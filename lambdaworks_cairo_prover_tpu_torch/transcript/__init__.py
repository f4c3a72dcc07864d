from .fiat_shamir import (
    DefaultTranscript,
    TestTranscript,
    batch_sample_challenges,
    sample_z_ood,
    transcript_to_field,
    transcript_to_usize,
)
