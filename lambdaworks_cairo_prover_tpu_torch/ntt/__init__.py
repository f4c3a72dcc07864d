from .core import (
    evaluate_fft,
    evaluate_offset_fft,
    evaluate_on_lde_domain,
    interpolate_fft,
    interpolate_offset_fft,
    intt,
    ntt,
    offset_powers,
    poly_eval_at,
    scale_poly,
    sum_reduce,
)
