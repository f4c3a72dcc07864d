"""Fiat-Shamir transcript (host side).

Matches the behavior of lambdaworks-crypto's `DefaultTranscript` (a Keccak256
accumulator; reference usage src/starks/prover.rs:4-9): ``append`` feeds bytes
into the hasher; ``challenge`` returns the digest of everything absorbed since
the last challenge, resets, and re-seeds the hasher with that digest.

The field/usize sampling helpers mirror src/starks/transcript.rs.
"""

from __future__ import annotations

from ..field import host as fh
from ..hash.keccak_host import keccak256


class DefaultTranscript:
    def __init__(self) -> None:
        self._buf = bytearray()

    def append(self, data: bytes) -> None:
        self._buf.extend(data)

    def challenge(self) -> bytes:
        digest = keccak256(bytes(self._buf))
        self._buf = bytearray(digest)
        return digest


class TestTranscript:
    """Deterministic counter transcript — the analog of the reference's
    `test_fiat_shamir` feature, which swaps `DefaultTranscript` for
    lambdaworks-crypto's `TestTranscript` in both prover and verifier
    (prover.rs:85-88, verifier.rs:31-34) so protocol tests are
    hash-independent.  Absorbed data is ignored; challenge i is the 32-byte
    BE encoding of i."""

    def __init__(self) -> None:
        self._counter = 0

    def append(self, data: bytes) -> None:
        pass

    def challenge(self) -> bytes:
        c = self._counter.to_bytes(32, "big")
        self._counter += 1
        return c


def transcript_to_field(transcript) -> int:
    """251-bit-masked field draw (reference transcript.rs:13-43)."""
    return fh.randomness_to_field(transcript.challenge())


def transcript_to_usize(transcript) -> int:
    """First 8 challenge bytes as BE u64 (reference transcript.rs:45-51)."""
    return int.from_bytes(transcript.challenge()[:8], "big")


def sample_z_ood(lde_coset_set, trace_roots_set, transcript) -> int:
    """Resample until z lies in neither domain (reference transcript.rs:53-69).

    The domains are passed as python sets of ints for O(1) membership."""
    while True:
        z = transcript_to_field(transcript)
        if z not in lde_coset_set and z not in trace_roots_set:
            return z


def batch_sample_challenges(size: int, transcript) -> list[int]:
    return [transcript_to_field(transcript) for _ in range(size)]
