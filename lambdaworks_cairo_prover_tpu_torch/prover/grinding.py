"""Proof-of-work grinding (reference src/starks/grinding.rs).

The nonce search runs on the tensor device in batches (vectorized Keccak
over candidate nonces), scanning from 0 upward so the found nonce is the
reference's: the smallest.  The per-nonce check on host mirrors
`hash_transcript_with_int_and_get_leading_zeros` exactly.
"""

from __future__ import annotations

from collections import deque

from ..hash import keccak_device as kd
from ..hash.keccak_host import keccak256


def leading_zeros_of_nonce(challenge: bytes, nonce: int) -> int:
    """Reference grinding.rs:17-29 (trailing zeros of the BE-read u64 head)."""
    digest = keccak256(challenge + nonce.to_bytes(8, "little"))
    head = int.from_bytes(digest[:8], "big")
    if head == 0:
        return 64
    return (head & -head).bit_length() - 1


def generate_nonce_with_grinding(
    challenge: bytes, grinding_factor: int, device, batch: int | None = None,
    pipeline: int = 4,
) -> int:
    """Smallest u64 nonce whose grinding hash meets the factor.

    Factors up to 12 search on the host.  Larger ones keep ``pipeline``
    batches in flight on ``device`` before reading the first result (CUDA
    work is asynchronous; reading ``found`` waits), and drain them in
    launch order, so the returned nonce is the smallest (grinding.rs:40-48).
    """
    if grinding_factor <= 12:
        nonce = 0
        while leading_zeros_of_nonce(challenge, nonce) < grinding_factor:
            nonce += 1
        return nonce
    if batch is None:
        # the expected first hit is at ~0.69 * 2^factor
        batch = 1 << min(20, max(16, grinding_factor - 1))
    inflight: deque = deque()
    next_start = 0
    limit = 1 << 63  # grinding_batch keeps nonces in int64
    while inflight or next_start < limit:
        while len(inflight) < pipeline and next_start < limit:
            size = min(batch, limit - next_start)
            inflight.append((next_start, kd.grinding_batch(
                challenge, next_start, size, grinding_factor, device)))
            next_start += size
        start, (found, first) = inflight.popleft()
        if bool(found):
            nonce = start + int(first)
            if leading_zeros_of_nonce(challenge, nonce) < grinding_factor:
                raise RuntimeError(
                    "device grinding result disagrees with host check")
            return nonce
    raise RuntimeError("no grinding hit below 2^63")
