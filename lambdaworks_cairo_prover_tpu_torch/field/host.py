"""Host-side Stark252 scalar arithmetic (python ints).

The verifier and the Fiat-Shamir transcript operate on a handful of scalars,
so they run on host with exact python integers (bulk arrays are limb tensors;
see field/device.py).  Byte conversions mirror lambdaworks `ByteConversion`
(to/from 32-byte big-endian, reference usage transcript.rs:42, cairo_mem.rs:50).
"""

from __future__ import annotations

from .params import FIELD_BIT_SIZE, P


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def finv(a: int) -> int:
    return pow(a, P - 2, P)


def fpow(a: int, e: int) -> int:
    return pow(a, e, P)


def fneg(a: int) -> int:
    return (-a) % P


def to_bytes_be(a: int) -> bytes:
    return a.to_bytes(32, "big")


def to_bytes_le(a: int) -> bytes:
    return a.to_bytes(32, "little")


def from_bytes_be(b: bytes) -> int:
    v = int.from_bytes(b[:32], "big")
    if v >= P:
        raise ValueError("field element out of range")
    return v


def from_bytes_le(b: bytes) -> int:
    v = int.from_bytes(b[:32], "little")
    if v >= P:
        raise ValueError("field element out of range")
    return v


def batch_inverse(values: list[int]) -> list[int]:
    """Montgomery trick on host; zeros map to zero."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v else 1) % P
    inv_all = finv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v:
            out[i] = prefix[i] * inv_all % P
            inv_all = inv_all * v % P
    return out


def randomness_to_field(randomness: bytes) -> int:
    """Mask 32 random bytes down to FIELD_BIT_SIZE-1 bits, BE (reference
    src/starks/transcript.rs:23-43)."""
    buf = bytearray(randomness)
    bits_to_clear = len(buf) * 8 - (FIELD_BIT_SIZE - 1)
    i = 0
    while bits_to_clear >= 8:
        buf[i] = 0
        bits_to_clear -= 8
        i += 1
    if bits_to_clear:
        buf[i] &= (1 << (8 - bits_to_clear)) - 1
    return from_bytes_be(bytes(buf))
