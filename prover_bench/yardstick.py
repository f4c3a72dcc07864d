"""The work that a call into one layer needs at the least, counted from its
shapes, and the least time the card could take for it.

The arithmetic is frozen here from the repository's `chip_smoke.py`
(`bound`, `butterfly_ops`, `keccak_blocks`), so that a later change to the
program cannot move the yardstick.  It counts the same work whatever
implements it: 32 bytes a field element read once and written once, in
whatever layout the program keeps it, and 32 bytes a twiddle.

Peaks of one NVIDIA H100 SXM: 3.35 TB/s of HBM (NVIDIA's data sheet).
16.75e12 32-bit integer instructions a second is derived, not published:
132 SMs x 64 int32 lanes x the 1.98 GHz boost clock, half the data sheet's
67 TFLOP/s of float32 (128 lanes an SM).  A share of a roofline is stated
against these at the card's power limit, which the result line records."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2

FELT_BYTES = 32
TWIDDLE_BYTES = 32
DIGEST_BYTES = 32
# 32-bit integer instructions of one operation on 8-word elements at the
# least: a Montgomery product is 64 + 8 wide multiply-adds and an 8-word
# subtraction; an addition or subtraction mod p an 8-word add and an 8-word
# compare-and-subtract.
OPS_MUL = 64 + 8 + 8
OPS_ADD = 16
# A Keccak-f[1600] permutation: the LOP3 and SHF instructions of one in the
# repository's K2 kernel's SASS as first measured (a 64-bit xor, and-not or
# rotate is two 32-bit instructions); frozen here.
OPS_PERMUTATION = 4491
KECCAK_RATE = 136


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take for this work."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def butterfly_ops(n_points: int, log_m_hi: int, n_stages: int) -> int:
    """Instructions that DIF stages of half-size 2^log_m_hi down to
    2^(log_m_hi - n_stages + 1) over n_points need: n_points / 2 butterflies
    a stage, less the products by a twiddle of one (the whole stage m = 1,
    half of the stage m = 2)."""
    pairs = n_points // 2
    products = 0
    for log_m in range(log_m_hi, log_m_hi - n_stages, -1):
        products += pairs if log_m > 1 else pairs // 2 * log_m
    return 2 * OPS_ADD * n_stages * pairs + OPS_MUL * products


def keccak_blocks(n_felts: int) -> int:
    """Permutations that a message of n_felts 32-byte encodings takes, its
    padding included."""
    return FELT_BYTES * n_felts // KECCAK_RATE + 1


def elements(shape) -> int:
    """Field elements in a tensor of 16 limbs or 8 packed words on axis 0."""
    return math.prod(shape[1:])


def broadcast_elements(a_shape, b_shape) -> int:
    a, b = list(a_shape[1:]), list(b_shape[1:])
    width = max(len(a), len(b))
    a = [1] * (width - len(a)) + a
    b = [1] * (width - len(b)) + b
    return math.prod(max(x, y) for x, y in zip(a, b))


# work (bytes, int32 instructions) of one call, from its arguments' shapes

def elementwise_work(ops_each: int):
    def work(a_shape, b_shape):
        out = broadcast_elements(a_shape, b_shape)
        n_bytes = FELT_BYTES * (elements(a_shape) + elements(b_shape) + out)
        return n_bytes, ops_each * out
    return work


mul_work = elementwise_work(OPS_MUL)
add_work = elementwise_work(OPS_ADD)


def batch_inverse_work(shape):
    """x -> 1/x elementwise by Montgomery's trick: three products an element
    (the one inversion of the total is negligible)."""
    n = elements(shape)
    return 2 * FELT_BYTES * n, 3 * OPS_MUL * n


def prefix_product_work(shape):
    n = elements(shape)
    return 2 * FELT_BYTES * n, OPS_MUL * n


def ntt_work(shape):
    """A whole radix-2 transform of every column over the last axis."""
    n_points = shape[-1]
    columns = elements(shape) // n_points
    log_n = n_points.bit_length() - 1
    if n_points < 2:
        return 2 * FELT_BYTES * columns, 0
    n_bytes = 2 * FELT_BYTES * columns * n_points + TWIDDLE_BYTES * (
        n_points // 2)
    return n_bytes, columns * butterfly_ops(n_points, log_n - 1, log_n)


def row_hash_work(n_rows: int, n_cols: int):
    """A Keccak-256 digest of each row of n_cols field elements."""
    perms = n_rows * keccak_blocks(n_cols)
    return (FELT_BYTES * n_rows * n_cols + DIGEST_BYTES * n_rows,
            OPS_PERMUTATION * perms)


def tree_work(n_leaves: int):
    """A Merkle tree's inner nodes over n_leaves digests: one permutation
    each."""
    nodes = max(n_leaves - 1, 0)
    return (DIGEST_BYTES * (n_leaves + nodes), OPS_PERMUTATION * nodes)
