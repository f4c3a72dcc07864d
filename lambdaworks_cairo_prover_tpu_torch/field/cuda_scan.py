"""H5 `mont_batch_inverse` and H6 `mont_prefix_product`: wrappers of the
scan kernels (csrc/scan.cu), with their plain PyTorch versions.

They replace the JAX package's field/device.py:batch_inverse (its two
``lax.scan`` over the Pallas product and the Fermat ``inv`` of the chunk
totals) and prefix_product (its ``lax.scan``, ``associative_scan`` and the
offset product): on the TPU each is one compiled device loop; here H5 is
one call of three kernel launches and H6 one call of one launch (after a
memset of its status words), where the port used to launch H1 once a scan
step (1,209 times a batch inverse, 397 a prefix product).  Neither keeps a
running product in device memory: H5 reads x twice and writes the
inverses once, H6 reads x once and writes the products once (decoupled
look-back between its tiles).

Operands are ``(16, n)`` int32 limb tensors (16-bit limbs, Montgomery form,
canonical).

* :func:`mont_batch_inverse` / :func:`mont_prefix_product` launch the
  kernels.  They take contiguous CUDA tensors of that shape only, under the
  Stark252 prime (the kernels bake it), and raise on anything else before
  building or launching; each adds one to its ``launches`` count a call.
  Outputs and the scratch (H5's totals, H6's status words, which the C
  launcher zeroes on the stream) come from ``torch.empty``; nothing waits
  for the device.
* :func:`batch_inverse_plain` / :func:`prefix_product_plain` are the chunked
  scans over :func:`cuda_field.mul_plain`, for any prime of ``params`` on
  any device.  CPU tensors use them, as do all tensors of a toy field; the
  chip check compares the kernels against them on the card.
* :func:`inverse_plan` and :func:`prefix_plan` are the kernels' schedules,
  which the CPU tests walk with the plain product.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from .cuda_field import mul_plain
from .params import LIMB_MASK, N_LIMBS, P, R, SPARSE_P

# csrc/scan.cu's block shapes (the CPU test reads them back from the source)
INV_THREADS = 128   # kInvThreads: H5's tile passes, threads a block
RUN = 4             # kRun: consecutive elements an H5 thread takes
INV_TILE = INV_THREADS * RUN
MID_THREADS = 256   # kMidThreads: H5's totals, leaves of a block's tree
TILE_THREADS = 128  # kTileThreads: H6's threads a tile
PER_THREAD = 4      # kPerThread: consecutive elements an H6 thread scans
TILE = TILE_THREADS * PER_THREAD
# H6's status words (kStatusHead, kSlotWords): the tile counter padded to 8
# words, a flag a tile padded to a multiple of 8, then a slot of 16 words a
# tile (its aggregate and its inclusive prefix)
STATUS_HEAD, SLOT_WORDS = 8, 16
# H5's totals pass takes 1 or more totals a thread in at most this many
# blocks, one for each of the H100's 132 SMs
MID_BLOCKS = 132
# H5's root inverse (kLowBits, kHighShift, kHighTail): p - 2 = 2^192 (2^59 +
# 2^4) + (2^192 - 1), two chains (root_inverse)
LOW_BITS, HIGH_SHIFT, HIGH_TAIL = 192, 55, 4

# ---------------------------------------------------------------------------
# Plain versions: the chunked loops over mul_plain
# ---------------------------------------------------------------------------

_ONE_LIMBS = [(R >> (16 * k)) & LIMB_MASK for k in range(N_LIMBS)]


def _ones(n: int, device) -> torch.Tensor:
    """Montgomery one (R mod p), (16, n)."""
    one = torch.tensor(_ONE_LIMBS, dtype=torch.int32, device=device)
    return one[:, None].expand(N_LIMBS, n)


def fermat(a: torch.Tensor, mul) -> torch.Tensor:
    """Fermat inverse a^(p-2) by the product ``mul``, left to right; 0 maps
    to 0."""
    acc = a
    for bit in bin(P - 2)[3:]:  # MSB first; the leading 1 is the initial acc
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def root_inverse(a, mul):
    """a^(p - 2) for the Stark252 prime by csrc/scan.cu's two chains
    (inv_low, inv_high), with the product ``mul`` (Python ints or limb
    tensors): lo = a^(2^192 - 1) by a_2k = a_k^(2^k) a_k from a_1 = a, and
    hi = ((a^(2^55) a)^(2^4))^(2^192)."""
    def sqr_n(v, k):
        for _ in range(k):
            v = mul(v, v)
        return v

    lo = a
    for _ in range(2):  # a_2, a_3
        lo = mul(sqr_n(lo, 1), a)
    k = 3
    while k < LOW_BITS:
        lo = mul(sqr_n(lo, k), lo)
        k *= 2
    hi = sqr_n(mul(sqr_n(a, HIGH_SHIFT), a), HIGH_TAIL + LOW_BITS)
    return mul(lo, hi)


def _chunk_len(n: int) -> int:
    """Scan length for the chunked Montgomery tricks: about sqrt(n), in
    [2, 256] (only the schedule depends on it, never the values)."""
    return max(2, min(256, 1 << ((max(n, 1) - 1).bit_length() + 1) // 2))


def _chunk_scan(x: torch.Tensor, chunk: int, mul):
    """(16, n) -> list over t < chunk of (16, k) inclusive prefix products
    within each of k = ceil(n/chunk) chunks, and the padded (16, chunk, k)
    chunk-major input (padding is Montgomery one)."""
    n = x.shape[1]
    k = -(-n // chunk)
    pad = k * chunk - n
    xs = x
    if pad:
        xs = torch.cat([x, _ones(pad, x.device)], dim=1)
    xs = xs.reshape(N_LIMBS, k, chunk).transpose(1, 2).contiguous()
    pre = [xs[:, 0]]
    for t in range(1, chunk):
        pre.append(mul(pre[-1], xs[:, t]))
    return pre, xs


def batch_inverse_plain(x: torch.Tensor, mul=mul_plain) -> torch.Tensor:
    """Montgomery-trick batch inversion along axis 1 of ``x`` (16, n);
    zeros map to zero (lambdaworks `inplace_batch_inverse`).

    Chunks of about sqrt(n) are scanned in parallel; one Fermat inversion
    of the chunk totals, then the backward sweep.  ``mul`` is the product
    of every step (the chip check passes H1 to time the route that the
    kernel replaced)."""
    n = x.shape[1]
    if n == 0:
        return x
    zmask = (x == 0).all(dim=0)
    xs = torch.where(zmask, _ones(n, x.device), x)
    chunk = _chunk_len(n)
    pre, xs = _chunk_scan(xs, chunk, mul)
    carry = fermat(pre[-1], mul)
    out = [None] * chunk
    for t in range(chunk - 1, 0, -1):
        out[t] = mul(carry, pre[t - 1])
        carry = mul(carry, xs[:, t])
    out[0] = carry
    res = torch.stack(out, dim=2).reshape(N_LIMBS, -1)[:, :n]
    return torch.where(zmask, torch.zeros_like(res), res)


def prefix_product_plain(x: torch.Tensor, mul=mul_plain) -> torch.Tensor:
    """Inclusive prefix product along axis 1 of ``x`` (16, n)."""
    n = x.shape[1]
    if n <= 1:
        return x.clone()
    chunk = _chunk_len(n)
    pre, _ = _chunk_scan(x, chunk, mul)
    blocks = torch.stack(pre, dim=2)  # (16, k, chunk)
    k = blocks.shape[1]
    if k > 1:
        incl = prefix_product_plain(pre[-1], mul)  # running product of totals
        excl = torch.cat([_ones(1, x.device), incl[:, :-1]], dim=1)
        blocks = mul(blocks, excl[:, :, None])
    return blocks.reshape(N_LIMBS, -1)[:, :n]


# ---------------------------------------------------------------------------
# The kernels' schedules
# ---------------------------------------------------------------------------


def inverse_plan(n: int) -> tuple:
    """H5's schedule for n >= 1 elements: (k, q, mid_blocks).  k tiles of
    INV_TILE contiguous elements; their k totals go to mid_blocks blocks of
    MID_THREADS threads, q a thread."""
    k = -(-n // INV_TILE)
    q = max(1, -(-k // (MID_THREADS * MID_BLOCKS)))
    return k, q, -(-k // (MID_THREADS * q))


def prefix_plan(n: int) -> tuple:
    """H6's schedule for n >= 1 elements: (tiles, status words).  Tiles of
    TILE contiguous elements, one block each; a single tile takes no status
    words, more take the counter and flags (zeroed on every call) and a
    slot a tile."""
    nb = -(-n // TILE)
    if nb == 1:
        return 1, 0
    return nb, STATUS_HEAD + -(-nb // 8) * 8 + SLOT_WORDS * nb


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(what: str, x) -> None:
    if not SPARSE_P:
        raise ValueError(f"{what}: the CUDA kernel bakes the Stark252 prime; "
                         "this field takes the plain version")
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(x).__name__}")
    if x.dim() != 2 or x.shape[0] != N_LIMBS:
        raise ValueError(f"{what}: expected a (16, n) limb tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 limbs, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {x.device}")


def _scratch(shape: tuple, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=like.device)


def mont_batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """H5: the inverse of each element of a CUDA (16, n) limb tensor, zeros
    to zero."""
    _check("mont_batch_inverse", x)
    n = x.shape[1]
    out = _scratch((N_LIMBS, n), x)
    if n == 0:
        return out
    k, q, _ = inverse_plan(n)
    tot = _scratch((N_LIMBS, k), x)
    pre = _scratch((N_LIMBS, k), x)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.lcp_batch_inverse(
            x.data_ptr(), out.data_ptr(), n, k, q, tot.data_ptr(),
            pre.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "mont_batch_inverse")
    mont_batch_inverse.launches += 1
    return out


mont_batch_inverse.launches = 0


def mont_prefix_product(x: torch.Tensor) -> torch.Tensor:
    """H6: the inclusive prefix products along axis 1 of a CUDA (16, n) limb
    tensor."""
    _check("mont_prefix_product", x)
    n = x.shape[1]
    out = _scratch((N_LIMBS, n), x)
    if n == 0:
        return out
    nb, words = prefix_plan(n)
    status = _scratch((words,), x) if words else None
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.lcp_prefix_product(
            x.data_ptr(), out.data_ptr(), n, nb,
            None if status is None else status.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "mont_prefix_product")
    mont_prefix_product.launches += 1
    return out


mont_prefix_product.launches = 0
