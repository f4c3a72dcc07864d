"""K1 `keccak_rows`, K2 `keccak_pairs` and K3 `keccak_grind`: wrappers of
the Keccak-256 CUDA kernels (csrc/keccak.cu); :func:`keccak_tree` is K2
over a whole Merkle tree, one launch, :func:`keccak_pairs` over one level.

They replace the JAX package's Keccak, which is jnp under ``jax.jit`` and
not a Pallas kernel (hash/keccak_device.py: ``_keccak_f`` and
``_absorb_words`` under ``hash_felt_rows``, ``hash_digest_pairs`` and
``grinding_batch``).  Their plain versions are the whole-state PyTorch
functions of :mod:`.keccak_device` (``*_plain``), which CPU tensors take.

Digests are (n, 4) int64 tensors: lane j of the final state, digest bytes
8j .. 8j+8 little-endian; the kernels read and write the same storage as
u64.  Each launcher takes CUDA tensors (K3: a CUDA device) only and raises
on anything else before building or launching, and adds one to its
``launches`` count per launch.  Nothing waits for the device: K3's result
stays on it.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from ..field.params import N_LIMBS

_I64 = torch.int64
_U64_MASK = (1 << 64) - 1


def lane0_mask(grinding_factor: int) -> int:
    """The u64 mask on digest lane 0 whose zero test is "the first 8 digest
    bytes, read as a BE u64, have at least ``grinding_factor`` trailing
    zeros": bit 8i + k of that u64 is bit 8(7 - i) + k of lane 0 (LE)."""
    mask = 0
    for bit in range(min(grinding_factor, 64)):
        i, k = divmod(bit, 8)
        mask |= 1 << (8 * (7 - i) + k)
    return mask


def _require_cuda(what: str, device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {device}")
    return device


def _check(what: str, x, dtype, ndim: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(x).__name__}")
    _require_cuda(what, x.device)
    if x.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} axes, got shape "
                         f"{tuple(x.shape)}")


def keccak_rows(limbs: torch.Tensor) -> torch.Tensor:
    """K1: (16, c, n) int32 canonical limbs, any strides -> (n, 4) int64,
    the Keccak-256 of each point's c felts, 32 BE bytes each, in column
    order (lambdaworks `BatchKeccak256Tree` leaves)."""
    _check("keccak_rows", limbs, torch.int32, 3)
    if limbs.shape[0] != N_LIMBS:
        raise ValueError(f"keccak_rows: expected (16, c, n) limbs, got shape "
                         f"{tuple(limbs.shape)}")
    _, n_cols, n_rows = limbs.shape
    out = torch.empty((n_rows, 4), dtype=_I64, device=limbs.device)
    if n_rows == 0:
        return out
    ls, cs, rs = limbs.stride()
    lib = cuda_lib.library()
    with torch.cuda.device(limbs.device):
        code = lib.lcp_keccak_rows(
            limbs.data_ptr(), ls, cs, rs, n_cols, n_rows, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "keccak_rows")
    keccak_rows.launches += 1
    return out


keccak_rows.launches = 0


# csrc/keccak.cu's K2 (the CPU test reads them back from the source):
# threads a block, the levels a block resolves at most (a task's children:
# 2 ** TREE_LEVELS), the levels a task below the top resolves, and the tasks
# whose nodes make the next task's children
TREE_THREADS = 256  # kTreeThreads
TREE_LEVELS = 9     # kTreeLevels
TREE_STEP = 2       # kTreeStep
TREE_GROUP = 4      # kTreeGroup


def tree_counts(n: int, chunk: int = 1 << TREE_LEVELS, step: int = TREE_STEP,
                group: int = TREE_GROUP) -> int:
    """The group counts K2 takes for the tree over n leaves (a power of
    two): a round over c > chunk children has c / chunk tasks in groups of
    ``group`` (or all of them, if fewer), and the next round c / 2^step."""
    total, c = 0, n
    while c > chunk:
        tasks = c // chunk
        total += tasks // min(group, tasks)
        c >>= step
    return total


def keccak_pairs(digests: torch.Tensor) -> torch.Tensor:
    """K2 over one level: (2k, 4) int64 digests -> (k, 4),
    Keccak-256(left || right) of rows 2i and 2i + 1."""
    _check("keccak_pairs", digests, _I64, 2)
    n = digests.shape[0]
    if digests.shape[1] != 4 or n % 2:
        raise ValueError(f"keccak_pairs: expected (2k, 4) digests, got shape "
                         f"{tuple(digests.shape)}")
    out = torch.empty((n // 2, 4), dtype=_I64, device=digests.device)
    if n:
        _launch_pairs(digests.contiguous(), 1, out, None)
    return out


def keccak_tree(leaves: torch.Tensor) -> torch.Tensor:
    """K2 over a whole Merkle tree, in one launch: every level above (n, 4)
    leaf digests, n a power of two, as one (n - 1, 4) tensor, level 1 (n/2
    rows) first and the root last."""
    _check("keccak_tree", leaves, _I64, 2)
    n = leaves.shape[0]
    if leaves.shape[1] != 4 or n & (n - 1):
        raise ValueError(f"keccak_tree: expected (n, 4) digests, n a power of "
                         f"two, got shape {tuple(leaves.shape)}")
    if n <= 1:
        return leaves[:0]  # a single leaf is its own root
    out = torch.empty((n - 1, 4), dtype=_I64, device=leaves.device)
    counts = tree_counts(n)
    _launch_pairs(leaves.contiguous(), n.bit_length() - 1, out,
                  torch.zeros(counts, dtype=torch.int32, device=leaves.device)
                  if counts else None)
    return out


def _launch_pairs(src: torch.Tensor, levels: int, out: torch.Tensor,
                  counts) -> None:
    """One K2 launch over the checked digests ``src`` into ``out``."""
    lib = cuda_lib.library()
    with torch.cuda.device(src.device):
        code = lib.lcp_keccak_pairs(
            src.data_ptr(), src.shape[0], levels, out.data_ptr(),
            None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "keccak_pairs")
    keccak_pairs.launches += 1


keccak_pairs.launches = 0


def keccak_grind(challenge_lanes, start: int, size: int, grinding_factor: int,
                 device) -> tuple:
    """K3: search the nonces [start, start + size) on ``device``: message
    challenge || nonce_le_u64 (the challenge as 4 u64 lanes, LE), hit when
    ``lane0_mask`` of digest lane 0 is zero.  Returns (found, index in the
    batch of the first hit, else ``size``) as 0-d tensors on the device."""
    device = _require_cuda("keccak_grind", device)
    lanes = [int(v) & _U64_MASK for v in challenge_lanes]
    if len(lanes) != 4:
        raise ValueError(f"keccak_grind: expected 4 challenge lanes, got "
                         f"{len(lanes)}")
    if start < 0 or size < 0 or start + size > 1 << 63:
        raise ValueError("nonce batch outside [0, 2^63)")
    first = torch.full((), size, dtype=_I64, device=device)
    if size:
        lib = cuda_lib.library()
        with torch.cuda.device(device):
            code = lib.lcp_keccak_grind(
                *lanes, start, size, lane0_mask(grinding_factor),
                first.data_ptr(), torch.cuda.current_stream().cuda_stream)
        cuda_lib.check(code, "keccak_grind")
        keccak_grind.launches += 1
    return first < size, first


keccak_grind.launches = 0
