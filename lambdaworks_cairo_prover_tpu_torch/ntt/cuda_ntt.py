"""H3 `ntt_dif_stages` and H4 `ntt_dif_local`: wrappers of the NTT kernels
(csrc/ntt.cu), their plain PyTorch versions, the pass list both walk, and the
plain NTT.

Together the two kernels replace the JAX package's five TPU NTT schedules
(ntt/fused.py: ``_gpair_kernel``, ``_gsingle_kernel``, ``_local_kernel_body``;
field/pallas_mul.py: ``_butterfly_kernel``, ``_butterfly2_kernel``).  The
values are fixed by the math — ``ntt(c)[i] = sum_j c_j w^(ij)`` with ``w`` the
primitive root of order n, natural order — so the CUDA schedule is free:
decimation in frequency in a few passes (:func:`ntt_passes`), each of which
keeps up to 8 stages of a 2^TILE_LOG-point tile in shared memory.  The first
H3 pass reads the caller's tensor, the last pass (H4) writes natural order
itself: three passes over the array at 2^21 points, no copy-in and no
bit-reverse gather.  The plain NTT on CPU tensors is the radix-2
decimation-in-time schedule of the JAX package's ``core._ntt_impl``, on the
plain field ops.

Twiddles: one ``(16, n)`` limb table per direction and device, with
``tw[m + j] = w_{2m}^j`` for every power of two m < n and j < m; a smaller
transform uses a prefix of a larger table.  The kernels read the same table
packed to 8 words of 32 bits an entry, ``(n, 8)`` (:func:`pack_twiddles`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import cuda_lib
from ..field import cuda_field as cf
from ..field import device as fd
from ..field.params import N_LIMBS, P, SPARSE_P, get_primitive_root_of_unity

LOCAL_LOG = 10  # largest chunk of H4, as LOCAL_LOG in csrc/ntt.cu
TILE_LOG = 11   # points a block keeps in shared memory, as TILE_LOG there
TILE_BYTES = 8 * 4 * ((1 << TILE_LOG) + (1 << TILE_LOG) // 32)
LAST_LOG = 7    # chunk of the last pass of a transform above 2^LOCAL_LOG:
                # 2^(TILE_LOG - LAST_LOG) = 16 chunks a block, so that the
                # natural-order writes are runs of 16 words
MAX_STAGES = 8  # of one H3 pass: 256 rows by 8 columns
# The launchers' own limit (csrc/ntt.cu: log_n <= 30, so that a block's chunk
# index fits the int that rev_bits takes); every element index there is a
# long long, and the grid, columns x 2^(log_n - TILE_LOG) blocks, is checked
# against 2^31 there.
# Memory binds first on an 80 GB card: a one-column transform of 2^28 points
# holds 16 GiB in, 16 GiB out and 8 GiB of packed twiddles (and 32 GiB while
# the table is built).  Stark252's two-adicity (192) is no limit.
MAX_LOG_N = 30

# (inverse, device) -> the largest table built; it stays, and a transform of
# 2^26 points keeps 4 GiB a direction of limbs or 2 GiB packed (forget_tables)
_twiddle_cache: dict = {}  # (16, n) limb tables: the plain versions
_packed_cache: dict = {}   # (n, 8) packed tables: the kernels
_bitrev_cache: dict = {}   # (log_n, device) -> int64 permutation


def twiddle_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """(16, 2^log_n) view with tw[m + j] = w_{2m}^j (inverse roots if
    ``inverse``); entry 0 is one."""
    device = torch.device(device)
    key = (inverse, device)
    n = 1 << log_n
    tab = _twiddle_cache.get(key)
    if tab is None or tab.shape[1] < n:
        tab = _build_twiddles(log_n, inverse, device)
        _twiddle_cache[key] = tab
    return tab[:, :n]


def _build_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    parts = [fd.ones((1,), device=device)]
    for s in range(log_n):
        w = get_primitive_root_of_unity(s + 1)
        if inverse:
            w = pow(w, P - 2, P)
        parts.append(fd.powers(w, 1 << s, device=device))
    return torch.cat(parts, dim=1).contiguous()


def pack_twiddles(tw: torch.Tensor) -> torch.Tensor:
    """A (16, n) limb table as the (n, 8) int32 table the kernels read: word
    k of an entry is limb 2k | limb 2k+1 << 16."""
    return fd.pack(tw).t().contiguous()


def packed_twiddle_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """(2^log_n, 8) packed view of :func:`twiddle_table`, cached.  The limb
    table it is packed from is not kept: the kernels read only this one,
    and the limb table is twice its bytes (512 MiB a direction at 2^23
    points)."""
    key = (inverse, torch.device(device))
    n = 1 << log_n
    tab = _packed_cache.get(key)
    if tab is None or tab.shape[0] < n:
        tab = pack_twiddles(_build_twiddles(log_n, inverse, device))
        _packed_cache[key] = tab
    return tab[:n]


def forget_tables(device=None) -> None:
    """Drop the cached twiddle tables and bit-reversal permutations (of
    ``device``, or of every device)."""
    for cache in (_twiddle_cache, _packed_cache, _bitrev_cache):
        for key in [k for k in cache
                    if device is None or k[1] == torch.device(device)]:
            del cache[key]


def bitrev_indices(log_n: int, device) -> torch.Tensor:
    device = torch.device(device)
    key = (log_n, device)
    if key not in _bitrev_cache:
        idx = torch.arange(1 << log_n, device=device)
        rev = torch.zeros_like(idx)
        for b in range(log_n):
            rev |= ((idx >> b) & 1) << (log_n - 1 - b)
        _bitrev_cache[key] = rev
    return _bitrev_cache[key]


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    return log_n


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def dif_stage_plain(x: torch.Tensor, tw: torch.Tensor, log_m: int) -> torch.Tensor:
    """One DIF stage of half-size m on (16, B, n):
    x[j] <- x[j] + x[j+m], x[j+m] <- (x[j] - x[j+m]) * w_{2m}^j."""
    _, b, n = x.shape
    m = 1 << log_m
    xv = x.reshape(N_LIMBS, b, n // (2 * m), 2, m)
    u, v = xv[:, :, :, 0], xv[:, :, :, 1]
    w = tw[:, m:2 * m].reshape(N_LIMBS, 1, 1, m)
    top = cf.add_plain(u, v)
    bot = cf.mul_plain(cf.sub_plain(u, v), w)
    return torch.stack([top, bot], dim=3).reshape(N_LIMBS, b, n)


def dif_stages_plain(x: torch.Tensor, tw: torch.Tensor, log_m_hi: int,
                     n_stages: int) -> torch.Tensor:
    """The DIF stages of half-size 2^log_m_hi .. 2^(log_m_hi - n_stages + 1),
    as one H3 pass runs them."""
    for log_m in range(log_m_hi, log_m_hi - n_stages, -1):
        x = dif_stage_plain(x, tw, log_m)
    return x


def dif_local_plain(x: torch.Tensor, tw: torch.Tensor, log_chunk: int,
                    natural: bool = False) -> torch.Tensor:
    """Every DIF stage with m < 2^log_chunk, as H4 runs them.  With
    ``natural`` the result goes to natural order: after all of a transform's
    stages, position i holds value bitrev(i)."""
    x = dif_stages_plain(x, tw, log_chunk - 1, log_chunk)
    if natural:
        x = x.index_select(-1, bitrev_indices(_log2(x.shape[-1]), x.device))
    return x


class Pass(NamedTuple):
    """One pass over the array: the DIF stages of half-size 2^log_m_hi ..
    2^(log_m_hi - n_stages + 1); ``local`` passes go to H4 (log_m_hi =
    n_stages - 1), the others to H3; ``natural`` marks the pass that writes
    natural order."""
    log_m_hi: int
    n_stages: int
    local: bool
    natural: bool


def ntt_passes(log_n: int) -> list:
    """The passes of a 2^log_n-point transform, first stage first.  Up to
    2^LOCAL_LOG points it is one H4 launch.  Above, the last pass is H4 on
    chunks of 2^LAST_LOG, and the stages before it are split evenly over as
    few H3 passes of at most MAX_STAGES as cover them."""
    if not 1 <= log_n <= MAX_LOG_N:
        raise ValueError(f"NTT of 2^{log_n} points: log_n outside [1, {MAX_LOG_N}]")
    if log_n <= LOCAL_LOG:
        return [Pass(log_n - 1, log_n, True, True)]
    n_global = log_n - LAST_LOG
    n_pass = -(-n_global // MAX_STAGES)
    passes, hi = [], log_n - 1
    for i in range(n_pass):
        r = n_global // n_pass + (1 if i < n_global % n_pass else 0)
        passes.append(Pass(hi, r, False, False))
        hi -= r
    passes.append(Pass(LAST_LOG - 1, LAST_LOG, True, True))
    return passes


def ntt_passes_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Transform along the last axis by the pass list of :func:`ntt_cuda`,
    each pass through its kernel's plain version."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x.clone()
    tw = twiddle_table(log_n, inverse, x.device)
    y = x.reshape(N_LIMBS, -1, n)
    for p in ntt_passes(log_n):
        if p.local:
            y = dif_local_plain(y, tw, p.n_stages, p.natural)
        else:
            y = dif_stages_plain(y, tw, p.log_m_hi, p.n_stages)
    return y.reshape(x.shape)


def dit_stage_plain(x: torch.Tensor, tw: torch.Tensor, log_m: int) -> torch.Tensor:
    """One DIT stage of half-size m on (16, B, n): with t = x[j+m] * w_{2m}^j,
    x[j] <- x[j] + t and x[j+m] <- x[j] - t (the JAX package's radix-2
    butterfly, field/pallas_mul.py:_butterfly_kernel)."""
    _, b, n = x.shape
    m = 1 << log_m
    xv = x.reshape(N_LIMBS, b, n // (2 * m), 2, m)
    lo, hi = xv[:, :, :, 0], xv[:, :, :, 1]
    t = cf.mul_plain(hi, tw[:, m:2 * m].reshape(N_LIMBS, 1, 1, m))
    out = torch.stack([cf.add_plain(lo, t), cf.sub_plain(lo, t)], dim=3)
    return out.reshape(N_LIMBS, b, n)


def ntt_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Transform along the last axis: bit-reverse, then radix-2 DIT stages
    (the schedule of the JAX package's core._ntt_impl)."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x.clone()
    tw = twiddle_table(log_n, inverse, x.device)
    lead = x.shape[1:-1]
    y = x.reshape(N_LIMBS, -1, n).index_select(-1, bitrev_indices(log_n, x.device))
    for log_m in range(log_n):
        y = dit_stage_plain(y, tw, log_m)
    return y.reshape((N_LIMBS,) + tuple(lead) + (n,))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(what: str, src: torch.Tensor, dst: torch.Tensor, twp: torch.Tensor) -> tuple:
    if not SPARSE_P:
        raise ValueError(f"{what}: the CUDA kernel bakes the Stark252 prime; "
                         "this field takes the plain NTT")
    for name, t in (("src", src), ("dst", dst), ("tw", twp)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a tensor")
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                             f"got {name} on {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if t.device != src.device:
            raise ValueError(f"{what}: src on {src.device}, {name} on {t.device}")
    for name, t in (("src", src), ("dst", dst)):
        if t.dim() != 3 or t.shape[0] != N_LIMBS or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous (16, B, n) "
                             f"tensor, got {tuple(t.shape)}")
    if dst.shape != src.shape:
        raise ValueError(f"{what}: src {tuple(src.shape)}, dst {tuple(dst.shape)}")
    n = src.shape[2]
    log_n = _log2(n)
    if (twp.dim() != 2 or twp.shape[1] != 8 or twp.shape[0] < n
            or not twp.is_contiguous()):
        raise ValueError(f"{what}: tw must be a contiguous packed (>= {n}, 8) "
                         f"table (pack_twiddles), got {tuple(twp.shape)}")
    return src.shape[1], log_n


def ntt_dif_stages(src: torch.Tensor, dst: torch.Tensor, tw: torch.Tensor,
                   log_m_hi: int, n_stages: int) -> torch.Tensor:
    """H3: the DIF stages of half-size 2^log_m_hi .. 2^(log_m_hi - n_stages +
    1) of src (16, B, n) into dst, which may be src; tw is the packed table."""
    cols, log_n = _check("ntt_dif_stages", src, dst, tw)
    if not (1 <= n_stages <= TILE_LOG and n_stages - 1 <= log_m_hi < log_n):
        raise ValueError(f"ntt_dif_stages: stages {log_m_hi} .. "
                         f"{log_m_hi - n_stages + 1} of a 2^{log_n}-point NTT")
    lib = cuda_lib.library()
    with torch.cuda.device(src.device):
        code = lib.lcp_ntt_dif_stages(
            src.data_ptr(), dst.data_ptr(), cols, log_n, log_m_hi, n_stages,
            tw.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "ntt_dif_stages")
    ntt_dif_stages.launches += 1
    return dst


ntt_dif_stages.launches = 0


def ntt_dif_local(src: torch.Tensor, dst: torch.Tensor, tw: torch.Tensor,
                  log_chunk: int, natural: bool) -> torch.Tensor:
    """H4: every DIF stage with m < 2^log_chunk on each 2^log_chunk-point
    chunk of src (16, B, n) into dst; 1 <= log_chunk <= min(log n, LOCAL_LOG).
    Without ``natural`` dst may be src (the DIF's bit-reversed order stays);
    with it dst gets natural order and is another tensor than src, and the
    chunk is the whole transform or at most 2^LAST_LOG points (a larger one
    leaves a block too few chunks to write whole sectors)."""
    cols, log_n = _check("ntt_dif_local", src, dst, tw)
    if not 1 <= log_chunk <= min(log_n, LOCAL_LOG):
        raise ValueError(f"ntt_dif_local: log_chunk {log_chunk} outside "
                         f"[1, {min(log_n, LOCAL_LOG)}]")
    if natural and dst.data_ptr() == src.data_ptr():
        raise ValueError("ntt_dif_local: natural order is written out of place")
    if natural and LAST_LOG < log_chunk < log_n:
        raise ValueError(f"ntt_dif_local: natural order from chunks of "
                         f"2^{log_chunk} points of a 2^{log_n}-point array "
                         f"(at most 2^{LAST_LOG}, or the whole array)")
    lib = cuda_lib.library()
    with torch.cuda.device(src.device):
        code = lib.lcp_ntt_dif_local(
            src.data_ptr(), dst.data_ptr(), cols, log_n, log_chunk, int(natural),
            tw.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "ntt_dif_local")
    ntt_dif_local.launches += 1
    return dst


ntt_dif_local.launches = 0


def ntt_cuda(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Transform along the last axis of a CUDA tensor: :func:`ntt_passes`
    through H3 and H4.  x is only read."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x.clone()
    tw = packed_twiddle_table(log_n, inverse, x.device)
    src = x.reshape(N_LIMBS, -1, n).contiguous()
    work = None
    for p in ntt_passes(log_n):
        if p.local:
            src = ntt_dif_local(src, torch.empty_like(src), tw, p.n_stages, p.natural)
        else:
            if work is None:
                work = torch.empty_like(src)
            src = ntt_dif_stages(src, work, tw, p.log_m_hi, p.n_stages)
    return src.reshape(x.shape)
