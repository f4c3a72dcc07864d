"""H3 `ntt_dif_stage` and H4 `ntt_dif_local`: wrappers of the NTT kernels
(csrc/ntt.cu), their plain PyTorch versions, and the plain NTT.

Together the two kernels replace the JAX package's five TPU NTT schedules
(ntt/fused.py: ``_gpair_kernel``, ``_gsingle_kernel``, ``_local_kernel_body``;
field/pallas_mul.py: ``_butterfly_kernel``, ``_butterfly2_kernel``).  The
values are fixed by the math — ``ntt(c)[i] = sum_j c_j w^(ij)`` with ``w`` the
primitive root of order n, natural order — so the CUDA schedule is free:
decimation in frequency, stages with half-size m >= 2^LOCAL_LOG one H3
launch each, all smaller stages in one H4 launch, then one bit-reverse
gather.  The plain NTT on CPU tensors is the radix-2 decimation-in-time
schedule of the JAX package's ``core._ntt_impl``, on the plain field ops.

Twiddles: one ``(16, n)`` table per direction and device, with
``tw[m + j] = w_{2m}^j`` for every power of two m < n and j < m; a smaller
transform uses a prefix of a larger table.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib
from ..field import cuda_field as cf
from ..field import device as fd
from ..field.params import N_LIMBS, P, get_primitive_root_of_unity

LOCAL_LOG = 10  # chunk of H4, as LOCAL_LOG in csrc/ntt.cu

_twiddle_cache: dict = {}  # (inverse, device) -> largest (16, n) table built
_bitrev_cache: dict = {}   # (log_n, device) -> int64 permutation


def twiddle_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """(16, 2^log_n) view with tw[m + j] = w_{2m}^j (inverse roots if
    ``inverse``); entry 0 is one."""
    device = torch.device(device)
    key = (inverse, device)
    n = 1 << log_n
    tab = _twiddle_cache.get(key)
    if tab is None or tab.shape[1] < n:
        parts = [fd.ones((1,), device=device)]
        for s in range(log_n):
            w = get_primitive_root_of_unity(s + 1)
            if inverse:
                w = pow(w, P - 2, P)
            parts.append(fd.powers(w, 1 << s, device=device))
        tab = torch.cat(parts, dim=1).contiguous()
        _twiddle_cache[key] = tab
    return tab[:, :n]


def bitrev_indices(log_n: int, device) -> torch.Tensor:
    device = torch.device(device)
    key = (log_n, device)
    if key not in _bitrev_cache:
        idx = np.arange(1 << log_n)
        rev = np.zeros(1 << log_n, dtype=np.int64)
        for b in range(log_n):
            rev |= ((idx >> b) & 1) << (log_n - 1 - b)
        _bitrev_cache[key] = torch.from_numpy(rev).to(device)
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


def dif_local_plain(x: torch.Tensor, tw: torch.Tensor, log_chunk: int) -> torch.Tensor:
    """Every DIF stage with m < 2^log_chunk, as H4 runs them."""
    for log_m in range(log_chunk - 1, -1, -1):
        x = dif_stage_plain(x, tw, log_m)
    return x


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


def _check(what: str, x: torch.Tensor, tw: torch.Tensor) -> tuple:
    for name, t in (("x", x), ("tw", tw)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a tensor")
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                             f"got {name} on {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32 limbs, got {t.dtype}")
    if tw.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, tw on {tw.device}")
    if x.dim() != 3 or x.shape[0] != N_LIMBS or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (16, B, n) tensor, "
                         f"got {tuple(x.shape)}")
    n = x.shape[2]
    log_n = _log2(n)
    if tw.dim() != 2 or tw.shape[0] != N_LIMBS or tw.shape[1] < n or tw.stride(1) != 1:
        raise ValueError(f"{what}: tw must be a (16, >= {n}) table with "
                         f"unit element stride, got {tuple(tw.shape)}")
    return n, log_n


def ntt_dif_stage(x: torch.Tensor, tw: torch.Tensor, log_m: int) -> torch.Tensor:
    """H3: one DIF stage of half-size 2^log_m, in place on x (16, B, n)."""
    n, log_n = _check("ntt_dif_stage", x, tw)
    if not 0 <= log_m < log_n:
        raise ValueError(f"ntt_dif_stage: log_m {log_m} outside [0, {log_n})")
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.lcp_ntt_dif_stage(
            x.data_ptr(), x[0].numel(), log_n, log_m, tw.data_ptr(),
            tw.stride(0), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "ntt_dif_stage")
    ntt_dif_stage.launches += 1
    return x


ntt_dif_stage.launches = 0


def ntt_dif_local(x: torch.Tensor, tw: torch.Tensor, log_chunk: int) -> torch.Tensor:
    """H4: every DIF stage with m < 2^log_chunk on each 2^log_chunk-point
    chunk of x (16, B, n), in place; 1 <= log_chunk <= min(log n, LOCAL_LOG)."""
    n, log_n = _check("ntt_dif_local", x, tw)
    if not 1 <= log_chunk <= min(log_n, LOCAL_LOG):
        raise ValueError(f"ntt_dif_local: log_chunk {log_chunk} outside "
                         f"[1, {min(log_n, LOCAL_LOG)}]")
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.lcp_ntt_dif_local(
            x.data_ptr(), x[0].numel(), log_chunk, tw.data_ptr(),
            tw.stride(0), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "ntt_dif_local")
    ntt_dif_local.launches += 1
    return x


ntt_dif_local.launches = 0


def ntt_cuda(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Transform along the last axis of a CUDA tensor with H3 + H4."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x.clone()
    tw = twiddle_table(log_n, inverse, x.device)
    lead = x.shape[1:-1]
    y = torch.empty((N_LIMBS, x[0].numel() // n, n), dtype=torch.int32,
                    device=x.device)
    y.copy_(x.reshape(N_LIMBS, -1, n))
    for log_m in range(log_n - 1, LOCAL_LOG - 1, -1):
        ntt_dif_stage(y, tw, log_m)
    ntt_dif_local(y, tw, min(log_n, LOCAL_LOG))
    y = y.index_select(-1, bitrev_indices(log_n, x.device))
    return y.reshape((N_LIMBS,) + tuple(lead) + (n,))
