"""NTT / coset LDE / polynomial helpers over Stark252 limb tensors.

Mirrors the JAX package's ntt/core.py (lambdaworks `FFTPoly` semantics):
``evaluate(coeffs)[i] = p(offset * w^i)`` with ``w`` the primitive root of
order N and evaluations in natural order.  Transforms run along the last
axis; axes between the limb axis and the last are batch.

A CUDA tensor is transformed by the H3 + H4 kernels (``cuda_ntt.ntt_cuda``),
a CPU tensor by the plain radix-2 NTT (``cuda_ntt.ntt_plain``).  The kernels
bake the Stark252 prime, so a toy field (``LCP_FIELD``; its largest NTT is
2^TWO_ADICITY points) takes the plain NTT on every device, as it takes the
plain field ops.  Tables are built on the input's device from ``params``
and cached in plain dicts.
"""

from __future__ import annotations

import torch

from ..field import device as fd
from ..field.params import N_LIMBS, P, SPARSE_P
from . import cuda_ntt

_powers_cache: dict = {}  # (offset, n, device) -> (16, n) powers


def offset_powers(offset: int, n: int, device) -> torch.Tensor:
    """[offset^0 .. offset^(n-1)] (Montgomery limbs) on ``device``, cached."""
    key = (offset % P, n, torch.device(device))
    if key not in _powers_cache:
        _powers_cache[key] = fd.powers(offset, n, device=device)
    return _powers_cache[key]


def forget_powers(offset: int, n: int, device) -> None:
    """Drop the cached :func:`offset_powers` table, if there is one."""
    _powers_cache.pop((offset % P, n, torch.device(device)), None)


def transform(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The DFT along the last axis, natural order both ends, not scaled by
    1/n: the local transforms of the four-step NTT (parallel/four_step.py)."""
    if x.device.type == "cpu" or not SPARSE_P:
        return cuda_ntt.ntt_plain(x, inverse)
    return cuda_ntt.ntt_cuda(x, inverse)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward transform: coefficients -> evaluations at w^i (natural order)."""
    return transform(x, inverse=False)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse transform: evaluations at w^i (natural order) -> coefficients."""
    n = x.shape[-1]
    if n == 1:
        return x.clone()
    y = transform(x, inverse=True)
    n_inv = fd.from_int(pow(n, P - 2, P), device=x.device)
    return fd.mul(y, n_inv.reshape((N_LIMBS,) + (1,) * (y.dim() - 1)))


def interpolate_fft(evals: torch.Tensor) -> torch.Tensor:
    """Coefficients of the poly with values ``evals`` on the natural domain."""
    return intt(evals)


def scale_poly(coeffs: torch.Tensor, factor: int) -> torch.Tensor:
    """p(factor * X): multiply coeff i by factor^i (last axis)."""
    return fd.mul(coeffs, offset_powers(factor, coeffs.shape[-1], coeffs.device))


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _pad_coeffs(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    cur = coeffs.shape[-1]
    if cur == n:
        return coeffs
    if cur > n:
        return coeffs[..., :n]
    pad = torch.zeros(coeffs.shape[:-1] + (n - cur,), dtype=coeffs.dtype,
                      device=coeffs.device)
    return torch.cat([coeffs, pad], dim=-1)


def evaluate_offset_fft(coeffs: torch.Tensor, blowup: int,
                        domain_size: int | None, offset: int) -> torch.Tensor:
    """lambdaworks `evaluate_offset_fft`: evaluations of p on the coset
    offset * <w_N>, N = next_pow2(max(len(coeffs), domain_size)) * blowup."""
    base = max(coeffs.shape[-1], domain_size or 0)
    n_fft = _next_pow2(base) * blowup
    return ntt(_pad_coeffs(scale_poly(coeffs, offset), n_fft))


def evaluate_fft(coeffs: torch.Tensor, blowup: int = 1,
                 domain_size: int | None = None) -> torch.Tensor:
    base = max(coeffs.shape[-1], domain_size or 0)
    return ntt(_pad_coeffs(coeffs, _next_pow2(base) * blowup))


def evaluate_on_lde_domain(coeffs: torch.Tensor, blowup: int, domain_size: int,
                           offset: int) -> torch.Tensor:
    """Reference `evaluate_polynomial_on_lde_domain` (prover.rs:106-123):
    evaluate, then subsample down to domain_size * blowup points."""
    evals = evaluate_offset_fft(coeffs, blowup, domain_size, offset)
    step = evals.shape[-1] // (domain_size * blowup)
    if step > 1:
        evals = evals[..., ::step].contiguous()
    return evals


def interpolate_offset_fft(evals: torch.Tensor, offset: int) -> torch.Tensor:
    """Coefficients of the poly interpolating ``evals`` on offset * <w_n>."""
    return scale_poly(intt(evals), pow(offset, P - 2, P))


def sum_reduce(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Modular sum along a batch axis by folding halves (log2 adds)."""
    x = torch.movedim(x, axis, 1).contiguous()
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        folded = fd.add(x[:, :h], x[:, h:2 * h])
        x = torch.cat([folded, x[:, 2 * h:]], dim=1) if x.shape[1] % 2 else folded
    return x[:, 0]


def poly_eval_at(coeffs: torch.Tensor, point: int) -> torch.Tensor:
    """Evaluate coefficients (last axis) at a host scalar point: a (16, ...)
    limb tensor, dot(coeffs, powers(point))."""
    pw = fd.powers(point, coeffs.shape[-1], device=coeffs.device)
    return sum_reduce(fd.mul(coeffs, pw), axis=-1)
