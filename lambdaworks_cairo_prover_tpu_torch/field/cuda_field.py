"""H1 `mont_mul` and H2 `add_sub_mod`: wrappers of the elementwise CUDA
kernels (csrc/field_ops.cu), with their plain PyTorch versions.

Replace the TPU kernels of the JAX package's field/pallas_mul.py:
``_mul_kernel`` (H1) and ``_add_kernel``/``_sub_kernel`` (H2).

Operands are ``(16, ...)`` int32 limb tensors (16-bit limbs, Montgomery form,
canonical) that broadcast against each other on the batch axes.

* :func:`mont_mul` / :func:`add_sub_mod` launch the kernels.  They take CUDA
  tensors only and raise on anything else before building or launching;
  each adds one to its ``launches`` count per launch.  The kernels bake the
  sparse Stark252 prime (csrc/field.cuh), so under another field
  (``LCP_FIELD``, ``params.SPARSE_P`` false) they refuse to launch.  A
  broadcast operand is read in place where its batch axes form one
  C-contiguous run (a scalar, a row, a column); otherwise it is expanded to
  contiguous memory.
* :func:`mul_plain` / :func:`add_plain` / :func:`sub_plain` compute the same
  values with plain tensor ops on any device, in int64 with masks (CPU
  torch has no uint32 arithmetic), for any prime of ``params``.  CPU
  tensors use them, as do all tensors of a toy field; the chip check
  compares the kernels against them on the card.
"""

from __future__ import annotations

import math

import torch

from .. import cuda_lib
from .params import LIMB_MASK, N_LIMBS, P_INV_NEG_LIMBS, P_LIMBS, SPARSE_P

_I64 = torch.int64
# the nonzero limbs of p: (0, 1), (12, 17), (15, 2048) for Stark252
_P_TERMS = [(k, v) for k, v in enumerate(P_LIMBS) if v]
_P_INV0 = P_INV_NEG_LIMBS[0]  # -p^-1 mod 2^16 (0xffff for Stark252)

# ---------------------------------------------------------------------------
# Plain versions (int64 limb arithmetic, any device)
# ---------------------------------------------------------------------------


def _lift(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(16, *s) -> int64 (16, 1.., *s) with as many axes as ``shape``."""
    pad = len(shape) - (x.dim() - 1)
    return x.to(_I64).reshape((N_LIMBS,) + (1,) * pad + tuple(x.shape[1:]))


def _normalize(cols: torch.Tensor, n_out: int) -> torch.Tensor:
    """Lazy nonnegative int64 columns -> ``n_out`` clean 16-bit limbs."""
    out = []
    carry = None
    for k in range(n_out):
        v = cols[k] if carry is None else cols[k] + carry
        out.append(v & LIMB_MASK)
        carry = v >> 16
    return torch.stack(out)


def _cond_sub_p(limbs: torch.Tensor) -> torch.Tensor:
    """Clean limbs of a value < 2p -> canonical (< p)."""
    diff = []
    borrow = None
    for k in range(N_LIMBS):
        v = limbs[k] - P_LIMBS[k]
        if borrow is not None:
            v = v - borrow
        borrow = (v < 0).to(_I64)
        diff.append(v & LIMB_MASK)
    return torch.where(borrow == 0, torch.stack(diff), limbs)


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a*b): 16-bit-limb CIOS with lazy carries and the generic m*p
    reduction (the JAX package's field/device.py:mul): each reduction factor
    is m = t_i * (-p^-1) mod 2^16, and m*p is added over the nonzero limbs
    of p only (for Stark252, p = 1 mod 2^16 makes m = -t_i mod 2^16, and p
    has three nonzero limbs)."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = _lift(a, shape)
    b = _lift(b, shape)
    t = torch.zeros((2 * N_LIMBS + 1,) + tuple(shape), dtype=_I64,
                    device=a.device)
    for i in range(N_LIMBS):
        t[i:i + N_LIMBS] += a[i] * b
        m = ((t[i] & LIMB_MASK) * _P_INV0) & LIMB_MASK
        for k, p_k in _P_TERMS:
            t[i + k] += p_k * m
        t[i + 1] += t[i] >> 16  # t[i] is now 0 mod 2^16
    limbs = _normalize(t[N_LIMBS:], N_LIMBS)  # value < 2p < 2^253
    return _cond_sub_p(limbs).to(torch.int32)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    s = _lift(a, shape) + _lift(b, shape)
    return _cond_sub_p(_normalize(s, N_LIMBS)).to(torch.int32)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = _lift(a, shape)
    b = _lift(b, shape)
    diff = []
    borrow = None
    for k in range(N_LIMBS):
        v = a[k] - b[k]
        if borrow is not None:
            v = v - borrow
        borrow = (v < 0).to(_I64)
        diff.append(v & LIMB_MASK)
    diff = torch.stack(diff)
    p = torch.tensor(P_LIMBS, dtype=_I64, device=a.device).reshape(
        (N_LIMBS,) + (1,) * len(shape))
    fixed = _normalize(diff + p * borrow, N_LIMBS)  # carry out of limb 15 dropped
    return fixed.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(what: str, *xs: torch.Tensor) -> None:
    if not SPARSE_P:
        raise ValueError(f"{what}: the CUDA kernel bakes the Stark252 prime; "
                         "this field takes the plain version")
    dev = xs[0].device
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{what}: expected a tensor, got {type(x).__name__}")
        if x.device.type != "cuda":
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {x.device}")
        if x.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 limbs, got {x.dtype}")
        if x.dim() < 1 or x.shape[0] != N_LIMBS:
            raise ValueError(f"{what}: expected a (16, ...) limb tensor, "
                             f"got shape {tuple(x.shape)}")


def _operand(x: torch.Tensor, shape: tuple):
    """Read plan for ``x`` broadcast to (16, *shape): (tensor, limb stride,
    div, mod) with element e of the output read at (e // div) % mod."""
    nd = len(shape)
    pad = nd - (x.dim() - 1)
    xs = (1,) * pad + tuple(x.shape[1:])
    st = (0,) * pad + tuple(x.stride()[1:])
    big = [d for d in range(nd) if shape[d] > 1]
    full = [d for d in big if xs[d] == shape[d]]
    ok = True
    if full:
        i0 = big.index(full[0])
        ok = big[i0:i0 + len(full)] == full
        expect = 1
        for d in reversed(full):
            if not ok:
                break
            ok = st[d] == expect
            expect *= shape[d]
    if not ok:
        x = x.reshape((N_LIMBS,) + xs).expand((N_LIMBS,) + tuple(shape))
        x = x.contiguous()
        full = big
    mod = math.prod(shape[d] for d in full)
    div = math.prod(shape[d] for d in big if full and d > full[-1])
    return x, x.stride(0), div, mod


def _binop_launch(what: str, fn, a, b, *lead):
    _check_operands(what, a, b)
    shape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    out = torch.empty((N_LIMBS,) + shape, dtype=torch.int32, device=a.device)
    n = math.prod(shape)
    if n == 0:
        return out, False
    xa, a_ls, a_div, a_mod = _operand(a, shape)
    xb, b_ls, b_div, b_mod = _operand(b, shape)
    lib = cuda_lib.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(*lead, xa.data_ptr(), a_ls, a_div, a_mod,
                                xb.data_ptr(), b_ls, b_div, b_mod,
                                out.data_ptr(), n, stream)
    cuda_lib.check(code, what)
    return out, True


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H1: Montgomery product REDC(a*b) of two CUDA limb tensors."""
    out, launched = _binop_launch("mont_mul", "lcp_mont_mul", a, b)
    mont_mul.launches += int(launched)
    return out


mont_mul.launches = 0


_OPS = {"add": 0, "sub": 1}


def add_sub_mod(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """H2: (a + b) or (a - b) mod p of two CUDA limb tensors (op "add"/"sub")."""
    if op not in _OPS:
        raise ValueError(f"add_sub_mod: unknown op {op!r}")
    out, launched = _binop_launch("add_sub_mod", "lcp_add_sub", a, b,
                                  _OPS[op])
    add_sub_mod.launches += int(launched)
    return out


add_sub_mod.launches = 0
