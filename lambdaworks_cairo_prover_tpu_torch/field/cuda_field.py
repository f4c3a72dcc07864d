"""H1 `mont_mul` and H2 `add_sub_mod`: wrappers of the elementwise CUDA
kernels (csrc/field_ops.cu), with their plain PyTorch versions.

Replace the TPU kernels of the JAX package's field/pallas_mul.py:
``_mul_kernel`` (H1) and ``_add_kernel``/``_sub_kernel`` (H2).

Operands are int32 tensors in Montgomery form, canonical, that broadcast
against each other on the batch axes, each in either layout of the JAX
package's field/device.py:

* limbs ``(16, ...)``: 16-bit limbs, one a word;
* packed ``(8, ...)``: two limbs a word, limb 2k in the low half of word k
  (the uint32 bit pattern, negative where the top bit is set), as
  :func:`pack_words` makes them; half the bytes.

Every function takes ``packed``, the layout of its result: True, False, or
None for packed where any operand is packed.

* :func:`mont_mul` / :func:`add_sub_mod` launch the kernels.  They take CUDA
  tensors only and raise on anything else before building or launching;
  each adds one to its ``launches`` count per launch.  The kernels bake the
  sparse Stark252 prime (csrc/field.cuh), so under another field
  (``LCP_FIELD``, ``params.SPARSE_P`` false) they refuse to launch.  An
  operand is read in place, whichever its layout, where its batch axes form
  at most two C-contiguous runs of equal length (a scalar, a row, a column,
  a chunk of points cut from several columns: :func:`operand_plan`);
  otherwise it is expanded to contiguous memory.
* :func:`mul_plain` / :func:`add_plain` / :func:`sub_plain` compute the same
  values with plain tensor ops on any device, in int64 with masks (CPU
  torch has no uint32 arithmetic), for any prime of ``params``; they turn
  packed operands into limbs inside and pack the result where asked.  CPU
  tensors use them, as do all tensors of a toy field; the chip check
  compares the kernels against them on the card.
* :func:`pack_words` / :func:`unpack_words` convert between the layouts
  (``field.device.pack`` / ``unpack`` count the main path's calls to them).
"""

from __future__ import annotations

import math

import torch

from .. import cuda_lib
from .params import LIMB_MASK, N_LIMBS, P_INV_NEG_LIMBS, P_LIMBS, SPARSE_P

_I64 = torch.int64
_I32 = torch.int32
N_WORDS = N_LIMBS // 2  # rows of the packed layout
# the nonzero limbs of p: (0, 1), (12, 17), (15, 2048) for Stark252
_P_TERMS = [(k, v) for k, v in enumerate(P_LIMBS) if v]
_P_INV0 = P_INV_NEG_LIMBS[0]  # -p^-1 mod 2^16 (0xffff for Stark252)

# ---------------------------------------------------------------------------
# The two layouts
# ---------------------------------------------------------------------------


def is_packed(x: torch.Tensor) -> bool:
    """Whether ``x`` holds packed words (8, ...) rather than limbs (16, ...)."""
    return x.shape[0] == N_WORDS


def pack_words(a: torch.Tensor) -> torch.Tensor:
    """(16, ...) 16-bit limbs -> (8, ...) int32 words, limb 2k | limb 2k+1 << 16."""
    # sign-extend the high limb to int32 first, so that the shift by 16
    # cannot leave the int32 range
    words = a[1::2].to(_I32) ^ 0x8000
    return words.sub_(0x8000).mul_(0x10000).bitwise_or_(a[0::2].to(_I32))


def unpack_words(p: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(8, ...) packed words (int32 bit patterns, or int64 words < 2^32) ->
    (16, ...) int32 16-bit limbs, written into ``out`` where given."""
    if out is None:
        out = torch.empty((N_LIMBS,) + tuple(p.shape[1:]), dtype=_I32,
                          device=p.device)
    out[0::2] = p & LIMB_MASK
    out[1::2] = (p >> 16) & LIMB_MASK  # mask after the arithmetic shift
    return out


def _out_packed(packed: bool | None, *xs: torch.Tensor) -> bool:
    """The result's layout: ``packed``, or where None, packed iff any
    operand is."""
    return any(is_packed(x) for x in xs) if packed is None else bool(packed)


def _limbs(x: torch.Tensor) -> torch.Tensor:
    return unpack_words(x) if is_packed(x) else x


def _result(limbs: torch.Tensor, packed: bool) -> torch.Tensor:
    limbs = limbs.to(_I32)
    return pack_words(limbs) if packed else limbs


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


def mul_plain(a: torch.Tensor, b: torch.Tensor,
              packed: bool | None = None) -> torch.Tensor:
    """REDC(a*b): 16-bit-limb CIOS with lazy carries and the generic m*p
    reduction (the JAX package's field/device.py:mul): each reduction factor
    is m = t_i * (-p^-1) mod 2^16, and m*p is added over the nonzero limbs
    of p only (for Stark252, p = 1 mod 2^16 makes m = -t_i mod 2^16, and p
    has three nonzero limbs)."""
    packed = _out_packed(packed, a, b)
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = _lift(_limbs(a), shape)
    b = _lift(_limbs(b), shape)
    t = torch.zeros((2 * N_LIMBS + 1,) + tuple(shape), dtype=_I64,
                    device=a.device)
    for i in range(N_LIMBS):
        t[i:i + N_LIMBS] += a[i] * b
        m = ((t[i] & LIMB_MASK) * _P_INV0) & LIMB_MASK
        for k, p_k in _P_TERMS:
            t[i + k] += p_k * m
        t[i + 1] += t[i] >> 16  # t[i] is now 0 mod 2^16
    limbs = _normalize(t[N_LIMBS:], N_LIMBS)  # value < 2p < 2^253
    return _result(_cond_sub_p(limbs), packed)


def add_plain(a: torch.Tensor, b: torch.Tensor,
              packed: bool | None = None) -> torch.Tensor:
    packed = _out_packed(packed, a, b)
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    s = _lift(_limbs(a), shape) + _lift(_limbs(b), shape)
    return _result(_cond_sub_p(_normalize(s, N_LIMBS)), packed)


def sub_plain(a: torch.Tensor, b: torch.Tensor,
              packed: bool | None = None) -> torch.Tensor:
    packed = _out_packed(packed, a, b)
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = _lift(_limbs(a), shape)
    b = _lift(_limbs(b), shape)
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
    return _result(fixed, packed)


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
        if x.dtype != _I32:
            raise TypeError(f"{what}: expected int32 limbs or words, got "
                            f"{x.dtype}")
        if x.dim() < 1 or x.shape[0] not in (N_LIMBS, N_WORDS):
            raise ValueError(f"{what}: expected a (16, ...) limb or (8, ...) "
                             f"packed tensor, got shape {tuple(x.shape)}")


def _runs(full: list, shape: tuple, st: tuple):
    """(run, run stride) of an operand whose own axes are ``full`` (strides
    ``st``): the longest C-contiguous run of its last axes, then the rest
    C-contiguous at the run stride; None where that does not describe it."""
    inner, expect = 0, 1
    for d in reversed(full):
        if st[d] != expect:
            break
        inner += 1
        expect *= shape[d]
    if inner == len(full):
        return None, None  # one run
    if inner == 0:
        return False, None  # the last axis is not contiguous
    outer = full[:len(full) - inner]
    run = math.prod(shape[d] for d in full[len(full) - inner:])
    run_stride = expect = st[outer[-1]]
    for d in reversed(outer):
        if st[d] != expect:
            return False, None
        expect *= shape[d]
    return run, run_stride


def operand_plan(x: torch.Tensor, shape: tuple):
    """How the kernels read ``x`` broadcast to (rows, *shape): (tensor, row
    stride, div, mod, run, run stride), output element e reading element
    i = (e // div) % mod of the tensor's own batch, which lies at
    (i // run) * run_stride + i % run (run == mod: one run).  Where no plan
    describes ``x`` in place, the tensor is a contiguous copy of it expanded
    to the shape."""
    nd = len(shape)
    pad = nd - (x.dim() - 1)
    xs = (1,) * pad + tuple(x.shape[1:])
    st = (0,) * pad + tuple(x.stride()[1:])
    big = [d for d in range(nd) if shape[d] > 1]
    full = [d for d in big if xs[d] == shape[d]]
    run, run_stride = None, None
    if full:
        i0 = big.index(full[0])
        run, run_stride = ((False, None) if big[i0:i0 + len(full)] != full
                           else _runs(full, shape, st))
    if run is False:
        x = x.reshape((x.shape[0],) + xs).expand((x.shape[0],) + tuple(shape))
        x = x.contiguous()
        full, run = big, None
    mod = math.prod(shape[d] for d in full)
    div = math.prod(shape[d] for d in big if full and d > full[-1])
    if run is None:
        run, run_stride = mod, mod
    return x, x.stride(0), div, mod, run, run_stride


def _binop_launch(what: str, fn, a, b, packed, *lead):
    _check_operands(what, a, b)
    packed = _out_packed(packed, a, b)
    shape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    out = torch.empty(((N_WORDS if packed else N_LIMBS),) + shape, dtype=_I32,
                      device=a.device)
    n = math.prod(shape)
    if n == 0:
        return out, False
    plans = [operand_plan(x, shape) for x in (a, b)]  # held to the launch
    args = []
    for x, ls, div, mod, run, run_stride in plans:
        args += [x.data_ptr(), ls, div, mod, run, run_stride, int(is_packed(x))]
    lib = cuda_lib.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn)(*lead, *args, out.data_ptr(), int(packed), n,
                                stream)
    cuda_lib.check(code, what)
    return out, True


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             packed: bool | None = None) -> torch.Tensor:
    """H1: Montgomery product REDC(a*b) of two CUDA tensors."""
    out, launched = _binop_launch("mont_mul", "lcp_mont_mul", a, b, packed)
    mont_mul.launches += int(launched)
    return out


mont_mul.launches = 0


_OPS = {"add": 0, "sub": 1}


def add_sub_mod(a: torch.Tensor, b: torch.Tensor, op: str,
                packed: bool | None = None) -> torch.Tensor:
    """H2: (a + b) or (a - b) mod p of two CUDA tensors (op "add"/"sub")."""
    if op not in _OPS:
        raise ValueError(f"add_sub_mod: unknown op {op!r}")
    out, launched = _binop_launch("add_sub_mod", "lcp_add_sub", a, b, packed,
                                  _OPS[op])
    add_sub_mod.launches += int(launched)
    return out


add_sub_mod.launches = 0
