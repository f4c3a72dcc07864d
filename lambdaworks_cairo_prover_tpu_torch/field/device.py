"""Prime-field arithmetic over limb or packed tensors (PyTorch): Stark252,
or the toy field that ``LCP_FIELD`` selects.

Every function takes int32 tensors whose LEADING axis holds an element, in
either layout of the JAX package (field/device.py), so arrays pass between
the two packages unchanged:

* limbs ``(16, ...)``: little-endian 16-bit limbs, values < 2^16;
* packed ``(8, ...)``: two limbs a 32-bit word (:func:`pack`), the at-rest
  layout of the resident trace, LDE and domain tables; half the bytes.

Elements are in Montgomery form (R = 2^256) and canonical (< p) unless
noted.  ``mul``, ``add``, ``sub`` (and ``neg``, ``square``, ``from_mont``,
``to_mont``) take operands in either layout and ``packed``, the result's:
True, False, or None for packed where any operand is packed.  A caller
whose consumer reads only limbs (the NTT, the scans, Keccak) asks for
``packed=False`` from the product or sum that makes its input, so no pass
unpacks between them; :func:`pack` and :func:`unpack` count their calls.

Dispatch rule: under the Stark252 prime a CUDA tensor goes to the
hand-written kernels of ``cuda_field`` (mul -> H1, add/sub/neg -> H2) and
``cuda_scan`` (batch_inverse -> H5, prefix_product -> H6), whatever its
size; a CPU tensor goes to their plain PyTorch versions.  The
kernels bake the sparse Stark252 prime, so a toy field takes the plain
versions on every device: the choice is fixed by ``params.SPARSE_P`` at
import, as in the JAX package (field/device.py:mul).  There is no fallback
from one to the other.  Functions that make a tensor from nothing take its
device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_field as cf
from . import cuda_scan as cs
from .params import N_LIMBS, P, R, R2, SPARSE_P

_I32 = torch.int32

# ---------------------------------------------------------------------------
# Host <-> tensor conversion
# ---------------------------------------------------------------------------


def from_ints(values, mont: bool = True, *, device) -> torch.Tensor:
    """Python ints -> (16, len(values)) int32 limb tensor on ``device``.

    If ``mont`` the values are converted to Montgomery form on the host."""
    vals = [(v * R) % P if mont else v % P for v in values]
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    limbs = np.frombuffer(buf, dtype=np.uint16).reshape(len(vals), N_LIMBS)
    arr = np.ascontiguousarray(limbs.T.astype(np.int32))
    return torch.from_numpy(arr).to(device)


def to_ints(limbs, mont: bool = True) -> list:
    """(16, ...) limbs or (8, ...) packed words -> flat list of python ints
    (out of Montgomery form)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs)
    if arr.shape[0] == N_LIMBS // 2:  # words: the uint32 bit patterns
        arr = (arr.astype(np.int64) & 0xFFFFFFFF).astype("<u4")
    else:
        arr = arr.astype(np.uint16)
    arr = arr.reshape(arr.shape[0], -1).T.copy()
    out = []
    r_inv = pow(R, P - 2, P)
    for row in arr:
        v = int.from_bytes(row.tobytes(), "little")
        out.append((v * r_inv) % P if mont else v)
    return out


def from_int(value: int, mont: bool = True, *, device) -> torch.Tensor:
    """Single python int -> shape (16, 1) limb tensor."""
    return from_ints([value], mont=mont, device=device)


def to_int(limbs, mont: bool = True) -> int:
    return to_ints(limbs, mont=mont)[0]


def zeros(shape=(), *, device) -> torch.Tensor:
    return torch.zeros((N_LIMBS,) + tuple(shape), dtype=_I32, device=device)


_const_cache: dict = {}  # (value, mont, device) -> (16, 1) limbs


def constant(value: int, mont: bool = True, *, device) -> torch.Tensor:
    """:func:`from_int`, cached per device: a constant that the device's
    queue reads again and again is copied to the device once."""
    key = (value % P, mont, torch.device(device))
    if key not in _const_cache:
        _const_cache[key] = from_int(value, mont=mont, device=device)
    return _const_cache[key]


def ones(shape=(), *, device) -> torch.Tensor:
    """Montgomery-form one (= R mod p) broadcast to the batch shape."""
    one = from_int(1, device=device).reshape((N_LIMBS,) + (1,) * len(tuple(shape)))
    return one.expand((N_LIMBS,) + tuple(shape))


# ---------------------------------------------------------------------------
# Packed layout: two 16-bit limbs a 32-bit word (the JAX package's at-rest
# layout, field/device.py:pack), half the bytes of the limb layout.  Words
# are int32 carrying the uint32 bit pattern (a word whose top bit is set is
# negative), as the kernels read them: CPU torch has no uint32 arithmetic,
# and int32 shifts and masks act on the bits as on uint32 where the mask
# follows an arithmetic shift.  Each conversion is a pass over the tensor:
# ``pack.calls`` and ``unpack.calls`` count them.
# ---------------------------------------------------------------------------


def pack(a: torch.Tensor) -> torch.Tensor:
    """(16, ...) 16-bit limbs -> (8, ...) int32 words, limb 2k | limb 2k+1 << 16."""
    pack.calls += 1
    return cf.pack_words(a)


pack.calls = 0


def unpack(p: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(8, ...) packed words (int32 bit patterns, or int64 words < 2^32) ->
    (16, ...) int32 16-bit limbs, written into ``out`` where given."""
    unpack.calls += 1
    return cf.unpack_words(p, out)


unpack.calls = 0

is_packed = cf.is_packed


def unpacked(a: torch.Tensor) -> torch.Tensor:
    """``a`` as (16, ...) limbs, whichever layout it is in."""
    return unpack(a) if is_packed(a) else a


def _same_layout(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in one layout: the packed one's, where they differ."""
    if is_packed(a) == is_packed(b):
        return a, b
    return (a, pack(b)) if is_packed(a) else (pack(a), b)


# ---------------------------------------------------------------------------
# Elementwise arithmetic (kernel on CUDA, plain version on CPU)
# ---------------------------------------------------------------------------


def _plain(a: torch.Tensor, b: torch.Tensor) -> bool:
    return not SPARSE_P or (a.device.type == "cpu" and b.device.type == "cpu")


def add(a: torch.Tensor, b: torch.Tensor,
        packed: bool | None = None) -> torch.Tensor:
    """Modular addition of canonical tensors."""
    if _plain(a, b):
        return cf.add_plain(a, b, packed)
    return cf.add_sub_mod(a, b, "add", packed)


def sub(a: torch.Tensor, b: torch.Tensor,
        packed: bool | None = None) -> torch.Tensor:
    """Modular subtraction a - b."""
    if _plain(a, b):
        return cf.sub_plain(a, b, packed)
    return cf.add_sub_mod(a, b, "sub", packed)


def neg(a: torch.Tensor, packed: bool | None = None) -> torch.Tensor:
    return sub(zeros((1,) * (a.dim() - 1), device=a.device), a, packed)


def mul(a: torch.Tensor, b: torch.Tensor,
        packed: bool | None = None) -> torch.Tensor:
    """Montgomery product REDC(a*b); canonical output."""
    return (cf.mul_plain(a, b, packed) if _plain(a, b)
            else cf.mont_mul(a, b, packed))


def square(a: torch.Tensor, packed: bool | None = None) -> torch.Tensor:
    return mul(a, a, packed)


def from_mont(a: torch.Tensor, packed: bool | None = None) -> torch.Tensor:
    """Montgomery form -> canonical residues (REDC with 1)."""
    one = constant(1, mont=False, device=a.device)
    return mul(a, one.reshape((N_LIMBS,) + (1,) * (a.dim() - 1)), packed)


def to_mont(a: torch.Tensor, packed: bool | None = None) -> torch.Tensor:
    """Canonical residues -> Montgomery form (multiply by R^2)."""
    r2 = constant(R2, mont=False, device=a.device)
    return mul(a, r2.reshape((N_LIMBS,) + (1,) * (a.dim() - 1)), packed)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask over the batch shape: element == 0 (either layout)."""
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _same_layout(a, b)
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise where over the batch shape (mask broadcast against the
    leading axis); the packed layout where a and b differ."""
    a, b = _same_layout(a, b)
    return torch.where(mask.unsqueeze(0), a, b)


# ---------------------------------------------------------------------------
# Exponentiation / inversion
# ---------------------------------------------------------------------------


def pow_u64(a: torch.Tensor, e: int) -> torch.Tensor:
    """Power with a python-int exponent (square-and-multiply)."""
    if e == 0:
        return ones(a.shape[1:], device=a.device).contiguous()
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2), left to right; 0 maps to 0."""
    return cs.fermat(a, mul)


def _limbs_only(x: torch.Tensor, what: str) -> None:
    if is_packed(x):
        raise ValueError(f"{what} takes (16, n) limbs: ask the product or "
                         "sum that makes its input for packed=False")


def batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """Montgomery-trick batch inversion along axis 1 of ``x`` (16, n);
    zeros map to zero (lambdaworks `inplace_batch_inverse`): H5 on a CUDA
    tensor, the chunked plain scan otherwise."""
    _limbs_only(x, "batch_inverse")
    if _plain(x, x):
        return cs.batch_inverse_plain(x)
    return cs.mont_batch_inverse(x.contiguous())


def prefix_product(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along axis 1 of ``x`` (16, n): H6 on a CUDA
    tensor, the chunked plain scan otherwise."""
    _limbs_only(x, "prefix_product")
    if _plain(x, x):
        return cs.prefix_product_plain(x)
    return cs.mont_prefix_product(x.contiguous())


# ---------------------------------------------------------------------------
# Power tables
# ---------------------------------------------------------------------------


def _host_powers(base: int, n: int) -> list:
    vals = [1] * n
    cur = 1
    for i in range(1, n):
        cur = cur * base % P
        vals[i] = cur
    return vals


def powers(base_int: int, n: int, *, device) -> torch.Tensor:
    """[1, b, b^2, ..., b^(n-1)] as (16, n) Montgomery limbs on ``device``.

    Up to 1024 entries are built on the host; above that, 2*sqrt(n) host
    powers b^i (i < s) and b^(s*j) and one device product of the two."""
    if n <= 0:
        return zeros((0,), device=device)
    base_int %= P
    if n <= 1024:
        return from_ints(_host_powers(base_int, n), device=device)
    s = 1 << ((n - 1).bit_length() + 1) // 2
    k = -(-n // s)
    small_vals = _host_powers(base_int, s)
    step = small_vals[-1] * base_int % P  # b^s
    big_vals = _host_powers(step, k)
    small = from_ints(small_vals, device=device)
    big = from_ints(big_vals, device=device)
    prod = mul(small[:, None, :], big[:, :, None])  # (16, k, s)
    return prod.reshape(N_LIMBS, -1)[:, :n]
