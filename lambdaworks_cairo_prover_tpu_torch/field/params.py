"""Prime-field parameters (Stark252 by default; toy fields selectable).

The default field is GF(p) with p = 2^251 + 17*2^192 + 1 (the StarkWare /
Cairo field).  Mirrors the capability surface of `lambdaworks-math`'s
`Stark252PrimeField` (reference usage: src/lib.rs:12-13,
runner/run.rs:300-305).

The reference engine is generic over `IsFFTField` and is exercised over a
17-element toy field in its tests (tests/integration_tests.rs:56-77) — the
analogous seam here is the ``LCP_FIELD`` environment variable, selected at
import time (the limb tables and twiddle caches are process-wide):

  * ``stark252`` (default) — the Cairo prime
  * ``f257``     — GF(257): q - 1 = 2^8, so every NTT up to 256 points
    works and every intermediate value is hand-checkable.  The CUDA
    kernels bake the sparse Stark252 prime, so this field takes the plain
    PyTorch field ops and NTT (generic m*p reduction) on every device.

Device representation: 16 little-endian limbs of 16 bits each, held in
int32 tensor lanes (values < 2^16), in Montgomery form with R = 2^256.  The Stark252 prime is
extremely sparse in this basis — limbs [1, 0,...,0, 17, 0, 0, 2048] — and
p = 1 (mod 2^16), so its Montgomery reduction needs no multiplications by
p' ( -p^-1 mod 2^16 = 0xffff, hence m_i = (-T_i) mod 2^16 ).
"""

import os

_FIELD = os.environ.get("LCP_FIELD", "stark252")

if _FIELD == "stark252":
    # The STARK prime.
    P = (1 << 251) + 17 * (1 << 192) + 1
    _GENERATOR = 3
elif _FIELD == "f257":
    P = 257
    _GENERATOR = 3
else:
    raise ValueError(f"unknown LCP_FIELD {_FIELD!r}")

N_LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# Montgomery constants, R = 2^256.
R = (1 << 256) % P
R2 = (R * R) % P
R_INV = pow(R, P - 2, P)

# Limbs of p (little-endian 16-bit).
P_LIMBS = [(P >> (LIMB_BITS * i)) & LIMB_MASK for i in range(N_LIMBS)]

# Whether the fast sparse-prime reduction (limbs {1@0, 17@12, 2048@15})
# applies; other fields take the generic m*p path in device.mul.
SPARSE_P = P_LIMBS == [1] + [0] * 11 + [17, 0, 0, 2048]
if _FIELD == "stark252":
    assert SPARSE_P

# -p^-1 mod 2^256 (for single-shot Montgomery reduction m = T_lo * PINV).
P_INV_NEG = (-pow(P, -1, 1 << 256)) % (1 << 256)
P_INV_NEG_LIMBS = [(P_INV_NEG >> (LIMB_BITS * i)) & LIMB_MASK
                   for i in range(N_LIMBS)]

# Two-adicity of p - 1 and the canonical maximal-order root of unity
# (lambdaworks `TWO_ADIC_PRIMITVE_ROOT_OF_UNITY` convention: derived from
# the field generator; for Stark252 this equals 3^((p-1)/2^192) mod p).
TWO_ADICITY = ((P - 1) & -(P - 1)).bit_length() - 1
TWO_ADIC_ROOT = pow(_GENERATOR, (P - 1) >> TWO_ADICITY, P)
assert pow(TWO_ADIC_ROOT, 1 << TWO_ADICITY, P) == 1
assert pow(TWO_ADIC_ROOT, 1 << (TWO_ADICITY - 1), P) != 1

# Field metadata mirroring lambdaworks' `field_bit_size()` (Stark252 = 252).
FIELD_BIT_SIZE = P.bit_length()


def get_primitive_root_of_unity(order: int) -> int:
    """2^order-th primitive root of unity (lambdaworks `get_primitive_root_of_unity`)."""
    if order > TWO_ADICITY:
        raise ValueError(f"no 2^{order}-th root of unity")
    return pow(TWO_ADIC_ROOT, 1 << (TWO_ADICITY - order), P)
