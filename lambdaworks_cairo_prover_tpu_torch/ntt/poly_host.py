"""Host-side polynomial helpers over Stark252 (python-int coefficients).

Covers the `lambdaworks-math` Polynomial surface the engine needs outside
device-tensor paths (reference usage: frame.rs:79 Horner, prover.rs:436
Ruffini division, debug.rs:93 long division).  Coefficients are ascending
(coeffs[i] multiplies X^i); trailing zeros are trimmed like
`Polynomial::new`.
"""

from __future__ import annotations

from ..field.params import P


def trim(coeffs: list[int]) -> list[int]:
    n = len(coeffs)
    while n > 0 and coeffs[n - 1] % P == 0:
        n -= 1
    return [c % P for c in coeffs[:n]]


def degree(coeffs: list[int]) -> int:
    t = trim(coeffs)
    return len(t) - 1 if t else -1


def evaluate(coeffs: list[int], x: int) -> int:
    """Horner evaluation."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def add(a: list[int], b: list[int]) -> list[int]:
    n = max(len(a), len(b))
    return trim([( (a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % P
                 for i in range(n)])


def scalar_mul(a: list[int], k: int) -> list[int]:
    return trim([c * k % P for c in a])


def mul(a: list[int], b: list[int]) -> list[int]:
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ca in enumerate(a):
        if ca == 0:
            continue
        for j, cb in enumerate(b):
            out[i + j] = (out[i + j] + ca * cb) % P
    return trim(out)


def ruffini_division(coeffs: list[int], a: int) -> list[int]:
    """Divide by (X - a); the remainder (== evaluate(coeffs, a)) is dropped
    (reference `ruffini_division_inplace`, prover.rs:436-473)."""
    out = [0] * (len(coeffs) - 1) if len(coeffs) > 1 else []
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * a + coeffs[i]) % P
        out[i - 1] = acc
    return trim(out)


def long_division(num: list[int], den: list[int]) -> tuple[list[int], list[int]]:
    """(quotient, remainder) (reference `long_division_with_remainder`)."""
    num = trim(num)
    den = trim(den)
    if not den:
        raise ZeroDivisionError("division by zero polynomial")
    if len(num) < len(den):
        return [], num
    num = list(num)
    q = [0] * (len(num) - len(den) + 1)
    inv_lead = pow(den[-1], P - 2, P)
    for i in range(len(q) - 1, -1, -1):
        c = num[i + len(den) - 1] * inv_lead % P
        q[i] = c
        if c:
            for j, d in enumerate(den):
                num[i + j] = (num[i + j] - c * d) % P
    return trim(q), trim(num)


def even_odd_decomposition(coeffs: list[int]) -> tuple[list[int], list[int]]:
    """H(X) = H1(X^2) + X*H2(X^2) (reference `even_odd_decomposition`)."""
    return trim(coeffs[0::2]), trim(coeffs[1::2])


def fold_polynomial(coeffs: list[int], beta: int) -> list[int]:
    """FRI fold: even + beta*odd (reference fri_functions.rs:4-27)."""
    even = coeffs[0::2]
    odd = [c * beta % P for c in coeffs[1::2]]
    n = max(len(even), len(odd))
    return trim([
        ((even[i] if i < len(even) else 0) + (odd[i] if i < len(odd) else 0)) % P
        for i in range(n)
    ])
