"""Builtin runners with memory deduction (cairo-vm semantics).

The reference executes programs through the `cairo-vm` crate
(src/cairo/runner/run.rs:76-101), whose builtin runners
deduce the output cells of each builtin instance when they are first read
(`deduce_memory_cell`).  This module implements those deduction rules for
the auto-deduction builtins covered by the prover's layouts
(cairo_layout.rs:2-29):

  * ``bitwise``  — 5 cells/instance: [x, y, x & y, x ^ y, x | y]
  * ``pedersen`` — 3 cells/instance: [a, b, H(a, b)] with H the
    STARK-curve Pedersen hash (curve y^2 = x^3 + x + BETA over the
    Stark252 prime; constant points are the standard cairo-lang
    `pedersen_params` values, validated against the canonical vector
    H(1, 2) = 0x5bb9440e27889a364bcb678b1f679ecd1347acdedcbf36e83494f857cc58026)
  * ``ec_op``    — 7 cells/instance: [px, py, qx, qy, m, rx, ry] with
    (rx, ry) = P + m * Q on the same curve

Deduced cells are written back into the builtin segment, so they reach the
relocated memory and flow into the proof through the memory argument
exactly like instruction-accessed cells (execution_trace.rs:195-255).
"""

from __future__ import annotations

from ..field.params import P

# ---------------------------------------------------------------------------
# STARK curve + Pedersen constants (cairo-lang pedersen_params)
# ---------------------------------------------------------------------------

ALPHA = 1
BETA = 0x6F21413EFBE40DE150E596D72F7A8C5609AD26C15C915C1F4CDFCB99CEE9E89

SHIFT_POINT = (
    0x49EE3EBA8C1600700EE1B87EB599F16716B0B1022947733551FDE4050CA6804,
    0x3CA0CFE4B3BC6DDF346D49D06EA0ED34E621062C0E056C1D0405D266E10268A,
)
PEDERSEN_POINTS = (
    (0x234287DCBAFFE7F969C748655FCA9E58FA8120B6D56EB0C1080D17957EBE47B,
     0x3B056F100F96FB21E889527D41F4E39940135DD7A6C94CC6ED0268EE89E5615),
    (0x4FA56F376C83DB33F9DAB2656558F3399099EC1DE5E3018B7A6932DBA8AA378,
     0x3FA0984C931C9E38113E0C0E47E4401562761F92A7A23B45168F4E80FF5B54D),
    (0x4BA4CC166BE8DEC764910F75B45F74B40C690C74709E90F3AA372F0BD2D6997,
     0x40301CF5C1751F4B971E46C4EDE85FCAC5C59A5CE5AE7C48151F27B24B219C),
    (0x54302DCB0E6CC1C6E44CCA8F61A63BB2CA65048D53FB325D36FF12C49A58202,
     0x1B77B3E37D13504B348046268D8AE25CE98AD783C25561A879DCC77E99C2426),
)

_LOW_MASK = (1 << 248) - 1


def _ec_add(a, b):
    """Affine addition on y^2 = x^3 + ALPHA*x + BETA; None = infinity."""
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        m = (3 * x1 * x1 + ALPHA) * pow(2 * y1, P - 2, P) % P
    else:
        m = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (m * m - x1 - x2) % P
    y3 = (m * (x1 - x3) - y1) % P
    return (x3, y3)


def _ec_mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _ec_add(acc, pt)
        pt = _ec_add(pt, pt)
        k >>= 1
    return acc


def pedersen_hash(a: int, b: int) -> int:
    """STARK-curve Pedersen hash: x-coordinate of
    shift + a_low*P0 + a_high*P1 + b_low*P2 + b_high*P3."""
    pt = SHIFT_POINT
    for x, (p_low, p_high) in ((a, PEDERSEN_POINTS[0:2]),
                               (b, PEDERSEN_POINTS[2:4])):
        if x >> 252:
            raise ValueError(f"pedersen input {x:#x} exceeds 252 bits")
        lo, hi = x & _LOW_MASK, x >> 248
        if lo:
            pt = _ec_add(pt, _ec_mul(lo, p_low))
        if hi:
            pt = _ec_add(pt, _ec_mul(hi, p_high))
    return pt[0]


def ec_op(px: int, py: int, qx: int, qy: int, m: int):
    """r = P + m*Q on the STARK curve (cairo-vm EcOp builtin semantics)."""
    r = _ec_add((px, py), _ec_mul(m, (qx, qy)))
    if r is None:
        raise ValueError("ec_op result is the point at infinity")
    return r


# ---------------------------------------------------------------------------
# Deduction rules: (segment_cells: dict[int, value], offset) -> value | None
# ---------------------------------------------------------------------------

BITWISE_TOTAL_N_BITS = 251  # cairo-vm BitwiseBuiltinRunner default


def deduce_bitwise(cells: dict, offset: int):
    """Cells 2..4 of a 5-cell instance from inputs at 0/1."""
    index = offset % 5
    if index < 2:
        return None
    base = offset - index
    x = cells.get(base)
    y = cells.get(base + 1)
    if not isinstance(x, int) or not isinstance(y, int):
        return None
    for v in (x, y):
        if v >> BITWISE_TOTAL_N_BITS:
            raise ValueError(
                f"bitwise input {v:#x} exceeds {BITWISE_TOTAL_N_BITS} bits")
    if index == 2:
        return x & y
    if index == 3:
        return x ^ y
    return x | y


def deduce_pedersen(cells: dict, offset: int):
    """Cell 2 of a 3-cell instance: H(a, b) from inputs at 0/1."""
    if offset % 3 != 2:
        return None
    a = cells.get(offset - 2)
    b = cells.get(offset - 1)
    if not isinstance(a, int) or not isinstance(b, int):
        return None
    return pedersen_hash(a, b)


def deduce_ec_op(cells: dict, offset: int):
    """Cells 5/6 of a 7-cell instance: P + m*Q from inputs at 0..4."""
    index = offset % 7
    if index < 5:
        return None
    base = offset - index
    vals = [cells.get(base + i) for i in range(5)]
    if not all(isinstance(v, int) for v in vals):
        return None
    rx, ry = ec_op(*vals)
    return rx if index == 5 else ry


# ---------------------------------------------------------------------------
# ECDSA signature builtin (cairo-vm SignatureBuiltinRunner semantics)
# ---------------------------------------------------------------------------
#
# NOT a deduce-on-read builtin: each 2-cell instance [pub_key, message] is
# written by the program, and the (r, s) signature arrives separately via
# the stdlib verify_ecdsa_signature hint (`ecdsa_builtin.add_signature`).
# The VM validates the instance when both cells are present (vm.py mem_set
# validation hook), exactly like cairo-vm's validation rules.  Constants
# are the cairo-lang signature parameters (starkware fast_pedersen/ecdsa).

ECDSA_CELLS_PER_INSTANCE = 2  # [pub_key, message]

EC_ORDER = 0x800000000000010FFFFFFFFFFFFFFFFB781126DCAE7B2321E66A241ADC64D2F
EC_GEN = (
    0x1EF15C18599971B7BECED415A40F0C7DEACFD9B0D1819E03D723D8BC943CFCA,
    0x5668060AA49730B7BE4801DF46EC62DE53ECD11ABE43A32873000C36E8DC1F,
)


def sqrt_mod_p(a: int) -> int | None:
    """Tonelli–Shanks square root mod the Stark prime (p = 1 mod 4);
    None when `a` is a non-residue."""
    a %= P
    if a == 0:
        return 0
    if pow(a, (P - 1) // 2, P) != 1:
        return None
    # factor p-1 = q * 2^s
    q, s = P - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue
    z = 2
    while pow(z, (P - 1) // 2, P) != P - 1:
        z += 1
    m, c, t, r = s, pow(z, q, P), pow(a, q, P), pow(a, (q + 1) // 2, P)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m, c = i, b * b % P
        t, r = t * c % P, r * b % P
    return r


def recover_y(x: int) -> int | None:
    """A y with (x, y) on the STARK curve, or None if x is not on it."""
    return sqrt_mod_p((pow(x, 3, P) + ALPHA * x + BETA) % P)


def verify_ecdsa(pub_x: int, msg: int, r: int, s: int) -> bool:
    """STARK-curve ECDSA verification (starkware signature.py `verify`):
    with w = s^-1 mod EC_ORDER, valid iff r == x(msg*w*G + r*w*Q) for
    either candidate public-key point Q = (pub_x, ±y)."""
    if not (1 <= r < 1 << 251) or not (1 <= s < EC_ORDER):
        return False
    if msg >> 251:
        return False
    y = recover_y(pub_x)
    if y is None:
        return False
    w = pow(s, EC_ORDER - 2, EC_ORDER)
    u1 = msg * w % EC_ORDER
    u2 = r * w % EC_ORDER
    base = _ec_mul(u1, EC_GEN) if u1 else None
    for cand_y in (y, P - y):
        pt = _ec_add(base, _ec_mul(u2, (pub_x, cand_y)))
        if pt is not None and pt[0] == r:
            return True
    return False


def ecdsa_sign(priv_key: int, msg: int, k: int) -> tuple[int, int]:
    """Deterministic-k signing (starkware signature.py `sign`); test/fixture
    helper — the builtin itself only verifies."""
    if not (1 <= k < EC_ORDER):
        raise ValueError("k out of range")
    r = _ec_mul(k, EC_GEN)[0]
    if not (1 <= r < 1 << 251):
        raise ValueError("bad k: r out of range, pick another")
    denom = (msg + r * priv_key) % EC_ORDER
    if denom == 0:
        raise ValueError("bad k: msg + r*priv == 0 mod order")
    w = k * pow(denom, EC_ORDER - 2, EC_ORDER) % EC_ORDER
    if not (1 <= w < 1 << 251):
        raise ValueError("bad k: w out of range, pick another")
    s = pow(w, EC_ORDER - 2, EC_ORDER)
    return r, s


# ---------------------------------------------------------------------------
# keccak builtin (cairo-vm KeccakBuiltinRunner deduction)
# ---------------------------------------------------------------------------

KECCAK_CELLS_PER_INSTANCE = 16  # 8 input + 8 output felts of 200 bits
_KECCAK_FELT_BITS = 200
_KECCAK_FELT_MASK = (1 << _KECCAK_FELT_BITS) - 1


def keccak_builtin_permute(inputs: list[int]) -> list[int]:
    """keccak-f[1600] over 8x200-bit input felts (little-endian packing),
    returning 8x200-bit output felts — cairo-vm keccak_instance_def
    semantics (state bit k = bit k%200 of felt k//200)."""
    from ..hash.keccak_host import keccak_f

    acc = 0
    for i, v in enumerate(inputs):
        if v >> _KECCAK_FELT_BITS:
            raise ValueError(
                f"keccak builtin input {v:#x} exceeds {_KECCAK_FELT_BITS} "
                f"bits")
        acc |= v << (_KECCAK_FELT_BITS * i)
    raw = acc.to_bytes(200, "little")
    lanes = [int.from_bytes(raw[8 * j: 8 * j + 8], "little")
             for j in range(25)]
    out_lanes = keccak_f(lanes)
    out_acc = int.from_bytes(
        b"".join(v.to_bytes(8, "little") for v in out_lanes), "little")
    return [(out_acc >> (_KECCAK_FELT_BITS * j)) & _KECCAK_FELT_MASK
            for j in range(8)]


def deduce_keccak(cells: dict, offset: int):
    """Cells 8..15 of a 16-cell instance from the 8 input felts."""
    index = offset % KECCAK_CELLS_PER_INSTANCE
    if index < 8:
        return None
    base = offset - index
    vals = [cells.get(base + i) for i in range(8)]
    if not all(isinstance(v, int) for v in vals):
        return None
    return keccak_builtin_permute(vals)[index - 8]


# ---------------------------------------------------------------------------
# poseidon builtin (cairo-vm PoseidonBuiltinRunner deduction)
# ---------------------------------------------------------------------------
#
# Starknet Poseidon over the Stark252 field: state width m = 3 (rate 2,
# capacity 1), 8 full + 83 partial Hades rounds, S-box x^3 (partial rounds
# s-box the LAST state element), MDS [[3,1,1],[1,-1,1],[1,1,-2]], round
# constants ark[i][j] = sha256("Hades" + str(3*i+j)) mod p — the exact
# generation rule of cairo-lang's poseidon_utils.py.  (The canonical
# cross-check against cairo-lang itself is environment-blocked — no
# package, no egress; tests pin a self-generated vector for regression.)

POSEIDON_CELLS_PER_INSTANCE = 6  # 3 input + 3 output felts
_POSEIDON_FULL_ROUNDS = 8
_POSEIDON_PARTIAL_ROUNDS = 83
_POSEIDON_MDS = ((3, 1, 1), (1, P - 1, 1), (1, 1, P - 2))

_poseidon_ark: list | None = None


def _poseidon_constants():
    global _poseidon_ark
    if _poseidon_ark is None:
        from hashlib import sha256

        n_rounds = _POSEIDON_FULL_ROUNDS + _POSEIDON_PARTIAL_ROUNDS
        _poseidon_ark = [
            [int.from_bytes(
                sha256(f"Hades{3 * i + j}".encode()).digest(), "big") % P
             for j in range(3)]
            for i in range(n_rounds)
        ]
    return _poseidon_ark


def hades_permutation(values: list[int]) -> list[int]:
    """cairo-lang poseidon_utils.hades_permutation (width-3 state)."""
    ark = _poseidon_constants()
    state = [v % P for v in values]
    half_full = _POSEIDON_FULL_ROUNDS // 2
    r = 0

    def rnd(full: bool):
        nonlocal state, r
        state = [(v + c) % P for v, c in zip(state, ark[r])]
        if full:
            state = [pow(v, 3, P) for v in state]
        else:
            state[2] = pow(state[2], 3, P)
        state = [sum(m * v for m, v in zip(row, state)) % P
                 for row in _POSEIDON_MDS]
        r += 1

    for _ in range(half_full):
        rnd(True)
    for _ in range(_POSEIDON_PARTIAL_ROUNDS):
        rnd(False)
    for _ in range(half_full):
        rnd(True)
    return state


def deduce_poseidon(cells: dict, offset: int):
    """Cells 3..5 of a 6-cell instance: hades_permutation of cells 0..2."""
    index = offset % POSEIDON_CELLS_PER_INSTANCE
    if index < 3:
        return None
    base = offset - index
    vals = [cells.get(base + i) for i in range(3)]
    if not all(isinstance(v, int) for v in vals):
        return None
    return hades_permutation(vals)[index - 3]


DEDUCERS = {
    "bitwise": deduce_bitwise,
    "pedersen": deduce_pedersen,
    "ec_op": deduce_ec_op,
    "keccak": deduce_keccak,
    "poseidon": deduce_poseidon,
}
