"""A STARK verifier in Python integers: the protocol of lambdaworks'
`src/starks/verifier.rs` (the Starknet stack prover), with the proof's wire
format of `src/starks/proof/stark.rs` and the Keccak-256 Fiat-Shamir
transcript of lambdaworks-crypto's `DefaultTranscript`.

It is the yardstick that decides whether a proof is correct: written apart
from the prover under test, it imports nothing of it and reads only the
proof's bytes and the statement that the caller works out itself
(`cairo.statement`).  Every check returns a reason, so that a rejected proof
says which layer broke."""

from __future__ import annotations

from dataclasses import dataclass

from .keccak import keccak256, keccak256_batch, merkle_roots

# the Stark252 field: p = 2^251 + 17 * 2^192 + 1, generator 3
P = (1 << 251) + 17 * (1 << 192) + 1
TWO_ADICITY = 192
_TWO_ADIC_ROOT = pow(3, (P - 1) >> TWO_ADICITY, P)
FELT = 32


def root_of_unity(log_order: int) -> int:
    return pow(_TWO_ADIC_ROOT, 1 << (TWO_ADICITY - log_order), P)


def inv(a: int) -> int:
    return pow(a, P - 2, P)


def batch_inverse(values: list[int]) -> list[int]:
    prefix = [1]
    for v in values:
        prefix.append(prefix[-1] * v % P)
    acc = inv(prefix[-1])
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * acc % P
        acc = acc * values[i] % P
    return out


def felt_bytes(a: int) -> bytes:
    return a.to_bytes(FELT, "big")


class Reject(Exception):
    """A proof that the verifier refuses; the message names the check."""


# -- Fiat-Shamir ------------------------------------------------------------

class Transcript:
    """Keccak-256 accumulator: a challenge is the digest of all bytes since
    the last one, and the digest seeds what follows."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def append(self, data: bytes) -> None:
        self._buf.extend(data)

    def challenge(self) -> bytes:
        digest = keccak256(bytes(self._buf))
        self._buf = bytearray(digest)
        return digest

    def field(self) -> int:
        """A challenge masked to 251 bits, big-endian (always below p)."""
        c = bytearray(self.challenge())
        c[0] &= 0x07
        return int.from_bytes(c, "big")

    def usize(self) -> int:
        return int.from_bytes(self.challenge()[:8], "big")


# -- the proof's wire format ------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise Reject("proof bytes end early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "big")

    def felt(self, length: int = FELT) -> int:
        if length != FELT:
            raise Reject(f"field element of {length} bytes")
        v = int.from_bytes(self.take(FELT), "big")
        if v >= P:
            raise Reject("field element not below p")
        return v

    def felts(self, count: int, length: int = FELT) -> list[int]:
        return [self.felt(length) for _ in range(count)]

    def path(self) -> list[bytes]:
        return [self.take(32) for _ in range(self.u64())]

    def sub(self) -> "_Reader":
        return _Reader(self.take(self.u64()))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise Reject(f"{len(self.data) - self.pos} bytes left over")


@dataclass
class Query:
    paths_sym: list
    evals_sym: list
    evals: list
    paths: list


@dataclass
class Opening:
    comp_path: list
    comp_even: int
    comp_odd: int
    trace_paths: list
    trace_evals: list


@dataclass
class Proof:
    trace_length: int
    trace_roots: list
    ood_rows: list
    comp_root: bytes
    comp_even_ood: int
    comp_odd_ood: int
    fri_roots: list
    fri_last: int
    queries: list
    openings: list
    nonce: int


def parse_proof(data: bytes) -> Proof:
    r = _Reader(data)
    trace_length = r.u64()
    trace_roots = [r.take(32) for _ in range(r.u64())]
    fr = r.sub()
    n_data, felt_len = fr.u64(), fr.u64()
    flat = fr.felts(n_data, felt_len) if n_data else []
    width = fr.u64()
    fr.done()
    if width == 0 or len(flat) % width:
        raise Reject("out-of-domain frame of no or ragged width")
    ood_rows = [flat[i:i + width] for i in range(0, len(flat), width)]
    comp_root = r.take(32)
    felt_len = r.u64()
    comp_even_ood, comp_odd_ood = r.felt(felt_len), r.felt(felt_len)
    fri_roots = [r.take(32) for _ in range(r.u64())]
    fri_last = r.felt(felt_len)
    queries = []
    for _ in range(r.u64()):
        q = r.sub()
        paths_sym = [q.path() for _ in range(q.u64())]
        flen = q.u64()
        evals_sym = q.felts(q.u64(), flen)
        evals = q.felts(q.u64(), flen)
        paths = [q.path() for _ in range(q.u64())]
        q.done()
        queries.append(Query(paths_sym, evals_sym, evals, paths))
    openings = []
    for _ in range(r.u64()):
        o = r.sub()
        comp_path = o.path()
        flen = o.u64()
        even, odd = o.felt(flen), o.felt(flen)
        trace_paths = [o.path() for _ in range(o.u64())]
        trace_evals = o.felts(o.u64(), flen)
        o.done()
        openings.append(Opening(comp_path, even, odd, trace_paths,
                                trace_evals))
    nonce = r.u64()
    r.done()
    return Proof(trace_length, trace_roots, ood_rows, comp_root,
                 comp_even_ood, comp_odd_ood, fri_roots, fri_last, queries,
                 openings, nonce)


# -- the verifier -----------------------------------------------------------

@dataclass(frozen=True)
class Options:
    blowup_factor: int
    fri_number_of_queries: int
    coset_offset: int
    grinding_factor: int


def _leading_zeros(challenge: bytes, nonce: int) -> int:
    """Trailing zeros of the digest's first 8 bytes read big-endian
    (the reference's grinding rule, `grinding.rs:17-29`)."""
    head = int.from_bytes(keccak256(challenge + nonce.to_bytes(8, "little"))
                          [:8], "big")
    return 64 if head == 0 else (head & -head).bit_length() - 1


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise Reject(what)


def verify(proof_bytes: bytes, air, options: Options) -> None:
    """Raise `Reject` unless ``proof_bytes`` proves ``air``'s statement.

    ``air`` gives the trace length and the columns it expects, the boundary
    and transition constraints, their degrees and exemptions."""
    proof = parse_proof(proof_bytes)
    n = air.trace_length
    _require(proof.trace_length == n,
             f"trace length {proof.trace_length}, expected {n}")
    q_count = options.fri_number_of_queries
    _require(len(proof.queries) == q_count and len(proof.openings) == q_count,
             f"{len(proof.queries)} queries and {len(proof.openings)} "
             f"openings, expected {q_count}")
    _require(len(proof.trace_roots) == 2, "expected a main and an auxiliary "
             "trace commitment")
    _require(len(proof.ood_rows) == 2
             and all(len(row) == air.columns for row in proof.ood_rows),
             "out-of-domain frame of the wrong shape")

    log_n = n.bit_length() - 1
    lde_size = n * options.blowup_factor
    log_lde = lde_size.bit_length() - 1
    g = root_of_unity(log_n)
    w = root_of_unity(log_lde)
    h = options.coset_offset % P

    # step 1: replay the transcript
    t = Transcript()
    t.append(proof.trace_roots[0])
    rap = [t.field() for _ in range(air.num_rap_challenges)]
    t.append(proof.trace_roots[1])
    boundary = air.boundary_constraints(rap)
    b_alpha = [t.field() for _ in boundary]
    b_beta = [t.field() for _ in boundary]
    n_tr = len(air.transition_degrees)
    t_alpha = [t.field() for _ in range(n_tr)]
    t_beta = [t.field() for _ in range(n_tr)]
    t.append(proof.comp_root)
    h_inv = inv(h)
    while True:
        z = t.field()
        if (pow(z * h_inv % P, lde_size, P) != 1
                and pow(z, n, P) != 1):
            break
    t.append(felt_bytes(proof.comp_even_ood))
    t.append(felt_bytes(proof.comp_odd_ood))
    for row in proof.ood_rows:
        for v in row:
            t.append(felt_bytes(v))
    gamma_even, gamma_odd = t.field(), t.field()
    trace_coeffs = [[t.field() for _ in range(2)] for _ in range(air.columns)]
    zetas = []
    for root in proof.fri_roots:
        t.append(root)
        zetas.append(t.field())
    t.append(felt_bytes(proof.fri_last))
    zeros = _leading_zeros(t.challenge(), proof.nonce)
    t.append(proof.nonce.to_bytes(8, "big"))
    iotas = [t.usize() % lde_size for _ in range(q_count)]
    _require(zeros >= options.grinding_factor,
             f"grinding nonce has {zeros} zero bits, expected "
             f"{options.grinding_factor}")

    # step 2: the composition polynomial at z against the constraints
    bound = air.composition_degree_bound
    curr, nxt = proof.ood_rows
    dens = batch_inverse([(z - pow(g, c.step, P)) % P for c in boundary])
    zb = pow(z, bound - n, P)
    boundary_sum = 0
    for c, d, a, b in zip(boundary, dens, b_alpha, b_beta):
        boundary_sum += (curr[c.col] - c.value) * d % P * ((a * zb + b) % P)
    transitions = air.transition(curr, nxt, rap)
    zerofier_inv = inv((pow(z, n, P) - 1) % P)
    transition_sum = 0
    for ev, deg, ex, a, b in zip(transitions, air.transition_degrees,
                                 air.transition_exemptions, t_alpha, t_beta):
        adj = pow(z, bound - n * (deg - 1), P)
        ex_eval = 1
        for j in range(ex):
            ex_eval = ex_eval * (z - pow(g, n - 1 - j, P)) % P
        transition_sum += (zerofier_inv * ev % P * ((a * adj + b) % P)
                           * ex_eval)
    _require((boundary_sum + transition_sum) % P
             == (proof.comp_even_ood + z * proof.comp_odd_ood) % P,
             "composition polynomial at z disagrees with the constraints")

    # step 3: FRI, every layer's openings and the folding
    lde_points = [h * pow(w, i, P) % P for i in iotas]
    n_layers = len(proof.fri_roots)
    _require(n_layers >= 1, "no FRI layer")
    for q in proof.queries:
        _require(len(q.evals) == n_layers == len(q.evals_sym)
                 == len(q.paths) == len(q.paths_sym),
                 "FRI decommitment of the wrong length")
    for k, root in enumerate(proof.fri_roots):
        size = lde_size >> k
        leaves, paths, idx = [], [], []
        for iota, q in zip(iotas, proof.queries):
            leaves += [felt_bytes(q.evals[k]), felt_bytes(q.evals_sym[k])]
            paths += [q.paths[k], q.paths_sym[k]]
            idx += [iota % size, (iota + size // 2) % size]
        roots = merkle_roots(keccak256_batch(leaves), paths, idx)
        _require(all(r == root for r in roots),
                 f"FRI layer {k}: an opening does not lead to its root")
    two_inv = inv(2)
    for q, x in zip(proof.queries, batch_inverse(lde_points)):
        v = q.evals[0]
        for k in range(n_layers):
            sym = q.evals_sym[k]
            v = ((v + sym) * two_inv
                 + zetas[k] * ((v - sym) % P) % P * two_inv % P * x) % P
            want = q.evals[k + 1] if k < n_layers - 1 else proof.fri_last
            _require(v == want, f"FRI fold {k} disagrees with the next layer")
            x = x * x % P

    # step 4: the openings of the trace and the composition, and DEEP
    comp_leaves = keccak256_batch(
        [felt_bytes(o.comp_even) + felt_bytes(o.comp_odd)
         for o in proof.openings])
    _require(all(r == proof.comp_root for r in merkle_roots(
        comp_leaves, [o.comp_path for o in proof.openings], iotas)),
        "a composition opening does not lead to its root")
    splits = [(0, air.main_columns), (air.main_columns, air.columns)]
    for t_idx, (root, (lo, hi)) in enumerate(zip(proof.trace_roots, splits)):
        _require(all(len(o.trace_paths) == 2
                     and len(o.trace_evals) == air.columns
                     for o in proof.openings), "trace opening of wrong shape")
        leaves = keccak256_batch(
            [b"".join(felt_bytes(v) for v in o.trace_evals[lo:hi])
             for o in proof.openings])
        roots = merkle_roots(leaves, [o.trace_paths[t_idx]
                                      for o in proof.openings], iotas)
        _require(all(r == root for r in roots),
                 f"a trace opening does not lead to commitment {t_idx}")
    z2 = z * z % P
    zg = [z, z * g % P]
    divs = batch_inverse([(x - p) % P for x in lde_points for p in zg])
    comp_divs = batch_inverse([(x - z2) % P for x in lde_points])
    for i, (o, q) in enumerate(zip(proof.openings, proof.queries)):
        acc = 0
        for col in range(air.columns):
            for row in range(2):
                acc += ((o.trace_evals[col] - proof.ood_rows[row][col])
                        * divs[2 * i + row] % P * trace_coeffs[col][row])
        acc += ((o.comp_even - proof.comp_even_ood) * comp_divs[i] % P
                * gamma_even)
        acc += ((o.comp_odd - proof.comp_odd_ood) * comp_divs[i] % P
                * gamma_odd)
        _require(acc % P == q.evals[0],
                 f"DEEP composition at query {i} disagrees with FRI layer 0")
