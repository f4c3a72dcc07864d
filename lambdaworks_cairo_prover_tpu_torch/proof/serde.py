"""Bit-exact wire format for proofs (reference src/starks/proof/stark.rs:53-773,
src/starks/utils.rs:6-38, src/starks/frame.rs:86-157, src/main.rs:98-102).

All lengths are 8-byte big-endian usize; field elements are 32-byte BE."""

from __future__ import annotations

import struct

from ..field import host as fh
from .stark import DeepPolynomialOpenings, FriDecommitment, StarkProof

FELT_LEN = 32


class DeserializeError(Exception):
    pass


def _u64(x: int) -> bytes:
    return x.to_bytes(8, "big")


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise DeserializeError("not enough bytes")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "big")

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return int.from_bytes(self.take(2), "big")

    def felt(self, felt_len: int = FELT_LEN) -> int:
        return fh.from_bytes_be(self.take(felt_len))

    def remaining(self) -> bytes:
        return self.data[self.pos :]


# -- merkle path (utils.rs:6-38) -------------------------------------------


def serialize_merkle_proof(path: list[bytes]) -> bytes:
    out = bytearray(_u64(len(path)))
    for node in path:
        assert len(node) == 32
        out.extend(node)
    return bytes(out)


def deserialize_merkle_proof(r: _Reader) -> list[bytes]:
    n = r.u64()
    return [r.take(32) for _ in range(n)]


# -- frame (frame.rs:86-157) -----------------------------------------------


def serialize_frame(rows: list[list[int]]) -> bytes:
    data = [el for row in rows for el in row]
    row_width = len(rows[0]) if rows else 0
    out = bytearray(_u64(len(data)))
    out.extend(_u64(FELT_LEN if data else 0))
    for el in data:
        out.extend(fh.to_bytes_be(el))
    out.extend(_u64(row_width))
    return bytes(out)


def deserialize_frame(r: _Reader) -> list[list[int]]:
    data_len = r.u64()
    felt_len = r.u64()
    data = [r.felt(felt_len) for _ in range(data_len)]
    row_width = r.u64()
    if row_width == 0:
        return []
    return [data[i : i + row_width] for i in range(0, len(data), row_width)]


# -- FriDecommitment (fri_decommit.rs:19-146) ------------------------------


def serialize_fri_decommitment(d: FriDecommitment) -> bytes:
    out = bytearray(_u64(len(d.layers_auth_paths_sym)))
    for path in d.layers_auth_paths_sym:
        out.extend(serialize_merkle_proof(path))
    out.extend(_u64(FELT_LEN))
    out.extend(_u64(len(d.layers_evaluations_sym)))
    for ev in d.layers_evaluations_sym:
        out.extend(fh.to_bytes_be(ev))
    out.extend(_u64(len(d.layers_evaluations)))
    for ev in d.layers_evaluations:
        out.extend(fh.to_bytes_be(ev))
    out.extend(_u64(len(d.layers_auth_paths)))
    for path in d.layers_auth_paths:
        out.extend(serialize_merkle_proof(path))
    return bytes(out)


def deserialize_fri_decommitment(r: _Reader) -> FriDecommitment:
    n_sym = r.u64()
    paths_sym = [deserialize_merkle_proof(r) for _ in range(n_sym)]
    felt_len = r.u64()
    n_ev_sym = r.u64()
    evs_sym = [r.felt(felt_len) for _ in range(n_ev_sym)]
    n_ev = r.u64()
    evs = [r.felt(felt_len) for _ in range(n_ev)]
    n_paths = r.u64()
    paths = [deserialize_merkle_proof(r) for _ in range(n_paths)]
    return FriDecommitment(paths_sym, evs_sym, evs, paths)


# -- DeepPolynomialOpenings (stark.rs:53-160) ------------------------------


def serialize_deep_openings(o: DeepPolynomialOpenings) -> bytes:
    out = bytearray(serialize_merkle_proof(o.lde_composition_poly_proof))
    out.extend(_u64(FELT_LEN))
    out.extend(fh.to_bytes_be(o.lde_composition_poly_even_evaluation))
    out.extend(fh.to_bytes_be(o.lde_composition_poly_odd_evaluation))
    out.extend(_u64(len(o.lde_trace_merkle_proofs)))
    for path in o.lde_trace_merkle_proofs:
        out.extend(serialize_merkle_proof(path))
    out.extend(_u64(len(o.lde_trace_evaluations)))
    for ev in o.lde_trace_evaluations:
        out.extend(fh.to_bytes_be(ev))
    return bytes(out)


def deserialize_deep_openings(r: _Reader) -> DeepPolynomialOpenings:
    comp_proof = deserialize_merkle_proof(r)
    felt_len = r.u64()
    even = r.felt(felt_len)
    odd = r.felt(felt_len)
    n_proofs = r.u64()
    trace_proofs = [deserialize_merkle_proof(r) for _ in range(n_proofs)]
    n_evs = r.u64()
    evs = [r.felt(felt_len) for _ in range(n_evs)]
    return DeepPolynomialOpenings(comp_proof, even, odd, trace_proofs, evs)


# -- StarkProof (stark.rs:162-460) -----------------------------------------


def serialize_proof(p: StarkProof) -> bytes:
    out = bytearray()
    out.extend(_u64(p.trace_length))
    out.extend(_u64(len(p.lde_trace_merkle_roots)))
    for root in p.lde_trace_merkle_roots:
        out.extend(root)
    frame_bytes = serialize_frame(p.trace_ood_frame_evaluations)
    out.extend(_u64(len(frame_bytes)))
    out.extend(frame_bytes)
    out.extend(p.composition_poly_root)
    out.extend(_u64(FELT_LEN))
    out.extend(fh.to_bytes_be(p.composition_poly_even_ood_evaluation))
    out.extend(fh.to_bytes_be(p.composition_poly_odd_ood_evaluation))
    out.extend(_u64(len(p.fri_layers_merkle_roots)))
    for root in p.fri_layers_merkle_roots:
        out.extend(root)
    out.extend(fh.to_bytes_be(p.fri_last_value))
    out.extend(_u64(len(p.query_list)))
    for q in p.query_list:
        qb = serialize_fri_decommitment(q)
        out.extend(_u64(len(qb)))
        out.extend(qb)
    out.extend(_u64(len(p.deep_poly_openings)))
    for o in p.deep_poly_openings:
        ob = serialize_deep_openings(o)
        out.extend(_u64(len(ob)))
        out.extend(ob)
    out.extend(_u64(p.nonce))
    return bytes(out)


def deserialize_proof(data: bytes) -> StarkProof:
    r = _Reader(data)
    trace_length = r.u64()
    n_roots = r.u64()
    roots = [r.take(32) for _ in range(n_roots)]
    frame_len = r.u64()
    frame_reader = _Reader(r.take(frame_len))
    ood_frame = deserialize_frame(frame_reader)
    comp_root = r.take(32)
    felt_len = r.u64()
    even_ood = r.felt(felt_len)
    odd_ood = r.felt(felt_len)
    n_fri_roots = r.u64()
    fri_roots = [r.take(32) for _ in range(n_fri_roots)]
    fri_last = r.felt(felt_len)
    n_queries = r.u64()
    queries = []
    for _ in range(n_queries):
        qlen = r.u64()
        queries.append(deserialize_fri_decommitment(_Reader(r.take(qlen))))
    n_openings = r.u64()
    openings = []
    for _ in range(n_openings):
        olen = r.u64()
        openings.append(deserialize_deep_openings(_Reader(r.take(olen))))
    nonce = r.u64()
    return StarkProof(
        lde_trace_merkle_roots=roots,
        trace_ood_frame_evaluations=ood_frame,
        composition_poly_root=comp_root,
        composition_poly_even_ood_evaluation=even_ood,
        composition_poly_odd_ood_evaluation=odd_ood,
        fri_layers_merkle_roots=fri_roots,
        fri_last_value=fri_last,
        query_list=queries,
        deep_poly_openings=openings,
        nonce=nonce,
        trace_length=trace_length,
    )


# -- proof file framing (main.rs:98-143) -----------------------------------


def write_proof_file(proof: StarkProof, pub_inputs_bytes: bytes) -> bytes:
    pb = serialize_proof(proof)
    return _u64(len(pb)) + pb + pub_inputs_bytes


def read_proof_file(data: bytes) -> tuple[StarkProof, bytes]:
    r = _Reader(data)
    proof_len = r.u64()
    proof = deserialize_proof(r.take(proof_len))
    return proof, r.remaining()
