"""The reference on its own (Keccak vectors, the statement of a run) and
against the prover's proofs at a tiny size: a proof verifies, and a proof
altered in any one layer (a commitment, an opening, a FRI layer, the nonce)
or checked against another statement does not."""

import copy
import random

import pytest

import reference
from reference import keccak
from reference.stark import Options

TINY = Options(blowup_factor=4, fri_number_of_queries=3, coset_offset=3,
               grinding_factor=1)


def test_keccak_vectors():
    empty = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    abc = "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert keccak.keccak256(b"").hex() == empty
    assert keccak.keccak256(b"abc").hex() == abc
    assert [d.hex() for d in keccak.keccak256_batch([b"abc"] * 3)] == [abc] * 3


@pytest.mark.parametrize("length", [1, 64, 135, 136, 137, 1088, 1700])
def test_keccak_batch_matches_single(length):
    rng = random.Random(length)
    msgs = [bytes(rng.randrange(256) for _ in range(length)) for _ in range(4)]
    assert keccak.keccak256_batch(msgs) == [keccak.keccak256(m) for m in msgs]


@pytest.mark.parametrize("n", [1, 5, 77, 43689])
def test_fibonacci_statement(n):
    st = reference.statement("fibonacci", n)
    assert st.num_steps == 6 * n + 8
    assert (st.pc_init, st.ap_init, st.pc_final) == (1, 23, 9)
    assert st.ap_final == 5 * n + 29
    assert (st.rc_min, st.rc_max) == ((1 << 15) - 5, (1 << 15) + 1)
    assert [a for a, _ in st.public_memory] == list(range(1, 21))


@pytest.mark.parametrize("n", [1, 5, 77])
def test_statement_matches_the_provers_runner(n):
    from lambdaworks_cairo_prover_tpu_torch.cairo.programs import (
        fibonacci_program)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)

    assert reference.bytecode("fibonacci", n) == fibonacci_program(n).data
    _, pub = generate_prover_args(fibonacci_program(n), device="cpu")
    st = reference.statement("fibonacci", n)
    assert (pub.pc_init, pub.ap_init, pub.pc_final, pub.ap_final,
            pub.num_steps, pub.range_check_min, pub.range_check_max,
            tuple(pub.public_memory.items())) == (
        st.pc_init, st.ap_init, st.pc_final, st.ap_final, st.num_steps,
        st.rc_min, st.rc_max, st.public_memory)


@pytest.mark.parametrize("n", [4, 8])
def test_row_range_ends(n):
    """The tiny cell's range [4, 8] pads to 64 rows in the prover, as the
    configurations' ranges pad to theirs, both ends included."""
    from lambdaworks_cairo_prover_tpu_torch.cairo.programs import (
        fibonacci_program)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)

    trace, _ = generate_prover_args(fibonacci_program(n), device="cpu")
    assert trace.n_rows == 64
    outside, _ = generate_prover_args(fibonacci_program(n + 1 if n == 8
                                                         else n - 1),
                                      device="cpu")
    assert outside.n_rows != 64


@pytest.fixture(scope="module")
def tiny_proof():
    """The prover's proof of fib(8) (a trace with no padding rows) at test
    options, on the CPU, as a proof object and its bytes."""
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.cairo.programs import (
        fibonacci_program)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove

    trace, pub = generate_prover_args(fibonacci_program(8), device="cpu")
    proof = prove(trace, pub, ProofOptions(**TINY.__dict__), CairoAIR,
                  device="cpu")
    return proof, serialize_proof(proof)


def _check(data, n=8):
    return reference.check(data, reference.statement("fibonacci", n), 64,
                           TINY)


def test_the_provers_proof_verifies(tiny_proof):
    assert _check(tiny_proof[1]) is None


def test_another_statement_rejects(tiny_proof):
    assert "composition" in _check(tiny_proof[1], n=7)


def _flip(value):
    if isinstance(value, bytes):
        return bytes([value[0] ^ 1]) + value[1:]
    return value ^ 1


ALTERATIONS = {
    "main trace root": lambda p: p.lde_trace_merkle_roots.__setitem__(
        0, _flip(p.lde_trace_merkle_roots[0])),
    "aux trace root": lambda p: p.lde_trace_merkle_roots.__setitem__(
        1, _flip(p.lde_trace_merkle_roots[1])),
    "out-of-domain frame": lambda p: p.trace_ood_frame_evaluations[1]
    .__setitem__(40, _flip(p.trace_ood_frame_evaluations[1][40])),
    "composition root": lambda p: setattr(
        p, "composition_poly_root", _flip(p.composition_poly_root)),
    "composition at z": lambda p: setattr(
        p, "composition_poly_odd_ood_evaluation",
        _flip(p.composition_poly_odd_ood_evaluation)),
    "FRI layer root": lambda p: p.fri_layers_merkle_roots.__setitem__(
        1, _flip(p.fri_layers_merkle_roots[1])),
    "FRI last value": lambda p: setattr(p, "fri_last_value",
                                        _flip(p.fri_last_value)),
    "FRI layer value": lambda p: p.query_list[2].layers_evaluations
    .__setitem__(1, _flip(p.query_list[2].layers_evaluations[1])),
    "FRI path node": lambda p: p.query_list[0].layers_auth_paths_sym[0]
    .__setitem__(0, _flip(p.query_list[0].layers_auth_paths_sym[0][0])),
    "trace opening": lambda p: p.deep_poly_openings[1].lde_trace_evaluations
    .__setitem__(3, _flip(p.deep_poly_openings[1].lde_trace_evaluations[3])),
    "aux opening": lambda p: p.deep_poly_openings[0].lde_trace_evaluations
    .__setitem__(50, _flip(p.deep_poly_openings[0].lde_trace_evaluations[50])),
    "composition opening": lambda p: setattr(
        p.deep_poly_openings[2], "lde_composition_poly_even_evaluation",
        _flip(p.deep_poly_openings[2].lde_composition_poly_even_evaluation)),
    "trace path node": lambda p: p.deep_poly_openings[0]
    .lde_trace_merkle_proofs[1].__setitem__(
        2, _flip(p.deep_poly_openings[0].lde_trace_merkle_proofs[1][2])),
    "nonce": lambda p: setattr(p, "nonce", p.nonce + 1),
    "a query less": lambda p: (p.query_list.pop(), p.deep_poly_openings.pop()),
}


@pytest.mark.parametrize("what", list(ALTERATIONS))
def test_an_altered_layer_rejects(tiny_proof, what):
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof

    proof = copy.deepcopy(tiny_proof[0])
    ALTERATIONS[what](proof)
    data = serialize_proof(proof)
    assert data != tiny_proof[1]
    assert _check(data) is not None


@pytest.mark.parametrize("pos", [0, 9, 100, 2000, -9, -1])
def test_a_flipped_byte_rejects(tiny_proof, pos):
    data = bytearray(tiny_proof[1])
    data[pos] ^= 0x04
    assert _check(bytes(data)) is not None
