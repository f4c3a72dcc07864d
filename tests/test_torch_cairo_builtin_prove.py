"""Cairo programs with builtins or hints, proved by the PyTorch port on the
CPU and held against the JAX package's proof files.

``tests/fixtures/torch_port/cairo_programs.json`` (written by
``tools/make_torch_fixtures.py``) names each proof file with its program
(``cairo/programs.py``: output, bitwise, pedersen, ecdsa, keccak, poseidon;
``cairo/stdlib.py``: lt_comparison, signed_div_rem,
compare_lesser_array(10)), its arguments and its layout.  The port's proof
file (proof, then public inputs) must equal the JAX package's byte for
byte, and each package's verifier must accept the other's proof."""

import json
import os

import pytest
import torch

from lambdaworks_cairo_prover_tpu.cairo.air import PublicInputs as JPublicInputs
from lambdaworks_cairo_prover_tpu.cairo.air import (
    verify_cairo_proof as jverify_cairo_proof)
from lambdaworks_cairo_prover_tpu.proof import serde as jserde
from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions as JOptions
from lambdaworks_cairo_prover_tpu_torch.cairo import programs, stdlib
from lambdaworks_cairo_prover_tpu_torch.cairo.air import (
    PublicInputs, generate_cairo_proof, verify_cairo_proof)
from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
    CairoLayout, generate_prover_args)
from lambdaworks_cairo_prover_tpu_torch.interop import public_inputs_from_jax
from lambdaworks_cairo_prover_tpu_torch.proof import serde
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
OPTIONS = ProofOptions.default_test_options()
with open(os.path.join(FIXTURES, "cairo_programs.json")) as _f:
    MANIFEST = json.load(_f)["proof_files"]


def make_program(entry):
    """The port's program of a manifest entry ("cairo/<module>.py:<gen>")."""
    module, gen = entry["program"].split(":")
    mod = {"cairo/programs.py": programs, "cairo/stdlib.py": stdlib}[module]
    return getattr(mod, gen)(*entry["args"])


@pytest.fixture(scope="module", params=sorted(MANIFEST))
def case(request):
    """(the JAX package's proof file, the port's proof, its public inputs,
    the manifest entry)."""
    entry = MANIFEST[request.param]
    with open(os.path.join(FIXTURES, request.param), "rb") as f:
        jax_file = f.read()
    trace, pub = generate_prover_args(make_program(entry), device="cpu",
                                      layout=CairoLayout[entry["layout"]])
    proof = generate_cairo_proof(trace, pub, OPTIONS, device="cpu")
    return jax_file, proof, pub, entry


def test_builtin_proof_file_equals_jax(case):
    jax_file, proof, pub, entry = case
    assert pub.num_steps > 0
    assert len(proof.trace_ood_frame_evaluations[0]) == entry["trace_columns"]
    assert serde.write_proof_file(proof, pub.serialize()) == jax_file


def test_builtin_port_verifier_accepts_jax_proof(case):
    jax_file, _, _, _ = case
    proof, rest = serde.read_proof_file(jax_file)
    pub = PublicInputs.deserialize(rest)
    assert verify_cairo_proof(proof, pub, OPTIONS)
    # the JAX package's public inputs, carried field by field
    jpub = JPublicInputs.deserialize(rest)
    assert public_inputs_from_jax(jpub).serialize() == rest
    pub.pc_final += 1
    assert not verify_cairo_proof(proof, pub, OPTIONS)


def test_builtin_jax_verifier_accepts_port_proof(case):
    _, proof, pub, _ = case
    jproof = jserde.deserialize_proof(serde.serialize_proof(proof))
    jpub = JPublicInputs.deserialize(pub.serialize())
    assert jverify_cairo_proof(jproof, jpub, JOptions.default_test_options())
    jpub.ap_final += 1
    assert not jverify_cairo_proof(jproof, jpub,
                                   JOptions.default_test_options())


def test_output_segment_is_public():
    """An output program's public memory carries its output cells, and a
    changed output makes the proof fail."""
    entry = MANIFEST["cairo_output_test_options.proof"]
    trace, pub = generate_prover_args(make_program(entry), device="cpu")
    out = list(pub.memory_segments["output"])
    assert [pub.public_memory[a] for a in out] == [42, 123]
    with open(os.path.join(FIXTURES, "cairo_output_test_options.proof"),
              "rb") as f:
        proof, _ = serde.read_proof_file(f.read())
    pub.public_memory[out[0]] = 999
    assert not verify_cairo_proof(proof, pub, OPTIONS)
