"""The Cairo slice of the PyTorch port as a whole, on the CPU:
``generate_prover_args`` -> ``generate_cairo_proof`` -> ``serialize_proof``
-> ``verify_cairo_proof``, and the command line.

The JAX package's proofs come from ``tests/fixtures/torch_port/`` (written
by ``tools/make_torch_fixtures.py``; compiling the JAX prover for a Cairo
trace takes minutes on a CPU).  The Fiat-Shamir transcript is deterministic,
so every comparison is exact: the port's proof file must equal the JAX
package's byte for byte, and each package's verifier must accept the other's
proof."""

import json
import os

import pytest
import torch

from lambdaworks_cairo_prover_tpu.cairo.air import PublicInputs as JPublicInputs
from lambdaworks_cairo_prover_tpu.cairo.air import (
    verify_cairo_proof as jverify_cairo_proof)
from lambdaworks_cairo_prover_tpu.proof import serde as jserde
from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions as JOptions
from lambdaworks_cairo_prover_tpu_torch import cli
from lambdaworks_cairo_prover_tpu_torch.cairo import programs
from lambdaworks_cairo_prover_tpu_torch.cairo.air import (
    PublicInputs, generate_cairo_proof, verify_cairo_proof)
from lambdaworks_cairo_prover_tpu_torch.cairo.runner import generate_prover_args
from lambdaworks_cairo_prover_tpu_torch.proof import serde
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.prover.prove import ProvingError

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
OPTIONS = ProofOptions.default_test_options()
CASES = {
    "fib5": ("cairo_fib5_test_options.proof",
             lambda: programs.fibonacci_program(5), 52),
    "rc": ("cairo_rc_test_options.proof",
           lambda: programs.rc_program((250, 77, 1 << 100)), 61),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(the JAX package's proof file, the port's proof, its public inputs,
    the expected number of trace columns)."""
    name, make, columns = CASES[request.param]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        jax_file = f.read()
    trace, pub = generate_prover_args(make(), device="cpu")
    proof = generate_cairo_proof(trace, pub, OPTIONS, device="cpu")
    return jax_file, proof, pub, columns


def test_proof_file_equals_jax(case):
    jax_file, proof, pub, columns = case
    assert len(proof.trace_ood_frame_evaluations[0]) == columns
    jax_proof, jax_pub = serde.read_proof_file(jax_file)
    assert pub.serialize() == jax_pub
    assert serde.serialize_proof(proof) == serde.serialize_proof(jax_proof)
    assert serde.write_proof_file(proof, pub.serialize()) == jax_file


def test_port_verifier_accepts_jax_proof_and_rejects_wrong_inputs(case):
    jax_file, _, _, _ = case
    proof, rest = serde.read_proof_file(jax_file)
    pub = PublicInputs.deserialize(rest)
    assert verify_cairo_proof(proof, pub, OPTIONS)
    pub.pc_final += 1
    assert not verify_cairo_proof(proof, pub, OPTIONS)


def test_jax_verifier_accepts_port_proof(case):
    _, proof, pub, _ = case
    jproof = jserde.deserialize_proof(serde.serialize_proof(proof))
    jpub = JPublicInputs.deserialize(pub.serialize())
    assert jverify_cairo_proof(jproof, jpub, JOptions.default_test_options())
    jpub.pc_final += 1
    assert not jverify_cairo_proof(jproof, jpub,
                                   JOptions.default_test_options())


def test_port_verifier_accepts_its_own_proof(case):
    _, proof, pub, _ = case
    assert verify_cairo_proof(proof, pub, OPTIONS)


def test_proving_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    trace, pub = generate_prover_args(programs.simple_program(), device="cpu")
    with pytest.raises(ProvingError, match="CUDA"):
        generate_cairo_proof(trace, pub, OPTIONS)  # device defaults to cuda


# -- the command line -------------------------------------------------------


@pytest.fixture(scope="module")
def program_json(tmp_path_factory) -> str:
    prog = programs.fibonacci_program(5)
    path = tmp_path_factory.mktemp("cli") / "fib5.json"
    path.write_text(json.dumps({
        "data": [hex(x) for x in prog.data],
        "identifiers": {"__main__.main": {"pc": prog.main_pc}},
        "builtins": prog.builtins}))
    return str(path)


def test_cli_prove_then_verify(program_json, tmp_path, capsys):
    out = str(tmp_path / "fib5.proof")
    assert cli.main(["prove", program_json, out, "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        data = f.read()
    with open(os.path.join(FIXTURES, CASES["fib5"][0]), "rb") as f:
        assert data == f.read()
    assert cli.main(["verify", out]) == 0
    assert "Verification succeded" in capsys.readouterr().out

    flipped = bytearray(data)
    flipped[200] ^= 1  # inside the proof's first out-of-domain evaluation
    bad = str(tmp_path / "bad.proof")
    with open(bad, "wb") as f:
        f.write(bytes(flipped))
    assert cli.main(["verify", bad]) == 1
    assert "Verification failed" in capsys.readouterr().out


def test_cli_prove_and_verify_on_cpu(program_json):
    assert cli.main(["--device", "cpu", "prove_and_verify", program_json]) == 0


def test_cli_asks_for_cuda_by_default(program_json, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = str(tmp_path / "never.proof")
    assert cli.main(["prove", program_json, out]) != 0
    assert cli.main(["prove", program_json, out, "--device", "cuda"]) != 0
    err = capsys.readouterr().err
    assert "ProvingError" in err and "torch.cuda.is_available() is false" in err
    assert not os.path.exists(out)


def test_cli_usage_errors():
    assert cli.main([]) == 1
    assert cli.main(["prove"]) == 1
    assert cli.main(["nonsense"]) == 1
