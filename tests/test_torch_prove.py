"""The PyTorch port's STARK engine as a whole against the JAX package:
``simple_fibonacci`` prove -> serialize -> verify on the CPU.

The Fiat-Shamir transcript is deterministic, so the port's proof must equal
the JAX package's byte for byte, and each package's verifier must accept the
other's proof."""

import os

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu.air.examples import simple_fibonacci as jfib
from lambdaworks_cairo_prover_tpu.proof import serde as jserde
from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions as JOptions
from lambdaworks_cairo_prover_tpu.prover.prove import prove as jprove
from lambdaworks_cairo_prover_tpu.verifier.verify import verify as jverify
from lambdaworks_cairo_prover_tpu_torch.air.examples import simple_fibonacci as tfib
from lambdaworks_cairo_prover_tpu_torch.interop import trace_from_numpy
from lambdaworks_cairo_prover_tpu_torch.proof import serde as tserde
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.prover.prove import ProvingError, prove
from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
ROWS = 8
PUB = tfib.FibonacciPublicInputs(a0=1, a1=1)
OPTIONS = ProofOptions.default_test_options()


@pytest.fixture(scope="module")
def jax_proof_bytes() -> bytes:
    """The JAX package's proof of simple_fibonacci at 8 rows, test options."""
    proof = jprove(jfib.fibonacci_trace([1, 1], ROWS),
                   jfib.FibonacciPublicInputs(a0=1, a1=1),
                   JOptions.default_test_options(), jfib.FibonacciAIR)
    return jserde.serialize_proof(proof)


@pytest.fixture(scope="module")
def port_proof():
    return prove(tfib.fibonacci_trace([1, 1], ROWS, device="cpu"), PUB, OPTIONS,
                 tfib.FibonacciAIR, device="cpu")


def test_proof_bytes_equal_jax(port_proof, jax_proof_bytes):
    assert tserde.serialize_proof(port_proof) == jax_proof_bytes


def test_port_verifier_accepts_jax_proof(jax_proof_bytes):
    proof = tserde.deserialize_proof(jax_proof_bytes)
    assert verify(proof, PUB, OPTIONS, tfib.FibonacciAIR)


def test_jax_verifier_accepts_port_proof(port_proof):
    proof = jserde.deserialize_proof(tserde.serialize_proof(port_proof))
    assert jverify(proof, jfib.FibonacciPublicInputs(a0=1, a1=1),
                   JOptions.default_test_options(), jfib.FibonacciAIR)


def test_wrong_public_inputs_rejected(port_proof):
    assert verify(port_proof, PUB, OPTIONS, tfib.FibonacciAIR)
    assert not verify(port_proof, tfib.FibonacciPublicInputs(a0=2, a1=1),
                      OPTIONS, tfib.FibonacciAIR)


def test_trace_carried_from_jax():
    """A JAX TraceTable's limbs become the port's trace unchanged."""
    j_data = np.asarray(jfib.fibonacci_trace([1, 1], 64).data)
    carried = trace_from_numpy(j_data, "cpu")
    port = tfib.fibonacci_trace([1, 1], 64, device="cpu")
    assert torch.equal(carried.data, port.data)


def test_1024_rows_equal_jax_fixture():
    """2^10 rows against the committed JAX proof (tools/make_torch_fixtures.py)."""
    with open(os.path.join(FIXTURES,
                           "simple_fibonacci_1024_test_options.proof"), "rb") as f:
        want = f.read()
    proof = prove(tfib.fibonacci_trace([1, 1], 1 << 10, device="cpu"), PUB, OPTIONS,
                  tfib.FibonacciAIR, device="cpu")
    assert tserde.serialize_proof(proof) == want


def test_cuda_prove_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where CUDA is absent")
    with pytest.raises(ProvingError, match="CUDA"):
        prove(tfib.fibonacci_trace([1, 1], ROWS, device="cpu"), PUB, OPTIONS,
              tfib.FibonacciAIR, device="cuda")
