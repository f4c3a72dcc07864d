"""The port over the toy field GF(257) (``LCP_FIELD=f257``) against the JAX
package: the value checks of tests/test_toy_field.py, prove and verify of
``simple_fibonacci``, and proof bytes equal to the JAX package's GF(257)
proof that ``tools/make_torch_fixtures.py`` (``toy``) recorded.

The field is chosen at import, so the port runs in a child process on the
CPU.  The Hopper kernels bake the Stark252 prime: under GF(257) the port
takes the plain field ops and the plain NTT by a check made at import, and
the FRI commit keeps the per-layer route (the chain's draw masks to 251
bits), as the JAX package does.  Values and bytes must be equal (tolerance
0)."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "torch_port",
                       "simple_fibonacci_8_f257_test_options.proof")

_SCRIPT = r"""
import json, os, sys
os.environ["LCP_FIELD"] = "f257"
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)

from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
from lambdaworks_cairo_prover_tpu_torch.field import device as fd
from lambdaworks_cairo_prover_tpu_torch.field.params import (
    P, SPARSE_P, TWO_ADICITY)
from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
from lambdaworks_cairo_prover_tpu_torch.prover import kernels as pk
out = {"field": [P, TWO_ADICITY], "sparse_p": SPARSE_P}

a = fd.from_ints([5, 100, 256, 0], device="cpu")
b = fd.from_ints([7, 200, 256, 123], device="cpu")
out["products"] = fd.to_ints(fd.mul(a, b))
out["squares"] = fd.to_ints(fd.square(b))
out["sums"] = fd.to_ints(fd.add(a, b)) + fd.to_ints(fd.sub(a, b))
vals = list(range(1, 17))
x = fd.from_ints(vals, device="cpu")
out["ntt_roundtrip"] = fd.to_ints(nttc.intt(nttc.ntt(x)))
try:
    cf.mont_mul(a, b)
    out["mont_mul_refused"] = ""
except ValueError as exc:
    out["mont_mul_refused"] = str(exc)

chain_calls = []
chain = pk.ProverKernels.fri_commit_chain
pk.ProverKernels.fri_commit_chain = (
    lambda self, *a, **k: chain_calls.append(1) or chain(self, *a, **k))

from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
    FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove
from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

pub = FibonacciPublicInputs(a0=1, a1=1)
options = ProofOptions.default_test_options()  # blowup 4: LDE 32 <= 256
proof = prove(fibonacci_trace([1, 1], 8, device="cpu"), pub, options,
              FibonacciAIR, device="cpu")
out["verified"] = verify(proof, pub, options, FibonacciAIR)
out["wrong_pub_verified"] = verify(
    proof, FibonacciPublicInputs(a0=2, a1=1), options, FibonacciAIR)
out["proof_hex"] = serialize_proof(proof).hex()
out["chain_calls"] = len(chain_calls)
out["launches"] = [cf.mont_mul.launches, cf.add_sub_mod.launches,
                   cn.ntt_dif_stages.launches, cn.ntt_dif_local.launches]
print("TOY=" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def toy() -> dict:
    env = dict(os.environ)
    env.pop("LCP_FIELD", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, ROOT],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TOY=")]
    return json.loads(line[-1][len("TOY="):])


def test_f257_values(toy):
    assert toy["field"] == [257, 8]
    assert toy["products"] == [35, 100 * 200 % 257, 256 * 256 % 257, 0]
    assert toy["squares"] == [49, 200 * 200 % 257, 1, 123 * 123 % 257]
    assert toy["sums"] == [12, 300 % 257, 255, 123, (5 - 7) % 257,
                           (100 - 200) % 257, 0, (0 - 123) % 257]
    assert toy["ntt_roundtrip"] == list(range(1, 17))


def test_f257_takes_no_kernel(toy):
    """The field check at import routes every op to the plain versions;
    a kernel launcher refuses the field outright."""
    assert toy["sparse_p"] is False
    assert "Stark252" in toy["mont_mul_refused"]
    assert toy["launches"] == [0, 0, 0, 0]
    assert toy["chain_calls"] == 0  # the per-layer FRI route


def test_f257_prove_verify(toy):
    assert toy["verified"] is True
    assert toy["wrong_pub_verified"] is False


def test_f257_proof_equals_jax(toy):
    with open(FIXTURE, "rb") as f:
        assert bytes.fromhex(toy["proof_hex"]) == f.read()
