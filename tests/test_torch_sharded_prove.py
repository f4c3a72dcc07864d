"""``prove(mesh=...)`` of the port on gloo ranks on the CPU against the JAX
package's proof bytes (tests/fixtures/torch_port/, made by
tools/make_torch_fixtures.py).

The ranks are child processes of tests/torch_dist_worker.py.  The JAX
package's own tests (tests/test_domain_sharded.py, test_sharded_prove.py)
assert that its sharded proofs equal its single-device ones, which are the
fixtures, so every rank's proof must equal them byte for byte (tolerance
0) and verify:

* ``shard_axis="domain"``: simple_fibonacci at 1024 rows, test options, on
  2 and 4 ranks; Cairo fib(5) (64 rows x 52 columns, an LDE of 256 points)
  on 4 ranks, whose FRI layers fall below the four-step plan and then
  below D points, where they are replicated;
* ``shard_axis="columns"``: the same Cairo fib(5) and simple_fibonacci on
  4 ranks, and the synthetic Cairo1 contract (synthetic_contract.casm,
  BASELINE config 4's Cairo1 arm) on 2;
* the sharded ``fri_commit_chain`` on 4 ranks against the JAX package's
  chain on the input of fri_chain.json, a partial plan and the full chain;
* an unknown ``shard_axis`` and a CUDA device with a CPU mesh raise
  ``ProvingError``."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu_torch.air.examples import simple_fibonacci as tfib
from lambdaworks_cairo_prover_tpu_torch.field import device as fd
from lambdaworks_cairo_prover_tpu_torch.field.params import N_LIMBS
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.prover.prove import ProvingError, prove
from torch_dist_worker import run_group

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
FIB = {"kind": "prove", "air": "simple_fibonacci", "rows": 1024}
CAIRO = {"kind": "prove", "air": "cairo", "fib": 5}
FIB_FIXTURE = "simple_fibonacci_1024_test_options.proof"
CAIRO_FIXTURE = "cairo_fib5_test_options.proof"
CAIRO1_FIXTURE = "cairo1_synthetic_test_options.proof"
# (world, case, fixture) of every prove
PROVES = {
    "domain-fib-2": (2, dict(FIB, shard_axis="domain"), FIB_FIXTURE),
    "domain-fib-4": (4, dict(FIB, shard_axis="domain"), FIB_FIXTURE),
    "domain-cairo-4": (4, dict(CAIRO, shard_axis="domain"), CAIRO_FIXTURE),
    "columns-cairo-4": (4, dict(CAIRO, shard_axis="columns"), CAIRO_FIXTURE),
    "columns-fib-4": (4, dict(FIB, shard_axis="columns"), FIB_FIXTURE),
    "columns-cairo1-2": (2, {"kind": "prove", "air": "cairo1",
                             "shard_axis": "columns"}, CAIRO1_FIXTURE),
}
EXTRA = {2: [{"kind": "device_mismatch"}],
         4: [{"kind": "fri_chain", "plan": "partial"},
             {"kind": "fri_chain", "plan": "full"}]}


def _cases(world: int) -> list:
    return [case for w, case, _ in PROVES.values() if w == world] + EXTRA[world]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_prove")
    return {w: run_group(w, _cases(w), tmp) for w in (2, 4)}


def _result(groups, world, case):
    """Every rank's result of ``case``."""
    i = _cases(world).index(case)
    return [results[i] for results in groups[world]]


@pytest.mark.parametrize("name", list(PROVES))
def test_sharded_proof_equals_jax_bytes(groups, name):
    world, case, fixture = PROVES[name]
    with open(os.path.join(FIXTURES, fixture), "rb") as f:
        want = hashlib.sha256(f.read()).hexdigest()
    for rank, got in enumerate(_result(groups, world, case)):
        assert got["sha256"] == want, f"rank {rank} of {world}"
        assert got["verified"], f"rank {rank} of {world}"


@pytest.mark.parametrize("plan", ["partial", "full"])
def test_sharded_fri_chain_equals_jax(groups, plan):
    with open(os.path.join(FIXTURES, "fri_chain.json")) as f:
        want = json.load(f)[plan]
    n_roots = len(want["plan"]) + 1
    jax_rows = bytes.fromhex(want["roots_hex"])
    for rank, got in enumerate(_result(groups, 4, {"kind": "fri_chain",
                                                   "plan": plan})):
        rows = bytes.fromhex(got["rows_hex"])
        assert rows[:32 * n_roots] == jax_rows[:32 * n_roots], rank
        if want["final_fold"]:
            # the JAX package appends the constant's 16 raw limbs as words
            limbs = np.frombuffer(jax_rows[32 * n_roots:], dtype="<u4")
            assert int.from_bytes(rows[32 * n_roots:], "little") == fd.to_int(
                limbs.reshape(N_LIMBS, 1), mont=False)
        assert got["evals_sha256"] == want["evals_sha256"], rank
        assert got["last_coeffs_sha256"] == want["last_coeffs_sha256"], rank


def test_cuda_device_with_cpu_mesh_raises(groups):
    for got in _result(groups, 2, {"kind": "device_mismatch"}):
        assert got["raised"] and "mesh" in got["raised"]


def test_unknown_shard_axis_raises():
    with pytest.raises(ProvingError, match="shard_axis"):
        prove(tfib.fibonacci_trace([1, 1], 16, device="cpu"),
              tfib.FibonacciPublicInputs(a0=1, a1=1),
              ProofOptions.default_test_options(), tfib.FibonacciAIR,
              device="cpu", shard_axis="column")
