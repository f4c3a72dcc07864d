"""The port's four-step NTT (parallel/four_step.py) on gloo ranks on the CPU
against the single-device transform and the JAX package's ShardedNTT.

* ``four_step_plan(n, d)`` equals JAX ``ShardedNTT(make_mesh(d)).plan(n)``
  for d in 1, 2, 4, 8 and n = 2^0 .. 2^14 (the 8-device CPU mesh of
  tests/conftest.py).
* ``ShardedNTT.transform`` on 2 and 4 ranks (child processes of
  tests/torch_dist_worker.py), forward and inverse at 2^10 and 2^12 points
  on seeded input, gathered whole, equals the port's single-device
  transform and the JAX package's ShardedNTT on its 8-device mesh.  That
  JAX run compiles for about 20 s on this CPU, so
  tools/make_torch_fixtures.py (``four_step``) recorded its outputs' sha256.
* ``sharding.reblock`` (a cut or a zero-pad along the domain axis, between
  any two layouts) equals the block of the whole tensor cut or padded.

Limbs must be equal (tolerance 0)."""

import json
import os

import jax
import pytest
import torch

from lambdaworks_cairo_prover_tpu.parallel.four_step import ShardedNTT as JShardedNTT
from lambdaworks_cairo_prover_tpu.parallel.sharding import make_mesh as jmake_mesh
from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                        limbs_to_numpy)
from lambdaworks_cairo_prover_tpu_torch.ntt import core as tnttc
from lambdaworks_cairo_prover_tpu_torch.parallel.four_step import four_step_plan
from torch_dist_worker import run_group, seeded_limbs, sha256_limbs

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
WORLDS = (2, 4)
# (n_old, n_new): zero-pads by an LDE blowup and cuts back, both block-
# sharded at 2 and 4 ranks; to and from lengths that 4 ranks replicate
REBLOCKS = [(64, 256), (256, 64), (1024, 4096), (4096, 1024), (64, 64),
            (2, 8), (8, 2), (2, 1)]


def _recorded() -> list:
    with open(os.path.join(FIXTURES, "four_step_ntt.json")) as f:
        return json.load(f)["cases"]


CASES = [(c["log_n"], c["direction"]) for c in _recorded()]


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_four_step_plan_matches_jax(d):
    jax_ntt = JShardedNTT(jmake_mesh(d, devices=jax.devices("cpu")))
    for log_n in range(15):
        assert four_step_plan(1 << log_n, d) == jax_ntt.plan(1 << log_n), log_n


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    cases = [{"kind": "ntt", "log_n": c["log_n"], "direction": c["direction"],
              "seed": c["seed"]} for c in _recorded()]
    cases += [{"kind": "reblock", "n_old": a, "n_new": b} for a, b in REBLOCKS]
    tmp = tmp_path_factory.mktemp("four_step")
    return {w: run_group(w, cases, tmp) for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("log_n, direction", CASES)
def test_sharded_ntt_matches_single_device_and_jax(groups, world, log_n,
                                                   direction):
    case = next(c for c in _recorded()
                if (c["log_n"], c["direction"]) == (log_n, direction))
    n = 1 << log_n
    x = seeded_limbs(case["seed"], (n,))
    assert sha256_limbs(x) == case["input_sha256"]
    single = tnttc.transform(limbs_from_numpy(x, "cpu"),
                             inverse=direction == "inverse")
    want = sha256_limbs(limbs_to_numpy(single))
    assert want == case["output_sha256"]  # the JAX package's ShardedNTT
    for rank, results in enumerate(groups[world]):
        got = results[CASES.index((log_n, direction))]
        assert got["plan"] == list(four_step_plan(n, world)), rank
        assert got["in_shape"] == got["out_shape"] == [16, 1, n // world]
        assert got["sha256"] == want, f"rank {rank} of {world}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n_old, n_new", REBLOCKS)
def test_reblock_equals_slice_of_whole(groups, world, n_old, n_new):
    for rank, results in enumerate(groups[world]):
        got = results[len(CASES) + REBLOCKS.index((n_old, n_new))]
        assert got["equal"], (rank, got)
        local = n_new // world if n_new % world == 0 else n_new
        assert got["shape"] == [16, 3, local]
