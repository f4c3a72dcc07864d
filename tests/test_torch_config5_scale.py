"""tools/config5_scale_torch.py, the port's BASELINE config 5 tool, on 2
gloo ranks on the CPU at 2^10 rows with the test options.

Its proof must be the JAX package's bytes (simple_fibonacci_1024_test_
options.proof, made by tools/make_torch_fixtures.py; tolerance 0) and its
single-device proof's, and verify; its record must carry the JAX tool's keys
and the port's; and the collective bytes it counts at each call site must
equal closed forms worked out here from ``four_step_plan``, the protocol's
transform sizes and the layouts, not from the counter:

* ``ShardedNTT._a2a``: three all-to-alls of the rank's whole block a
  planned transform (64 B a point: 16 int32 limbs);
* ``reblock``: what each rank sends and receives when a block-sharded
  tensor is zero-padded (LDE, composition halves, FRI layers) or cut (the
  DEEP polynomial);
* ``gather_rows`` by caller: one 32-byte subtree root a sharded Merkle
  tree, the constraint halo, the OOD partial sums, the fold whose block is
  one point; the openings (``_from_owners``, whose sizes follow the drawn
  queries) only as all-gathers: D times the bytes sent come back.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from lambdaworks_cairo_prover_tpu_torch.air.examples import simple_fibonacci as tfib
from lambdaworks_cairo_prover_tpu_torch.parallel.four_step import four_step_plan
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "config5_scale_torch.py")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "simple_fibonacci_1024_test_options.proof")
D = 2
LOG_ROWS = 10
EQ_LOG_ROWS = 8
ELEM = 64  # bytes of a point: 16 int32 limbs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("config5") / "record.json"
    proc = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--ranks", str(D),
         "--log-rows", str(LOG_ROWS), "--equality-log-rows", str(EQ_LOG_ROWS),
         "--out", str(out), "--timeout", "300"],
        cwd=ROOT, capture_output=True, text=True, timeout=360,
        env=dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(out) as f:
        rec = json.load(f)
    assert rec == line
    return rec


def test_proof_equals_jax_fixture(run):
    with open(FIXTURE, "rb") as f:
        want = hashlib.sha256(f.read()).hexdigest()
    assert run["proof_sha256"] == want
    assert run["jax_fixture"] == {"fixture": os.path.basename(FIXTURE),
                                  "equal": True}
    assert run["ranks_equal"] and run["ok"]
    for r in run["ranks"]:
        assert r["proof_sha256"] == {"cold": want, "warm": want}
    assert run["verified"] and run["wrong_public_inputs_rejected"]
    assert run["single_device"]["sha256"] == want
    assert run["single_device"]["equal"]
    eq = run["bytes_equal_single_device"]
    assert eq["log2_rows"] == EQ_LOG_ROWS and eq["equal"]
    assert eq["jax_fixture"] is None  # no JAX proof at 2^8 rows
    assert run["jax_modules_loaded"] == []


def test_record_keys(run):
    assert {"trace_rows_log2", "lde_points", "n_devices", "mesh_backend",
            "trace_gen_s", "prove_wall_s", "verified", "proof_bytes",
            "round_timings_s", "host_peak_rss_bytes",
            "per_device_peak_bytes", "bytes_equal_single_device",
            "collective_bytes_by_site", "proof_sha256", "ranks",
            "collectives_counted", "single_device"} <= set(run)
    assert run["trace_rows_log2"] == LOG_ROWS
    assert run["lde_points"] == 4 << LOG_ROWS
    assert (run["n_devices"], run["mesh_backend"]) == (D, "gloo")
    assert set(run["prove_wall_s"]) == set(run["round_timings_s"]) == {
        "cold", "warm"}
    assert "round4" in run["round_timings_s"]["warm"]
    assert run["proof_bytes"] == os.path.getsize(FIXTURE)
    assert [r["rank"] for r in run["ranks"]] == list(range(D))
    for r in run["ranks"]:
        assert {"phase_memory", "peak_device_bytes", "host_peak_rss_bytes",
                "collectives", "launches", "trace_gen_s"} <= set(r)
        assert r["host_peak_rss_bytes"] > 0
        # prove.py's phases, each "unavailable" on the CPU
        tags = [p["phase"] for p in r["phase_memory"]]
        assert tags[0].startswith("round0") and tags[-1].startswith("round4")
        assert all(p["bytes"].startswith("unavailable")
                   for p in r["phase_memory"])
        assert r["peak_device_bytes"] == {"cold": "unavailable",
                                          "warm": "unavailable"}
        # no kernel launches on the CPU: the plain versions ran
        assert not any(r["launches"].values())
    assert run["per_device_peak_bytes"] == "unavailable"


def _overlap(lo0, hi0, lo1, hi1):
    return max(0, min(hi0, hi1) - max(lo0, lo1))


def _closed_forms(rank: int) -> dict:
    """Calls and bytes (sent, received) of rank ``rank`` at each site in one
    prove of simple_fibonacci at 2^LOG_ROWS rows, test options, D ranks."""
    options = ProofOptions.default_test_options()
    n = 1 << LOG_ROWS
    N = n * options.blowup_factor
    log_n = LOG_ROWS
    # the transforms of the protocol: the trace's iNTT and LDE; the
    # composition's iNTT and its two halves' LDE; the DEEP polynomial's
    # iNTT; the FRI layers' evaluations (the first at N points, then one a
    # fold down to 2 coefficients: N/2 .. 8 points)
    transforms = [n, N, N, N, N, N, N] + [N >> k for k in range(1, log_n)]
    a2a = [3 * ELEM * t // D for t in transforms if four_step_plan(t, D)]
    # reblock: zero-pads (coefficients -> points) and the DEEP cut
    pads = [(n, N), (N // 2, N), (N // 2, N), (n, N)] + [
        (n >> k, N >> k) for k in range(1, log_n)]
    sent = recv = 0
    for old, new in pads + [(N, n)]:
        m, a, b = min(old, new), old // D, new // D
        sent += ELEM * _overlap(rank * a, min((rank + 1) * a, m), 0, m)
        recv += ELEM * _overlap(rank * b, min((rank + 1) * b, m), 0, m)
    # gather_rows: a root a sharded tree (the trace, the composition, the
    # first FRI layer and one a fold); the halo of the frame's row shifts
    # (offsets up to 2, times the blowup; packed 8 words, 1 column); one
    # partial OOD sum a trace offset (in the packed polynomials' layout, 8
    # words) and a composition half (16 limbs); the fold whose block is one
    # point (the chain's last: 2 coefficients)
    air = tfib.FibonacciAIR(n, tfib.FibonacciPublicInputs(1, 1), options)
    offsets = air.context.transition_offsets
    trees = 3 + (log_n - 1)
    halo = 4 * 8 * 1 * max(offsets) * options.blowup_factor
    folds = [N] + [n >> k for k in range(log_n)]
    ood = ELEM // 2 * len(offsets) + ELEM * 2
    odd = [ELEM * L // D for L in folds if L % D == 0 and (L // D) % 2]
    return {
        "four_step.ShardedNTT._a2a": (len(a2a) * 3, sum(a2a), sum(a2a)),
        "sharding.reblock": (len(pads) + 1, sent, recv),
        "_commit": (trees, 32 * trees, 32 * D * trees),
        "_halo": (1, halo, D * halo),
        "eval_at_powers": (len(offsets) + 2, ood, D * ood),
        "_halves": (len(odd), sum(odd), D * sum(odd)),
    }


@pytest.mark.parametrize("rank", range(D))
@pytest.mark.parametrize("site", ["four_step.ShardedNTT._a2a",
                                  "sharding.reblock", "_commit", "_halo",
                                  "eval_at_powers", "_halves"])
def test_collective_bytes_closed_form(run, rank, site):
    for tag in ("cold", "warm"):
        got = run["ranks"][rank]["collectives"][tag]
        if site.startswith("_") or site == "eval_at_powers":
            got = got["sharding.gather_rows"]["by_caller"]
        want = dict(zip(("calls", "bytes_sent", "bytes_received"),
                        _closed_forms(rank)[site]))
        assert {k: got[site][k] for k in want} == want, tag


def test_collective_sites_add_up(run):
    """gather_rows is its callers; the openings are all-gathers; no
    collective came from elsewhere; the summary sums the ranks."""
    total = {}
    for r in run["ranks"]:
        cold = r["collectives"]["cold"]
        assert set(cold) == {"four_step.ShardedNTT._a2a", "sharding.reblock",
                             "sharding.gather_rows"}
        g = cold["sharding.gather_rows"]
        callers = g["by_caller"]
        assert set(callers) == {"_commit", "_halo", "eval_at_powers",
                                "_halves", "_from_owners"}
        for k in ("calls", "bytes_sent", "bytes_received"):
            assert g[k] == sum(c[k] for c in callers.values())
        opening = callers["_from_owners"]
        assert opening["calls"] > 0
        assert opening["bytes_received"] == D * opening["bytes_sent"]
        for site, c in cold.items():
            acc = total.setdefault(site, [0, 0, 0])
            for i, k in enumerate(("calls", "bytes_sent", "bytes_received")):
                acc[i] += c[k]
    assert {s: [c["calls"], c["bytes_sent"], c["bytes_received"]]
            for s, c in run["collective_bytes_by_site"].items()} == total
