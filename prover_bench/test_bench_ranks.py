"""A cell on D > 1 cards, rehearsed on the CPU: the tiny configuration's
cells `tiny_domain.serial2` and `tiny_domain.serial4` run as 2 and 4 gloo
ranks of run.py, domain-sharded.  Correct as they stand, with every rank's
job count and proof bytes equal, and the bytes equal to one card's;
not correct with each planted fault under rank 0's or rank 1's timed path,
and with the control under every rank's; a rank that raises, or hangs, ends the run with no result and that rank
named; the traced run reaches every layer entry on rank 0; a one-card cell
starts no rank and makes no process group."""

import hashlib
import subprocess
import sys
import time

import pytest

import controls
import harness
import ranks

SEED = 3


def _run(checkout, cell, trace=False, seconds=0.5, rank_command=None):
    return harness.run(cell, SEED, seconds, trace,
                       t_start=time.perf_counter(),
                       manifest_path=checkout / "BENCHMARK.json",
                       device="cpu", bench_dir=checkout / "prover_bench",
                       rank_command=rank_command)


def _digests(lines) -> dict:
    """`proof sha256, n = <n>: <hex> ...` lines of rank 0, by n."""
    out = {}
    for line in lines:
        if line.startswith("proof sha256, n = "):
            n, shas = line[len("proof sha256, n = "):].split(": ")
            out[int(n)] = set(shas.split())
    return out


def _one_card_digests(checkout) -> dict:
    """The sha256 of the proof of each of the cell's traces for SEED, proved
    on one (CPU) device in this process, by n."""
    import json

    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.cairo.vm import Program
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove

    import reference

    manifest = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = harness.resolve(manifest, "tiny_domain.serial4",
                           checkout / "prover_bench")
    cfg, out = cell.config, {}
    for n in harness.pick_sizes(cfg, cell.traffic, SEED):
        trace, pub = generate_prover_args(Program(
            data=reference.bytecode(cfg["program"], n), main_pc=0,
            builtins=[]), device="cpu")
        proof = prove(trace, pub, ProofOptions(**cfg["options"]), CairoAIR,
                      device="cpu")
        out[n] = {hashlib.sha256(serialize_proof(proof)).hexdigest()}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_are_correct(tiny_checkout, world):
    result, lines = _run(tiny_checkout, f"tiny_domain.serial{world}")
    assert result["correct"] and result["failed"] == 0, lines
    assert result["device"]["count"] == world
    jobs = [r["jobs"] for r in result["ranks"]]
    assert len(jobs) == world and set(jobs) == {result["attempted"]}
    assert list(result)[-1] == "checks"
    assert result["checks"] == {
        "rejected_proofs": {"value": 0, "limit": 0},
        "failed_jobs": {"value": 0, "limit": 0},
        "divergent_ranks": {"value": 0, "limit": 0}}
    assert lines[-3:] == ["check rejected_proofs: 0 (limit 0)",
                          "check failed_jobs: 0 (limit 0)",
                          "check divergent_ranks: 0 (limit 0)"]
    assert "kernel build: none (the ranks run on the CPU)" in lines
    if world == 4:  # the proofs of 4 ranks are one card's, byte for byte
        sharded = _digests(lines)
        one_card = _one_card_digests(tiny_checkout)
        assert sharded and all(sharded[n] == one_card[n] for n in sharded)


def _plant_command(checkout, plant, rank):
    return [sys.executable, str(checkout / "prover_bench" / "controls.py"),
            "rank", plant, str(rank)]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("plant", sorted(set(controls.PLANTS) - {"control"}))
def test_a_fault_planted_on_one_rank_is_not_correct(tiny_checkout, plant,
                                                    rank):
    assert controls.placements(plant, 2) == [0, 1]
    result, lines = _run(tiny_checkout, "tiny_domain.serial2",
                         rank_command=_plant_command(tiny_checkout, plant,
                                                     rank))
    assert not result["correct"], lines
    checks = result["checks"]
    assert checks["rejected_proofs"]["value"] + checks["divergent_ranks"][
        "value"] >= 1


def test_the_control_on_every_rank_is_rejected(tiny_checkout):
    assert controls.placements("control", 2) == [-1]
    result, lines = _run(tiny_checkout, "tiny_domain.serial2",
                         rank_command=_plant_command(tiny_checkout, "control",
                                                     -1))
    assert not result["correct"], lines
    checks = result["checks"]
    assert checks["rejected_proofs"]["value"] == result["attempted"] >= 1
    assert checks["divergent_ranks"]["value"] == 0


def test_controls_report_a_run_with_no_result_apart(tiny_checkout,
                                                    monkeypatch, capsys):
    """`controls.py` on a cell of 2 ranks: the control once under every
    rank, each fault under rank 0 and under rank 1; a run that ends with
    no result is reported as such, with no `correct`."""
    import json

    calls, resolve = [], harness.resolve

    def run(workload, seed, seconds, trace, *, rank_command, **kwargs):
        plant, at = rank_command[-2:]
        calls.append((plant, int(at)))
        if plant == "control":
            raise ranks.RankFailure("rank 1: RuntimeError: planted")
        return {"correct": False, "attempted": 2, "checks": {}}, ["a", "b"]

    monkeypatch.setattr(controls, "ROOT", tiny_checkout)
    monkeypatch.setattr(harness, "resolve", lambda manifest, cell: resolve(
        manifest, cell, tiny_checkout / "prover_bench"))
    monkeypatch.setattr(harness, "run", run)
    controls.main(["--workload", "tiny_domain.serial2", "--seeds", "3",
                   "--plants", "control", "stale"])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert calls == [("control", -1), ("stale", 0), ("stale", 1)]
    assert out[0] == {"plant": "control", "seed": 3, "rank": -1,
                      "no_result": "rank 1: RuntimeError: planted"}
    assert [o["correct"] for o in out[1:]] == [False, False]


def test_an_unplanted_rank_command_is_correct(tiny_checkout):
    result, lines = _run(tiny_checkout, "tiny_domain.serial2",
                         rank_command=_plant_command(tiny_checkout, "none", 0))
    assert result["correct"], lines


FAILING_RANK = """
import sys
sys.path.insert(0, {bench!r})
if sys.argv[sys.argv.index("--rank") + 1] == "1":
    from lambdaworks_cairo_prover_tpu_torch.prover import prove as pm
    proved, original = [], pm.prove

    def failing(*a, **k):
        proved.append(1)
        if len(proved) == {nth}:
            {fault}
        return original(*a, **k)
    pm.prove = failing
import run
sys.exit(run.main(sys.argv[1:]))
"""


def _failing_command(checkout, tmp_path, fault, nth):
    # the tiny mix warms up on one round of its two traces
    path = tmp_path / "failing_rank.py"
    path.write_text(FAILING_RANK.format(
        bench=str(checkout / "prover_bench"), nth=2 + nth, fault=fault))
    return [sys.executable, str(path)]


def test_a_rank_that_raises_ends_the_run(tiny_checkout, tmp_path):
    command = _failing_command(tiny_checkout, tmp_path,
                               'raise RuntimeError("planted in job 2")', 2)
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailure) as e:
        _run(tiny_checkout, "tiny_domain.serial2", seconds=30,
             rank_command=command)
    assert time.monotonic() - t0 < 30 + ranks.SETUP_ALLOWANCE_S
    assert str(e.value).startswith("rank 1: BenchError: job 1 (n = ")
    assert "RuntimeError: planted in job 2" in str(e.value)


def test_a_rank_that_hangs_ends_at_the_deadline(tiny_checkout, tmp_path,
                                                monkeypatch):
    """Rank 1 sleeps in the window's first job while rank 0 waits in a
    collective: the parent ends both at the deadline."""
    monkeypatch.setattr(ranks, "SETUP_ALLOWANCE_S", 40)
    command = _failing_command(tiny_checkout, tmp_path,
                               "import time; time.sleep(3600)", 1)
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailure) as e:
        _run(tiny_checkout, "tiny_domain.serial2", seconds=1,
             rank_command=command)
    assert 1 + 40 <= time.monotonic() - t0 < 1 + 40 + 10
    assert str(e.value).startswith("ranks [0, 1] still ran at the deadline")


LIGHT_PROFILER = """
import contextlib, sys, time
sys.path.insert(0, {bench!r})
import tracing
events = []


@contextlib.contextmanager
def recorded_range(name):
    t = time.perf_counter_ns() / 1e3
    try:
        yield
    finally:
        events.append({{"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": t, "dur": time.perf_counter_ns() / 1e3 - t,
                       "tid": 1}})


@contextlib.contextmanager
def profiled(cuda=True):
    holder = type("Recording", (), {{"events": None}})()
    events.clear()
    yield holder
    holder.events = list(events)


tracing._range, tracing.profiled = recorded_range, profiled
import run
sys.exit(run.main(sys.argv[1:]))
"""


def test_traced_ranks_reach_every_layer_entry(tiny_checkout, tmp_path):
    """A `--trace 1` run of 2 ranks: it fails if rank 0's wrappers miss an
    entry point, and the sharded path misses none.  The ranks record the
    benchmark's ranges by themselves in place of the profiler, whose CPU
    recording of the plain kernels' millions of operations would take
    minutes here; the profiler's own reading is the card's to test."""
    path = tmp_path / "light_profiler.py"
    path.write_text(LIGHT_PROFILER.format(
        bench=str(tiny_checkout / "prover_bench")))
    result, lines = _run(tiny_checkout, "tiny_domain.serial2", trace=True,
                         rank_command=[sys.executable, str(path)])
    assert result["correct"], lines
    assert {"round1_s", "round4_s", "device_idle_share",
            "launches_per_job"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0
    assert sum(1 for line in lines if "device busy" in line) == 2


def test_a_one_card_cell_starts_no_rank(tiny_checkout, monkeypatch):
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a one-card cell started a rank or a group")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(ranks, "launch", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    result, lines = _run(tiny_checkout, "tiny.serial")
    assert result["correct"], lines
    assert list(result["checks"]) == ["rejected_proofs", "failed_jobs"]
    assert "ranks" not in result and result["device"]["count"] == 1


def test_a_sharded_cell_states_its_layout(tiny_checkout):
    import json

    manifest = json.loads((tiny_checkout / "BENCHMARK.json").read_text())
    for w in manifest["workloads"]:
        if w["name"] == "tiny_domain.serial2":
            w["config"] = "tiny"
    with pytest.raises(harness.BenchError, match="shard_axis"):
        harness.resolve(manifest, "tiny_domain.serial2",
                        tiny_checkout / "prover_bench")


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except FileNotFoundError:
        return False


def _children(pid: int) -> list:
    out = subprocess.run(["pgrep", "-P", str(pid)], capture_output=True,
                         text=True)
    return [int(p) for p in out.stdout.split()]


def test_no_rank_outlives_a_killed_parent(tiny_checkout):
    """The ranks die with their parent, however it dies (here SIGKILL)."""
    import os
    import signal

    parent = subprocess.Popen(
        [sys.executable, "prover_bench/run.py", "--workload",
         "tiny_domain.serial2", "--seed", str(SEED), "--seconds", "60",
         "--device", "cpu"], cwd=tiny_checkout, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while len(_children(parent.pid)) < 2:
            assert time.monotonic() < deadline and parent.poll() is None
            time.sleep(0.2)
        ranks_pids = _children(parent.pid)
        time.sleep(3)  # the ranks are past their start
    finally:
        parent.kill()
        parent.wait()
    deadline = time.monotonic() + 30
    alive = ranks_pids
    while alive and time.monotonic() < deadline:
        time.sleep(0.2)
        alive = [p for p in alive if _alive(p)]
    for p in alive:
        os.kill(p, signal.SIGKILL)
    assert not alive
