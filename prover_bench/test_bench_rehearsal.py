"""A run of the harness at a tiny size on the CPU, with the look for a
card skipped: correct as it stands, and not correct with each planted
fault and the control under the timed path; the layer wrappers reach every
entry point; a run loads neither JAX nor the JAX package."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

import controls
import harness
import tracing

BENCH = Path(__file__).resolve().parent


def _run(checkout, seconds=0.5, seed=3, trace=False):
    return harness.run("tiny.serial", seed, seconds, trace,
                       t_start=time.perf_counter(),
                       manifest_path=checkout / "BENCHMARK.json",
                       device="cpu", bench_dir=checkout / "prover_bench")


def test_tiny_run_is_correct(tiny_checkout):
    result, lines = _run(tiny_checkout)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert {"job_s", "setup_s"} <= set(result["metrics"])
    assert lines[-2:] == ["check rejected_proofs: 0 (limit 0)",
                          "check failed_jobs: 0 (limit 0)"]
    json.dumps(result)


@pytest.mark.parametrize("plant", sorted(controls.PLANTS))
def test_a_planted_fault_is_not_correct(tiny_checkout, plant):
    with controls.PLANTS[plant]():
        result, lines = _run(tiny_checkout)
    assert not result["correct"], lines
    assert result["checks"]["rejected_proofs"]["value"] >= 1


def test_the_plants_are_undone(tiny_checkout):
    for plant in controls.PLANTS.values():
        with plant():
            pass
    result, _ = _run(tiny_checkout)
    assert result["correct"]


def test_wrappers_reach_every_entry_point():
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.cairo.programs import (
        fibonacci_program)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.prover import kernels
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove

    original = (fd.mul, kernels.tree_levels, kernels.ProverKernels.round2)
    trace, pub = generate_prover_args(fibonacci_program(5), device="cpu")
    rec = tracing.Recorder()
    with tracing.instrumented(rec):
        assert kernels.tree_levels is not original[1]
        rec.on = True
        prove(trace, pub, ProofOptions(4, 3, 3, 1), CairoAIR, device="cpu")
        rec.on = False
    assert tracing.unhit_entries(rec) == []
    assert all(rec.work[layer][0] > 0 and rec.work[layer][1] > 0
               for layer in tracing.LAYERS)
    assert (fd.mul, kernels.tree_levels,
            kernels.ProverKernels.round2) == original


def test_a_run_loads_no_jax(tiny_checkout):
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r]; import harness; "
        "from pathlib import Path; c = Path(%r); "
        "r, _ = harness.run('tiny.serial', 5, 0.1, False, "
        "t_start=time.perf_counter(), manifest_path=c / 'BENCHMARK.json', "
        "device='cpu', bench_dir=c / 'prover_bench'); "
        "print(json.dumps([r['correct'], harness.forbidden_modules("
        "sys.modules), 'lambdaworks_cairo_prover_tpu_torch' in sys.modules]))"
        % (str(tiny_checkout / "prover_bench"), str(BENCH.parent),
           str(tiny_checkout)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_run_py_without_a_card_gives_no_result(tmp_path):
    """On a machine without a card (as here) the entry prints no result
    and exits non-zero; in a checkout that holds only the benchmark, too."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "cairo_fib70k.serial", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr
    shutil.copytree(BENCH, tmp_path / "prover_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "prover_bench/run.py", "--workload",
         "cairo_fib70k.serial", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cairo_fib70k.serial",
                                  "cairo_fib280k.serial"])
def test_cell_on_the_card(cuda_card, cell):
    """Each cell's short run on the card is correct (run on the chip)."""
    result, lines = harness.run(cell, 7, 3.0, False,
                                t_start=time.perf_counter(),
                                manifest_path=BENCH.parent / "BENCHMARK.json")
    assert result["correct"], lines
