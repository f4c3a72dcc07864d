"""The frozen work counts on known shapes, the trace reduction and the
end-to-end arithmetic on synthetic records, and the import guard."""

import importlib.util
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import harness
import tracing
import yardstick as ys

BENCH = Path(__file__).resolve().parent


def test_butterfly_and_ntt_counts():
    # 8 points: 3 stages of 4 butterflies; products by a twiddle other than
    # one: 4 (m = 4), 2 (m = 2), 0 (m = 1)
    assert ys.butterfly_ops(8, 2, 3) == 2 * 16 * 3 * 4 + 80 * 6
    n_bytes, ops = ys.ntt_work((16, 3, 8))
    assert n_bytes == 2 * 32 * 3 * 8 + 32 * 4 and ops == 3 * 864
    # a packed operand counts the same bytes as limbs
    assert ys.ntt_work((8, 3, 8)) == (n_bytes, ops)


def test_field_counts():
    n = 1 << 21
    assert ys.mul_work((8, 15, n), (16, 15, 1)) == (
        32 * (15 * n + 15 + 15 * n), 80 * 15 * n)
    assert ys.add_work((16, n), (8, n)) == (32 * 3 * n, 16 * n)
    assert ys.batch_inverse_work((16, 3 * n)) == (64 * 3 * n, 240 * 3 * n)
    assert ys.prefix_product_work((16, n)) == (64 * n, 80 * n)


def test_keccak_counts():
    # 34 felts: 1088 bytes and the padding, 9 blocks of 136
    assert ys.keccak_blocks(34) == 9 and ys.keccak_blocks(1) == 1
    rows = 1 << 19
    assert ys.row_hash_work(rows, 34) == (32 * rows * 35, 4491 * 9 * rows)
    assert ys.tree_work(1 << 21) == (32 * ((1 << 22) - 1),
                                     4491 * ((1 << 21) - 1))
    assert ys.tree_work(1) == (32, 0)


def test_bound():
    assert ys.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert ys.bound_s(0, 16.75e12) == pytest.approx(1.0)
    assert ys.bound_s(3.35e12, 2 * 16.75e12) == pytest.approx(2.0)


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_reduce_trace():
    """Two jobs; a field call nested in a context range, an NTT call with a
    field call inside it (its kernel goes to the field layer), a kernel
    outside every layer range, and idle gaps."""
    ev = [
        _x("bench.job", "user_annotation", 0, 100),
        _x("bench.ProverKernels.round2", "user_annotation", 5, 40),
        _x("bench.field.mul", "user_annotation", 10, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 1, corr=1),
        _x("mont_mul", "kernel", 20, 10, tid=7, corr=1),
        _x("bench.ntt.transform", "user_annotation", 50, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 52, 1, corr=2),
        _x("ntt_pass", "kernel", 55, 20, tid=7, corr=2),
        _x("bench.field.mul", "user_annotation", 60, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 61, 1, corr=3),
        _x("mont_mul", "kernel", 75, 5, tid=7, corr=3),
        _x("bench.job", "user_annotation", 100, 100),
        _x("cudaMemsetAsync", "cuda_runtime", 110, 1, corr=4),
        _x("Memset", "gpu_memset", 150, 10, tid=7, corr=4),
    ]
    rec = tracing.Recorder()
    rec.work["field"] = [0, ys.INT32_OPS_PER_S * 1e-6]   # 1 us of bound
    rec.work["ntt"] = [ys.HBM_BYTES_PER_S * 5e-6, 0]      # 5 us of bound
    out = tracing.reduce_trace(ev, rec)
    assert out["jobs"] == 2 and out["launches"] == 4
    assert out["window_s"] == pytest.approx(200e-6)
    assert out["busy_s"] == pytest.approx(45e-6)
    assert out["layer_device_s"]["field"] == pytest.approx(15e-6)
    assert out["layer_device_s"]["ntt"] == pytest.approx(20e-6)
    assert out["rooflines"]["field"] == pytest.approx(100 / 15)
    assert out["rooflines"]["ntt"] == pytest.approx(25.0)
    assert "hash" not in out["rooflines"]  # nothing to read: left out
    top = dict(out["breakdown"]["device_ops"])
    assert top["mont_mul"] == pytest.approx(15e-6)
    idle = dict(out["breakdown"]["idle_gaps"])
    # gaps, named at their middle: 0-20 (the field call at 10), 30-55
    # (round2 at 42.5), 80-150 and 160-200 (job 2)
    assert idle["bench.field.mul"] == pytest.approx(20e-6)
    assert idle["bench.ProverKernels.round2"] == pytest.approx(25e-6)
    assert idle["bench.job"] == pytest.approx(110e-6)


def _run(latencies, window_s, **extra):
    jobs, t = [], 0.0
    for lat in latencies:
        jobs.append(SimpleNamespace(start=t, end=t + lat, proof=0,
                                    recorded=False,
                                    timings={"round1": lat / 2,
                                             "round4": lat / 4}))
        t += lat
    return SimpleNamespace(jobs=jobs, window_s=window_s, peak_bytes=3 * 2**30,
                           setup_s=12.5, profile=None,
                           traces=[SimpleNamespace(timings={
                               "vm": 1.0, "trace_build": 2.0, "ingest": 0.5,
                               "vm_name": "native"})], **extra)


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_end_to_end_arithmetic():
    lat = [0.3 + 0.01 * i for i in range(20)]  # 0.30 .. 0.49
    run = _run(lat, sum(lat))
    assert _metric("job_s")(run) == pytest.approx(sum(lat) / 20)
    # the 90th percentile between ranks 18 and 19 (0-based 17.1)
    assert _metric("job_p90_s")(run) == pytest.approx(0.471)
    assert _metric("peak_device_gib")(run) == 3.0
    assert _metric("setup_s")(run) == 12.5
    assert _metric("trace_gen_s")(run) == pytest.approx(3.5)
    assert _metric("round1_s")(run) == pytest.approx(sum(lat) / 40)
    assert _metric("round4_s")(run) == pytest.approx(sum(lat) / 80)
    for name in ("field_roofline", "ntt_roofline", "keccak_roofline",
                 "device_idle_share", "launches_per_job"):
        assert _metric(name)(run) is None  # no recording: nothing to read
    run.profile = {"window_s": 2.0, "busy_s": 0.5, "launches": 4000,
                   "jobs": 4, "rooflines": {"field": 80.0, "ntt": 30.0}}
    assert _metric("device_idle_share")(run) == pytest.approx(75.0)
    assert _metric("launches_per_job")(run) == 1000
    assert _metric("keccak_roofline")(run) is None
    assert _metric("field_roofline")(run) == 80.0
    # a failed job is not a completed one
    run.jobs[-1].proof = None
    assert _metric("job_s")(run) == pytest.approx(sum(lat) / 19)


def test_forbidden_modules():
    names = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen",
             "lambdaworks_cairo_prover_tpu", "lambdaworks_cairo_prover_tpu.ntt",
             "lambdaworks_cairo_prover_tpu_torch",
             "lambdaworks_cairo_prover_tpu_torch.field.device", "jaxtyping",
             "torch", "numpy"]
    assert harness.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen",
         "lambdaworks_cairo_prover_tpu", "lambdaworks_cairo_prover_tpu.ntt"])


def test_reference_loads_nothing_of_the_prover():
    code = ("import sys; sys.path.insert(0, %r); import reference, "
            "reference.programs.fibonacci; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('lambdaworks_cairo_prover_tpu_torch', "
            "'lambdaworks_cairo_prover_tpu', 'jax', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
