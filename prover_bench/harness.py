"""The benchmark's harness: resolves a cell by name, sets up its traces,
runs the measured window of proving jobs, checks every proof against the
reference, and prints one result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name: `configs/<config>.json`, `traffic/<traffic>.json`
(and an optional `traffic/<traffic>.py` with a `window(ctx)` of its own),
`metrics/<metric>.py` (a `read(run)` that returns a number or None).  The
cell's entry in `BENCHMARK.json` says which metrics it reports."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import reference
import tracing

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lambdaworks_cairo_prover_tpu")


class BenchError(Exception):
    """The run cannot give a result (no card, a missing file, a bad cell)."""


def forbidden_modules(names) -> list[str]:
    """Module names whose top-level name, compared whole, is one the
    benchmark must not load."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(manifest: dict, workload: str, bench_dir: Path = BENCH_DIR):
    """The cell's entry, its configuration and traffic files' contents, its
    metric entries and the readers of those metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config_entry = configs[cell["config"]]
    config = json.loads((bench_dir.parent / config_entry["file"]).read_text())
    traffic_path = bench_dir / "traffic" / f"{cell['traffic']}.json"
    traffic = json.loads(traffic_path.read_text())
    loop_path = traffic_path.with_suffix(".py")
    if not loop_path.exists() and (
            traffic.get("loop") != "closed" or traffic.get("jobs_in_flight") != 1
            or traffic.get("order") != "alternate"):
        raise BenchError(f"traffic {cell['traffic']!r}: the general loop runs "
                         f"one job in flight over the traces in turn; another "
                         f"mix brings traffic/{cell['traffic']}.py")

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    end_to_end = [m for m in manifest["end_to_end"] if applies(m)]
    per_layer = [m for m in manifest["per_layer"] if applies(m)]
    readers = {m["name"]: _load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                       f"metric_{m['name']}").read
               for m in end_to_end + per_layer}
    return SimpleNamespace(
        name=workload, entry=cell, config=config, traffic=traffic,
        loop=(_load_module(loop_path, f"traffic_{cell['traffic']}").window
              if loop_path.exists() else None),
        end_to_end=end_to_end, per_layer=per_layer, readers=readers)


def pick_sizes(config: dict, traffic: dict, seed: int) -> list[int]:
    """The program sizes of the cell's distinct traces, drawn from the
    configuration's range (every size in it pads to the same rows).  At the
    traffic's `config_size_seed` the first is the configuration's own."""
    lo, hi = config["n_range"]
    count = traffic["distinct_traces"]
    rng = random.Random(seed)
    sizes = []
    if seed == traffic.get("config_size_seed"):
        sizes.append(config["n"])
    while len(sizes) < count:
        n = rng.randint(lo, hi)
        if n not in sizes:
            sizes.append(n)
    return sizes


def closed_loop(ctx) -> None:
    """One job in flight: the next job starts when the last one's proof is
    on the host; jobs take the traces in turn.  Jobs start while the window
    is open, and the window ends with the last one."""
    i = 0
    while True:
        if ctx.record and i == ctx.record_jobs:
            ctx.stop_recording()
        if time.perf_counter() - ctx.window_start >= ctx.seconds and (
                not ctx.record or i >= ctx.record_jobs):
            break
        if not ctx.run_job(i % len(ctx.traces)):
            break
        i += 1


def _card_facts() -> dict:
    """The card's power limit, as nvidia-smi reads it (nothing without
    nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"power_limit": out.splitlines()[0]} if out else {}


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, manifest_path: Path, device: str = "cuda",
        bench_dir: Path = BENCH_DIR) -> tuple[dict, list[str]]:
    """Set up, measure and check one cell; returns the result object and
    the lines of checks for standard error."""
    import torch

    cell = resolve(json.loads(manifest_path.read_text()), workload, bench_dir)
    chips = cell.entry["chips"]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: torch.cuda.is_available() is "
                             "false")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} cards, "
                             f"{torch.cuda.device_count()} found")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)

    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.cairo.vm import Program
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover import prove as prove_mod

    cfg = cell.config
    opts = cfg["options"]
    options = ProofOptions(**opts)
    sizes = pick_sizes(cfg, cell.traffic, seed)

    # set-up: the traces through the program's own path, then every job
    # shape proved once cold and once warm
    traces = []
    for n in sizes:
        program = Program(data=reference.bytecode(cfg["program"], n),
                          main_pc=0, builtins=[])
        t, pub = generate_prover_args(program, device=dev)
        if (t.n_rows, t.n_cols) != (cfg["rows"], cfg["main_columns"]):
            raise BenchError(f"n = {n} gave a {t.n_rows} x {t.n_cols} trace, "
                             f"the configuration states {cfg['rows']} x "
                             f"{cfg['main_columns']}")
        traces.append(SimpleNamespace(n=n, trace=t, pub=pub,
                                      timings=dict(t._timings)))

    def job(k):
        tr = traces[k]
        with tracing.maybe_range(rec, "bench.prove"):
            proof = prove_mod.prove(tr.trace, tr.pub, options, CairoAIR,
                                    device=dev)
        with tracing.maybe_range(rec, "bench.serialize"):
            return serialize_proof(proof), proof._timings

    rec = tracing.Recorder()
    for _ in range(cell.traffic["warmup_rounds"]):
        for k in range(len(traces)):
            job(k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    jobs, errors = [], []
    ctx = SimpleNamespace(traces=traces, seconds=seconds, record=trace,
                          record_jobs=cell.traffic["recorded_jobs"],
                          recording=None)
    recording = contextlib.ExitStack()

    def start_recording():
        recording.enter_context(tracing.instrumented(rec))
        ctx.recording = recording.enter_context(
            tracing.profiled(dev.type == "cuda"))
        rec.on = True

    def stop_recording():
        rec.on = False
        recording.close()

    # each trace's distinct proofs; a job keeps the index of its own, so
    # the window holds one copy of each proof and compares bytes once a job
    proofs = [[] for _ in traces]

    def run_job(k) -> bool:
        start = time.perf_counter()
        try:
            with tracing.maybe_range(rec, "bench.job"):
                data, timings = job(k)
        except Exception as e:  # a failed job is counted, and ends the window
            errors.append(f"job {len(jobs)} (n = {traces[k].n}): "
                          f"{type(e).__name__}: {e}")
            jobs.append(SimpleNamespace(trace=k, start=start,
                                        end=time.perf_counter(), proof=None,
                                        timings={}, recorded=rec.on))
            return False
        end = time.perf_counter()
        if not proofs[k] or proofs[k][-1] != data:
            proofs[k].append(data)
        jobs.append(SimpleNamespace(trace=k, start=start, end=end,
                                    proof=len(proofs[k]) - 1,
                                    timings=timings, recorded=rec.on))
        return True

    ctx.run_job, ctx.stop_recording = run_job, stop_recording
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if trace:
        start_recording()
    ctx.window_start = window_start = time.perf_counter()
    try:
        (cell.loop or closed_loop)(ctx)
    finally:
        stop_recording()
    window_end = jobs[-1].end if jobs else time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    profile = None
    if trace:
        missed = tracing.unhit_entries(rec)
        if missed:
            raise BenchError(f"the traced run never went through {missed}: "
                             f"a binding the wrappers did not reach")
        profile = tracing.reduce_trace(ctx.recording.events, rec)

    run_record = SimpleNamespace(
        jobs=jobs, proofs=proofs, window_s=window_end - window_start,
        setup_s=window_start - t_start, peak_bytes=peak,
        traces=[SimpleNamespace(n=t.n, timings=t.timings) for t in traces],
        profile=profile)

    # the program's state goes before the reference runs on the host
    del traces, ctx
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed, log = check_proofs(run_record, cfg, sizes, opts)
    log = errors + log

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]](run_record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values())
        and bool(jobs),
        "attempted": len(jobs), "failed": failed, "metrics": metrics,
        "device": device_facts(dev, chips, peak, profile),
    }
    if profile is not None:
        result["breakdown"] = profile["breakdown"]
        result["recorded_jobs"] = profile["jobs"]
    result["checks"] = checks
    lines = log + [build_line()] + latency_lines(run_record) + [
        f"check {k}: {c['value']} (limit {c['limit']})"
        for k, c in checks.items()]
    return result, lines


def build_line() -> str:
    """Whether this run built the kernels, and the seconds the build took
    (counted in `setup_s`: the first run in a checkout builds)."""
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib

    info = cuda_lib.build_info()
    if not info:
        return "kernel build: no kernel library loaded"
    if info["compiled"]:
        return f"kernel build: compiled in {info['seconds']:.1f} s"
    return "kernel build: found in the checkout"


def latency_lines(run_record) -> list[str]:
    """Every job's latency in ms, in the order they ran; and each trace's:
    count, lowest, median, highest (s)."""
    out = ["job latencies (ms): " + " ".join(
        f"{1e3 * (j.end - j.start):.0f}" for j in run_record.jobs)]
    for k, t in enumerate(run_record.traces):
        lat = sorted(j.end - j.start for j in run_record.jobs
                     if j.trace == k and j.proof is not None)
        if lat:
            out.append(f"jobs of n = {t.n}: {len(lat)}, latency {lat[0]:.4f} "
                       f"/ {lat[len(lat) // 2]:.4f} / {lat[-1]:.4f} s")
    return out


def device_facts(dev, chips, peak, profile) -> dict:
    import torch

    facts = {"platform": "gpu" if dev.type == "cuda" else dev.type,
             "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
             "count": chips, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        facts.update(_card_facts())
    if profile is not None:
        facts["busy_s"] = profile["busy_s"]
        facts["window_s"] = profile["window_s"]
    return facts


def check_proofs(run_record, cfg, sizes, opts):
    """Every job's proof against the reference: each distinct proof of each
    trace is verified once, against the statement that the reference works
    out from the program itself.  Returns the numbers compared, the jobs
    that failed, and a line for each rejected proof."""
    options = reference.Options(**opts)
    statements = [reference.statement(cfg["program"], n) for n in sizes]
    verdicts, log = {}, []
    rejected = failed_jobs = 0
    for j in run_record.jobs:
        if j.proof is None:
            failed_jobs += 1
            continue
        key = (j.trace, j.proof)
        if key not in verdicts:
            verdicts[key] = reference.check(run_record.proofs[j.trace][j.proof],
                                            statements[j.trace], cfg["rows"],
                                            options)
            if verdicts[key] is not None:
                log.append(f"rejected: a proof of n = {sizes[j.trace]}: "
                           f"{verdicts[key]}")
        if verdicts[key] is not None:
            rejected += 1
    checks = {"rejected_proofs": {"value": rejected, "limit": 0},
              "failed_jobs": {"value": failed_jobs, "limit": 0}}
    return checks, rejected + failed_jobs, log
