#!/usr/bin/env python3
"""BASELINE config 5 on the PyTorch/CUDA port: a 2^22-row synthetic trace
(simple_fibonacci) proven with the LDE-domain axis sharded over the ranks of
a ``torch.distributed`` group (four-step NTTs whose transposes are
all-to-alls, Merkle subtrees whose roots are all-gathered).  The counterpart
of tools/config5_scale.py; it imports only the port and torch.

    # one process a card, NCCL
    torchrun --nproc-per-node 4 tools/config5_scale_torch.py --log-rows 22 --bench-options
    # D ranks as child processes of this one, gloo, sharing one card
    python tools/config5_scale_torch.py --ranks 4 --log-rows 20 --bench-options
    # the same on the CPU
    python tools/config5_scale_torch.py --device cpu --ranks 2 --log-rows 10

Each rank proves the trace twice (cold, then warm) with
``prove(mesh=..., shard_axis="domain")``; rank 0 verifies both proofs and
rejects wrong public inputs.  What it records, in one JSON line on standard
output and, with ``--out``, in a file (the JAX tool's keys where it has one):

* ``trace_gen_s`` (``fibonacci_trace``: python ints, then the ingest),
  ``prove_wall_s`` and ``round_timings_s`` of the cold and the warm prove,
  ``verified``, ``proof_bytes`` and ``proof_sha256``;
* per rank (``ranks``): the allocated, peak and reserved device bytes after
  each phase of the cold prove (``phase_memory``; ``prover/prove.py:_mem``
  is replaced for the prove, as the JAX tool replaces its ``_mem``), the
  peak device bytes of each prove, the host's peak RSS, the kernels'
  launches in the cold prove, and the collectives;
* the collectives: every call of ``torch.distributed.all_to_all_single``
  and ``all_gather_into_tensor`` in a prove, keyed by the port's call site
  (``ShardedNTT._a2a``, ``reblock``, ``gather_rows``; ``gather_rows`` also
  by the function that asked for it, ``by_caller``), with the bytes handed
  to the call and the bytes it returns (a rank's own chunk included).  The
  JAX tool sums once per compiled program; this one counts every call;
* the proof against the port's single-device proof of the same trace on
  rank 0's device (``single_device``; ``--no-single`` where one device
  cannot hold it), and a sharded against a single-device proof at
  ``--equality-log-rows`` (``bytes_equal_single_device``; 0 skips it); both
  also against the JAX package's bytes where a fixture has that size and
  those options (``tests/fixtures/torch_port``).

Without ``torchrun`` the ranks are child processes that meet through a
``FileStore``; the default device is ``cuda`` and nothing falls back to the
CPU.  The exit code is 0 only if every proof verified and every comparison
held.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

BENCH = dict(blowup_factor=4, fri_number_of_queries=80, coset_offset=3,
             grinding_factor=20)
# the functions whose collectives are counted, by the name of their frame
SITES = {"_a2a": "four_step.ShardedNTT._a2a", "reblock": "sharding.reblock",
         "gather_rows": "sharding.gather_rows"}
# sharding.py's helpers over gather_rows: its callers are counted apart by
# the first frame above them (_commit: a subtree's root; _halo; ...)
GATHER_HELPERS = {"gather_rows", "gather_stack", "gather_domain", "fetch",
                  "full"}
TIMEOUT = datetime.timedelta(hours=2)


def log(msg: str) -> None:
    print(msg, flush=True)


def _options(bench: bool):
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions

    return (ProofOptions(**BENCH) if bench
            else ProofOptions.default_test_options())


def kernel_wrappers() -> dict:
    """The kernels' wrappers, each with its launch count."""
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
    from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

    return {w.__name__: w for w in (
        cf.mont_mul, cf.add_sub_mod, cn.ntt_dif_stages, cn.ntt_dif_local,
        ck.keccak_rows, ck.keccak_pairs, ck.keccak_grind,
        cs.mont_batch_inverse, cs.mont_prefix_product)}


def jax_reference(log_rows: int, bench: bool):
    """(fixture name, sha256) of the JAX package's simple_fibonacci proof at
    2^log_rows rows with these options, or None where there is none."""
    if not bench and log_rows == 10:
        name = "simple_fibonacci_1024_test_options.proof"
        with open(os.path.join(FIXTURES, name), "rb") as f:
            return name, hashlib.sha256(f.read()).hexdigest()
    name = "simple_fibonacci_bench_digest.json"
    with open(os.path.join(FIXTURES, name)) as f:
        digest = json.load(f)
    if bench and digest["options"] == BENCH and (
            digest["trace_length"] == 1 << log_rows):
        return name, digest["sha256"]
    return None


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def _zero() -> dict:
    return {"calls": 0, "bytes_sent": 0, "bytes_received": 0}


class Collectives:
    """Counts the calls of ``all_to_all_single`` and
    ``all_gather_into_tensor`` made inside the ``with`` block, with the
    bytes of their input and output tensors, by the port's call site (the
    nearest enclosing frame named in SITES; "other" if none)."""

    def __init__(self):
        self.by_site: dict = {}

    def _count(self, inp, out) -> None:
        f = sys._getframe(2)
        site = "other"
        while f is not None:
            if f.f_code.co_name in SITES:
                site = SITES[f.f_code.co_name]
                break
            f = f.f_back
        recs = [self.by_site.setdefault(site, _zero())]
        if f is not None and f.f_code.co_name == "gather_rows":
            while f is not None and f.f_code.co_name in GATHER_HELPERS:
                f = f.f_back
            caller = f.f_code.co_name if f is not None else "other"
            recs.append(recs[0].setdefault("by_caller", {}).setdefault(
                caller, _zero()))
        for rec in recs:
            rec["calls"] += 1
            rec["bytes_sent"] += inp.numel() * inp.element_size()
            rec["bytes_received"] += out.numel() * out.element_size()

    def __enter__(self):
        self._orig = (dist.all_to_all_single, dist.all_gather_into_tensor)
        a2a, gather = self._orig

        def all_to_all_single(output, input, *args, **kwargs):
            self._count(input, output)
            return a2a(output, input, *args, **kwargs)

        def all_gather_into_tensor(output_tensor, input_tensor, *args,
                                   **kwargs):
            self._count(input_tensor, output_tensor)
            return gather(output_tensor, input_tensor, *args, **kwargs)

        dist.all_to_all_single = all_to_all_single
        dist.all_gather_into_tensor = all_gather_into_tensor
        return self

    def __exit__(self, *exc):
        dist.all_to_all_single, dist.all_gather_into_tensor = self._orig
        return False


class PhaseMemory:
    """Replaces ``prover/prove.py:_mem`` inside the ``with`` block: after each
    phase of a prove, the device's allocated, peak and reserved bytes (after
    a synchronize), or "unavailable" on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.phases: list = []

    def _record(self, tag: str, device=None) -> None:
        if self.device.type != "cuda":
            self.phases.append({"phase": tag, "bytes": "unavailable: the "
                                f"prove runs on {self.device}"})
            return
        torch.cuda.synchronize(self.device)
        self.phases.append({
            "phase": tag,
            "allocated_bytes": torch.cuda.memory_allocated(self.device),
            "peak_bytes": torch.cuda.max_memory_allocated(self.device),
            "reserved_bytes": torch.cuda.memory_reserved(self.device)})

    def __enter__(self):
        from lambdaworks_cairo_prover_tpu_torch.prover import prove as prove_mod

        self._mod, self._orig = prove_mod, prove_mod._mem
        prove_mod._mem = self._record
        return self

    def __exit__(self, *exc):
        self._mod._mem = self._orig
        return False


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    if device.type != "cuda":
        return "unavailable"
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def host_peak_rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# ---------------------------------------------------------------------------
# proves
# ---------------------------------------------------------------------------


def fib_trace(log_rows: int, device):
    from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
        fibonacci_trace)

    return fibonacci_trace([1, 1], 1 << log_rows, device=device)


def prove_fib(trace, options, device, mesh=None):
    """(proof, its bytes, wall seconds) of one prove, sharded over ``mesh``
    by domain where given."""
    from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
        FibonacciAIR, FibonacciPublicInputs)
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove

    t0 = time.perf_counter()
    proof = prove(trace, FibonacciPublicInputs(a0=1, a1=1), options,
                  FibonacciAIR, device=device, mesh=mesh, shard_axis="domain")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return proof, serialize_proof(proof), time.perf_counter() - t0


def verify_fib(proof, options) -> dict:
    """Whether the proof verifies and wrong public inputs are rejected."""
    from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
        FibonacciAIR, FibonacciPublicInputs)
    from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

    t0 = time.perf_counter()
    ok = verify(proof, FibonacciPublicInputs(a0=1, a1=1), options, FibonacciAIR)
    seconds = time.perf_counter() - t0
    wrong = verify(proof, FibonacciPublicInputs(a0=2, a1=1), options,
                   FibonacciAIR)
    return {"verified": bool(ok), "wrong_public_inputs_rejected": not wrong,
            "verify_s": seconds}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def scale_run(log_rows: int, bench: bool, device, mesh, rank: int) -> dict:
    """This rank's part of the scale run: the trace, a cold prove under the
    telemetry, a warm prove; rank 0 verifies both."""
    options = _options(bench)
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    trace = fib_trace(log_rows, device)
    trace_s = time.perf_counter() - t0
    log(f"[config5] rank {rank}: trace of 2^{log_rows} rows in {trace_s:.3f} s")
    proves = {}
    for tag in ("cold", "warm"):
        for w in wrappers.values():
            w.launches = 0
        _reset_peak(device)
        with Collectives() as coll, PhaseMemory(device) as mem:
            proof, data, wall = prove_fib(trace, options, device, mesh)
        proves[tag] = {
            "proof": proof, "bytes": data, "prove_wall_s": wall,
            "round_timings_s": dict(proof._timings),
            "peak_device_bytes": _peak(device), "phase_memory": mem.phases,
            "collectives": coll.by_site,
            "launches": {k: w.launches for k, w in wrappers.items()}}
        log(f"[config5] rank {rank}: {tag} prove {wall:.3f} s, "
            f"{len(data)} bytes, sha256 {_sha(data)}")
    cold = proves["cold"]
    rec = {
        "rank": rank, "device": str(device), "trace_gen_s": trace_s,
        "proof_sha256": {t: _sha(p["bytes"]) for t, p in proves.items()},
        "prove_wall_s": {t: p["prove_wall_s"] for t, p in proves.items()},
        "round_timings_s": {t: p["round_timings_s"] for t, p in proves.items()},
        "peak_device_bytes": {t: p["peak_device_bytes"]
                              for t, p in proves.items()},
        "phase_memory": cold["phase_memory"],
        "collectives": {t: p["collectives"] for t, p in proves.items()},
        "launches": cold["launches"], "proof_bytes": len(cold["bytes"]),
    }
    if rank == 0:
        rec["verify"] = {t: verify_fib(p["proof"], options)
                         for t, p in proves.items()}
    rec["host_peak_rss_bytes"] = host_peak_rss()
    rec["jax_modules_loaded"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "lambdaworks_cairo_prover_tpu"))
    return rec


def single_device(log_rows: int, bench: bool, device) -> dict:
    """The port's single-device proof of the same trace on ``device``."""
    trace = fib_trace(log_rows, device)
    _reset_peak(device)
    proof, data, wall = prove_fib(trace, _options(bench), device)
    return {"log2_rows": log_rows, "sha256": _sha(data), "prove_s": wall,
            "peak_device_bytes": _peak(device), "proof_bytes": len(data)}


def equality_run(log_rows: int, bench: bool, device, mesh, rank: int) -> dict:
    """A sharded proof at 2^log_rows rows (every rank) and, on rank 0, the
    single-device proof of the same trace."""
    options = _options(bench)
    _, data, wall = prove_fib(fib_trace(log_rows, device), options, device,
                              mesh)
    rec = {"sha256": _sha(data), "sharded_s": wall}
    if rank == 0:
        single = single_device(log_rows, bench, device)
        rec.update(single_sha256=single["sha256"], single_s=single["prove_s"])
    return rec


def _fixture_check(log_rows: int, bench: bool, sha: str):
    ref = jax_reference(log_rows, bench)
    if ref is None:
        return None
    return {"fixture": ref[0], "equal": sha == ref[1]}


def merge(args, records: list, world: int, backend: str, kind: str) -> dict:
    """The run's record from every rank's (rank 0's first)."""
    head = records[0]
    scale = [r["scale"] for r in records]
    cold_sha = head["scale"]["proof_sha256"]["cold"]
    verify = head["scale"]["verify"]
    ranks_equal = all(s["proof_sha256"][t] == cold_sha
                      for s in scale for t in ("cold", "warm"))
    rec = {
        "config": "BASELINE config 5 (domain-sharded long-trace prove), "
                  "PyTorch/CUDA port",
        "trace_rows_log2": args.log_rows,
        "lde_points": 4 << args.log_rows,
        "options": BENCH if args.bench_options else "default_test_options",
        "n_devices": world, "mesh_backend": backend, "device": kind,
        "trace_gen_s": head["scale"]["trace_gen_s"],
        "prove_wall_s": head["scale"]["prove_wall_s"],
        "round_timings_s": head["scale"]["round_timings_s"],
        "verified": all(v["verified"] for v in verify.values()),
        "wrong_public_inputs_rejected": all(
            v["wrong_public_inputs_rejected"] for v in verify.values()),
        "verify_s": {t: v["verify_s"] for t, v in verify.items()},
        "proof_bytes": head["scale"]["proof_bytes"],
        "proof_sha256": cold_sha,
        "ranks_equal": ranks_equal,
        "jax_modules_loaded": sorted({m for s in scale
                                      for m in s["jax_modules_loaded"]}),
        "ranks": [{k: v for k, v in s.items() if k != "verify"}
                  for s in scale],
        "per_device_peak_bytes": (
            max(s["peak_device_bytes"]["cold"] for s in scale)
            if all(isinstance(s["peak_device_bytes"]["cold"], int)
                   for s in scale) else "unavailable"),
        "host_peak_rss_bytes": max(s["host_peak_rss_bytes"] for s in scale),
        "collectives_counted": "every call in one prove, on each rank; "
                               "bytes handed to the call and returned by it",
        "collective_bytes_by_site": _sum_sites(scale),
        "jax_fixture": _fixture_check(args.log_rows, args.bench_options,
                                      cold_sha),
        "single_device": None,
        "bytes_equal_single_device": None,
    }
    if head.get("single") is not None:
        single = head["single"]
        rec["single_device"] = dict(single, equal=single["sha256"] == cold_sha)
    if head.get("equality") is not None:
        eq = head["equality"]
        shas = {r["equality"]["sha256"] for r in records}
        rec["bytes_equal_single_device"] = {
            "log2_rows": args.equality_log_rows,
            "equal": shas == {eq["single_sha256"]},
            "single_s": eq["single_s"], "sharded_s": eq["sharded_s"],
            "jax_fixture": _fixture_check(args.equality_log_rows,
                                          args.bench_options,
                                          eq["single_sha256"]),
        }
    checks = [rec["verified"], rec["wrong_public_inputs_rejected"],
              ranks_equal, not rec["jax_modules_loaded"]]
    for part in (rec["jax_fixture"], rec["single_device"],
                 rec["bytes_equal_single_device"],
                 (rec["bytes_equal_single_device"] or {}).get("jax_fixture")):
        if part is not None:
            checks.append(part["equal"])
    rec["ok"] = all(checks)
    return rec


def _sum_sites(scale: list) -> dict:
    """Each site's calls and bytes in the cold prove, summed over the ranks."""
    out: dict = {}
    for s in scale:
        for site, c in s["collectives"]["cold"].items():
            acc = out.setdefault(site, _zero())
            for k in _zero():
                acc[k] += c[k]
    return out


def run_rank(args, rank: int, world: int, device) -> dict:
    """Everything one rank does inside the process group; rank 0 gets the
    merged record, the others None."""
    from lambdaworks_cairo_prover_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(world, device_type=device.type)
    mine: dict = {"rank": rank}
    if args.equality_log_rows:
        mine["equality"] = equality_run(args.equality_log_rows,
                                        args.bench_options, device, mesh, rank)
    mine["scale"] = scale_run(args.log_rows, args.bench_options, device, mesh,
                              rank)
    if rank == 0 and not args.no_single:
        mine["single"] = single_device(args.log_rows, args.bench_options,
                                       device)
        log(f"[config5] single-device proof on {device}: "
            f"{mine['single']['prove_s']:.3f} s, sha256 "
            f"{mine['single']['sha256']}")
    records = [None] * world
    dist.all_gather_object(records, mine)
    if rank != 0:
        return None
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return merge(args, records, world, dist.get_backend(), kind)


def _emit(args, rec: dict) -> int:
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


def _init(backend: str, **kwargs) -> None:
    # torch > 2.11 calls all_gather_into_tensor deprecated; the card's torch
    # has no other name for it
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=".*all_gather_into_tensor.*")
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)


def _finish(rank: int) -> None:
    dist.barrier()  # no rank tears its connections down while another uses them
    dist.destroy_process_group()


def main_torchrun(args) -> int:
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if args.device == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        _init("nccl", init_method="env://", device_id=device)
    else:
        device = torch.device("cpu")
        _init("gloo", init_method="env://")
    rec = run_rank(args, rank, world, device)
    _finish(rank)
    return _emit(args, rec) if rank == 0 else 0


def main_child(args) -> int:
    """One of the --ranks children: gloo over a FileStore, every child on
    the same device; rank 0 writes the record to --result."""
    device = torch.device("cuda", 0) if args.device == "cuda" else (
        torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)  # D ranks share the host's cores
    _init("gloo", store=dist.FileStore(args.store, args.ranks),
          rank=args.rank, world_size=args.ranks)
    rec = run_rank(args, args.rank, args.ranks, device)
    _finish(args.rank)
    if rec is not None:
        with open(args.result, "w") as f:
            json.dump(rec, f)
    return 0


def main_spawn(args) -> int:
    """Start --ranks children of this script and report rank 0's record."""
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "record.json")
        base = [sys.executable, os.path.abspath(__file__)] + sys.argv[1:]
        env = dict(os.environ)
        if args.device == "cpu":
            env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        # each rank writes to a file: a full pipe would stall a rank inside a
        # collective while this process waits on another
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(args.ranks)]
        procs = [subprocess.Popen(
            base + ["--rank", str(r), "--store", os.path.join(tmp, "store"),
                    "--result", result],
            cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(args.ranks)]
        try:
            deadline = time.monotonic() + args.timeout
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for f in logs:
                f.seek(0)
                texts.append(f.read())
                f.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        for line in texts[0].splitlines():
            if line.startswith("[config5]"):
                log(line)
        if failed or not os.path.exists(result):
            for r in failed or [0]:
                print(f"rank {r} of {args.ranks} failed (exit code "
                      f"{procs[r].returncode}):\n{texts[r][-6000:]}",
                      file=sys.stderr, flush=True)
            return 1
        with open(result) as f:
            rec = json.load(f)
    return _emit(args, rec)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-rows", type=int, default=22,
                    help="log2 of the trace's rows (BASELINE: 22)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks to start as child processes (without torchrun)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--bench-options", action="store_true",
                    help="blowup 4, 80 queries, coset 3, grinding 20 (else "
                         "ProofOptions.default_test_options())")
    ap.add_argument("--equality-log-rows", type=int, default=16,
                    help="rows of the sharded vs single-device check (0: none)")
    ap.add_argument("--no-single", action="store_true",
                    help="no single-device proof at --log-rows")
    ap.add_argument("--out", help="also write the record to this file")
    ap.add_argument("--timeout", type=float, default=3600,
                    help="seconds the children may take")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("config5_scale_torch: --device cuda, and "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return main_torchrun(args)
    if args.rank is not None:
        return main_child(args)
    return main_spawn(args)


if __name__ == "__main__":
    sys.exit(main())
