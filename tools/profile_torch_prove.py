#!/usr/bin/env python3
"""Where the time of a warm prove goes on a CUDA GPU.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 tools/profile_torch_prove.py [--workload simple_fibonacci|cairo_fib|cairo_hints]
        [--log-rows 19] [--fib-n 70000] [--repeats 3]
        [--fri-route chain|per-layer|both] [--out DIR] [--root DIR]

``--workload simple_fibonacci`` (the default) proves the one-column example
AIR at 2^``--log-rows`` rows; ``--workload cairo_fib`` runs the Cairo program
``fibonacci_program(--fib-n)`` through ``generate_prover_args`` (70000, the
default: 2^19 rows x 52 columns; 280000: 2^21 rows) and proves its trace
with ``generate_cairo_proof``;
``--workload cairo_hints`` does the same with the hinted range-check program
``compare_lesser_array_program(9600)`` (python VM, 2^19 rows x 61 columns).

Proves once to build the kernels and tables, then ``--repeats`` times on
the host clock (each prove ends in copies to the host, so the device work
is inside), then once more under ``torch.profiler``.  Prints the card
(``nvidia-smi``), the warm wall times with their per-round split, the
device's busy time (the sum of kernel times: one stream, so kernels do not
overlap; with ``--mesh`` NCCL's kernels run on a stream of their own, may
overlap the others, and count the time they wait for the other ranks)
and idle share over the profiled prove, and the device time by
group and by kernel.  With ``--out``, also writes the profiler's table
there (a Chrome trace of a whole prove is too large to keep).  Uses the bench options: blowup 4, 80 FRI queries, coset offset
3, grinding 20.

``--root DIR`` proves with the package of another checkout (the parent
commit unpacked with ``git archive``, say), so that two versions are
profiled by the same tool and grouped alike.

``--mesh`` proves on several cards at once, the LDE domain sharded
(``prove(mesh=..., shard_axis="domain")``), one process per card, started by
``torchrun``, which gives each its rank and the group's address::

    torchrun --nproc-per-node 4 tools/profile_torch_prove.py --workload cairo_fib --mesh

Each rank joins an NCCL group on ``cuda:LOCAL_RANK``; rank 0 prints the
timings and the profile of its own card, every rank its peak device memory,
and all check that their proofs are equal.  The cold prove (the first,
after the kernels are built) is printed too, and with ``--mesh`` the
scaling of the four-step NTT at 2^NTT_LOG points as the JAX package's
bench.py defines it: T1 / (D · TD), T1 the single-card transform, TD the
sharded one (best of 5 each, host clock around a synchronised run).

``--fri-route`` picks the FRI commit route of the warm and profiled
proves: ``chain`` (the default: the on-device chain of
``ProverKernels.fri_commit_chain``), ``per-layer`` (a ``DefaultTranscript``
subclass, which the chain's gate sends layer by layer), or ``both``: the
warm proves take the routes in turns (chain, per-layer, per-layer, chain,
...), every proof must equal the first, the medians of each route's warm
prove and ``round4_fri_commit`` are printed, and the profiled prove takes
the chain.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAIRO_FIB_N = 70000  # the cairo_fib workload's default: 2^19 rows x 52 columns
HINTS_LENGTH = 9600  # the cairo_hints workload: 2^19 rows x 61 columns
NTT_LOG = 20  # --mesh: the four-step NTT's size, bench.py's BENCH_NTT_LOG2

# kernel-name fragment -> group; the first match wins, the rest is "other"
GROUPS = (
    ("keccak_rows_kernel", "K1 keccak_rows"),
    ("keccak_pairs_kernel", "K2 keccak_pairs"),
    ("keccak_grind_kernel", "K3 keccak_grind"),
    ("fri_tail_kernel", "K4 fri_tail"),
    ("mont_mul_kernel", "H1 mont_mul"),
    ("add_sub_kernel", "H2 add_sub_mod"),
    ("ntt_dif_stages_kernel", "H3 ntt_dif_stages"),
    ("ntt_dif_local_kernel", "H4 ntt_dif_local"),
    ("inv_reduce_kernel", "H5 mont_batch_inverse"),
    ("inv_totals_kernel", "H5 mont_batch_inverse"),
    ("inv_apply_kernel", "H5 mont_batch_inverse"),
    # H5's passes before its redesign (a checkout from before, --root)
    ("inv_forward_kernel", "H5 mont_batch_inverse"),
    ("inv_backward_kernel", "H5 mont_batch_inverse"),
    ("prefix_product_kernel", "H6 mont_prefix_product"),
    # H6's passes before its redesign (a checkout from before, --root)
    ("prefix_reduce_kernel", "H6 mont_prefix_product"),
    ("prefix_totals_kernel", "H6 mont_prefix_product"),
    ("prefix_scan_kernel", "H6 mont_prefix_product"),
    ("roll", "PyTorch roll"),
    ("sort", "PyTorch sort"),
    ("Sort", "PyTorch sort"),
    # before "cat": _scatter_gather_elementwise_kernel holds that word too
    ("gather", "PyTorch gather / index_select"),
    ("index", "PyTorch gather / index_select"),
    ("cat", "PyTorch cat / stack"),
    ("Cat", "PyTorch cat / stack"),
    ("elementwise", "PyTorch elementwise"),
    ("copy", "copies"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=("simple_fibonacci", "cairo_fib",
                                           "cairo_hints"),
                    default="simple_fibonacci")
    ap.add_argument("--log-rows", type=int, default=19,
                    help="simple_fibonacci: log2 of the trace length")
    ap.add_argument("--fib-n", type=int, default=CAIRO_FIB_N,
                    help="cairo_fib: n of fibonacci_program(n)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--fri-route", choices=("chain", "per-layer", "both"),
                    default="chain")
    ap.add_argument("--out", help="directory for the profiler's table")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package proves (another one, "
                    "such as the parent unpacked with git archive, to "
                    "compare two versions in one call)")
    ap.add_argument("--mesh", action="store_true",
                    help="prove over all ranks of a torchrun group, the "
                    "LDE domain sharded")
    args = ap.parse_args()
    say = print

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
        FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.cairo.programs import (
        fibonacci_program)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.cairo.stdlib import (
        compare_lesser_array_program)
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove
    from lambdaworks_cairo_prover_tpu_torch.transcript import DefaultTranscript

    class PerLayerTranscript(DefaultTranscript):
        """The default transcript under another type: the per-layer route."""

    factories = {"chain": DefaultTranscript, "per-layer": PerLayerTranscript}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(f"[card] {card}", flush=True)
    options = ProofOptions(blowup_factor=4, fri_number_of_queries=80,
                           coset_offset=3, grinding_factor=20)
    dev = torch.device("cuda", 0)
    mesh, rank = None, 0
    if args.mesh:
        import torch.distributed as dist

        from lambdaworks_cairo_prover_tpu_torch import cuda_lib
        from lambdaworks_cairo_prover_tpu_torch.parallel.sharding import (
            make_mesh)

        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl")  # rank, size, address: torchrun's
        mesh, rank = make_mesh(), dist.get_rank()
        cuda_lib.library()  # built before the cold prove
    if rank:  # rank 0 reports; the others prove beside it
        say = _quiet
    if args.workload in ("cairo_fib", "cairo_hints"):
        air_class = CairoAIR
        program, name = (
            (fibonacci_program(args.fib_n), f"fibonacci_program({args.fib_n})")
            if args.workload == "cairo_fib" else
            (compare_lesser_array_program(HINTS_LENGTH),
             f"compare_lesser_array_program({HINTS_LENGTH})"))
        trace, pub = generate_prover_args(program, device=dev)
        stages = ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                           for k, v in trace._timings.items())
        say(f"[trace] {name}: {stages}", flush=True)
    else:
        air_class = FibonacciAIR
        pub = FibonacciPublicInputs(a0=1, a1=1)
        trace = fibonacci_trace([1, 1], 1 << args.log_rows, device=dev)
    what = f"{args.workload}, {trace.n_rows} rows x {trace.n_cols} main columns"
    wrappers = {"H1 mont_mul": cf.mont_mul, "H2 add_sub_mod": cf.add_sub_mod,
                "H3 ntt_dif_stages": cn.ntt_dif_stages,
                "H4 ntt_dif_local": cn.ntt_dif_local,
                "K1 keccak_rows": ck.keccak_rows,
                "K2 keccak_pairs": ck.keccak_pairs,
                "K3 keccak_grind": ck.keccak_grind,
                "H5 mont_batch_inverse": cs.mont_batch_inverse,
                "H6 mont_prefix_product": cs.mont_prefix_product}
    try:  # K4: absent in a checkout from before it (--root)
        from lambdaworks_cairo_prover_tpu_torch.prover import fri_tail as ft

        wrappers["K4 fri_tail"] = ft.fri_tail_cuda
    except ImportError:
        pass

    # the layout passes that the prove asks for (counted since the packed
    # H1/H2; None in a checkout from before)
    passes = {"fd.unpack": fd.unpack, "fd.pack": fd.pack}
    counts0 = {}

    def run(route):
        for w in wrappers.values():
            w.launches = 0
        counts0.update({k: getattr(f, "calls", None) for k, f in passes.items()})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proof = prove(trace, pub, options, air_class, device=dev,
                      transcript_factory=factories[route], mesh=mesh)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, proof

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    first = "per-layer" if args.fri_route == "per-layer" else "chain"
    cold, proof0 = run(first)  # build kernels and tables
    reference = serialize_proof(proof0)
    digest = hashlib.sha256(reference).hexdigest()
    split = ", ".join(f"{k} {v:.4f}" for k, v in proof0._timings.items())
    say(f"[cold] prove {cold:.4f} s ({split}); proof {len(reference)} "
          f"bytes, sha256 {digest}", flush=True)
    peaks, scaling = None, None
    if mesh is not None:
        peaks, scaling = _mesh_checks(torch, mesh, dev, digest, say)
    walls = []
    by_route: dict = {}
    turns = (("chain", "per-layer", "per-layer", "chain")
             if args.fri_route == "both" else (first,))
    for i in range(args.repeats):
        route = turns[i % len(turns)]
        wall, proof = run(route)
        if serialize_proof(proof) != reference:
            print(f"FAILED: the {route} proof differs from the first",
                  file=sys.stderr)
            return 1
        walls.append(wall)
        by_route.setdefault(route, []).append(
            (wall, proof._timings["round4_fri_commit"]))
        split = ", ".join(f"{k} {v:.4f}" for k, v in proof._timings.items())
        say(f"[warm] prove {i} ({route} FRI route): {wall:.4f} s ({split})",
              flush=True)
    for route, runs in by_route.items():
        say(f"[warm] {route} FRI route, {len(runs)} proves: median warm "
              f"prove {median([w for w, _ in runs]):.4f} s, median "
              f"round4_fri_commit {median([f for _, f in runs]):.4f} s "
              f"({', '.join(f'{f:.4f}' for _, f in runs)})", flush=True)
    layout_calls = {k: None if counts0[k] is None else f.calls - counts0[k]
                    for k, f in passes.items()}
    say(f"[warm] {what}: launches per prove "
          f"{ {k: w.launches for k, w in wrappers.items()} }, layout passes "
          f"{layout_calls}, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = run(first)
    # device-side rows (kernels, copies, memsets) have no CPU time; the aten
    # op that launched a kernel repeats its device time, so it is left out,
    # as are the "nccl:..." records, which repeat their NCCL kernel's
    by_name = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0
                      and e.self_cpu_time_total == 0
                      and not e.key.startswith("nccl:")),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in by_name)
    groups: dict = {}
    for name, ms, count in by_name:
        group = next((g for frag, g in GROUPS if frag in name), "other")
        ms0, n0 = groups.get(group, (0.0, 0))
        groups[group] = (ms0 + ms, n0 + count)
    mid = median(walls) if walls else wall
    say(f"[profile] {what}, {first} FRI route: device busy {busy_ms:.1f} ms; "
          f"idle share {1 - busy_ms / (wall * 1e3):.4f} of the profiled prove "
          f"({wall:.4f} s), {1 - busy_ms / (mid * 1e3):.4f} of the median "
          f"unprofiled warm prove ({mid:.4f} s)", flush=True)
    for group, (ms, count) in sorted(groups.items(), key=lambda r: -r[1][0]):
        say(f"[profile] {group}: {ms:.1f} ms device, {count} launches",
              flush=True)
    for name, ms, count in by_name[:25]:
        say(f"[profile] {ms:9.1f} ms {count:7d}x {name[:200]}", flush=True)

    if args.out and not rank:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
    say(json.dumps({"card": card, "root": os.path.abspath(args.root),
                      "workload": args.workload, "rows": trace.n_rows,
                      "main_columns": trace.n_cols,
                      "mesh": "domain" if mesh is not None else None,
                      "ranks": mesh.size() if mesh is not None else 1,
                      "proof_sha256": digest, "cold_prove_s": cold,
                      "peak_bytes_per_rank": peaks, "ntt_scaling": scaling,
                      "warm_prove_s": walls, "profiled_prove_s": wall,
                      "layout_passes": layout_calls,
                      "fri_route": args.fri_route,
                      "round4_fri_commit_s": {
                          r: [f for _, f in runs] for r, runs in by_route.items()},
                      "device_busy_ms": busy_ms,
                      "device_ms_by_group": {g: v[0] for g, v in groups.items()},
                      "kernel_launches_by_group": {
                          g: v[1] for g, v in groups.items()}}),
          flush=True)
    return 0


def _quiet(*args, **kwargs) -> None:
    pass


def _mesh_checks(torch, mesh, dev, digest: str, say):
    """Every rank's proof digest equal and its peak device memory after the
    cold prove; then the four-step NTT's scaling at 2^NTT_LOG points."""
    import torch.distributed as dist

    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.field.params import P
    from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
    from lambdaworks_cairo_prover_tpu_torch.parallel.four_step import ShardedNTT

    digests, peaks = [None] * mesh.size(), [None] * mesh.size()
    dist.all_gather_object(digests, digest)
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(dev))
    if any(d != digest for d in digests):
        raise SystemExit(f"FAILED: the ranks' proofs differ: {digests}")
    say(f"[mesh] {mesh.size()} ranks, proofs equal; peak device memory "
          f"per rank after the cold prove {peaks} bytes", flush=True)

    log_n = NTT_LOG
    n = 1 << log_n
    x = fd.from_ints([pow(3, i, P) for i in range(256)], device=dev)
    x = x.repeat(1, n // 256)  # bench.py's input

    def best(fn):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            times.append(time.perf_counter() - t0)
        return min(times)

    t1 = best(lambda: nttc.ntt(x))
    sntt = ShardedNTT(mesh, mesh.mesh_dim_names[0], dev)
    xs = sntt.shard(x)
    td = best(lambda: sntt.transform(xs, n, inverse=False))
    scaling = {"log_n": log_n, "ranks": mesh.size(), "t_single_s": t1,
               "t_sharded_s": td, "efficiency": t1 / (mesh.size() * td)}
    say(f"[mesh] four-step NTT at 2^{log_n} points: one card {t1:.6f} s, "
          f"{mesh.size()} cards {td:.6f} s, efficiency T1 / (D TD) "
          f"{scaling['efficiency']:.4f}", flush=True)
    return peaks, scaling


if __name__ == "__main__":
    sys.exit(main())
