#!/usr/bin/env python3
"""H5 (the batch inverse), H6 (the prefix product) and the Merkle tree over
K2 of one checkout, alone, on a CUDA GPU.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 tools/bench_torch_scan_tree.py [--root DIR] [--reps 10]

Imports the port's package from ``--root`` (this checkout by default;
another, such as the parent commit unpacked with ``git archive``, to compare
two versions in one call: run them in turns, parent, change, change,
parent), builds its kernels and prints the card (``nvidia-smi``) and one
JSON line: CUDA-event times of H5 at 1, 2^16, 2^21, 3 * 2^19, 3 * 2^21 and
3 * 2^23 elements and of H6 at 1, 2^16, 2^21, 3 * 2^19, 3 * 2^21 and 2^23,
with zeros planted, and of ``hash.merkle.tree_levels`` over 2^16 and 2^21
leaves, each beside the sha256 of its output, which must agree between
checkouts.  The inputs
are made on the card from a seed, so that every checkout sees the same.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import cuda_ms  # noqa: E402

SEED = 20260516
INVERSE_NS = (1, 1 << 16, 1 << 21, 3 << 19, 3 << 21, 3 << 23)
PREFIX_NS = (1, 1 << 16, 1 << 21, 3 << 19, 3 << 21, 1 << 23)
TREE_LOGS = (16, 21)
# zeros at the first runs' and tiles' edges of both H5 designs and mid-way;
# for H6 as far from the end (a zero makes every product after it zero)
ZEROS = (0, 3, 4, 255, 256, 511, 512, 1023, 1024)


def elements(torch, n: int, dev, zeros: str):
    """(16, n) canonical Montgomery limbs from SEED (below 2^251 < p), with
    zeros for ``zeros`` "inverse" or "prefix"."""
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    x = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, device=dev,
                      generator=gen)
    x[15] &= 0x7FF
    at = {"inverse": (*ZEROS, n // 2),
          "prefix": tuple(n - 2 - e for e in ZEROS)}.get(zeros, ())
    for e in at:
        if 0 <= e < n - 1:
            x[:, e] = 0
    return x


def sha(torch, t) -> str:
    torch.cuda.synchronize()
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="also time K2 over a whole tree and over one level "
                    "at 2^1 .. 2^21 digests (a checkout with "
                    "cuda_keccak.keccak_tree), and H5's and H6's kernels "
                    "one by one (torch.profiler): H5 at 3 * 2^21 and "
                    "3 * 2^23, H6 and its memset at 2^21, 3 * 2^21 and 2^23")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
    from lambdaworks_cairo_prover_tpu_torch.hash.merkle import tree_levels

    import lambdaworks_cairo_prover_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"FAILED: imported {pkg.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda", 0)
    cuda_lib.library()
    out = {"root": root, "card": card, "mont_batch_inverse": {},
           "mont_prefix_product": {}, "tree_levels": {}}
    for name, fn, ns in (("mont_batch_inverse", cs.mont_batch_inverse,
                          INVERSE_NS),
                         ("mont_prefix_product", cs.mont_prefix_product,
                          PREFIX_NS)):
        for n in ns:
            x = elements(torch, n, dev, "inverse" if name ==
                         "mont_batch_inverse" else "prefix")
            reps = args.reps if n > 1 << 16 else 5 * args.reps
            out[name][n] = {"ms": cuda_ms(torch, lambda: fn(x), reps),
                            "sha256": sha(torch, fn(x))}
            print(f"[{name}] n = {n}: {out[name][n]}", flush=True)
            del x
    for log_n in TREE_LOGS:
        gen = torch.Generator(device=dev).manual_seed(SEED + log_n)
        leaves = torch.randint(-2**31, 2**31 - 1, (1 << log_n, 8),
                               dtype=torch.int32, device=dev,
                               generator=gen).view(torch.int64)
        levels = tree_levels(leaves)
        out["tree_levels"][1 << log_n] = {
            "ms": cuda_ms(torch, lambda: tree_levels(leaves), args.reps),
            "sha256": sha(torch, torch.cat(levels[1:]))}
        print(f"[tree_levels] {1 << log_n} leaves: "
              f"{out['tree_levels'][1 << log_n]}", flush=True)
    if args.sweep:
        out["sweep"] = sweep(torch, dev, cs, args.reps)
    print(json.dumps(out), flush=True)
    return 0


def device_ms(torch, fn, reps: int) -> dict:
    """Kernel name -> device milliseconds a call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.self_device_time_total > 0}


def sweep(torch, dev, cs, reps: int) -> dict:
    """K2 over a whole tree and over one level at 2^1 .. 2^21 digests (CUDA
    events), both kernels' device time at 2^16 and 2^21 leaves, and H5's and
    H6's kernels' device times (torch.profiler)."""
    from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck

    gen = torch.Generator(device=dev).manual_seed(SEED)
    leaves = torch.randint(-2**31, 2**31 - 1, (1 << 21, 8), dtype=torch.int32,
                           device=dev, generator=gen).view(torch.int64)
    res = {"tree": {}, "one": {}, "tree_device": {}, "h5_kernels": {},
           "h6_kernels": {}}
    for k in range(1, 22):
        x = leaves[:1 << k]
        res["tree"][k] = cuda_ms(torch, lambda: ck.keccak_tree(x), reps)
        res["one"][k] = cuda_ms(torch, lambda: ck.keccak_pairs(x), reps)
    for k in (16, 21):
        x = leaves[:1 << k]
        res["tree_device"][k] = device_ms(torch, lambda: ck.keccak_tree(x),
                                          reps)
    print(f"[sweep] K2: {res}", flush=True)
    for n in (3 << 21, 3 << 23):
        x = elements(torch, n, dev, "inverse")
        res["h5_kernels"][n] = device_ms(
            torch, lambda: cs.mont_batch_inverse(x), reps)
        print(f"[sweep] H5 at {n}: {res['h5_kernels'][n]}", flush=True)
        del x
    for n in (1 << 21, 3 << 21, 1 << 23):
        x = elements(torch, n, dev, "prefix")
        res["h6_kernels"][n] = device_ms(
            torch, lambda: cs.mont_prefix_product(x), reps)
        print(f"[sweep] H6 at {n}: {res['h6_kernels'][n]}", flush=True)
        del x
    return res


if __name__ == "__main__":
    sys.exit(main())
