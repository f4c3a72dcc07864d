#!/usr/bin/env python3
"""H6 (``mont_prefix_product``, csrc/scan.cu) against variants of itself, built
apart, on a CUDA GPU: what holds the kernel under its bound.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 tools/bench_torch_prefix_variants.py [--reps 20]

Each variant is csrc/scan.cu with a few lines replaced, compiled with the
port's nvcc flags into its own library under the package's ``_build/``
(gitignored); the shipped source is never changed.  The variants:

* ``shipped``: the source as it is;
* ``oracle``: the look-back replaced by a read of the true prefix of the
  tiles before, which the script writes into the status slots first: the
  kernel without the wait between tiles;
* ``no_products``: every product of the kernel replaced by an xor of the
  words (its output is wrong): the kernel without its products;
* ``bare``: both, the kernel's loads, stores and barriers alone.

The script prints the card (``nvidia-smi``), each variant's registers and
spills (``-Xptxas -v``), and one JSON line: CUDA-event times of every
variant at 2^21, 3 * 2^19, 3 * 2^21 and 2^23 elements beside the bound
(128 B an element at 3.35 TB/s), and of a PyTorch copy of the same bytes.
The shipped kernel must give its plain version's output at 2^21, and every
variant but ``no_products`` and ``bare`` the shipped kernel's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import ELEM_BYTES, bound, cuda_ms, ptxas_report  # noqa: E402

SEED = 20260518
NS = (1 << 21, 3 << 19, 3 << 21, 1 << 23)
LOOK_BACK = "        look_back(status, nb, t, pre);\n"
# the oracle: tile t - 1's inclusive prefix, written by the script
ORACLE = """        {
          const uint4* q = reinterpret_cast<const uint4*>(
              status + flag_words(nb) + kSlotWords * (t - 1) + 8);
          const uint4 lo = __ldcg(q), hi = __ldcg(q + 1);
          pre[0] = lo.x; pre[1] = lo.y; pre[2] = lo.z; pre[3] = lo.w;
          pre[4] = hi.x; pre[5] = hi.y; pre[6] = hi.z; pre[7] = hi.w;
        }
"""
VARIANTS = ("shipped", "oracle", "no_products", "bare")
ORACLE_LOOK_BACK = ("oracle", "bare")  # the look-back read from the slots
NO_PRODUCTS = ("no_products", "bare")  # xor for every product


def variant_source(src: str, name: str) -> str:
    if name in ORACLE_LOOK_BACK:
        assert src.count(LOOK_BACK) == 1
        src = src.replace(LOOK_BACK, ORACLE)
    if name in NO_PRODUCTS:
        src = src.replace("lcp::mont_mul(", "xor_words(").replace(
            "namespace {\n", """namespace {

__device__ __forceinline__ void xor_words(const uint32_t a[8],
                                          const uint32_t b[8], uint32_t r[8]) {
#pragma unroll
  for (int w = 0; w < 8; ++w) r[w] = a[w] ^ b[w];
}
""", 1)
    return src


def build(out_dir: str) -> dict:
    """Variant -> (its loaded lcp_prefix_product, ptxas report of its H6
    kernels); one nvcc a variant, all started together."""
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib

    with open(os.path.join(cuda_lib.CSRC_DIR, "scan.cu")) as f:
        shipped = f.read()
    procs = {}
    for name in VARIANTS:
        src = variant_source(shipped, name)
        cu = os.path.join(out_dir, f"scan_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"libscan_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", cuda_lib.CSRC_DIR,
             "-shared", "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{report}")
        fn = ctypes.CDLL(so).lcp_prefix_product
        fn.argtypes = cuda_lib._SIGNATURES["lcp_prefix_product"]
        fn.restype = ctypes.c_int
        libs[name] = (fn, {k: v for k, v in ptxas_report(report).items()
                           if "prefix_product_kernel" in k})
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    out_dir = os.path.join(cuda_lib.BUILD_DIR, "h6_variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(out_dir)
    for name, (_, regs) in libs.items():
        print(f"[build] {name}: {regs}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": card, "build": {k: v[1] for k, v in libs.items()},
           "ms": {}}
    for n in NS:
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        x = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, device=dev,
                          generator=gen)
        x[15] &= 0x7FF
        want = cs.mont_prefix_product(x)
        if n == NS[0] and not torch.equal(want, cs.prefix_product_plain(x)):
            print(f"FAILED: H6 differs from its plain version at n = {n}",
                  file=sys.stderr)
            return 1
        row = {**bound(2 * ELEM_BYTES * n, 0),
               "copy": cuda_ms(torch, lambda: torch.empty_like(x).copy_(x),
                               args.reps)}
        nb, words_n = cs.prefix_plan(n)
        for name, (fn, _) in libs.items():
            status = torch.zeros(max(words_n, 1), dtype=torch.int32,
                                 device=dev)
            if name in ORACLE_LOOK_BACK:  # each tile's inclusive prefix
                ends = want[:, cs.TILE - 1::cs.TILE].to(torch.int64)
                words = ends[0::2] | (ends[1::2] << 16)
                words = torch.where(words >= 1 << 31, words - (1 << 32), words)
                slots = status[words_n - cs.SLOT_WORDS * nb:]
                slots.view(nb, cs.SLOT_WORDS)[:words.shape[1], 8:] = \
                    words.t().to(torch.int32)
            got = torch.empty_like(x)

            def call():
                code = fn(x.data_ptr(), got.data_ptr(), n, nb,
                          status.data_ptr(), stream)
                assert code == 0, f"{name}: CUDA error {code}"

            call()
            torch.cuda.synchronize()
            if name not in NO_PRODUCTS and not torch.equal(got, want):
                print(f"FAILED: {name} differs from the shipped kernel at "
                      f"n = {n}", file=sys.stderr)
                return 1
            row[name] = cuda_ms(torch, call, args.reps)
        res["ms"][n] = row
        print(f"[variants] n = {n}: {row}", flush=True)
        del x, want
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
