#!/usr/bin/env python3
"""H1 and H2 (``mont_mul``, ``add_sub_mod``, csrc/field_ops.cu) against
variants of themselves, built apart, on a CUDA GPU: what holds the kernels
under their byte bound.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 tools/bench_torch_field_variants.py [--reps 50]

Each variant is csrc/field_ops.cu with a few lines replaced, compiled with
the port's nvcc flags into its own library under the package's ``_build/``
(gitignored); the shipped source is never changed.  The variants:

* ``shipped``: the source as it is (blocks of 256 threads, a thread a group
  of 4 elements, as many blocks as groups need);
* ``threads128``: blocks of 128 threads;
* ``min3``: at most 85 registers a thread (``__launch_bounds__(256, 3)``),
  three blocks an SM;
* ``one_wave``: 264 blocks (two an SM), each thread looping over groups;
* ``no_ops``: the product and the sums replaced by an xor of the words (its
  output is wrong): the kernels' loads and stores alone.

The script prints the card (``nvidia-smi``), each variant's registers and
spills (``-Xptxas -v``), and one JSON line: CUDA-event times of every variant
at three shapes beside the byte bound (each operand read once,
the result written once, at 3.35 TB/s), and of ``torch.add`` on int32
tensors of the same bytes (a PyTorch elementwise kernel's reach on that
traffic).  Every variant but ``no_ops`` must give the shipped kernels'
output, and the shipped kernels their plain versions' on the first column.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import bound, cuda_ms, ptxas_report  # noqa: E402

SEED = 20260519
LOG_N = 21
VARIANTS = {
    "shipped": [],
    "threads128": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 128;")],
    "min3": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")],
    "one_wave": [("const long long cap = 1LL << 20;",
                  "const long long cap = 264;")],
    "no_ops": [("lcp::mont_mul(a, b, r);", "xor_words(a, b, r);"),
               ("lcp::add_mod(a, b, r);", "xor_words(a, b, r);"),
               ("lcp::sub_mod(a, b, r);", "xor_words(a, b, r);"),
               ("namespace {\n", """namespace {

__device__ __forceinline__ void xor_words(const uint32_t a[8],
                                          const uint32_t b[8], uint32_t r[8]) {
#pragma unroll
  for (int w = 0; w < 8; ++w) r[w] = a[w] ^ b[w];
}
""")],
}


def variant_source(src: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        assert old in src, (name, old)
        src = src.replace(old, new)
    return src


def build(out_dir: str) -> dict:
    """Variant -> (its lcp_mont_mul, its lcp_add_sub, ptxas report of its
    kernels); one nvcc a variant, all started together."""
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib

    with open(os.path.join(cuda_lib.CSRC_DIR, "field_ops.cu")) as f:
        shipped = f.read()
    procs = {}
    for name in VARIANTS:
        cu = os.path.join(out_dir, f"field_ops_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(shipped, name))
        so = os.path.join(out_dir, f"libfield_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", cuda_lib.CSRC_DIR,
             "-shared", "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{report}")
        lib = ctypes.CDLL(so)
        fns = []
        for fn_name in ("lcp_mont_mul", "lcp_add_sub"):
            fn = getattr(lib, fn_name)
            fn.argtypes = cuda_lib._SIGNATURES[fn_name]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[name] = (*fns, {k.split("field_ops_cu_")[-1]: v
                             for k, v in ptxas_report(report).items()})
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    out_dir = os.path.join(cuda_lib.BUILD_DIR, "field_variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(out_dir)
    for name, (*_, regs) in libs.items():
        print(f"[build] {name}: {regs}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randint(0, 1 << 16, (16, 16, 1 << LOG_N), dtype=torch.int32,
                      device=dev, generator=gen)
    x[15] &= 0x7FF
    px = cf.pack_words(x)
    consts = x[:, :15, 7:8].contiguous()
    shapes = {  # name: (a, b, packed result)
        "(8, 2^21) x (8, 2^21) -> (8, 2^21)": (px[:, 0], px[:, 1], True),
        "(8, 15, 2^21) x (16, 15, 1) -> (8, 15, 2^21)":
            (px[:, :15], consts, True),
        "(16, 2^21) x (16, 2^21) -> (16, 2^21)":
            (x[:, 0].contiguous(), x[:, 1].contiguous(), False),
    }
    want = {}
    res = {"card": card, "build": {k: v[2] for k, v in libs.items()},
           "ms": {}}
    for tag, (a, b, packed) in shapes.items():
        shape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
        n = math.prod(shape)
        rows = 8 if packed else 16
        plans = [cf.operand_plan(t, shape) for t in (a, b)]
        args_ab = []
        for t, ls, div, mod, run, rs in plans:
            args_ab += [t.data_ptr(), ls, div, mod, run, rs, int(cf.is_packed(t))]
        n_bytes = sum(t.numel() * 4 for t, *_ in plans) + rows * n * 4
        m = n_bytes // 12  # int32 elements of an add that moves as many bytes
        flat = x.reshape(-1)
        row = {**bound(n_bytes, 0),
               "torch.add": cuda_ms(torch, lambda: torch.add(
                   flat[:m], flat[m:2 * m]), args.reps)}
        for name, (mul, add_sub, _) in libs.items():
            for op, fn, lead in (("mont_mul", mul, ()), ("sub", add_sub, (1,))):
                out = torch.empty((rows,) + shape, dtype=torch.int32, device=dev)

                def call():
                    code = fn(*lead, *args_ab, out.data_ptr(), int(packed), n,
                              stream)
                    assert code == 0, f"{name}: CUDA error {code}"

                call()
                torch.cuda.synchronize()
                if name == "shipped":
                    want[tag, op] = out.clone()
                    plain = cf.mul_plain if op == "mont_mul" else cf.sub_plain
                    c0 = [t if t.dim() == 2 or t.shape[1] == 1 else t[:, :1]
                          for t in (a, b)]
                    got0 = out if out.dim() == 2 else out[:, :1]
                    if not torch.equal(got0, plain(*c0, packed=packed)):
                        print(f"FAILED: {op} differs from its plain version at "
                              f"{tag}", file=sys.stderr)
                        return 1
                elif name != "no_ops" and not torch.equal(out, want[tag, op]):
                    print(f"FAILED: {name} {op} differs from the shipped kernel "
                          f"at {tag}", file=sys.stderr)
                    return 1
                row[f"{name} {op}"] = cuda_ms(torch, call, args.reps)
        res["ms"][tag] = row
        print(f"[variants] {tag}: {row}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
