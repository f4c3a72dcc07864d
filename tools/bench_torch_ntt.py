#!/usr/bin/env python3
"""The NTT kernels of the PyTorch/CUDA port, alone, on a CUDA GPU.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 tools/bench_torch_ntt.py [--widths 1,34] [--pipes]

Prints the card (``nvidia-smi``), what ``nvcc -Xptxas=-v`` says of every
kernel (registers, spills), the SASS instruction counts of the built kernels
and of one DIF butterfly (a probe kernel compiled here from csrc/field.cuh and
read with ``cuobjdump -sass``), and CUDA-event times of
  - every pass of ``ntt_passes`` at 2^19, 2^21 and 2^22 points,
  - H4 at 10 stages in place, and at 7 in place and with the natural-order
    output,
  - H3 with one stage (the earlier schedule's pass),
  - the whole transform,
at one column and at the Cairo prove's 34 columns (2^22: one column), each
beside the least time the card could take: the yardstick of chip_smoke.py
(its ``bound`` and ``butterfly_ops``), which this tool imports.  Every pass is
first held against its plain version on one column (exact).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (ELEM_BYTES, TWIDDLE_BYTES, bound, bound_text,  # noqa: E402
                        butterfly_ops, cuda_ms, sass_counts)

PROBE = r"""
#include <stdint.h>
#include "field.cuh"
// one DIF butterfly on operands that arrive and leave as 16-byte words
extern "C" __global__ void probe_butterfly(const uint4* in, uint4* out) {
  uint32_t u[8], v[8], w[8], s[8], d[8];
  const uint4* p = in + 6 * threadIdx.x;
  uint4 q;
  q = p[0]; u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
  q = p[1]; u[4] = q.x; u[5] = q.y; u[6] = q.z; u[7] = q.w;
  q = p[2]; v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  q = p[3]; v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  q = p[4]; w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  q = p[5]; w[4] = q.x; w[5] = q.y; w[6] = q.z; w[7] = q.w;
  lcp::add_mod(u, v, s);
  lcp::sub_mod(u, v, d);
  lcp::mont_mul(d, w, v);
  uint4* o = out + 4 * threadIdx.x;
  o[0] = make_uint4(s[0], s[1], s[2], s[3]);
  o[1] = make_uint4(s[4], s[5], s[6], s[7]);
  o[2] = make_uint4(v[0], v[1], v[2], v[3]);
  o[3] = make_uint4(v[4], v[5], v[6], v[7]);
}
extern "C" __global__ void probe_mont_mul(const uint4* in, uint4* out) {
  uint32_t v[8], w[8], r[8];
  const uint4* p = in + 4 * threadIdx.x;
  uint4 q;
  q = p[0]; v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  q = p[1]; v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  q = p[2]; w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  q = p[3]; w[4] = q.x; w[5] = q.y; w[6] = q.z; w[7] = q.w;
  lcp::mont_mul(v, w, r);
  uint4* o = out + 2 * threadIdx.x;
  o[0] = make_uint4(r[0], r[1], r[2], r[3]);
  o[1] = make_uint4(r[4], r[5], r[6], r[7]);
}
"""


# Throughput of the instructions the butterfly is made of: each kernel runs
# 8 independent chains a thread, 64 warps an SM.
PIPES = r"""
#include <stdint.h>
#include <cuda_runtime.h>
#define BODY(NAME, DECL, STEP, FOLD)                                        \
  __global__ void NAME(uint32_t* out, int iters, uint32_t a, uint32_t b) {  \
    DECL;                                                                   \
    a += threadIdx.x; b += blockIdx.x;                                      \
    for (int it = 0; it < iters; ++it) {                                    \
      _Pragma("unroll") for (int i = 0; i < 8; ++i) { STEP; }               \
    }                                                                       \
    uint32_t r = 0;                                                         \
    _Pragma("unroll") for (int i = 0; i < 8; ++i) r ^= FOLD;                \
    out[blockIdx.x * blockDim.x + threadIdx.x] = r;                         \
  }
BODY(k_add, uint32_t x[8] = {0}, asm volatile("add.u32 %0, %0, %1;" : "+r"(x[i]) : "r"(a)), x[i])
BODY(k_mad_lo, uint32_t x[8] = {0}, asm volatile("mad.lo.u32 %0, %1, %2, %0;" : "+r"(x[i]) : "r"(a), "r"(b)), x[i])
BODY(k_mad_hi, uint32_t x[8] = {0}, asm volatile("mad.hi.u32 %0, %1, %2, %0;" : "+r"(x[i]) : "r"(a), "r"(b)), x[i])
BODY(k_mad_wide, uint64_t x[8] = {0}, asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(x[i]) : "r"(a), "r"(b)), (uint32_t)(x[i] ^ (x[i] >> 32)))
BODY(k_mad_lo_hi_carry, uint32_t x[8] = {0}; uint32_t y[8] = {0},
     asm volatile("mad.lo.cc.u32 %0, %2, %3, %0; madc.hi.cc.u32 %1, %2, %3, %1;" : "+r"(x[i]), "+r"(y[i]) : "r"(a), "r"(b)),
     (x[i] ^ y[i]))
extern "C" int run(int which, void* out, int blocks, int iters, void* stream) {
  void (*k[])(uint32_t*, int, uint32_t, uint32_t) = {k_add, k_mad_lo, k_mad_hi, k_mad_wide, k_mad_lo_hi_carry};
  k[which]<<<blocks, 256, 0, (cudaStream_t)stream>>>((uint32_t*)out, iters, 12345u, 6789u);
  return (int)cudaGetLastError();
}
"""
PIPE_NAMES = ("add.u32", "mad.lo.u32", "mad.hi.u32", "mad.wide.u32",
              "mad.lo.cc + madc.hi.cc pair")


def pipes(torch, lib, tmp: str) -> None:
    """Thread-instructions a second of each instruction, all SMs busy."""
    import ctypes

    src, so = os.path.join(tmp, "pipes.cu"), os.path.join(tmp, "pipes.so")
    with open(src, "w") as f:
        f.write(PIPES)
    subprocess.run([lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, src], check=True)
    run = ctypes.CDLL(so).run
    run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for which, name in enumerate(PIPE_NAMES):
        def fn():
            if run(which, out.data_ptr(), blocks, iters, stream):
                raise RuntimeError(f"pipe probe {name} did not launch")
        ms = cuda_ms(torch, fn, 5)
        rate = blocks * 256 * iters * 8 / (ms * 1e-3)
        log(f"[pipes] {name}: {rate / 1e12:.3f}e12 a second over {sms} SMs "
            f"({rate / sms / 1e9:.1f}e9 an SM)")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_lib():
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib as lib
    return lib


def field_times(torch, cf, card: str, root: str) -> None:
    """H1 and H2 at (16, 2^21) x (16, 2^21) and at (16, 15, 2^21) x (16, 15, 1);
    where the checkout's kernels take packed words, also at (8, 2^21) x
    (8, 2^21) -> (8, 2^21) and (8, 15, 2^21) x (16, 15, 1) -> (8, 15, 2^21)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    x = torch.randint(0, 1 << 16, (16, 15, 1 << 21), dtype=torch.int32,
                      device="cuda", generator=gen)
    x[15] &= 0x7FF
    a, b = x[:, 0].contiguous(), x[:, 1].contiguous()
    consts = x[:, :, 7:8].contiguous()
    cases = [
        ("H1 mont_mul, one column", lambda: cf.mont_mul(a, b)),
        ("H2 add_sub_mod, one column", lambda: cf.add_sub_mod(a, b, "sub")),
        ("H1 mont_mul, 15-column stack", lambda: cf.mont_mul(x, consts)),
        ("H2 add_sub_mod, 15-column stack",
         lambda: cf.add_sub_mod(x, consts, "sub"))]
    if hasattr(cf, "pack_words"):
        pa, pb, px = cf.pack_words(a), cf.pack_words(b), cf.pack_words(x)
        cases += [
            ("H1 mont_mul, one column, packed", lambda: cf.mont_mul(pa, pb)),
            ("H2 add_sub_mod, one column, packed",
             lambda: cf.add_sub_mod(pa, pb, "sub")),
            ("H1 mont_mul, 15-column stack, packed",
             lambda: cf.mont_mul(px, consts)),
            ("H2 add_sub_mod, 15-column stack, packed",
             lambda: cf.add_sub_mod(px, consts, "sub"))]
    for what, fn in cases:
        log(f"[field] {what}: {cuda_ms(torch, fn, 20):.4f} ms ({root}; {card})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="1,34",
                    help="column counts at 2^21 and 2^19 points (default 1,34)")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose package is measured (default: this one)")
    ap.add_argument("--field-only", action="store_true",
                    help="only H1 and H2, at one column and at the Cairo "
                         "prove's 15-column stack (runs on an earlier checkout "
                         "too: compare two commits within one call)")
    ap.add_argument("--pipes", action="store_true",
                    help="also measure the throughput of add, mad.lo, mad.hi, "
                         "mad.wide and a carried lo/hi pair")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    lib = cuda_lib()
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[card] {card}")
    lib.library()
    if args.field_only:
        field_times(torch, cf, card, os.path.abspath(args.root))
        return 0
    info = lib.build_info()
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    for name, (count, ops) in sass_counts(info["path"]).items():
        log(f"[sass] {name}: {count} instructions; {dict(ops.most_common(8))}")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        subprocess.run([lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-cubin", "-I", lib.CSRC_DIR,
                        "-o", cubin, src], check=True)
        if args.pipes:
            pipes(torch, lib, tmp)
        for name, (count, ops) in sass_counts(cubin).items():
            log(f"[sass] {name}: {count} instructions (10 of them 16-byte loads "
                f"and stores for the butterfly, 6 for the product, plus address "
                f"setup and EXIT); {dict(ops.most_common(10))}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def columns(cols, log_n):
        x = torch.randint(0, 1 << 16, (16, cols, 1 << log_n), dtype=torch.int32,
                          device=dev, generator=gen)
        x[15] &= 0x7FF
        return x

    def record(what, cols, log_n, ms, hi, stages, twiddles):
        points = cols << log_n
        rec = {"ms": ms, **bound(2 * ELEM_BYTES * points + TWIDDLE_BYTES * twiddles,
                                 butterfly_ops(points, hi, stages))}
        log(f"[time] {what} at (16, {cols}, 2^{log_n}): {ms:.4f} ms; "
            f"{bound_text(rec)}")

    widths = tuple(int(w) for w in args.widths.split(","))
    for log_n, widths in ((21, widths), (19, widths), (22, (1,))):
        n = 1 << log_n
        tw = cn.twiddle_table(log_n, False, dev)
        twp = cn.packed_twiddle_table(log_n, False, dev)
        for cols in widths:
            x = columns(cols, log_n)
            y = torch.empty_like(x)
            one = x[:, :1].contiguous()
            cases = []  # (what, first stage, stages, twiddles read, kernel, plain)
            for p in cn.ntt_passes(log_n):
                if p.local:
                    continue
                cases.append((f"H3 stages {p.log_m_hi}..{p.log_m_hi - p.n_stages + 1}",
                              p.log_m_hi, p.n_stages,
                              (1 << (p.log_m_hi + 1)) - (1 << (p.log_m_hi - p.n_stages + 1)),
                              lambda s, d, p=p: cn.ntt_dif_stages(s, d, twp, p.log_m_hi, p.n_stages),
                              lambda c, p=p: cn.dif_stages_plain(c, tw, p.log_m_hi, p.n_stages)))
            cases.append((f"H3 stage {log_n - 6} alone", log_n - 6, 1, 1 << (log_n - 6),
                          lambda s, d: cn.ntt_dif_stages(s, d, twp, log_n - 6, 1),
                          lambda c: cn.dif_stages_plain(c, tw, log_n - 6, 1)))
            for chunk, natural in ((cn.LOCAL_LOG, False), (cn.LAST_LOG, False),
                                   (cn.LAST_LOG, True)):
                cases.append((f"H4 {chunk} stages{', natural order' if natural else ''}",
                              chunk - 1, chunk, 1 << chunk,
                              lambda s, d, chunk=chunk, natural=natural:
                              cn.ntt_dif_local(s, d, twp, chunk, natural),
                              lambda c, chunk=chunk, natural=natural:
                              cn.dif_local_plain(c, tw, chunk, natural)))
            for what, hi, stages, twiddles, kernel, plain in cases:
                got = kernel(one, torch.empty_like(one))
                if not torch.equal(got, plain(one)):
                    print(f"FAILED: {what} at 2^{log_n} disagrees with its plain "
                          f"version", file=sys.stderr)
                    return 1
                record(what, cols, log_n, cuda_ms(torch, lambda: kernel(x, y), 10),
                       hi, stages, twiddles)
            v = x if cols > 1 else x.reshape(16, n)
            record("whole transform", cols, log_n,
                   cuda_ms(torch, lambda: nttc.ntt(v), 10), log_n - 1, log_n, n)
            del x, y
    field_times(torch, cf, card, os.path.abspath(args.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
