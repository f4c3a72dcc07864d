#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card: name and power limit (nvidia-smi), CUDA version;
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, exactly
     (H1 mont_mul, H2 add_sub_mod, H3 ntt_dif_stage, H4 ntt_dif_local, and
     the whole NTT at 2^4 .. 2^21, forward and inverse, with a batch of 3);
  4. simple_fibonacci proofs against the JAX package's fixtures: 2^10 rows
     with test options (equal bytes) and, where the fixture has a digest,
     its size with the bench options (equal sha256);
  5. the real-size run: simple_fibonacci at 2^19 rows, blowup 4, 80 FRI
     queries, coset offset 3, grinding 20 — prove cold and warm, verify,
     and check that every kernel was launched on the way.

The line before the last is a JSON object with each kernel's launch count
in phase 5, its largest disagreement with the plain version, and its time
against the plain version's at the main path's shapes; the last line is
``{"ok": true, "device": {...}}``.  This script imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
PKG = "lambdaworks_cairo_prover_tpu_torch"
SEED = 20260516
FULL_LOG = 19          # the real-size run
LDE_LOG = FULL_LOG + 2  # its LDE: the main path's largest kernel shapes
MULADD_LOG = 20         # H1 / H2 comparison size
NTT_LOGS = (4, 10, 12, 17, 21)
BENCH = dict(blowup_factor=4, fri_number_of_queries=80, coset_offset=3,
             grinding_factor=20)


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> int:
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_limbs(torch, rng, shape, device):
    """Canonical random elements (< 2^251 < p) plus 0, 1 and p-1 at the end
    of the last axis."""
    import numpy as np
    from lambdaworks_cairo_prover_tpu_torch.field.params import P, N_LIMBS

    limbs = rng.integers(0, 1 << 16, size=(N_LIMBS,) + tuple(shape),
                         dtype=np.int64)
    limbs[N_LIMBS - 1] &= 0x7FF
    edges = np.zeros((N_LIMBS,) + tuple(shape[:-1]) + (3,), dtype=np.int64)
    edges[0, ..., 1] = 1
    for k in range(N_LIMBS):
        edges[k, ..., 2] = ((P - 1) >> (16 * k)) & 0xFFFF
    arr = np.concatenate([limbs, edges], axis=-1).astype(np.int32)
    return torch.from_numpy(arr).to(device)


def phase_card(torch) -> None:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)  # name and power limit, as nvidia-smi prints them
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")


def phase_build() -> None:
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    info = cuda_lib.build_info()
    log(f"[build] {'compiled' if info['compiled'] else 'reused'} "
        f"{os.path.relpath(info['path'], ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(torch, dev) -> dict:
    """Kernels against plain versions; returns per-kernel error and times."""
    import numpy as np
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.field.params import P
    from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

    rng = np.random.default_rng(SEED)
    out = {}

    # H1 / H2 on 2^20 elements + edges, plain shapes and broadcasts
    a = random_limbs(torch, rng, (1 << MULADD_LOG,), dev)
    b = random_limbs(torch, rng, (1 << MULADD_LOG,), dev)
    s = a[:, 5:6].contiguous()
    a2 = a[:, :1 << MULADD_LOG].reshape(16, 4, 1 << (MULADD_LOG - 2))
    col = b[:, :4].reshape(16, 4, 1).contiguous()
    errs = {"mont_mul": 0, "add_sub_mod": 0}
    cases = [(a, b), (a, s), (s, b), (a2, col), (col, a2), (a2, a2[:, 1:2])]
    for x, y in cases:
        errs["mont_mul"] = max(errs["mont_mul"], max_abs_err(
            torch, cf.mont_mul(x, y), cf.mul_plain(x, y)))
        errs["add_sub_mod"] = max(
            errs["add_sub_mod"],
            max_abs_err(torch, cf.add_sub_mod(x, y, "add"), cf.add_plain(x, y)),
            max_abs_err(torch, cf.add_sub_mod(x, y, "sub"), cf.sub_plain(x, y)))
    # spot-check against python ints as well
    xs, ys = fd.to_ints(a[:, -8:]), fd.to_ints(b[:, -8:])
    require(fd.to_ints(cf.mont_mul(a[:, -8:], b[:, -8:])) ==
            [x * y % P for x, y in zip(xs, ys)], "mont_mul != python ints")
    for name, e in errs.items():
        log(f"[kernels] {name} vs plain at 2^{MULADD_LOG}+3 (and broadcasts): "
            f"max_abs_err {e}")
        require(e == 0, f"{name} disagrees with its plain version")

    # main-path shape: one (16, 2^21) LDE-sized operand pair
    lde = 1 << LDE_LOG
    big_a = random_limbs(torch, rng, (lde,), dev)[:, :lde].contiguous()
    big_b = random_limbs(torch, rng, (lde,), dev)[:, :lde].contiguous()
    out["mont_mul"] = {
        "max_abs_err": errs["mont_mul"],
        "ms": cuda_ms(torch, lambda: cf.mont_mul(big_a, big_b), 20),
        "plain_ms": cuda_ms(torch, lambda: cf.mul_plain(big_a, big_b), 3),
    }
    out["add_sub_mod"] = {
        "max_abs_err": errs["add_sub_mod"],
        "ms": cuda_ms(torch, lambda: cf.add_sub_mod(big_a, big_b, "sub"), 20),
        "plain_ms": cuda_ms(torch, lambda: cf.sub_plain(big_a, big_b), 3),
    }

    # H3 / H4 alone at the 2^21 LDE shape
    x = big_a.reshape(16, 1, lde)
    tw = cn.twiddle_table(LDE_LOG, False, dev)
    e3 = 0
    for log_m in (LDE_LOG - 1, LDE_LOG - 6, cn.LOCAL_LOG):
        e3 = max(e3, max_abs_err(torch, cn.ntt_dif_stage(x.clone(), tw, log_m),
                                 cn.dif_stage_plain(x, tw, log_m)))
    e4 = max_abs_err(torch, cn.ntt_dif_local(x.clone(), tw, cn.LOCAL_LOG),
                     cn.dif_local_plain(x, tw, cn.LOCAL_LOG))
    log(f"[kernels] ntt_dif_stage vs plain at 2^{LDE_LOG} (m = 2^{LDE_LOG - 1}, "
        f"2^{LDE_LOG - 6}, 2^{cn.LOCAL_LOG}): max_abs_err {e3}")
    log(f"[kernels] ntt_dif_local vs plain at 2^{LDE_LOG}: max_abs_err {e4}")
    require(e3 == 0 and e4 == 0, "an NTT kernel disagrees with its plain version")
    work = x.clone()
    out["ntt_dif_stage"] = {
        "max_abs_err": e3,
        "ms": cuda_ms(torch, lambda: cn.ntt_dif_stage(work, tw, LDE_LOG - 6), 20),
        "plain_ms": cuda_ms(torch, lambda: cn.dif_stage_plain(x, tw, LDE_LOG - 6), 3),
    }
    out["ntt_dif_local"] = {
        "max_abs_err": e4,
        "ms": cuda_ms(torch, lambda: cn.ntt_dif_local(work, tw, cn.LOCAL_LOG), 20),
        "plain_ms": cuda_ms(torch, lambda: cn.dif_local_plain(x, tw, cn.LOCAL_LOG), 2),
    }

    # whole NTT (H3 + H4 + bit-reverse) against the plain DIT NTT
    for log_n in NTT_LOGS:
        for batch in ((), (3,)):
            v = random_limbs(torch, rng, batch + ((1 << log_n) - 3,), dev)
            fwd = max_abs_err(torch, nttc.ntt(v), cn.ntt_plain(v, False))
            inv_plain = cf.mul_plain(
                cn.ntt_plain(v, True),
                fd.from_int(pow(1 << log_n, P - 2, P), device=dev).reshape(
                    (16,) + (1,) * (v.dim() - 1)))
            inv = max_abs_err(torch, nttc.intt(v), inv_plain)
            log(f"[kernels] NTT 2^{log_n} batch {batch or (1,)}: forward "
                f"max_abs_err {fwd}, inverse max_abs_err {inv}")
            require(fwd == 0 and inv == 0, f"NTT mismatch at 2^{log_n}")
    v = big_a.reshape(16, lde)
    log(f"[kernels] NTT 2^{LDE_LOG}: {cuda_ms(torch, lambda: nttc.ntt(v), 5):.3f} ms "
        f"(H3+H4), {cuda_ms(torch, lambda: cn.ntt_plain(v, False), 1):.3f} ms "
        f"(plain)")
    for name, rec in out.items():
        log(f"[kernels] {name}: {rec['ms']:.4f} ms kernel, "
            f"{rec['plain_ms']:.4f} ms plain")
    return out


def _fib(log_n: int, bench: bool, dev, verify_it: bool = True):
    from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
        FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove
    from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

    options = (ProofOptions(**BENCH) if bench
               else ProofOptions.default_test_options())
    pub = FibonacciPublicInputs(a0=1, a1=1)
    t0 = time.perf_counter()
    trace = fibonacci_trace([1, 1], 1 << log_n)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = prove(trace, pub, options, FibonacciAIR, device=dev)
    t_prove = time.perf_counter() - t0
    data = serialize_proof(proof)
    ok = None
    t_verify = None
    if verify_it:
        t0 = time.perf_counter()
        ok = verify(proof, pub, options, FibonacciAIR)
        t_verify = time.perf_counter() - t0
        require(ok, f"the port's verifier rejected its 2^{log_n} proof")
        require(not verify(proof, FibonacciPublicInputs(a0=2, a1=1), options,
                           FibonacciAIR), "wrong public inputs were accepted")
    return {"bytes": data, "trace_s": t_trace, "prove_s": t_prove,
            "verify_s": t_verify, "timings": proof._timings}


def phase_fixtures(dev) -> None:
    with open(os.path.join(FIXTURES, "simple_fibonacci_1024_test_options.proof"),
              "rb") as f:
        ref = f.read()
    res = _fib(10, bench=False, dev=dev)
    log(f"[fixture] 2^10 rows, test options: {len(res['bytes'])} bytes, "
        f"equal to the JAX proof: {res['bytes'] == ref}")
    require(res["bytes"] == ref, "2^10 proof bytes differ from the JAX fixture")
    with open(os.path.join(FIXTURES, "simple_fibonacci_bench_digest.json")) as f:
        digest = json.load(f)
    log_n = digest["trace_length"].bit_length() - 1
    require(digest["options"] == BENCH, "digest fixture has other options")
    res = _fib(log_n, bench=True, dev=dev)
    got = hashlib.sha256(res["bytes"]).hexdigest()
    log(f"[fixture] 2^{log_n} rows, bench options: {len(res['bytes'])} bytes, "
        f"prove {res['prove_s']:.3f} s, sha256 {got}, equal to the JAX "
        f"digest: {got == digest['sha256']}")
    require(got == digest["sha256"], f"2^{log_n} proof differs from the JAX digest")


def phase_full(torch, dev) -> dict:
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

    wrappers = {"mont_mul": cf.mont_mul, "add_sub_mod": cf.add_sub_mod,
                "ntt_dif_stage": cn.ntt_dif_stage, "ntt_dif_local": cn.ntt_dif_local}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    cold = _fib(FULL_LOG, bench=True, dev=dev)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    warm = _fib(FULL_LOG, bench=True, dev=dev)
    require(warm["bytes"] == cold["bytes"], "cold and warm proofs differ")
    digest = hashlib.sha256(cold["bytes"]).hexdigest()
    log(f"[full] 2^{FULL_LOG} rows, blowup 4, 80 queries, coset 3, grinding 20")
    log(f"[full] proof size {len(cold['bytes'])} bytes, sha256 {digest}")
    log(f"[full] trace build {cold['trace_s']:.3f} s (host)")
    for tag, r in (("cold", cold), ("warm", warm)):
        rounds = ", ".join(f"{k} {v:.3f}" for k, v in r["timings"].items())
        log(f"[full] {tag} prove {r['prove_s']:.3f} s ({rounds}); "
            f"verify {r['verify_s']:.3f} s, accepted")
    log(f"[full] torch.cuda.max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    log(f"[full] kernel launches in the cold prove: {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    fixture = os.path.join(FIXTURES, "simple_fibonacci_bench_digest.json")
    with open(fixture) as f:
        ref = json.load(f)
    if ref["trace_length"] == 1 << FULL_LOG:
        require(ref["sha256"] == digest, "2^19 proof differs from the JAX digest")
        log("[full] equal to the JAX digest")
    else:
        log(f"[full] no JAX digest at 2^{FULL_LOG} rows (the fixture covers "
            f"{ref['trace_length']} rows)")
    return launches


SOURCES = {
    "mont_mul": ("lambdaworks_cairo_prover_tpu_torch/csrc/field_ops.cu",
                 "lambdaworks_cairo_prover_tpu/field/pallas_mul.py:126"),
    "add_sub_mod": ("lambdaworks_cairo_prover_tpu_torch/csrc/field_ops.cu",
                    "lambdaworks_cairo_prover_tpu/field/pallas_mul.py:135"),
    "ntt_dif_stage": ("lambdaworks_cairo_prover_tpu_torch/csrc/ntt.cu",
                      "lambdaworks_cairo_prover_tpu/ntt/fused.py:164"),
    "ntt_dif_local": ("lambdaworks_cairo_prover_tpu_torch/csrc/ntt.cu",
                      "lambdaworks_cairo_prover_tpu/ntt/fused.py:200"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAILED: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"FAILED: the port's package {PKG}/ is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    try:
        phase_card(torch)
        phase_build()
        kern = phase_kernels(torch, dev)
        phase_fixtures(dev)
        launches = phase_full(torch, dev)
        require("jax" not in sys.modules, "JAX was imported")
    except Exception as exc:  # report the failed phase, then exit non-zero
        import traceback

        traceback.print_exc()
        print(f"FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"]}
        for name, rec in kern.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
