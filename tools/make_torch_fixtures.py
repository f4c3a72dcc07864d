"""Write fixtures from the JAX package for the PyTorch port's tests.

Run once on a CPU host with JAX installed:

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [--budget 900] \
        [--logs 19 18 17 16] [--cairo-fibs 8000 2000 500]

Writes into tests/fixtures/torch_port/:

* ``simple_fibonacci_1024_test_options.proof`` — serialized bytes of the
  JAX proof of ``simple_fibonacci`` at 2^10 rows, ``default_test_options()``.
* ``simple_fibonacci_bench_digest.json`` — the sha256 of the JAX proof at the
  largest trace length (tried in the order of ``--logs``) that the JAX package
  proves on this host within ``--budget`` seconds, with the bench options
  (blowup 4, 80 FRI queries, coset offset 3, grinding 20).  The file states
  the trace length the digest covers.
* ``fused_ntt_4096.json`` — the sha256 of the fused Pallas NTT's output
  (``ntt/fused.py:ntt_fused`` in interpret mode) at 2^12 points, forward and
  inverse, on inputs made by :func:`fused_input`.  Compiling that kernel in
  interpret mode takes minutes on a CPU, longer than a fast test may run.
* ``butterfly2_64.json`` — the same for ``field/pallas_mul.py:butterfly2``
  (two fused DIT stages) on a 2^6-point input.

* ``cairo_fib5_test_options.proof`` and ``cairo_rc_test_options.proof`` — the
  JAX package's proof files (``proof/serde.py:write_proof_file``: the proof,
  then the serialized public inputs) of the Cairo programs
  ``fibonacci_program(5)`` and ``rc_program((250, 77, 1 << 100))`` run through
  ``generate_prover_args`` and ``generate_cairo_proof`` with
  ``default_test_options()``.
* ``cairo_fib_bench_digest.json`` — the sha256 and size of the JAX proof of
  the largest Cairo ``fibonacci_program(n)`` (tried in the order of
  ``--cairo-fibs``) that the JAX package proves on this host within
  ``--budget`` seconds with the bench options, and of its serialized public
  inputs.  The file states ``n`` and the trace's rows and columns.

Each Cairo proof is made in a child process of its own.  The port's tests
and ``chip_smoke.py`` compare their own outputs with these
files.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import queue as queue_mod
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_port")
SMALL_NAME = "simple_fibonacci_1024_test_options.proof"
DIGEST_NAME = "simple_fibonacci_bench_digest.json"
BENCH_OPTIONS = dict(blowup_factor=4, fri_number_of_queries=80,
                     coset_offset=3, grinding_factor=20)
FUSED_NAME = "fused_ntt_4096.json"
FUSED_LOG = 12
FUSED_SEEDS = {"forward": 40, "inverse": 41}
BUTTERFLY2_NAME = "butterfly2_64.json"
BUTTERFLY2_LOG, BUTTERFLY2_STAGE, BUTTERFLY2_SEED = 6, 2, 50
CAIRO_DIGEST_NAME = "cairo_fib_bench_digest.json"
RC_VALUES = (250, 77, 1 << 100)
# name of the proof file -> (generator in cairo/programs.py, its arguments)
CAIRO_SMALL = {
    "cairo_fib5_test_options.proof": ("fibonacci_program", (5,)),
    "cairo_rc_test_options.proof": ("rc_program", (RC_VALUES,)),
}


def fused_input(seed: int, log_n: int = FUSED_LOG):
    """(16, 2^log_n) uint32 limbs of canonical elements (< 2^251) from
    ``np.random.default_rng(seed)``."""
    import numpy as np

    limbs = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(16, 1 << log_n), dtype=np.uint32)
    limbs[15] &= 0x7FF
    return limbs


def _fused_worker(queue) -> None:
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.ntt import fused

    @functools.partial(jax.jit, static_argnames=("inverse",))
    def run(x, inverse):
        return fused.ntt_fused(x, FUSED_LOG, inverse, interpret=True)

    record = {"log_n": FUSED_LOG, "input": "tools/make_torch_fixtures.py:"
              "fused_input(seed)", "made_by": "lambdaworks_cairo_prover_tpu "
              "ntt/fused.py:ntt_fused(interpret=True) on CPU"}
    for direction, seed in FUSED_SEEDS.items():
        x = fused_input(seed)
        out = np.asarray(run(jnp.asarray(x), direction == "inverse"),
                         dtype=np.uint32)
        record[direction] = {
            "seed": seed,
            "input_sha256": hashlib.sha256(x.tobytes()).hexdigest(),
            "output_sha256": hashlib.sha256(out.tobytes()).hexdigest(),
        }
    queue.put(record)


def _butterfly2_worker(queue) -> None:
    """pallas_mul.butterfly2 (two fused DIT stages) at the stage pair
    (2^BUTTERFLY2_STAGE, 2^(BUTTERFLY2_STAGE+1)) of a 2^BUTTERFLY2_LOG NTT,
    as ntt/core.py:_ntt_impl applies it."""
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.field import pallas_mul as pm
    from lambdaworks_cairo_prover_tpu.ntt import core as nttc

    n, s = 1 << BUTTERFLY2_LOG, BUTTERFLY2_STAGE
    m = 1 << s
    x = fused_input(BUTTERFLY2_SEED, BUTTERFLY2_LOG)
    tw = nttc._stage_twiddles(BUTTERFLY2_LOG, False)
    xv = jnp.asarray(x).reshape(16, 1, n // (4 * m), 4, m)
    w2 = tw[s + 1]
    outs = pm.butterfly2(
        tuple(xv[:, :, :, j, :] for j in range(4)),
        (tw[s][:, None, None, :], w2[:, None, None, :m], w2[:, None, None, m:]),
        interpret=True)
    out = np.asarray(jnp.stack(outs, axis=3).reshape(16, n), dtype=np.uint32)
    queue.put({"log_n": BUTTERFLY2_LOG, "stage": s, "seed": BUTTERFLY2_SEED,
               "input": "tools/make_torch_fixtures.py:fused_input(seed, log_n)",
               "made_by": "lambdaworks_cairo_prover_tpu field/pallas_mul.py:"
               "butterfly2(interpret=True) on CPU",
               "input_sha256": hashlib.sha256(x.tobytes()).hexdigest(),
               "output_sha256": hashlib.sha256(out.tobytes()).hexdigest()})


def _write_json(name: str, record) -> None:
    if record is None:
        print(f"{name}: failed or over the budget", flush=True)
        return
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {name}", flush=True)


def _in_child(target, args, budget: float):
    """Run ``target(*args, queue)`` in a child process; its queued result,
    or None when it fails or overruns ``budget`` seconds (then it is
    stopped)."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=target, args=(*args, queue))
    proc.start()
    result = None
    deadline = time.monotonic() + budget
    while result is None and time.monotonic() < deadline:
        try:
            result = queue.get(timeout=5)
        except queue_mod.Empty:
            if not proc.is_alive():  # died (out of memory, or an error)
                break
    proc.join(timeout=5)
    if proc.is_alive():
        proc.kill()
        proc.join()
    return result


def _prove_bytes(log_n: int, bench: bool) -> bytes:
    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.air.examples.simple_fibonacci import (
        FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu.prover.prove import prove

    options = (ProofOptions(**BENCH_OPTIONS) if bench
               else ProofOptions.default_test_options())
    trace = fibonacci_trace([1, 1], 1 << log_n)
    proof = prove(trace, FibonacciPublicInputs(a0=1, a1=1), options,
                  FibonacciAIR)
    return serialize_proof(proof)


def _bench_worker(log_n: int, queue) -> None:
    t0 = time.perf_counter()
    data = _prove_bytes(log_n, bench=True)
    queue.put((hashlib.sha256(data).hexdigest(), len(data),
               time.perf_counter() - t0))


def _cairo_worker(generator: str, gen_args: tuple, bench: bool, queue) -> None:
    """Prove a program of cairo/programs.py with the JAX package; queues
    (proof bytes, public-input bytes, rows, columns, seconds)."""
    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.cairo import programs
    from lambdaworks_cairo_prover_tpu.cairo.air import generate_cairo_proof
    from lambdaworks_cairo_prover_tpu.cairo.runner import generate_prover_args
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.proof.serde import serialize_proof

    t0 = time.perf_counter()
    options = (ProofOptions(**BENCH_OPTIONS) if bench
               else ProofOptions.default_test_options())
    trace, pub = generate_prover_args(getattr(programs, generator)(*gen_args))
    proof = generate_cairo_proof(trace, pub, options)
    columns = len(proof.trace_ood_frame_evaluations[0])  # main + auxiliary
    queue.put((serialize_proof(proof), pub.serialize(), trace.n_rows,
               columns, time.perf_counter() - t0))


def _write_cairo_fixtures(budget: float, fibs: list[int]) -> None:
    for name, (generator, gen_args) in CAIRO_SMALL.items():
        result = _in_child(_cairo_worker, (generator, gen_args, False), budget)
        if result is None:
            print(f"{name}: failed or over the budget", flush=True)
            continue
        proof_bytes, pub_bytes, rows, cols, seconds = result
        with open(os.path.join(OUT_DIR, name), "wb") as f:
            # the framing of proof/serde.py:write_proof_file
            f.write(len(proof_bytes).to_bytes(8, "big") + proof_bytes
                    + pub_bytes)
        print(f"wrote {name}: {rows} rows x {cols} columns, proof "
              f"{len(proof_bytes)} B, {seconds:.1f} s", flush=True)

    not_proved = {}
    for n in fibs:
        print(f"bench-options Cairo fibonacci_program({n}) "
              f"(budget {budget:.0f} s)...", flush=True)
        result = _in_child(_cairo_worker, ("fibonacci_program", (n,), True),
                           budget)
        if result is None:
            print(f"  fib({n}): failed or did not finish within the budget",
                  flush=True)
            not_proved[str(n)] = f"failed or over the {budget:.0f} s budget"
            continue
        proof_bytes, pub_bytes, rows, cols, seconds = result
        _write_json(CAIRO_DIGEST_NAME, {
            "program": f"cairo/programs.py:fibonacci_program({n})",
            "n": n,
            "trace_rows": rows,
            "trace_columns": cols,
            "options": BENCH_OPTIONS,
            "sha256": hashlib.sha256(proof_bytes).hexdigest(),
            "proof_bytes": len(proof_bytes),
            "public_inputs_sha256": hashlib.sha256(pub_bytes).hexdigest(),
            "public_inputs_bytes": len(pub_bytes),
            "made_by": "lambdaworks_cairo_prover_tpu (JAX) on CPU",
            "jax_cpu_seconds": round(seconds, 1),
            "larger_programs_not_proved": not_proved,
        })
        return
    if fibs:
        print("no bench-options Cairo program finished within the budget",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget", type=float, default=900.0,
                    help="seconds allowed for each proof or digest run")
    ap.add_argument("--logs", type=int, nargs="*", default=[19, 18, 17, 16],
                    help="log2 trace lengths to try, largest first")
    ap.add_argument("--skip-small", action="store_true")
    ap.add_argument("--skip-fused", action="store_true")
    ap.add_argument("--skip-butterfly2", action="store_true")
    ap.add_argument("--cairo-fibs", type=int, nargs="*",
                    default=[8000, 2000, 500],
                    help="n of fibonacci_program(n) to try with the bench "
                    "options, largest first (none: no Cairo fixtures)")
    args = ap.parse_args()
    os.makedirs(OUT_DIR, exist_ok=True)

    if not args.skip_small:
        data = _prove_bytes(10, bench=False)
        with open(os.path.join(OUT_DIR, SMALL_NAME), "wb") as f:
            f.write(data)
        print(f"wrote {SMALL_NAME}: {len(data)} bytes", flush=True)
    if not args.skip_fused:
        _write_json(FUSED_NAME, _in_child(_fused_worker, (), args.budget))
    if not args.skip_butterfly2:
        _write_json(BUTTERFLY2_NAME,
                    _in_child(_butterfly2_worker, (), args.budget))

    if args.cairo_fibs:
        _write_cairo_fixtures(args.budget, args.cairo_fibs)

    not_proved = {}
    for log_n in args.logs:
        print(f"bench-options prove at 2^{log_n} rows "
              f"(budget {args.budget:.0f} s)...", flush=True)
        result = _in_child(_bench_worker, (log_n,), args.budget)
        if result is None:
            print(f"  2^{log_n}: failed or did not finish within the budget",
                  flush=True)
            not_proved[str(1 << log_n)] = (
                f"failed or over the {args.budget:.0f} s budget")
            continue
        digest, size, seconds = result
        record = {
            "air": "simple_fibonacci",
            "initial_values": [1, 1],
            "trace_length": 1 << log_n,
            "options": BENCH_OPTIONS,
            "sha256": digest,
            "proof_bytes": size,
            "made_by": "lambdaworks_cairo_prover_tpu (JAX) on CPU",
            "jax_cpu_seconds": round(seconds, 1),
            "larger_sizes_not_proved": not_proved,
        }
        with open(os.path.join(OUT_DIR, DIGEST_NAME), "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote {DIGEST_NAME}: {record}", flush=True)
        return
    if args.logs:
        print("no bench-options size finished within the budget", flush=True)


if __name__ == "__main__":
    main()
