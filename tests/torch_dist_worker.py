"""One rank of a gloo process group on the CPU for the port's sharded
tests (tests/test_torch_four_step.py, tests/test_torch_sharded_prove.py),
as tests/mp_prove_worker.py is one process of the JAX package's cluster.

    python tests/torch_dist_worker.py RANK WORLD STORE_FILE CASES_JSON OUT_JSON

The ranks meet through a ``FileStore`` (a file in the test's temporary
directory, so no port is shared between test workers), build the mesh
with ``parallel.sharding.make_mesh``, run every case of CASES_JSON (a JSON
list) in order and write one JSON result per case to OUT_JSON.  The worker
never imports JAX or the JAX package, and fails if a module of either is
loaded.  :func:`run_group` starts the ranks from a test.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures", "torch_port")


def run_group(world: int, cases: list, tmp_dir, timeout: float = 600) -> list:
    """Run ``cases`` on ``world`` ranks, each a child process with one
    thread; their results, rank by rank.  A rank that fails fails the
    caller with its output; a group that outlives ``timeout`` seconds is
    killed and fails the caller."""
    tmp_dir = os.fspath(tmp_dir)
    cases_path = os.path.join(tmp_dir, f"cases_{world}.json")
    with open(cases_path, "w") as f:
        json.dump(cases, f)
    store = os.path.join(tmp_dir, f"store_{world}")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs, outs = [], [], []
    for rank in range(world):
        outs.append(os.path.join(tmp_dir, f"out_{world}_{rank}.json"))
        logs.append(open(os.path.join(tmp_dir, f"log_{world}_{rank}.txt"),
                         "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(world),
             store, cases_path, outs[-1]],
            cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"the {world}-rank group did not finish within "
                             f"{timeout} s") from None
    finally:
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (f"rank {rank} of {world} exited with "
                                   f"{p.returncode}:\n{texts[rank][-6000:]}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def seeded_limbs(seed: int, shape) -> "np.ndarray":
    """uint32 limbs (16, *shape) of canonical elements (< 2^251), from
    ``np.random.default_rng(seed)``: tools/make_torch_fixtures.py:fused_input."""
    import numpy as np

    x = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(16,) + tuple(shape), dtype=np.uint32)
    x[15] &= 0x7FF
    return x


def sha256_limbs(x) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(x), dtype=np.uint32)).hexdigest()


# ---------------------------------------------------------------------------
# cases (run in the ranks)
# ---------------------------------------------------------------------------


def _case_ntt(mesh, case):
    """ShardedNTT.transform of a seeded (16, 1, n) input, gathered whole."""
    from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                            limbs_to_numpy)
    from lambdaworks_cairo_prover_tpu_torch.parallel import sharding as sh
    from lambdaworks_cairo_prover_tpu_torch.parallel.four_step import ShardedNTT

    n = 1 << case["log_n"]
    sntt = ShardedNTT(mesh, "dom", "cpu")
    x = limbs_from_numpy(seeded_limbs(case["seed"], (1, n)), "cpu")
    local = sntt.shard(x)
    out = sntt.transform(local, n, inverse=case["direction"] == "inverse")
    return {"plan": sntt.plan(n), "in_shape": list(local.shape),
            "out_shape": list(out.shape),
            "sha256": sha256_limbs(limbs_to_numpy(sh.full(out, n, mesh)))}


def _case_reblock(mesh, case):
    """reblock of a seeded (16, 3, n_old) tensor against the block of the
    whole tensor cut or padded on one rank."""
    import torch

    from lambdaworks_cairo_prover_tpu_torch.interop import limbs_from_numpy
    from lambdaworks_cairo_prover_tpu_torch.parallel import sharding as sh

    n_old, n_new = case["n_old"], case["n_new"]
    x = limbs_from_numpy(seeded_limbs(80, (3, n_old)), "cpu")
    got = sh.reblock(sh.shard_domain(mesh, x), n_old, n_new, mesh)
    m = min(n_old, n_new)
    whole = torch.cat([x[..., :m], torch.zeros((16, 3, n_new - m),
                                               dtype=x.dtype)], dim=-1)
    want = sh.shard_domain(mesh, whole)
    return {"shape": list(got.shape), "want_shape": list(want.shape),
            "equal": bool(got.shape == want.shape and torch.equal(got, want))}


def _prove(mesh, case):
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import (
        serialize_proof, write_proof_file)

    options = ProofOptions.default_test_options()
    axis = case["shard_axis"]
    if case["air"] == "simple_fibonacci":
        from lambdaworks_cairo_prover_tpu_torch.air.examples import (
            simple_fibonacci as fib)
        from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove
        from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

        pub = fib.FibonacciPublicInputs(a0=1, a1=1)
        proof = prove(fib.fibonacci_trace([1, 1], case["rows"], device="cpu"),
                      pub, options, fib.FibonacciAIR, device="cpu",
                      mesh=mesh, shard_axis=axis)
        return (serialize_proof(proof),
                verify(proof, pub, options, fib.FibonacciAIR))
    from lambdaworks_cairo_prover_tpu_torch.cairo import programs
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import (
        generate_cairo_proof, verify_cairo_proof)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        CairoVersion, generate_prover_args)

    if case["air"] == "cairo1":
        # the synthetic CASM contract (BASELINE config 4's Cairo1 arm)
        with open(os.path.join(FIXTURES, "synthetic_contract.casm"), "rb") as f:
            trace, pub = generate_prover_args(
                f.read(), cairo_version=CairoVersion.V1, device="cpu")
    else:
        trace, pub = generate_prover_args(
            programs.fibonacci_program(case["fib"]), device="cpu")
    proof = generate_cairo_proof(trace, pub, options, device="cpu", mesh=mesh,
                                 shard_axis=axis)
    return (write_proof_file(proof, pub.serialize()),
            verify_cairo_proof(proof, pub, options))


def _case_prove(mesh, case):
    t0 = time.perf_counter()
    data, ok = _prove(mesh, case)
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data),
            "verified": bool(ok), "seconds": time.perf_counter() - t0}


def _case_fri_chain(mesh, case):
    """The sharded fri_commit_chain on the input of fri_chain.json (the JAX
    package's chain): roots, the whole of every layer's evaluations, the
    last coefficients."""
    import numpy as np
    import torch

    from lambdaworks_cairo_prover_tpu_torch.air.examples import (
        simple_fibonacci as fib)
    from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                            limbs_to_numpy)
    from lambdaworks_cairo_prover_tpu_torch.parallel import sharding as sh
    from lambdaworks_cairo_prover_tpu_torch.parallel.sharded_kernels import (
        get_sharded_kernels)
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.prover.domain import Domain

    with open(os.path.join(FIXTURES, "fri_chain.json")) as f:
        rec = json.load(f)
    rng = np.random.default_rng(rec["seed"])
    n = 1 << rec["log_rows"]
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] &= 0x7FF
    state = rng.bytes(32)  # tools/make_torch_fixtures.py:fri_chain_input
    air = fib.FibonacciAIR(n, fib.FibonacciPublicInputs(a0=1, a1=1),
                           ProofOptions.default_test_options())
    domain = Domain(air)
    kern = get_sharded_kernels(air, domain, mesh, "cpu")
    want = rec[case["plan"]]
    plan = tuple(tuple(p) for p in want["plan"])
    coeffs = sh.shard_domain(mesh, limbs_from_numpy(limbs, "cpu"))
    rows, evals, _, last = kern.fri_commit_chain(
        coeffs, torch.from_numpy(np.frombuffer(state, "<i8").copy())[None],
        plan, final_fold=want["final_fold"])
    sizes = [domain.lde_size] + [ds for _, ds in plan]
    n_last = n >> len(plan)
    return {"rows_hex": rows.numpy().tobytes().hex(),
            "evals_sha256": [sha256_limbs(limbs_to_numpy(sh.full(e, s, mesh)))
                             for e, s in zip(evals, sizes)],
            "last_coeffs_sha256": sha256_limbs(limbs_to_numpy(
                sh.full(last, n_last, mesh)))}


def _case_device_mismatch(mesh, case):
    """prove on a CUDA device with this CPU mesh: the ProvingError's text."""
    from lambdaworks_cairo_prover_tpu_torch.air.examples import (
        simple_fibonacci as fib)
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.prover.prove import (ProvingError,
                                                                 prove)

    try:
        prove(fib.fibonacci_trace([1, 1], 16, device="cpu"),
              fib.FibonacciPublicInputs(a0=1, a1=1),
              ProofOptions.default_test_options(), fib.FibonacciAIR,
              device="cuda", mesh=mesh)
    except ProvingError as exc:
        return {"raised": str(exc)}
    return {"raised": None}


_CASES = {"ntt": _case_ntt, "reblock": _case_reblock, "prove": _case_prove,
          "fri_chain": _case_fri_chain,
          "device_mismatch": _case_device_mismatch}


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, cases_path, out_path = sys.argv[3:6]
    sys.path.insert(0, ROOT)
    import warnings

    import torch
    import torch.distributed as dist

    # torch > 2.11 calls all_gather_into_tensor deprecated; the card's
    # torch has no other name for it
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=".*all_gather_into_tensor.*")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        from lambdaworks_cairo_prover_tpu_torch.parallel.sharding import (
            make_mesh)

        mesh = make_mesh(world, device_type="cpu")
        with open(cases_path) as f:
            cases = json.load(f)
        results = [_CASES[c["kind"]](mesh, c) for c in cases]
        # no rank tears its connections down while another still uses them
        dist.barrier()
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "lambdaworks_cairo_prover_tpu"))
    assert not bad, f"the worker loaded {bad}"
    with open(out_path, "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main()
