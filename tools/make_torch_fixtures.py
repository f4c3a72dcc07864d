"""Write fixtures from the JAX package for the PyTorch port's tests.

Run once on a CPU host with JAX installed:

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [--budget 900] \
        [--only PART ...] [--logs 19 18 17 16] [--cairo-fibs 8000 2000 500] \
        [--jobs 1]

``--only`` names the parts to write (all by default): ``small``, ``bench``,
``fused``, ``butterfly2``, ``cairo``, ``examples``, ``programs``, ``casm``,
``hinted``, ``rc``, ``toy``, ``fri_chain``, ``four_step``, in the order of
the list below.

Writes into tests/fixtures/torch_port/:

* ``simple_fibonacci_1024_test_options.proof`` — serialized bytes of the
  JAX proof of ``simple_fibonacci`` at 2^10 rows, ``default_test_options()``.
* ``simple_fibonacci_bench_digest.json`` (``bench``) — the sha256 of the JAX proof at the
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

* ``cairo_<name>_test_options.proof`` — the JAX package's proof files, as
  above, of the programs with builtins or hints in ``CAIRO_PROGRAMS``
  (``cairo/programs.py``: output, bitwise, pedersen, ecdsa, keccak,
  poseidon; ``cairo/stdlib.py``: lt_comparison, signed_div_rem,
  compare_lesser_array(10)), each on its layout, and
  ``cairo_programs.json``: for each file the generator, its arguments (the
  ecdsa signature made by the JAX package's ``ecdsa_sign``), the layout,
  the trace's rows and columns.
* ``cairo_compare_lesser_array_bench_digest.json`` (``hinted``) — the sha256
  and size of the JAX proof of ``compare_lesser_array_program(HINTED_LENGTH)``
  (a hinted stdlib program: 2^16 rows x 61 columns, the range-check builtin)
  with the bench options, and its serialized public inputs in hex.
* ``cairo_rc_bench_digest.json`` (``rc``) — the sha256 and size of the JAX
  proof of ``bench.py``'s rc workload at 2^16 rows: ``rc_program`` of the
  value count that :func:`rc_value_count` calibrates (the loop of
  ``bench.py:_rc_workload``, copied here), with the bench options.
* ``simple_fibonacci_8_f257_test_options.proof`` (``toy``) — the JAX proof
  (``serialize_proof``) of ``simple_fibonacci`` at 8 rows over GF(257)
  (``LCP_FIELD=f257``), ``default_test_options()``, as
  ``tests/test_toy_field.py`` makes it.
* ``fri_chain.json`` (``fri_chain``) — the JAX package's
  ``ProverKernels.fri_commit_chain`` on the coefficients and transcript
  state of :func:`fri_chain_input`, for a partial plan and for the full
  chain: the sha256 of the stacked roots (u32 words), of each layer's
  evaluations and of the last coefficients (uint32 limbs).
* ``four_step_ntt.json`` (``four_step``) — the sha256 of the JAX package's
  ``parallel/four_step.py:ShardedNTT.transform`` outputs on an 8-device CPU
  mesh (uint32 limbs, gathered whole), forward and inverse at 2^10 and
  2^12 points, on inputs made by :func:`fused_input` with the seeds of
  ``FOUR_STEP_SEEDS``.
* ``synthetic_contract.casm`` and ``cairo1_synthetic_test_options.proof`` —
  a small CASM contract class (:func:`synthetic_casm`: Cairo1 core hints
  ``TestLessThan``, ``AllocSegment`` and ``DivMod``, a range-check cell),
  and the JAX package's proof file of it, run through the ``CairoVersion.V1``
  arm of ``generate_prover_args`` with ``default_test_options()``.  No
  compiled Cairo1 contract is in the repository.
* ``example_<air>_test_options.proof`` — the JAX proofs
  (``serialize_proof``) of the example AIRs ``fibonacci_2_columns``,
  ``quadratic_air``, ``fibonacci_rap`` and ``dummy_air`` as
  ``tests/test_examples.py`` makes them (16 steps), with
  ``default_test_options()``.

Each Cairo or example proof is made in a child process of its own;
``--jobs`` runs that many at once.  The port's tests
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
# the ecdsa program's signature: key, message and nonce of
# tests/test_ecdsa_builtin.py
ECDSA_PRIV, ECDSA_MSG, ECDSA_K = 0x12345678ABCDEF, 0xDEADBEEFCAFE, 0x6789ABCDEF012345
CAIRO_PROGRAMS_NAME = "cairo_programs.json"
# name -> (module of the JAX package's cairo/, generator, its arguments,
# layout); "ECDSA_SIG" stands for the signature made in the child
CAIRO_PROGRAMS = {
    "output": ("programs", "output_program", (), "Small"),
    "bitwise": ("programs", "bitwise_program", (), "Recursive"),
    "pedersen": ("programs", "pedersen_program", (), "Small"),
    "ecdsa": ("programs", "ecdsa_program", ("ECDSA_SIG",), "Small"),
    "keccak": ("programs", "keccak_program", (), "StarknetWithKeccak"),
    "poseidon": ("programs", "poseidon_program", (), "Starknet"),
    "lt_comparison": ("stdlib", "lt_comparison_program", (), "Small"),
    "signed_div_rem": ("stdlib", "signed_div_rem_program", (), "Small"),
    "compare_lesser_array_10": ("stdlib", "compare_lesser_array_program",
                                (10,), "Small"),
}
HINTED_DIGEST_NAME = "cairo_compare_lesser_array_bench_digest.json"
HINTED_LENGTH = 1200  # 64,843 steps: 2^16 rows
RC_DIGEST_NAME = "cairo_rc_bench_digest.json"
RC_LOG_ROWS = 16
TOY_NAME = "simple_fibonacci_8_f257_test_options.proof"
TOY_ROWS = 8
FRI_CHAIN_NAME = "fri_chain.json"
FRI_CHAIN_LOG, FRI_CHAIN_SEED = 8, 60  # 2^8 rows: an LDE of 2^10 points
FOUR_STEP_NAME = "four_step_ntt.json"
FOUR_STEP_DEVICES = 8
FOUR_STEP_SEEDS = {(10, "forward"): 70, (10, "inverse"): 71,
                   (12, "forward"): 72, (12, "inverse"): 73}
CASM_NAME = "synthetic_contract.casm"
CASM_PROOF_NAME = "cairo1_synthetic_test_options.proof"
EXAMPLES = ("fibonacci_2_columns", "quadratic_air", "fibonacci_rap",
            "dummy_air")
EXAMPLE_STEPS = 16


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


def _toy_worker(queue) -> None:
    """simple_fibonacci over GF(257) with the JAX package, as
    tests/test_toy_field.py proves it; queues the proof bytes."""
    os.environ["LCP_FIELD"] = "f257"
    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.air.examples.simple_fibonacci import (
        FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu.prover.prove import prove

    proof = prove(fibonacci_trace([1, 1], TOY_ROWS),
                  FibonacciPublicInputs(a0=1, a1=1),
                  ProofOptions.default_test_options(), FibonacciAIR)
    queue.put(serialize_proof(proof))


def fri_chain_input(seed: int = FRI_CHAIN_SEED, log_rows: int = FRI_CHAIN_LOG):
    """(coefficients (16, 2^log_rows) uint32 canonical limbs, 32-byte
    transcript state) from ``np.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(16, 1 << log_rows), dtype=np.uint32)
    limbs[15] &= 0x7FF
    return limbs, rng.bytes(32)


def fri_chain_plans(log_rows: int = FRI_CHAIN_LOG, blowup: int = 4,
                    offset: int = 3, partial: int = 3) -> dict:
    """The plans of a 2^log_rows-row trace's FRI commit: ``partial`` folds,
    and every fold (``root_order - 1`` of them, the full chain); each a
    tuple of (offset, domain size) as prover/prove.py builds it."""
    p = (1 << 251) + 17 * (1 << 192) + 1  # Stark252
    plan, off, ds = [], offset, (1 << log_rows) * blowup
    for _ in range(1, log_rows):
        off, ds = off * off % p, ds // 2
        plan.append((off, ds))
    return {"partial": tuple(plan[:partial]), "full": tuple(plan)}


def _fri_chain_worker(queue) -> None:
    """The JAX package's fri_commit_chain on fri_chain_input, for both
    plans of fri_chain_plans, on the kernels of simple_fibonacci at
    2^FRI_CHAIN_LOG rows with the test options."""
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.air.examples.simple_fibonacci import (
        FibonacciAIR, FibonacciPublicInputs)
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.prover.domain import Domain
    from lambdaworks_cairo_prover_tpu.prover.kernels import get_kernels

    def sha(x):
        return hashlib.sha256(np.asarray(x, dtype=np.uint32).tobytes()
                              ).hexdigest()

    air = FibonacciAIR(1 << FRI_CHAIN_LOG, FibonacciPublicInputs(a0=1, a1=1),
                       ProofOptions.default_test_options())
    kern = get_kernels(air, Domain(air))
    coeffs, state = fri_chain_input()
    state_words = jnp.asarray(np.frombuffer(state, dtype="<u4"))
    record = {"log_rows": FRI_CHAIN_LOG, "seed": FRI_CHAIN_SEED,
              "input": "tools/make_torch_fixtures.py:fri_chain_input()",
              "kernels": "simple_fibonacci, default_test_options()",
              "made_by": "lambdaworks_cairo_prover_tpu prover/kernels.py:"
              "fri_commit_chain on CPU"}
    for name, plan in fri_chain_plans().items():
        final = name == "full"
        roots, evals, _, last = kern.fri_commit_chain(
            jnp.asarray(coeffs), state_words, plan, final_fold=final)
        record[name] = {
            "plan": [[o, d] for o, d in plan], "final_fold": final,
            "roots_hex": np.asarray(roots, dtype=np.uint32).tobytes().hex(),
            "evals_sha256": [sha(e) for e in evals],
            "last_coeffs_sha256": sha(last)}
    queue.put(record)


def _four_step_worker(queue) -> None:
    """ShardedNTT.transform on a mesh of FOUR_STEP_DEVICES CPU devices (the
    mesh of the JAX package's tests) for each case of FOUR_STEP_SEEDS."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count="
                               f"{FOUR_STEP_DEVICES}").strip()
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.parallel.four_step import ShardedNTT
    from lambdaworks_cairo_prover_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(FOUR_STEP_DEVICES, devices=jax.devices("cpu"))
    sntt = ShardedNTT(mesh)
    record = {"devices": FOUR_STEP_DEVICES,
              "input": "tools/make_torch_fixtures.py:fused_input(seed, log_n)",
              "made_by": "lambdaworks_cairo_prover_tpu parallel/four_step.py:"
              "ShardedNTT.transform (no 1/n scaling) on CPU", "cases": []}
    for (log_n, direction), seed in FOUR_STEP_SEEDS.items():
        x = fused_input(seed, log_n)
        out = sntt.transform(sntt.shard(jnp.asarray(x)[:, None, :]),
                             inverse=direction == "inverse")
        out = np.asarray(out, dtype=np.uint32).reshape(16, 1 << log_n)
        record["cases"].append({
            "log_n": log_n, "direction": direction, "seed": seed,
            "plan": list(sntt.plan(1 << log_n)),
            "input_sha256": hashlib.sha256(x.tobytes()).hexdigest(),
            "output_sha256": hashlib.sha256(out.tobytes()).hexdigest()})
    queue.put(record)


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


def _program_worker(module: str, generator: str, gen_args: tuple,
                    layout: str, bench: bool, queue) -> None:
    """Prove a program of cairo/programs.py or cairo/stdlib.py on ``layout``
    with the JAX package; queues (proof bytes, public-input bytes, rows,
    columns, seconds, the generator's arguments)."""
    import importlib

    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.cairo.air import generate_cairo_proof
    from lambdaworks_cairo_prover_tpu.cairo.builtins import (
        EC_GEN, _ec_mul, ecdsa_sign)
    from lambdaworks_cairo_prover_tpu.cairo.runner import (
        CairoLayout, generate_prover_args)
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.proof.serde import serialize_proof

    t0 = time.perf_counter()
    if gen_args == ("ECDSA_SIG",):
        r, s = ecdsa_sign(ECDSA_PRIV, ECDSA_MSG, ECDSA_K)
        gen_args = ([(_ec_mul(ECDSA_PRIV, EC_GEN)[0], ECDSA_MSG, r, s)],)
    mod = importlib.import_module(f"lambdaworks_cairo_prover_tpu.cairo.{module}")
    options = (ProofOptions(**BENCH_OPTIONS) if bench
               else ProofOptions.default_test_options())
    trace, pub = generate_prover_args(getattr(mod, generator)(*gen_args),
                                      layout=CairoLayout[layout])
    proof = generate_cairo_proof(trace, pub, options)
    columns = len(proof.trace_ood_frame_evaluations[0])
    queue.put((serialize_proof(proof), pub.serialize(), trace.n_rows,
               columns, time.perf_counter() - t0, gen_args))


def synthetic_casm() -> str:
    """The JSON of a CASM contract class with one EXTERNAL entrypoint
    (builtins: range_check): a TestLessThan hint whose result the next
    instruction asserts, an AllocSegment hint, a DivMod hint in its
    ``{"Core": ...}`` framing, a write of 100 to the range-check segment,
    ``ret``.  Encoded with the JAX package's instruction encoder."""
    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.cairo import decode as D
    from lambdaworks_cairo_prover_tpu.cairo import programs as PR
    from lambdaworks_cairo_prover_tpu.field.params import P

    def cell(reg, off):
        return {"register": reg, "offset": off}

    def imm(v):
        return {"Immediate": hex(v)}

    keep_ap = D.encode_instruction(  # [ap] = [ap]; ap++
        off_dst=0, off_op0=-1, off_op1=0, dst_reg=0, op0_reg=0,
        op1_src=D.OP1_SRC_AP, res_logic=D.RES_OP1, pc_update=D.PC_REGULAR,
        ap_update=D.AP_ADD1, opcode=D.OPCODE_ASSERT_EQ)
    code, hints = [], []
    hints.append([len(code), [{"TestLessThan": {
        "lhs": imm(5), "rhs": imm(10), "dst": cell("AP", 0)}}]])
    code += PR.push_imm(1)
    hints.append([len(code), [{"AllocSegment": {"dst": cell("AP", 0)}}]])
    code += [keep_ap]
    hints.append([len(code), [{"Core": {"DivMod": {
        "lhs": imm(1000), "rhs": imm(7), "quotient": cell("AP", 0),
        "remainder": cell("AP", 1)}}}]])
    code += PR.push_imm(142) + PR.push_imm(6)
    code += [PR.copy_fp(-7)] + PR.push_imm(100) + [PR._deref_write(-2, 0)]
    code += [PR.RET]
    return json.dumps({
        "prime": hex(P), "bytecode": [hex(w) for w in code], "hints": hints,
        "entry_points_by_type": {
            "EXTERNAL": [{"selector": "0x0", "offset": 0,
                          "builtins": ["range_check"]}],
            "L1_HANDLER": [], "CONSTRUCTOR": []}}, indent=1)


def _casm_worker(text: str, queue) -> None:
    """Prove a CASM contract class through the V1 arm with the JAX package;
    queues (proof bytes, public-input bytes, rows, columns, seconds)."""
    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.cairo.air import generate_cairo_proof
    from lambdaworks_cairo_prover_tpu.cairo.runner import (
        CairoVersion, generate_prover_args)
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.proof.serde import serialize_proof

    t0 = time.perf_counter()
    trace, pub = generate_prover_args(text, cairo_version=CairoVersion.V1)
    proof = generate_cairo_proof(trace, pub,
                                 ProofOptions.default_test_options())
    queue.put((serialize_proof(proof), pub.serialize(), trace.n_rows,
               len(proof.trace_ood_frame_evaluations[0]),
               time.perf_counter() - t0))


def _write_casm_fixtures(budget: float) -> None:
    text = synthetic_casm()
    with open(os.path.join(OUT_DIR, CASM_NAME), "w") as f:
        f.write(text + "\n")
    print(f"wrote {CASM_NAME}", flush=True)
    result = _in_child(_casm_worker, (text,), budget)
    if result is None:
        print(f"{CASM_PROOF_NAME}: failed or over the budget", flush=True)
        return
    proof_bytes, pub_bytes, rows, cols, seconds = result
    _write_proof_file(CASM_PROOF_NAME, proof_bytes, pub_bytes)
    print(f"wrote {CASM_PROOF_NAME}: {rows} rows x {cols} columns, proof "
          f"{len(proof_bytes)} B, {seconds:.1f} s", flush=True)


def _example_worker(air_name: str, queue) -> None:
    """Prove an example AIR as tests/test_examples.py does; queues (proof
    bytes, rows, seconds)."""
    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.air.examples import (
        dummy_air, fibonacci_2_columns, fibonacci_rap, quadratic_air)
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu.prover.prove import prove

    n = EXAMPLE_STEPS
    trace, pub, air = {
        "fibonacci_2_columns": lambda: (
            fibonacci_2_columns.fibonacci_trace_2_columns([1, 1], n),
            fibonacci_2_columns.Fibonacci2PublicInputs(a0=1, a1=1),
            fibonacci_2_columns.Fibonacci2ColsAIR),
        "quadratic_air": lambda: (
            quadratic_air.quadratic_trace(3, n),
            quadratic_air.QuadraticPublicInputs(a0=3),
            quadratic_air.QuadraticAIR),
        "fibonacci_rap": lambda: (
            fibonacci_rap.fibonacci_rap_trace([1, 1], n),
            fibonacci_rap.FibonacciRAPPublicInputs(steps=n, a0=1, a1=1),
            fibonacci_rap.FibonacciRAP),
        "dummy_air": lambda: (dummy_air.dummy_trace(n), None,
                              dummy_air.DummyAIR),
    }[air_name]()
    t0 = time.perf_counter()
    proof = prove(trace, pub, ProofOptions.default_test_options(), air)
    queue.put((serialize_proof(proof), trace.n_rows,
               time.perf_counter() - t0))


def _in_children(jobs: list, budget: float, n_jobs: int) -> list:
    """``_in_child`` for each (target, args) of ``jobs``, ``n_jobs`` at a
    time; the results in the order of ``jobs``."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max(1, n_jobs)) as pool:
        return list(pool.map(lambda job: _in_child(*job, budget), jobs))


def _write_proof_file(name: str, proof_bytes: bytes, pub_bytes: bytes) -> None:
    with open(os.path.join(OUT_DIR, name), "wb") as f:
        # the framing of proof/serde.py:write_proof_file
        f.write(len(proof_bytes).to_bytes(8, "big") + proof_bytes + pub_bytes)


def _write_program_fixtures(budget: float, n_jobs: int) -> None:
    jobs = [(_program_worker, (module, gen, gen_args, layout, False))
            for module, gen, gen_args, layout in CAIRO_PROGRAMS.values()]
    manifest = {}
    for name, result in zip(CAIRO_PROGRAMS,
                            _in_children(jobs, budget, n_jobs)):
        if result is None:
            print(f"cairo program {name}: failed or over the budget",
                  flush=True)
            continue
        proof_bytes, pub_bytes, rows, cols, seconds, gen_args = result
        module, gen, _, layout = CAIRO_PROGRAMS[name]
        file_name = f"cairo_{name}_test_options.proof"
        _write_proof_file(file_name, proof_bytes, pub_bytes)
        manifest[file_name] = {
            "program": f"cairo/{module}.py:{gen}", "args": gen_args,
            "layout": layout, "trace_rows": rows, "trace_columns": cols,
            "proof_bytes": len(proof_bytes),
            "jax_cpu_seconds": round(seconds, 1)}
        print(f"wrote {file_name}: {rows} rows x {cols} columns, proof "
              f"{len(proof_bytes)} B, {seconds:.1f} s", flush=True)
    _write_json(CAIRO_PROGRAMS_NAME, {
        "options": "default_test_options()",
        "made_by": "lambdaworks_cairo_prover_tpu (JAX) on CPU",
        "proof_files": manifest})


def _write_hinted_digest(budget: float) -> None:
    print(f"bench-options compare_lesser_array_program({HINTED_LENGTH}) "
          f"(budget {budget:.0f} s)...", flush=True)
    result = _in_child(_program_worker, (
        "stdlib", "compare_lesser_array_program", (HINTED_LENGTH,), "Small",
        True), budget)
    if result is None:
        print(f"{HINTED_DIGEST_NAME}: failed or over the budget", flush=True)
        return
    proof_bytes, pub_bytes, rows, cols, seconds, _ = result
    _write_json(HINTED_DIGEST_NAME, {
        "program": "cairo/stdlib.py:compare_lesser_array_program"
                   f"({HINTED_LENGTH})",
        "length": HINTED_LENGTH,
        "layout": "Small",
        "trace_rows": rows,
        "trace_columns": cols,
        "options": BENCH_OPTIONS,
        "sha256": hashlib.sha256(proof_bytes).hexdigest(),
        "proof_bytes": len(proof_bytes),
        "public_inputs_sha256": hashlib.sha256(pub_bytes).hexdigest(),
        "public_inputs_bytes": len(pub_bytes),
        "public_inputs_hex": pub_bytes.hex(),
        "made_by": "lambdaworks_cairo_prover_tpu (JAX) on CPU",
        "jax_cpu_seconds": round(seconds, 1),
    })


def rc_values(k: int) -> tuple:
    """The values of ``bench.py``'s rc program with ``k`` values."""
    return tuple((i * 7919 + 1) % (1 << 100) for i in range(k))


def rc_value_count(rc_program, runner, generate_prover_args,
                   log2_rows: int) -> int:
    """The value count of ``bench.py:_rc_workload(log2_rows)``: the same
    calibration (two probe runs, a linear fit aimed at 95 % of the target,
    up to four nudges), copied so that either package can run it with its
    own ``rc_program``, VM ``runner`` and ``generate_prover_args``."""
    def prepad_rows(k):
        regs, _, program_size, _ = runner(rc_program(rc_values(k)))
        return len(regs.rows) + (program_size >> 2) + 1

    t16, t64 = prepad_rows(16), prepad_rows(64)
    slope = (t64 - t16) / 48.0
    base = t16 - slope * 16
    target = 1 << log2_rows
    k = max(1, int((0.95 * target - base) / slope))
    for _ in range(4):
        trace, _ = generate_prover_args(rc_program(rc_values(k)))
        if trace.n_rows == target:
            break
        k = max(1, int(k * (0.7 if trace.n_rows > target else 1.4)))
    return k


def _rc_worker(log2_rows: int, queue) -> None:
    """Calibrate and prove bench.py's rc program with the JAX package;
    queues (proof bytes, public-input bytes, rows, columns, seconds, k)."""
    sys.path.insert(0, ROOT)
    from lambdaworks_cairo_prover_tpu.cairo import native as native_vm
    from lambdaworks_cairo_prover_tpu.cairo.air import generate_cairo_proof
    from lambdaworks_cairo_prover_tpu.cairo.programs import rc_program
    from lambdaworks_cairo_prover_tpu.cairo.runner import generate_prover_args
    from lambdaworks_cairo_prover_tpu.cairo.vm import run_program
    from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu.proof.serde import serialize_proof

    runner = (native_vm.run_program_native if native_vm.available()
              else run_program)
    t0 = time.perf_counter()
    k = rc_value_count(rc_program, runner, generate_prover_args, log2_rows)
    trace, pub = generate_prover_args(rc_program(rc_values(k)))
    proof = generate_cairo_proof(trace, pub, ProofOptions(**BENCH_OPTIONS))
    queue.put((serialize_proof(proof), pub.serialize(), trace.n_rows,
               len(proof.trace_ood_frame_evaluations[0]),
               time.perf_counter() - t0, k))


def _write_rc_digest(budget: float) -> None:
    print(f"bench-options rc program at 2^{RC_LOG_ROWS} rows "
          f"(budget {budget:.0f} s)...", flush=True)
    result = _in_child(_rc_worker, (RC_LOG_ROWS,), budget)
    if result is None:
        print(f"{RC_DIGEST_NAME}: failed or over the budget", flush=True)
        return
    proof_bytes, pub_bytes, rows, cols, seconds, k = result
    _write_json(RC_DIGEST_NAME, {
        "program": "cairo/programs.py:rc_program(tools/make_torch_fixtures.py"
                   ":rc_values(k)), k from rc_value_count (bench.py:"
                   "_rc_workload)",
        "log2_rows": RC_LOG_ROWS,
        "k": k,
        "layout": "Small",
        "trace_rows": rows,
        "trace_columns": cols,
        "options": BENCH_OPTIONS,
        "sha256": hashlib.sha256(proof_bytes).hexdigest(),
        "proof_bytes": len(proof_bytes),
        "public_inputs_sha256": hashlib.sha256(pub_bytes).hexdigest(),
        "public_inputs_bytes": len(pub_bytes),
        "made_by": "lambdaworks_cairo_prover_tpu (JAX) on CPU",
        "jax_cpu_seconds": round(seconds, 1),
    })


def _write_example_fixtures(budget: float, n_jobs: int) -> None:
    results = _in_children([(_example_worker, (air,)) for air in EXAMPLES],
                           budget, n_jobs)
    for air, result in zip(EXAMPLES, results):
        name = f"example_{air}_test_options.proof"
        if result is None:
            print(f"{name}: failed or over the budget", flush=True)
            continue
        proof_bytes, rows, seconds = result
        with open(os.path.join(OUT_DIR, name), "wb") as f:
            f.write(proof_bytes)
        print(f"wrote {name}: {rows} rows, proof {len(proof_bytes)} B, "
              f"{seconds:.1f} s", flush=True)


def _write_cairo_fixtures(budget: float, fibs: list[int]) -> None:
    for name, (generator, gen_args) in CAIRO_SMALL.items():
        result = _in_child(_program_worker, (
            "programs", generator, gen_args, "Small", False), budget)
        if result is None:
            print(f"{name}: failed or over the budget", flush=True)
            continue
        proof_bytes, pub_bytes, rows, cols, seconds, _ = result
        _write_proof_file(name, proof_bytes, pub_bytes)
        print(f"wrote {name}: {rows} rows x {cols} columns, proof "
              f"{len(proof_bytes)} B, {seconds:.1f} s", flush=True)

    not_proved = {}
    for n in fibs:
        print(f"bench-options Cairo fibonacci_program({n}) "
              f"(budget {budget:.0f} s)...", flush=True)
        result = _in_child(_program_worker, (
            "programs", "fibonacci_program", (n,), "Small", True), budget)
        if result is None:
            print(f"  fib({n}): failed or did not finish within the budget",
                  flush=True)
            not_proved[str(n)] = f"failed or over the {budget:.0f} s budget"
            continue
        proof_bytes, pub_bytes, rows, cols, seconds, _ = result
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
    print("no bench-options Cairo program finished within the budget",
          flush=True)


PARTS = ("small", "bench", "fused", "butterfly2", "cairo", "examples",
         "programs", "casm", "hinted", "rc", "toy", "fri_chain", "four_step")


def _write_bench_digest(budget: float, logs: list[int]) -> None:
    not_proved = {}
    for log_n in logs:
        print(f"bench-options prove at 2^{log_n} rows "
              f"(budget {budget:.0f} s)...", flush=True)
        result = _in_child(_bench_worker, (log_n,), budget)
        if result is None:
            print(f"  2^{log_n}: failed or did not finish within the budget",
                  flush=True)
            not_proved[str(1 << log_n)] = (
                f"failed or over the {budget:.0f} s budget")
            continue
        digest, size, seconds = result
        _write_json(DIGEST_NAME, {
            "air": "simple_fibonacci",
            "initial_values": [1, 1],
            "trace_length": 1 << log_n,
            "options": BENCH_OPTIONS,
            "sha256": digest,
            "proof_bytes": size,
            "made_by": "lambdaworks_cairo_prover_tpu (JAX) on CPU",
            "jax_cpu_seconds": round(seconds, 1),
            "larger_sizes_not_proved": not_proved,
        })
        return
    print("no bench-options size finished within the budget", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget", type=float, default=900.0,
                    help="seconds allowed for each proof or digest run")
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS,
                    help="the parts to write (default: all)")
    ap.add_argument("--logs", type=int, nargs="+", default=[19, 18, 17, 16],
                    help="log2 trace lengths to try for the simple_fibonacci "
                    "digest, largest first")
    ap.add_argument("--cairo-fibs", type=int, nargs="+",
                    default=[8000, 2000, 500],
                    help="n of fibonacci_program(n) to try for the Cairo "
                    "digest, largest first")
    ap.add_argument("--jobs", type=int, default=1,
                    help="child processes at once for the small proofs")
    args = ap.parse_args()
    os.makedirs(OUT_DIR, exist_ok=True)
    parts = set(args.only)

    if "small" in parts:
        data = _prove_bytes(10, bench=False)
        with open(os.path.join(OUT_DIR, SMALL_NAME), "wb") as f:
            f.write(data)
        print(f"wrote {SMALL_NAME}: {len(data)} bytes", flush=True)
    if "bench" in parts:
        _write_bench_digest(args.budget, args.logs)
    if "fused" in parts:
        _write_json(FUSED_NAME, _in_child(_fused_worker, (), args.budget))
    if "butterfly2" in parts:
        _write_json(BUTTERFLY2_NAME,
                    _in_child(_butterfly2_worker, (), args.budget))
    if "cairo" in parts:
        _write_cairo_fixtures(args.budget, args.cairo_fibs)
    if "examples" in parts:
        _write_example_fixtures(args.budget, args.jobs)
    if "programs" in parts:
        _write_program_fixtures(args.budget, args.jobs)
    if "casm" in parts:
        _write_casm_fixtures(args.budget)
    if "hinted" in parts:
        _write_hinted_digest(args.budget)
    if "rc" in parts:
        _write_rc_digest(args.budget)
    if "toy" in parts:
        data = _in_child(_toy_worker, (), args.budget)
        if data is None:
            print(f"{TOY_NAME}: failed or over the budget", flush=True)
        else:
            with open(os.path.join(OUT_DIR, TOY_NAME), "wb") as f:
                f.write(data)
            print(f"wrote {TOY_NAME}: {len(data)} bytes", flush=True)
    if "fri_chain" in parts:
        _write_json(FRI_CHAIN_NAME, _in_child(_fri_chain_worker, (),
                                              args.budget))
    if "four_step" in parts:
        _write_json(FOUR_STEP_NAME, _in_child(_four_step_worker, (),
                                              args.budget))


if __name__ == "__main__":
    main()
