#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card: name and power limit (nvidia-smi), CUDA version;
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, exactly
     (H1 mont_mul, H2 add_sub_mod, H3 ntt_dif_stages, H4 ntt_dif_local), at
     the shapes of both real-size runs below: one 2^21-point column, and
     the Cairo run's stacks of 15 and 8 columns (H1, H2) and of 34 and 18
     columns (H3, H4) of 2^21 points; H1 and H2 with each operand as limbs
     and as packed words (views cut as the prover cuts them) into both
     output layouts, timed in both layouts.  H3 and H4: every pass of the
     transforms those runs make (2^21 and 2^19 points at 1, 34 and 18
     columns, 2^22 at one), H3 in place and out of place, and at 2^21 also
     one stage alone and H4 on 2^10-point chunks in place; and the whole
     NTT at 2^4 .. 2^22, forward and inverse, alone and with a batch of 3;
     then the Keccak-256 kernels (``[keccak]``), bit for bit: K1
     keccak_rows at (16, c, 2^21) for c = 61, 43, 34, 18 in the row-leaf
     layout, the composition's 2 columns and the FRI's single-felt leaves
     at 2^21 and 2^20; K2 keccak_pairs on the tree over n leaves at every
     n = 2^0 .. 2^21 (one launch a tree, timed beside a launch a level)
     and at one pair; K3 keccak_grind at batches of 2^20 nonces, also
     against the host's leading_zeros_of_nonce; their registers (no
     spill) and SASS, whose 32-bit integer instructions a permutation set
     their bound;
     then the scans (``[scan]``), bit for bit: H5 mont_batch_inverse and H6
     mont_prefix_product at the proves' shapes (2^21, 3 * 2^19 and 3 * 2^21
     elements, H5 also at 3 * 2^23, H6 at 2^23, both at 1 and 2^16) with
     zeros planted, at small and ragged sizes and on all zeros, H6 with
     its first tiles zero and in 100 calls back to back, and against Python
     ints on a sample; timed beside the chunked loop over H1 that they
     replaced;
     then K4 fri_tail (``[fri-tail]``) at the FRI tails of LDEs of 2^21 and
     2^23 points (ten layers from 4,096 points), launched under
     torch.cuda.set_sync_debug_mode("error"), against its plain version on
     the CPU bit for bit and the host route's last value, at every cluster
     size, timed beside its bounds and the host route it replaces;
  4. simple_fibonacci proofs against the JAX package's fixtures: 2^10 rows
     with test options (equal bytes) and, where the fixture has a digest,
     its size with the bench options (equal sha256);
  5. the first slice's real-size run: simple_fibonacci at 2^19 rows, blowup
     4, 80 FRI queries, coset offset 3, grinding 20 — prove cold and warm,
     verify, and check that every kernel was launched on the way (but H6:
     this AIR has no RAP trace);
  6. Cairo proofs against the JAX package's fixtures: fibonacci_program(5)
     and rc_program with test options (equal proof files), and the Cairo
     fibonacci with the bench options whose JAX digest is recorded;
  7. the device RAP (auxiliary trace) build against the host oracle at 2^12
     rows: equal limbs;
  8. the Cairo real-size run: generate_prover_args(fibonacci_program(70000))
     -> generate_cairo_proof with the bench options (2^19 rows x 52 columns),
     cold and warm, -> verify_cairo_proof; every kernel must be launched,
     H1 fewer than 600 times in the cold prove; no fd.unpack or fd.pack
     call inside round 2, DEEP's evaluations or the OOD dot products of the
     warm prove;
     then the FRI commit routes (``[fri-routes]``): a warm prove whose
     on-device FRI chain and K4 run under
     torch.cuda.set_sync_debug_mode("error") (no host sync before its one
     readback; K4 once, no FRI layer folded on the host), the chain with
     the host tail (ten layers on the host), the full chain, and the
     per-layer route (a DefaultTranscript subclass), all byte-equal;
     round4_fri_commit and the launches of each; its peak memory must stay
     below the unpacked layout's 30.85 GiB;
  9. the memory layout at scale (``[memory]``): Cairo
     fibonacci_program(280000), 2^21 rows x 52 columns (an LDE of 2^23
     points) with the bench options, one cold prove with donate_trace=True
     and LCP_DEBUG_MEM=1 (the per-phase memory lines), verified, every
     kernel launched, its peak printed; then H3/H4 against their plain
     versions on one 2^23-point column, every pass of ntt_passes(23);
 10. programs with builtins and hints (``[cairo-hints]``): the proof files
     of the nine programs of tests/fixtures/torch_port/cairo_programs.json
     (output, bitwise, pedersen, ecdsa, keccak, poseidon, lt_comparison,
     signed_div_rem, compare_lesser_array(10)) and of the synthetic CASM
     contract (the Cairo1 arm) with test options, equal to the JAX
     package's; a hinted extra, compare_lesser_array_program(1200) with the
     bench options (2^16 rows x 61 columns), at the JAX package's sha256;
     and the slice's real-size run, compare_lesser_array_program(9600) on
     the python VM with hints, alloc and the range-check builtin (2^19 rows
     x 61 columns, bench options), cold and warm, verified; every kernel
     must be launched; the FRI commit routes as in phase 8;
 11. bench.py's rc workload (``BASELINE`` config 3): rc_program with the
     value count that bench.py's calibration loop (copied into
     tools/make_torch_fixtures.py) finds for 2^16 rows, bench options, at
     the JAX package's sha256
     (tests/fixtures/torch_port/cairo_rc_bench_digest.json);
 12. the toy field: a child process with LCP_FIELD=f257 proves
     simple_fibonacci at 8 rows on the card, byte-equal to the JAX
     package's GF(257) proof, verifies it, launches none of H1-H6 and
     launches K1 and K2 (Keccak does not depend on the field);
 13. the command line once on the card (prove_and_verify, a child process);
 14. the multi-device prover (``[parallel]``): Cairo fib(70000) with the
     bench options on a one-rank NCCL mesh (``prove(mesh=...)``,
     shard_axis "domain"), cold and warm, at the single-device sha256,
     verified, every kernel launched; 4 gloo ranks sharing the card (child
     processes) prove Cairo fib(5) with test options and simple_fibonacci
     at the fixture's 2^16 rows with the bench options, each equal to the
     JAX package's bytes, with H1, H3/H4, K1 and K2 launched on every rank
     (K3 where the options grind on the card); H3/H4
     against their plain versions at the local shapes of a 2^21-point,
     52-column four-step transform over 4 ranks, (16, 52, 256, 2048) and
     (16, 52, 512, 1024); ``BASELINE`` config 4's layout: the synthetic
     Cairo1 contract (synthetic_contract.casm) with shard_axis "columns",
     on the one NCCL rank with the bench options equal to the single-device
     proof file (K3 launched), on the 4 gloo ranks with test options equal
     to the JAX package's;
 15. ``BASELINE`` config 5 (``[scale]``, tools/config5_scale_torch.py):
     simple_fibonacci at 2^22 rows with the bench options, single-device
     and on a one-rank NCCL mesh, cold and warm, verified, the four proofs
     equal, H1-H5 and K1-K3 launched; at 2^23 rows single-device (the
     composition's LDE of 2^26 points, past the NTT's old 2^24 cap),
     verified, its peak and per-phase memory; the whole NTT at 2^24, 2^25
     and 2^26 points forward and inverse, K2's tree over 2^22 .. 2^25
     leaves, K1's single-felt leaves at 2^24 and 2^25 points and H5 at the
     2^23-row prove's DEEP input (2^27 elements, zeros planted) against
     their plain versions, bit for bit; 4 gloo ranks sharing the card at
     2^22 rows (the tool's children), every rank's proof equal to the
     single-device proof, H1, H3/H4, K1 and K2 launched on every rank, the
     collective bytes by site.

The line before the last is a JSON object with, for each kernel, its launch
count in phase 10's cold prove (and under ``launches_cairo_fib`` in phase 8,
``launches_memory`` in phase 9 and ``launches_simple_fibonacci`` in phase 5), its largest disagreement with the plain
version, its time against the plain version's and the least time the card
could take, at the Cairo run's widest shape (and under ``one_column`` at
the one-column shape of phase 5; H1 and H2 on packed operands into a packed
result, their limb layout's times under ``limbs``), H3 at its widest pass, H4 at the last
pass of the 2^21 transform (and under ``ten_stages`` at 10 stages in
place), the whole 2^21 transform under ``whole_ntt``, H3/H4 at the
four-step's shapes under ``four_step``, the launches of phase 14's
one-rank prove under ``launches_parallel`` (its columns-sharded Cairo1
prove under ``launches_parallel_columns``), phase 15's 2^22-row cold
single-device prove under ``launches_scale`` and its kernel records under
``scale``; the last line is
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
CASM_PATH = os.path.join(FIXTURES, "synthetic_contract.casm")
PKG = "lambdaworks_cairo_prover_tpu_torch"
SEED = 20260516
FULL_LOG = 19          # the real-size run
LDE_LOG = FULL_LOG + 2  # its LDE: the main path's largest kernel shapes
COMPOSITION_LOG = FULL_LOG + 3  # the LDE of a composition half: 2^22 points
MULADD_LOG = 20         # H1 / H2 comparison size
NTT_LOGS = (4, 10, 11, 12, 17, FULL_LOG, LDE_LOG, COMPOSITION_LOG)
BENCH = dict(blowup_factor=4, fri_number_of_queries=80, coset_offset=3,
             grinding_factor=20)
CAIRO_FIB_N = 70000     # the Cairo real-size run: 2^19 rows x 52 columns
# the size of that proof with the bench options (it depends on the trace
# shape and the options alone; bench.py of the JAX package records the same)
CAIRO_FIB_PROOF_BYTES = 1_601_016
CAIRO_FIB_MAX_H1 = 600  # H1 launches of its cold prove, at most
CAIRO_AUX_FIB_N = 500   # 2^12 rows for the RAP build against the host oracle
CAIRO_MAIN_COLS = 34    # columns that one NTT launch carries on that run
CAIRO_AUX_COLS = 18
CAIRO_FLAG_COLS = 15    # the instruction flags, stacked by the constraints
HINTS_LENGTH = 9600     # compare_lesser_array_program: 518,443 steps, 2^19 rows
HINTS_MAIN_COLS = 43    # 34 + 9 of the range-check builtin: one NTT launch
HINTS_COLS = 61         # 43 main (34 + 9 range-check) + 18 auxiliary
RC_VALUES = (250, 77, 1 << 100)
RC_LOG_ROWS = 16        # bench.py's rc workload: 2^16 rows
TOY_ROWS = 8            # simple_fibonacci over GF(257): an LDE of 32 points
# the single-device proof of fibonacci_program(CAIRO_FIB_N), bench options
CAIRO_FIB_SHA256 = ("ac3aa66d80cb107e6ad4457dd9db69d0e11dc6332e4fdb0c9aaef95e"
                    "2100dc04")
CAIRO_COLS = 52         # 34 main + 18 auxiliary columns of that run
# the peak of [cairo-full]'s cold prove before the packed resident layout
# (30.85 GiB, NVIDIA H100 80GB HBM3 at 700 W): the layout must stay below it
CAIRO_FIB_UNPACKED_PEAK = 33_126_153_216
MEMORY_FIB_N = 280000   # [memory]: about 1.68 M steps, 2^21 rows x 52 columns
MEMORY_LOG = 21         # its rows; its LDE has 2^23 points
PARALLEL_RANKS = 4      # gloo ranks that share the one card in [parallel]
SCALE_LOG = 22          # [scale]: BASELINE config 5's 2^22 rows, LDE 2^24
SCALE_BIG_LOG = 23      # single-device, its composition LDE 2^26 points
SCALE_GLOO_LOG = 22     # 4 gloo ranks through tools/config5_scale_torch.py,
                        # BASELINE's own rows: 30.4 s at 2^20 and 38.5 s at
                        # 2^21 with the processes' start (H100 80GB HBM3, 700 W)
SCALE_NTT_LOGS = (24, 25, 26)  # the whole NTT past the old 2^24 cap
# K2's tree and K1's single-felt leaves at the new sizes, up to the largest
# the 2^23-row prove builds (2^25 leaves: its LDE)
SCALE_TREE_LOGS = tuple(range(SCALE_LOG, SCALE_BIG_LOG + 3))
SCALE_LEAF_LOGS = (SCALE_LOG + 2, SCALE_BIG_LOG + 2)
# DEEP's batch inverse at 2^23 rows: 3 frame offsets and z^2, 2^25 points each
SCALE_DEEP_N = 4 << (SCALE_BIG_LOG + 2)
# [fri-tail]: K4 at the FRI tails of the benchmark cells' LDEs (2^21 and 2^23
# points: both ten layers from 4,096 points, 2,048 coefficients in)
FRI_TAIL_LDE_LOGS = (LDE_LOG, MEMORY_LOG + 2)
FRI_TAIL_REPS = 50
FRI_TAIL_CLUSTERS = (1, 2, 4, 8, 16)  # K4's blocks a cluster, each timed

# The card's peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of HBM and 67
# TFLOP/s of float32 outside the tensor cores, i.e. 33.5e12 FMA instructions
# a second on 128 lanes per SM.  An SM has half as many int32 lanes, so the
# peak for 32-bit integer instructions is 16.75e12 a second; a multiply-add
# of 32 x 32 + 64 -> 64 bits (mad.wide.u32, IMAD.WIDE) is one of them.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2
# 32-bit integer instructions that one operation on 8-word elements needs at
# the least.  A Montgomery product is 64 + 8 wide multiply-adds (a * b, and
# m * 17 in each of the 8 reductions) and an 8-word subtraction at the end;
# an addition or subtraction mod p is an 8-word add and an 8-word
# compare-and-subtract.  A DIF butterfly is an addition, a subtraction and,
# unless its twiddle is one, a product (butterfly_ops).
OPS_MUL = 64 + 8 + 8
OPS_ADD = 16
ELEM_BYTES = 64  # 16 int32 limb words
PACKED_BYTES = 32  # 8 int32 words of two limbs each
TWIDDLE_BYTES = 32  # an entry of the packed table the NTT kernels read


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least milliseconds the card could take: the larger of bytes over
    the memory rate and integer instructions over their peak rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_ms": by_bytes, "operations_ms": by_ops}


def bound_text(rec: dict) -> str:
    return (f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} (bytes "
            f"{rec['bytes_ms']:.4f}, operations {rec['operations_ms']:.4f}), "
            f"share {rec['bound_ms'] / rec['ms']:.3f}")


def butterfly_ops(n_points: int, log_m_hi: int, n_stages: int) -> int:
    """Instructions that the DIF stages of half-size 2^log_m_hi ..
    2^(log_m_hi - n_stages + 1) over n_points need at the least: n_points / 2
    butterflies a stage, less the products by a twiddle of one (all of the
    stage m = 1, half of the stage m = 2)."""
    pairs = n_points // 2
    products = 0
    for log_m in range(log_m_hi, log_m_hi - n_stages, -1):
        products += pairs if log_m > 1 else pairs // 2 * log_m
    return 2 * OPS_ADD * n_stages * pairs + OPS_MUL * products


def keccak_blocks(n_cols: int) -> int:
    """Keccak-f permutations that a row of n_cols felts takes: its 32-byte
    encodings and the padding, 136 bytes a block."""
    return 32 * n_cols // 136 + 1


def sass_counts(binary: str) -> dict:
    """Function name -> (instructions, Counter of opcodes) from cuobjdump."""
    import collections
    import re

    from lambdaworks_cairo_prover_tpu_torch import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", binary], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", line)
        if m and name:
            out[name][m.group(1).split(".")[0]] += 1
    return {k: (sum(c.values()), c) for k, c in out.items()}


# SASS opcodes that are not 32-bit integer work of a thread: memory,
# control, special registers (the uniform datapath's U* ops run beside)
NOT_INT_OPS = {"LDG", "STG", "LD", "ST", "LDC", "LDS", "STS", "ATOM", "ATOMG",
               "RED", "EXIT", "BRA", "RET", "NOP", "BSSY", "BSYNC", "BAR",
               "S2R", "CS2R", "CALL", "YIELD", "WARPSYNC", "MEMBAR"}


def ptxas_report(log: str) -> dict:
    """Function -> registers, stack frame and spill bytes, from the build's
    ``-Xptxas=-v`` lines."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, reps: int, warm_up: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after a warm-up
    unless the caller has run ``fn`` before and one run takes seconds)."""
    if warm_up:
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


def graph_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Milliseconds of one call of ``fn``: a CUDA graph of ``reps`` calls,
    replayed once to warm up and then ``replays`` times, the median replay
    over ``reps``.  The card's time for the kernels without the host's time
    to launch them (a wrapper that takes longer to call than its kernel
    takes to run leaves the card idle between launches otherwise)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[replays // 2]


def timed(torch, fn) -> tuple:
    """(result, milliseconds on the card) of one call of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def random_columns(torch, cols: int, n: int, device):
    """Seeded canonical random elements made on the card, (16, cols, n), with
    0, 1 and p-1 as the last three elements of every column."""
    from lambdaworks_cairo_prover_tpu_torch.field.params import P, N_LIMBS

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x = torch.randint(0, 1 << 16, (N_LIMBS, cols, n), dtype=torch.int32,
                      device=device, generator=gen)
    x[N_LIMBS - 1] &= 0x7FF
    x[:, :, -3:-1] = 0
    x[0, :, -2] = 1
    for k in range(N_LIMBS):
        x[k, :, -1] = ((P - 1) >> (16 * k)) & 0xFFFF
    return x


def layout_errs(torch, cf, x, y, px=None, py=None,
                by_columns: bool = False) -> dict:
    """H1 and H2 on (16, ...) limb operands x and y, each handed over in both
    layouts (limbs, and packed: px and py, views of a packed tensor cut as x
    and y are, or else cf.pack_words of them), into both output layouts,
    against the plain versions: {kernel: largest |difference|} over the
    limbs.  The plain result is computed once an op (one column at a time
    with ``by_columns``, which bounds its int64 temporaries)."""
    errs = {"mont_mul": 0, "add_sub_mod": 0}
    px = cf.pack_words(x) if px is None else px
    py = cf.pack_words(y) if py is None else py
    cols = torch.broadcast_shapes(x.shape[1:], y.shape[1:])[0]
    for name, op, plain in (("mont_mul", None, cf.mul_plain),
                            ("add_sub_mod", "add", cf.add_plain),
                            ("add_sub_mod", "sub", cf.sub_plain)):
        want = (torch.cat([plain(*[t if t.shape[1] == 1 else t[:, c:c + 1]
                                   for t in (x, y)]) for c in range(cols)],
                          dim=1) if by_columns else plain(x, y))
        for xx in (x, px):
            for yy in (y, py):
                for packed in (False, True):
                    got = (cf.mont_mul(xx, yy, packed) if op is None
                           else cf.add_sub_mod(xx, yy, op, packed))
                    if packed:
                        got = cf.unpack_words(got)
                    errs[name] = max(errs[name], max_abs_err(torch, got, want))
    return errs


def shape_text(*tensors) -> str:
    return " x ".join(str(tuple(t.shape)) for t in tensors)


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


class NttChecks:
    """H3 and H4 against their plain versions, and their times, on the
    (16, cols, n) tensors that the transforms of both real-size runs hand
    them: every pass of ``ntt_passes`` for that n."""

    def __init__(self, torch, dev, max_log: int = max(NTT_LOGS)):
        from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

        self.torch, self.cn = torch, cn
        # a smaller transform reads a prefix of the tables
        self.tw = cn.twiddle_table(max_log, False, dev)
        self.twp = cn.packed_twiddle_table(max_log, False, dev)
        self.plain_ms = {}  # (kernel, first stage, stages, natural, shape) -> ms

    def cases(self, log_n: int) -> list:
        """(kernel, first stage, stages, natural-order output): the passes of
        a 2^log_n-point transform; at 2^LDE_LOG also one stage alone through
        H3 and a 2^LOCAL_LOG-point chunk through H4, both left in the DIF's
        order."""
        cn = self.cn
        cases = [("ntt_dif_local" if p.local else "ntt_dif_stages", p.log_m_hi,
                  p.n_stages, p.natural) for p in cn.ntt_passes(log_n)]
        if log_n == LDE_LOG:
            cases += [("ntt_dif_stages", log_n - 6, 1, False),
                      ("ntt_dif_local", cn.LOCAL_LOG - 1, cn.LOCAL_LOG, False)]
        return cases

    def compare(self, xs, *narrower) -> dict:
        """Largest disagreement of every case on xs, and on each of
        ``narrower`` (tensors that hold the first columns of xs: one launch
        carries them as the path does, and a column's plain result serves
        all): out of place and, but for the natural-order output, in place.
        The plain version goes column by column, which bounds its int64
        temporaries; its time on each stack (the sum over that stack's
        columns) is kept for :meth:`times`."""
        torch, cn, tw, twp = self.torch, self.cn, self.tw, self.twp
        log_n = xs.shape[2].bit_length() - 1
        cn.bitrev_indices(log_n, xs.device)  # built outside the plain times
        errs = {"ntt_dif_stages": 0, "ntt_dif_local": 0}
        for name, hi, r, natural in self.cases(log_n):
            if name == "ntt_dif_stages":
                def run(src, dst):
                    return cn.ntt_dif_stages(src, dst, twp, hi, r)

                def plain(col):
                    return cn.dif_stages_plain(col, tw, hi, r)
            else:
                def run(src, dst):
                    return cn.ntt_dif_local(src, dst, twp, r, natural)

                def plain(col):
                    return cn.dif_local_plain(col, tw, r, natural)
            got = []
            for t in (xs,) + narrower:
                got.append(run(t, torch.empty_like(t)))
                if not natural:
                    work = t.clone()
                    got.append(run(work, work))
            col_ms = []
            for c in range(xs.shape[1]):
                want, t = timed(torch, lambda: plain(xs[:, c:c + 1]))
                col_ms.append(t)
                errs[name] = max(errs[name], *[
                    max_abs_err(torch, g[:, c:c + 1], want)
                    for g in got if c < g.shape[1]])
            for t in (xs,) + narrower:
                self.plain_ms[(name, hi, r, natural, shape_text(t))] = sum(
                    col_ms[:t.shape[1]])
        log(f"[kernels] (kernel, first stage, stages, natural order) "
            f"{self.cases(log_n)} vs plain at "
            f"{', '.join(shape_text(t) for t in (xs,) + narrower)}, out of "
            f"place and (but for natural order) in place: max_abs_err "
            f"{errs['ntt_dif_stages']}, {errs['ntt_dif_local']}")
        require(not any(errs.values()), "an NTT kernel disagrees with its "
                f"plain version at {shape_text(xs)} or a narrower stack")
        return errs

    def times(self, xs) -> dict:
        """H3 at its widest pass (the first), H4 at the transform's last pass
        and, under ``ten_stages``, at 2^LOCAL_LOG-point chunks in place; the
        plain versions' times are those of :meth:`compare` on xs."""
        torch, cn, twp = self.torch, self.cn, self.twp
        n_points = xs[0].numel()
        log_n = xs.shape[2].bit_length() - 1
        work, other = xs.clone(), torch.empty_like(xs)
        reps = 20 if xs.shape[1] == 1 else 10
        first, last = cn.ntt_passes(log_n)[0], cn.ntt_passes(log_n)[-1]
        hi, r = first.log_m_hi, first.n_stages

        def h4(stages, natural):
            dst = other if natural else work
            return {
                "n_stages": stages, "natural": natural,
                "ms": cuda_ms(torch, lambda: cn.ntt_dif_local(
                    work, dst, twp, stages, natural), reps),
                "plain_ms": self.plain_ms[("ntt_dif_local", stages - 1, stages,
                                           natural, shape_text(xs))],
                # the array read and written once, 2^stages twiddles read once
                **bound(2 * ELEM_BYTES * n_points + TWIDDLE_BYTES * (1 << stages),
                        butterfly_ops(n_points, stages - 1, stages))}

        return {
            "ntt_dif_stages": {
                "shape": shape_text(xs), "log_m_hi": hi, "n_stages": r,
                "ms": cuda_ms(torch, lambda: cn.ntt_dif_stages(
                    work, work, twp, hi, r), reps),
                "plain_ms": self.plain_ms[
                    ("ntt_dif_stages", hi, r, False, shape_text(xs))],
                # the array read and written once, the twiddles of the r
                # stages (2^(hi+1) - 2^(hi+1-r) entries) read once
                **bound(2 * ELEM_BYTES * n_points + TWIDDLE_BYTES *
                        ((1 << (hi + 1)) - (1 << (hi + 1 - r))),
                        butterfly_ops(n_points, hi, r))},
            "ntt_dif_local": {"shape": shape_text(xs),
                              **h4(last.n_stages, True),
                              "ten_stages": h4(cn.LOCAL_LOG, False)},
        }


def phase_kernels(torch, dev) -> dict:
    """Kernels against plain versions; returns per-kernel error and times."""
    import numpy as np
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.field.params import P
    from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
    from lambdaworks_cairo_prover_tpu_torch.prover.kernels import _COL_CHUNK

    rng = np.random.default_rng(SEED)
    out = {}

    # H1 / H2 on 2^20 elements + edges, plain shapes and broadcasts
    a = random_limbs(torch, rng, (1 << MULADD_LOG,), dev)
    b = random_limbs(torch, rng, (1 << MULADD_LOG,), dev)
    s = a[:, 5:6].contiguous()
    a2 = a[:, :1 << MULADD_LOG].reshape(16, 4, 1 << (MULADD_LOG - 2))
    col = b[:, :4].reshape(16, 4, 1).contiguous()
    errs = {"mont_mul": 0, "add_sub_mod": 0}
    # operands whose 32-bit words are each 0, 1, 2^31 or 2^32 - 1 (the top word
    # 0, so they stay below p): the kernels' carry chains at their edges
    pick = torch.randint(0, 4, (8, 1 << 14), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(SEED))
    pick[7] = 0
    sparse = torch.empty((16, 1 << 14), dtype=torch.int32, device=dev)
    sparse[0::2] = torch.tensor([0, 1, 0, 0xFFFF], dtype=torch.int32, device=dev)[pick]
    sparse[1::2] = torch.tensor([0, 0, 0x8000, 0xFFFF], dtype=torch.int32, device=dev)[pick]
    # 2^17 points cut from 4 columns: two runs, read in place (the limbs
    # with a row stride of 2^20 + 3, the packed words 16-byte aligned)
    cut = (slice(None), slice(None), slice(8, 8 + (1 << 17)))
    a4, pa4 = a2[cut], cf.pack_words(a2)[cut]
    cases = [(a, b), (a, s), (s, b), (a2, col), (col, a2), (a2, a2[:, 1:2]),
             (sparse, sparse.flip(1)), (sparse, a[:, :1 << 14]),
             (a4, col, pa4), (a4, a2[:, 1:2, :1 << 17], pa4)]
    for x, y, *packed in cases:
        for name, e in layout_errs(torch, cf, x, y, *packed).items():
            errs[name] = max(errs[name], e)
    # spot-check against python ints as well
    xs, ys = fd.to_ints(a[:, -8:]), fd.to_ints(b[:, -8:])
    require(fd.to_ints(cf.mont_mul(a[:, -8:], b[:, -8:])) ==
            [x * y % P for x, y in zip(xs, ys)], "mont_mul != python ints")
    for name, e in errs.items():
        log(f"[kernels] {name} vs plain at 2^{MULADD_LOG}+3 (and broadcasts), "
            f"every layout pair and output layout: max_abs_err {e}")
        require(e == 0, f"{name} disagrees with its plain version")

    # the simple_fibonacci path's shape: one (16, 2^21) LDE-sized operand pair
    lde = 1 << LDE_LOG
    big_a = random_limbs(torch, rng, (lde,), dev)[:, :lde].contiguous()
    big_b = random_limbs(torch, rng, (lde,), dev)[:, :lde].contiguous()
    pa, pb = cf.pack_words(big_a), cf.pack_words(big_b)
    one, limb_recs = {}, {"mont_mul": {}, "add_sub_mod": {}}
    for x, y, elem, recs in ((pa, pb, PACKED_BYTES, one),
                             (big_a, big_b, ELEM_BYTES, None)):
        # two operands read, one result written (the operands' layout); one
        # product or difference per element
        for name, launch, plain, ops in (
                ("mont_mul", lambda: cf.mont_mul(x, y),
                 lambda: cf.mul_plain(x, y), OPS_MUL),
                ("add_sub_mod", lambda: cf.add_sub_mod(x, y, "sub"),
                 lambda: cf.sub_plain(x, y), OPS_ADD)):
            rec = {"shape": shape_text(x, y), "ms": graph_ms(torch, launch, 20),
                   "plain_ms": cuda_ms(torch, plain, 3),
                   **bound(3 * elem * lde, ops * lde)}
            if recs is None:
                limb_recs[name]["one_column"] = rec
            else:
                recs[name] = rec
    del pa, pb

    # H3 / H4 at one 2^21-point column
    x = big_a.reshape(16, 1, lde)
    ntt = NttChecks(torch, dev)
    errs.update(ntt.compare(x))
    one.update(ntt.times(x))

    # The Cairo path's shapes.  The constraint and DEEP code hands H1 / H2
    # the 15 stacked flag columns, or a slice of _COL_CHUNK LDE columns,
    # against per-column constants, one shared row, or another stack; one NTT
    # launch of H3 / H4 carries all main LDE columns (43 with the
    # range-check builtin, 34 without) or the 18 auxiliary ones.
    hints_wide = random_columns(torch, HINTS_MAIN_COLS, lde, dev)
    wide = hints_wide[:, :CAIRO_MAIN_COLS].contiguous()
    flags = wide[:, :CAIRO_FLAG_COLS].contiguous()
    chunk = wide[:, _COL_CHUNK:2 * _COL_CHUNK]  # a view, as deep_poly slices
    row = wide[:, -1:]
    consts = wide[:, :CAIRO_FLAG_COLS, 7:8].contiguous()
    pairs = [(flags, consts), (flags, row),
             (flags, wide[:, CAIRO_FLAG_COLS:2 * CAIRO_FLAG_COLS]),
             (chunk, consts[:, :_COL_CHUNK]), (chunk, row),
             (chunk, wide[:, :_COL_CHUNK]), (row, consts[:, :_COL_CHUNK])]
    # the packed views as DEEP cuts them from the LDE: _COL_CHUNK columns, and
    # a chunk of 2^20 of their points
    pwide = cf.pack_words(wide)
    pairs = [(u, v, pwide[:, _COL_CHUNK:2 * _COL_CHUNK] if u is chunk else None)
             for u, v in pairs]
    pairs.append((wide[:, :_COL_CHUNK, 1 << 20:], consts[:, :_COL_CHUNK],
                  pwide[:, :_COL_CHUNK, 1 << 20:]))
    for u, v, pu in pairs:
        es = layout_errs(torch, cf, u, v, pu, by_columns=True)
        e1, e2 = es["mont_mul"], es["add_sub_mod"]
        log(f"[kernels] mont_mul, add_sub_mod vs plain at {shape_text(u, v)}, "
            f"every layout pair and output layout: max_abs_err {e1}, {e2}")
        errs["mont_mul"] = max(errs["mont_mul"], e1)
        errs["add_sub_mod"] = max(errs["add_sub_mod"], e2)
        require(e1 == 0 and e2 == 0, "a field kernel disagrees with its plain "
                f"version at {shape_text(u, v)}")
    del pwide, pairs

    def plain_by_columns(plain, u, v):
        return [plain(u[:, c:c + 1], v[:, c:c + 1]) for c in range(u.shape[1])]

    n_flag = CAIRO_FLAG_COLS * lde
    pflags = cf.pack_words(flags)
    # the constraints' stack: the packed frame's 15 flag columns against
    # (16, 15, 1) constants, as round 2 hands them to H1/H2; then the same
    # in the limb layout
    for u, elem, recs in ((pflags, PACKED_BYTES, out), (flags, ELEM_BYTES, None)):
        for name, launch, plain, ops in (
                ("mont_mul", lambda: cf.mont_mul(u, consts),
                 lambda: plain_by_columns(cf.mul_plain, u, consts), OPS_MUL),
                ("add_sub_mod", lambda: cf.add_sub_mod(u, consts, "sub"),
                 lambda: plain_by_columns(cf.sub_plain, u, consts), OPS_ADD)):
            # the stack read and written once, one constant per column read
            # once
            rec = {"shape": shape_text(u, consts),
                   "ms": graph_ms(torch, launch, 10),
                   "plain_ms": cuda_ms(torch, plain, 2),
                   **bound(elem * 2 * n_flag + ELEM_BYTES * CAIRO_FLAG_COLS,
                           ops * n_flag)}
            if recs is None:
                limb_recs[name]["cairo_stack"] = rec
            else:
                recs[name] = rec
    del pflags

    def narrow(xs, cols):
        return xs[:, :cols].contiguous()

    # the LDE of the main (43 or 34 columns) and auxiliary trace, the
    # other transforms of the three paths: the trace's iNTT (43, 34, 18 and
    # 1 columns of 2^19 points) and the LDE of a composition half (one column
    # of 2^22 points)
    trace = random_columns(torch, HINTS_MAIN_COLS, 1 << FULL_LOG, dev)
    for group in ((hints_wide, wide, narrow(hints_wide, CAIRO_AUX_COLS)),
                  (trace, narrow(trace, CAIRO_MAIN_COLS),
                   narrow(trace, CAIRO_AUX_COLS), narrow(trace, 1)),
                  (random_columns(torch, 1, 1 << COMPOSITION_LOG, dev),)):
        for name, e in ntt.compare(*group).items():
            errs[name] = max(errs[name], e)
    del group, trace
    # the times at the hinted run's stack, whose launches the kernels line
    # counts, and at the fib(70000) run's
    out.update(ntt.times(hints_wide))
    for name, rec in ntt.times(wide).items():
        out[name]["cairo_fib_stack"] = rec
    del hints_wide

    # whole NTT (the pass list through H3 and H4) against the plain DIT NTT
    for log_n in NTT_LOGS:
        for batch in ((), (3,)):
            v = random_columns(torch, (batch or (1,))[0], 1 << log_n,
                               dev).reshape((16,) + batch + (1 << log_n,))
            fwd = max_abs_err(torch, nttc.ntt(v), cn.ntt_plain(v, False))
            inv_plain = cf.mul_plain(
                cn.ntt_plain(v, True),
                fd.from_int(pow(1 << log_n, P - 2, P), device=dev).reshape(
                    (16,) + (1,) * (v.dim() - 1)))
            inv = max_abs_err(torch, nttc.intt(v), inv_plain)
            log(f"[kernels] NTT 2^{log_n} batch {batch or (1,)}: forward "
                f"max_abs_err {fwd}, inverse max_abs_err {inv}")
            require(fwd == 0 and inv == 0, f"NTT mismatch at 2^{log_n}")
    for w in (cn.ntt_dif_stages, cn.ntt_dif_local):
        w.launches = 0
    nttc.ntt(big_a.reshape(16, lde))
    log(f"[kernels] NTT 2^{LDE_LOG}: {cn.ntt_dif_stages.launches} H3 + "
        f"{cn.ntt_dif_local.launches} H4 launches, each one pass over the "
        f"array; passes {[tuple(p) for p in cn.ntt_passes(LDE_LOG)]}")
    require(cn.ntt_dif_stages.launches + cn.ntt_dif_local.launches <= 5,
            "a 2^21-point transform takes more than five passes")
    whole = {}
    for tag, v in (("one_column", big_a.reshape(16, lde)), ("cairo_stack", wide)):
        n_points = v[0].numel()
        whole[tag] = {
            "shape": shape_text(v),
            "ms": cuda_ms(torch, lambda: nttc.ntt(v), 5),
            # the array read and written once, the table of n twiddles read
            # once; every stage
            **bound(2 * ELEM_BYTES * n_points + TWIDDLE_BYTES * lde,
                    butterfly_ops(n_points, LDE_LOG - 1, LDE_LOG))}
    whole["one_column"]["plain_ms"] = cuda_ms(
        torch, lambda: cn.ntt_plain(big_a.reshape(16, lde), False), 1)
    for tag, r in whole.items():
        log(f"[kernels] whole NTT at {r['shape']}: {r['ms']:.4f} ms (H3 + H4), "
            f"{bound_text(r)}"
            + (f", {r['plain_ms']:.3f} ms plain" if "plain_ms" in r else ""))
    for name in ("ntt_dif_stages", "ntt_dif_local"):
        out[name]["whole_ntt"] = whole
    for name, rec in out.items():
        rec["max_abs_err"] = errs[name]  # over every shape compared above
        # no single PyTorch call computes a 256-bit modular product, sum or
        # butterfly, so there is no library time to put beside the kernel's
        rec["library_ms"] = None
        rec["one_column"] = one[name]
        if name in limb_recs:
            rec["limbs"] = limb_recs[name]  # the (16, ...) layout's times
        for r in (rec, rec.get("cairo_fib_stack"), one[name],
                  *limb_recs.get(name, {}).values()):
            if r is None:
                continue
            for label, t in ((name, r), (f"{name}, 10 stages in place",
                                         r.get("ten_stages"))):
                if t:
                    log(f"[kernels] {label} at {r['shape']}: {t['ms']:.4f} ms "
                        f"kernel, {t['plain_ms']:.4f} ms plain, {bound_text(t)}")
    return out


def digest_err(torch, a, b) -> int:
    """Largest |a - b| over the bytes of two digest tensors (0 iff equal)."""
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return max_abs_err(torch, a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def keccak_build_facts() -> dict:
    """Registers, spills and SASS of K1-K3, and the 32-bit integer
    instructions of one permutation: the LOP3 and SHF of K2's kernel (a
    64-bit xor, and-not or rotate is two of them; the rest of its integer
    work is the tree's bookkeeping), which must hold one permutation: within
    2 % of K3's, one straight-line permutation of a 40-byte message.  Fails
    on a spill or a stack frame."""
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib

    info = cuda_lib.build_info()
    ptxas = ptxas_report(info["log"])
    sass = sass_counts(info["path"])
    facts = {}
    for kernel in ("keccak_rows_kernel", "keccak_pairs_kernel",
                   "keccak_grind_kernel"):
        regs = [v for k, v in ptxas.items() if kernel in k]
        code = [v for k, v in sass.items() if kernel in k]
        require(len(regs) == 1 and len(code) == 1,
                f"{kernel}: not found in the build's report or its SASS")
        count, ops = code[0]
        int_ops = sum(n for op, n in ops.items()
                      if op not in NOT_INT_OPS and not op.startswith("U"))
        facts[kernel] = {**regs[0], "sass": count, "int_ops": int_ops,
                         "lop3_shf": ops["LOP3"] + ops["SHF"],
                         "opcodes": dict(ops.most_common(8))}
        log(f"[keccak] {kernel}: {regs[0]}; SASS {count} instructions, "
            f"{int_ops} of them 32-bit integer work; {dict(ops.most_common(8))}")
        # the state stays in registers: no spill and no local array
        require(regs[0].get("spill_stores") == 0 and
                regs[0].get("spill_loads") == 0 and regs[0].get("stack") == 0,
                f"{kernel} spills registers or keeps a local array")
    per_perm = facts["keccak_pairs_kernel"]["lop3_shf"]
    perm_k3 = facts["keccak_grind_kernel"]["lop3_shf"]
    require(per_perm > 24 * 100, f"{per_perm} instructions a permutation: "
            "the SASS count went wrong")
    require(abs(per_perm - perm_k3) <= perm_k3 // 50,
            f"keccak_pairs_kernel holds {per_perm} LOP3 and SHF against one "
            f"permutation's {perm_k3}: not one permutation in its SASS")
    facts["ops_per_permutation"] = per_perm
    return facts


def phase_keccak(torch, dev) -> dict:
    """K1-K3 against their plain versions on the card, bit for bit, and their
    times.  K1 at the row leaves of every commit the proves make: (16, c,
    2^21) in _row_leaves' layout for the hinted run's 61 and 43 columns and
    fib(70000)'s 34 and 18, the composition's 2 columns in round 2's (16,
    2^21, 2) layout, and the single-felt FRI leaves at 2^21 and 2^20; K2 on
    the tree over n leaves at every n = 2^0 .. 2^21 (keccak_tree, against
    the plain levels; one launch a tree; timed beside one launch a level)
    and at the FRI chain's draw; K3 at batches of 2^20 nonces against the
    host's leading_zeros_of_nonce.  Returns the kernels' records."""
    import numpy as np
    from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
    from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as kd
    from lambdaworks_cairo_prover_tpu_torch.hash.merkle import tree_levels
    from lambdaworks_cairo_prover_tpu_torch.prover.grinding import (
        leading_zeros_of_nonce)

    facts = keccak_build_facts()
    per_perm = facts["ops_per_permutation"]
    lde = 1 << LDE_LOG
    errs = {"keccak_rows": 0, "keccak_pairs": 0, "keccak_grind": 0}

    def rows_record(x, got, plain, n_cols, n_rows, run, reps):
        """Error, times and bound of one K1 shape (x: what K1 reads)."""
        want, plain_ms = timed(torch, plain)
        err = digest_err(torch, got, want)
        errs["keccak_rows"] = max(errs["keccak_rows"], err)
        rec = {"shape": shape_text(x), "max_abs_err": err,
               "ms": cuda_ms(torch, run, reps), "plain_ms": plain_ms,
               # the limbs read once, the digests written once
               **bound(ELEM_BYTES * n_cols * n_rows + 32 * n_rows,
                       per_perm * keccak_blocks(n_cols) * n_rows)}
        log(f"[keccak] keccak_rows at {rec['shape']} ({keccak_blocks(n_cols)} "
            f"blocks a row): max_abs_err {err}; {rec['ms']:.4f} ms kernel, "
            f"{plain_ms:.4f} ms plain, {bound_text(rec)}")
        require(err == 0, f"keccak_rows disagrees with its plain version at "
                f"{rec['shape']}")
        return rec

    rows = []
    big = random_columns(torch, HINTS_COLS, lde, dev)
    for n_cols in (HINTS_COLS, HINTS_MAIN_COLS, CAIRO_MAIN_COLS,
                   CAIRO_AUX_COLS):
        x = big[:, :n_cols].contiguous()  # _row_leaves' (16, c, n) layout
        rows.append(rows_record(
            x, ck.keccak_rows(x),
            lambda: kd.hash_felt_rows_plain(x.permute(0, 2, 1), n_cols),
            n_cols, lde, lambda: ck.keccak_rows(x), 5))
        del x
    # the composition: round 2 stacks its two halves as (16, n, 2)
    halves = torch.stack([big[:, 0], big[:, 1]], dim=2)
    rows.append(rows_record(
        halves, kd.hash_felt_rows(halves, 2),
        lambda: kd.hash_felt_rows_plain(halves, 2), 2, lde,
        lambda: kd.hash_felt_rows(halves, 2), 20))
    del halves
    # the FRI layers' single-felt leaves
    for n in (lde, lde // 2):
        col = big[:, 2, :n].contiguous()
        rows.append(rows_record(
            col, kd.hash_felt_leaves(col),
            lambda: kd.hash_felt_rows_plain(col[:, :, None], 1), 1, n,
            lambda: kd.hash_felt_leaves(col), 20))
    del big

    # K2: the tree over n leaves at every n = 2^0 .. 2^21 against the plain
    # levels, its launches, and its time beside the per-level route's (a
    # one-level K2 launch a level); then one pair (the FRI draw)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    leaves = torch.randint(-2**31, 2**31 - 1, (lde, 8), dtype=torch.int32,
                           device=dev, generator=gen).view(torch.int64)

    def per_level(x):
        cur = x
        while cur.shape[0] > 1:
            cur = ck.keccak_pairs(cur)
        return cur

    trees = []
    for log_n in range(LDE_LOG + 1):
        n = 1 << log_n
        x = leaves[:n]
        before = ck.keccak_pairs.launches
        got = ck.keccak_tree(x)
        launches = ck.keccak_pairs.launches - before
        want, plain_ms = timed(torch, lambda: kd.hash_tree_plain(x))
        err = digest_err(torch, got, want)
        errs["keccak_pairs"] = max(errs["keccak_pairs"], err)
        levels = tree_levels(x)
        root = want[-1:] if n > 1 else x
        require(err == 0 and torch.equal(levels[-1], root),
                f"keccak_pairs disagrees with its plain version on a tree "
                f"over {n} leaves")
        require(launches == (n > 1),
                f"a tree over {n} leaves took {launches} launches")
        reps = 5 if log_n >= 19 else 20
        rec = {"n": n, "tree_launches": launches,
               "ms": cuda_ms(torch, lambda: ck.keccak_tree(x), reps),
               "per_level_ms": cuda_ms(torch, lambda: per_level(x), reps),
               "per_level_launches": log_n, "plain_ms": plain_ms,
               # the leaves read once, the n - 1 nodes written once
               **bound(32 * n + 32 * (n - 1), per_perm * (n - 1))}
        trees.append(rec)
        log(f"[keccak] tree over {n} leaves: max_abs_err {err}, "
            f"{launches} launch; {rec['ms']:.4f} ms, the "
            f"per-level route ({log_n} launches) {rec['per_level_ms']:.4f} "
            f"ms, {plain_ms:.2f} ms plain"
            + (f", {bound_text(rec)}" if n > 1 else ""))
    require(errs["keccak_pairs"] == 0, "keccak_pairs disagrees with its "
            "plain version")
    slower = [r["n"] for r in trees if r["ms"] > r["per_level_ms"]]
    log(f"[keccak] trees slower than the per-level route: {slower or 'none'}")
    main_tree = trees[-1]
    pairs = {"shape": f"tree over {shape_text(leaves)} leaves",
             **{k: v for k, v in main_tree.items() if k != "n"},
             "by_tree": trees,
             "draw": {"shape": "(2, 4)",
                      "ms": cuda_ms(torch, lambda: ck.keccak_pairs(leaves[:2]), 50),
                      "plain_ms": trees[1]["plain_ms"],
                      **bound(64 + 32, per_perm)}}
    log(f"[keccak] keccak_pairs at one pair (the draw): "
        f"{pairs['draw']['ms']:.4f} ms kernel, "
        f"{pairs['draw']['plain_ms']:.4f} ms plain, "
        f"{bound_text(pairs['draw'])}")
    del leaves

    # K3: batches of 2^20 nonces, a hit inside each of two, none in a third
    size = 1 << 20
    challenge = bytes(np.random.default_rng(SEED).integers(0, 256, 32,
                                                           dtype=np.uint8))
    for start, factor in ((0, 16), ((1 << 40) + 7, 16), (0, 40)):
        found, first = kd.grinding_batch(challenge, start, size, factor, dev)
        p_found, p_first = kd.grinding_batch_plain(challenge, start, size,
                                                   factor, dev)
        got = (bool(found), int(first))
        ok = got == (bool(p_found), int(p_first))
        if got[0]:
            ok = ok and leading_zeros_of_nonce(
                challenge, start + got[1]) >= factor and all(
                leading_zeros_of_nonce(challenge, start + i) < factor
                for i in range(got[1]))
        else:
            ok = ok and got[1] == size and factor > 30
        log(f"[keccak] keccak_grind at start {start}, {size} nonces, factor "
            f"{factor}: (found, first) {got}, equal to the plain version's "
            f"and to the host check: {ok}")
        errs["keccak_grind"] = max(errs["keccak_grind"], int(not ok))
        require(ok, "keccak_grind disagrees with its plain version or the host")
    factor = BENCH["grinding_factor"]
    grind = {"shape": f"{size} nonces, factor {factor}",
             "ms": cuda_ms(torch, lambda: ck.keccak_grind(
                 (1, 2, 3, 4), 0, size, factor, dev), 20),
             "plain_ms": timed(torch, lambda: kd.grinding_batch_plain(
                 challenge, 0, size, factor, dev))[1],
             # the result written once; one permutation a nonce
             **bound(8, per_perm * size)}
    log(f"[keccak] keccak_grind at {grind['shape']}: {grind['ms']:.4f} ms "
        f"kernel, {grind['plain_ms']:.4f} ms plain, {bound_text(grind)}")

    # the kernels line: K1 at the hinted run's 43 main columns (its
    # launches are that run's), every shape under by_shape
    main = next(r for r in rows if f", {HINTS_MAIN_COLS}, " in r["shape"])
    out = {"keccak_rows": {**{k: v for k, v in main.items()
                              if k != "max_abs_err"}, "by_shape": rows},
           "keccak_pairs": pairs, "keccak_grind": grind}
    for name, rec in out.items():
        rec["max_abs_err"] = errs[name]
        # no PyTorch call computes Keccak: no library time
        rec["library_ms"] = None
        rec["build"] = facts[f"{name}_kernel"]
        rec["ops_per_permutation"] = per_perm
    return out


# the scans' shapes: the RAP's memory and range-check scans of a 2^19-row
# Cairo trace (4 and 3 values a row) and DEEP's inverse over 3 LDE offsets
# of 2^21 points
SCAN_SHAPES = (4 << FULL_LOG, 3 << FULL_LOG, 3 << LDE_LOG)
SCAN_SMALL = (0, 1, 2, 3, 255, 256, 257, 1023, 1024, 1025, 4097, 65535,
              65536, 65537, 70001)
# H5 also at fib(280000)'s DEEP inverse, and at 1 and 2^16 elements, where
# its fixed part (the launches and the root's inverse) dominates; H6 at
# fib(280000)'s memory scan (4 values a row of 2^21), 1 and 2^16
INVERSE_EXTRA = (3 << (MEMORY_LOG + 2), 1, 1 << 16)
PREFIX_EXTRA = (1 << (MEMORY_LOG + 2), 1, 1 << 16)
# H6 called back to back at these shapes without a synchronise, each output
# equal to the first (the status words of one call are the next's)
PREFIX_REPEAT, PREFIX_REPEAT_SHAPES = 100, (3 << FULL_LOG, 4 << FULL_LOG)
SCAN_KERNELS = {"mont_batch_inverse": ("inv_reduce_kernel",
                                      "inv_totals_kernel",
                                      "inv_apply_kernel"),
                "mont_prefix_product": ("prefix_product_kernel",)}


def root_products() -> int:
    """Products of H5's root inverse (cuda_scan.root_inverse's chains)."""
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs

    count = [0]

    def mul(a, b):
        count[0] += 1
        return a

    cs.root_inverse(1, mul)
    return count[0]


def scan_input(torch, n: int, dev, plant: str = "", all_zero: bool = False,
               zero_tiles: int = 0):
    """(16, n) seeded canonical elements on the card, 0, 1 and p - 1 last.
    ``plant`` "mont_batch_inverse": zeros also at the edges of H5's first
    runs and tiles, in the middle and a tile before the end (and about H6's
    first tile's end); "mont_prefix_product": zeros on the edges of H6's
    last two tiles and inside them (the products before stay nonzero);
    ``zero_tiles``: H6's first tiles all zero."""
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs

    if n < 3:
        x = random_columns(torch, 1, 3, dev).reshape(16, 3)[:, 3 - n:]
    else:
        x = random_columns(torch, 1, n, dev).reshape(16, n)
    if all_zero:
        return torch.zeros_like(x).contiguous()
    x[:, :zero_tiles * cs.TILE] = 0
    if n and plant == "mont_batch_inverse":
        edges = (0, cs.RUN - 1, cs.RUN, cs.INV_TILE - 1, cs.INV_TILE,
                 n // 2, n - cs.INV_TILE, cs.TILE - 1, cs.TILE)
    elif n and plant == "mont_prefix_product":
        last = (cs.prefix_plan(n)[0] - 1) * cs.TILE  # the last tile's start
        edges = (last - cs.TILE - 1, last - cs.TILE + cs.RUN, last - 1, last,
                 last + 1, n - 3)
    else:
        edges = ()
    for e in edges:
        if 0 <= e < n - 1:
            x[:, e] = 0
    return x.contiguous()


def phase_scan(torch, dev) -> dict:
    """H5 mont_batch_inverse and H6 mont_prefix_product against their plain
    versions on the card, bit for bit: at the path's shapes (SCAN_SHAPES,
    and at fib(280000)'s DEEP inverse, 3 * 2^23, and memory scan, 2^23, and
    at 1 and 2^16 elements for the fixed part) with zeros planted, at
    small and ragged sizes, on all zeros, H6 also with its first tiles all
    zero and in PREFIX_REPEAT calls back to back; against Python ints on a
    sample.
    Their times against the bound, the plain version and the route they
    replaced (the chunked loop over H1, whose launches are counted), and
    H1's time a step of that loop.  Returns the kernels' records."""
    from lambdaworks_cairo_prover_tpu_torch import cuda_lib
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.field.params import P

    ptxas = ptxas_report(cuda_lib.build_info()["log"])
    build = {name: {} for name in SCAN_KERNELS}
    for name, names in SCAN_KERNELS.items():
        for kernel in names:
            # H5's tile passes are templates: the 16-byte-load instance and
            # the one for ragged n
            regs = {k: v for k, v in ptxas.items() if kernel in k}
            require(regs, f"{kernel}: not in the build's report")
            for k, v in regs.items():
                build[name][k] = v
                log(f"[scan] {kernel} ({k}): {v}")
    kernels = {"mont_batch_inverse": (cs.mont_batch_inverse,
                                      cs.batch_inverse_plain),
               "mont_prefix_product": (cs.mont_prefix_product,
                                       cs.prefix_product_plain)}
    errs = {name: 0 for name in kernels}

    def compare(name, x, tag):
        kernel, plain = kernels[name]
        got = kernel(x)
        want, plain_ms = timed(torch, lambda: plain(x))
        err = max_abs_err(torch, got, want) if x.shape[1] else 0
        errs[name] = max(errs[name], err)
        require(err == 0, f"{name} disagrees with its plain version at "
                f"{tag}")
        return got, plain_ms

    # small and ragged sizes, all zeros, and H6's first tiles all zero
    for n in SCAN_SMALL:
        for name in kernels:
            # H6's planted zeros would zero most of a small input
            plant = name if name == "mont_batch_inverse" else ""
            compare(name, scan_input(torch, n, dev, plant), f"n = {n}")
    for name in kernels:
        compare(name, scan_input(torch, 4097, dev, all_zero=True), "zeros")
    got, _ = compare("mont_prefix_product",
                     scan_input(torch, SCAN_SHAPES[0], dev, zero_tiles=3),
                     "the first 3 tiles zero")
    require(not got.any(), "H6: a zero prefix is not zero")
    log(f"[scan] mont_batch_inverse, mont_prefix_product vs plain at n = "
        f"{', '.join(map(str, SCAN_SMALL))} and 4097 zeros, H6 at "
        f"{SCAN_SHAPES[0]} with its first 3 tiles zero: max_abs_err "
        f"{errs['mont_batch_inverse']}, {errs['mont_prefix_product']}")
    del got

    # H6 back to back: the caching allocator hands each call the status
    # words of the one before; the mismatches are summed on the card
    repeat = {}
    for n in PREFIX_REPEAT_SHAPES:
        x = scan_input(torch, n, dev, "mont_prefix_product")
        first = cs.mont_prefix_product(x)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(PREFIX_REPEAT - 1):
            bad += (cs.mont_prefix_product(x) != first).any(dim=0).sum()
        repeat[n] = int(bad)
        require(repeat[n] == 0, f"H6: {repeat[n]} elements of {PREFIX_REPEAT} "
                f"calls at (16, {n}) differ from the first call's")
        del x, first
    log(f"[scan] mont_prefix_product {PREFIX_REPEAT} calls back to back at "
        f"n = {', '.join(map(str, PREFIX_REPEAT_SHAPES))}: every output "
        f"equal to the first")

    records = {name: [] for name in kernels}
    shapes = [(name, n) for n in SCAN_SHAPES for name in kernels]
    shapes += [("mont_batch_inverse", n) for n in INVERSE_EXTRA]
    shapes += [("mont_prefix_product", n) for n in PREFIX_EXTRA]
    root_ops = root_products()
    for name, n in shapes:
        x = scan_input(torch, n, dev, name)
        kernel, plain = kernels[name]
        got, plain_ms = compare(name, x, f"(16, {n})")
        # Python ints on a sample: the first and last elements and around
        # the planted zeros
        idx = sorted(e for e in {*range(4), *range(n - 4, n), n // 2 - 1,
                                 n // 2, n // 2 + 1} if 0 <= e < n)
        xs, gs = fd.to_ints(x[:, idx]), fd.to_ints(got[:, idx])
        if name == "mont_batch_inverse":
            ok = gs == [pow(v, P - 2, P) for v in xs]
        else:  # out[e] = out[e - 1] * x[e]
            prev = fd.to_ints(got[:, [max(e - 1, 0) for e in idx]])
            ok = all(g == (v if e == 0 else p * v % P)
                     for e, g, p, v in zip(idx, gs, prev, xs))
        require(ok, f"{name} at (16, {n}) disagrees with Python ints")
        nonzero = int((x != 0).any(dim=0).sum())
        if name == "mont_batch_inverse":
            k, q, mid_blocks = cs.inverse_plan(n)
            # the Montgomery trick: 3 products a nonzero element, one
            # inversion
            ops = OPS_MUL * (3 * nonzero + root_ops)
            plan = {"tiles": k, "totals_a_thread": q,
                    "totals_blocks": mid_blocks}
        else:
            ops = OPS_MUL * (n - 1)
            tiles, words = cs.prefix_plan(n)
            plan = {"tiles": tiles, "status_words": words}
        cf.mont_mul.launches = 0
        h1_out, h1_loop_ms = timed(torch, lambda: plain(x, cf.mont_mul))
        h1_launches = cf.mont_mul.launches
        require(torch.equal(h1_out, got), f"{name}: the H1 loop differs")
        del h1_out
        step = cs._chunk_len(n)
        a = x[:, :-(-n // step)].contiguous()
        h1_step = {"shape": shape_text(a, a),
                   "ms": cuda_ms(torch, lambda: cf.mont_mul(a, a), 50),
                   **bound(3 * ELEM_BYTES * a.shape[1],
                           OPS_MUL * a.shape[1])}
        rec = {"shape": shape_text(x), "n": n, "nonzero": nonzero, **plan,
               "ms": cuda_ms(torch, lambda: kernel(x), 10),
               "plain_ms": plain_ms,
               # the elements read once and written once
               **bound(2 * ELEM_BYTES * n, ops),
               "h1_loop_ms": h1_loop_ms, "h1_loop_launches": h1_launches,
               "h1_step": h1_step}
        records[name].append(rec)
        log(f"[scan] {name} at {rec['shape']} ({plan}): max_abs_err 0, "
            f"Python ints on {len(idx)} elements equal; {rec['ms']:.4f} ms "
            f"kernel, {plain_ms:.2f} ms plain, {bound_text(rec)}; the "
            f"route it replaced: {h1_launches} H1 launches, "
            f"{h1_loop_ms:.2f} ms, H1 at {h1_step['shape']} "
            f"{h1_step['ms']:.4f} ms a step, {bound_text(h1_step)}")
        del x, got
    out = {}
    for name, recs in records.items():
        # the kernels line: H5 at DEEP's shape, H6 at the memory scan's
        main_n = SCAN_SHAPES[2 if name == "mont_batch_inverse" else 0]
        main = next(r for r in recs if r["n"] == main_n)
        out[name] = {**main, "by_shape": recs,
                     "max_abs_err": errs[name],
                     **({"back_to_back": {"calls": PREFIX_REPEAT,
                                          "mismatches": repeat}}
                        if name == "mont_prefix_product" else {}),
                     # no PyTorch call computes a 256-bit modular scan
                     "library_ms": None, "build": build[name]}
    return out


def fri_tail_layers(lde_log: int) -> list:
    """(offset, points) of the FRI layers of at most 2^MAX_LOG points of an
    LDE of 2^lde_log points with the bench options: the layers that
    prove._fri_commit hands K4."""
    from lambdaworks_cairo_prover_tpu_torch.field.params import P
    from lambdaworks_cairo_prover_tpu_torch.prover import fri_tail as ft

    layers, off, ds = [], BENCH["coset_offset"], 1 << lde_log
    for _ in range(1, lde_log - 2):  # a layer a trace bit, the first apart
        off, ds = off * off % P, ds // 2
        if ds <= 1 << ft.MAX_LOG:
            layers.append((off, ds))
    return layers


def host_fri_tail(coeffs: list, state: bytes, root: bytes, layers) -> int:
    """The host route that K4 replaces, on a host transcript: a draw after
    each root, prove._host_fri_layer, the final draw and fold; the last
    value."""
    from lambdaworks_cairo_prover_tpu_torch.prover import prove as pv
    from lambdaworks_cairo_prover_tpu_torch.transcript import (
        DefaultTranscript, transcript_to_field)

    t = DefaultTranscript()
    t._buf = bytearray(state)
    for off, ds in layers:
        t.append(root)
        coeffs, _, tree = pv._host_fri_layer(coeffs, transcript_to_field(t),
                                             off, ds)
        root = tree.root
    t.append(root)
    return pv._host_fold(coeffs, transcript_to_field(t))[0]


def fri_tail_work(layers, per_perm: int) -> tuple:
    """(bytes, 32-bit integer instructions) that K4 needs at the least:
    the coefficients in; the evaluations, digests, rows and states out; a
    permutation for each draw, leaf and node; a product and an add for
    each fold, a product for each scaled coefficient and each leaf out of
    Montgomery form, and the DIT butterflies (no product by w^0)."""
    n = len(layers)
    sizes = [ds for _, ds in layers]
    n_bytes = (2 << n) * ELEM_BYTES + sum(sizes) * ELEM_BYTES + (
        sum(2 * ds - 1 for ds in sizes) + 2 * (n + 1)) * 32
    perms = sum(2 * ds - 1 for ds in sizes) + n + 1
    ops = perms * per_perm + (n + 1) * OPS_MUL
    for k, ds in enumerate(sizes):
        c = 1 << (n - k)
        ops += c * (2 * OPS_MUL + OPS_ADD) + ds * OPS_MUL
        log_ds = ds.bit_length() - 1
        for log_m in range(log_ds):
            ops += ds // 2 * 2 * OPS_ADD + (ds // 2 - (ds // 2 >> log_m)) * OPS_MUL
    return n_bytes, ops + OPS_MUL + OPS_ADD  # and the final fold


def phase_fri_tail(torch, dev, per_perm: int) -> dict:
    """K4 ``fri_tail`` (``[fri-tail]``) at the FRI tails of both benchmark
    cells' LDEs: launched, once its tables are built, under
    set_sync_debug_mode("error") (no host sync),
    against its plain version on the CPU bit for bit (roots and last value,
    states, evaluations, tree levels) and against the host route's last
    value, at every cluster size; its registers; its time (CUDA events over
    FRI_TAIL_REPS launches) beside its bounds on the card and on the SMs
    of its cluster, the plain version's time on the CPU and the host
    route's."""
    import numpy as np

    from lambdaworks_cairo_prover_tpu_torch import cuda_lib
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as kd
    from lambdaworks_cairo_prover_tpu_torch.prover import fri_tail as ft

    regs = [v for k, v in ptxas_report(cuda_lib.build_info()["log"]).items()
            if "fri_tail_kernel" in k]
    require(len(regs) == 1, "fri_tail_kernel: not in the build's report")
    log(f"[fri-tail] fri_tail_kernel: {regs[0]}")
    rng = np.random.default_rng(SEED)
    shapes = []
    for lde_log in FRI_TAIL_LDE_LOGS:
        layers = fri_tail_layers(lde_log)
        n = len(layers)
        coeffs = fd.to_mont(random_limbs(torch, rng, ((2 << n) - 3,), dev))
        state, root = (torch.from_numpy(rng.integers(
            -1 << 63, (1 << 63) - 1, (1, 4), dtype=np.int64)).to(dev)
            for _ in range(2))
        ft.fri_tail(coeffs, state, root, layers)  # builds its tables
        before = ft.fri_tail_cuda.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ft.fri_tail(coeffs, state, root, layers)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        require(ft.fri_tail_cuda.launches == before + 1,
                "fri_tail did not launch K4 once")
        t0 = time.perf_counter()
        want = ft.fri_tail_plain(coeffs.cpu(), state.cpu(), root.cpu(), layers)
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = {name: digest_err(torch, getattr(got, name).cpu(),
                                 getattr(want, name))
                for name in ("rows", "states", "levels")}
        errs["evals"] = max_abs_err(torch, got.evals.cpu(), want.evals)
        t0 = time.perf_counter()
        last = host_fri_tail(fd.to_ints(coeffs), kd.digest_to_bytes(state[0]),
                             kd.digest_to_bytes(root[0]), layers)
        host_ms = (time.perf_counter() - t0) * 1e3
        errs["host_last_value"] = int(
            int.from_bytes(got.rows[-1].cpu().numpy().tobytes(), "little")
            != last)
        ms = cuda_ms(torch, lambda: ft.fri_tail(coeffs, state, root, layers),
                     FRI_TAIL_REPS)
        # the same launch at every cluster size: each exact, each timed
        clusters = {}
        for size in FRI_TAIL_CLUSTERS:
            try:
                out = ft.fri_tail_cuda(coeffs, state, root, layers, size)
                torch.cuda.synchronize()
            except cuda_lib.KernelLaunchError as exc:
                clusters[size] = f"refused: {exc}"
                continue
            err = max(digest_err(torch, getattr(out, name), getattr(got, name))
                      for name in ("rows", "states", "levels"))
            err = max(err, max_abs_err(torch, out.evals, got.evals))
            require(err == 0, f"[fri-tail] LDE 2^{lde_log}: K4 over a "
                    f"cluster of {size} differs from the plain version")
            clusters[size] = cuda_ms(torch, lambda: ft.fri_tail_cuda(
                coeffs, state, root, layers, size), FRI_TAIL_REPS)
        n_bytes, ops = fri_tail_work(layers, per_perm)
        b = bound(n_bytes, ops)
        # the integer rate of the SMs the launch takes (132 on the card)
        cluster_ms = ops / (INT32_OPS_PER_S * ft.CLUSTER / 132) * 1e3
        rec = {"lde_log": lde_log, "layers": [ds for _, ds in layers],
               "max_abs_err": max(errs.values()), "errs": errs, "ms": ms,
               "plain_ms": plain_ms, "host_route_ms": host_ms,
               "cluster_bound_ms": cluster_ms, "cluster": ft.CLUSTER,
               "ms_by_cluster": clusters, **b}
        shapes.append(rec)
        log(f"[fri-tail] LDE 2^{lde_log}: {n} layers from {layers[0][1]} "
            f"points, 2^{n + 1} coefficients in; errors {errs}; K4 {ms:.4f} "
            f"ms a launch ({FRI_TAIL_REPS} launches, CUDA events), "
            f"{bound_text({**b, 'ms': ms})}; the operations bound on the "
            f"cluster's {ft.CLUSTER} SMs {cluster_ms:.4f} ms, share "
            f"{cluster_ms / ms:.3f}; plain version "
            f"on the CPU {plain_ms:.1f} ms; the host route (Python integers) "
            f"{host_ms:.1f} ms; clusters of {ft.CLUSTER} blocks; ms a launch by "
            f"blocks a cluster {clusters}")
        require(rec["max_abs_err"] == 0, f"[fri-tail] LDE 2^{lde_log}: K4 "
                f"differs from its plain version or the host route: {errs}")
    top = shapes[-1]
    return {"fri_tail": {**{k: top[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "bytes_ms", "operations_ms", "cluster_bound_ms", "host_route_ms")},
        "library_ms": None, "registers": regs[0], "shapes": shapes}}


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
    trace = fibonacci_trace([1, 1], 1 << log_n, device=dev)
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


def kernel_wrappers() -> dict:
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
    from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
    from lambdaworks_cairo_prover_tpu_torch.prover import fri_tail as ft

    return {"mont_mul": cf.mont_mul, "add_sub_mod": cf.add_sub_mod,
            "ntt_dif_stages": cn.ntt_dif_stages,
            "ntt_dif_local": cn.ntt_dif_local,
            "keccak_rows": ck.keccak_rows, "keccak_pairs": ck.keccak_pairs,
            "keccak_grind": ck.keccak_grind,
            "mont_batch_inverse": cs.mont_batch_inverse,
            "mont_prefix_product": cs.mont_prefix_product,
            "fri_tail": ft.fri_tail_cuda}


# kernels that a path does not run: simple_fibonacci has no RAP trace, so
# no prefix product (its DEEP and boundary inverses take H5); the
# domain-sharded kernels fold the FRI tail on the host (no K4)
NOT_ON_PATH = {"full": {"mont_prefix_product"},
               "scale": {"mont_prefix_product"},
               "parallel": {"fri_tail"}}


def reset_counts(torch) -> None:
    """Every launch count to 0 and the peak-memory mark to now."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in kernel_wrappers().values():
        w.launches = 0
    from lambdaworks_cairo_prover_tpu_torch.prover import prove as pv

    pv._host_fri_layer.calls = 0


def read_counts(tag: str) -> dict:
    from lambdaworks_cairo_prover_tpu_torch.prover import prove as pv

    launches = {name: w.launches for name, w in kernel_wrappers().items()}
    log(f"[{tag}] kernel launches on this path: {launches}; FRI layers "
        f"folded on the host since the count's reset: "
        f"{pv._host_fri_layer.calls}")
    for name, count in launches.items():
        if name not in NOT_ON_PATH.get(tag, ()):
            require(count > 0, f"[{tag}] kernel {name} was not launched")
    return launches


def phase_full(torch, dev) -> dict:
    reset_counts(torch)
    cold = _fib(FULL_LOG, bench=True, dev=dev)
    launches = read_counts("full")
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


def _cairo(program, bench: bool, dev, args=None, mesh=None,
           shard_axis: str = "domain", **run_options):
    """generate_prover_args -> generate_cairo_proof -> verify_cairo_proof on
    ``dev``; ``args`` reuses an earlier (trace, public inputs); ``mesh``
    and ``shard_axis`` go to generate_cairo_proof (the sharded prover);
    ``run_options`` go to generate_prover_args (layout, cairo_version)."""
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import (
        generate_cairo_proof, verify_cairo_proof)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import (
        serialize_proof, write_proof_file)

    options = (ProofOptions(**BENCH) if bench
               else ProofOptions.default_test_options())
    t0 = time.perf_counter()
    trace, pub = args or generate_prover_args(program, device=dev,
                                              **run_options)
    t_args = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = generate_cairo_proof(trace, pub, options, device=dev, mesh=mesh,
                                 shard_axis=shard_axis)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(verify_cairo_proof(proof, pub, options),
            "the port's verifier rejected its Cairo proof")
    t_verify = time.perf_counter() - t0
    wrong = type(pub).deserialize(pub.serialize())
    wrong.pc_final += 1
    require(not verify_cairo_proof(proof, wrong, options),
            "wrong public inputs were accepted")
    return {"bytes": serialize_proof(proof),
            "file": write_proof_file(proof, pub.serialize()),
            "trace": trace, "pub": pub, "args_s": t_args, "prove_s": t_prove,
            "verify_s": t_verify, "timings": proof._timings,
            "columns": len(proof.trace_ood_frame_evaluations[0])}


def phase_cairo_fixture(dev) -> None:
    from lambdaworks_cairo_prover_tpu_torch.cairo import programs

    small = {"cairo_fib5_test_options.proof": programs.fibonacci_program(5),
             "cairo_rc_test_options.proof": programs.rc_program(RC_VALUES)}
    for name, program in small.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            ref = f.read()
        res = _cairo(program, bench=False, dev=dev)
        log(f"[cairo-fixture] {name}: {res['trace'].n_rows} rows x "
            f"{res['columns']} columns, {len(res['file'])} bytes, equal to "
            f"the JAX proof file: {res['file'] == ref}")
        require(res["file"] == ref, f"{name}: bytes differ from the JAX fixture")
    with open(os.path.join(FIXTURES, "cairo_fib_bench_digest.json")) as f:
        digest = json.load(f)
    require(digest["options"] == BENCH, "Cairo digest fixture has other options")
    res = _cairo(programs.fibonacci_program(digest["n"]), bench=True, dev=dev)
    got = hashlib.sha256(res["bytes"]).hexdigest()
    pub_got = hashlib.sha256(res["pub"].serialize()).hexdigest()
    log(f"[cairo-fixture] fibonacci_program({digest['n']}), bench options: "
        f"{res['trace'].n_rows} rows x {res['columns']} columns, "
        f"{len(res['bytes'])} bytes, prove {res['prove_s']:.3f} s, sha256 "
        f"{got}, equal to the JAX digest: {got == digest['sha256']}")
    require((res["trace"].n_rows, res["columns"]) ==
            (digest["trace_rows"], digest["trace_columns"]),
            "trace shape differs from the JAX fixture's")
    require(pub_got == digest["public_inputs_sha256"],
            "public inputs differ from the JAX fixture's")
    require(got == digest["sha256"], "Cairo bench proof differs from the JAX digest")


def phase_cairo_aux(torch, dev) -> None:
    """The device RAP build (sorts, batch inverses and prefix products
    through H5/H6) against the python-int host oracle."""
    from lambdaworks_cairo_prover_tpu_torch.cairo import programs
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.field.params import P
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions

    trace, pub = generate_prover_args(
        programs.fibonacci_program(CAIRO_AUX_FIB_N), device=dev)
    require(trace.n_rows >= 1 << 12, f"only {trace.n_rows} rows")
    air = CairoAIR(trace.n_rows, pub, ProofOptions(**BENCH))
    challenges = tuple(pow(b, SEED, P) for b in (3, 5, 7))
    t0 = time.perf_counter()
    aux = air.build_auxiliary_trace(trace, challenges)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = air.build_auxiliary_trace_host(trace, challenges)
    t_host = time.perf_counter() - t0
    require(aux.data.device.type == "cuda", "the RAP build left the card")
    err = max_abs_err(torch, aux.data, host.unpacked())
    log(f"[cairo-aux] {trace.n_rows} rows x {aux.n_cols} auxiliary columns: "
        f"device build {t_dev:.3f} s, host oracle {t_host:.3f} s, "
        f"max_abs_err {err}")
    require(err == 0, "the device RAP build differs from the host oracle")


def fri_routes(torch, dev, tag: str, res: dict, warm: dict) -> None:
    """The FRI commit routes on the trace of ``res`` (a cold Cairo prove)
    after the warm prove ``warm`` (the chain route, with K4 for the layers
    of 4,096 points or fewer): a prove whose chain and K4 run under
    torch.cuda.set_sync_debug_mode("error") with every table built, so that
    any host sync before the chain's one readback raises, with K4 launched
    once and no FRI layer folded on the host; the chain with the host tail
    (``supports_fri_tail`` off: ten layers on the host at these sizes); the
    full chain (``_FULL_CHAIN_MAX_LOG`` past the LDE), the reference for
    the launches it queues; and the per-layer route (a DefaultTranscript
    subclass, which the chain's gate sends there).  All proofs byte-equal;
    each route's round4_fri_commit, and the kernel launches of its prove."""
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover import kernels as pk
    from lambdaworks_cairo_prover_tpu_torch.prover import prove as pv
    from lambdaworks_cairo_prover_tpu_torch.transcript import DefaultTranscript

    class PerLayerTranscript(DefaultTranscript):
        pass

    options = ProofOptions(**BENCH)
    chain = pk.ProverKernels.fri_commit_chain
    chain_ms = []

    def guarded(self, *args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, ms = timed(torch, lambda: chain(self, *args, **kwargs))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        chain_ms.append(ms)
        return out

    def counted_prove(**kwargs):
        """(proof, kernel launches, FRI layers folded on the host)."""
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in kernel_wrappers().items()}
        host0 = pv._host_fri_layer.calls
        proof = pv.prove(res["trace"], res["pub"], options, CairoAIR,
                         device=dev, **kwargs)
        launches = {k: w.launches - before[k]
                    for k, w in kernel_wrappers().items()}
        return proof, launches, pv._host_fri_layer.calls - host0

    pk.ProverKernels.fri_commit_chain = guarded
    try:
        guarded_proof, tail_launches, tail_host = counted_prove()
    finally:
        pk.ProverKernels.fri_commit_chain = chain
    require(len(chain_ms) == 1, f"[{tag}] the prove did not take the chain")
    require(tail_launches["fri_tail"] == 1 and tail_host == 0,
            f"[{tag}] K4 launched {tail_launches['fri_tail']} times and "
            f"{tail_host} FRI layers folded on the host (1 and 0 expected)")
    pk.ProverKernels.supports_fri_tail = False
    try:
        host_tail, host_launches, host_layers = counted_prove()
    finally:
        pk.ProverKernels.supports_fri_tail = True
    require(host_launches["fri_tail"] == 0 and host_layers == 10,
            f"[{tag}] the host-tail route launched K4 "
            f"{host_launches['fri_tail']} times and folded {host_layers} "
            f"layers on the host (0 and 10 expected)")
    full_log, pv._FULL_CHAIN_MAX_LOG = pv._FULL_CHAIN_MAX_LOG, 30
    try:
        full, full_launches, _ = counted_prove()
    finally:
        pv._FULL_CHAIN_MAX_LOG = full_log
    layered = pv.prove(res["trace"], res["pub"], options, CairoAIR,
                       device=dev, transcript_factory=PerLayerTranscript)
    for name, proof in (("the proof under the sync check", guarded_proof),
                        ("the host-tail route", host_tail),
                        ("the full chain", full),
                        ("the per-layer FRI route", layered)):
        require(serialize_proof(proof) == res["bytes"],
                f"[{tag}] {name} gives other proof bytes")
    log(f"[{tag}] FRI chain and K4 under set_sync_debug_mode('error'): no "
        f"host sync before the readback ({chain_ms[0]:.1f} ms queued and "
        f"run); K4 launched once, no FRI layer on the host; the host-tail "
        f"route folded {host_layers} layers on the host; proofs of all four "
        f"routes byte-equal")
    log(f"[{tag}] round4_fri_commit: chain + K4 "
        f"{warm['timings']['round4_fri_commit']:.4f} s (warm prove "
        f"{warm['prove_s']:.3f} s), under the sync check "
        f"{guarded_proof._timings['round4_fri_commit']:.4f} s; chain + host "
        f"tail {host_tail._timings['round4_fri_commit']:.4f} s; full chain "
        f"{full._timings['round4_fri_commit']:.4f} s; per-layer route "
        f"{layered._timings['round4_fri_commit']:.4f} s (round4 "
        f"{layered._timings['round4']:.3f} s)")
    log(f"[{tag}] kernel launches a prove: chain + K4 "
        f"{sum(tail_launches.values())} {tail_launches}; chain + host tail "
        f"{sum(host_launches.values())}; full chain "
        f"{sum(full_launches.values())} {full_launches}")


# ProverKernels methods in which H1/H2 read the packed LDE, polynomials and
# tables as they lie: no fd.unpack (or fd.pack) call inside them
UNPACK_FREE = ("round2", "_deep_evaluations", "eval_at_powers")


def counting_unpacks(fn):
    """(fn(), {method of UNPACK_FREE: (unpack, pack) calls inside it over the
    run}, (unpack, pack) calls in all)."""
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.prover.kernels import ProverKernels

    seen = {name: [0, 0] for name in UNPACK_FREE}
    saved = {name: getattr(ProverKernels, name) for name in UNPACK_FREE}

    def counted(orig, name):
        def run(self, *args, **kwargs):
            u0, p0 = fd.unpack.calls, fd.pack.calls
            try:
                return orig(self, *args, **kwargs)
            finally:
                seen[name][0] += fd.unpack.calls - u0
                seen[name][1] += fd.pack.calls - p0
        return run

    u0, p0 = fd.unpack.calls, fd.pack.calls
    try:
        for name, orig in saved.items():
            setattr(ProverKernels, name, counted(orig, name))
        out = fn()
    finally:
        for name, orig in saved.items():
            setattr(ProverKernels, name, orig)
    return out, {k: tuple(v) for k, v in seen.items()}, (
        fd.unpack.calls - u0, fd.pack.calls - p0)


def phase_cairo_full(torch, dev) -> dict:
    from lambdaworks_cairo_prover_tpu_torch.cairo import programs

    program = programs.fibonacci_program(CAIRO_FIB_N)
    reset_counts(torch)
    cold = _cairo(program, bench=True, dev=dev)
    launches = read_counts("cairo-full")
    # the scans go through H5 and H6, not a launch of H1 a step (5,977 H1
    # launches when they did)
    require(launches["mont_mul"] < CAIRO_FIB_MAX_H1,
            f"the cold prove launched H1 {launches['mont_mul']} times, not "
            f"fewer than {CAIRO_FIB_MAX_H1}")
    peak = torch.cuda.max_memory_allocated()
    warm, inside, whole = counting_unpacks(lambda: _cairo(
        program, bench=True, dev=dev, args=(cold["trace"], cold["pub"])))
    require(warm["bytes"] == cold["bytes"], "cold and warm Cairo proofs differ")
    log(f"[cairo-full] warm prove: fd.unpack / fd.pack calls {whole[0]} / "
        f"{whole[1]} in all; inside {', '.join(f'{k} {u} / {p}' for k, (u, p) in inside.items())}")
    require(all(c == (0, 0) for c in inside.values()),
            "a layout pass runs in round 2, DEEP or the OOD dot products")
    trace, stages = cold["trace"], cold["trace"]._timings
    require((trace.n_rows, cold["columns"]) == (1 << FULL_LOG, 52),
            f"expected 2^{FULL_LOG} rows x 52 columns, got {trace.n_rows} x "
            f"{cold['columns']}")
    log(f"[cairo-full] fibonacci_program({CAIRO_FIB_N}): {trace.n_rows} rows x "
        f"{cold['columns']} columns ({trace.n_cols} main), blowup 4, 80 "
        f"queries, coset 3, grinding 20")
    log(f"[cairo-full] {stages['vm_name']} VM {stages['vm']:.3f} s, trace "
        f"build {stages['trace_build']:.3f} s (host), ingest "
        f"{stages['ingest']:.3f} s; generate_prover_args {cold['args_s']:.3f} s")
    for tag, r in (("cold", cold), ("warm", warm)):
        rounds = ", ".join(f"{k} {v:.3f}" for k, v in r["timings"].items())
        log(f"[cairo-full] {tag} prove {r['prove_s']:.3f} s ({rounds}); "
            f"verify {r['verify_s']:.3f} s, accepted; wrong public inputs "
            f"rejected")
    log(f"[cairo-full] proof size {len(cold['bytes'])} bytes, sha256 "
        f"{hashlib.sha256(cold['bytes']).hexdigest()}; with public inputs "
        f"{len(cold['file'])} bytes")
    require(len(cold["bytes"]) == CAIRO_FIB_PROOF_BYTES,
            f"proof size {len(cold['bytes'])} != {CAIRO_FIB_PROOF_BYTES}")
    log(f"[cairo-full] torch.cuda.max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB; {CAIRO_FIB_UNPACKED_PEAK} bytes before "
        f"the packed resident layout)")
    require(peak < CAIRO_FIB_UNPACKED_PEAK,
            "the cold prove's peak is not below the unpacked layout's")
    reset_counts(torch)
    fri_routes(torch, dev, "fri-routes cairo-full", cold, warm)
    read_counts("fri-routes cairo-full")
    return launches


def phase_memory(torch, dev) -> dict:
    """The port's device-memory layout at a size the unpacked one could not
    hold on one card: Cairo fibonacci_program(MEMORY_FIB_N), 2^21 rows x 52
    columns, bench options, one cold prove with donate_trace=True under
    LCP_DEBUG_MEM=1 (its per-phase memory lines), verified; every kernel
    launched.  The kernel tables that earlier phases cached are dropped
    first, and the peak is printed beside what was allocated before.  Then
    H3/H4 against their plain versions on one 2^23-point column, every pass
    of ntt_passes(23).  Returns the launches and the NTT errors."""
    import gc

    from lambdaworks_cairo_prover_tpu_torch.cairo import programs
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import (
        generate_cairo_proof, verify_cairo_proof)
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
    from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
    from lambdaworks_cairo_prover_tpu_torch.prover import kernels as pk

    pk._KERNEL_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    options = ProofOptions(**BENCH)
    reset_counts(torch)
    t0 = time.perf_counter()
    trace, pub = generate_prover_args(
        programs.fibonacci_program(MEMORY_FIB_N), device=dev)
    t_args = time.perf_counter() - t0
    rows, cols, stages = trace.n_rows, trace.n_cols, trace._timings
    require(rows == 1 << MEMORY_LOG,
            f"fibonacci_program({MEMORY_FIB_N}) pads to {rows} rows, not "
            f"2^{MEMORY_LOG}")
    os.environ["LCP_DEBUG_MEM"] = "1"
    try:
        t0 = time.perf_counter()
        proof = generate_cairo_proof(trace, pub, options, device=dev,
                                     donate_trace=True)
        t_prove = time.perf_counter() - t0
    finally:
        del os.environ["LCP_DEBUG_MEM"]
    launches = read_counts("memory")
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    require(trace.data is None, "donate_trace left the caller's trace")
    t0 = time.perf_counter()
    require(verify_cairo_proof(proof, pub, options),
            "the port's verifier rejected the 2^21-row Cairo proof")
    t_verify = time.perf_counter() - t0
    n_bytes = len(serialize_proof(proof))
    n_cols = len(proof.trace_ood_frame_evaluations[0])
    require(n_cols == CAIRO_COLS, f"{n_cols} columns, not {CAIRO_COLS}")
    rounds = ", ".join(f"{k} {v:.3f}" for k, v in proof._timings.items())
    log(f"[memory] fibonacci_program({MEMORY_FIB_N}): {rows} rows x {n_cols} "
        f"columns ({cols} main), LDE 2^{MEMORY_LOG + 2} points, blowup 4, 80 "
        f"queries, coset 3, grinding 20, donate_trace=True")
    log(f"[memory] {stages['vm_name']} VM {stages['vm']:.3f} s, trace build "
        f"{stages['trace_build']:.3f} s (host), ingest {stages['ingest']:.3f} "
        f"s; generate_prover_args {t_args:.3f} s")
    log(f"[memory] cold prove {t_prove:.3f} s ({rounds}); verify "
        f"{t_verify:.3f} s, accepted; proof size {n_bytes} bytes")
    log(f"[memory] torch.cuda.max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB; {base} bytes allocated before the phase), "
        f"max_memory_reserved {reserved} bytes ({reserved / 2**30:.2f} GiB)")
    del proof
    checks = NttChecks(torch, dev, MEMORY_LOG + 2)
    column = random_columns(torch, 1, 1 << (MEMORY_LOG + 2), dev)
    errs = checks.compare(column)
    del checks, column
    return {"launches": launches, "ntt_errs": errs, "peak": peak}


def _hints_fixtures(dev) -> None:
    """The proof files of cairo_programs.json and of the CASM contract,
    test options, against the JAX package's."""
    from lambdaworks_cairo_prover_tpu_torch.cairo import programs, stdlib
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        CairoLayout, CairoVersion)

    with open(os.path.join(FIXTURES, "cairo_programs.json")) as f:
        manifest = json.load(f)["proof_files"]
    runs = []
    for name, entry in sorted(manifest.items()):
        module, gen = entry["program"].split(":")
        mod = {"cairo/programs.py": programs, "cairo/stdlib.py": stdlib}[module]
        runs.append((name, getattr(mod, gen)(*entry["args"]),
                     {"layout": CairoLayout[entry["layout"]]}))
    with open(os.path.join(FIXTURES, "synthetic_contract.casm"), "rb") as f:
        runs.append(("cairo1_synthetic_test_options.proof", f.read(),
                     {"cairo_version": CairoVersion.V1}))
    for name, program, options in runs:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            ref = f.read()
        res = _cairo(program, bench=False, dev=dev, **options)
        log(f"[cairo-hints] {name}: {res['trace'].n_rows} rows x "
            f"{res['columns']} columns, {res['trace']._timings['vm_name']} "
            f"VM, {len(res['file'])} bytes, equal to the JAX proof file: "
            f"{res['file'] == ref}")
        require(res["file"] == ref, f"{name}: bytes differ from the JAX fixture")


def phase_cairo_hints(torch, dev) -> dict:
    """Programs with builtins and hints: the fixtures, the 2^16-row digest
    and the slice's real-size run at 2^19 rows x 61 columns."""
    from lambdaworks_cairo_prover_tpu_torch.cairo import stdlib

    _hints_fixtures(dev)
    with open(os.path.join(
            FIXTURES, "cairo_compare_lesser_array_bench_digest.json")) as f:
        digest = json.load(f)
    require(digest["options"] == BENCH, "hinted digest fixture has other "
            "options")
    res = _cairo(stdlib.compare_lesser_array_program(digest["length"]),
                 bench=True, dev=dev)
    got = hashlib.sha256(res["bytes"]).hexdigest()
    log(f"[cairo-hints] hinted extra compare_lesser_array_program("
        f"{digest['length']}), bench options: {res['trace'].n_rows} rows x "
        f"{res['columns']} "
        f"columns, {len(res['bytes'])} bytes, prove {res['prove_s']:.3f} s, "
        f"sha256 {got}, equal to the JAX digest: {got == digest['sha256']}")
    require((res["trace"].n_rows, res["columns"]) ==
            (digest["trace_rows"], digest["trace_columns"]),
            "trace shape differs from the JAX fixture's")
    require(res["pub"].serialize().hex() == digest["public_inputs_hex"],
            "public inputs differ from the JAX fixture's")
    require(got == digest["sha256"], "the hinted 2^16-row bench proof "
            "differs from the JAX digest")

    program = stdlib.compare_lesser_array_program(HINTS_LENGTH)
    reset_counts(torch)
    cold = _cairo(program, bench=True, dev=dev)
    launches = read_counts("cairo-hints")
    peak = torch.cuda.max_memory_allocated()
    warm = _cairo(program, bench=True, dev=dev,
                  args=(cold["trace"], cold["pub"]))
    require(warm["bytes"] == cold["bytes"], "cold and warm hinted proofs differ")
    trace, stages = cold["trace"], cold["trace"]._timings
    require((trace.n_rows, cold["columns"]) == (1 << FULL_LOG, HINTS_COLS),
            f"expected 2^{FULL_LOG} rows x {HINTS_COLS} columns, got "
            f"{trace.n_rows} x {cold['columns']}")
    require(stages["vm_name"] == "python", "the hinted program left the "
            "python VM")
    log(f"[cairo-hints] compare_lesser_array_program({HINTS_LENGTH}): "
        f"{cold['pub'].num_steps} steps, {trace.n_rows} rows x "
        f"{cold['columns']} columns ({trace.n_cols} main), blowup 4, 80 "
        f"queries, coset 3, grinding 20")
    log(f"[cairo-hints] {stages['vm_name']} VM {stages['vm']:.3f} s")
    log(f"[cairo-hints] trace build {stages['trace_build']:.3f} s (host)")
    log(f"[cairo-hints] ingest {stages['ingest']:.3f} s; "
        f"generate_prover_args {cold['args_s']:.3f} s")
    for tag, r in (("cold", cold), ("warm", warm)):
        log(f"[cairo-hints] {tag} prove {r['prove_s']:.3f} s")
        rounds = ", ".join(f"{k} {v:.3f}" for k, v in r["timings"].items())
        log(f"[cairo-hints] {tag} rounds: {rounds}")
        log(f"[cairo-hints] {tag} verify {r['verify_s']:.3f} s, accepted; "
            f"wrong public inputs rejected")
    log(f"[cairo-hints] proof size {len(cold['bytes'])} bytes, sha256 "
        f"{hashlib.sha256(cold['bytes']).hexdigest()}; with public inputs "
        f"{len(cold['file'])} bytes; cold equals warm")
    log(f"[cairo-hints] torch.cuda.max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    reset_counts(torch)
    fri_routes(torch, dev, "fri-routes cairo-hints", cold, warm)
    read_counts("fri-routes cairo-hints")
    return launches


def phase_rc(dev) -> None:
    """bench.py's rc workload at 2^16 rows against the JAX digest: the value
    count from bench.py's calibration loop, as the fixture tool copies it
    (``rc_value_count``: it takes the package's program, VM and
    ``generate_prover_args``, here the port's)."""
    import functools

    from lambdaworks_cairo_prover_tpu_torch.cairo import native as native_vm
    from lambdaworks_cairo_prover_tpu_torch.cairo.programs import rc_program
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
        generate_prover_args)
    from lambdaworks_cairo_prover_tpu_torch.cairo.vm import run_program

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_torch_fixtures import rc_value_count, rc_values

    with open(os.path.join(FIXTURES, "cairo_rc_bench_digest.json")) as f:
        digest = json.load(f)
    require(digest["options"] == BENCH and digest["log2_rows"] == RC_LOG_ROWS,
            "the rc digest fixture has other options or rows")
    runner = (native_vm.run_program_native if native_vm.available()
              else run_program)
    t0 = time.perf_counter()
    k = rc_value_count(rc_program, runner,
                       functools.partial(generate_prover_args, device=dev),
                       RC_LOG_ROWS)
    t_cal = time.perf_counter() - t0
    require(k == digest["k"],
            f"calibrated {k} values, the JAX package {digest['k']}")
    res = _cairo(rc_program(rc_values(k)), bench=True, dev=dev)
    got = hashlib.sha256(res["bytes"]).hexdigest()
    log(f"[rc] bench.py's rc program, {k} values (calibrated in {t_cal:.2f} "
        f"s, as the JAX package): {res['trace'].n_rows} rows x "
        f"{res['columns']} columns, {res['trace']._timings['vm_name']} VM, "
        f"bench options, {len(res['bytes'])} bytes, prove {res['prove_s']:.3f} "
        f"s, verify {res['verify_s']:.3f} s, sha256 {got}, equal to the JAX "
        f"digest: {got == digest['sha256']}")
    require((res["trace"].n_rows, res["columns"]) ==
            (digest["trace_rows"], digest["trace_columns"]),
            "trace shape differs from the JAX fixture's")
    require(hashlib.sha256(res["pub"].serialize()).hexdigest() ==
            digest["public_inputs_sha256"],
            "public inputs differ from the JAX fixture's")
    require(got == digest["sha256"], "rc bench proof differs from the JAX digest")


_TOY_SCRIPT = r"""
import json, os, sys
os.environ["LCP_FIELD"] = "f257"
sys.path.insert(0, sys.argv[1])
import torch
from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
    FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
from lambdaworks_cairo_prover_tpu_torch.field.params import P
from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove
from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

pub = FibonacciPublicInputs(a0=1, a1=1)
options = ProofOptions.default_test_options()
trace = fibonacci_trace([1, 1], int(sys.argv[2]), device="cuda")
proof = prove(trace, pub, options, FibonacciAIR, device="cuda")
print("TOY=" + json.dumps({
    "p": P, "device": str(trace.data.device),
    "proof_hex": serialize_proof(proof).hex(),
    "verified": verify(proof, pub, options, FibonacciAIR),
    "wrong_pub_verified": verify(proof, FibonacciPublicInputs(a0=2, a1=1),
                                 options, FibonacciAIR),
    "launches": {"mont_mul": cf.mont_mul.launches,
                 "add_sub_mod": cf.add_sub_mod.launches,
                 "ntt_dif_stages": cn.ntt_dif_stages.launches,
                 "ntt_dif_local": cn.ntt_dif_local.launches,
                 "keccak_rows": ck.keccak_rows.launches,
                 "keccak_pairs": ck.keccak_pairs.launches,
                 "keccak_grind": ck.keccak_grind.launches,
                 "mont_batch_inverse": cs.mont_batch_inverse.launches,
                 "mont_prefix_product": cs.mont_prefix_product.launches}}))
"""


# the toy field's launches: H1-H6 bake the Stark252 prime and refuse
# GF(257); Keccak does not depend on the field (16 limbs a felt there too),
# so K1 and K2 hash its trees; grinding factor 1 searches on the host
TOY_LAUNCHES = {"mont_mul": False, "add_sub_mod": False,
                "ntt_dif_stages": False, "ntt_dif_local": False,
                "keccak_rows": True, "keccak_pairs": True,
                "keccak_grind": False, "mont_batch_inverse": False,
                "mont_prefix_product": False}


def phase_toy_field() -> None:
    """simple_fibonacci over GF(257) on the card in a child process (the
    field is fixed at import): the JAX package's proof bytes, verified, no
    H1-H4 launch, K1 and K2 launched (TOY_LAUNCHES)."""
    env = dict(os.environ)
    env["LCP_FIELD"] = "f257"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _TOY_SCRIPT, ROOT,
                           str(TOY_ROWS)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=env)
    require(proc.returncode == 0, f"the GF(257) child failed: {proc.stdout}\n"
            f"{proc.stderr}")
    out = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("TOY=")][-1][len("TOY="):])
    with open(os.path.join(
            FIXTURES, "simple_fibonacci_8_f257_test_options.proof"), "rb") as f:
        ref = f.read()
    data = bytes.fromhex(out["proof_hex"])
    log(f"[toy-field] LCP_FIELD=f257 (p = {out['p']}) simple_fibonacci, "
        f"{TOY_ROWS} rows on {out['device']}, test options: {len(data)} bytes, "
        f"equal to the JAX GF(257) proof: {data == ref}; verified "
        f"{out['verified']}, wrong public inputs verified "
        f"{out['wrong_pub_verified']}; kernel launches {out['launches']} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(out["p"] == 257 and out["device"].startswith("cuda"),
            "the child did not prove over GF(257) on the card")
    require(data == ref, "the GF(257) proof differs from the JAX package's")
    require(out["verified"] and not out["wrong_pub_verified"],
            "the GF(257) proof did not verify, or wrong inputs did")
    require({k: v > 0 for k, v in out["launches"].items()} == TOY_LAUNCHES,
            f"over GF(257) the launches {out['launches']} are not "
            f"{TOY_LAUNCHES} (launched or not)")


def phase_cli(dev) -> None:
    """The command line as a user runs it: a child process, CUDA by default."""
    import tempfile

    from lambdaworks_cairo_prover_tpu_torch.cairo import programs

    prog = programs.fibonacci_program(10)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fib10.json")
        with open(path, "w") as f:
            json.dump({"data": [hex(x) for x in prog.data],
                       "identifiers": {"__main__.main": {"pc": prog.main_pc}},
                       "builtins": prog.builtins}, f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.cli", "prove_and_verify", path],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
    log(f"[cli] prove_and_verify fib10.json: exit code {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; {proc.stdout.strip().splitlines()}")
    require(proc.returncode == 0 and "Verification succeded" in proc.stdout,
            f"the CLI failed: {proc.stdout}\n{proc.stderr}")


_PARALLEL_SCRIPT = r"""
import datetime, hashlib, json, sys, time, warnings
root, rank, world, store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
bench, fib_rows, casm_path = json.loads(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
sys.path.insert(0, root)
warnings.filterwarnings("ignore", category=FutureWarning,
                        message=".*all_gather_into_tensor.*")
import torch
import torch.distributed as dist
from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
    FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
from lambdaworks_cairo_prover_tpu_torch.cairo import programs
from lambdaworks_cairo_prover_tpu_torch.cairo.air import (
    generate_cairo_proof, verify_cairo_proof)
from lambdaworks_cairo_prover_tpu_torch.cairo.runner import (
    CairoVersion, generate_prover_args)
from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
from lambdaworks_cairo_prover_tpu_torch.parallel.sharding import make_mesh
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.proof.serde import (
    serialize_proof, write_proof_file)
from lambdaworks_cairo_prover_tpu_torch.prover.prove import prove
from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=600))
mesh = make_mesh(world)
wrappers = (cf.mont_mul, cf.add_sub_mod, cn.ntt_dif_stages, cn.ntt_dif_local,
            ck.keccak_rows, ck.keccak_pairs, ck.keccak_grind,
            cs.mont_batch_inverse, cs.mont_prefix_product)


def counted(fn):
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {w.__name__: w.launches
                                           for w in wrappers}


out = {"rank": rank, "device": str(dev), "backend": dist.get_backend()}
test = ProofOptions.default_test_options()
trace, pub = generate_prover_args(programs.fibonacci_program(5), device=dev)
proof, secs, launches = counted(lambda: generate_cairo_proof(
    trace, pub, test, device=dev, mesh=mesh))
out["cairo_fib5"] = {
    "sha256": hashlib.sha256(write_proof_file(proof, pub.serialize())).hexdigest(),
    "verified": verify_cairo_proof(proof, pub, test), "prove_s": secs,
    "launches": launches}
options, fpub = ProofOptions(**bench), FibonacciPublicInputs(a0=1, a1=1)
proof, secs, launches = counted(lambda: prove(
    fibonacci_trace([1, 1], fib_rows, device=dev), fpub, options,
    FibonacciAIR, device=dev, mesh=mesh))
out["simple_fibonacci"] = {
    "sha256": hashlib.sha256(serialize_proof(proof)).hexdigest(),
    "verified": verify(proof, fpub, options, FibonacciAIR), "prove_s": secs,
    "launches": launches}
# BASELINE config 4's Cairo1 contract, columns sharded
with open(casm_path, "rb") as f:
    trace, pub = generate_prover_args(f.read(), cairo_version=CairoVersion.V1,
                                      device=dev)
proof, secs, launches = counted(lambda: generate_cairo_proof(
    trace, pub, test, device=dev, mesh=mesh, shard_axis="columns"))
out["cairo1_columns"] = {
    "sha256": hashlib.sha256(write_proof_file(proof, pub.serialize())).hexdigest(),
    "verified": verify_cairo_proof(proof, pub, test), "prove_s": secs,
    "launches": launches}
dist.barrier()  # no rank tears its connections down while another uses them
dist.destroy_process_group()
print("PAR=" + json.dumps(out), flush=True)
"""


def four_step_kernels(torch, dev) -> dict:
    """H3 and H4 against their plain versions, exactly, and their times at
    the local transforms of a 2^LDE_LOG-point, CAIRO_COLS-column transform
    over PARALLEL_RANKS ranks (four_step_plan: R x C points; C/D rows of R
    points, then R/D rows of C points): every pass of ``ntt_passes`` of
    each, on seeded random columns; the plain version goes one trace
    column (rows x points) at a time."""
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
    from lambdaworks_cairo_prover_tpu_torch.parallel.four_step import (
        four_step_plan)

    d = PARALLEL_RANKS
    r, c = four_step_plan(1 << LDE_LOG, d)
    out = {"ntt_dif_stages": [], "ntt_dif_local": []}
    for rows, n in ((c // d, r), (r // d, c)):
        log_n = n.bit_length() - 1
        tw = cn.twiddle_table(log_n, False, dev)
        twp = cn.packed_twiddle_table(log_n, False, dev)
        cn.bitrev_indices(log_n, dev)  # built outside the plain times
        x = random_columns(torch, CAIRO_COLS * rows, n, dev)
        dst = torch.empty_like(x)
        shape = f"(16, {CAIRO_COLS}, {rows}, {n})"
        for p in cn.ntt_passes(log_n):
            if p.local:
                name, n_tw = "ntt_dif_local", 1 << p.n_stages

                def run(src, out_):
                    return cn.ntt_dif_local(src, out_, twp, p.n_stages,
                                            p.natural)

                def plain(v):
                    return cn.dif_local_plain(v, tw, p.n_stages, p.natural)
            else:
                name = "ntt_dif_stages"
                n_tw = (1 << (p.log_m_hi + 1)) - (
                    1 << (p.log_m_hi + 1 - p.n_stages))

                def run(src, out_):
                    return cn.ntt_dif_stages(src, out_, twp, p.log_m_hi,
                                             p.n_stages)

                def plain(v):
                    return cn.dif_stages_plain(v, tw, p.log_m_hi, p.n_stages)
            got = run(x, dst).clone()
            err, plain_ms = 0, 0.0
            for k in range(CAIRO_COLS):
                part = slice(k * rows, (k + 1) * rows)
                want, t = timed(torch, lambda: plain(x[:, part]))
                plain_ms += t
                err = max(err, max_abs_err(torch, got[:, part], want))
            del got
            n_points = x[0].numel()
            rec = {"shape": shape, "log_m_hi": p.log_m_hi,
                   "n_stages": p.n_stages, "natural": p.natural,
                   "ms": cuda_ms(torch, lambda: run(x, dst), 10),
                   "plain_ms": plain_ms, "max_abs_err": err,
                   # the array read and written once, the pass's twiddles
                   # read once
                   **bound(2 * ELEM_BYTES * n_points + TWIDDLE_BYTES * n_tw,
                           butterfly_ops(n_points, p.log_m_hi, p.n_stages))}
            out[name].append(rec)
            log(f"[parallel] {name} at {shape}, stages {p.log_m_hi} .. "
                f"{p.log_m_hi - p.n_stages + 1}"
                f"{', natural order' if p.natural else ''}: max_abs_err "
                f"{err}; {rec['ms']:.4f} ms kernel, {plain_ms:.4f} ms plain, "
                f"{bound_text(rec)}")
            require(err == 0, f"{name} disagrees with its plain version at "
                    f"the four-step shape {shape}")
        del x, dst
    return out


def phase_parallel(torch, dev) -> dict:
    """The multi-device prover (``prove(mesh=...)``, parallel/):
    Cairo fib(CAIRO_FIB_N) at full width on a one-rank NCCL mesh (the
    single-device sha256, cold and warm, verified; every kernel launched);
    PARALLEL_RANKS gloo ranks sharing the card (child processes: the
    four-step's all-to-alls, the halo, the sharded trees and openings)
    prove Cairo fib(5) and simple_fibonacci with the bench options to the
    JAX package's bytes and launch H1 and H3/H4 on every rank; and H3/H4 at
    the four-step's local shapes.  Returns the one-rank run's launches and
    the four-step kernel records."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from lambdaworks_cairo_prover_tpu_torch.cairo import programs
    from lambdaworks_cairo_prover_tpu_torch.cairo.runner import CairoVersion
    from lambdaworks_cairo_prover_tpu_torch.parallel.sharding import make_mesh

    program = programs.fibonacci_program(CAIRO_FIB_N)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
        try:
            mesh = make_mesh(1)
            reset_counts(torch)
            cold = _cairo(program, bench=True, dev=dev, mesh=mesh)
            launches = read_counts("parallel")
            peak = torch.cuda.max_memory_allocated()
            warm = _cairo(program, bench=True, dev=dev, mesh=mesh,
                          args=(cold["trace"], cold["pub"]))
            # BASELINE config 4: the Cairo1 contract, columns sharded, with
            # grinding on the card, against the single-device proof
            with open(CASM_PATH, "rb") as f:
                casm = f.read()
            single = _cairo(casm, bench=True, dev=dev,
                            cairo_version=CairoVersion.V1)
            reset_counts(torch)
            columns = _cairo(casm, bench=True, dev=dev, mesh=mesh,
                             shard_axis="columns",
                             args=(single["trace"], single["pub"]))
            columns_launches = {name: w.launches
                                for name, w in kernel_wrappers().items()}
        finally:
            dist.destroy_process_group()
    log(f"[parallel] one NCCL rank, the synthetic Cairo1 contract "
        f"({single['trace'].n_rows} rows x {columns['columns']} columns), "
        f"shard_axis='columns', bench options: prove {columns['prove_s']:.3f}"
        f" s, verified, wrong public inputs rejected; {len(columns['file'])} "
        f"bytes, equal to the single-device proof file: "
        f"{columns['file'] == single['file']}; launches {columns_launches}")
    require(columns["file"] == single["file"], "the columns-sharded Cairo1 "
            "proof differs from the single-device proof")
    require(all(columns_launches[k] > 0 for k in (
        "mont_mul", "add_sub_mod", "ntt_dif_local", "keccak_rows",
        "keccak_pairs", "keccak_grind", "mont_batch_inverse",
        "mont_prefix_product")), "[parallel] the columns-sharded Cairo1 prove "
            "did not launch every kernel of its path (H3 has no pass under "
            "2^11 points)")
    digest = hashlib.sha256(cold["bytes"]).hexdigest()
    log(f"[parallel] one NCCL rank, fibonacci_program({CAIRO_FIB_N}): "
        f"{cold['trace'].n_rows} rows x {cold['columns']} columns, "
        f"shard_axis='domain', bench options")
    for tag, r in (("cold", cold), ("warm", warm)):
        rounds = ", ".join(f"{k} {v:.3f}" for k, v in r["timings"].items())
        log(f"[parallel] {tag} prove {r['prove_s']:.3f} s ({rounds}); verify "
            f"{r['verify_s']:.3f} s, accepted; wrong public inputs rejected")
    log(f"[parallel] torch.cuda.max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB); sha256 {digest}, equal to the "
        f"single-device proof's: {digest == CAIRO_FIB_SHA256}")
    require(digest == CAIRO_FIB_SHA256 and warm["bytes"] == cold["bytes"],
            "the one-rank sharded proof differs from the single-device proof")

    with open(os.path.join(FIXTURES, "cairo_fib5_test_options.proof"),
              "rb") as f:
        want_fib5 = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(FIXTURES, "cairo1_synthetic_test_options.proof"),
              "rb") as f:
        want_cairo1 = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(FIXTURES, "simple_fibonacci_bench_digest.json")) as f:
        fib_digest = json.load(f)
    require(fib_digest["options"] == BENCH, "digest fixture has other options")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # each rank writes to a file: a full pipe would stall a rank inside
        # a collective while this process waits on another rank
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(PARALLEL_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _PARALLEL_SCRIPT, ROOT, str(r),
             str(PARALLEL_RANKS), os.path.join(tmp, "store"),
             json.dumps(BENCH), str(fib_digest["trace_length"]), CASM_PATH],
            cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(PARALLEL_RANKS)]
        try:
            deadline = time.monotonic() + 600
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
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
    ranks = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        lines = [ln for ln in text.splitlines() if ln.startswith("PAR=")]
        require(p.returncode == 0 and lines, f"[parallel] gloo rank {r} "
                f"failed (exit code {p.returncode}):\n{text[-4000:]}")
        ranks.append(json.loads(lines[-1][len("PAR="):]))
    for res in ranks:
        for name, want in (("cairo_fib5", want_fib5),
                           ("simple_fibonacci", fib_digest["sha256"]),
                           ("cairo1_columns", want_cairo1)):
            got = res[name]
            log(f"[parallel] gloo rank {res['rank']} of {PARALLEL_RANKS} on "
                f"{res['device']}, {name}: prove {got['prove_s']:.3f} s, "
                f"equal to the JAX package's: {got['sha256'] == want}, "
                f"verified {got['verified']}, launches {got['launches']}")
            require(got["sha256"] == want and got["verified"],
                    f"[parallel] rank {res['rank']}: the sharded {name} proof "
                    f"differs from the JAX package's or does not verify")
            counts = got["launches"]
            n_ntt = counts["ntt_dif_stages"] + counts["ntt_dif_local"]
            require(counts["mont_mul"] > 0 and n_ntt > 0,
                    f"[parallel] rank {res['rank']}: no H1 or no H3/H4 launch")
            # every rank hashes its block's leaves and nodes; grinding runs
            # on the card above factor 12 (the bench options' 20), on the
            # host for the test options' 1
            grinds = name == "simple_fibonacci"
            require(counts["keccak_rows"] > 0 and counts["keccak_pairs"] > 0
                    and (counts["keccak_grind"] > 0) == grinds,
                    f"[parallel] rank {res['rank']}, {name}: Keccak launches "
                    f"{counts}, expected K1 and K2"
                    f"{' and K3' if grinds else ' and no K3'}")
    log(f"[parallel] {PARALLEL_RANKS} gloo ranks on one card: "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")
    return {"launches": launches, "columns_launches": columns_launches,
            "four_step": four_step_kernels(torch, dev)}


def scale_tool():
    """tools/config5_scale_torch.py as a module (the proves, the telemetry)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import config5_scale_torch

    return config5_scale_torch


def drop_prove_caches(torch) -> None:
    """Release the kernel tables, twiddles and domain tables that earlier
    proves cached, and the allocator's free blocks."""
    import gc

    from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn
    from lambdaworks_cairo_prover_tpu_torch.parallel import sharded_kernels
    from lambdaworks_cairo_prover_tpu_torch.prover import kernels as pk

    pk._KERNEL_CACHE.clear()
    sharded_kernels._SHARDED_CACHE.clear()
    nttc._powers_cache.clear()
    cn.forget_tables()
    gc.collect()
    torch.cuda.empty_cache()


def exact_err(torch, a, b) -> int:
    """max_abs_err without its int64 copies where the two are equal."""
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return 0 if torch.equal(a, b) else max_abs_err(torch, a, b)


def scale_kernels(torch, dev, per_perm: int) -> dict:
    """The kernels at [scale]'s new shapes against their plain versions on
    the card, bit for bit, with their times and bounds: the whole NTT
    (H3 + H4) at SCALE_NTT_LOGS, one column, forward and inverse; K2's tree
    and K1's single-felt leaves at SCALE_TREE_LOGS and SCALE_LEAF_LOGS; H5
    at the 2^23-row prove's DEEP input with zeros planted."""
    from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd
    from lambdaworks_cairo_prover_tpu_torch.field.params import P
    from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
    from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as kd
    from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
    from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

    out = {"whole_ntt": [], "trees": [], "leaves": [], "inverse": None}
    for log_n in SCALE_NTT_LOGS:
        n = 1 << log_n
        v = random_columns(torch, 1, n, dev).reshape(16, n)
        cn.bitrev_indices(log_n, dev)  # built outside the plain times
        for inverse in (False, True):
            # the transform itself (no 1/n: that product is H1's, and its
            # plain version at 2^26 points needs some 40 GB of int64)
            got = nttc.transform(v, inverse)
            cn.twiddle_table(log_n, inverse, dev)
            want, plain_ms = timed(torch, lambda: cn.ntt_plain(v, inverse))
            err = exact_err(torch, got, want)
            del got, want
            rec = {"shape": shape_text(v), "inverse": inverse,
                   "passes": [tuple(p) for p in cn.ntt_passes(log_n)],
                   "max_abs_err": err, "plain_ms": plain_ms,
                   "ms": cuda_ms(torch, lambda: cn.ntt_cuda(v, inverse), 3),
                   # the array read and written once, the table of n
                   # twiddles read once; every stage
                   **bound(2 * ELEM_BYTES * n + TWIDDLE_BYTES * n,
                           butterfly_ops(n, log_n - 1, log_n))}
            out["whole_ntt"].append(rec)
            log(f"[scale] whole NTT 2^{log_n} {'inverse' if inverse else 'forward'}"
                f" at {rec['shape']} (passes {rec['passes']}): max_abs_err "
                f"{err}; {rec['ms']:.4f} ms (H3 + H4), {plain_ms:.1f} ms "
                f"plain, {bound_text(rec)}")
            require(err == 0, f"the NTT disagrees with the plain NTT at "
                    f"2^{log_n} points (inverse {inverse})")
        del v
        cn.forget_tables(dev)  # 4 GiB a direction of limbs at 2^26
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    top = 1 << max(SCALE_TREE_LOGS)
    leaves = torch.randint(-2**31, 2**31 - 1, (top, 8), dtype=torch.int32,
                           device=dev, generator=gen).view(torch.int64)
    for log_n in SCALE_TREE_LOGS:
        n = 1 << log_n
        x = leaves[:n]
        before = ck.keccak_pairs.launches
        got = ck.keccak_tree(x)
        launches = ck.keccak_pairs.launches - before
        want, plain_ms = timed(torch, lambda: kd.hash_tree_plain(x))
        err = exact_err(torch, got, want)
        del got, want
        rec = {"n": n, "tree_launches": launches, "max_abs_err": err,
               "counts": ck.tree_counts(n),
               "ms": cuda_ms(torch, lambda: ck.keccak_tree(x), 3),
               "plain_ms": plain_ms,
               # the leaves read once, the n - 1 nodes written once
               **bound(32 * n + 32 * (n - 1), per_perm * (n - 1))}
        out["trees"].append(rec)
        log(f"[scale] keccak_tree over {n} leaves ({rec['counts']} group "
            f"counts): max_abs_err {err}, {launches} launch; "
            f"{rec['ms']:.4f} ms, {plain_ms:.1f} ms plain, {bound_text(rec)}")
        require(err == 0 and launches == 1, f"keccak_pairs disagrees with its "
                f"plain version on the tree over {n} leaves, or took "
                f"{launches} launches")
    del leaves

    for log_n in SCALE_LEAF_LOGS:
        n = 1 << log_n
        col = random_columns(torch, 1, n, dev).reshape(16, n)
        got = kd.hash_felt_leaves(col)
        want, plain_ms = timed(
            torch, lambda: kd.hash_felt_rows_plain(col[:, :, None], 1))
        err = exact_err(torch, got, want)
        del got, want
        rec = {"shape": shape_text(col), "max_abs_err": err,
               "ms": cuda_ms(torch, lambda: kd.hash_felt_leaves(col), 3),
               "plain_ms": plain_ms,
               # the limbs read once, the digests written once
               **bound(ELEM_BYTES * n + 32 * n,
                       per_perm * keccak_blocks(1) * n)}
        out["leaves"].append(rec)
        log(f"[scale] keccak_rows, single-felt leaves at {rec['shape']}: "
            f"max_abs_err {err}; {rec['ms']:.4f} ms kernel, {plain_ms:.1f} "
            f"ms plain, {bound_text(rec)}")
        require(err == 0, f"keccak_rows disagrees with its plain version at "
                f"{rec['shape']}")
        del col

    n = SCALE_DEEP_N
    x = scan_input(torch, n, dev, "mont_batch_inverse")
    got = cs.mont_batch_inverse(x)
    want, plain_ms = timed(torch, lambda: cs.batch_inverse_plain(x))
    err = exact_err(torch, got, want)
    idx = [0, 1, n // 2 - 1, n // 2, n // 2 + 1, n - 2, n - 1]
    xs, gs = fd.to_ints(x[:, idx]), fd.to_ints(got[:, idx])
    del got, want
    nonzero = int((x != 0).any(dim=0).sum())
    rec = {"shape": shape_text(x), "n": n, "nonzero": nonzero,
           "max_abs_err": err, "plain_ms": plain_ms,
           "ms": cuda_ms(torch, lambda: cs.mont_batch_inverse(x), 3),
           # the elements read once and written once; 3 products a nonzero
           # element and one root inversion
           **bound(2 * ELEM_BYTES * n,
                   OPS_MUL * (3 * nonzero + root_products()))}
    out["inverse"] = rec
    log(f"[scale] mont_batch_inverse at {rec['shape']} (DEEP at 2^"
        f"{SCALE_BIG_LOG} rows, {n - nonzero} zeros planted): max_abs_err "
        f"{err}; {rec['ms']:.4f} ms kernel, {plain_ms:.1f} ms plain, "
        f"{bound_text(rec)}")
    require(err == 0 and gs == [pow(v, P - 2, P) for v in xs],
            f"mont_batch_inverse disagrees with its plain version or with "
            f"Python ints at (16, {n})")
    del x
    torch.cuda.empty_cache()
    return out


def scale_records(kernels: dict, name: str) -> list:
    """The [scale] records of one kernel for the kernels line."""
    return {"ntt_dif_stages": kernels["whole_ntt"],
            "ntt_dif_local": kernels["whole_ntt"],
            "keccak_pairs": kernels["trees"],
            "keccak_rows": kernels["leaves"],
            "mont_batch_inverse": [kernels["inverse"]]}.get(name, [])


def phase_scale(torch, dev, per_perm: int) -> dict:
    """BASELINE config 5 on the card (the port's tools/config5_scale_torch.py
    in this process and in child processes): simple_fibonacci at 2^SCALE_LOG
    rows with the bench options, cold and warm, single-device and on a
    one-rank NCCL mesh (domain-sharded), verified, all four proofs equal,
    every kernel of the path launched in the single-device cold prove
    (launches_scale); at 2^SCALE_BIG_LOG rows single-device (the
    composition's LDE of 2^26 points, over the old 2^24 cap), verified, with
    its peak memory and per-phase bytes; the kernels at the new shapes
    (scale_kernels); and SCALE_GLOO_LOG rows on PARALLEL_RANKS gloo ranks
    sharing the card (the tool's --ranks children), every rank's proof equal
    to the single-device one, H1, H3/H4, K1 and K2 launched on every rank,
    the collectives' bytes by site."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from lambdaworks_cairo_prover_tpu_torch.parallel.sharding import make_mesh

    c5 = scale_tool()
    options = c5._options(True)
    drop_prove_caches(torch)
    t0 = time.perf_counter()
    trace = c5.fib_trace(SCALE_LOG, dev)
    trace_s = time.perf_counter() - t0
    log(f"[scale] simple_fibonacci at 2^{SCALE_LOG} rows (LDE 2^"
        f"{SCALE_LOG + 2} points), bench options; trace {trace_s:.3f} s "
        f"(python ints, then the ingest)")
    runs, shas = {}, {}

    def one(tag, mesh=None):
        with c5.Collectives() as coll:
            proof, data, wall = c5.prove_fib(trace, options, dev, mesh)
        v = c5.verify_fib(proof, options)
        rounds = ", ".join(f"{k} {t:.3f}" for k, t in proof._timings.items())
        shas[tag] = hashlib.sha256(data).hexdigest()
        log(f"[scale] {tag}: prove {wall:.3f} s ({rounds}); verify "
            f"{v['verify_s']:.3f} s, {len(data)} bytes, sha256 {shas[tag]}"
            + (f"; collectives {coll.by_site}" if mesh is not None else ""))
        require(v["verified"] and v["wrong_public_inputs_rejected"],
                f"[scale] {tag}: the proof does not verify, or wrong public "
                f"inputs were accepted")
        runs[tag] = {"prove_s": wall, "timings": dict(proof._timings)}

    reset_counts(torch)
    one("single-device cold")
    launches = read_counts("scale")
    peak = torch.cuda.max_memory_allocated()
    one("single-device warm")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
        try:
            mesh = make_mesh(1)
            one("one NCCL rank cold", mesh)
            one("one NCCL rank warm", mesh)
        finally:
            dist.destroy_process_group()
    require(len(set(shas.values())) == 1, f"[scale] the 2^{SCALE_LOG}-row "
            f"proofs differ: {shas}")
    log(f"[scale] 2^{SCALE_LOG} rows: the four proofs equal; single-device "
        f"cold peak {peak} bytes ({peak / 2**30:.2f} GiB)")
    del trace
    drop_prove_caches(torch)

    # 2^23 rows on one card: the composition's halves are evaluated on 2^26
    # points, which the port refused before
    t0 = time.perf_counter()
    trace = c5.fib_trace(SCALE_BIG_LOG, dev)
    big_trace_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with c5.PhaseMemory(dev) as mem:
        proof, data, wall = c5.prove_fib(trace, options, dev)
    big_peak = torch.cuda.max_memory_allocated()
    v = c5.verify_fib(proof, options)
    rounds = ", ".join(f"{k} {t:.3f}" for k, t in proof._timings.items())
    log(f"[scale] 2^{SCALE_BIG_LOG} rows single-device: trace {big_trace_s:.3f}"
        f" s, cold prove {wall:.3f} s ({rounds}); verify {v['verify_s']:.3f} "
        f"s; {len(data)} bytes, sha256 {hashlib.sha256(data).hexdigest()}; "
        f"peak {big_peak} bytes ({big_peak / 2**30:.2f} GiB)")
    for p in mem.phases:
        log(f"[scale] 2^{SCALE_BIG_LOG} rows, {p['phase']}: allocated "
            f"{p['allocated_bytes']}, peak {p['peak_bytes']}, reserved "
            f"{p['reserved_bytes']} bytes")
    require(v["verified"] and v["wrong_public_inputs_rejected"],
            f"[scale] the 2^{SCALE_BIG_LOG}-row proof does not verify, or "
            f"wrong public inputs were accepted")
    del trace, proof, data
    drop_prove_caches(torch)

    kernels = scale_kernels(torch, dev, per_perm)
    drop_prove_caches(torch)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "config5_scale_torch.py"),
         "--ranks", str(PARALLEL_RANKS), "--log-rows", str(SCALE_GLOO_LOG),
         "--bench-options", "--equality-log-rows", "0", "--timeout", "400"],
        cwd=ROOT, capture_output=True, text=True, timeout=460)
    gloo_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines, f"[scale] config5_scale_torch.py "
            f"--ranks {PARALLEL_RANKS} failed (exit code {proc.returncode}):\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-6000:]}")
    for line in lines[:-1]:
        log(f"[scale] {line}")
    rec = json.loads(lines[-1])
    require(rec["ok"] and rec["ranks_equal"] and rec["single_device"]["equal"]
            and rec["n_devices"] == PARALLEL_RANKS,
            f"[scale] the {PARALLEL_RANKS}-rank proofs differ from the "
            f"single-device proof or do not verify")
    for r in rec["ranks"]:
        counts = r["launches"]
        log(f"[scale] gloo rank {r['rank']} of {PARALLEL_RANKS}: cold prove "
            f"{r['prove_wall_s']['cold']:.3f} s, warm "
            f"{r['prove_wall_s']['warm']:.3f} s, peak "
            f"{r['peak_device_bytes']['cold']} bytes, launches {counts}")
        require(counts["mont_mul"] > 0 and counts["keccak_rows"] > 0
                and counts["keccak_pairs"] > 0
                and counts["ntt_dif_stages"] + counts["ntt_dif_local"] > 0,
                f"[scale] gloo rank {r['rank']}: H1, H3/H4, K1 or K2 not "
                f"launched")
    for site, c in rec["collective_bytes_by_site"].items():
        log(f"[scale] {PARALLEL_RANKS} gloo ranks, 2^{SCALE_GLOO_LOG} rows, "
            f"cold prove, {site}: {c['calls']} calls, {c['bytes_sent']} bytes "
            f"sent, {c['bytes_received']} received (all ranks)")
    log(f"[scale] {PARALLEL_RANKS} gloo ranks: sha256 {rec['proof_sha256']} on"
        f" every rank, equal to the single-device proof; single-device "
        f"{rec['single_device']['prove_s']:.3f} s; {gloo_s:.1f} s with the "
        f"processes' start")
    return {"launches": launches, "kernels": kernels, "runs": runs,
            "peak": peak, "big_peak": big_peak, "gloo": rec}


SOURCES = {
    "mont_mul": ("lambdaworks_cairo_prover_tpu_torch/csrc/field_ops.cu",
                 "lambdaworks_cairo_prover_tpu/field/pallas_mul.py:126"),
    "add_sub_mod": ("lambdaworks_cairo_prover_tpu_torch/csrc/field_ops.cu",
                    "lambdaworks_cairo_prover_tpu/field/pallas_mul.py:135"),
    "ntt_dif_stages": ("lambdaworks_cairo_prover_tpu_torch/csrc/ntt.cu",
                      "lambdaworks_cairo_prover_tpu/ntt/fused.py:164"),
    "ntt_dif_local": ("lambdaworks_cairo_prover_tpu_torch/csrc/ntt.cu",
                      "lambdaworks_cairo_prover_tpu/ntt/fused.py:200"),
    # not Pallas: jnp under jax.jit (_keccak_f :93, _absorb_words :110)
    "keccak_rows": ("lambdaworks_cairo_prover_tpu_torch/csrc/keccak.cu",
                    "lambdaworks_cairo_prover_tpu/hash/keccak_device.py:166"),
    "keccak_pairs": ("lambdaworks_cairo_prover_tpu_torch/csrc/keccak.cu",
                     "lambdaworks_cairo_prover_tpu/hash/keccak_device.py:196"),
    "keccak_grind": ("lambdaworks_cairo_prover_tpu_torch/csrc/keccak.cu",
                     "lambdaworks_cairo_prover_tpu/hash/keccak_device.py:237"),
    # not separate Pallas calls: lax.scan over _mul_kernel (:434, :448 and
    # inv's :386; :484 and the associative_scan :486)
    "mont_batch_inverse": ("lambdaworks_cairo_prover_tpu_torch/csrc/scan.cu",
                           "lambdaworks_cairo_prover_tpu/field/device.py:405"),
    "mont_prefix_product": ("lambdaworks_cairo_prover_tpu_torch/csrc/scan.cu",
                            "lambdaworks_cairo_prover_tpu/field/device.py:458"),
    # not Pallas: the host tail in Python integers (_host_fold :99,
    # _host_evaluate_offset_fft :107, _HostMerkle :140)
    "fri_tail": ("lambdaworks_cairo_prover_tpu_torch/csrc/fri_tail.cu",
                 "lambdaworks_cairo_prover_tpu/prover/prove.py:99"),
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
    t_start = time.perf_counter()
    try:
        def phase(fn, *args):
            t0 = time.perf_counter()
            res = fn(*args)
            log(f"[total] {fn.__name__} took {time.perf_counter() - t0:.1f} s")
            return res

        phase_card(torch)
        phase(phase_build)
        kern = phase(phase_kernels, torch, dev)
        kern.update(phase(phase_keccak, torch, dev))
        kern.update(phase(phase_scan, torch, dev))
        kern.update(phase(phase_fri_tail, torch, dev,
                          kern["keccak_pairs"]["ops_per_permutation"]))
        phase(phase_fixtures, dev)
        launches_fib = phase(phase_full, torch, dev)
        phase(phase_cairo_fixture, dev)
        phase(phase_cairo_aux, torch, dev)
        launches_cairo_fib = phase(phase_cairo_full, torch, dev)
        memory = phase(phase_memory, torch, dev)
        launches = phase(phase_cairo_hints, torch, dev)
        phase(phase_rc, dev)
        phase(phase_toy_field)
        phase(phase_cli, dev)
        par = phase(phase_parallel, torch, dev)
        scale = phase(phase_scale, torch, dev,
                      kern["keccak_pairs"]["ops_per_permutation"])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "lambdaworks_cairo_prover_tpu"))
        require(not bad, f"imported {bad}")
    except Exception as exc:  # report the failed phase, then exit non-zero
        import traceback

        traceback.print_exc()
        print(f"FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "launches_cairo_fib": launches_cairo_fib[name],
         "launches_simple_fibonacci": launches_fib[name],
         "launches_parallel": par["launches"][name],
         "launches_memory": memory["launches"][name],
         "launches_scale": scale["launches"][name],
         "launches_parallel_columns": par["columns_launches"][name],
         "max_abs_err": max(rec["max_abs_err"],
                            memory["ntt_errs"].get(name, 0),
                            *[r["max_abs_err"] for r in scale_records(
                                scale["kernels"], name)]),
         "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
         **{k: v for k, v in rec.items() if k not in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         **({"four_step": par["four_step"][name]}
            if name in par["four_step"] else {}),
         **({"scale": scale_records(scale["kernels"], name)}
            if scale_records(scale["kernels"], name) else {})}
        for name, rec in kern.items()
    ]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
