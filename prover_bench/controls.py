"""The control and the planted faults that `correct` must catch, each put
under the timed path of an ordinary run of the harness.

    python3 prover_bench/controls.py --workload <cell> --seeds 1 2 3 \
        --seconds 10 [--plants control stale ...]

runs each plant on each seed and prints one JSON line a run: the plant, the
seed, `correct` and the numbers compared.  The benchmark's own runs never
load this file; the CPU tests drive the same plants at a tiny size.

- `control`: the prover at one FRI query and one bit of grinding below the
  Provable80Bits options that the configuration states (the step that would
  tempt a change that wants round 4 shorter).
- `stale`: a job returns the proof of the job before it (the step that
  returns its state unchanged).
- `half_queries`: half of the queries and openings left out of the proof.
- `flipped_byte`: one bit of the proof's bytes flipped where they are made.
- `bad_witness`: one value of the auxiliary (RAP) trace altered on the
  device where it is built, the rest of the proof made faithfully from it.

One card proves alone, so no exchange between cards can be left out."""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _prove_module():
    from lambdaworks_cairo_prover_tpu_torch.prover import prove

    return prove


def control():
    pm = _prove_module()

    def make(prove):
        def weaker(trace, pub, options, *a, **k):
            cls = type(options)
            return prove(trace, pub, cls(
                blowup_factor=options.blowup_factor,
                fri_number_of_queries=options.fri_number_of_queries - 1,
                coset_offset=options.coset_offset,
                grinding_factor=options.grinding_factor - 1), *a, **k)
        return weaker
    return _patched(pm, "prove", make)


def stale():
    pm = _prove_module()
    last = []

    def make(prove):
        def previous(*a, **k):
            proof = prove(*a, **k)
            last.append(proof)
            return last[-2] if len(last) > 1 else proof
        return previous
    return _patched(pm, "prove", make)


def half_queries():
    pm = _prove_module()

    def make(prove):
        def half(*a, **k):
            proof = prove(*a, **k)
            keep = len(proof.query_list) // 2
            proof.query_list = proof.query_list[:keep]
            proof.deep_poly_openings = proof.deep_poly_openings[:keep]
            return proof
        return half
    return _patched(pm, "prove", make)


def flipped_byte():
    from lambdaworks_cairo_prover_tpu_torch.proof import serde

    def make(serialize):
        def flipped(proof):
            data = bytearray(serialize(proof))
            data[len(data) // 2] ^= 0x10
            return bytes(data)
        return flipped
    return _patched(serde, "serialize_proof", make)


def bad_witness():
    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd

    def make(build):
        def altered(self, main_trace, rc):
            aux = build(self, main_trace, rc)
            data = aux.data  # (limbs or words, columns, rows)
            col, row = 11, data.shape[2] // 3  # a memory permutation value
            one = fd.from_int(1, device=data.device)
            if data.shape[0] != one.shape[0]:
                one = fd.pack(one.reshape(-1, 1)).reshape(-1)
            data[:, col, row] = fd.add(data[:, col, row:row + 1],
                                       one.reshape(-1, 1)).reshape(-1)
            return aux
        return altered
    return _patched(CairoAIR, "build_auxiliary_trace", make)


PLANTS = {"control": control, "stale": stale, "half_queries": half_queries,
          "flipped_byte": flipped_byte, "bad_witness": bad_witness}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--plants", nargs="+", default=list(PLANTS),
                    choices=[*PLANTS, "none"])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import harness

    for seed in args.seeds:
        for plant in args.plants:
            t0 = time.perf_counter()
            with (PLANTS[plant]() if plant != "none"
                  else contextlib.nullcontext()):
                result, lines = harness.run(
                    args.workload, seed, args.seconds, False, t_start=t0,
                    manifest_path=ROOT / "BENCHMARK.json")
            print(json.dumps({"plant": plant, "seed": seed,
                              "correct": result["correct"],
                              "attempted": result["attempted"],
                              "checks": result["checks"],
                              "why": lines[:2]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
