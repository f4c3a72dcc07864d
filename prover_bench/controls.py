"""The control and the planted faults that `correct` must catch, each put
under the timed path of an ordinary run of the harness.

    python3 prover_bench/controls.py --workload <cell> --seeds 1 2 3 \
        --seconds 10 [--plants control stale ...]

runs each plant on each seed and prints one JSON line a run: the plant, the
seed, `correct` and the numbers compared, or `no_result` where the run
gave none.  On a cell of D > 1 cards the control goes under every rank's
timed path and each fault under rank 0's, then rank 1's (`placements`):
the ranks are started as `controls.py rank <plant> <rank> <run.py's
arguments>`.  The benchmark's own runs never load this file; the CPU tests
drive the same plants at a tiny size.

- `control`: the prover at one FRI query and one bit of grinding below the
  Provable80Bits options that the configuration states (the step that would
  tempt a change that wants round 4 shorter).
- `stale`: a job returns the proof of the job before it (the step that
  returns its state unchanged).
- `half_queries`: half of the queries and openings left out of the proof.
- `flipped_byte`: one bit of the proof's bytes flipped where they are made.
- `bad_witness`: one value of the auxiliary (RAP) trace altered on the
  device where it is built, the rest of the proof made faithfully from it;
  on D ranks of the domain layout, one in each rank's block of rows, since
  each rank proves from its own block.

A cell on one card proves alone, so no exchange between cards can be left
out; on D > 1 cards a rank that left one out would wait in it until the
collective's timeout, and the run ends with no result."""

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
    import torch.distributed as dist

    from lambdaworks_cairo_prover_tpu_torch.cairo.air import CairoAIR
    from lambdaworks_cairo_prover_tpu_torch.field import device as fd

    def make(build):
        def altered(self, main_trace, rc):
            aux = build(self, main_trace, rc)
            data = aux.data  # (limbs or words, columns, rows)
            col = 11  # a memory permutation value
            one = fd.from_int(1, device=data.device)
            if data.shape[0] != one.shape[0]:
                one = fd.pack(one.reshape(-1, 1)).reshape(-1)
            block = data.shape[2] // (dist.get_world_size()
                                      if dist.is_initialized() else 1)
            for row in range(block // 3, data.shape[2], block):
                data[:, col, row] = fd.add(data[:, col, row:row + 1],
                                           one.reshape(-1, 1)).reshape(-1)
            return aux
        return altered
    return _patched(CairoAIR, "build_auxiliary_trace", make)


PLANTS = {"control": control, "stale": stale, "half_queries": half_queries,
          "flipped_byte": flipped_byte, "bad_witness": bad_witness}


def rank_main(argv) -> int:
    """`rank <plant> <rank>` and run.py's arguments: one rank of a cell on
    D > 1 cards, with the plant under its timed path if it is that rank
    (or if the rank given is -1)."""
    plant, at, rest = argv[0], int(argv[1]), argv[2:]
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import run

    planted = plant != "none" and at in (-1, run.parse_args(rest).rank)
    with PLANTS[plant]() if planted else contextlib.nullcontext():
        return run.main(rest)


def placements(plant: str, chips: int) -> list:
    """The ranks a plant goes under, one run each (-1: under every rank at
    once).  One card: its one.  D > 1 ranks: the control under every rank,
    since ranks that prove under different options meet no more in their
    collectives; each fault under rank 0, then under rank 1."""
    if chips == 1:
        return [0]
    return [-1] if plant in ("control", "none") else [0, 1]


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["rank"]:
        return rank_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--plants", nargs="+", default=list(PLANTS),
                    choices=[*PLANTS, "none"])
    # the CPU tests' device
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import harness
    import ranks

    manifest = ROOT / "BENCHMARK.json"
    chips = harness.resolve(json.loads(manifest.read_text()),
                            args.workload).entry["chips"]
    for seed in args.seeds:
        for plant in args.plants:
            for at in placements(plant, chips):
                t0 = time.perf_counter()
                rank_command = [sys.executable, str(Path(__file__).resolve()),
                                "rank", plant, str(at)]
                line = {"plant": plant, "seed": seed, "rank": at}
                with (PLANTS[plant]() if plant != "none" and chips == 1
                      else contextlib.nullcontext()):
                    try:
                        result, lines = harness.run(
                            args.workload, seed, args.seconds, False,
                            t_start=t0, manifest_path=manifest,
                            device=args.device, rank_command=rank_command)
                    except ranks.RankFailure as e:
                        line["no_result"] = str(e)[:2000]
                    else:
                        line.update(correct=result["correct"],
                                    attempted=result["attempted"],
                                    checks=result["checks"],
                                    why=lines[:2] if chips == 1
                                    else lines[-4:])
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
