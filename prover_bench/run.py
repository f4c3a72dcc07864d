"""The benchmark of the PyTorch and CUDA prover (`lambdaworks_cairo_prover_tpu_torch`).

    python3 prover_bench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`, and
last `checks`, the numbers compared with their limits, which also end
standard error.  Without the cards, or if the process has loaded JAX or the
JAX package, it prints no result and exits non-zero."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, lines = harness.run(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=T_START, manifest_path=ROOT / "BENCHMARK.json")
    except (harness.BenchError, OSError, ImportError, KeyError) as e:
        print(f"no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"no result: the run loaded {loaded}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
