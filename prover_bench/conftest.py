"""Test set-up of the benchmark's own tests: its files and the repository's
root on the path, and the `card` marker for tests that need a CUDA card."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is present (decided here, when the
    test runs, not when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


TINY_OPTIONS = {"blowup_factor": 4, "fri_number_of_queries": 3,
                "coset_offset": 3, "grinding_factor": 1}


# the cells of the tiny configuration: one card, and 2 and 4 gloo ranks of
# the configuration `tiny_domain`, the same with "shard_axis": "domain"
TINY_CELLS = {"tiny.serial": ("tiny", 1),
              "tiny_domain.serial2": ("tiny_domain", 2),
              "tiny_domain.serial4": ("tiny_domain", 4)}


@pytest.fixture
def tiny_checkout(tmp_path):
    """A copy of the benchmark, and links to the port and its native VM,
    beside a manifest that adds the cells of TINY_CELLS: the flagship's
    program at 64 rows (n from 4 to 8), test options, one warm-up round and
    two recorded jobs."""
    import json
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "prover_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("lambdaworks_cairo_prover_tpu_torch", "native"):
        (tmp_path / name).symlink_to(BENCH_DIR.parent / name)
    manifest = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH_DIR / "configs" / "cairo_fib70k.json").read_text())
    cfg.update(name="tiny", n=5, n_range=[4, 8], rows=64,
               options=TINY_OPTIONS)
    for name, extra in (("tiny", {}),
                        ("tiny_domain", {"shard_axis": "domain"})):
        manifest["configs"].append({
            "name": name, "source": "test",
            "file": f"prover_bench/configs/{name}.json", "reduced": [],
            "why": "a CPU rehearsal"})
        (tmp_path / "prover_bench" / "configs" / f"{name}.json").write_text(
            json.dumps(dict(cfg, name=name, **extra)))
    for cell, (config, chips) in TINY_CELLS.items():
        manifest["workloads"].append({
            "name": cell, "config": config, "traffic": "tiny_serial",
            "chips": chips, "why": "a CPU rehearsal"})
        for m in manifest["per_layer"]:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.loads((BENCH_DIR / "traffic" / "serial.json").read_text())
    traffic.update(warmup_rounds=1, recorded_jobs=2)
    (tmp_path / "prover_bench" / "traffic" / "tiny_serial.json").write_text(
        json.dumps(traffic))
    return tmp_path
