"""BENCHMARK.json against the benchmark's contract, every cell resolved to
its files by name, and new files picked up with no edit."""

import json
import re
import shutil
from pathlib import Path

import pytest

import harness

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["prover_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in MANIFEST[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in MANIFEST[k]}) == len(MANIFEST[k])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip()
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.resolve(MANIFEST, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.entry["chips"] in (1, 4)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and set(c.readers) == names | {
        m["name"] for m in c.per_layer}
    assert all(callable(r) for r in c.readers.values())


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=[c["name"] for c in MANIFEST["configs"]])
def test_config_files(entry):
    path = ROOT / entry["file"]
    assert entry["file"].startswith("prover_bench/") and path.is_file()
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    lo, hi = cfg["n_range"]
    assert lo <= cfg["n"] <= hi
    assert cfg["rows"] & (cfg["rows"] - 1) == 0
    assert cfg["lde_points"] == cfg["rows"] * cfg["options"]["blowup_factor"]


def test_new_files_are_picked_up(tmp_path):
    """A configuration, a traffic mix (with a loop of its own) and a
    per-layer metric added as new files and manifest entries, with no edit
    to a file that is there."""
    bench = tmp_path / "prover_bench"
    shutil.copytree(ROOT / "prover_bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "cairo_fib70k.json").read_text())
    cfg["name"] = "extra_cfg"
    (bench / "configs" / "extra_cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "bursty.json").write_text(json.dumps(
        {"loop": "open", "jobs_in_flight": 2, "distinct_traces": 2,
         "warmup_rounds": 1, "recorded_jobs": 2}))
    (bench / "traffic" / "bursty.py").write_text(
        "def window(ctx):\n    ctx.run_job(0)\n")
    (bench / "metrics" / "extra_metric.py").write_text(
        "def read(run):\n    return 1.5\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "extra_cfg", "source": "x",
                                "file": "prover_bench/configs/extra_cfg.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "extra_cfg.bursty",
                                  "config": "extra_cfg", "traffic": "bursty",
                                  "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "extra_metric", "unit": "s",
                                  "better": "lower", "source": "program_span",
                                  "layer": "device", "moves": "job_s"})
    c = harness.resolve(manifest, "extra_cfg.bursty", bench)
    assert c.config["name"] == "extra_cfg" and c.loop is not None
    assert c.readers["extra_metric"](None) == 1.5
    assert {p: p.read_bytes() for p in before} == before
    # a mix that is not the general loop's, with no loop of its own
    (bench / "traffic" / "bursty.py").unlink()
    with pytest.raises(harness.BenchError):
        harness.resolve(manifest, "extra_cfg.bursty", bench)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 12345, 987654321987])
def test_sizes_from_seed(seed):
    cfg = json.loads((ROOT / "prover_bench/configs/cairo_fib70k.json")
                     .read_text())
    traffic = json.loads((ROOT / "prover_bench/traffic/serial.json")
                         .read_text())
    sizes = harness.pick_sizes(cfg, traffic, seed)
    assert sizes == harness.pick_sizes(cfg, traffic, seed)
    assert len(set(sizes)) == 2
    assert all(cfg["n_range"][0] <= n <= cfg["n_range"][1] for n in sizes)
    assert (sizes[0] == cfg["n"]) == (seed == 0)
