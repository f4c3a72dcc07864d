"""The traced run's instruments, all from the benchmark's own files: ranges
(`torch.profiler.record_function`) around the program's layer entry points,
the work each call needs (`yardstick`), and the reduction of one profiler
recording to device busy time, idle share, launches and rooflines.

A layer range's name is `bench.<layer>.<function>`; other ranges name what
the host was doing (`bench.ProverKernels.<method>`, `bench.CairoAIR.<method>`,
`bench.prove._fri_commit`, `bench.job`, ...).  A device operation belongs to
the innermost layer range open on its launching thread when it was
launched."""

from __future__ import annotations

import contextlib
import importlib
import inspect
import json
import os
import sys
import tempfile
from collections import defaultdict

import yardstick as ys

PKG = "lambdaworks_cairo_prover_tpu_torch"

# (layer, module, function, work from the call's arguments)
LAYER_ENTRIES = [
    ("field", "field.device", "mul", lambda a, b, *_, **__: ys.mul_work(
        a.shape, b.shape)),
    ("field", "field.device", "add", lambda a, b, *_, **__: ys.add_work(
        a.shape, b.shape)),
    ("field", "field.device", "sub", lambda a, b, *_, **__: ys.add_work(
        a.shape, b.shape)),
    ("field", "field.device", "batch_inverse",
     lambda x, *_, **__: ys.batch_inverse_work(x.shape)),
    ("field", "field.device", "prefix_product",
     lambda x, *_, **__: ys.prefix_product_work(x.shape)),
    ("ntt", "ntt.core", "transform", lambda x, *_, **__: ys.ntt_work(x.shape)),
    ("hash", "hash.merkle", "tree_levels",
     lambda leaves, *_, **__: ys.tree_work(leaves.shape[0])),
    ("hash", "hash.keccak_device", "hash_felt_rows",
     lambda limbs, n_cols, *_, **__: ys.row_hash_work(limbs.shape[1],
                                                       n_cols)),
]
LAYERS = ("field", "ntt", "hash")

# ranges that only name what the host is doing (for the idle gaps)
CONTEXT_FUNCTIONS = [
    ("prover.prove", "_fri_commit"),
    ("prover.prove", "generate_nonce_with_grinding"),
    ("prover.prove", "get_kernels"),
    ("field.device", "to_ints"),
]
CONTEXT_CLASSES = [("prover.kernels", "ProverKernels"),
                   ("cairo.air", "CairoAIR")]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Recorder:
    """Work counted while ``on``: (bytes, ops) sums by layer, calls by
    entry point."""

    def __init__(self):
        self.on = False
        self.work = {layer: [0, 0] for layer in LAYERS}
        self.calls = defaultdict(int)


def _range(name):
    import torch

    return torch.profiler.record_function(name)


def maybe_range(rec: Recorder, name: str):
    """A range named ``name`` while ``rec`` records, else nothing."""
    return _range(name) if rec.on else contextlib.nullcontext()


def _layer_wrapper(f, layer, name, work, rec):
    label = f"bench.{layer}.{name}"

    def wrapper(*args, **kwargs):
        if not rec.on:
            return f(*args, **kwargs)
        n_bytes, n_ops = work(*args, **kwargs)
        rec.work[layer][0] += n_bytes
        rec.work[layer][1] += n_ops
        rec.calls[f"{layer}.{name}"] += 1
        with _range(label):
            return f(*args, **kwargs)

    wrapper.__wrapped__ = f
    return wrapper


def _context_wrapper(f, label, rec):
    def wrapper(*args, **kwargs):
        if not rec.on:
            return f(*args, **kwargs)
        with _range(label):
            return f(*args, **kwargs)

    wrapper.__wrapped__ = f
    return wrapper


@contextlib.contextmanager
def instrumented(rec: Recorder):
    """Wrap every binding of each entry point in the program's loaded
    modules (a name imported into another module is a binding of its own),
    and the public methods of the context classes; restore them on exit."""
    patched = []

    def bind_everywhere(f, wrapper):
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not (mod_name == PKG
                                   or mod_name.startswith(PKG + ".")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is f:
                    patched.append((mod, attr, val))
                    setattr(mod, attr, wrapper)

    try:
        for layer, mod_name, name, work in LAYER_ENTRIES:
            f = getattr(importlib.import_module(f"{PKG}.{mod_name}"), name)
            bind_everywhere(f, _layer_wrapper(f, layer, name, work, rec))
        for mod_name, name in CONTEXT_FUNCTIONS:
            f = getattr(importlib.import_module(f"{PKG}.{mod_name}"), name)
            short = mod_name.split(".")[-1]
            bind_everywhere(f, _context_wrapper(f, f"bench.{short}.{name}",
                                                rec))
        for mod_name, cls_name in CONTEXT_CLASSES:
            cls = getattr(importlib.import_module(f"{PKG}.{mod_name}"),
                          cls_name)
            for attr, val in list(vars(cls).items()):
                if inspect.isfunction(val) and not attr.startswith("__"):
                    patched.append((cls, attr, val))
                    setattr(cls, attr, _context_wrapper(
                        val, f"bench.{cls_name}.{attr}", rec))
        yield rec
    finally:
        for owner, attr, val in reversed(patched):
            setattr(owner, attr, val)


def unhit_entries(rec: Recorder) -> list[str]:
    """Layer entry points that no recorded call went through."""
    return [f"{layer}.{name}" for layer, _, name, _ in LAYER_ENTRIES
            if rec.calls.get(f"{layer}.{name}", 0) == 0]


@contextlib.contextmanager
def profiled(cuda: bool = True):
    """A profiler recording of host ranges and device activity; yields a
    holder whose ``events`` are the recording's Chrome-trace events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = type("Recording", (), {"events": None})()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities, record_shapes=False,
                 with_stack=False) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo, hi):
    """Idle stretches of [lo, hi] between the merged intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _innermost(ranges, points):
    """For each (ts, key) in points, the innermost range (start, end, name)
    of one thread that holds ts.  Ranges nest; points are any order."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(points)), key=lambda i: points[i][0])
    out = [None] * len(points)
    stack, k = [], 0
    for i in order:
        ts = points[i][0]
        while k < len(ranges) and ranges[k][0] <= ts:
            while stack and stack[-1][1] < ranges[k][0]:
                stack.pop()
            stack.append(ranges[k])
            k += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def reduce_trace(events: list, rec: Recorder) -> dict:
    """Busy time, window, idle share, launches, each layer's device time and
    roofline share, and the breakdown, from one recording over whole jobs.
    Times are in seconds."""
    us = 1e-6
    jobs = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name") == "bench.job"]
    if not jobs:
        raise ValueError("the recording holds no job")
    lo = min(e["ts"] for e in jobs)
    hi = max(e["ts"] + e["dur"] for e in jobs)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi]
    launch_at = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (e["ts"], e.get("tid"))
    ranges = defaultdict(list)
    layer_ranges = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith("bench.")):
            item = (e["ts"], e["ts"] + e["dur"], e["name"])
            ranges[e.get("tid")].append(item)
            if e["name"].split(".")[1] in LAYERS:
                layer_ranges[e.get("tid")].append(item)

    # each device operation's layer: the innermost layer range at its launch
    by_tid = defaultdict(list)
    for d in device:
        corr = d.get("args", {}).get("correlation")
        if corr in launch_at:
            ts, tid = launch_at[corr]
            by_tid[tid].append((ts, d))
    layer_time = {layer: 0.0 for layer in LAYERS}
    for tid, pts in by_tid.items():
        names = _innermost(layer_ranges.get(tid, []), pts)
        for (_, d), name in zip(pts, names):
            if name is not None:
                layer_time[name.split(".")[1]] += d["dur"] * us

    spans = [(d["ts"], min(d["ts"] + d["dur"], hi)) for d in device]
    busy = _union(spans) * us
    window = (hi - lo) * us
    op_time = defaultdict(float)
    for d in device:
        op_time[d["name"]] += d["dur"] * us
    gaps = _gaps(spans, lo, hi)
    host_tid = jobs[0].get("tid")
    gap_names = _innermost(ranges.get(host_tid, []),
                           [((s + e) / 2, None) for s, e in gaps])
    idle_by = defaultdict(float)
    for (s, e), name in zip(gaps, gap_names):
        idle_by[name or "outside the benchmark's ranges"] += (e - s) * us

    rooflines = {}
    for layer in LAYERS:
        n_bytes, n_ops = rec.work[layer]
        if layer_time[layer] > 0:
            rooflines[layer] = 100.0 * ys.bound_s(n_bytes, n_ops) / layer_time[
                layer]
    top = sorted(op_time.items(), key=lambda kv: -kv[1])[:10]
    idle_top = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {
        "jobs": len(jobs),
        "window_s": window,
        "busy_s": busy,
        "launches": len(device),
        "layer_device_s": layer_time,
        "rooflines": rooflines,
        "breakdown": {"device_ops": [[k, v] for k, v in top],
                      "idle_gaps": [[k, v] for k, v in idle_top]},
    }
