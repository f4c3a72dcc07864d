"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use, with ``nvcc`` for
Hopper (``sm_90a``), one process a source, all started together, and linked
into one shared library with a plain C interface that is loaded with
ctypes.  The library goes into ``_build/`` inside the package
(listed in ``.gitignore``) under a name derived from the sources and flags,
so an edited source is rebuilt and a built one is reused.  Nothing is built
when this module is imported: :func:`library` builds on its first call,
which only a launcher of a CUDA tensor makes.

Each C entry point takes device pointers, sizes and the CUDA stream as
plain integers and returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("field_ops.cu", "ntt.cu", "keccak.cu", "scan.cu")
HEADERS = ("field.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U64 = ctypes.c_ulonglong
# an H1/H2 operand: pointer, row stride, div, mod, run, run stride, packed
_OPERAND = [_P, _LL, _LL, _LL, _LL, _LL, _I]
_SIGNATURES = {
    "lcp_mont_mul": _OPERAND * 2 + [_P, _I, _LL, _P],
    "lcp_add_sub": [_I] + _OPERAND * 2 + [_P, _I, _LL, _P],
    "lcp_ntt_dif_stages": [_P, _P, _LL, _I, _I, _I, _P, _P],
    "lcp_ntt_dif_local": [_P, _P, _LL, _I, _I, _I, _P, _P],
    "lcp_keccak_rows": [_P, _LL, _LL, _LL, _I, _LL, _P, _P],
    "lcp_keccak_pairs": [_P, _LL, _I, _P, _P, _P],
    "lcp_keccak_grind": [_U64, _U64, _U64, _U64, _U64, _LL, _U64, _P, _P],
    "lcp_batch_inverse": [_P, _P, _LL, _LL, _LL, _P, _P, _P],
    "lcp_prefix_product": [_P, _P, _LL, _LL, _P, _P],
}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused the sources."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error code."""


_lock = threading.Lock()
_state: dict = {}  # "lib": ctypes.CDLL, "build": dict of build facts


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise KernelCompileError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels if needed; returns the library path, whether it
    was compiled in this call, the seconds taken and nvcc's report."""
    tag = _source_hash()
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"liblcp_kernels_{tag}.so")
    log_path = so_path + ".log"
    if os.path.exists(so_path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"path": so_path, "compiled": False, "seconds": 0.0, "log": log}
    tmp = f"{so_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{name}.o" for name in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj,
         os.path.join(CSRC_DIR, name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    failed = [(name, p.returncode) for name, p in zip(SOURCES, procs)
              if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    if failed:
        raise KernelCompileError(f"nvcc failed {failed}:\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, so_path)
    return {"path": so_path, "compiled": True, "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _lock:
        if "lib" not in _state:
            info = build()
            lib = ctypes.CDLL(info["path"])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _state["build"] = info
            _state["lib"] = lib
        return _state["lib"]


def build_info() -> dict:
    """Facts about the build that :func:`library` loaded ({} before)."""
    return dict(_state.get("build", {}))


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")
