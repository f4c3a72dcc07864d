"""ctypes bindings for the native C++ Cairo VM (native/cairo_vm.cpp).

Drop-in alternative to the python VM for trace generation: the heavy
per-step interpretation runs natively, returning cairo-vm-compatible binary
trace/memory blobs that feed the existing decoders.  Falls back to the
python VM if the shared library has not been built
(``make -C native`` / g++ one-liner in native/cairo_vm.cpp)."""

from __future__ import annotations

import ctypes
import os

from .cairo_mem import CairoMemory
from .register_states import RegisterStates
from .vm import Program

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libcairo_vm.so",
)

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.cairo_vm_run.restype = ctypes.c_void_p
        lib.cairo_vm_run.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64,
        ]
        for name in ("cairo_vm_trace_ptr", "cairo_vm_memory_ptr"):
            getattr(lib, name).restype = ctypes.POINTER(ctypes.c_uint8)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("cairo_vm_trace_len", "cairo_vm_memory_len",
                     "cairo_vm_rc_start", "cairo_vm_rc_end",
                     "cairo_vm_out_start", "cairo_vm_out_end"):
            getattr(lib, name).restype = ctypes.c_uint64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.cairo_vm_error.restype = ctypes.c_char_p
        lib.cairo_vm_error.argtypes = [ctypes.c_void_p]
        lib.cairo_vm_free.restype = None
        lib.cairo_vm_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return os.path.exists(_LIB_PATH)


def run_program_native(program: Program, max_steps: int = 1 << 24):
    """Mirror of vm.run_program using the native VM."""
    lib = _load()
    blob = b"".join(w.to_bytes(32, "little") for w in program.data)
    mask = 0
    if "output" in program.builtins:
        mask |= 1
    if "range_check" in program.builtins:
        mask |= 2
    res = lib.cairo_vm_run(blob, len(program.data), program.main_pc, mask,
                           max_steps)
    try:
        err = lib.cairo_vm_error(res)
        if err:
            raise RuntimeError(f"native cairo vm: {err.decode()}")
        tlen = lib.cairo_vm_trace_len(res)
        mlen = lib.cairo_vm_memory_len(res)
        trace_bytes = ctypes.string_at(lib.cairo_vm_trace_ptr(res), tlen)
        memory_bytes = ctypes.string_at(lib.cairo_vm_memory_ptr(res), mlen)
        rc_start = lib.cairo_vm_rc_start(res)
        rc_end = lib.cairo_vm_rc_end(res)
        out_start = lib.cairo_vm_out_start(res)
        out_end = lib.cairo_vm_out_end(res)
    finally:
        lib.cairo_vm_free(res)

    register_states = RegisterStates.from_bytes_le(trace_bytes)
    memory = CairoMemory.from_bytes_le(memory_bytes)
    builtin_ranges = {}
    if rc_end > rc_start or (rc_start and rc_end == rc_start):
        builtin_ranges["range_check"] = range(rc_start, rc_end)
    if out_end > out_start or (out_start and out_end == out_start):
        builtin_ranges["output"] = range(out_start, out_end)
    return register_states, memory, len(program.data), builtin_ranges
