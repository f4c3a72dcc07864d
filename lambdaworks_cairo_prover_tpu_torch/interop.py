"""Carry arrays and public inputs between the JAX package and the port.

The JAX package keeps field elements as ``(16, ...)`` uint32 arrays of
16-bit limbs in Montgomery form; the port keeps the same limbs as int32
tensors.  Turn a JAX array into numpy with ``np.asarray`` first: this module
imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .air.trace import TraceTable
from .cairo.air import PublicInputs
from .field.params import N_LIMBS


def limbs_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """(16, ...) uint32 limbs (values < 2^16) -> int32 tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.ndim < 1 or arr.shape[0] != N_LIMBS:
        raise ValueError(f"expected (16, ...) limbs, got shape {arr.shape}")
    if arr.size and int(arr.max()) >= 1 << 16:
        raise ValueError("limb values must be < 2^16")
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """(16, ...) int32 limb tensor -> uint32 numpy array (the JAX layout)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def trace_from_numpy(data: np.ndarray, device) -> TraceTable:
    """A port TraceTable from a JAX TraceTable's ``data``, in the same
    layout: (16, cols, rows) limbs, or the packed (8, cols, rows) words
    (limb pairs in one u32), whose bits the port keeps as int32."""
    data = np.asarray(data, dtype=np.uint32)
    if data.ndim == 3 and data.shape[0] == N_LIMBS // 2:
        return TraceTable(torch.from_numpy(
            data.view(np.int32).copy()).to(device))
    return TraceTable(limbs_from_numpy(data, device))


def public_inputs_from_jax(pub) -> PublicInputs:
    """The port's `PublicInputs` from the JAX package's, field by field.
    Segment ranges are rebuilt as ranges and both dicts keep their insertion
    order, which is the wire order of ``serialize``."""
    return PublicInputs(
        pc_init=int(pub.pc_init), ap_init=int(pub.ap_init),
        fp_init=int(pub.fp_init), pc_final=int(pub.pc_final),
        ap_final=int(pub.ap_final),
        range_check_min=(None if pub.range_check_min is None
                         else int(pub.range_check_min)),
        range_check_max=(None if pub.range_check_max is None
                         else int(pub.range_check_max)),
        memory_segments={name: range(rng.start, rng.stop)
                         for name, rng in pub.memory_segments.items()},
        public_memory={int(a): int(v) for a, v in pub.public_memory.items()},
        num_steps=int(pub.num_steps),
    )
