"""Execution-trace table: a (16, n_cols, n_rows) int32 Montgomery limb
tensor, column-major like the JAX package's TraceTable (per-column NTTs run
along the contiguous last axis; Merkle row leaves transpose on the fly).
"""

from __future__ import annotations

import torch

from ..field import device as fd
from ..field.params import N_LIMBS


class TraceTable:
    def __init__(self, data: torch.Tensor):
        # data: (16, n_cols, n_rows) Montgomery limbs
        assert data.dim() == 3 and data.shape[0] == N_LIMBS
        self.data = data

    def to(self, device) -> "TraceTable":
        return TraceTable(self.data.to(device))

    # -- constructors -------------------------------------------------------

    @classmethod
    def empty(cls, device="cpu") -> "TraceTable":
        return cls(torch.zeros((N_LIMBS, 0, 0), dtype=torch.int32, device=device))

    @classmethod
    def from_int_columns(cls, cols: list[list[int]], device="cpu") -> "TraceTable":
        """Columns of python ints -> a trace on ``device`` (the CPU unless
        named; ``prove`` moves it).  The Montgomery form is computed on the
        host, with exact python ints."""
        n_rows = len(cols[0])
        flat = [v for col in cols for v in col]
        limbs = fd.from_ints(flat, device=device)
        return cls(limbs.reshape(N_LIMBS, len(cols), n_rows))

    # -- accessors ----------------------------------------------------------

    @property
    def n_cols(self) -> int:
        return self.data.shape[1]

    @property
    def n_rows(self) -> int:
        return self.data.shape[2]

    def is_empty(self) -> bool:
        return self.n_cols == 0
