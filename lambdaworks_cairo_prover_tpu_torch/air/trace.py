"""Execution-trace table: a (16, n_cols, n_rows) int32 Montgomery limb
tensor, column-major like the JAX package's TraceTable (per-column NTTs run
along the contiguous last axis; Merkle row leaves transpose on the fly).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import device as fd
from ..field.params import N_LIMBS
from ..ntt import core as nttc


def _words_to_limbs(words: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """(cols, rows, W) int64 little-endian 64-bit words -> the low ``n_limbs``
    16-bit limbs as (n_limbs, cols, rows) int32.  The mask comes after the
    (arithmetic) shift, so a word with bit 63 set gives the right limb."""
    return torch.stack([(words[..., L // 4] >> (16 * (L % 4))) & 0xFFFF
                        for L in range(n_limbs)]).to(torch.int32)


class TraceTable:
    def __init__(self, data: torch.Tensor):
        # data: (16, n_cols, n_rows) Montgomery limbs
        assert data.dim() == 3 and data.shape[0] == N_LIMBS
        self.data = data

    def to(self, device) -> "TraceTable":
        return TraceTable(self.data.to(device))

    # -- constructors -------------------------------------------------------

    @classmethod
    def empty(cls, *, device) -> "TraceTable":
        return cls(torch.zeros((N_LIMBS, 0, 0), dtype=torch.int32, device=device))

    @classmethod
    def from_int_columns(cls, cols: list[list[int]], *, device) -> "TraceTable":
        """Columns of python ints (< p) -> a trace on ``device``.

        Compact ingest, as in the JAX package: a column whose values all fit
        64 bits (registers, addresses, offsets, flags, instructions) goes to
        the device as one 64-bit word per value, a full-width felt column as
        four.  The 16-limb expansion and the Montgomery conversion
        (``fd.to_mont``, the H1 kernel on a CUDA device) run on ``device``."""
        n_rows = len(cols[0])
        small_idx, small_arrs, felt_idx, felt_arrs = [], [], [], []
        for c, col in enumerate(cols):
            try:
                a = np.asarray(col, dtype=np.uint64)
            except (OverflowError, TypeError):
                buf = b"".join(v.to_bytes(32, "little") for v in col)
                felt_idx.append(c)
                felt_arrs.append(
                    np.frombuffer(buf, dtype="<i8").reshape(n_rows, 4))
                continue
            small_idx.append(c)
            small_arrs.append(a.view(np.int64))
        parts = []
        if small_arrs:
            small = torch.from_numpy(np.stack(small_arrs)).to(device)
            lo = _words_to_limbs(small[:, :, None], 4)  # (4, n_small, n_rows)
            pad = torch.zeros((N_LIMBS - 4,) + lo.shape[1:], dtype=torch.int32,
                              device=device)
            parts.append(torch.cat([lo, pad], dim=0))
        if felt_arrs:
            felt = torch.from_numpy(np.stack(felt_arrs)).to(device)
            parts.append(_words_to_limbs(felt, N_LIMBS))
        raw = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        order = torch.tensor(np.argsort(np.asarray(small_idx + felt_idx)),
                             dtype=torch.int64, device=device)
        return cls(fd.to_mont(raw.index_select(1, order)))

    @classmethod
    def from_columns(cls, cols: list[torch.Tensor]) -> "TraceTable":
        """cols: list of (16, n_rows) Montgomery limb tensors."""
        return cls(torch.stack(cols, dim=1))

    # -- accessors ----------------------------------------------------------

    @property
    def n_cols(self) -> int:
        return self.data.shape[1]

    @property
    def n_rows(self) -> int:
        return self.data.shape[2]

    def is_empty(self) -> bool:
        return self.n_cols == 0

    def col(self, idx: int) -> torch.Tensor:
        """Column ``idx`` as a (16, n_rows) view."""
        return self.data[:, idx, :]

    def get_row_ints(self, row_idx: int) -> list[int]:
        return fd.to_ints(self.data[:, :, row_idx])

    def to_int_columns(self) -> list[list[int]]:
        flat = fd.to_ints(self.data.reshape(N_LIMBS, -1))
        return [flat[c * self.n_rows:(c + 1) * self.n_rows]
                for c in range(self.n_cols)]

    def concatenate(self, other: "TraceTable") -> "TraceTable":
        return TraceTable(torch.cat([self.data, other.data], dim=1))

    # -- polynomial ops -----------------------------------------------------

    def compute_trace_polys(self) -> torch.Tensor:
        """Per-column interpolation: (16, n_cols, n_rows) coefficients."""
        return nttc.interpolate_fft(self.data)
