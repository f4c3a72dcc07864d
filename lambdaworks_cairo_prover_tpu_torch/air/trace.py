"""Execution-trace table: a (16, n_cols, n_rows) int32 Montgomery limb
tensor, or the same packed to (8, n_cols, n_rows) words (``fd.pack``),
column-major like the JAX package's TraceTable (per-column NTTs run along
the contiguous last axis; Merkle row leaves transpose on the fly).

The ingest (``from_int_columns``) leaves the trace packed, as the JAX
package's does: half the device bytes of the limb layout.  Consumers read
columns through ``col`` and ``unpacked``, which take either layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import device as fd
from ..field.params import N_LIMBS
from ..ntt import core as nttc

_INGEST_COLS = 8  # columns expanded to limbs on the device at a time


def _words_to_limbs(words: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """(cols, rows, W) int64 little-endian 64-bit words -> the low ``n_limbs``
    16-bit limbs as (n_limbs, cols, rows) int32.  The mask comes after the
    (arithmetic) shift, so a word with bit 63 set gives the right limb."""
    return torch.stack([((words[..., L // 4] >> (16 * (L % 4))) & 0xFFFF)
                        .to(torch.int32) for L in range(n_limbs)])


class TraceTable:
    def __init__(self, data: torch.Tensor):
        # data: (16, n_cols, n_rows) Montgomery limbs, or the packed
        # (8, n_cols, n_rows) words that from_int_columns makes
        assert data.dim() == 3 and data.shape[0] in (N_LIMBS, N_LIMBS // 2)
        self.data = data

    def to(self, device) -> "TraceTable":
        return TraceTable(self.data.to(device))

    def unpacked(self) -> torch.Tensor:
        """(16, n_cols, n_rows) limbs, whichever layout the trace is in."""
        return fd.unpacked(self.data)

    # -- constructors -------------------------------------------------------

    @classmethod
    def empty(cls, *, device) -> "TraceTable":
        return cls(torch.zeros((N_LIMBS, 0, 0), dtype=torch.int32, device=device))

    @classmethod
    def from_int_columns(cls, cols: list[list[int]], *, device) -> "TraceTable":
        """Columns of python ints (< p) -> a packed trace on ``device``.

        Compact ingest, as in the JAX package: a column whose values all fit
        64 bits (registers, addresses, offsets, flags, instructions) goes to
        the device as one 64-bit word per value, a full-width felt column as
        four.  The 16-limb expansion and the Montgomery conversion
        (``fd.to_mont``, the H1 kernel on a CUDA device, which writes packed
        words) run on ``device``, ``_INGEST_COLS`` columns at a time, each
        copied into the packed trace."""
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
            small_arrs.append(a.view(np.int64)[:, None])
        out = torch.empty((N_LIMBS // 2, len(cols), n_rows), dtype=torch.int32,
                          device=device)
        for idx, arrs, n_limbs in ((small_idx, small_arrs, 4),
                                   (felt_idx, felt_arrs, N_LIMBS)):
            if not arrs:
                continue
            words = torch.from_numpy(np.stack(arrs)).to(device)  # one copy
            for c0 in range(0, len(idx), _INGEST_COLS):
                raw = _words_to_limbs(words[c0:c0 + _INGEST_COLS], n_limbs)
                if n_limbs < N_LIMBS:
                    raw = torch.cat([raw, raw.new_zeros(
                        (N_LIMBS - n_limbs,) + raw.shape[1:])])
                dst = torch.tensor(idx[c0:c0 + _INGEST_COLS],
                                   dtype=torch.int64, device=device)
                out.index_copy_(1, dst, fd.to_mont(raw, packed=True))
        return cls(out)

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
        """Column ``idx`` as (16, n_rows) limbs (a view where unpacked)."""
        return fd.unpacked(self.data[:, idx, :])

    def get_row_ints(self, row_idx: int) -> list[int]:
        return fd.to_ints(fd.unpacked(self.data[:, :, row_idx]))

    def to_int_columns(self) -> list[list[int]]:
        # the resident layout comes to the host (packed: half the bytes) and
        # is unpacked there: a whole-trace unpack on the device would add
        # the full 16-limb copy
        raw = self.data.cpu()
        if fd.is_packed(raw):
            raw = fd.unpack(raw)
        flat = fd.to_ints(raw.reshape(N_LIMBS, -1))
        return [flat[c * self.n_rows:(c + 1) * self.n_rows]
                for c in range(self.n_cols)]

    def concatenate(self, other: "TraceTable") -> "TraceTable":
        if self.data.shape[0] == other.data.shape[0]:
            return TraceTable(torch.cat([self.data, other.data], dim=1))
        return TraceTable(torch.cat([self.unpacked(), other.unpacked()], dim=1))

    # -- polynomial ops -----------------------------------------------------

    def compute_trace_polys(self) -> torch.Tensor:
        """Per-column interpolation: (16, n_cols, n_rows) coefficients."""
        return nttc.interpolate_fft(self.unpacked())
