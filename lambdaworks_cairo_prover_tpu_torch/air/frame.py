"""Evaluation frames.

DeviceFrame: the whole-domain sliding window — row k is the LDE trace rolled
by ``k * blowup`` positions (wraparound), so `compute_transition` evaluates
every transition constraint at EVERY domain point at once (replacing the
reference's per-point `Frame::read_from_trace`, src/starks/frame.rs:40-59).

HostFrame: a single concrete frame of python ints (the out-of-domain frame
used by the verifier)."""

from __future__ import annotations

import torch

from .values import FV, HostCtx, TorchCtx


class _DeviceRow:
    """Row ``k`` of the window: column ``c`` is the LDE column rolled by
    ``shift`` positions.  A column is rolled when a constraint first reads
    it and kept, so only the columns that are read at this offset are
    copied (at 52 columns of 2^21 points a whole rolled copy is 7 GB)."""

    def __init__(self, ctx: TorchCtx, data: torch.Tensor, shift: int):
        self._ctx = ctx
        self._data = data  # (16, n_cols, n_points)
        self._shift = shift
        self._cols: dict[int, torch.Tensor] = {}

    def __getitem__(self, col: int) -> FV:
        if self._shift == 0:
            return self._ctx.wrap(self._data[:, col, :])
        if col not in self._cols:
            self._cols[col] = self._shifted(col)
        return self._ctx.wrap(self._cols[col])

    def _shifted(self, col: int) -> torch.Tensor:
        return torch.roll(self._data[:, col, :], -self._shift, dims=1)


class DeviceFrame:
    def __init__(self, lde_data: torch.Tensor, offsets: list[int], blowup: int):
        # lde_data: (16, n_cols, n_points)
        self.ctx = TorchCtx(batch_shape=(lde_data.shape[2],),
                            device=lde_data.device)
        self._rows = {k: _DeviceRow(self.ctx, lde_data, k * blowup)
                      for k in set(offsets)}

    def get_row(self, k: int) -> _DeviceRow:
        return self._rows[k]


class _HostRow:
    def __init__(self, ctx: HostCtx, vals: list[int]):
        self._ctx = ctx
        self._vals = vals

    def __getitem__(self, col: int) -> FV:
        return self._ctx.wrap(self._vals[col])


class HostFrame:
    """rows: list (per transition offset) of lists of ints (per column)."""

    def __init__(self, rows: list[list[int]]):
        self.ctx = HostCtx()
        self.rows = rows

    def get_row(self, k: int) -> _HostRow:
        return _HostRow(self.ctx, self.rows[k])

    def num_rows(self) -> int:
        return len(self.rows)

    def num_columns(self) -> int:
        return len(self.rows[0]) if self.rows else 0
