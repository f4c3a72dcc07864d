"""Evaluation frames.

HaloFrame: the transition window over one run of LDE points (a chunk of
the domain, or a rank's block of it) and the halo after it — row k is the
run shifted by ``k * blowup`` points, read from the run and, past its end,
from the halo; so `compute_transition` evaluates every transition
constraint at every point of the run at once (replacing the reference's
per-point `Frame::read_from_trace`, src/starks/frame.rs:40-59).  The prover
walks the domain in such runs: the halo of the last one is the first
points of the domain (the wraparound).

DeviceFrame: the whole-domain window, a HaloFrame whose halo is the
domain's first points.

HostFrame: a single concrete frame of python ints (the out-of-domain frame
used by the verifier)."""

from __future__ import annotations

import torch

from .values import FV, HostCtx, TorchCtx


class _WindowRow:
    """Row at ``shift`` of a window: column c is the (rows, length) view of
    the window's points [shift, shift + length)."""

    def __init__(self, ctx: TorchCtx, data: torch.Tensor, shift: int,
                 length: int):
        self._ctx = ctx
        self._data = data  # (16 or 8, n_cols, length + halo)
        self._shift = shift
        self._length = length

    def __getitem__(self, col: int) -> FV:
        return self._ctx.wrap(
            self._data[:, col, self._shift:self._shift + self._length])


class HaloFrame:
    """The transition frame over ``block`` (16 or 8, cols, L) and the
    ``halo`` (the same layout, at least max(offsets) * blowup points) that
    follows it: one copy of block ‖ halo in their layout, each row a view
    of it.  A packed frame is read by H1/H2 as it lies, and the constraints
    over it come out packed."""

    def __init__(self, block: torch.Tensor, halo: torch.Tensor,
                 offsets: list[int], blowup: int):
        length = block.shape[2]
        self.ctx = TorchCtx(batch_shape=(length,), device=block.device)
        # row 0 of every column is data[:, c, :L]
        self.data = data = torch.cat(
            [block, halo[:, :, :max(offsets) * blowup]], dim=2)
        self._rows = {k: _WindowRow(self.ctx, data, k * blowup, length)
                      for k in set(offsets)}

    def get_row(self, k: int) -> _WindowRow:
        return self._rows[k]


class DeviceFrame(HaloFrame):
    """The frame over the whole domain: the halo wraps to its first points."""

    def __init__(self, lde_data: torch.Tensor, offsets: list[int], blowup: int):
        super().__init__(lde_data, wrap_halo(lde_data, max(offsets) * blowup),
                         offsets, blowup)


def wrap_halo(data: torch.Tensor, h: int) -> torch.Tensor:
    """The h points that follow the last point of ``data`` (..., n) on a
    cycle of n points: its first h points, taken round again where h > n."""
    idx = torch.arange(h, device=data.device) % data.shape[-1]
    return data.index_select(-1, idx)


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
