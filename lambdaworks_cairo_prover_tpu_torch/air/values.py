"""Field-value wrapper so AIR constraints are written once and evaluated both
on the tensor device (whole-LDE-domain limb tensors) and on the host
(out-of-domain scalars).

The reference evaluates `compute_transition` per frame point
(evaluator.rs:189-255); here the same constraint code runs as whole-tensor
ops over the domain axis (TorchCtx) or as python-int arithmetic (HostCtx,
used by the verifier on the OOD frame)."""

from __future__ import annotations

import torch

from ..field import device as fd
from ..field.params import P


class FV:
    """A field value bound to an evaluation context."""

    __slots__ = ("ctx", "v")

    def __init__(self, ctx, v):
        self.ctx = ctx
        self.v = v

    def _coerce(self, other):
        if isinstance(other, FV):
            return other
        if isinstance(other, int):
            return self.ctx.const(other)
        raise TypeError(f"cannot coerce {type(other)}")

    def __add__(self, other):
        o = self._coerce(other)
        return FV(self.ctx, self.ctx.add(self.v, o.v))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return FV(self.ctx, self.ctx.sub(self.v, o.v))

    def __rsub__(self, other):
        o = self._coerce(other)
        return FV(self.ctx, self.ctx.sub(o.v, self.v))

    def __mul__(self, other):
        o = self._coerce(other)
        return FV(self.ctx, self.ctx.mul(self.v, o.v))

    __rmul__ = __mul__

    def __neg__(self):
        return FV(self.ctx, self.ctx.sub(self.ctx.const(0).v, self.v))

    def inv(self):
        return FV(self.ctx, self.ctx.inv(self.v))


class TorchCtx:
    """Values are (16, ...) int32 Montgomery limb tensors on ``device``
    (the interface of the JAX package's DeviceCtx)."""

    def __init__(self, batch_shape=(), *, device):
        self.batch_shape = tuple(batch_shape)
        self.device = torch.device(device)
        self._const_cache: dict[int, torch.Tensor] = {}

    def const(self, c: int) -> FV:
        c = c % P
        if c not in self._const_cache:
            arr = fd.from_int(c, device=self.device).reshape(
                (16,) + (1,) * len(self.batch_shape)
            )
            self._const_cache[c] = arr
        return FV(self, self._const_cache[c])

    def wrap(self, arr) -> FV:
        return FV(self, arr)

    def lift(self, v) -> FV:
        """int -> constant; tensor -> runtime value."""
        if isinstance(v, int):
            return self.const(v)
        return FV(self, v.reshape((16,) + (1,) * len(self.batch_shape)))

    add = staticmethod(fd.add)
    sub = staticmethod(fd.sub)
    mul = staticmethod(fd.mul)
    inv = staticmethod(fd.inv)


class HostCtx:
    """Values are python ints mod P."""

    def const(self, c: int) -> FV:
        return FV(self, c % P)

    def wrap(self, v: int) -> FV:
        return FV(self, v % P)

    def lift(self, v) -> FV:
        return FV(self, v % P)

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return (a * b) % P

    @staticmethod
    def inv(a):
        return pow(a, P - 2, P)
