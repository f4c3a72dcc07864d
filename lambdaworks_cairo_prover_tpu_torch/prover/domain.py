"""Evaluation domains (reference src/starks/domain.rs).

Host-side scalars (roots, orders) plus lazily built tensors of the LDE
coset values and their powers, cached per device."""

from __future__ import annotations

import torch

from ..field import device as fd
from ..field.params import P, get_primitive_root_of_unity
from ..ntt import core as nttc


class Domain:
    def __init__(self, air):
        options = air.options()
        self.blowup_factor = int(options.blowup_factor)
        self.coset_offset = int(options.coset_offset) % P
        self.interpolation_domain_size = air.trace_length()
        n = air.trace_length()
        self.root_order = n.bit_length() - 1
        assert 1 << self.root_order == n, "trace length must be a power of two"
        self.trace_primitive_root = get_primitive_root_of_unity(self.root_order)
        self.lde_root_order = (n * self.blowup_factor).bit_length() - 1
        self.lde_size = n * self.blowup_factor
        self.lde_primitive_root = get_primitive_root_of_unity(self.lde_root_order)
        self._cache: dict = {}

    # -- device tensors -----------------------------------------------------

    def lde_values(self, *, device, packed: bool = False) -> torch.Tensor:
        """Montgomery h * w^i over the LDE coset: (16, N) limbs, or (8, N)
        packed words written so by the product that makes them."""
        key = ("lde_values", packed, torch.device(device))
        if key not in self._cache:
            pw = nttc.offset_powers(self.lde_primitive_root, self.lde_size,
                                    device)
            self._cache[key] = fd.mul(pw, fd.from_int(self.coset_offset,
                                                      device=device), packed)
        return self._cache[key]

    def lde_pow(self, exponent: int, *, device,
                packed: bool = False) -> torch.Tensor:
        """d_i^exponent for d_i in the LDE coset: h^e * (w^e)^i, one powers
        table and a scalar scale; (16, N) limbs or (8, N) packed words."""
        key = ("lde_pow", exponent, packed, torch.device(device))
        if key not in self._cache:
            pw = fd.powers(pow(self.lde_primitive_root, exponent, P),
                           self.lde_size, device=device)
            self._cache[key] = fd.mul(pw, fd.from_int(
                pow(self.coset_offset, exponent, P), device=device), packed)
        return self._cache[key]

    def forget(self, *, device) -> None:
        """Drop the tables cached on ``device``, and the powers table that
        ``lde_values`` is built from: a caller that keeps its own copy (the
        prover's packed tables) lets the (16, N) originals go."""
        device = torch.device(device)
        for key in [k for k in self._cache if k[-1] == device]:
            del self._cache[key]
        nttc.forget_powers(self.lde_primitive_root, self.lde_size, device)

    # -- host scalars -------------------------------------------------------

    def trace_root_pow(self, step: int) -> int:
        return pow(self.trace_primitive_root, step, P)

    def lde_point(self, index: int) -> int:
        return (
            self.coset_offset * pow(self.lde_primitive_root, index, P)
        ) % P

    def contains_in_lde_coset(self, z: int) -> bool:
        h_inv = pow(self.coset_offset, P - 2, P)
        return pow(z * h_inv % P, self.lde_size, P) == 1

    def contains_in_trace_roots(self, z: int) -> bool:
        return pow(z, self.interpolation_domain_size, P) == 1
