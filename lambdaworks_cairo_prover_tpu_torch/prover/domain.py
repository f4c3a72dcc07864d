"""Evaluation domains (reference src/starks/domain.rs).

Host-side scalars (roots, orders); the prover builds its domain tensors in
prover/kernels.py."""

from __future__ import annotations

from ..field.params import P, get_primitive_root_of_unity


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
