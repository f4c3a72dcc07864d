"""Fibonacci RAP: auxiliary permutation column (reference example/fibonacci_rap.rs).

Exercises the full randomized-AIR-with-preprocessing path: a transcript-drawn
challenge, an auxiliary grand-product column, and a second commitment."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...field import device as fd
from ...field import host as fh
from ...field.params import P
from ...transcript import transcript_to_field
from ..base import AIR, AirContext
from ..boundary import BoundaryConstraint, BoundaryConstraints
from ..trace import TraceTable


@dataclass
class FibonacciRAPPublicInputs:
    steps: int
    a0: int
    a1: int


class FibonacciRAP(AIR):
    def __init__(self, trace_length, pub_inputs, proof_options):
        super().__init__(trace_length, pub_inputs, proof_options)
        exemptions = 3 + trace_length - pub_inputs.steps - 1
        self.context = AirContext(
            proof_options=proof_options,
            trace_columns=3,
            transition_degrees=[1, 2],
            transition_offsets=[0, 1, 2],
            transition_exemptions=[exemptions, 1],
            num_transition_constraints=2,
            num_transition_exemptions=2,
        )

    def composition_poly_degree_bound(self):
        return self.trace_length()

    def number_auxiliary_rap_columns(self):
        return 1

    def build_rap_challenges(self, transcript):
        return (transcript_to_field(transcript),)

    def build_auxiliary_trace(self, main_trace: TraceTable, rap) -> TraceTable:
        """z_0 = 1;  z_{i+1} = z_i * (a_i + gamma) / (b_i + gamma), on the
        main trace's device: one batch inverse and one prefix product."""
        dev = main_trace.data.device
        gamma = fd.from_int(rap[0], device=dev)  # (16, 1)
        a = main_trace.col(0)[:, :-1]
        b = main_trace.col(1)[:, :-1]
        ratio = fd.mul(fd.add(a, gamma), fd.batch_inverse(fd.add(b, gamma)))
        z = torch.cat([fd.ones((1,), device=dev), fd.prefix_product(ratio)],
                      dim=1)
        return TraceTable(z[:, None, :])

    def build_auxiliary_trace_host(self, main_trace: TraceTable,
                                   rap) -> TraceTable:
        """The same column with python ints on the host (the JAX package's
        construction), the oracle of the device build."""
        gamma = rap[0]
        cols = main_trace.to_int_columns()
        not_perm, perm = cols[0], cols[1]
        n = main_trace.n_rows
        denoms = [(perm[i] + gamma) % P for i in range(n - 1)]
        inv_denoms = fh.batch_inverse(denoms)
        aux = [1]
        for i in range(1, n):
            aux.append(aux[i - 1] * ((not_perm[i - 1] + gamma) % P) % P * inv_denoms[i - 1] % P)
        return TraceTable.from_int_columns([aux], device=main_trace.data.device)

    def compute_transition(self, frame, rap):
        gamma = rap[0]
        first = frame.get_row(0)
        second = frame.get_row(1)
        third = frame.get_row(2)
        constraints = [third[0] - second[0] - first[0]]
        z_i = first[2]
        z_next = second[2]
        a_i = first[0]
        b_i = first[1]
        constraints.append(z_next * (b_i + gamma) - z_i * (a_i + gamma))
        return constraints

    def boundary_constraints(self, rap_challenges):
        return BoundaryConstraints.from_constraints(
            [
                BoundaryConstraint(0, 0, 1),
                BoundaryConstraint(0, 1, 1),
                BoundaryConstraint(2, 0, 1),
            ]
        )


def fibonacci_rap_trace(initial_values, trace_length, *, device) -> TraceTable:
    fib = [initial_values[0], initial_values[1]]
    for i in range(2, trace_length):
        fib.append((fib[i - 1] + fib[i - 2]) % P)
    permuted = list(fib)
    permuted[0] = fib[trace_length - 1]
    permuted[trace_length - 1] = initial_values[0]
    fib.append(0)
    permuted.append(0)
    # resize to next power of two, padding with zeros (lambdaworks
    # `resize_to_next_power_of_two` pads with the ZERO element? it pads by
    # resizing with the last element; here last element is 0 either way)
    target = 1 << (len(fib) - 1).bit_length()
    while len(fib) < target:
        fib.append(0)
        permuted.append(0)
    return TraceTable.from_int_columns([fib, permuted], device=device)
