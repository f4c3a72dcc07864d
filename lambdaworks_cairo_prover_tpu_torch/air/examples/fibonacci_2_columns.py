"""Two-column Fibonacci AIR (reference example/fibonacci_2_columns.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ...field.params import P
from ..base import AIR, AirContext
from ..boundary import BoundaryConstraint, BoundaryConstraints
from ..trace import TraceTable


@dataclass
class Fibonacci2PublicInputs:
    a0: int
    a1: int


class Fibonacci2ColsAIR(AIR):
    def __init__(self, trace_length, pub_inputs, proof_options):
        super().__init__(trace_length, pub_inputs, proof_options)
        self.context = AirContext(
            proof_options=proof_options,
            trace_columns=2,
            transition_degrees=[1, 1],
            transition_offsets=[0, 1],
            transition_exemptions=[1, 1],
            num_transition_constraints=2,
            num_transition_exemptions=1,
        )

    def composition_poly_degree_bound(self):
        return self.trace_length()

    def compute_transition(self, frame, rap_challenges):
        first = frame.get_row(0)
        second = frame.get_row(1)
        return [
            second[0] - first[0] - first[1],
            second[1] - first[1] - second[0],
        ]

    def boundary_constraints(self, rap_challenges):
        return BoundaryConstraints.from_constraints(
            [
                BoundaryConstraint(0, 0, self.pub_inputs_.a0),
                BoundaryConstraint(1, 0, self.pub_inputs_.a1),
            ]
        )


def fibonacci_trace_2_columns(initial_values, trace_length, *,
                              device) -> TraceTable:
    ret1 = [initial_values[0]]
    ret2 = [initial_values[1]]
    for i in range(1, trace_length):
        new_val = (ret1[i - 1] + ret2[i - 1]) % P
        ret1.append(new_val)
        ret2.append((new_val + ret2[i - 1]) % P)
    return TraceTable.from_int_columns([ret1, ret2], device=device)
