"""Simple Fibonacci AIR (reference src/starks/example/simple_fibonacci.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ...proof.options import ProofOptions
from ..base import AIR, AirContext
from ..boundary import BoundaryConstraint, BoundaryConstraints
from ..trace import TraceTable


@dataclass
class FibonacciPublicInputs:
    a0: int
    a1: int


class FibonacciAIR(AIR):
    def __init__(self, trace_length, pub_inputs, proof_options: ProofOptions):
        super().__init__(trace_length, pub_inputs, proof_options)
        self.context = AirContext(
            proof_options=proof_options,
            trace_columns=1,
            transition_degrees=[1],
            transition_exemptions=[2],
            transition_offsets=[0, 1, 2],
            num_transition_constraints=1,
            num_transition_exemptions=1,
        )

    def composition_poly_degree_bound(self):
        return self.trace_length()

    def compute_transition(self, frame, rap_challenges):
        first = frame.get_row(0)
        second = frame.get_row(1)
        third = frame.get_row(2)
        return [third[0] - second[0] - first[0]]

    def boundary_constraints(self, rap_challenges):
        return BoundaryConstraints.from_constraints(
            [
                BoundaryConstraint(0, 0, self.pub_inputs_.a0),
                BoundaryConstraint(0, 1, self.pub_inputs_.a1),
            ]
        )


def fibonacci_trace(initial_values, trace_length, *, device) -> TraceTable:
    ret = [initial_values[0], initial_values[1]]
    from ...field.params import P

    for i in range(2, trace_length):
        ret.append((ret[i - 1] + ret[i - 2]) % P)
    return TraceTable.from_int_columns([ret], device=device)
