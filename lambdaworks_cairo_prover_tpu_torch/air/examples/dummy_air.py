"""Dummy AIR: a bit-constraint plus Fibonacci (reference example/dummy_air.rs)."""

from __future__ import annotations

from ...field.params import P
from ..base import AIR, AirContext
from ..boundary import BoundaryConstraint, BoundaryConstraints
from ..trace import TraceTable


class DummyAIR(AIR):
    def __init__(self, trace_length, pub_inputs, proof_options):
        super().__init__(trace_length, pub_inputs, proof_options)
        self.context = AirContext(
            proof_options=proof_options,
            trace_columns=2,
            transition_degrees=[2, 1],
            transition_offsets=[0, 1, 2],
            transition_exemptions=[0, 2],
            num_transition_constraints=2,
            num_transition_exemptions=1,
        )

    def composition_poly_degree_bound(self):
        return self.trace_length()

    def compute_transition(self, frame, rap_challenges):
        first = frame.get_row(0)
        second = frame.get_row(1)
        third = frame.get_row(2)
        f_constraint = first[0] * (first[0] - 1)
        fib_constraint = third[1] - second[1] - first[1]
        return [f_constraint, fib_constraint]

    def boundary_constraints(self, rap_challenges):
        return BoundaryConstraints.from_constraints(
            [BoundaryConstraint(1, 0, 1), BoundaryConstraint(1, 1, 1)]
        )


def dummy_trace(trace_length, *, device) -> TraceTable:
    fib = [1, 1]
    for i in range(2, trace_length):
        fib.append((fib[i - 1] + fib[i - 2]) % P)
    ones = [1] * trace_length
    return TraceTable.from_int_columns([ones, fib], device=device)
