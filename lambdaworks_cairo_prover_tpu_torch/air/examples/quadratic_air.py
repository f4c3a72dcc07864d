"""Quadratic AIR, degree-2 transition (reference example/quadratic_air.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ...field.params import P
from ..base import AIR, AirContext
from ..boundary import BoundaryConstraint, BoundaryConstraints
from ..trace import TraceTable


@dataclass
class QuadraticPublicInputs:
    a0: int


class QuadraticAIR(AIR):
    def __init__(self, trace_length, pub_inputs, proof_options):
        super().__init__(trace_length, pub_inputs, proof_options)
        self.context = AirContext(
            proof_options=proof_options,
            trace_columns=1,
            transition_degrees=[2],
            transition_offsets=[0, 1],
            transition_exemptions=[1],
            num_transition_constraints=1,
            num_transition_exemptions=1,
        )

    def composition_poly_degree_bound(self):
        return 2 * self.trace_length()

    def compute_transition(self, frame, rap_challenges):
        first = frame.get_row(0)
        second = frame.get_row(1)
        return [second[0] - first[0] * first[0]]

    def boundary_constraints(self, rap_challenges):
        return BoundaryConstraints.from_constraints(
            [BoundaryConstraint(0, 0, self.pub_inputs_.a0)]
        )


def quadratic_trace(initial_value, trace_length, *, device) -> TraceTable:
    ret = [initial_value]
    for i in range(1, trace_length):
        ret.append(ret[i - 1] * ret[i - 1] % P)
    return TraceTable.from_int_columns([ret], device=device)
