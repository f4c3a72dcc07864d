"""Boundary constraints (reference src/starks/constraints/boundary.rs)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BoundaryConstraint:
    col: int
    step: int
    value: int  # canonical int


class BoundaryConstraints:
    def __init__(self, constraints: list[BoundaryConstraint] | None = None):
        self.constraints = constraints or []

    @classmethod
    def from_constraints(cls, constraints):
        return cls(list(constraints))

    def steps(self, col: int) -> list[int]:
        return [c.step for c in self.constraints if c.col == col]

    def distinct_steps(self) -> list[int]:
        seen = []
        for c in self.constraints:
            if c.step not in seen:
                seen.append(c.step)
        return seen
