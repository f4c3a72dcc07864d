"""The AIR protocol (reference src/starks/traits.rs:15-119) and AirContext.

Subclasses describe an algebraic intermediate representation; the generic
prover/verifier are parameterized by an AIR instance.  `compute_transition`
is written once against the FV wrapper and evaluated either over the whole
LDE domain (device) or on a single OOD frame (host)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..field.params import P, get_primitive_root_of_unity
from ..proof.options import ProofOptions
from .boundary import BoundaryConstraints
from .trace import TraceTable


@dataclass
class AirContext:
    proof_options: ProofOptions
    trace_columns: int
    transition_degrees: list[int]
    transition_offsets: list[int]
    transition_exemptions: list[int]
    num_transition_constraints: int
    num_transition_exemptions: int = 1


class AIR:
    """Base class; subclasses must set self.context in __init__."""

    def __init__(self, trace_length: int, pub_inputs, proof_options: ProofOptions):
        self.trace_length_ = trace_length
        self.pub_inputs_ = pub_inputs
        self.proof_options = proof_options
        self.context: AirContext = None  # set by subclass

    # -- required overrides -------------------------------------------------

    def build_auxiliary_trace(self, main_trace: TraceTable, rap_challenges) -> TraceTable:
        return TraceTable.empty(device=main_trace.data.device)

    def build_rap_challenges(self, transcript):
        """Returns a tuple of ints (transcript field draws)."""
        return ()

    def wrap_rap_challenges(self, ctx, rap):
        """Lift the rap-challenge tuple (ints or limb arrays) into FVs bound
        to an evaluation context, for use inside compute_transition."""
        return tuple(ctx.lift(v) for v in rap)

    def kernel_cache_key(self):
        """Hashable key distinguishing pub-input-dependent kernel structure
        (boundary steps, exemptions); override when those vary."""
        return ()

    def number_auxiliary_rap_columns(self) -> int:
        return 0

    def composition_poly_degree_bound(self) -> int:
        raise NotImplementedError

    def compute_transition(self, frame, rap_challenges) -> list:
        """Returns a list of FV (one per transition constraint)."""
        raise NotImplementedError

    def boundary_constraints(self, rap_challenges) -> BoundaryConstraints:
        raise NotImplementedError

    # -- provided helpers (mirror trait defaults) ---------------------------

    def trace_length(self) -> int:
        return self.trace_length_

    def pub_inputs(self):
        return self.pub_inputs_

    def options(self) -> ProofOptions:
        return self.context.proof_options

    def blowup_factor(self) -> int:
        return self.options().blowup_factor

    def num_transition_constraints(self) -> int:
        return self.context.num_transition_constraints

    def transition_exemption_counts(self) -> list[int]:
        """Distinct positive exemption counts, in first-appearance order
        (matches traits.rs:49-79 `unique_by` + filter > 0)."""
        seen = []
        for c in self.context.transition_exemptions:
            if c > 0 and c not in seen:
                seen.append(c)
        return seen

    def exemption_roots(self, count: int) -> list[int]:
        """Roots of the exemption polynomial for a given count: the last
        ``count`` trace roots of unity g^(n-1), g^(n-2), ... (traits.rs:66-77)."""
        n = self.trace_length()
        g = get_primitive_root_of_unity(n.bit_length() - 1)
        return [pow(g, n - 1 - j, P) for j in range(count)]

    def exemption_eval_at(self, count: int, x: int) -> int:
        acc = 1
        for r in self.exemption_roots(count):
            acc = acc * (x - r) % P
        return acc
