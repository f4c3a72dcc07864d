"""Trace validation oracle (reference src/starks/debug.rs:14-82).

Evaluates every boundary and transition constraint pointwise on the raw trace
(host python ints) and reports violations.  Intended for tests and debug runs
on small traces before any FFT work happens."""

from __future__ import annotations

from ..air.frame import HostFrame
from ..air.trace import TraceTable
from ..field.params import P, get_primitive_root_of_unity
from ..ntt import poly_host


def validate_trace(air, main_trace: TraceTable, aux_trace, rap_challenges) -> bool:
    cols = main_trace.to_int_columns()
    if aux_trace is not None and not aux_trace.is_empty():
        cols = cols + aux_trace.to_int_columns()
    n_rows = len(cols[0])
    ok = True

    for c in air.boundary_constraints(rap_challenges).constraints:
        actual = cols[c.col][c.step]
        if actual != c.value:
            ok = False
            print(
                f"Boundary constraint violation: col {c.col} step {c.step}: "
                f"expected {c.value}, got {actual}"
            )

    ctx = air.context
    exemption_steps = [n_rows - e for e in ctx.transition_exemptions]
    offsets = ctx.transition_offsets
    for step in range(n_rows):
        rows = [
            [cols[c][(step + o) % n_rows] for c in range(len(cols))] for o in offsets
        ]
        frame = HostFrame(rows)
        rap_fv = air.wrap_rap_challenges(frame.ctx, rap_challenges)
        evals = air.compute_transition(frame, rap_fv)
        for i, fv in enumerate(evals):
            if step < exemption_steps[i] and fv.v != 0:
                ok = False
                print(
                    f"Transition constraint {i} violated at step {step}: {fv.v}"
                )
    return ok


def check_boundary_polys_divisibility(air, main_trace: TraceTable, aux_trace,
                                      rap_challenges) -> bool:
    """Reference debug.rs:84-98: for every boundary-constrained column,
    (trace_poly - interpolant of the (g^step, value) pairs) must divide
    exactly by the boundary zerofier Π (x - g^step); a nonzero remainder is
    reported per column.  Host-int long division — debug/tests only."""
    cols = main_trace.to_int_columns()
    if aux_trace is not None and not aux_trace.is_empty():
        cols = cols + aux_trace.to_int_columns()
    n = len(cols[0])
    g = get_primitive_root_of_unity(n.bit_length() - 1)

    # per-column interpolation on the trace domain (host radix-2 iFFT via
    # evaluate at inverse root, small traces only)
    def interpolate(vals):
        from ..prover.prove import _host_fft

        inv_g = pow(g, P - 2, P)
        coeffs = _host_fft(list(vals), inv_g)
        n_inv = pow(n, P - 2, P)
        return [c * n_inv % P for c in coeffs]

    bc = air.boundary_constraints(rap_challenges)
    by_col: dict[int, list] = {}
    for c in bc.constraints:
        by_col.setdefault(c.col, []).append(c)
    ok = True
    for col, constraints in by_col.items():
        trace_poly = interpolate(cols[col])
        # Lagrange interpolant through the boundary points
        interp = [0]
        for c in constraints:
            x_c = pow(g, c.step, P)
            num, den = [c.value % P], 1
            for other in constraints:
                if other is c:
                    continue
                x_o = pow(g, other.step, P)
                num = poly_host.mul(num, [(-x_o) % P, 1])
                den = den * (x_c - x_o) % P
            num = poly_host.scalar_mul(num, pow(den, P - 2, P))
            interp = poly_host.add(interp, num)
        boundary_poly = poly_host.add(
            trace_poly, poly_host.scalar_mul(interp, P - 1))
        zerofier = [1]
        for c in constraints:
            zerofier = poly_host.mul(zerofier, [(-pow(g, c.step, P)) % P, 1])
        _, rem = poly_host.long_division(boundary_poly, zerofier)
        if any(v % P for v in rem):
            ok = False
            print(f"Boundary poly for col {col} is not divisible by its "
                  f"zerofier (remainder degree {poly_host.degree(rem)})")
    return ok
