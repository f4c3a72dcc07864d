"""The PyTorch port's example AIRs, trace oracle and host polynomials
against the JAX package, on the CPU.

The four example AIRs (``fibonacci_2_columns``, ``quadratic_air``,
``fibonacci_rap``, ``dummy_air``) are proved as ``tests/test_examples.py``
proves them (16 steps, ``default_test_options()``); the JAX package's proofs
come from ``tests/fixtures/torch_port/`` (written by
``tools/make_torch_fixtures.py``: a live JAX prove compiles for over a
minute on a CPU).  The transcript is deterministic, so the proofs must be
equal byte for byte."""

import os

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu.air import trace as jtrace
from lambdaworks_cairo_prover_tpu.air.examples import dummy_air as jdummy
from lambdaworks_cairo_prover_tpu.air.examples import (
    fibonacci_2_columns as jfib2)
from lambdaworks_cairo_prover_tpu.air.examples import fibonacci_rap as jrap
from lambdaworks_cairo_prover_tpu.air.examples import quadratic_air as jquad
from lambdaworks_cairo_prover_tpu.ntt import poly_host as jph
from lambdaworks_cairo_prover_tpu.proof import serde as jserde
from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions as JOptions
from lambdaworks_cairo_prover_tpu.prover import debug as jdebug
from lambdaworks_cairo_prover_tpu.verifier.verify import verify as jverify
from lambdaworks_cairo_prover_tpu_torch.air.examples import dummy_air
from lambdaworks_cairo_prover_tpu_torch.air.examples import (
    fibonacci_2_columns as fib2)
from lambdaworks_cairo_prover_tpu_torch.air.examples import fibonacci_rap
from lambdaworks_cairo_prover_tpu_torch.air.examples import quadratic_air
from lambdaworks_cairo_prover_tpu_torch.air.trace import TraceTable
from lambdaworks_cairo_prover_tpu_torch.field.params import P
from lambdaworks_cairo_prover_tpu_torch.ntt import poly_host as ph
from lambdaworks_cairo_prover_tpu_torch.proof import serde
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.prover import debug
from lambdaworks_cairo_prover_tpu_torch.prover.prove import ProvingError, prove
from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

import torch_parity as tp

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
OPTIONS = ProofOptions.default_test_options()
STEPS = 16
# name -> (port trace, public inputs, port AIR, JAX trace, JAX public inputs,
# JAX AIR), as tests/test_examples.py makes them
EXAMPLES = {
    "fibonacci_2_columns": lambda: (
        fib2.fibonacci_trace_2_columns([1, 1], STEPS, device="cpu"),
        fib2.Fibonacci2PublicInputs(a0=1, a1=1), fib2.Fibonacci2ColsAIR,
        jfib2.fibonacci_trace_2_columns([1, 1], STEPS),
        jfib2.Fibonacci2PublicInputs(a0=1, a1=1), jfib2.Fibonacci2ColsAIR),
    "quadratic_air": lambda: (
        quadratic_air.quadratic_trace(3, STEPS, device="cpu"),
        quadratic_air.QuadraticPublicInputs(a0=3), quadratic_air.QuadraticAIR,
        jquad.quadratic_trace(3, STEPS), jquad.QuadraticPublicInputs(a0=3),
        jquad.QuadraticAIR),
    "fibonacci_rap": lambda: (
        fibonacci_rap.fibonacci_rap_trace([1, 1], STEPS, device="cpu"),
        fibonacci_rap.FibonacciRAPPublicInputs(steps=STEPS, a0=1, a1=1),
        fibonacci_rap.FibonacciRAP,
        jrap.fibonacci_rap_trace([1, 1], STEPS),
        jrap.FibonacciRAPPublicInputs(steps=STEPS, a0=1, a1=1),
        jrap.FibonacciRAP),
    "dummy_air": lambda: (
        dummy_air.dummy_trace(STEPS, device="cpu"), None, dummy_air.DummyAIR,
        jdummy.dummy_trace(STEPS), None, jdummy.DummyAIR),
}


@pytest.fixture(scope="module", params=list(EXAMPLES))
def example(request):
    """(name, port trace, public inputs, AIR, the port's proof, JAX trace,
    JAX public inputs, JAX AIR)."""
    trace, pub, air, jt, jpub, jair = EXAMPLES[request.param]()
    proof = prove(trace, pub, OPTIONS, air, device="cpu")
    return request.param, trace, pub, air, proof, jt, jpub, jair


def test_example_trace_matches_jax(example):
    _, trace, _, _, _, jt, _, _ = example
    assert trace.to_int_columns() == jt.to_int_columns()


def test_example_proof_equals_jax(example):
    name, _, _, _, proof, _, _, _ = example
    with open(os.path.join(FIXTURES, f"example_{name}_test_options.proof"),
              "rb") as f:
        want = f.read()
    assert serde.serialize_proof(proof) == want


def test_example_verifiers_accept_each_others_proofs(example):
    name, _, pub, air, proof, _, jpub, jair = example
    assert verify(proof, pub, OPTIONS, air)
    with open(os.path.join(FIXTURES, f"example_{name}_test_options.proof"),
              "rb") as f:
        data = f.read()
    assert verify(serde.deserialize_proof(data), pub, OPTIONS, air)
    assert jverify(jserde.deserialize_proof(serde.serialize_proof(proof)),
                   jpub, JOptions.default_test_options(), jair)


def test_fibonacci_rap_device_build_equals_host_construction():
    trace = fibonacci_rap.fibonacci_rap_trace([1, 1], STEPS, device="cpu")
    air = fibonacci_rap.FibonacciRAP(
        trace.n_rows, fibonacci_rap.FibonacciRAPPublicInputs(STEPS, 1, 1),
        OPTIONS)
    rng = np.random.default_rng(400)
    for _ in range(3):
        gamma = (int(rng.integers(1 << 62)) << 190) % P
        dev = air.build_auxiliary_trace(trace, (gamma,))
        host = air.build_auxiliary_trace_host(trace, (gamma,))
        assert torch.equal(dev.unpacked(), host.unpacked())
        jair = jrap.FibonacciRAP(
            trace.n_rows, jrap.FibonacciRAPPublicInputs(STEPS, 1, 1),
            JOptions.default_test_options())
        jaux = jair.build_auxiliary_trace(
            jrap.fibonacci_rap_trace([1, 1], STEPS), (gamma,))
        assert dev.to_int_columns() == jaux.to_int_columns()


# -- the trace oracle (prover/debug.py) ---------------------------------------


def _tampered(trace: TraceTable, col: int, row: int) -> list[list[int]]:
    cols = trace.to_int_columns()
    cols[col][row] = (cols[col][row] + 1) % P
    return cols


@pytest.mark.parametrize("name", list(EXAMPLES))
@pytest.mark.parametrize("tamper", [None, (0, 5)], ids=["valid", "tampered"])
def test_validate_trace_matches_jax(name, tamper, capsys):
    trace, pub, air_cls, jt, jpub, jair_cls = EXAMPLES[name]()
    if tamper is not None:
        cols = _tampered(trace, *tamper)
        trace = TraceTable.from_int_columns(cols, device="cpu")
        jt = jtrace.TraceTable.from_int_columns(cols)
    air = air_cls(trace.n_rows, pub, OPTIONS)
    jair = jair_cls(jt.n_rows, jpub, JOptions.default_test_options())
    rap = (12345,) if air.number_auxiliary_rap_columns() else ()
    aux = air.build_auxiliary_trace(trace, rap)
    jaux = jair.build_auxiliary_trace(jt, rap)
    got = debug.validate_trace(air, trace, aux, rap)
    printed = capsys.readouterr().out
    assert got == jdebug.validate_trace(jair, jt, jaux, rap)
    assert capsys.readouterr().out == printed
    assert got == (tamper is None)
    assert debug.check_boundary_polys_divisibility(air, trace, aux, rap) == (
        jdebug.check_boundary_polys_divisibility(jair, jt, jaux, rap))


def test_validate_trace_hook_refuses_a_tampered_trace(monkeypatch):
    trace, pub, air, *_ = EXAMPLES["fibonacci_2_columns"]()
    bad = TraceTable.from_int_columns(_tampered(trace, 1, 3), device="cpu")
    monkeypatch.setenv("LCP_VALIDATE_TRACE", "1")
    with pytest.raises(ProvingError, match="does not satisfy"):
        prove(bad, pub, OPTIONS, air, device="cpu")
    # without the hook the prover goes on and the proof does not verify
    monkeypatch.delenv("LCP_VALIDATE_TRACE")
    assert not verify(prove(bad, pub, OPTIONS, air, device="cpu"), pub,
                      OPTIONS, air)


# -- host polynomials (ntt/poly_host.py) --------------------------------------


@pytest.mark.parametrize("case", tp.cases("test_poly_host"), ids=tp.case_id)
def test_poly_host_case_matches_jax(case):
    tp.check_case(case, no_vm=[f for _, f, _ in tp.cases("test_poly_host")])


def test_poly_host_functions_match_jax():
    rng = np.random.default_rng(401)

    def felts(n):
        return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]

    for n in (1, 2, 7, 16):
        a, b, x = felts(n), felts(n + 3), felts(1)[0]
        for fn, args in [("trim", (a + [0, 0],)), ("degree", (a,)),
                         ("evaluate", (a, x)), ("add", (a, b)),
                         ("scalar_mul", (a, x)), ("mul", (a, b)),
                         ("ruffini_division", (b, x)),
                         ("long_division", (b, a)),
                         ("even_odd_decomposition", (b,)),
                         ("fold_polynomial", (b, x))]:
            assert getattr(ph, fn)(*args) == getattr(jph, fn)(*args), fn


@pytest.mark.parametrize("tamper", [None, (5, 3)], ids=["valid", "tampered"])
def test_validate_trace_on_a_cairo_trace_matches_jax(tamper, capsys):
    """The oracle on the range-check program's 61-column Cairo trace (the
    auxiliary columns from each package's host construction)."""
    from lambdaworks_cairo_prover_tpu.cairo import air as jcairo_air
    from lambdaworks_cairo_prover_tpu.cairo import programs as jprograms
    from lambdaworks_cairo_prover_tpu.cairo import runner as jrunner
    from lambdaworks_cairo_prover_tpu_torch.cairo import air as cairo_air
    from lambdaworks_cairo_prover_tpu_torch.cairo import programs
    from lambdaworks_cairo_prover_tpu_torch.cairo import runner

    trace, pub = runner.generate_prover_args(programs.rc_program(),
                                             device="cpu")
    jt, jpub = jrunner.generate_prover_args(jprograms.rc_program())
    if tamper is not None:
        cols = _tampered(trace, *tamper)
        trace = TraceTable.from_int_columns(cols, device="cpu")
        jt = jtrace.TraceTable.from_int_columns(cols)
    rap = (111, 222, 333)
    air = cairo_air.CairoAIR(trace.n_rows, pub, OPTIONS)
    jair = jcairo_air.CairoAIR(jt.n_rows, jpub, JOptions.default_test_options())
    assert air.has_rc_builtin
    aux = air.build_auxiliary_trace_host(trace, rap)
    got = debug.validate_trace(air, trace, aux, rap)
    printed = capsys.readouterr().out
    assert got == jdebug.validate_trace(
        jair, jt, jair.build_auxiliary_trace_host(jt, rap), rap)
    assert capsys.readouterr().out == printed
    assert got == (tamper is None)
    assert torch.equal(air.build_auxiliary_trace(trace, rap).unpacked(),
                       aux.unpacked())
