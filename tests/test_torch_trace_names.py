"""Public names of the port's trace table and evaluation domain against the
JAX package: ``TraceTable.from_columns``, ``compute_trace_polys``,
``Domain.lde_values`` and ``Domain.lde_pow``.

The same limbs, made from a seed with numpy, go through both packages on
the CPU; widths stay under 1024 elements a call, so the JAX side takes its
plain path.  Field values must be bit-equal (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambdaworks_cairo_prover_tpu.air.examples import simple_fibonacci as jfib
from lambdaworks_cairo_prover_tpu.air.trace import TraceTable as JTrace
from lambdaworks_cairo_prover_tpu.field.params import N_LIMBS
from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions as JOptions
from lambdaworks_cairo_prover_tpu.prover.domain import Domain as JDomain
from lambdaworks_cairo_prover_tpu_torch.air.examples import simple_fibonacci as tfib
from lambdaworks_cairo_prover_tpu_torch.air.trace import TraceTable
from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                        limbs_to_numpy)
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.prover.domain import Domain

torch.set_num_threads(1)

ROWS = 64  # LDE of 256 points at blowup 4


def columns(seed: int, n_cols: int, n_rows: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_cols):
        limbs = rng.integers(0, 1 << 16, size=(N_LIMBS, n_rows), dtype=np.uint32)
        limbs[N_LIMBS - 1] &= 0x7FF
        out.append(limbs)
    return out


@pytest.fixture(scope="module")
def domains():
    jair = jfib.FibonacciAIR(ROWS, jfib.FibonacciPublicInputs(a0=1, a1=1),
                             JOptions.default_test_options())
    tair = tfib.FibonacciAIR(ROWS, tfib.FibonacciPublicInputs(a0=1, a1=1),
                             ProofOptions.default_test_options())
    return JDomain(jair), Domain(tair)


def test_from_columns_and_trace_polys_match_jax():
    cols = columns(11, 3, ROWS)
    jt = JTrace.from_columns([jnp.asarray(c) for c in cols])
    tt = TraceTable.from_columns([limbs_from_numpy(c, "cpu") for c in cols])
    assert (tt.n_cols, tt.n_rows) == (3, ROWS)
    assert np.array_equal(limbs_to_numpy(tt.data), np.asarray(jt.data))
    assert np.array_equal(limbs_to_numpy(tt.compute_trace_polys()),
                          np.asarray(jt.compute_trace_polys()))


def test_lde_values_match_jax(domains):
    jd, td = domains
    got = td.lde_values(device="cpu")
    assert got.shape == (N_LIMBS, ROWS * 4)
    assert np.array_equal(limbs_to_numpy(got), np.asarray(jd.lde_values()))
    assert td.lde_values(device="cpu") is got  # cached


@pytest.mark.parametrize("exponent", [0, 1, 5, ROWS * 3 - 1])
def test_lde_pow_matches_jax(domains, exponent):
    jd, td = domains
    assert np.array_equal(limbs_to_numpy(td.lde_pow(exponent, device="cpu")),
                          np.asarray(jd.lde_pow(exponent)))
