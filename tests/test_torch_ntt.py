"""NTTs of the PyTorch port against the JAX package.

The port's CPU path (the plain radix-2 NTT, and the plain versions of the
H3/H4 kernels run in the kernels' DIF schedule) against the JAX transforms,
the Pallas butterflies in interpret mode, and the fused Pallas NTT through
digests recorded from it.  Exact comparisons (tolerance 0): the values are
fixed by the math."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambdaworks_cairo_prover_tpu.field import pallas_mul as pm
from lambdaworks_cairo_prover_tpu.ntt import core as jnttc
from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                        limbs_to_numpy)
from lambdaworks_cairo_prover_tpu_torch.ntt import core as tnttc
from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

from test_torch_field import rand_limbs

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")


def _both(x_np, port_fn, jax_fn):
    got = limbs_to_numpy(port_fn(limbs_from_numpy(x_np, "cpu")))
    want = np.asarray(jax_fn(jnp.asarray(x_np)))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("log_n", [1, 3, 6, 9, 12])
def test_transforms_match_jax(log_n):
    n = 1 << log_n
    x = rand_limbs(log_n, ((2,) if log_n < 12 else ()) + (n,))
    _both(x, tnttc.ntt, jnttc.ntt)
    _both(x, tnttc.intt, jnttc.intt)
    _both(x, lambda c: tnttc.interpolate_offset_fft(c, 3),
          lambda c: jnttc.interpolate_offset_fft(c, 3))
    if log_n < 12:
        _both(x, lambda c: tnttc.evaluate_offset_fft(c, 4, n, 3),
              lambda c: jnttc.evaluate_offset_fft(c, 4, n, 3))
        # more coefficients than domain points: evaluate, then subsample
        _both(x, lambda c: tnttc.evaluate_on_lde_domain(c, 2, max(n // 2, 1), 3),
              lambda c: jnttc.evaluate_on_lde_domain(c, 2, max(n // 2, 1), 3))


def _dif_schedule(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The CUDA NTT's schedule (H3 stages, one H4 pass, bit-reverse) run
    with the kernels' plain versions."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    tw = cn.twiddle_table(log_n, inverse, x.device)
    y = x.reshape(16, 1, n)
    for log_m in range(log_n - 1, cn.LOCAL_LOG - 1, -1):
        y = cn.dif_stage_plain(y, tw, log_m)
    y = cn.dif_local_plain(y, tw, min(log_n, cn.LOCAL_LOG))
    return y.index_select(-1, cn.bitrev_indices(log_n, x.device)).reshape(x.shape)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, dtype=np.uint32)).hexdigest()


def _recorded(name: str) -> dict:
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def _recorded_input(seed: int, log_n: int, sha256: str) -> torch.Tensor:
    """The input of a recorded case, made as make_torch_fixtures.fused_input
    makes it (its digest guards against a change in numpy's stream)."""
    x = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(16, 1 << log_n), dtype=np.uint32)
    x[15] &= 0x7FF
    assert _sha256(x) == sha256
    return limbs_from_numpy(x, "cpu")


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_plain_ntts_match_fused_pallas(direction):
    """Against fused.ntt_fused(interpret=True) at 2^12.  Compiling that
    kernel in interpret mode takes minutes on a CPU, more than a fast test
    may run, so tools/make_torch_fixtures.py recorded its outputs' digests."""
    rec = _recorded("fused_ntt_4096.json")
    case = rec[direction]
    xt = _recorded_input(case["seed"], rec["log_n"], case["input_sha256"])
    inverse = direction == "inverse"
    assert _sha256(limbs_to_numpy(cn.ntt_plain(xt, inverse))) == case["output_sha256"]
    assert _sha256(limbs_to_numpy(_dif_schedule(xt, inverse))) == case["output_sha256"]


def test_plain_butterfly_stages_match_pallas():
    """The plain DIT stage against pallas_mul.butterfly, as core._ntt_impl
    applies it, and the stage twiddles against the JAX package's."""
    log_n, n = 6, 64
    x = rand_limbs(50, (1, n))
    jtw = jnttc._stage_twiddles(log_n, False)
    tw = cn.twiddle_table(log_n, False, "cpu")
    xt = limbs_from_numpy(x, "cpu")
    for s in range(log_n):
        m = 1 << s
        assert np.array_equal(limbs_to_numpy(tw[:, m:2 * m]), np.asarray(jtw[s]))
    for s in (0, 3):
        m = 1 << s
        xv = jnp.asarray(x).reshape(16, 1, n // (2 * m), 2, m)
        hi, lo = pm.butterfly(xv[:, :, :, 0, :], xv[:, :, :, 1, :],
                              jtw[s][:, None, None, :], interpret=True)
        want = np.asarray(jnp.stack([hi, lo], axis=3).reshape(16, 1, n))
        got = limbs_to_numpy(cn.dit_stage_plain(xt, tw, s))
        assert np.array_equal(got, want)


def test_plain_stage_pair_matches_pallas_butterfly2():
    """Two plain DIT stages against pallas_mul.butterfly2 (radix-4), whose
    interpret-mode compile also takes minutes on a CPU: against the digest
    that tools/make_torch_fixtures.py recorded."""
    rec = _recorded("butterfly2_64.json")
    log_n, s = rec["log_n"], rec["stage"]
    tw = cn.twiddle_table(log_n, False, "cpu")
    xt = _recorded_input(rec["seed"], log_n, rec["input_sha256"]).reshape(
        16, 1, 1 << log_n)
    got = cn.dit_stage_plain(cn.dit_stage_plain(xt, tw, s), tw, s + 1)
    assert _sha256(limbs_to_numpy(got)) == rec["output_sha256"]


def test_poly_helpers_match_jax():
    x = rand_limbs(60, (3, 32))
    _both(x, lambda c: tnttc.sum_reduce(c, axis=1),
          lambda c: jnttc.sum_reduce(c, axis=1))
    _both(x, lambda c: tnttc.poly_eval_at(c, 12345),
          lambda c: jnttc.poly_eval_at(c, 12345))
    _both(x, lambda c: tnttc.scale_poly(c, 7), lambda c: jnttc.scale_poly(c, 7))
    assert np.array_equal(limbs_to_numpy(tnttc.offset_powers(3, 100, "cpu")),
                          np.asarray(jnttc.offset_powers(3, 100)))
