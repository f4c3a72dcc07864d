"""Field arithmetic of the PyTorch port against the JAX package.

The same limbs, made from a seed with numpy, go through the JAX functions
(on the CPU; the Pallas kernels in interpret mode) and the port's CPU path
(the plain versions of the H1/H2 kernels).  Comparisons are exact: finite-
field values must be bit-equal (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambdaworks_cairo_prover_tpu.field import device as jfd
from lambdaworks_cairo_prover_tpu.field import pallas_mul as pm
from lambdaworks_cairo_prover_tpu.field.params import N_LIMBS, P
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                        limbs_to_numpy)

torch.set_num_threads(1)


def rand_limbs(seed: int, shape) -> np.ndarray:
    """(16, *shape) uint32 canonical elements (< 2^251); where the last axis
    has room, its last three replaced by 0, 1 and p - 1."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(N_LIMBS,) + tuple(shape),
                         dtype=np.uint32)
    limbs[N_LIMBS - 1] &= 0x7FF
    if shape[-1] < 3:
        return limbs
    limbs[..., -3:] = 0
    limbs[0, ..., -2] = 1
    for k in range(N_LIMBS):
        limbs[k, ..., -1] = ((P - 1) >> (16 * k)) & 0xFFFF
    return limbs


def port(op, *arrays):
    return limbs_to_numpy(op(*[limbs_from_numpy(a, "cpu") for a in arrays]))


def jax_np(op, *arrays, **kw):
    return np.asarray(op(*[jnp.asarray(a) for a in arrays], **kw))


@pytest.mark.parametrize("name", ["mul", "add", "sub"])
def test_binops_match_jax_and_pallas(name):
    n = 1021  # not a multiple of the Pallas kernels' 1024-element block
    a = rand_limbs(1, (n,))
    b = rand_limbs(2, (n,))[:, ::-1].copy()  # pair the edges with others
    got = port(getattr(tfd, name), a, b)
    assert np.array_equal(got, jax_np(getattr(jfd, name), a, b))
    assert np.array_equal(got, jax_np(getattr(pm, name), a, b, interpret=True))


@pytest.mark.parametrize("shapes", [
    ((4, 37), (1, 37)),
    ((4, 37), (4, 1)),
    ((4, 37), (1, 1)),
    ((1, 37), (3, 1)),
    ((2, 3, 5), (1, 3, 1)),
])
def test_broadcast_shapes_match_jax(shapes):
    sa, sb = shapes
    a = rand_limbs(3, sa)
    b = rand_limbs(4, sb)
    for name in ("mul", "add", "sub"):
        got = port(getattr(tfd, name), a, b)
        assert np.array_equal(got, jax_np(getattr(jfd, name), a, b)), name


def test_unary_ops_match_jax():
    a = rand_limbs(5, (40,))
    assert np.array_equal(port(tfd.neg, a), jax_np(jfd.neg, a))
    assert np.array_equal(port(tfd.to_mont, a), jax_np(jfd.to_mont, a))
    assert np.array_equal(port(tfd.from_mont, a), jax_np(jfd.from_mont, a))
    assert np.array_equal(port(tfd.inv, a[:, -8:]), jax_np(jfd.inv, a[:, -8:]))
    assert np.array_equal(port(lambda x: tfd.pow_u64(x, 1000003), a),
                          jax_np(lambda x: jfd.pow_u64(x, 1000003), a))


def test_batch_inverse_prefix_product_powers_match_jax():
    a = rand_limbs(6, (300,))
    a[:, 100] = 0  # a zero in the middle maps to zero
    assert np.array_equal(port(tfd.batch_inverse, a),
                          jax_np(jfd.batch_inverse, a))
    assert np.array_equal(port(tfd.prefix_product, a),
                          jax_np(jfd.prefix_product, a))
    for n in (1, 1000, 1500):
        assert np.array_equal(limbs_to_numpy(tfd.powers(7, n, device="cpu")),
                              np.asarray(jfd.powers(7, n)))


def test_int_conversions_match_jax():
    vals = [0, 1, P - 1, 12345, P // 3]
    for mont in (True, False):
        got = limbs_to_numpy(tfd.from_ints(vals, mont=mont, device="cpu"))
        assert np.array_equal(got, jfd.from_ints(vals, mont=mont))
        assert tfd.to_ints(limbs_from_numpy(got, "cpu"), mont=mont) == [
            v % P for v in vals]


def test_square_matches_jax():
    a = rand_limbs(7, (3, 101))
    assert np.array_equal(port(tfd.square, a), jax_np(jfd.square, a))


def test_pack_unpack_match_jax():
    a = rand_limbs(8, (5, 77))
    packed = tfd.pack(limbs_from_numpy(a, "cpu"))
    assert packed.shape == (N_LIMBS // 2, 5, 77)
    want = jax_np(jfd.pack, a)
    assert np.array_equal(packed.numpy().astype(np.uint32), want)
    unpacked = limbs_to_numpy(tfd.unpack(torch.from_numpy(want.astype(np.int64))))
    assert np.array_equal(unpacked, jax_np(jfd.unpack, want))
    assert np.array_equal(unpacked, a)

