"""Keccak digests, Merkle trees and grinding of the PyTorch port against the
JAX package.

The same limbs, made from a seed with numpy, are hashed by both packages
(the port on the CPU).  The JAX package keeps a digest as (8,) uint32 words
and the port as (4,) int64 lanes; both are compared as their 32 bytes, which
must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambdaworks_cairo_prover_tpu.hash import keccak_device as jkd
from lambdaworks_cairo_prover_tpu.hash import merkle as jmerkle
from lambdaworks_cairo_prover_tpu.prover import grinding as jgrinding
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.field.host import randomness_to_field
from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as tkd
from lambdaworks_cairo_prover_tpu_torch.hash import merkle as tmerkle
from lambdaworks_cairo_prover_tpu_torch.interop import limbs_from_numpy
from lambdaworks_cairo_prover_tpu_torch.prover import grinding as tgrinding

from test_torch_field import rand_limbs

torch.set_num_threads(1)


def jax_bytes(digests) -> bytes:
    return np.asarray(digests, dtype="<u4").tobytes()


def port_bytes(digests: torch.Tensor) -> bytes:
    return digests.numpy().astype("<i8").tobytes()


def test_leaf_row_and_pair_digests_match_jax():
    # 5 felts = 160 bytes: a row message spans two Keccak blocks
    rows = rand_limbs(70, (37, 5))
    assert port_bytes(tkd.hash_felt_rows(limbs_from_numpy(rows, "cpu"), 5)) == \
        jax_bytes(jkd.hash_felt_rows(jnp.asarray(rows), 5))
    leaves = rand_limbs(71, (38,))
    t_leaves = tkd.hash_felt_leaves(limbs_from_numpy(leaves, "cpu"))
    j_leaves = jkd.hash_felt_leaves(jnp.asarray(leaves))
    assert port_bytes(t_leaves) == jax_bytes(j_leaves)
    assert port_bytes(tkd.hash_digest_pairs(t_leaves)) == \
        jax_bytes(jkd.hash_digest_pairs(j_leaves))
    for i in (0, 7, 37):
        masked = tkd.digest_words_to_masked_limbs(t_leaves[i])
        assert np.array_equal(masked.numpy().astype(np.uint32),
                              np.asarray(jkd.digest_words_to_masked_limbs(
                                  j_leaves[i])))
        assert tfd.to_int(masked, mont=False) == randomness_to_field(
            tkd.digest_to_bytes(t_leaves[i]))


@pytest.mark.parametrize("kind", ["batch", "single"])
def test_merkle_roots_and_batched_proofs_match_jax(kind):
    n = 64
    if kind == "batch":
        # rows of 3 felts; the edge values land in the last rows
        limbs = np.ascontiguousarray(rand_limbs(72, (3, n)).transpose(0, 2, 1))
        t_tree = tmerkle.MerkleTree.build_batch(limbs_from_numpy(limbs, "cpu"), 3)
        j_tree = jmerkle.MerkleTree.build_batch(jnp.asarray(limbs), 3)
        leaf_ints = [tfd.to_ints(limbs_from_numpy(limbs[:, i], "cpu"), mont=False)
                     for i in range(n)]
    else:
        limbs = rand_limbs(73, (n,))
        t_tree = tmerkle.MerkleTree.build_single(limbs_from_numpy(limbs, "cpu"))
        j_tree = jmerkle.MerkleTree.build_single(jnp.asarray(limbs))
        leaf_ints = [[v] for v in tfd.to_ints(limbs_from_numpy(limbs, "cpu"),
                                              mont=False)]
    assert t_tree.root == j_tree.root
    idxs = [0, 5, 63, 5, 32]
    paths = t_tree.get_proofs(idxs)
    assert paths == j_tree.get_proofs(idxs)
    for i, path in zip(idxs, paths):
        leaf = tmerkle.hash_leaf_felts_host(leaf_ints[i])
        assert tmerkle.verify_proof(t_tree.root, i, leaf, path)
        assert not tmerkle.verify_proof(t_tree.root, i ^ 1, leaf, path)


@pytest.mark.parametrize("start", [0, (1 << 32) - 1000])
def test_grinding_batch_matches_jax(start):
    """Batches of candidate nonces, one across the 2^32 carry of the JAX
    package's (lo, hi) u32 nonce words."""
    challenge = bytes(np.random.default_rng(74).integers(0, 256, 32,
                                                         dtype=np.uint8))
    words = jnp.asarray(np.frombuffer(challenge, dtype="<u4").copy())
    size = 4096
    for factor in (6, 9):
        j_found, j_first = jkd.grinding_batch(
            words, jnp.uint32(start & 0xFFFFFFFF), jnp.uint32(start >> 32),
            size, factor)
        t_found, t_first = tkd.grinding_batch(challenge, start, size, factor,
                                              "cpu")
        assert bool(t_found) == bool(j_found)
        if bool(t_found):
            assert int(t_first) == int(j_first)
            nonce = start + int(t_first)
            assert tgrinding.leading_zeros_of_nonce(challenge, nonce) >= factor


def test_nonce_search_matches_jax():
    """The pipelined batch search returns the smallest nonce, as the JAX
    package's does (factor 13 takes the batched path in both)."""
    challenge = bytes(range(32))
    factor = 13
    want = jgrinding.generate_nonce_with_grinding(challenge, factor,
                                                  batch=2048, pipeline=2)
    got = tgrinding.generate_nonce_with_grinding(challenge, factor, "cpu",
                                                 batch=2048, pipeline=2)
    assert got == want
    assert all(tgrinding.leading_zeros_of_nonce(challenge, k) < factor
               for k in range(got))
