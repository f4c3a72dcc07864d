"""The Keccak-256 kernels' plain versions (K1 ``hash_felt_rows_plain``, K2
``hash_digest_pairs_plain``, K3 ``grinding_batch_plain``) against the JAX
package, and the message layout that K1 forms in registers.

The same inputs, made from a seed with numpy, go through the JAX package's
jitted Keccak and the port's plain version on the CPU; digests are compared
as their 32 bytes (tolerance 0).  The kernels themselves run only on the
card, where ``chip_smoke.py`` holds them against these plain versions bit
for bit; here the launchers must refuse CPU tensors and the public
functions must take the plain route."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambdaworks_cairo_prover_tpu.hash import keccak_device as jkd
from lambdaworks_cairo_prover_tpu.hash.merkle import MerkleTree as JaxTree
from lambdaworks_cairo_prover_tpu_torch import cuda_lib
from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as tkd
from lambdaworks_cairo_prover_tpu_torch.hash.merkle import (MerkleTree,
                                                           tree_levels)
from lambdaworks_cairo_prover_tpu_torch.interop import limbs_from_numpy
from lambdaworks_cairo_prover_tpu_torch.prover.grinding import (
    leading_zeros_of_nonce)

from test_torch_field import rand_limbs

torch.set_num_threads(1)

ROWS = 7  # the JAX package pads fewer than 128 rows itself


def jax_bytes(digests) -> bytes:
    return np.asarray(digests, dtype="<u4").tobytes()


def port_bytes(digests: torch.Tensor) -> bytes:
    return digests.numpy().astype("<i8").tobytes()


def felt_lanes(limbs: torch.Tensor) -> torch.Tensor:
    """(16, ...) canonical limbs -> (..., 4) int64: the four Keccak lanes of
    each felt's 32-byte big-endian encoding, by K1's formula
    (csrc/keccak.cu:felt_lane): lane k holds limbs 15-4k .. 12-4k, each with
    its two bytes swapped, limb 15-4k in the low 16 bits."""
    x = limbs.to(torch.int64)
    swapped = ((x & 0xFF) << 8) | ((x >> 8) & 0xFF)
    lanes = []
    for k in range(4):
        top = 15 - 4 * k
        lane = swapped[top]
        for t in range(1, 4):
            lane = lane | (swapped[top - t] << (16 * t))  # the last shift wraps
        lanes.append(lane)
    return torch.stack(lanes, dim=-1)


def kernel_message(cols: torch.Tensor) -> torch.Tensor:
    """(16, c, n) limbs -> (n, 17 * blocks) int64: the padded message as K1
    absorbs it, block by block: lane i of block b is message lane 17b + i
    (felt (17b + i) // 4, its lane (17b + i) % 4), 0x01 in the lane after
    the message, the top bit of the last block's lane 16 set."""
    lanes = felt_lanes(cols)  # (c, n, 4)
    n_cols, n_rows = cols.shape[1], cols.shape[2]
    msg = lanes.permute(1, 0, 2).reshape(n_rows, 4 * n_cols)
    n_lanes = 4 * n_cols
    n_blocks = n_lanes // 17 + 1
    out = torch.zeros((n_rows, 17 * n_blocks), dtype=torch.int64)
    for blk in range(n_blocks):
        for i in range(17):
            m = 17 * blk + i
            v = msg[:, m] if m < n_lanes else torch.zeros(n_rows, dtype=torch.int64)
            if m == n_lanes:
                v = v ^ 0x01
            if i == 16 and blk == n_blocks - 1:
                v = v ^ tkd._signed(0x80 << 56)
            out[:, m] = v
    return out


@pytest.mark.parametrize("n_cols", [1, 2, 17, 18, 34, 61])
def test_row_leaves_match_jax(n_cols):
    """Rows of 17 and 34 felts end on a block (the padding fills a block of
    its own); 1, 2, 18 and 61 end inside one."""
    cols = limbs_from_numpy(rand_limbs(90 + n_cols, (n_cols, ROWS)), "cpu")
    rows = cols.permute(0, 2, 1)  # _row_leaves' view: (16, n_rows, n_cols)
    want = jax_bytes(jkd.hash_felt_rows(
        jnp.asarray(rows.contiguous().numpy().astype(np.uint32)), n_cols))
    plain = tkd.hash_felt_rows_plain(rows, n_cols)
    assert port_bytes(plain) == want
    assert torch.equal(tkd.hash_felt_rows(rows, n_cols), plain)
    assert torch.equal(tkd._absorb(kernel_message(cols)), plain)


def test_felt_lanes_are_the_big_endian_encoding():
    """K1's lane formula (limbs -> 4 lanes a felt) against the byte
    expansion of the plain version, on canonical felts with the edges and on
    limbs of every bit pattern at the byte boundaries."""
    rng = np.random.default_rng(95)
    canonical = rand_limbs(96, (5, 64))
    patterns = rng.choice(np.array([0, 1, 0x7F, 0x80, 0xFF, 0x100, 0x7FFF,
                                    0x8000, 0xFF00, 0xFFFF], dtype=np.uint32),
                          size=(16, 64))
    for arr in (canonical, patterns):
        limbs = limbs_from_numpy(arr, "cpu")
        assert torch.equal(felt_lanes(limbs),
                           tkd.felts_to_be_bytes(limbs).view(torch.int64))


@pytest.mark.parametrize("k", [1, 1024])
def test_parent_nodes_match_jax(k):
    rng = np.random.default_rng(97 + k)
    words = rng.integers(0, 1 << 32, size=(2 * k, 8), dtype=np.uint32)
    digests = torch.from_numpy(words.view("<i8").copy())
    got = tkd.hash_digest_pairs_plain(digests)
    assert port_bytes(got) == jax_bytes(jkd.hash_digest_pairs(jnp.asarray(words)))
    assert torch.equal(tkd.hash_digest_pairs(digests), got)


def mirror_tree(leaves: torch.Tensor, threads: int, step: int,
                group: int) -> tuple:
    """csrc/keccak.cu's K2 over a whole tree (cuda_keccak.keccak_tree) with
    blocks of ``threads`` threads, walked with the plain pair hash.  A task
    over chunk = 2 threads children at level lv0: thread t hashes children
    2t, 2t + 1 from the level's nodes, then nodes 2t, 2t + 1 of the block's
    shared memory, ``step`` levels (all the rest for the top task, over
    chunk or fewer children); level lv's node i goes to node n - (n >>
    (lv - 1)) + i.  Tasks c of a group of ``group`` (fewer if the round has
    fewer) make task c // group of the next round, counted at counter
    first + c // group.  Returns the (n - 1, 4) buffer, the rounds' tasks
    and the counters used."""
    n = leaves.shape[0]
    chunk = 2 * threads
    buf = torch.zeros((max(n - 1, 0), 4), dtype=torch.int64)

    def start(lv):
        return n - (n >> (lv - 1))

    rounds, counts = [], 0
    lv0, count = 0, n
    while count > 1:
        tasks = -(-count // chunk)
        top = count <= chunk
        rounds.append(tasks)
        src = leaves if lv0 == 0 else buf[start(lv0):start(lv0) + count]
        widths = [min(chunk, count - c * chunk) for c in range(tasks)]
        todo = widths[0].bit_length() - 1 if top else step
        # the blocks' shared memory, all tasks side by side: task c's nodes
        # of the level below at c * (chunk >> (lv - 1)) ..
        node = None
        for lv in range(1, todo + 1):
            left, dst = [], []
            for c, width in enumerate(widths):
                base = c * chunk
                for t in range(width >> lv):
                    left.append(base + 2 * t if lv == 1
                                else c * (chunk >> (lv - 1)) + 2 * t)
                    dst.append(start(lv0 + lv) + (base >> lv) + t)
            below = src if lv == 1 else node
            ix = torch.tensor(left)
            pairs = torch.stack([below[ix], below[ix + 1]], 1)
            parents = tkd.hash_digest_pairs_plain(pairs.reshape(-1, 4))
            buf[dst] = parents
            node = torch.zeros((tasks * (chunk >> lv), 4), dtype=torch.int64)
            node[[c * (chunk >> lv) + t for c, width in enumerate(widths)
                  for t in range(width >> lv)]] = parents
        if top:
            break
        counts += tasks // min(group, tasks)
        lv0, count = lv0 + step, count >> step
    return buf, rounds, counts


@pytest.mark.parametrize("log_n", range(11))
def test_tree_launches_match_jax(log_n):
    """The levels, root and authentication paths of a tree over 2^log_n
    seeded leaves: the port's tree_levels (the plain route) and K2's task
    schedule walked by mirror_tree, at the kernel's block and at blocks of
    2, 4 and 8 threads with other steps and groups (so that a few leaves
    already span several rounds), against the JAX package's MerkleTree."""
    n = 1 << log_n
    words = np.random.default_rng(300 + log_n).integers(
        0, 1 << 32, size=(n, 8), dtype=np.uint32)
    leaves = torch.from_numpy(words.view("<i8").copy())
    jtree = JaxTree._build_from_leaves(jnp.asarray(words))
    want = [jax_bytes(lv) for lv in jtree.levels[1:]]
    tree = MerkleTree(tree_levels(leaves))
    assert [port_bytes(lv) for lv in tree.levels[1:]] == want
    assert tree.root == jtree.root
    queries = sorted({0, n - 1, n // 3, (5 * n) // 7})
    # a single leaf has empty paths (the JAX package gathers no level then)
    assert tree.get_proofs(queries) == (
        jtree.get_proofs(queries) if n > 1 else [[]])
    for threads, step, group in ((ck.TREE_THREADS, ck.TREE_STEP,
                                  ck.TREE_GROUP), (2, 1, 2), (4, 2, 4),
                                 (8, 2, 4), (8, 3, 8)):
        buf, rounds, counts = mirror_tree(leaves, threads, step, group)
        assert port_bytes(buf) == b"".join(want)
        assert counts == ck.tree_counts(n, 2 * threads, step, group)
        # every round but the top has whole tasks, grouped exactly
        assert all(r % min(group, r) == 0 for r in rounds[:-1])


def test_tree_block_matches_the_source():
    """K2's block, task and group as csrc/keccak.cu bakes them, and the
    group counts at the proves' tree sizes (none up to 2^9 leaves: one
    task)."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "keccak.cu")) as f:
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", f.read()))
    assert int(consts["kTreeThreads"]) == ck.TREE_THREADS
    assert int(consts["kTreeLevels"]) == ck.TREE_LEVELS
    assert int(consts["kTreeStep"]) == ck.TREE_STEP
    assert int(consts["kTreeGroup"]) == ck.TREE_GROUP
    assert 2 * ck.TREE_THREADS == 1 << ck.TREE_LEVELS
    assert ck.TREE_GROUP * (ck.TREE_THREADS * 2 >> ck.TREE_STEP) == \
        2 * ck.TREE_THREADS
    sizes = (1, 2, 4, 1 << 9, 1 << 10, 1 << 11, 1 << 13) + tuple(
        1 << k for k in range(21, 27))
    counts = {n: ck.tree_counts(n) for n in sizes}
    # 2^21: rounds over 2^21, 2^19, ..., 2^11 children: 1024 + ... + 1;
    # 2^22: over 2^22, ..., 2^12 (8 tasks: 2 groups) and 2^10 (2 tasks: 1);
    # the trees of simple_fibonacci at 2^20 .. 2^24 rows (LDE 2^22 .. 2^26)
    assert counts == {1: 0, 2: 0, 4: 0, 1 << 9: 0, 1 << 10: 1, 1 << 11: 1,
                      1 << 13: 4 + 1, 1 << 21: 1365,
                      1 << 22: 2048 + 512 + 128 + 32 + 8 + 2 + 1,
                      1 << 23: 4096 + 1024 + 256 + 64 + 16 + 4 + 1,
                      1 << 24: 8192 + 2048 + 512 + 128 + 32 + 8 + 2 + 1,
                      1 << 25: 16384 + 4096 + 1024 + 256 + 64 + 16 + 4 + 1,
                      1 << 26: 32768 + 8192 + 2048 + 512 + 128 + 32 + 8 + 2
                      + 1}


def test_tree_levels_are_views_of_one_buffer():
    """tree_levels: [leaves, level 1, ..., root], the levels above the
    leaves at offsets 0, n/2, n/2 + n/4, ... of one (n - 1, 4) tensor."""
    n = 64
    leaves = torch.from_numpy(np.random.default_rng(310).integers(
        -2**62, 2**62, size=(n, 4), dtype=np.int64))
    levels = tree_levels(leaves)
    assert levels[0] is leaves
    assert [lv.shape[0] for lv in levels] == [64, 32, 16, 8, 4, 2, 1]
    storage = levels[1].untyped_storage().data_ptr()
    off = 0
    for lv in levels[1:]:
        assert lv.untyped_storage().data_ptr() == storage
        assert lv.storage_offset() == 4 * off and lv.is_contiguous()
        off += lv.shape[0]
    assert levels[1].untyped_storage().nbytes() == (n - 1) * 32
    assert tkd.tree_level_sizes(n) == [32, 16, 8, 4, 2, 1]
    one = tree_levels(leaves[:1])
    assert len(one) == 1 and one[0] is not None and one[0].shape == (1, 4)


@pytest.mark.parametrize("factor, start", [(30, 5), (8, 1 << 40)])
def test_grinding_batch_matches_jax(factor, start):
    """A batch with no hit (factor 30 over 4,096 nonces) and one whose first
    hit lies inside it, past index 0; the hit agrees with the host check."""
    challenge = bytes(np.random.default_rng(99).integers(0, 256, 32,
                                                         dtype=np.uint8))
    size = 4096
    j_found, j_first = jkd.grinding_batch(
        jnp.asarray(np.frombuffer(challenge, dtype="<u4").copy()),
        jnp.uint32(start & 0xFFFFFFFF), jnp.uint32(start >> 32), size, factor)
    found, first = tkd.grinding_batch_plain(challenge, start, size, factor,
                                            "cpu")
    assert bool(found) == bool(j_found)
    assert [int(t) for t in tkd.grinding_batch(challenge, start, size, factor,
                                               "cpu")] == [int(found), int(first)]
    if factor == 30:
        assert not bool(found) and int(first) == size
        return
    assert bool(found) and int(first) == int(j_first) > 0
    assert leading_zeros_of_nonce(challenge, start + int(first)) >= factor
    assert all(leading_zeros_of_nonce(challenge, start + i) < factor
               for i in range(int(first)))


def test_lane0_mask_is_the_trailing_zero_test():
    """The mask that K3 and its plain version test digest lane 0 with:
    lane 0 & mask == 0 exactly when the BE-read head of the digest has
    ``factor`` trailing zeros."""
    rng = np.random.default_rng(100)
    for factor in (0, 1, 7, 8, 9, 20, 64):
        mask = ck.lane0_mask(factor)
        for lane in [0, (1 << 64) - 1, *rng.integers(0, 1 << 63, 200,
                                                      dtype=np.int64).tolist()]:
            head = int.from_bytes(lane.to_bytes(8, "little"), "big")
            zeros = 64 if head == 0 else (head & -head).bit_length() - 1
            assert ((lane & mask) == 0) == (zeros >= factor)


def test_every_signature_has_an_extern_c_definition():
    """Each entry point that cuda_lib binds is defined with C linkage in
    csrc/, with as many parameters as its ctypes signature."""
    defined = {}
    for name in cuda_lib.SOURCES:
        with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
            text = f.read()
        start = text.index('extern "C" {')
        for m in re.finditer(r"^int (lcp_\w+)\(([^)]*)\)", text[start:], re.M):
            defined[m.group(1)] = len(m.group(2).split(","))
    assert set(cuda_lib._SIGNATURES) <= set(defined)
    for name, argtypes in cuda_lib._SIGNATURES.items():
        assert defined[name] == len(argtypes), name
    assert "keccak.cu" in cuda_lib.SOURCES


def test_public_keccak_takes_the_plain_path_on_cpu_and_the_kernel_elsewhere():
    counts = (ck.keccak_rows.launches, ck.keccak_pairs.launches,
              ck.keccak_grind.launches)
    limbs = limbs_from_numpy(rand_limbs(101, (9,)), "cpu")
    leaves = tkd.hash_felt_leaves(limbs)
    assert torch.equal(leaves, tkd.hash_felt_rows_plain(limbs[:, :, None], 1))
    tkd.hash_digest_pairs(leaves[:8])
    tkd.grinding_batch(b"\x05" * 32, 0, 64, 3, torch.device("cpu"))
    assert counts == (ck.keccak_rows.launches, ck.keccak_pairs.launches,
                      ck.keccak_grind.launches)
    assert "lib" not in cuda_lib._state
    # any other device goes to the kernels, which take CUDA only
    meta = torch.empty((16, 4, 2), dtype=torch.int32, device="meta")
    for call in (lambda: tkd.hash_felt_rows(meta, 2),
                 lambda: tkd.hash_digest_pairs(meta[0, :, :].long().reshape(2, 4)),
                 lambda: tkd.hash_tree(meta[0, :, :].long().reshape(2, 4)),
                 lambda: tkd.grinding_batch(b"\x05" * 32, 0, 64, 3, "meta")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert "lib" not in cuda_lib._state
