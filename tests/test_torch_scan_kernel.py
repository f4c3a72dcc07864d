"""The scan kernels' plain versions (H5 ``batch_inverse_plain``, H6
``prefix_product_plain``) against the JAX package and Python ints, and the
kernels' schedules walked on the CPU.

The same inputs, made from a seed with numpy, go through the JAX package's
``batch_inverse`` / ``prefix_product`` and the port's plain versions;
elements are compared exactly (tolerance 0).  The kernels themselves
(csrc/scan.cu) run only on the card, where ``chip_smoke.py`` ``[scan]``
holds them against these plain versions bit for bit.  Here
``mirror_batch_inverse`` and ``mirror_prefix_product`` walk the kernels'
index arithmetic (H5's tiles, runs, warp scans and the backward walk, its
totals' blocks, product tree and two-chain root inverse; H6's tiles, runs
and warps and its look-back over the tiles' status in seeded completion
orders with small windows; the ragged edge) with the plain product, and
must give the Python ints' (and the JAX package's) answers; the
launchers must refuse what they do not take, and CPU tensors must never
reach them."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu.field import device as jfd
from lambdaworks_cairo_prover_tpu_torch import cuda_lib
from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.field.cuda_field import mul_plain
from lambdaworks_cairo_prover_tpu_torch.field.params import P, R
from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                        limbs_to_numpy)

from test_torch_field import rand_limbs

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCAN_CU = os.path.join(cuda_lib.CSRC_DIR, "scan.cu")


def seeded(seed: int, n: int, zeros=()) -> torch.Tensor:
    """(16, n) canonical elements from a seed, zero at ``zeros``."""
    a = rand_limbs(seed, (n,))
    for e in zeros:
        if e < n:
            a[:, e] = 0
    return limbs_from_numpy(a, "cpu")


def inverse_ints(x: torch.Tensor) -> list:
    """Each element's inverse (0 for 0) by the Montgomery trick on Python
    ints: running products, one pow, and back."""
    vals = tfd.to_ints(x)
    pre, acc = [], 1
    for v in vals:
        pre.append(acc)
        acc = acc * v % P if v else acc
    inv = pow(acc, P - 2, P)
    out = [0] * len(vals)
    for e in range(len(vals) - 1, -1, -1):
        if vals[e]:
            out[e] = inv * pre[e] % P
            inv = inv * vals[e] % P
    return out


def prefix_ints(x: torch.Tensor) -> list:
    out, acc = [], 1
    for v in tfd.to_ints(x):
        acc = acc * v % P
        out.append(acc)
    return out


def _ones(*shape) -> torch.Tensor:
    return cs._ones(1, "cpu").reshape((16,) + (1,) * len(shape)).expand(
        (16,) + shape).clone()


# ---------------------------------------------------------------------------
# The kernels' schedules on the CPU
# ---------------------------------------------------------------------------


def _warp_scan(a: torch.Tensor) -> torch.Tensor:
    """Inclusive product scan over the last axis (32 lanes), by
    __shfl_up_sync steps of 1, 2, 4, 8, 16."""
    for off in (1, 2, 4, 8, 16):
        nxt = a.clone()
        nxt[..., off:] = mul_plain(a[..., :-off], a[..., off:])
        a = nxt
    return a


def _scan_steps(a: torch.Tensor, width: int, reverse: bool) -> torch.Tensor:
    """Inclusive product scan over the first ``width`` lanes of the last axis
    (32 lanes) by shuffle steps 1, 2, 4, ... < width: __shfl_up_sync from
    the lanes below, or with ``reverse`` __shfl_down_sync from the lanes
    above; the lanes past ``width`` keep their values."""
    off = 1
    while off < width:
        nxt = a.clone()
        if reverse:
            nxt[..., :width - off] = mul_plain(a[..., :width - off],
                                               a[..., off:width])
        else:
            nxt[..., off:] = mul_plain(a[..., :-off], a[..., off:])
        a = nxt
        off *= 2
    return a


def _lane_after(a: torch.Tensor, width: int = 32) -> torch.Tensor:
    """The lane after's value, one from lane width - 1 on."""
    ex = _ones(*a.shape[1:])
    ex[..., :width - 1] = a[..., 1:width]
    return ex


def mirror_inv_totals(tot: torch.Tensor, q: int, mid: int) -> torch.Tensor:
    """csrc/scan.cu's inv_totals: the inverses of the k totals (16, k), by
    blocks of ``mid`` threads, q totals a thread, a product tree a block and
    the root's inverse by its two chains (cs.root_inverse)."""
    k = tot.shape[1]
    tot, pre = tot.clone(), torch.zeros_like(tot)
    # block b, thread i takes the totals b mid q + i + t mid (t < q); the
    # blocks side by side on axis 1
    blocks = -(-k // (mid * q))
    e0 = (torch.arange(blocks)[:, None] * mid * q + torch.arange(mid)).reshape(-1)
    cnt_i = torch.where(e0 < k, torch.clamp((k - 1 - e0) // mid + 1, max=q),
                        torch.zeros_like(e0))
    acc = _ones(blocks * mid)
    lanes = torch.arange(blocks * mid)
    for t in range(q):
        live = lanes[cnt_i > t]
        e = e0[live] + t * mid
        acc[:, live] = mul_plain(acc[:, live], tot[:, e])
        pre[:, e] = acc[:, live]
    node = _ones(blocks, 2 * mid)  # the trees: leaf mid + i, root 1
    node[:, :, mid:] = acc.reshape(16, blocks, mid)
    half = mid // 2
    while half >= 1:
        m = torch.arange(half, 2 * half)
        node[:, :, m] = mul_plain(node[:, :, 2 * m], node[:, :, 2 * m + 1])
        half //= 2
    node[:, :, 1] = cs.root_inverse(node[:, :, 1], mul_plain)
    half = 1
    while half < mid:
        m = torch.arange(half, 2 * half)
        v, left, right = node[:, :, m], node[:, :, 2 * m], node[:, :, 2 * m + 1]
        node[:, :, 2 * m] = mul_plain(v, right)
        node[:, :, 2 * m + 1] = mul_plain(v, left)
        half *= 2
    acc = node[:, :, mid:].reshape(16, blocks * mid)
    for t in range(q - 1, -1, -1):
        live = lanes[cnt_i > t]
        e = e0[live] + t * mid
        if t == 0:
            tot[:, e] = acc[:, live]
            continue
        r = mul_plain(acc[:, live], pre[:, e - mid])
        acc[:, live] = mul_plain(acc[:, live], tot[:, e])
        tot[:, e] = r
    return tot


def mirror_batch_inverse(x: torch.Tensor, threads: int = cs.INV_THREADS,
                         q: int = 1, mid: int = cs.MID_THREADS,
                         run: int = cs.RUN) -> torch.Tensor:
    """csrc/scan.cu's H5 (inv_reduce, inv_totals, inv_apply) with tiles of
    threads * run contiguous elements, thread t of a tile taking elements
    t * run .. t * run + run - 1; q totals a thread and ``mid`` threads a
    totals block.  Tiles are axis 1, threads axis 2, lanes of a warp the
    last axis."""
    n = x.shape[1]
    tile, warps = threads * run, threads // 32
    zero = (x == 0).all(dim=0)
    xs = torch.where(zero, _ones(n), x)
    v = _tiles(xs, tile).reshape(16, -1, threads, run)  # past n: one
    k = v.shape[1]
    # inv_reduce: a thread's run, the xor butterfly within warps, then
    # thread 0 over the warps
    acc = v[..., 0]
    for r in range(1, run):
        acc = mul_plain(acc, v[..., r])
    acc = acc.reshape(16, k, warps, 32)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = mul_plain(acc, acc[..., lane ^ off])
    tot = acc[:, :, 0, 0]
    for u in range(1, warps):
        tot = mul_plain(tot, acc[:, :, u, 0])
    tinv = mirror_inv_totals(tot, q, mid)
    # inv_apply: the run's prefix products and total u
    p = [v[..., 0]]
    for r in range(1, run):
        p.append(mul_plain(p[-1], v[..., r]))
    u = p[-1].reshape(16, k, warps, 32)
    pre, suf = _scan_steps(u, 32, False), _scan_steps(u, 32, True)
    lanes_ex = mul_plain(_lane_before(pre), _lane_after(suf))
    # warp 0: tinv times the warps before and after each warp
    a = _ones(k, 32)
    a[:, :, :warps] = pre[..., 31]
    before = _lane_before(_scan_steps(a, warps, False))
    after = _lane_after(_scan_steps(a, warps, True), warps)
    wq = mul_plain(mul_plain(before, after), tinv[:, :, None])[:, :, :warps]
    c = mul_plain(lanes_ex, wq[..., None]).reshape(16, k, threads)
    out = [None] * run
    for r in range(run - 1, 0, -1):
        out[r] = mul_plain(c, p[r - 1])
        c = mul_plain(c, v[..., r])
    out[0] = c
    res = torch.stack(out, dim=3).reshape(16, -1)[:, :n]
    return torch.where(zero, torch.zeros_like(res), res)


def _lane_before(a: torch.Tensor) -> torch.Tensor:
    ex = torch.empty_like(a)
    ex[..., 1:] = a[..., :-1]
    ex[..., :1] = _ones(*a.shape[1:-1], 1)
    return ex


def _tiles(src: torch.Tensor, tile: int) -> torch.Tensor:
    """(16, n) -> (16, ceil(n / tile), tile), padded with one."""
    n = src.shape[1]
    nb = -(-n // tile)
    pad = nb * tile - n
    if pad:
        src = torch.cat([src, _ones(pad)], dim=1)
    return src.reshape(16, nb, tile)


NONE, AGGREGATE, INCLUSIVE = 0, 1, 2  # a tile's flag (kNone, ...)


def _completion_order(nb: int, order) -> list:
    """The tiles in the order they publish and look back: index order
    (None), "reverse", or a permutation seeded by ``order``."""
    if order is None:
        return list(range(nb))
    if order == "reverse":
        return list(range(nb - 1, -1, -1))
    return np.random.default_rng(order).permutation(nb).tolist()


def _look_back(agg: torch.Tensor, window: int, order,
               per_round: int = 8) -> torch.Tensor:
    """csrc/scan.cu's look_back over the tiles' aggregates (16, nb): each
    tile's exclusive prefix (16, nb).  Tiles start ``per_round`` at a time in
    the completion order and publish their aggregate (tile 0 its inclusive
    prefix); then every started tile walks back from where it stopped,
    ``window`` lanes at a time (lane i at tile b - i), against the flags as
    the round began, and stops at a window with a tile still unpublished
    until a later round.  In a window with none, lanes 0 .. last (the
    nearest inclusive prefix, or all of them) multiply their payloads into
    their own running products; the walk ends at an inclusive prefix, and
    then xor steps 1, 2, 4, ... <= top (the highest lane that took a
    payload) multiply the lanes' products into lane 0's.  The tiles that
    ended publish their inclusive prefix when the round ends.  The walks of
    a round are batched on axis 1."""
    nb = agg.shape[1]
    assert window & (window - 1) == 0 and window <= 32
    flags = np.full(nb, NONE)
    slot = {AGGREGATE: _ones(nb), INCLUSIVE: _ones(nb)}  # read behind a flag
    pre, acc = _ones(nb), _ones(nb, window)  # acc: each lane's product
    b = np.arange(nb) - 1  # each tile's next window: its nearest tile
    top = np.zeros(nb, dtype=int)
    lane = np.arange(window)
    seq, active = _completion_order(nb, order), np.zeros(0, dtype=int)
    for start in range(0, nb, per_round):
        for t in seq[start:start + per_round]:
            kind = INCLUSIVE if t == 0 else AGGREGATE
            flags[t], slot[kind][:, t] = kind, agg[:, t]
        started = [t for t in seq[start:start + per_round] if t]
        active = np.concatenate([active, np.array(started, dtype=int)])
        snap, walking, ended = flags.copy(), active, []
        while len(walking):
            js = b[walking][:, None] - lane
            fs = np.where(js >= 0, snap[np.maximum(js, 0)], INCLUSIVE)
            ready = (fs != NONE).all(axis=1)
            walking, js, fs = walking[ready], js[ready], fs[ready]
            if not len(walking):
                break
            incl = (fs == INCLUSIVE).any(axis=1)
            last = np.where(incl, (fs == INCLUSIVE).argmax(axis=1), window - 1)
            jj = torch.from_numpy(np.maximum(js, 0))
            vals = torch.where(torch.from_numpy(fs == INCLUSIVE),
                               slot[INCLUSIVE][:, jj], slot[AGGREGATE][:, jj])
            use = torch.from_numpy((lane <= last[:, None]) & (js >= 0))
            w = torch.from_numpy(walking)
            acc[:, w] = torch.where(use, mul_plain(acc[:, w], vals), acc[:, w])
            top[walking] = np.maximum(top[walking], last)
            ended += walking[incl].tolist()
            b[walking[~incl]] -= window
            walking = walking[~incl]
        if ended:
            e = torch.tensor(ended)
            lanes, off = acc[:, e], 1
            while off <= top[ended].max():
                step = torch.from_numpy(off <= top[ended])[:, None]
                lanes = torch.where(step, mul_plain(lanes, lanes[..., lane ^ off]),
                                    lanes)
                off *= 2
            pre[:, e] = lanes[..., 0]
            slot[INCLUSIVE][:, e] = mul_plain(pre[:, e], agg[:, e])
            flags[ended] = INCLUSIVE
        assert start + per_round < nb or ended or not len(active), \
            "no tile finished its look-back"
        active = np.setdiff1d(active, ended)
    assert not len(active)
    return pre


def mirror_prefix_product(x: torch.Tensor, threads: int = cs.TILE_THREADS,
                          per: int = cs.PER_THREAD, window: int = 32,
                          order=None) -> torch.Tensor:
    """csrc/scan.cu's H6 (prefix_product_kernel) with tiles of threads * per
    elements, thread t of a tile taking elements t * per .. t * per + per -
    1: the runs' inclusive products (the running product times each next
    element), a warp scan of their totals, warp 0's
    scan of the warps' totals (the tile's aggregate), the look-back in the
    given completion order with a window of ``window`` lanes, then each
    element times (the tile's prefix times its warp's) times its lane's.
    Tiles are axis 1, threads axis 2, lanes of a warp the last axis."""
    n = x.shape[1]
    warps = threads // 32
    v = _tiles(x, threads * per).reshape(16, -1, threads, per)  # past n: one
    nb = v.shape[1]
    p = [v[..., 0]]
    for r in range(1, per):
        p.append(mul_plain(p[-1], v[..., r]))
    acc = _warp_scan(p[-1].reshape(16, nb, warps, 32))
    s = _ones(nb, 32)
    s[:, :, :warps] = acc[..., 31]
    s = _scan_steps(s, warps, False)
    o = _lane_before(s)
    if nb > 1:
        o = mul_plain(_look_back(s[:, :, warps - 1], window, order)[:, :, None],
                      o)
    off = mul_plain(o[:, :, :warps, None], _lane_before(acc))
    out = mul_plain(off.reshape(16, nb, threads)[..., None],
                    torch.stack(p, dim=3))
    return out.reshape(16, -1)[:, :n]


# ---------------------------------------------------------------------------
# Plain versions against the JAX package and Python ints
# ---------------------------------------------------------------------------

_jax_inverse = jax.jit(jfd.batch_inverse)
_jax_prefix = jax.jit(jfd.prefix_product)


@pytest.mark.parametrize("n, zeros", [
    (1, ()), (2, (1,)), (255, (0, 254)), (257, (0, 255, 256)),
    (257, tuple(range(257)))])
def test_plain_versions_match_jax(n, zeros):
    """Zeros at a chunk's first and last place (JAX's chunks of 256), all
    zeros, n = 1 and 2."""
    x = seeded(n, n, zeros)
    a = limbs_to_numpy(x)
    assert np.array_equal(limbs_to_numpy(cs.batch_inverse_plain(x)),
                          np.asarray(_jax_inverse(jnp.asarray(a))))
    assert np.array_equal(limbs_to_numpy(cs.prefix_product_plain(x)),
                          np.asarray(_jax_prefix(jnp.asarray(a))))


@pytest.mark.parametrize("n", [1023, (1 << 14) + 5])
def test_plain_versions_match_python_ints(n):
    x = seeded(n, n, (0, 1, 300, n - 1))
    assert tfd.to_ints(cs.batch_inverse_plain(x)) == inverse_ints(x)
    assert tfd.to_ints(cs.prefix_product_plain(x)) == prefix_ints(x)


# ---------------------------------------------------------------------------
# The kernels' schedules
# ---------------------------------------------------------------------------


def h5_edges(n: int, threads: int) -> tuple:
    """Zeros at the edges of H5's first runs and tiles and at the end."""
    tile = threads * cs.RUN
    return (0, cs.RUN - 1, cs.RUN, tile - 1, tile, 2 * tile - 1, n // 2,
            n - 1)


@pytest.mark.parametrize("n, threads, q", [
    (1, cs.INV_THREADS, 1), (2, cs.INV_THREADS, 1), (3, cs.INV_THREADS, 1),
    (1000, cs.INV_THREADS, 1),   # two tiles, the second ragged
    (1024, cs.INV_THREADS, 1),   # two whole tiles, n % 4 == 0
    (4099, 32, 1),               # tiles of 128 (one warp): 33 tiles
    (4101, 64, 3),               # q = 3: 768 totals a totals block
    ((1 << 14) + 5, cs.INV_THREADS, 3)])
def test_h5_schedule_matches_python_ints(n, threads, q):
    x = seeded(n + threads, n, h5_edges(n, threads))
    assert tfd.to_ints(mirror_batch_inverse(x, threads, q)) == inverse_ints(x)


def test_h5_schedule_with_small_totals_blocks():
    """A totals block of 32 threads (5 tree levels) over 100 tile totals, 2
    a thread: two blocks, the second ragged."""
    x = seeded(7, 12_800 - 3, h5_edges(12_800 - 3, 32))
    assert tfd.to_ints(mirror_batch_inverse(x, 32, 2, mid=32)) == \
        inverse_ints(x)


@pytest.mark.parametrize("n, zeros", [
    (255, "edges"), (257, "edges"), (257, "all")])
def test_h5_schedule_matches_jax(n, zeros):
    """Tiles of 128 (ragged) with zeros at run and tile edges, and all
    zeros, against the JAX package's batch_inverse."""
    x = seeded(n + 11, n, range(n) if zeros == "all" else h5_edges(n, 32))
    want = np.asarray(_jax_inverse(jnp.asarray(limbs_to_numpy(x))))
    assert np.array_equal(limbs_to_numpy(mirror_batch_inverse(x, 32)), want)


def test_root_inverse_is_fermat():
    """H5's root chain (inv_low, inv_high) is a^(p - 2): on Python ints
    and on limbs with the plain product, against pow and ``fermat``."""
    rng = np.random.default_rng(12)
    vals = [1, 2, 3, P - 1, R % P, *(int(v) % P for v in
                                     rng.integers(1, 1 << 62, 4))]
    mul = lambda a, b: a * b % P  # noqa: E731
    assert [cs.root_inverse(v, mul) for v in vals] == \
        [pow(v, P - 2, P) for v in vals]
    x = seeded(13, 6)
    assert torch.equal(cs.root_inverse(x, mul_plain), cs.fermat(x, mul_plain))


@pytest.mark.parametrize("n, threads, per", [
    (1, cs.TILE_THREADS, cs.PER_THREAD),
    (cs.TILE, cs.TILE_THREADS, cs.PER_THREAD),
    (cs.TILE + 1, cs.TILE_THREADS, cs.PER_THREAD),
    (5 * cs.TILE - 3, cs.TILE_THREADS, cs.PER_THREAD),
    # tiles of 128: 131 tiles, so the look-back walks windows of 32
    (128 * 130 + 7, 64, 2)])
def test_h6_schedule_matches_python_ints(n, threads, per):
    x = seeded(n + threads, n)
    assert tfd.to_ints(mirror_prefix_product(x, threads, per)) == \
        prefix_ints(x)


def h6_zero_tiles(n: int, tile: int) -> tuple:
    """A run of all-zero tiles (100 .. 104) late in the input, and zeros on
    the edges of the tiles before and after it."""
    return (100 * tile - 1, *range(100 * tile, 105 * tile), 105 * tile,
            105 * tile + 1, n - 1)


@pytest.mark.parametrize("n, threads, per, window, order, zeros", [
    # tiles of 128 over 131 to 134 tiles; completion orders in which every
    # tile sees only aggregates back to tile 0 (reverse) or a mix
    (128 * 130 + 7, 32, 4, 32, "reverse", False),
    (128 * 130 + 7, 32, 4, 32, 1, False),
    (128 * 131, 64, 2, 32, 2, False),
    (128 * 131 + 100, 32, 4, 1, 3, False),
    (128 * 133 + 1, 32, 4, 4, "reverse", False),
    (128 * 130 + 7, 32, 4, 4, 4, False),
    (128 * 134 + 5, 32, 4, 4, 5, True)])
def test_h6_look_back_matches_python_ints(n, threads, per, window, order,
                                          zeros):
    x = seeded(n + window, n, h6_zero_tiles(n, threads * per) if zeros
               else ())
    got = mirror_prefix_product(x, threads, per, window, order)
    assert tfd.to_ints(got) == prefix_ints(x)


def test_h6_look_back_matches_jax():
    """A ragged n over tiles of 64 (5 tiles) in a seeded completion order
    with windows of 4, against the JAX package's prefix_product."""
    x = seeded(41, 257)
    want = np.asarray(_jax_prefix(jnp.asarray(limbs_to_numpy(x))))
    got = mirror_prefix_product(x, 32, 2, window=4, order=6)
    assert np.array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize("n", [1, 2, 1000, 1 << 16, (1 << 16) + 1,
                               3 << 19, 1 << 21, 3 << 21, 1 << 23, 3 << 23])
def test_plans_cover_every_element(n):
    """At the proves' shapes too (the RAP's 2^21 and 3 * 2^19, DEEP's
    3 * 2^21, fib(280000)'s 2^23 and 3 * 2^23): the tiles cover the
    elements, every totals block has a total, and the blocks cover the
    totals."""
    k, q, blocks = cs.inverse_plan(n)
    assert (k - 1) * cs.INV_TILE < n <= k * cs.INV_TILE and q >= 1
    assert (blocks - 1) * cs.MID_THREADS * q < k <= blocks * cs.MID_THREADS * q
    assert blocks <= cs.MID_BLOCKS
    nb, words = cs.prefix_plan(n)
    assert (nb - 1) * cs.TILE < n <= nb * cs.TILE
    # a single tile takes no status; else the head, the flags padded to 8
    # words, and a slot a tile, 64 B aligned
    flags = cs.STATUS_HEAD + -(-nb // 8) * 8
    assert words == (0 if nb == 1 else flags + cs.SLOT_WORDS * nb)
    assert flags % 8 == 0 and cs.SLOT_WORDS % 16 == 0


# ---------------------------------------------------------------------------
# The source and the launchers
# ---------------------------------------------------------------------------


def _source() -> str:
    with open(SCAN_CU) as f:
        return f.read()


def test_kernel_constants_match_the_source():
    """Block shapes, the Montgomery one and the Fermat exponent's bits that
    csrc/scan.cu bakes."""
    src = _source()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kInvThreads"]) == cs.INV_THREADS
    assert int(consts["kRun"]) == cs.RUN
    assert int(consts["kMidThreads"]) == cs.MID_THREADS
    assert int(consts["kTileThreads"]) == cs.TILE_THREADS
    assert int(consts["kPerThread"]) == cs.PER_THREAD
    assert int(consts["kStatusHead"]) == cs.STATUS_HEAD
    assert int(consts["kSlotWords"]) == cs.SLOT_WORDS
    flags = dict(re.findall(r"(k[A-Z]\w+) = (\d+)[,;]", src[
        src.index("constexpr unsigned kNone"):]))
    assert (int(flags["kNone"]), int(flags["kAggregate"]),
            int(flags["kInclusive"])) == (NONE, AGGREGATE, INCLUSIVE)
    body = src[src.index("void set_one("):]
    words = re.findall(r"w\[(\d)\] = (0x[0-9A-Fa-f]+)u;", body)[:8]
    assert sum(int(v, 16) << (32 * int(i)) for i, v in words) == R
    # the root's two chains: p - 2 = 2^192 (2^59 + 2^4) + (2^192 - 1)
    low, shift, tail = (int(consts[c]) for c in ("kLowBits", "kHighShift",
                                                   "kHighTail"))
    assert (low, shift, tail) == (cs.LOW_BITS, cs.HIGH_SHIFT, cs.HIGH_TAIL)
    assert P - 2 == (1 << low) * ((1 << (shift + tail)) + (1 << tail)) + \
        (1 << low) - 1


def test_new_signatures_match_scan_cu():
    """The two entry points are defined with C linkage in csrc/scan.cu, with
    a pointer where the ctypes signature has one and a 64-bit int where it
    has c_longlong."""
    src = _source()
    start = src.index('extern "C" {')
    defined = {m.group(1): [p.strip() for p in m.group(2).split(",")]
               for m in re.finditer(r"^int (lcp_\w+)\(([^)]*)\)", src[start:],
                                    re.M)}
    assert set(defined) == {"lcp_batch_inverse", "lcp_prefix_product"}
    assert "scan.cu" in cuda_lib.SOURCES
    for name, params in defined.items():
        argtypes = cuda_lib._SIGNATURES[name]
        assert len(argtypes) == len(params), name
        for t, p in zip(argtypes, params):
            want = "void*" if t is cuda_lib._P else "long long"
            assert re.sub(r"\s+", " ", p).replace(" *", "*").startswith(
                ("const " + want, want)), (name, p)


def test_cpu_tensors_take_the_plain_versions():
    counts = (cs.mont_batch_inverse.launches, cs.mont_prefix_product.launches)
    x = seeded(3, 600, (0, 599))
    assert torch.equal(tfd.batch_inverse(x), cs.batch_inverse_plain(x))
    assert torch.equal(tfd.prefix_product(x), cs.prefix_product_plain(x))
    assert counts == (cs.mont_batch_inverse.launches,
                      cs.mont_prefix_product.launches)
    assert "lib" not in cuda_lib._state


@pytest.mark.parametrize("launcher", [cs.mont_batch_inverse,
                                      cs.mont_prefix_product])
def test_launchers_refuse_what_they_do_not_take(launcher):
    x = seeded(4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher(x)
    with pytest.raises(ValueError, match=r"\(16, n\)"):
        launcher(x.reshape(16, 8, 8))
    with pytest.raises(ValueError, match=r"\(16, n\)"):
        launcher(x[:8])
    with pytest.raises(TypeError, match="int32"):
        launcher(x.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        launcher(x[:, ::2])
    with pytest.raises(TypeError, match="tensor"):
        launcher(limbs_to_numpy(x))
    # any other device goes from field/device.py to the launchers
    meta = torch.empty((16, 64), dtype=torch.int32, device="meta")
    for fn in (tfd.batch_inverse, tfd.prefix_product):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(meta)
    assert "lib" not in cuda_lib._state


_TOY_SCRIPT = r"""
import json, os, sys
os.environ["LCP_FIELD"] = "f257"
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from lambdaworks_cairo_prover_tpu_torch.field import cuda_scan as cs
from lambdaworks_cairo_prover_tpu_torch.field import device as fd
vals = [5, 0, 256, 1, 100, 0, 3] * 50
x = fd.from_ints(vals, device="cpu")
out = {"inverse": fd.to_ints(fd.batch_inverse(x)),
       "prefix": fd.to_ints(fd.prefix_product(x)), "refused": [],
       "launches": [cs.mont_batch_inverse.launches,
                    cs.mont_prefix_product.launches]}
for launcher in (cs.mont_batch_inverse, cs.mont_prefix_product):
    try:
        launcher(x)
    except ValueError as exc:
        out["refused"].append(str(exc))
print("TOY=" + json.dumps(out))
"""


def test_toy_field_takes_the_plain_versions():
    """Under GF(257) the launchers refuse the field and field/device.py
    takes the plain versions, which are right there too."""
    env = dict(os.environ)
    env.pop("LCP_FIELD", None)
    proc = subprocess.run([sys.executable, "-c", _TOY_SCRIPT, ROOT],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    out = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("TOY=")][-1][len("TOY="):])
    vals = [5, 0, 256, 1, 100, 0, 3] * 50
    assert out["inverse"] == [pow(v, 255, 257) for v in vals]
    acc, want = 1, []
    for v in vals:
        acc = acc * v % 257
        want.append(acc)
    assert out["prefix"] == want
    assert out["launches"] == [0, 0]
    assert len(out["refused"]) == 2
    assert all("Stark252" in msg for msg in out["refused"])
