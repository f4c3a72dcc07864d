"""K4 ``fri_tail`` (the FRI commit's last layers and final fold in one
launch) on the CPU: its plain version, its schedule, and the proofs of the
route that takes it.

* The plain version (``prover/fri_tail.py:fri_tail_plain``) equals the
  host route (``prove._host_fri_layer`` after a host draw, then the host's
  final fold) at every tail size, LDE 2^5 .. 2^13: evaluations, tree
  levels, roots, drawn states and the last value.
* The chain with a tail (``fri_commit_chain(..., tail=)``) equals the full
  chain with its final fold.
* K4's schedule, walked in Python integers (:func:`mirror_tail`: the
  kernel's fold into ping-pong buffers, bit-reversed scatter, DIT stages
  and twiddle indices, leaf and draw lane formulas, tree offsets), equals
  the host route; the kernel itself runs only on the card, where
  ``chip_smoke.py`` ``[fri-tail]`` holds it to the plain version.
* ``FriTail.gather`` (one index_select for values, one for siblings) equals
  the per-layer gathers.
* A proof by the new route is byte-equal to the host-tail route and to the
  JAX package's fixture; the host-layer counter reads 0 on the new route
  and the number of layers at or below the threshold on the host route.

Field values and bytes must be equal (tolerance 0)."""

import os
import re

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu_torch import cuda_lib
from lambdaworks_cairo_prover_tpu_torch.air.examples import simple_fibonacci as tfib
from lambdaworks_cairo_prover_tpu_torch.field import device as fd
from lambdaworks_cairo_prover_tpu_torch.field import host as fh
from lambdaworks_cairo_prover_tpu_torch.field.params import (
    N_LIMBS, P, R2, get_primitive_root_of_unity)
from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as kd
from lambdaworks_cairo_prover_tpu_torch.hash.keccak_host import keccak256
from lambdaworks_cairo_prover_tpu_torch.hash.merkle import MerkleTree
from lambdaworks_cairo_prover_tpu_torch.interop import limbs_from_numpy
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
from lambdaworks_cairo_prover_tpu_torch.prover import fri_tail as ft
from lambdaworks_cairo_prover_tpu_torch.prover import kernels as pk
from lambdaworks_cairo_prover_tpu_torch.prover import prove as pv
from lambdaworks_cairo_prover_tpu_torch.prover.domain import Domain
from lambdaworks_cairo_prover_tpu_torch.transcript import (DefaultTranscript,
                                                           transcript_to_field)
from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
OPTIONS = ProofOptions.default_test_options()
PUB = tfib.FibonacciPublicInputs(a0=1, a1=1)
MASK32 = 0xFFFFFFFF


def kernels(log_rows: int):
    air = tfib.FibonacciAIR(1 << log_rows, PUB, OPTIONS)
    domain = Domain(air)
    return pk.get_kernels(air, domain, "cpu"), domain


def fold_layers(domain: Domain) -> list:
    """(offset, domain size) of every layer after the first."""
    layers, off, ds = [], domain.coset_offset, domain.lde_size
    for _ in range(1, domain.root_order):
        off, ds = off * off % P, ds // 2
        layers.append((off, ds))
    return layers


def random_coeffs(seed: int, n: int) -> torch.Tensor:
    limbs = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(N_LIMBS, n), dtype=np.uint32)
    limbs[N_LIMBS - 1] &= 0x7FF
    return fd.to_mont(limbs_from_numpy(limbs, "cpu"))


def digest(x: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(x, dtype="<i8").copy())[None]


def tail_input(log_rows: int):
    """The tail after the first layer at LDE 2^(log_rows + 2): every layer
    has at most 2^13 / 2 points, so all of them make the tail."""
    _, domain = kernels(log_rows)
    rng = np.random.default_rng(200 + log_rows)
    coeffs = random_coeffs(log_rows, 1 << log_rows)
    return coeffs, rng.bytes(32), rng.bytes(32), fold_layers(domain)


def host_route(coeffs: list, state: bytes, root: bytes, layers) -> tuple:
    """The host tail of prove._fri_commit on a host transcript: a draw after
    each root, ``_host_fri_layer``, then the final draw and fold."""
    t = DefaultTranscript()
    t._buf = bytearray(state)
    evals, trees, states = [], [], []
    for off, ds in layers:
        t.append(root)
        zeta = transcript_to_field(t)
        states.append(bytes(t._buf))
        coeffs, ev, tree = pv._host_fri_layer(coeffs, zeta, off, ds)
        evals.append(ev)
        trees.append(tree)
        root = tree.root
    t.append(root)
    zeta = transcript_to_field(t)
    states.append(bytes(t._buf))
    return evals, trees, states, pv._host_fold(coeffs, zeta)[0]


def rows_bytes(x: torch.Tensor) -> list:
    return [kd.digest_to_bytes(r) for r in x]


@pytest.mark.parametrize("log_rows", range(3, 12))  # LDE 2^5 .. 2^13
def test_tail_plain_equals_host_route(log_rows):
    coeffs, state, root, layers = tail_input(log_rows)
    got = ft.fri_tail(coeffs, digest(state), digest(root), layers)
    evals, trees, states, last = host_route(fd.to_ints(coeffs), state, root,
                                            layers)
    n = len(layers)
    assert got.sizes == tuple(ds for _, ds in layers)
    assert got.rows.shape == got.states.shape == (n + 1, 4)
    assert rows_bytes(got.rows[:n]) == [tree.root for tree in trees]
    assert int.from_bytes(got.rows[n].numpy().tobytes(), "little") == last
    assert rows_bytes(got.states) == states
    for k in range(n):
        assert fd.to_ints(got.layer_evals(k)) == evals[k]
        assert [rows_bytes(lv) for lv in got.layer_levels(k)] == \
            trees[k].levels


@pytest.mark.parametrize("log_rows", range(3, 11))  # LDE 2^5 .. 2^12
def test_chain_with_tail_equals_full_chain(log_rows):
    kern, domain = kernels(log_rows)
    layers = fold_layers(domain)
    split = len(layers) // 2
    coeffs = random_coeffs(300 + log_rows, 1 << log_rows)
    state = digest(np.random.default_rng(400 + log_rows).bytes(32))
    rows, evals, levels, _ = kern.fri_commit_chain(coeffs, state, layers,
                                                   final_fold=True)
    rows_t, evals_t, levels_t, tail = kern.fri_commit_chain(
        coeffs, state, layers[:split], tail=layers[split:])
    assert isinstance(tail, ft.FriTail)
    assert torch.equal(rows_t, rows)
    assert len(evals_t) == len(levels_t) == split + 1
    for k in range(len(layers) - split):
        assert torch.equal(tail.layer_evals(k), evals[split + 1 + k])
        for got, want in zip(tail.layer_levels(k), levels[split + 1 + k],
                             strict=True):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K4's schedule in Python integers
# ---------------------------------------------------------------------------


def bswap(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def words(v: int) -> list:
    """An element as the kernel holds it: 8 little-endian 32-bit words."""
    return [(v >> (32 * k)) & MASK32 for k in range(8)]


def leaf_message(v: int) -> bytes:
    """hash_felt's message lanes: lane j is words 7 - 2j (low half) and
    6 - 2j (high half), each byte-swapped."""
    w = words(v)
    lanes = [(bswap(w[6 - 2 * j]) << 32) | bswap(w[7 - 2 * j])
             for j in range(4)]
    return b"".join(lane.to_bytes(8, "little") for lane in lanes)


def draw_value(state: bytes) -> int:
    """draw's zeta from the state's lanes: words 2i and 2i + 1 from the high
    and low halves of lane 3 - i, byte-swapped, word 7 masked to 27 bits."""
    lanes = [int.from_bytes(state[8 * i:8 * i + 8], "little")
             for i in range(4)]
    w = [0] * 8
    for i in range(4):
        w[2 * i] = bswap(lanes[3 - i] >> 32)
        w[2 * i + 1] = bswap(lanes[3 - i] & MASK32)
    w[7] &= 0x07FFFFFF
    return sum(x << (32 * k) for k, x in enumerate(w))


def last_row(v: int) -> bytes:
    """The final fold's row: lane j is words 2j (low) and 2j + 1 (high)."""
    w = words(v)
    return b"".join((w[2 * j] | (w[2 * j + 1] << 32)).to_bytes(8, "little")
                    for j in range(4))


def rev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def mirror_tail(coeffs: list, state: bytes, root: bytes, layers,
                n_ranks: int) -> tuple:
    """csrc/fri_tail.cu's loop over the layers, in canonical integers (the
    kernel's Montgomery forms map one to one), for a cluster of n_ranks
    blocks: the draw, the fold from one coefficient buffer into the other,
    the scaled values scattered to bit-reversed positions of the padded
    plane, the DIT stages with the kernel's butterfly indexing and twiddle
    entry m + j = w_{2m}^j, the evaluations, the leaves and tree levels at
    the kernel's offsets in a flat buffer by the blocks' slices, the roots
    and states."""
    n = len(layers)
    c0, ds0 = 1 << n, layers[0][1]

    def phys(s: int) -> int:  # the plane's pad word per 32
        return s + (s >> 5)

    x = [None] * phys(ds0)
    coef = [[None] * c0, [None] * c0]
    evals, rows, states = [], [], []
    levels = [None] * sum(2 * ds - 1 for _, ds in layers)
    l_off = 0
    for layer in range(n + 1):
        state = keccak256(state + root)
        states.append(state)
        zeta = draw_value(state)
        if layer == n:
            break
        off, ds = layers[layer]
        log_ds, c = ds.bit_length() - 1, c0 >> layer
        src = coeffs if layer == 0 else coef[(layer + 1) & 1]
        dst = coef[layer & 1]
        for i in range(ds):
            v = 0
            if i < c:
                dst[i] = (src[2 * i] + zeta * src[2 * i + 1]) % P
                v = dst[i] * pow(off, i, P) % P
            x[phys(rev(i, log_ds))] = v
        for log_m in range(log_ds):
            m = 1 << log_m
            w2m = get_primitive_root_of_unity(log_m + 1)
            for bf in range(ds // 2):
                j = bf & (m - 1)
                lo = ((bf >> log_m) << (log_m + 1)) | j
                u, v = x[phys(lo)], x[phys(lo + m)]
                if j:
                    v = v * pow(w2m, j, P) % P
                x[phys(lo)], x[phys(lo + m)] = (u + v) % P, (u - v) % P
        ev = [x[phys(i)] for i in range(ds)]
        evals.append(ev)
        for i, v in enumerate(ev):
            levels[l_off + i] = keccak256(leaf_message(v))
        # block r's slice of the leaves and its subtree, then block 0's
        # levels above the slices' roots; a level of s nodes starts at
        # node 2 ds - 2 s of the layer's
        width = ds // n_ranks if ds > n_ranks else 1
        for first in range(0, ds, width):
            s, start, w = ds, first, width
            while w > 1:
                below = l_off + 2 * ds - 2 * s
                for j in range(w // 2):
                    levels[below + s + start // 2 + j] = keccak256(
                        levels[below + start + 2 * j]
                        + levels[below + start + 2 * j + 1])
                s, start, w = s // 2, start // 2, w // 2
        s = ds // width
        while s > 1:
            below = l_off + 2 * ds - 2 * s
            for j in range(s // 2):
                levels[below + s + j] = keccak256(levels[below + 2 * j]
                                                  + levels[below + 2 * j + 1])
            s //= 2
        root = levels[l_off + 2 * ds - 2]
        rows.append(root)
        l_off += 2 * ds - 1
    a, b = coef[(n + 1) & 1][:2]  # the final fold: 2 coefficients left
    rows.append(last_row((a + zeta * b) % P))
    return evals, levels, rows, states


def test_kernel_lane_formulas():
    """The leaf message, the draw's masked integer and the last row, as the
    kernel forms them from words, against the byte encodings."""
    rng = np.random.default_rng(500)
    for _ in range(64):
        v = int.from_bytes(rng.bytes(32), "little") % P
        assert leaf_message(v) == v.to_bytes(32, "big")
        assert last_row(v) == v.to_bytes(32, "little")
        state = rng.bytes(32)
        assert draw_value(state) == fh.randomness_to_field(state)


@pytest.mark.parametrize("n_ranks", [1, ft.CLUSTER, 16])
@pytest.mark.parametrize("log_rows", [3, 5, 11])
def test_kernel_schedule_equals_host_route(log_rows, n_ranks):
    coeffs, state, root, layers = tail_input(log_rows)
    ints = fd.to_ints(coeffs)
    evals, levels, rows, states = mirror_tail(ints, state, root, layers,
                                              n_ranks)
    want_evals, trees, want_states, last = host_route(ints, state, root,
                                                      layers)
    assert evals == want_evals
    assert states == want_states
    assert rows == [t.root for t in trees] + [last.to_bytes(32, "little")]
    assert levels == [d for t in trees for lv in t.levels for d in lv]


def source_table(name: str) -> list:
    with open(os.path.join(cuda_lib.CSRC_DIR, "fri_tail.cu")) as f:
        body = re.search(rf"{name}\[25\] = \{{([^}}]*)\}}", f.read()).group(1)
    return [int(v) for v in body.split(",")]


def keccak_f_warp(state: list) -> list:
    """csrc/fri_tail.cu's keccak_f_warp on 32 lanes (lane l < 25 holds state
    lane l; a shuffle reads another lane's value), with its kRho and kPiSrc
    tables, on u64 ints."""
    rho_t, pi_t = source_table("kRho"), source_table("kPiSrc")
    mask = (1 << 64) - 1

    def rotl(v, r):
        return ((v << r) | (v >> (64 - r))) & mask if r else v

    a = list(state) + [0] * 7
    lanes = range(32)
    ms = [lane if lane < 25 else 0 for lane in lanes]
    for rc in kd._RC:
        c = [a[lane] ^ a[(m + 5) % 25] ^ a[(m + 10) % 25] ^ a[(m + 15) % 25]
             ^ a[(m + 20) % 25] for lane, m in zip(lanes, ms)]
        a = [a[lane] ^ c[m - m % 5 + (m % 5 + 4) % 5]
             ^ rotl(c[m - m % 5 + (m % 5 + 1) % 5], 1)
             for lane, m in zip(lanes, ms)]
        rot = [rotl(a[lane], rho_t[m]) for lane, m in zip(lanes, ms)]
        b = [rot[pi_t[m]] for m in ms]
        a = [b[lane] ^ (~b[m - m % 5 + (m % 5 + 1) % 5] & mask
                        & b[m - m % 5 + (m % 5 + 2) % 5])
             for lane, m in zip(lanes, ms)]
        a[0] ^= rc
    return a[:25]


def test_warp_keccak_schedule_equals_keccak_f():
    """The warp's lane constants and round against the plain keccak-f."""
    rng = np.random.default_rng(700)
    states = rng.integers(-1 << 63, (1 << 63) - 1, (25, 4), dtype=np.int64)
    want = kd._keccak_f(torch.from_numpy(states.copy()))
    for k in range(states.shape[1]):
        got = keccak_f_warp([int(v) & ((1 << 64) - 1) for v in states[:, k]])
        assert got == [int(v) & ((1 << 64) - 1) for v in want[:, k]]


def test_kernel_constants_match_the_source():
    """MAX_LOG and R^2 as csrc/fri_tail.cu bakes them; the shared memory of
    the largest first layer fits a block."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "fri_tail.cu")) as f:
        text = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kTailMaxLog"]) == ft.MAX_LOG
    words_r2 = re.search(r"kR2\[8\] = \{([^}]*)\}", text).group(1)
    r2 = [int(w.strip().rstrip("u"), 16) for w in words_r2.split(",")]
    assert sum(w << (32 * k) for k, w in enumerate(r2)) == R2
    ds0 = 1 << ft.MAX_LOG
    n_layers = ft.MAX_LOG - 2  # blowup 4: the cells' ten layers
    smem = 4 * (8 * (ds0 + ds0 // 32) + 16 * (1 << n_layers))
    assert smem + 128 <= 232_448  # a block's shared memory on Hopper
    assert "fri_tail.cu" in cuda_lib.SOURCES


def test_gather_equals_per_layer_gathers():
    coeffs, state, root, layers = tail_input(7)
    tail = ft.fri_tail(coeffs, digest(state), digest(root), layers)
    rng = np.random.default_rng(600)
    idxs = [rng.integers(0, ds, 12).tolist() for ds in tail.sizes]
    values, siblings = tail.gather(idxs)
    want_v = [tail.layer_evals(k).index_select(1, torch.tensor(ix))
              for k, ix in enumerate(idxs)]
    want_s = [MerkleTree(tail.layer_levels(k)).gather_siblings(ix)
              for k, ix in enumerate(idxs)]
    assert torch.equal(values, torch.cat(want_v, dim=1))
    assert torch.equal(siblings, torch.cat(want_s))


def test_launcher_refuses():
    coeffs, state, root, layers = tail_input(4)
    with pytest.raises(ValueError, match="CUDA"):
        ft.fri_tail_cuda(coeffs, digest(state), digest(root), layers)
    with pytest.raises(ValueError, match="halve"):
        ft.fri_tail(coeffs, digest(state), digest(root), layers[::-1])
    with pytest.raises(ValueError, match="coefficients"):
        ft.fri_tail(coeffs[:, :8], digest(state), digest(root), layers)
    big = [(1, 1 << (ft.MAX_LOG + 1 - k)) for k in range(3)]
    with pytest.raises(ValueError, match="first layer"):
        ft.fri_tail_cuda(coeffs[:, :16], digest(state), digest(root), big)
    assert ft.fri_tail_cuda.launches == 0


# ---------------------------------------------------------------------------
# Whole proofs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_rows, threshold, fixture", [
    (10, 1024, "simple_fibonacci_1024_test_options.proof"),  # 8 tail layers
    (10, 32, "simple_fibonacci_1024_test_options.proof"),    # 3 tail layers
    (12, pv._HOST_FRI_THRESHOLD, None),  # the cells' ten layers of <= 4096
])
def test_proof_through_tail_equals_host_tail(monkeypatch, log_rows,
                                             threshold, fixture):
    """The chain then K4, against the chain then the host tail (the same
    route with ``supports_fri_tail`` off) and the JAX package's proof; the
    host-layer counter of each."""
    monkeypatch.setattr(pv, "_FULL_CHAIN_MAX_LOG", 0)
    monkeypatch.setattr(pv, "_HOST_FRI_THRESHOLD", threshold)
    trace = tfib.fibonacci_trace([1, 1], 1 << log_rows, device="cpu")
    tails = []
    chain = pk.ProverKernels.fri_commit_chain

    def spy(self, *args, **kwargs):
        out = chain(self, *args, **kwargs)
        tails.append(out[3] if kwargs.get("tail") else None)
        return out

    monkeypatch.setattr(pk.ProverKernels, "fri_commit_chain", spy)
    counted = pv._host_fri_layer.calls
    through_tail = pv.prove(trace, PUB, OPTIONS, tfib.FibonacciAIR,
                            device="cpu")
    assert pv._host_fri_layer.calls == counted
    n_host = sum(1 for _, ds in fold_layers(Domain(tfib.FibonacciAIR(
        1 << log_rows, PUB, OPTIONS))) if ds <= threshold)
    assert len(tails) == 1 and tails[0].sizes[0] == threshold
    assert len(tails[0].sizes) == n_host
    monkeypatch.setattr(pk.ProverKernels, "supports_fri_tail", False)
    host_tail = pv.prove(trace, PUB, OPTIONS, tfib.FibonacciAIR, device="cpu")
    assert pv._host_fri_layer.calls == counted + n_host
    assert tails[1] is None
    got = serialize_proof(through_tail)
    assert got == serialize_proof(host_tail)
    if fixture:
        with open(os.path.join(FIXTURES, fixture), "rb") as f:
            assert got == f.read()
    assert verify(through_tail, PUB, OPTIONS, tfib.FibonacciAIR)
