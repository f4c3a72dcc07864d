"""H1/H2 in both layouts of a field element, on the CPU.

The port's products and sums take each operand as ``(16, ...)`` limbs or
``(8, ...)`` packed words and write either layout.  The same limbs, made
from a seed with numpy, go through the JAX package's ``mul``/``add``/``sub``
(its plain route, no Pallas compile) and ``pack``, and through the port's
plain versions of H1/H2 in every operand layout and output layout; results
must be bit-equal.  A Python mirror walks the kernels' addressing
(csrc/field_ops.cu: groups of 4 output elements, 16-byte vector reads,
one read for a shared element, one element at a time elsewhere) over the
plans that the launcher makes, and the ctypes signatures of the two C
entry points are held to csrc/."""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambdaworks_cairo_prover_tpu.field import device as jfd
from lambdaworks_cairo_prover_tpu.field.params import N_LIMBS, P
from lambdaworks_cairo_prover_tpu_torch import cuda_lib
from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                        limbs_to_numpy)

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), "csrc")
N = 251  # elements: not a multiple of 4, and below the JAX Pallas route's 1024
EDGE_WORDS = (0, 1, 1 << 31, (1 << 32) - 1)
OPS = {"mul": (tfd.mul, cf.mul_plain), "add": (tfd.add, cf.add_plain),
       "sub": (tfd.sub, cf.sub_plain)}


def words_to_limbs(words: np.ndarray) -> np.ndarray:
    """(8, ...) uint32 words -> (16, ...) uint32 limbs."""
    out = np.empty((N_LIMBS,) + words.shape[1:], dtype=np.uint32)
    out[0::2] = words & 0xFFFF
    out[1::2] = words >> 16
    return out


def elements(seed: int, shape) -> np.ndarray:
    """(16, *shape) uint32 limbs of canonical elements: random ones below
    2^251, and along the last axis elements whose 32-bit words are each 0,
    1, 2^31 or 2^32 - 1 (word 7 kept below p's), then 0, 1 and p - 1."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(N_LIMBS,) + tuple(shape),
                         dtype=np.uint32)
    limbs[N_LIMBS - 1] &= 0x7FF
    m = shape[-1]
    if m < 8:
        return limbs
    n_edge = min(m - 3, 24)
    words = np.asarray(EDGE_WORDS, dtype=np.uint32)[
        rng.integers(0, 4, size=(8,) + tuple(shape[:-1]) + (n_edge,))]
    words[7] &= 0x03FFFFFF
    limbs[..., m - 3 - n_edge:m - 3] = words_to_limbs(words)
    limbs[..., -3:] = 0
    limbs[0, ..., -2] = 1
    for k in range(N_LIMBS):
        limbs[k, ..., -1] = ((P - 1) >> (16 * k)) & 0xFFFF
    return limbs


def in_layout(limbs: np.ndarray, packed: bool) -> torch.Tensor:
    t = limbs_from_numpy(limbs, "cpu")
    return cf.pack_words(t) if packed else t


def jax_ref(name: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    fn = getattr(jfd, name)
    return np.asarray(fn(jnp.asarray(a), jnp.asarray(b), prefer_pallas=False))


_REFS: dict = {}


def jax_refs(key, a: np.ndarray, b: np.ndarray) -> dict:
    """The JAX package's results of every op on (a, b), limbs and packed,
    computed once for ``key``."""
    if key not in _REFS:
        limbs = {name: jax_ref(name, a, b) for name in OPS}
        _REFS[key] = {name: (v, np.asarray(jfd.pack(jnp.asarray(v))))
                      for name, v in limbs.items()}
    return _REFS[key]


def as_words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def pair():
    a = elements(1, (N,))
    b = elements(2, (N,))[:, ::-1].copy()  # pair the edges with others
    return a, b, jax_refs("pair", a, b)


@pytest.mark.parametrize("name", list(OPS))
@pytest.mark.parametrize("layouts", [(False, False), (False, True),
                                     (True, False), (True, True)],
                         ids=["limbs-limbs", "limbs-packed", "packed-limbs",
                              "packed-packed"])
def test_every_layout_pair_and_output_layout_matches_jax(pair, name, layouts):
    a, b, want = pair
    want_limbs, want_words = want[name]
    fd_op, plain = OPS[name]
    x, y = in_layout(a, layouts[0]), in_layout(b, layouts[1])
    for packed in (False, True, None):
        for fn in (plain, fd_op):
            got = fn(x, y, packed=packed)
            if packed or (packed is None and any(layouts)):
                assert got.shape == (8, N)
                assert np.array_equal(as_words(got), want_words)
                assert np.array_equal(limbs_to_numpy(cf.unpack_words(got)),
                                      want_limbs)
            else:
                assert got.shape == (16, N)
                assert np.array_equal(limbs_to_numpy(got), want_limbs)


def test_edge_words_reach_the_operands(pair):
    a, b, _ = pair
    words = np.concatenate([as_words(in_layout(a, True)),
                            as_words(in_layout(b, True))], axis=1)
    assert set(EDGE_WORDS) <= set(np.unique(words).tolist())
    assert tfd.to_ints(in_layout(a, True), mont=False)[-3:] == [0, 1, P - 1]
    assert (tfd.to_ints(in_layout(a, True))
            == tfd.to_ints(in_layout(a, False)))


BROADCASTS = {
    # (x shape, y shape) of (16, ...) limbs; x's batch is the output's
    "scalar": ((4, 37), (1, 1)),
    "row": ((4, 37), (1, 37)),
    "column": ((4, 37), (4, 1)),
    "column-first": ((4, 1), (4, 37)),
    "outer": ((5, 1, 7), (1, 3, 7)),
}


@pytest.mark.parametrize("case", list(BROADCASTS))
@pytest.mark.parametrize("layouts", [(True, True), (True, False),
                                     (False, True)],
                         ids=["packed-packed", "packed-limbs", "limbs-packed"])
def test_broadcasts_match_jax(case, layouts):
    sx, sy = BROADCASTS[case]
    a = elements(3, sx)
    b = elements(4, sy)
    x, y = in_layout(a, layouts[0]), in_layout(b, layouts[1])
    for name, (want_limbs, want_words) in jax_refs(case, a, b).items():
        fd_op = OPS[name][0]
        got = fd_op(x, y, packed=False)
        assert np.array_equal(limbs_to_numpy(got), want_limbs), name
        assert np.array_equal(as_words(fd_op(x, y, packed=True)),
                              want_words), name


def test_views_with_another_row_stride_match_jax():
    """Operands cut from larger tensors: a row stride other than n, a chunk
    of points of several columns (two runs), a transposed view."""
    big = elements(5, (6, 40))
    other = elements(6, (3, 17))
    x = in_layout(big, True)[:, 1:4, 9:26]  # (8, 3, 17) from (8, 6, 40)
    assert x.stride(0) != 3 * 17
    want = {name: jax_ref(name, big[:, 1:4, 9:26], other) for name in OPS}
    for name, (fd_op, _) in OPS.items():
        got = fd_op(x, in_layout(other, False), packed=False)
        assert np.array_equal(limbs_to_numpy(got), want[name]), name
    # a view that no plan describes is read from a contiguous copy
    xt = in_layout(big, False)[:, 1:4, 9:26].transpose(1, 2)
    y = in_layout(other.transpose(0, 2, 1), True)
    for name, (fd_op, _) in OPS.items():
        got = fd_op(xt, y, packed=False).transpose(1, 2)
        assert np.array_equal(limbs_to_numpy(got), want[name]), name


# ---------------------------------------------------------------------------
# The kernels' addressing, walked in Python
# ---------------------------------------------------------------------------


def vector_ok(x: torch.Tensor, ls, div, mod, run, run_stride) -> bool:
    """csrc/field_ops.cu:make_operand's rule for 16-byte reads."""
    return (div == 1 and mod % 4 == 0 and run % 4 == 0
            and (run == mod or run_stride % 4 == 0) and ls % 4 == 0
            and x.data_ptr() % 16 == 0)


def operand_offset(e: int, div, mod, run, run_stride) -> int:
    i = e // div
    if i >= mod:
        i %= mod
    return i if run == mod else (i // run) * run_stride + i % run


def mirror(plain, a: torch.Tensor, b: torch.Tensor, packed):
    """The kernel's walk: groups of 4 output elements, each operand read
    by its plan (one element for the group, four consecutive ones from one
    16-byte aligned address, or one at a time, and the ragged tail one at a
    time), and the plain op on what was read.  Returns (result, the reads'
    modes)."""
    shape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    n = int(np.prod(shape))
    modes = Counter()
    reads = []
    for x, ls, div, mod, run, rs in (cf.operand_plan(t, shape) for t in (a, b)):
        flat = torch.as_strided(x, (x.untyped_storage().nbytes() // 4
                                    - x.storage_offset(),), (1,))
        vec = vector_ok(x, ls, div, mod, run, rs)
        offs = []
        for e0 in range(0, n, 4):
            group = [operand_offset(e, div, mod, run, rs)
                     for e in range(e0, min(e0 + 4, n))]
            if len(group) == 4 and (mod == 1 or div % 4 == 0):
                assert len(set(group)) == 1
                modes["one"] += 1
            elif len(group) == 4 and vec:
                assert group == list(range(group[0], group[0] + 4))
                for k in range(x.shape[0]):
                    assert (x.data_ptr() + 4 * (k * ls + group[0])) % 16 == 0
                modes["vector"] += 1
            else:
                modes["element"] += 1
            offs += group
        idx = torch.tensor(offs)
        reads.append(torch.stack([flat[k * ls + idx] for k in range(x.shape[0])]))
    out = plain(reads[0], reads[1], packed=packed)
    return out.reshape((out.shape[0],) + shape), modes


def _lde(seed, cols, points):
    return in_layout(elements(seed, (cols, points)), True)


MIRROR_CASES = {
    # name: (a, b, modes that the walk must use)
    "packed-packed": (lambda: (_lde(7, 1, 256)[:, 0], _lde(8, 1, 256)[:, 0]),
                      {"vector"}),
    "limbs-packed, ragged": (lambda: (in_layout(elements(9, (37,)), False),
                                      _lde(10, 1, 37)[:, 0]), {"element"}),
    "deep chunk x row": (
        lambda: (_lde(11, 10, 64)[:, 2:5, 16:48],
                 in_layout(elements(12, (1, 32)), False)), {"vector"}),
    "deep chunk x column": (
        lambda: (_lde(13, 10, 64)[:, 2:5, 16:48],
                 in_layout(elements(14, (3, 1)), False)), {"vector", "one"}),
    "flags x scalar": (lambda: (_lde(15, 15, 32), in_layout(
        elements(16, (15,))[:, 4:5], False)), {"vector", "one"}),
    "leaf rows": (lambda: (_lde(17, 7, 48)[:, 3:6, 8:40],
                           in_layout(elements(18, (1, 1))[..., :1], False)),
                  {"vector", "one"}),
    "misaligned view": (lambda: (_lde(19, 1, 41)[:, 0, 1:41],
                                 _lde(20, 1, 40)[:, 0]), {"vector", "element"}),
    "transposed (copied)": (lambda: (_lde(21, 8, 8).transpose(1, 2),
                                     _lde(22, 8, 8)), {"vector"}),
}


@pytest.mark.parametrize("case", list(MIRROR_CASES))
def test_kernel_addressing_mirror_matches_plain(case):
    make, expect = MIRROR_CASES[case]
    a, b = make()
    for name, (_, plain) in OPS.items():
        for packed in (False, True):
            got, modes = mirror(plain, a, b, packed)
            assert torch.equal(got, plain(a, b, packed=packed)), name
            assert set(modes) == expect, (name, dict(modes))


def test_plans_of_the_main_path_shapes():
    """A chunk of points of several columns is two runs, read in place; a
    contiguous packed operand one run; a non-C-contiguous view a copy."""
    lde = torch.zeros((8, 10, 64), dtype=torch.int32)
    x, ls, div, mod, run, rs = cf.operand_plan(lde[:, 2:5, 16:48], (3, 32))
    assert x.data_ptr() == lde[:, 2:5, 16:48].data_ptr()
    assert (ls, div, mod, run, rs) == (640, 1, 96, 32, 64)
    x, ls, div, mod, run, rs = cf.operand_plan(lde[:, 2], (64,))
    assert (ls, div, mod, run, rs) == (640, 1, 64, 64, 64)
    col = torch.zeros((16, 3, 1), dtype=torch.int32)
    assert cf.operand_plan(col, (3, 32))[1:] == (3, 32, 3, 3, 3)
    t = lde.transpose(1, 2)
    x, ls, div, mod, run, rs = cf.operand_plan(t, (64, 10))
    assert x.is_contiguous() and (ls, mod, run) == (640, 640, 640)


# ---------------------------------------------------------------------------
# The C entry points, and the rest of the fd layer
# ---------------------------------------------------------------------------

C_TYPES = {"const void*": cuda_lib.ctypes.c_void_p,
           "void*": cuda_lib.ctypes.c_void_p,
           "long long": cuda_lib.ctypes.c_longlong,
           "int": cuda_lib.ctypes.c_int}


@pytest.mark.parametrize("name", ["lcp_mont_mul", "lcp_add_sub"])
def test_ctypes_signatures_match_csrc(name):
    with open(os.path.join(CSRC, "field_ops.cu")) as f:
        text = f.read()
    m = re.search(rf"^int {name}\(([^)]*)\)", text, re.M)
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [re.sub(r"\s*\w+$", "", p) for p in params]
    assert [C_TYPES[t] for t in types] == cuda_lib._SIGNATURES[name]
    names = [p.split()[-1] for p in params]
    assert names[-4:] == ["out", "out_packed", "n", "stream"]
    for x in ("a", "b"):
        i = names.index(x)
        assert names[i:i + 7] == [x, f"{x}_ls", f"{x}_div", f"{x}_mod",
                                  f"{x}_run", f"{x}_run_stride", f"{x}_packed"]


def test_fd_layer_takes_either_layout():
    a = elements(23, (9,))
    limbs = limbs_from_numpy(a, "cpu")
    words = cf.pack_words(limbs)
    assert tfd.to_ints(words) == tfd.to_ints(limbs)
    assert torch.equal(tfd.from_mont(words, packed=False), tfd.from_mont(limbs))
    assert torch.equal(tfd.to_mont(limbs, packed=True),
                       cf.pack_words(tfd.to_mont(limbs)))
    assert torch.equal(tfd.square(words), cf.pack_words(tfd.square(limbs)))
    assert torch.equal(tfd.neg(words, packed=False), tfd.neg(limbs))
    assert torch.equal(tfd.is_zero(words), tfd.is_zero(limbs))
    assert tfd.eq(words, limbs).all() and tfd.eq(limbs, words).all()
    mask = torch.arange(9) % 2 == 0
    other = limbs.flip(1)
    assert torch.equal(tfd.select(mask, words, other),
                       cf.pack_words(tfd.select(mask, limbs, other)))
    for fn in (tfd.batch_inverse, tfd.prefix_product):
        with pytest.raises(ValueError, match="limbs"):
            fn(words)
    meta = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfd.mul(meta, meta)
