"""NTTs of the PyTorch port against the JAX package.

The port's CPU path (the plain radix-2 NTT, and the plain versions of the
H3/H4 kernels walking the pass list of the CUDA path) against the JAX
transforms, the Pallas butterflies in interpret mode, and the fused Pallas
NTT through digests recorded from it.  Exact comparisons (tolerance 0): the
values are fixed by the math."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambdaworks_cairo_prover_tpu.field import pallas_mul as pm
from lambdaworks_cairo_prover_tpu.ntt import core as jnttc
from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.field.params import P
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


@pytest.mark.parametrize("log_n", range(1, 14))
def test_pass_list_matches_jax(log_n):
    """The CUDA path's pass list, walked with the kernels' plain versions,
    against the JAX transforms on a batch of 2.  The inverse is held against
    the same JAX output through intt(x)[i] = ntt(x)[-i mod n] / n at every
    size, and against jnttc.intt itself at the sizes whose compile
    test_transforms_match_jax shares."""
    n = 1 << log_n
    x = rand_limbs(100 + log_n, (2, n))
    xt = limbs_from_numpy(x, "cpu")
    fwd = np.asarray(jnttc.ntt(jnp.asarray(x)))
    assert np.array_equal(limbs_to_numpy(cn.ntt_passes_plain(xt, False)), fwd)
    n_inv = tfd.from_int(pow(n, P - 2, P), device="cpu").reshape(16, 1, 1)
    inv = limbs_to_numpy(tfd.mul(cn.ntt_passes_plain(xt, True), n_inv))
    mirrored = limbs_from_numpy(fwd[..., (-np.arange(n)) % n], "cpu")
    assert np.array_equal(inv, limbs_to_numpy(tfd.mul(mirrored, n_inv)))
    if log_n in (1, 3, 6, 9):
        assert np.array_equal(inv, np.asarray(jnttc.intt(jnp.asarray(x))))


@pytest.mark.parametrize("log_n", range(1, cn.MAX_LOG_N + 1))
def test_pass_list_covers_every_stage_once(log_n):
    passes = cn.ntt_passes(log_n)
    stages = [m for p in passes
              for m in range(p.log_m_hi, p.log_m_hi - p.n_stages, -1)]
    assert stages == list(range(log_n - 1, -1, -1))
    assert [p.natural for p in passes] == [False] * (len(passes) - 1) + [True]
    assert passes[-1].local and not any(p.local for p in passes[:-1])
    for p in passes:
        assert p.n_stages <= (cn.LOCAL_LOG if p.local else cn.MAX_STAGES)
        assert p.n_stages <= cn.TILE_LOG
    # a block's tile, 8 words a point and a pad word per 32, fits the 227 KB
    # of shared memory a block may use, three blocks to an SM
    assert cn.TILE_BYTES == 32 * ((1 << cn.TILE_LOG) * 33 // 32)
    assert 3 * cn.TILE_BYTES <= 227 * 1024
    assert len(passes) <= (1 if log_n <= cn.LOCAL_LOG else 4)
    assert log_n != 21 or len(passes) == 3


def test_pass_list_past_the_old_cap():
    """Transforms of 2^25 and 2^26 points (simple_fibonacci's composition
    LDE at 2^22 and 2^23 rows) have a pass list: three H3 passes and the
    last H4 pass of 7 stages."""
    P_ = cn.Pass
    assert cn.MAX_LOG_N >= 26
    assert cn.ntt_passes(25) == [P_(24, 6, False, False), P_(18, 6, False, False),
                                 P_(12, 6, False, False), P_(6, 7, True, True)]
    assert cn.ntt_passes(26) == [P_(25, 7, False, False), P_(18, 6, False, False),
                                 P_(12, 6, False, False), P_(6, 7, True, True)]
    with pytest.raises(ValueError, match="outside"):
        cn.ntt_passes(cn.MAX_LOG_N + 1)


def _h3_pairs(log_n: int, log_m_hi: int, n_stages: int, tile: int):
    """The pairs and twiddle entries of one H3 block (one column), with
    csrc/ntt.cu's index arithmetic: ntt_dif_stages_kernel's base and
    strides, tile_stages' pairing and entry.  Returns (stage half-size m,
    lower position, upper position, twiddle entry) as int64 arrays."""
    r = n_stages
    lo = log_m_hi - r + 1
    log_t = min(cn.TILE_LOG - r, lo)
    mid = tile & ((1 << (lo - log_t)) - 1)
    base = ((tile >> (lo - log_t)) << (log_m_hi + 1)) + (mid << log_t)
    row = np.arange(1 << r, dtype=np.int64)[:, None]
    col = np.arange(1 << log_t, dtype=np.int64)[None, :]
    out = []
    for k in range(r - 1, -1, -1):
        m = 1 << (lo + k)
        low = row[(row[:, 0] >> k) & 1 == 0]
        p = base + low * (1 << lo) + col
        q = base + (low + (1 << k)) * (1 << lo) + col
        entry = m + ((low % (1 << k)) << lo) + (mid << log_t) + col
        out.append((m, p.ravel(), q.ravel(), entry.ravel()))
    return out


@pytest.mark.parametrize("log_n", [25, 26, cn.MAX_LOG_N])
def test_twiddle_indexing_at_the_cap(log_n):
    """At sizes no CPU test transforms, H3's blocks pair the points and read
    the twiddle entries that the plain DIF stage does (dif_stage_plain: the
    pair (p, p + m) with p mod 2m < m takes tw[m + p mod m]), every entry
    inside the 2^log_n-entry table: the first, a middle and the last block
    of every H3 pass of the pass list.  The entries of stage m are the
    powers of a root of order 2m, which the field has at every stage
    read."""
    from lambdaworks_cairo_prover_tpu_torch.field.params import (
        get_primitive_root_of_unity)

    n = 1 << log_n
    seen = set()
    for p_ in cn.ntt_passes(log_n):
        if p_.local:
            continue
        lo = p_.log_m_hi - p_.n_stages + 1
        blocks = n >> (p_.n_stages + min(cn.TILE_LOG - p_.n_stages, lo))
        for tile in (0, blocks // 2 + 1, blocks - 1):
            for m, p, q, entry in _h3_pairs(log_n, p_.log_m_hi, p_.n_stages,
                                            tile):
                assert np.array_equal(q, p + m)
                assert np.all(p % (2 * m) < m)
                assert np.array_equal(entry, m + p % m)
                assert entry.min() >= m and entry.max() < min(2 * m, n)
                seen.add((m, int(entry.max())))
    # every stage of the H3 passes was read, and its part of the table,
    # w_{2m}^j (cn._build_twiddles), has a root of order 2m to take
    assert {m for m, _ in seen} == {1 << s for s in range(
        cn.ntt_passes(log_n)[-1].n_stages, log_n)}
    for m, _ in seen:
        w = get_primitive_root_of_unity(m.bit_length())
        assert pow(w, m, P) == P - 1


@pytest.mark.parametrize("log_n,log_m_hi,n_stages",
                         [(4, 3, 4), (7, 6, 3), (7, 4, 5), (9, 8, 1)])
def test_plain_stage_passes(log_n, log_m_hi, n_stages):
    """dif_stages_plain is its stages one by one; dif_local_plain with the
    natural-order output is the bit-reversal of the one without."""
    x = limbs_from_numpy(rand_limbs(70 + log_n, (2, 1 << log_n)), "cpu")
    tw = cn.twiddle_table(log_n, False, "cpu")
    want = x
    for log_m in range(log_m_hi, log_m_hi - n_stages, -1):
        want = cn.dif_stage_plain(want, tw, log_m)
    assert torch.equal(cn.dif_stages_plain(x, tw, log_m_hi, n_stages), want)
    local = cn.dif_local_plain(x, tw, n_stages)
    assert torch.equal(local, cn.dif_stages_plain(x, tw, n_stages - 1, n_stages))
    assert torch.equal(cn.dif_local_plain(x, tw, n_stages, natural=True),
                       local[..., cn.bitrev_indices(log_n, "cpu")])


def test_packed_twiddles_hold_the_limb_table():
    tw = cn.twiddle_table(6, True, "cpu")
    packed = cn.packed_twiddle_table(6, True, "cpu")
    assert packed.shape == (64, 8) and packed.dtype == torch.int32
    words = packed.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(words.t() & 0xFFFF, tw[0::2].to(torch.int64))
    assert torch.equal(words.t() >> 16, tw[1::2].to(torch.int64))


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
    assert _sha256(limbs_to_numpy(cn.ntt_passes_plain(xt, inverse))) == case["output_sha256"]


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


def test_plain_dif_pass_undoes_pallas_butterflies():
    """A DIF stage with twiddle w undoes the DIT butterfly with 1/w up to a
    factor 2: pallas_mul.butterfly (interpret mode) with the inverse twiddles
    over stages 0 and 1, then dif_stages_plain over stages 1 and 0 with the
    forward ones, gives 4x."""
    log_n, n = 6, 64
    x = rand_limbs(51, (1, n))
    jtw = jnttc._stage_twiddles(log_n, True)
    y = jnp.asarray(x)
    for s in (0, 1):
        m = 1 << s
        yv = y.reshape(16, 1, n // (2 * m), 2, m)
        hi, lo = pm.butterfly(yv[:, :, :, 0, :], yv[:, :, :, 1, :],
                              jtw[s][:, None, None, :], interpret=True)
        y = jnp.stack([hi, lo], axis=3).reshape(16, 1, n)
    got = cn.dif_stages_plain(limbs_from_numpy(np.asarray(y), "cpu"),
                              cn.twiddle_table(log_n, False, "cpu"), 1, 2)
    xt = limbs_from_numpy(x, "cpu")
    two = cf.add_plain(xt, xt)
    assert torch.equal(got, cf.add_plain(two, two))


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
