"""The port's device-memory layout on the CPU, against the JAX package: the
packed words (``fd.pack``/``unpack``), the packed resident trace, the packed
round-1 buffers, and the Cairo proof files under every route through that
layout (the default, chunks forced far below the domain, ``LCP_AUX_HOST``,
``donate_trace``), each equal to the JAX package's recorded proof file
(``tests/fixtures/torch_port/``, written by ``tools/make_torch_fixtures.py``).
``LCP_DEBUG_MEM=1`` prints and carries on without a card."""

import os

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu.air.trace import TraceTable as JTraceTable
from lambdaworks_cairo_prover_tpu.field import device as jfd
from lambdaworks_cairo_prover_tpu_torch.air.examples.simple_fibonacci import (
    FibonacciAIR, FibonacciPublicInputs, fibonacci_trace)
from lambdaworks_cairo_prover_tpu_torch.air.trace import TraceTable
from lambdaworks_cairo_prover_tpu_torch.cairo import programs
from lambdaworks_cairo_prover_tpu_torch.cairo.air import (
    CairoAIR, generate_cairo_proof)
from lambdaworks_cairo_prover_tpu_torch.cairo.runner import generate_prover_args
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.field.params import N_LIMBS, P
from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as kd
from lambdaworks_cairo_prover_tpu_torch.hash.keccak_host import keccak256_batch
from lambdaworks_cairo_prover_tpu_torch.ntt import core as nttc
from lambdaworks_cairo_prover_tpu_torch.proof import serde
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.prover import kernels as pk
from lambdaworks_cairo_prover_tpu_torch.prover.domain import Domain
from lambdaworks_cairo_prover_tpu_torch.prover.prove import _mem, prove
from lambdaworks_cairo_prover_tpu_torch.verifier.verify import verify

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")
OPTIONS = ProofOptions.default_test_options()
PROGRAMS = {
    "fib5": ("cairo_fib5_test_options.proof",
             lambda: programs.fibonacci_program(5)),
    "rc": ("cairo_rc_test_options.proof",
           lambda: programs.rc_program((250, 77, 1 << 100))),
}


def _limbs_with_top_bits(seed: int, shape: tuple) -> np.ndarray:
    """Random 16-bit limbs whose odd limbs (the high half of a word) take
    0x8000 and 0xFFFF often: packed words with the top bit set."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(N_LIMBS,) + shape).astype(np.uint32)
    a[1::2, ..., 0::3] = 0xFFFF
    a[1::2, ..., 1::3] = 0x8000
    return a


def test_pack_and_unpack_equal_jax_bit_for_bit():
    a = _limbs_with_top_bits(81, (3, 97))
    packed = tfd.pack(torch.from_numpy(a.astype(np.int32)))
    assert packed.dtype == torch.int32 and packed.shape == (8, 3, 97)
    want = np.asarray(jfd.pack(a))  # uint32 words
    assert (want >= 1 << 31).any()
    # int32 words carry the uint32 bit pattern
    assert np.array_equal(packed.numpy().view(np.uint32), want)
    for words in (packed, torch.from_numpy(want.astype(np.int64))):
        got = tfd.unpack(words)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().astype(np.uint32),
                              np.asarray(jfd.unpack(want)))
        assert np.array_equal(got.numpy().astype(np.uint32), a)
    out = torch.full((N_LIMBS, 3, 100), -1, dtype=torch.int32)
    tfd.unpack(packed, out=out[:, :, :97])
    assert np.array_equal(out[:, :, :97].numpy().astype(np.uint32), a)
    assert (out[:, :, 97:] == -1).all()


def test_packed_ingest_equals_jax_packed_data():
    """Small columns, full-width felts and words with bit 63 set: the
    port's resident trace holds the JAX package's packed words, bit for
    bit."""
    rng = np.random.default_rng(82)
    n_rows = 32
    cols = [
        [int(v) for v in rng.integers(0, 1 << 16, size=n_rows)],
        [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n_rows)],
        [(1 << 64) - 1 - i for i in range(n_rows)],
        [0, P - 1] * (n_rows // 2),
    ] * 3  # 12 columns: more than one ingest chunk
    trace = TraceTable.from_int_columns(cols, device="cpu")
    jtrace = JTraceTable.from_int_columns(cols)
    assert trace.data.shape == (8, len(cols), n_rows)
    assert np.array_equal(trace.data.numpy().view(np.uint32),
                          np.asarray(jtrace.data))
    assert np.array_equal(trace.unpacked().numpy().astype(np.uint32),
                          np.asarray(jtrace.unpacked()))
    assert trace.to_int_columns() == cols
    assert tfd.to_ints(trace.col(2)) == cols[2]
    assert trace.get_row_ints(7) == [c[7] for c in cols]


def test_keccak_in_passes_of_fewer_messages(monkeypatch):
    """Leaves, nodes and grinding hashes are the same whatever the number
    of messages a Keccak pass takes, and equal the host's digests."""
    rng = np.random.default_rng(83)
    limbs = torch.from_numpy(
        rng.integers(0, 1 << 16, size=(N_LIMBS, 300)).astype(np.int32))
    limbs[N_LIMBS - 1] &= 0x7FF
    whole = kd.hash_felt_leaves(limbs)
    nodes = kd.hash_digest_pairs(whole)
    grind = kd.grinding_batch(b"\x07" * 32, 0, 256, 3, "cpu")
    monkeypatch.setattr(kd, "_ABSORB_CHUNK", 37)
    assert torch.equal(kd.hash_felt_leaves(limbs), whole)
    assert torch.equal(kd.hash_digest_pairs(whole), nodes)
    assert [int(t) for t in kd.grinding_batch(b"\x07" * 32, 0, 256, 3,
                                              "cpu")] == [int(t) for t in grind]
    want = keccak256_batch([v.to_bytes(32, "big")
                            for v in tfd.to_ints(limbs, mont=False)])
    assert [kd.digest_to_bytes(row) for row in whole] == want


def test_round1_fills_packed_buffers_in_place():
    """Main and auxiliary columns go into one packed buffer pair, a chunk of
    columns at a time; unpacked, it holds the whole-domain LDE."""
    trace, pub = generate_prover_args(programs.fibonacci_program(5),
                                      device="cpu")
    air = CairoAIR(trace.n_rows, pub, OPTIONS)
    domain = Domain(air)
    kern = pk.ProverKernels(air, domain, "cpu")
    total = trace.n_cols + air.number_auxiliary_rap_columns()
    bufs = kern.alloc_buffers(total)
    polys, lde, levels = kern.interpolate_commit(trace.data, bufs=bufs)
    assert polys is bufs[0] and lde is bufs[1]
    assert lde.shape == (8, total, domain.lde_size) and lde.dtype == torch.int32
    want_polys = nttc.interpolate_fft(trace.unpacked())
    want_lde = nttc.evaluate_on_lde_domain(
        want_polys, domain.blowup_factor, trace.n_rows, domain.coset_offset)
    assert torch.equal(tfd.unpack(polys[:, :trace.n_cols]), want_polys)
    assert torch.equal(tfd.unpack(lde[:, :trace.n_cols]), want_lde)
    assert all(t.dtype == torch.int32 and t.shape[0] == 8
               for t in kern.tables.values())
    assert levels[-1].shape == (1, 4)


ROUTES = ["packed", "small_chunks", "aux_host", "donate_trace"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_cairo_proof_file_equals_jax(name, route, monkeypatch):
    fixture, make = PROGRAMS[name]
    with open(os.path.join(FIXTURES, fixture), "rb") as f:
        jax_file = f.read()
    if route == "small_chunks":
        # several chunks of every pass, none dividing the domain or the
        # zerofier's period (blowup); the last constraint chunk's halo
        # wraps round to the first points
        monkeypatch.setattr(pk, "_EVAL_CHUNK", 37)
        monkeypatch.setattr(pk, "_DOT_CHUNK", 300)
        monkeypatch.setenv("LCP_COL_CHUNK", "3")
        monkeypatch.setenv("LCP_LEAF_CHUNK", "50")
        monkeypatch.setattr(kd, "_ABSORB_CHUNK", 100)
    elif route == "aux_host":
        monkeypatch.setenv("LCP_AUX_HOST", "1")
    trace, pub = generate_prover_args(make(), device="cpu")
    assert trace.data.shape[0] == 8  # the resident trace is packed
    if route == "small_chunks":
        assert 4 * trace.n_rows % 37 and trace.n_cols % 3
    proof = generate_cairo_proof(trace, pub, OPTIONS, device="cpu",
                                 donate_trace=route == "donate_trace")
    assert (trace.data is None) == (route == "donate_trace")
    assert serde.write_proof_file(proof, pub.serialize()) == jax_file


def test_debug_mem_prints_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("LCP_DEBUG_MEM", "1")
    pub = FibonacciPublicInputs(a0=1, a1=1)
    proof = prove(fibonacci_trace([1, 1], 16, device="cpu"), pub, OPTIONS,
                  FibonacciAIR, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    tags = [ln for ln in lines if ln.startswith("[mem ")]
    assert tags and tags[0].startswith("[mem round0")
    assert all("unavailable: the prove runs on cpu" in ln for ln in tags)
    assert any(ln.startswith("[mem round4") for ln in tags)
    assert verify(proof, pub, OPTIONS, FibonacciAIR)
    if not torch.cuda.is_available():
        _mem("no device")
        assert "unavailable: no CUDA device" in capsys.readouterr().out
    monkeypatch.delenv("LCP_DEBUG_MEM")
    _mem("off", "cpu")
    assert capsys.readouterr().out == ""
