"""The port's on-device FRI commit chain against the host transcript, the
per-layer route and the JAX package, on the CPU.

* The chain's zeta draw (keccak of state || root, 251-bit mask, Montgomery
  form) equals ``transcript_to_field`` of a host ``DefaultTranscript``.
* ``ProverKernels.fri_commit_chain`` equals the per-layer sequence
  (``fri_first_layer``, host draw, ``fri_fold_layer``, ...): roots,
  evaluations, folded coefficients and the final constant, for a partial
  plan and for the full chain, at LDE sizes 2^5 .. 2^12.
* Its output equals the JAX package's ``fri_commit_chain`` on the input
  that ``tools/make_torch_fixtures.py`` (``fri_chain``) recorded.
* A whole proof through the chain equals the proof through the per-layer
  route, which a ``DefaultTranscript`` subclass forces (as in the JAX gate).

Field values and bytes must be equal (tolerance 0)."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu_torch.air.examples import simple_fibonacci as tfib
from lambdaworks_cairo_prover_tpu_torch.field import device as fd
from lambdaworks_cairo_prover_tpu_torch.field.params import N_LIMBS, P
from lambdaworks_cairo_prover_tpu_torch.hash import keccak_device as kd
from lambdaworks_cairo_prover_tpu_torch.interop import (limbs_from_numpy,
                                                        limbs_to_numpy)
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.proof.serde import serialize_proof
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


def host_transcript(state: bytes) -> DefaultTranscript:
    t = DefaultTranscript()
    t._buf = bytearray(state)
    return t


def state_tensor(state: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(state, dtype="<i8").copy())[None]


def kernels(log_rows: int):
    air = tfib.FibonacciAIR(1 << log_rows, PUB, OPTIONS)
    domain = Domain(air)
    return pk.get_kernels(air, domain, "cpu"), domain


def plans(domain: Domain) -> dict:
    """Every fold of the commit phase (the full chain), and its first half."""
    plan, off, ds = [], domain.coset_offset, domain.lde_size
    for _ in range(1, domain.root_order):
        off, ds = off * off % P, ds // 2
        plan.append((off, ds))
    return {"partial": plan[:max(1, len(plan) // 2)], "full": plan}


def random_coeffs(seed: int, n: int) -> torch.Tensor:
    limbs = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(N_LIMBS, n), dtype=np.uint32)
    limbs[N_LIMBS - 1] &= 0x7FF
    return fd.to_mont(limbs_from_numpy(limbs, "cpu"))


def test_device_draw_equals_transcript_to_field():
    rng = np.random.default_rng(70)
    for _ in range(32):
        state, root = rng.bytes(32), rng.bytes(32)
        t = host_transcript(state)
        t.append(root)
        want = transcript_to_field(t)
        digest = kd.hash_digest_pairs(torch.cat([state_tensor(state),
                                                 state_tensor(root)]))
        assert kd.digest_to_bytes(digest[0]) == bytes(t._buf)
        raw = kd.digest_words_to_masked_limbs(digest[0])
        assert torch.equal(raw, fd.from_int(want, mont=False, device="cpu"))
        assert torch.equal(fd.to_mont(raw), fd.from_int(want, device="cpu"))


def per_layer(kern, coeffs, state: bytes, plan, final_fold: bool):
    """The chain's values by the per-layer route: a host draw after each
    root, as prover/prove.py draws zetas without the chain."""
    t = host_transcript(state)
    evals, levels = kern.fri_first_layer(coeffs)
    roots, evals_l = [kd.digest_to_bytes(levels[-1][0])], [evals]
    for off, ds in plan:
        t.append(roots[-1])
        zeta = fd.from_int(transcript_to_field(t), device="cpu")
        coeffs, evals, levels = kern.fri_fold_layer(coeffs, zeta, off, ds)
        roots.append(kd.digest_to_bytes(levels[-1][0]))
        evals_l.append(evals)
    last = None
    if final_fold:
        t.append(roots[-1])
        zeta = transcript_to_field(t)
        c = fd.to_ints(coeffs)
        last = (c[0] + zeta * c[1]) % P
    return roots, evals_l, coeffs, last


@pytest.mark.parametrize("kind", ["partial", "full"])
@pytest.mark.parametrize("log_rows", range(3, 11))  # LDE 2^5 .. 2^12
def test_chain_equals_per_layer(log_rows, kind):
    kern, domain = kernels(log_rows)
    plan = plans(domain)[kind]
    coeffs = random_coeffs(log_rows, 1 << log_rows)
    state = np.random.default_rng(100 + log_rows).bytes(32)
    final = kind == "full"
    rows, evals, levels, last_coeffs = kern.fri_commit_chain(
        coeffs, state_tensor(state), plan, final_fold=final)
    roots, want_evals, want_coeffs, want_last = per_layer(
        kern, coeffs, state, plan, final)
    assert rows.shape == (len(plan) + 1 + final, 4)
    assert [kd.digest_to_bytes(r) for r in rows[:len(plan) + 1]] == roots
    assert len(evals) == len(levels) == len(plan) + 1
    for got, want in zip(evals, want_evals):
        assert torch.equal(got, want)
    assert torch.equal(last_coeffs, want_coeffs)
    if final:
        assert int.from_bytes(rows[-1].numpy().tobytes(), "little") == want_last


def test_chain_equals_jax_fixture():
    with open(os.path.join(FIXTURES, "fri_chain.json")) as f:
        rec = json.load(f)
    rng = np.random.default_rng(rec["seed"])  # as fri_chain_input makes it
    limbs = rng.integers(0, 1 << 16, size=(N_LIMBS, 1 << rec["log_rows"]),
                         dtype=np.uint32)
    limbs[N_LIMBS - 1] &= 0x7FF
    state = rng.bytes(32)
    kern, _ = kernels(rec["log_rows"])

    def sha(t):
        return hashlib.sha256(limbs_to_numpy(t).tobytes()).hexdigest()

    for name in ("partial", "full"):
        want = rec[name]
        plan = [tuple(x) for x in want["plan"]]
        rows, evals, _, last = kern.fri_commit_chain(
            limbs_from_numpy(limbs, "cpu"), state_tensor(state), plan,
            final_fold=want["final_fold"])
        jax_rows = bytes.fromhex(want["roots_hex"])
        n_roots = len(plan) + 1
        assert rows[:n_roots].numpy().tobytes() == jax_rows[:32 * n_roots]
        if want["final_fold"]:
            # the JAX package appends the constant's 16 raw limbs as words
            limbs_jax = np.frombuffer(jax_rows[32 * n_roots:], dtype="<u4")
            assert int.from_bytes(rows[-1].numpy().tobytes(), "little") == \
                fd.to_int(limbs_jax.reshape(N_LIMBS, 1), mont=False)
        assert [sha(e) for e in evals] == want["evals_sha256"]
        assert sha(last) == want["last_coeffs_sha256"]


class _PerLayerTranscript(DefaultTranscript):
    """The same transcript under another type: prove() takes the per-layer
    route for it, as the JAX package's gate does."""


@pytest.mark.parametrize("route", ["full", "partial"])
def test_proof_through_chain_equals_per_layer(monkeypatch, route):
    if route == "partial":  # 2 device folds in the chain, then the host tail
        monkeypatch.setattr(pv, "_FULL_CHAIN_MAX_LOG", 0)
        monkeypatch.setattr(pv, "_HOST_FRI_THRESHOLD", 32)
    calls = []
    chain = pk.ProverKernels.fri_commit_chain

    def spy(self, *args, **kwargs):
        calls.append(kwargs.get("final_fold"))
        return chain(self, *args, **kwargs)

    monkeypatch.setattr(pk.ProverKernels, "fri_commit_chain", spy)
    trace = tfib.fibonacci_trace([1, 1], 64, device="cpu")  # LDE 2^8
    chained = pv.prove(trace, PUB, OPTIONS, tfib.FibonacciAIR, device="cpu")
    assert calls == [route == "full"]
    layered = pv.prove(trace, PUB, OPTIONS, tfib.FibonacciAIR, device="cpu",
                       transcript_factory=_PerLayerTranscript)
    assert len(calls) == 1  # the subclass kept the per-layer route
    assert serialize_proof(chained) == serialize_proof(layered)
    assert verify(chained, PUB, OPTIONS, tfib.FibonacciAIR)
