"""The main path's layout passes, counted: ``fd.unpack`` and ``fd.pack``
count their calls, and a Cairo fib(5) prove on the CPU makes none inside
round 2, DEEP's evaluations or the OOD dot products, where H1/H2 read the
packed LDE, polynomials and domain tables as they lie.  Its proof file is
the JAX package's (tests/fixtures/torch_port/)."""

import os

import torch

from lambdaworks_cairo_prover_tpu_torch.cairo import programs
from lambdaworks_cairo_prover_tpu_torch.cairo.air import generate_cairo_proof
from lambdaworks_cairo_prover_tpu_torch.cairo.runner import generate_prover_args
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.proof import serde
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions
from lambdaworks_cairo_prover_tpu_torch.prover.kernels import ProverKernels

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port")


def test_cairo_fib5_unpacks_nothing_in_round2_deep_or_ood(monkeypatch):
    """The count of fd.unpack calls inside round 2, DEEP's evaluations and
    the OOD dot products of a Cairo fib(5) prove is 0 (round 1 still
    unpacks the trace before the NTT), and the proof file is the JAX
    package's."""
    seen = {}
    for name in ("round2", "_deep_evaluations", "eval_at_powers"):
        orig = getattr(ProverKernels, name)

        def counted(self, *args, _orig=orig, _name=name, **kwargs):
            u0, p0 = tfd.unpack.calls, tfd.pack.calls
            out = _orig(self, *args, **kwargs)
            seen.setdefault(_name, []).append(
                (tfd.unpack.calls - u0, tfd.pack.calls - p0))
            return out
        monkeypatch.setattr(ProverKernels, name, counted)
    options = ProofOptions.default_test_options()
    u0 = tfd.unpack.calls
    trace, pub = generate_prover_args(programs.fibonacci_program(5),
                                      device="cpu")
    proof = generate_cairo_proof(trace, pub, options, device="cpu")
    assert tfd.unpack.calls > u0  # the counter counts
    assert seen["round2"] == [(0, 0)]
    assert seen["_deep_evaluations"] == [(0, 0)]
    assert seen["eval_at_powers"] == [(0, 0)] * 4  # H1, H2, two frame rows
    with open(os.path.join(FIXTURES, "cairo_fib5_test_options.proof"), "rb") as f:
        assert serde.write_proof_file(proof, pub.serialize()) == f.read()
