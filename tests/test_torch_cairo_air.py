"""The PyTorch port's Cairo AIR on the CPU: the device RAP (auxiliary trace)
build against both host oracles, the sort it rests on, and the transition
constraints in their scalar and their batched branch.

The RAP build runs the field ops that the H1/H2 kernels carry on a card; on
the CPU they take their plain versions.  Challenges are fixed numbers, other
inputs come from the programs of ``cairo/programs.py`` or from a numpy seed.
Every comparison is exact: limbs and integers must be equal."""

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu.cairo import air as jair
from lambdaworks_cairo_prover_tpu.cairo import programs as jprograms
from lambdaworks_cairo_prover_tpu.cairo import runner as jrunner
from lambdaworks_cairo_prover_tpu.proof.options import ProofOptions as JOptions
from lambdaworks_cairo_prover_tpu_torch.air.frame import DeviceFrame, HostFrame
from lambdaworks_cairo_prover_tpu_torch.cairo import air as tair
from lambdaworks_cairo_prover_tpu_torch.cairo import programs as tprograms
from lambdaworks_cairo_prover_tpu_torch.cairo import runner as trunner
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.field.params import P
from lambdaworks_cairo_prover_tpu_torch.interop import trace_from_numpy
from lambdaworks_cairo_prover_tpu_torch.proof.options import ProofOptions

torch.set_num_threads(1)

RC_VALUES = (250, 77, 1 << 100)
CHALLENGES = (0x1234567 * 3**100 % P, 0x7654321 * 5**90 % P, 7**80 % P)
OPTIONS = ProofOptions.default_test_options()
PROGRAMS = {"fib5": ("fibonacci_program", (5,)),
            "rc": ("rc_program", (RC_VALUES,)),
            "simple": ("simple_program", ())}


def _port(name):
    gen, args = PROGRAMS[name]
    trace, pub = trunner.generate_prover_args(
        getattr(tprograms, gen)(*args), device="cpu")
    return trace, pub, tair.CairoAIR(trace.n_rows, pub, OPTIONS)


@pytest.mark.parametrize("name", ["fib5", "rc"])
def test_device_rap_build_equals_both_host_oracles(name):
    trace, _, air = _port(name)
    aux = air.build_auxiliary_trace(trace, CHALLENGES)
    assert aux.data.shape == (16, 18, trace.n_rows)
    host = air.build_auxiliary_trace_host(trace, CHALLENGES)
    assert torch.equal(aux.data, host.unpacked())

    gen, args = PROGRAMS[name]
    jtrace, jpub = jrunner.generate_prover_args(getattr(jprograms, gen)(*args))
    jaux = jair.CairoAIR(jtrace.n_rows, jpub,
                         JOptions.default_test_options()
                         ).build_auxiliary_trace_host(jtrace, CHALLENGES)
    assert torch.equal(aux.data,
                       trace_from_numpy(np.asarray(jaux.data), "cpu").unpacked())


def _seeded_addresses(rng, m):
    """Canonical addresses below 2^64 with ties, values above 2^32 and
    values with bit 63 set (where a signed 64-bit order would go wrong)."""
    pool = np.concatenate([
        rng.integers(0, 50, size=m // 4, dtype=np.uint64),
        rng.integers(1 << 32, (1 << 32) + 50, size=m // 4, dtype=np.uint64),
        rng.integers(1 << 63, (1 << 63) + 50, size=m // 4, dtype=np.uint64),
        rng.integers(0, 1 << 64, size=m - 3 * (m // 4), dtype=np.uint64),
    ])
    return [int(v) for v in rng.permutation(pool)]


def test_stable_sort_is_unsigned_and_keeps_ties_in_order():
    import jax.numpy as jnp

    rng = np.random.default_rng(200)
    addrs = _seeded_addresses(rng, 256)
    assert len(set(addrs)) < len(addrs)
    canon = tfd.from_ints(addrs, mont=False, device="cpu")
    perm = tair._stable_sort_u64(canon).tolist()
    want = sorted(range(len(addrs)), key=lambda i: addrs[i])  # stable
    assert perm == want
    jperm = jair._stable_sort_u64(jnp.asarray(canon.numpy().astype(np.uint32)))
    assert perm == np.asarray(jperm).tolist()


def test_memory_argument_on_seeded_addresses_equals_python_ints():
    rng = np.random.default_rng(201)
    n = 32
    addrs = _seeded_addresses(rng, 4 * n)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in addrs]
    alpha, z, _ = CHALLENGES
    a = tfd.from_ints(addrs, device="cpu")
    v = tfd.from_ints(vals, device="cpu")
    got = tair._aux_mem_kernel(a, v, a, v, tfd.from_int(z, device="cpu"),
                               tfd.from_int(alpha, device="cpu"), n)

    pairs = sorted(zip(addrs, vals), key=lambda t: t[0])
    perm, prod = [], 1
    for (a0, v0), (a1, v1) in zip(zip(addrs, vals), pairs):
        prod = (prod * (z - (a0 + alpha * v0)) % P
                * pow((z - (a1 + alpha * v1)) % P, P - 2, P) % P)
        perm.append(prod)
    flat = [p[0] for p in pairs], [p[1] for p in pairs], perm
    want = [seq[k::4] for seq in flat for k in range(4)]
    assert got.shape == (16, 12, n)
    assert tfd.to_ints(got.reshape(16, -1)) == [x for col in want for x in col]


def _full_rows(name):
    trace, pub, air = _port(name)
    full = trace.concatenate(air.build_auxiliary_trace(trace, CHALLENGES))
    cols = full.to_int_columns()
    rows = [[c[i] for c in cols] for i in range(full.n_rows)]
    return full, rows, air


@pytest.mark.parametrize("name", ["fib5", "rc"])
def test_scalar_transition_vanishes_on_a_valid_trace(name):
    _, rows, air = _full_rows(name)
    n = len(rows)
    exempt = air.context.transition_exemptions
    assert len(exempt) == air.context.num_transition_constraints
    for i in range(n):
        frame = HostFrame([rows[i], rows[(i + 1) % n]])
        evals = air.compute_transition(
            frame, air.wrap_rap_challenges(frame.ctx, CHALLENGES))
        assert len(evals) == len(exempt)
        for k, ev in enumerate(evals):
            if i >= n - exempt[k]:
                continue
            assert ev.v == 0, (i, k)
    # a broken cell is seen
    bad = [list(rows[2]), rows[3]]
    bad[0][tair.FRAME_RES] = (bad[0][tair.FRAME_RES] + 1) % P
    frame = HostFrame(bad)
    evals = air.compute_transition(
        frame, air.wrap_rap_challenges(frame.ctx, CHALLENGES))
    assert any(ev.v for ev in evals)


@pytest.mark.parametrize("name", ["simple", "rc"])
def test_batched_transition_equals_scalar(name):
    """The whole-domain branch (stacked multiplies) against the scalar one,
    on every row of a trace whose cells were also shifted by seeded noise, so
    that the constraints take non-zero values."""
    full, _, air = _full_rows(name)
    rng = np.random.default_rng(202)
    noise = tfd.from_ints(
        [int.from_bytes(rng.bytes(32), "little") % P
         for _ in range(full.n_cols * full.n_rows)], device="cpu")
    data = tfd.add(full.data, noise.reshape(full.data.shape))
    n = full.n_rows
    assert n == {"simple": 8, "rc": 16}[name]
    flat = tfd.to_ints(data.reshape(16, -1))
    rows = [[flat[c * n + i] for c in range(full.n_cols)] for i in range(n)]

    frame = DeviceFrame(data, air.context.transition_offsets, blowup=1)
    rap = tuple(tfd.from_int(c, device="cpu") for c in CHALLENGES)
    evals = air.compute_transition(
        frame, air.wrap_rap_challenges(frame.ctx, rap))
    got = [tfd.to_ints(ev.v.expand(16, n)) for ev in evals]
    assert len(got) == air.context.num_transition_constraints
    for i in range(n):
        hframe = HostFrame([rows[i], rows[(i + 1) % n]])
        want = air.compute_transition(
            hframe, air.wrap_rap_challenges(hframe.ctx, CHALLENGES))
        assert [g[i] for g in got] == [w.v for w in want], i
    assert any(any(g) for g in got)
