"""The PyTorch port's builtin runners (``cairo/builtins.py``) and the VM's
deduction and ecdsa paths against the JAX package, on the CPU: the builtin
functions on the same inputs made from a seed with numpy (equal ints), the
six builtin programs on both VMs (equal registers, relocated memory and
builtin ranges), the host-side cases of the JAX package's builtin tests run
with each package's modules, and the layouts."""

import numpy as np
import pytest

from lambdaworks_cairo_prover_tpu.cairo import builtins as jb
from lambdaworks_cairo_prover_tpu.cairo import programs as jprograms
from lambdaworks_cairo_prover_tpu.cairo import runner as jrunner
from lambdaworks_cairo_prover_tpu.cairo import vm as jvm
from lambdaworks_cairo_prover_tpu_torch.cairo import builtins as tb
from lambdaworks_cairo_prover_tpu_torch.cairo import programs as tprograms
from lambdaworks_cairo_prover_tpu_torch.cairo import runner as trunner
from lambdaworks_cairo_prover_tpu_torch.cairo import vm as tvm

import torch_parity as tp

P = tb.P
# the key, message and nonce of tests/test_ecdsa_builtin.py
PRIV, MSG, K = 0x12345678ABCDEF, 0xDEADBEEFCAFE, 0x6789ABCDEF012345
# name -> (generator, layout); the ecdsa program gets the signature below
PROGRAMS = {
    "output": ("output_program", "Small"),
    "bitwise": ("bitwise_program", "Recursive"),
    "pedersen": ("pedersen_program", "Small"),
    "ecdsa": ("ecdsa_program", "Small"),
    "keccak": ("keccak_program", "StarknetWithKeccak"),
    "poseidon": ("poseidon_program", "Starknet"),
}
# the host-side cases; the proving ones are left to the fixture tests
HOST_CASES = (
    tp.cases("test_builtin_prove", exclude=("test_bitwise_program_proves",
                                            "test_pedersen_program_proves"))
    + tp.cases("test_ecdsa_builtin",
               exclude=("test_ecdsa_prove_verify_small_layout",))
    + tp.cases("test_keccak_poseidon_builtin",
               exclude=("test_keccak_prove_verify",
                        "test_poseidon_prove_verify")))
# the cases of plain functions: no VM to compare
HOST_ONLY = ("test_pedersen_canonical_vector",
             "test_ec_op_matches_pedersen_structure",
             "test_gen_on_curve_and_order", "test_sqrt_mod_p_roundtrip",
             "test_sign_verify_roundtrip", "test_keccak_permute_matches_lanes",
             "test_keccak_zero_state_nonzero_output",
             "test_keccak_input_range_check", "test_poseidon_regression_vector")


def _signature():
    r, s = tb.ecdsa_sign(PRIV, MSG, K)
    return tb._ec_mul(PRIV, tb.EC_GEN)[0], MSG, r, s


def _program(module, name):
    gen, _ = PROGRAMS[name]
    args = ([_signature()],) if name == "ecdsa" else ()
    return getattr(module, gen)(*args)


def _felts(rng, n, bits=251):
    return [int.from_bytes(rng.bytes(32), "little") % min(P, 1 << bits)
            for _ in range(n)]


def test_pedersen_and_ec_op_match_jax():
    rng = np.random.default_rng(300)
    for a, b in zip(_felts(rng, 6), _felts(rng, 6)):
        assert tb.pedersen_hash(a, b) == jb.pedersen_hash(a, b)
    for m in _felts(rng, 4):
        p, q = tb.SHIFT_POINT, tb.PEDERSEN_POINTS[int(m % 4)]
        assert tb.ec_op(p[0], p[1], q[0], q[1], m) == (
            jb.ec_op(p[0], p[1], q[0], q[1], m))


def test_keccak_and_hades_permutations_match_jax():
    rng = np.random.default_rng(301)
    for _ in range(4):
        state = _felts(rng, 8, bits=200)
        assert tb.keccak_builtin_permute(state) == (
            jb.keccak_builtin_permute(state))
        triple = _felts(rng, 3)
        assert tb.hades_permutation(triple) == jb.hades_permutation(triple)


def test_sqrt_and_recover_y_match_jax():
    rng = np.random.default_rng(302)
    for v in _felts(rng, 8):
        assert tb.sqrt_mod_p(v) == jb.sqrt_mod_p(v)
        assert tb.recover_y(v) == jb.recover_y(v)


def test_ecdsa_sign_and_verify_match_jax():
    rng = np.random.default_rng(303)
    for priv, msg, k in zip(_felts(rng, 3, 240), _felts(rng, 3, 240),
                            _felts(rng, 3, 240)):
        rs = tb.ecdsa_sign(priv, msg, k)
        assert rs == jb.ecdsa_sign(priv, msg, k)
        pub = tb._ec_mul(priv, tb.EC_GEN)[0]
        for args in [(pub, msg, *rs), (pub, msg + 1, *rs),
                     (pub, msg, rs[0], rs[1] + 1)]:
            assert tb.verify_ecdsa(*args) == jb.verify_ecdsa(*args)


def test_deducers_cover_the_same_builtins():
    assert sorted(tb.DEDUCERS) == sorted(jb.DEDUCERS)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_builtin_program_vm_matches_jax(name):
    jprog, tprog = _program(jprograms, name), _program(tprograms, name)
    assert (tprog.data, tprog.builtins) == (jprog.data, jprog.builtins)
    jregs, jmem, jsize, jranges = jvm.run_program(jprog)
    vm_name, tregs, tmem, tsize, tranges = trunner.run_vm(tprog)
    assert vm_name == ("native" if name == "output" and
                       trunner.native_vm.available() else "python")
    assert [(r.pc, r.ap, r.fp) for r in tregs.rows] == [
        (r.pc, r.ap, r.fp) for r in jregs.rows]
    assert tmem.data == jmem.data
    assert (tsize, tranges) == (jsize, jranges)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_builtin_program_layout_as_in_jax(name):
    _, layout = PROGRAMS[name]
    prog = _program(tprograms, name)
    trunner.validate_layout(prog, trunner.CairoLayout[layout])
    for other in trunner.CairoLayout:
        try:
            jrunner.validate_layout(_program(jprograms, name),
                                    jrunner.CairoLayout[other.name])
        except jvm.CairoVMError:
            with pytest.raises(tvm.CairoVMError):
                trunner.validate_layout(prog, other)
        else:
            trunner.validate_layout(prog, other)


def test_bitwise_input_too_wide_raises():
    with pytest.raises(tvm.CairoVMError, match="251"):
        tvm.run_program(tprograms.bitwise_program(pairs=((1 << 251, 1),)))


@pytest.mark.parametrize("case", HOST_CASES, ids=tp.case_id)
def test_builtin_case_matches_jax(case):
    tp.check_case(case, no_vm=HOST_ONLY)
