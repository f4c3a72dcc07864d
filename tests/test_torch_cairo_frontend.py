"""The PyTorch port's Cairo frontend against the JAX package, module by
module, on the CPU: instruction decode, the python and the native VM, the
main-trace build, the public inputs' wire format and the compact trace
ingest.

Inputs are the hand-assembled programs of ``cairo/programs.py`` or are made
from a seed with numpy.  Every comparison is exact: integers, limbs and
bytes must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

from lambdaworks_cairo_prover_tpu.cairo import decode as jdecode
from lambdaworks_cairo_prover_tpu.cairo import native as jnative
from lambdaworks_cairo_prover_tpu.cairo import programs as jprograms
from lambdaworks_cairo_prover_tpu.cairo import runner as jrunner
from lambdaworks_cairo_prover_tpu.cairo import vm as jvm
from lambdaworks_cairo_prover_tpu.cairo.air import PublicInputs as JPublicInputs
from lambdaworks_cairo_prover_tpu_torch.air.trace import TraceTable
from lambdaworks_cairo_prover_tpu_torch.cairo import decode as tdecode
from lambdaworks_cairo_prover_tpu_torch.cairo import native as tnative
from lambdaworks_cairo_prover_tpu_torch.cairo import programs as tprograms
from lambdaworks_cairo_prover_tpu_torch.cairo import runner as trunner
from lambdaworks_cairo_prover_tpu_torch.cairo import vm as tvm
from lambdaworks_cairo_prover_tpu_torch.cairo.air import PublicInputs
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.field.params import P
from lambdaworks_cairo_prover_tpu_torch.interop import (
    limbs_to_numpy, public_inputs_from_jax, trace_from_numpy)
from lambdaworks_cairo_prover_tpu_torch.prover.prove import ProvingError

torch.set_num_threads(1)

RC_VALUES = (250, 77, 1 << 100)
# name -> (generator, arguments); the programs this slice runs
PROGRAMS = {
    "simple": ("simple_program", ()),
    "mul": ("mul_program", ()),
    "fib5": ("fibonacci_program", (5,)),
    "fib50": ("fibonacci_program", (50,)),
    "output": ("output_program", ()),
    "rc": ("rc_program", (RC_VALUES,)),
}


def _both(name):
    gen, args = PROGRAMS[name]
    return getattr(jprograms, gen)(*args), getattr(tprograms, gen)(*args)


def _same_run(jres, tres):
    jregs, jmem, jsize, jranges = jres
    tregs, tmem, tsize, tranges = tres
    assert [(r.pc, r.ap, r.fp) for r in jregs.rows] == [
        (r.pc, r.ap, r.fp) for r in tregs.rows]
    assert jmem.data == tmem.data
    assert jsize == tsize
    assert jranges == tranges


# -- decode -------------------------------------------------------------------


def test_decode_round_trip_matches_jax():
    rng = np.random.default_rng(100)
    valid = {"op1_src": (0, 1, 2, 4), "res_logic": (0, 1, 2),
             "pc_update": (0, 1, 2, 4), "ap_update": (0, 1, 2),
             "opcode": (0, 1, 2, 4)}
    for _ in range(200):
        kw = {k: int(rng.choice(v)) for k, v in valid.items()}
        kw.update(dst_reg=int(rng.integers(2)), op0_reg=int(rng.integers(2)))
        kw.update({k: int(rng.integers(-(1 << 15), 1 << 15))
                   for k in ("off_dst", "off_op0", "off_op1")})
        word = tdecode.encode_instruction(**kw)
        assert word == jdecode.encode_instruction(**kw)
        flags = tdecode.InstructionFlags.decode(word)
        offs = tdecode.InstructionOffsets.decode(word)
        assert dataclasses.asdict(flags) == dataclasses.asdict(
            jdecode.InstructionFlags.decode(word))
        assert dataclasses.asdict(offs) == dataclasses.asdict(
            jdecode.InstructionOffsets.decode(word))
        assert flags.to_trace_representation() == (
            jdecode.InstructionFlags.decode(word).to_trace_representation())
        assert tdecode.encode_instruction(
            **dataclasses.asdict(flags), **dataclasses.asdict(offs)) == word


def test_decode_rejects_what_jax_rejects():
    rng = np.random.default_rng(101)
    words = [int(w) for w in rng.integers(0, 1 << 63, size=300, dtype=np.uint64)]
    for word in words + [1 << 63]:
        try:
            expect = dataclasses.asdict(jdecode.InstructionFlags.decode(word))
        except jdecode.InstructionDecodingError:
            with pytest.raises(tdecode.InstructionDecodingError):
                tdecode.InstructionFlags.decode(word)
        else:
            assert dataclasses.asdict(
                tdecode.InstructionFlags.decode(word)) == expect


# -- the VMs ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_python_vm_matches_jax(name):
    jprog, tprog = _both(name)
    assert (jprog.data, jprog.main_pc, jprog.builtins) == (
        tprog.data, tprog.main_pc, tprog.builtins)
    _same_run(jvm.run_program(jprog), tvm.run_program(tprog))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_native_vm_matches_jax_and_python(name):
    jprog, tprog = _both(name)
    assert tnative.available() == jnative.available()
    if not tnative.available():
        pytest.skip("native/libcairo_vm.so is not built")
    native = tnative.run_program_native(tprog)
    _same_run(jnative.run_program_native(jprog), native)
    _same_run(tvm.run_program(tprog), native)
    assert trunner.run_vm(tprog)[0] == "native"


@pytest.mark.parametrize("gen", ["bitwise_program", "pedersen_program",
                                 "keccak_program", "poseidon_program"])
def test_deduction_builtins_name_the_missing_module(gen):
    """Programs with deduction builtins, which raised before
    cairo/builtins.py was ported, run on the python VM as in the JAX
    package."""
    jprog = getattr(jprograms, gen)()
    vm_name, *tres = trunner.run_vm(getattr(tprograms, gen)())
    assert vm_name == "python"
    _same_run(jvm.run_program(jprog), tres)


def test_hinted_json_and_cairo1_name_the_missing_module():
    """A compiled program with hints and a Cairo1 contract class, which
    raised before cairo/hints.py and cairo/casm.py were ported, load and
    run as in the JAX package."""
    import json
    import os

    prog = tprograms.fibonacci_program(3)
    obj = {"data": [hex(x) for x in prog.data], "builtins": [],
           "identifiers": {"__main__.main": {"pc": 0}},
           "hints": {"0": [{"code": "memory[ap] = 1",
                            "flow_tracking_data": {
                                "reference_ids": {}}}]}}
    hinted = tvm.Program.from_json(json.dumps(obj))
    jhinted = jvm.Program.from_json(json.dumps(obj))
    assert hinted.data == jhinted.data == prog.data
    assert [[h.code for h in hs] for hs in hinted.hints.values()] == [
        [h.code for h in hs] for hs in jhinted.hints.values()] == [
        ["memory[ap] = 1"]]
    obj["hints"] = {}
    assert tvm.Program.from_json(json.dumps(obj)).data == prog.data
    with open(os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_port", "synthetic_contract.casm"),
              "rb") as f:
        contract = f.read()
    ttrace, tpub = trunner.generate_prover_args(
        contract, device="cpu", cairo_version=trunner.CairoVersion.V1)
    jtrace, jpub = jrunner.generate_prover_args(
        contract, cairo_version=jrunner.CairoVersion.V1)
    assert ttrace.to_int_columns() == jtrace.to_int_columns()
    assert tpub.serialize() == jpub.serialize()


def test_layout_validation_matches_jax():
    for layout in trunner.CairoLayout:
        assert layout.builtins == jrunner.CairoLayout[layout.name].builtins
    prog = tprograms.rc_program((3,))
    trunner.validate_layout(prog, trunner.CairoLayout.Small)
    with pytest.raises(tvm.CairoVMError):
        trunner.validate_layout(prog, trunner.CairoLayout.Plain)


def test_entry_points_ask_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(ProvingError, match="CUDA"):
        trunner.generate_prover_args(tprograms.fibonacci_program(5))


# -- main trace and public inputs --------------------------------------------


@pytest.fixture(scope="module", params=["fib5", "rc", "output"])
def prover_args(request):
    """(JAX trace, JAX public inputs, port trace, port public inputs)."""
    jprog, tprog = _both(request.param)
    jtrace, jpub = jrunner.generate_prover_args(jprog)
    ttrace, tpub = trunner.generate_prover_args(tprog, device="cpu")
    return jtrace, jpub, ttrace, tpub


def test_main_trace_matches_jax(prover_args):
    jtrace, _, ttrace, _ = prover_args
    assert (ttrace.n_cols, ttrace.n_rows) == (jtrace.n_cols, jtrace.n_rows)
    assert ttrace.to_int_columns() == jtrace.to_int_columns()
    # both traces are resident in the packed (8, ...) layout
    carried = trace_from_numpy(np.asarray(jtrace.data), "cpu")
    assert torch.equal(carried.data, ttrace.data)
    assert np.array_equal(limbs_to_numpy(ttrace.unpacked()),
                          np.asarray(jtrace.unpacked()))
    assert ttrace.get_row_ints(3) == jtrace.get_row_ints(3)
    assert set(ttrace._timings) == {"vm", "vm_name", "trace_build", "ingest"}


def test_public_inputs_match_jax(prover_args):
    _, jpub, _, tpub = prover_args
    assert tpub.range_check_min is not None
    assert dataclasses.asdict(tpub) == dataclasses.asdict(jpub)
    data = tpub.serialize()
    assert data == jpub.serialize()
    assert public_inputs_from_jax(jpub).serialize() == data
    back = PublicInputs.deserialize(data)
    assert dataclasses.asdict(back) == dataclasses.asdict(tpub)
    assert list(back.public_memory) == list(tpub.public_memory)
    assert back.serialize() == data
    assert dataclasses.asdict(JPublicInputs.deserialize(data)) == (
        dataclasses.asdict(back))


def test_trace_file_ingestion_matches_program_run(tmp_path):
    prog = tprograms.fibonacci_program(5)
    regs, mem, size, _ = tvm.run_program(prog)
    (tmp_path / "fib.trace").write_bytes(regs.to_bytes_le())
    (tmp_path / "fib.memory").write_bytes(mem.to_bytes_le())
    ttrace, tpub = trunner.generate_prover_args_from_trace_files(
        str(tmp_path / "fib.trace"), str(tmp_path / "fib.memory"), size,
        device="cpu")
    want, want_pub = trunner.generate_prover_args(prog, device="cpu")
    assert torch.equal(ttrace.data, want.data)
    assert tpub.serialize() == want_pub.serialize()


# -- compact ingest -----------------------------------------------------------


def test_compact_ingest_equals_host_montgomery_form():
    """Columns that fit 64 bits and full-width felts, mixed, against the
    host conversion (python ints -> Montgomery limbs)."""
    rng = np.random.default_rng(102)
    n_rows = 32

    def felts():
        return [int.from_bytes(rng.bytes(32), "little") % P
                for _ in range(n_rows)]

    cols = [
        [int(v) for v in rng.integers(0, 2, size=n_rows)],
        felts(),
        [int(v) for v in rng.integers(0, 1 << 63, size=n_rows, dtype=np.uint64)],
        [(1 << 64) - 1 - i for i in range(n_rows)],     # bit 63 set
        [0, P - 1] * (n_rows // 2),
        felts(),
        [int(v) for v in rng.integers(0, 1 << 16, size=n_rows)],
    ]
    trace = TraceTable.from_int_columns(cols, device="cpu")
    want = tfd.from_ints([v for col in cols for v in col], device="cpu")
    assert torch.equal(trace.unpacked(), want.reshape(16, len(cols), n_rows))
    assert trace.to_int_columns() == cols
    assert tfd.to_ints(trace.col(3)) == cols[3]
    both = trace.concatenate(TraceTable.from_int_columns(cols[:2], device="cpu"))
    assert both.n_cols == len(cols) + 2
    assert both.get_row_ints(5) == [c[5] for c in cols + cols[:2]]
