"""The PyTorch port's Cairo0 hint processor against the JAX package, on the
CPU: the reference-expression parser, every hint case of the JAX package's
``tests/test_hints_stdlib.py``, ``tests/test_hint_crypto.py`` and
``tests/test_hints.py`` run in both packages' VMs (equal outcomes, memory
and scopes afterwards), and the hinted stdlib programs on both VMs.

Every comparison is exact."""

import json
import os

import pytest

from lambdaworks_cairo_prover_tpu.cairo import hints as jhints
from lambdaworks_cairo_prover_tpu.cairo import stdlib as jstdlib
from lambdaworks_cairo_prover_tpu.cairo import vm as jvm
from lambdaworks_cairo_prover_tpu_torch.cairo import hints as thints
from lambdaworks_cairo_prover_tpu_torch.cairo import runner as trunner
from lambdaworks_cairo_prover_tpu_torch.cairo import stdlib as tstdlib
from lambdaworks_cairo_prover_tpu_torch.cairo import vm as tvm

import torch_parity as tp

# the cases of tests/test_hints.py that prove are left to the fixture tests
HINT_CASES = (tp.cases("test_hints_stdlib") + tp.cases("test_hint_crypto")
              + tp.cases("test_hints", exclude=("test_hinted_program_proves",)))
# the cases of plain functions: no VM to compare
HOST_ONLY = ("test_blake2s_compress_matches_hashlib",
             "test_sha256_compress_matches_hashlib",
             "test_parse_reference_values", "test_hints_parse_from_compiled_json",
             "test_struct_typed_references_load_lazily")
# (generator, arguments): the hinted programs of cairo/stdlib.py
PROGRAMS = {
    "lt_comparison": ("lt_comparison_program", ()),
    "signed_div_rem": ("signed_div_rem_program", ()),
    "compare_lesser_array_10": ("compare_lesser_array_program", (10,)),
    "compare_lesser_array_1200": ("compare_lesser_array_program", (1200,)),
}
REFERENCE_VALUES = [
    "cast(fp + (-3), felt*)",
    "[cast(ap + 2, felt*)]",
    "[cast([fp + (-6)] + 1, felt*)]",
    "cast(ap, felt**)",
    "[cast(fp + (-3), starkware.cairo.common.cairo_builtins"
    ".SignatureBuiltin**)]",
    "cast(ap + (-1), starkware.cairo.common.cairo_builtins.HashBuiltin*)",
    "cast([fp + (-4)] + 2, my.pkg.Struct*)",
    "[cast(fp + 7, starkware.cairo.common.squash_dict.LoopTemps*)]",
    "[cast(ap + (-1) + 2, felt*)]",
]


def _regs(regs):
    return [(r.pc, r.ap, r.fp) for r in regs.rows]


@pytest.mark.parametrize("value", REFERENCE_VALUES)
def test_parse_reference_value_matches_jax(value):
    assert thints.parse_reference_value(value) == (
        jhints.parse_reference_value(value))


@pytest.mark.parametrize("case", HINT_CASES, ids=tp.case_id)
def test_hint_case_matches_jax(case):
    """The same case, run once with each package's modules: it passes in
    the JAX package, and the outcome and the final memory, hint scopes and
    signatures of every VM it made are equal."""
    tp.check_case(case, no_vm=HOST_ONLY)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_hinted_program_vm_matches_jax(name):
    gen, args = PROGRAMS[name]
    jprog = getattr(jstdlib, gen)(*args)
    tprog = getattr(tstdlib, gen)(*args)
    assert tprog.data == jprog.data and tprog.builtins == jprog.builtins
    assert {pc: [h.code for h in hs] for pc, hs in tprog.hints.items()} == {
        pc: [h.code for h in hs] for pc, hs in jprog.hints.items()}
    jregs, jmem, jsize, jranges = jvm.run_program(jprog)
    vm_name, tregs, tmem, tsize, tranges = trunner.run_vm(tprog)
    assert vm_name == "python"
    assert _regs(tregs) == _regs(jregs)
    assert tmem.data == jmem.data
    assert (tsize, tranges) == (jsize, jranges)


def test_compiled_json_hints_parse_as_in_jax():
    a = tstdlib.Asm()
    a.label("main")
    a.hint(thints.IS_NN, {"a": "[cast(fp + (-3), felt*)]"})
    a.hint(thints.IS_NN_OUT_OF_RANGE, {"a": "[cast(ap + (-1), felt*)]"})
    a.push_imm(7)
    a.ret()
    built = a.finish("main", [])
    built["identifiers"] = {"__main__.main": {"pc": 0}}
    text = json.dumps(built)
    tprog, jprog = tvm.Program.from_json(text), jvm.Program.from_json(text)
    assert tprog.data == jprog.data
    assert [[(h.code, h.reference_ids) for h in hs]
            for hs in tprog.hints.values()] == [
        [(h.code, h.reference_ids) for h in hs] for hs in jprog.hints.values()]
    assert [(r.value, r.ast) for r in tprog.references] == [
        (r.value, r.ast) for r in jprog.references]


def test_unknown_hint_raises_in_the_vm():
    prog = tvm.Program(data=[0x208b7fff7fff7ffe], main_pc=0,
                       hints={0: [thints.Hint(code="print('nope')")]},
                       references=[])
    with pytest.raises(thints.UnknownHintError):
        tvm.CairoVM(prog).run()
    assert issubclass(thints.UnknownHintError, thints.HintError)


def test_cli_proves_a_hinted_json(tmp_path, monkeypatch):
    """``lt_comparison`` as compiled JSON (hints and reference manager)
    through the command line: the proof file equals the JAX package's."""
    from lambdaworks_cairo_prover_tpu_torch import cli

    built = {}
    finish = tstdlib.Asm.finish

    def record(self, main, builtins):
        built["json"] = finish(self, main, builtins)
        return built["json"]

    monkeypatch.setattr(tstdlib.Asm, "finish", record)
    tstdlib.lt_comparison_program()
    path, out = tmp_path / "lt_comparison.json", str(tmp_path / "lt.proof")
    path.write_text(json.dumps(built["json"]))
    assert cli.main(["prove", str(path), out, "--device", "cpu"]) == 0
    want = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                        "cairo_lt_comparison_test_options.proof")
    with open(out, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
