"""Hand-assembled Cairo0 stdlib functions and the reference's hinted test
programs, emitted in the compiled-JSON format (with real `hints` and
`reference_manager` sections) so the full hint-parsing path is exercised.

The reference proves these workloads through cairo-vm's builtin hint
processor (reference tests/integration_tests.rs:120-147: `lt_comparison`,
`compare_lesser_array`, `signed_div_rem`; sources
cairo_programs/cairo0/*.cairo).  This environment has no `cairo-compile`,
so the starkware stdlib functions they pull in (`alloc`, `is_nn`, `is_le`,
`assert_nn`, `assert_le`, `signed_div_rem`) are assembled here directly
from instruction encodings with their canonical hint strings attached —
semantically equivalent Cairo machine programs, runnable by any Cairo VM
with stdlib hint support.
"""

from __future__ import annotations

import json

from ..field.params import P
from .decode import (
    AP_ADD, AP_ADD1, AP_REGULAR, OP1_SRC_AP, OP1_SRC_FP, OP1_SRC_IMM,
    OP1_SRC_OP0, OPCODE_ASSERT_EQ, OPCODE_CALL, OPCODE_NOP, OPCODE_RET,
    PC_JNZ, PC_JUMP, PC_JUMP_REL, PC_REGULAR, RES_ADD, RES_MUL, RES_OP1,
    encode_instruction,
)
from . import hints as H
from .vm import Program

_AP, _FP = 0, 1  # register selector for helpers below


class Asm:
    """Tiny Cairo0 assembler with labels, calls, and hint attachment.

    Emits a compiled-JSON-shaped dict (`finish`) whose `hints` /
    `reference_manager` sections round-trip through `Program.from_json` and
    the hint processor, exactly like cairo-compile output.
    """

    def __init__(self):
        self.data: list[int] = []
        self.labels: dict[str, int] = {}
        self._fixups: list[tuple[int, str]] = []  # (imm index, label)
        self._hints: dict[int, list[dict]] = {}
        self._references: list[dict] = []

    # -- structure ----------------------------------------------------------

    def label(self, name: str) -> None:
        self.labels[name] = len(self.data)

    def hint(self, code: str, ids: dict[str, str] | None = None) -> None:
        """Attach a hint at the CURRENT pc (before the next instruction).

        ``ids``: short name -> reference `value` string, e.g.
        ``{"a": "[cast(fp + (-3), felt*)]"}``."""
        ref_ids = {}
        for name, value in (ids or {}).items():
            ref_ids[f"__asm__.{name}"] = len(self._references)
            self._references.append({
                "value": value,
                "ap_tracking_data": {"group": 0, "offset": 0},
                "pc": len(self.data),
            })
        self._hints.setdefault(len(self.data), []).append({
            "code": code,
            "flow_tracking_data": {
                "ap_tracking": {"group": 0, "offset": 0},
                "reference_ids": ref_ids,
            },
            "accessible_scopes": ["__asm__"],
        })

    def _emit(self, **kw) -> None:
        self.data.append(encode_instruction(**kw))

    # -- pushes (write [ap], ap++) ------------------------------------------

    def push_imm(self, v: int) -> None:
        """[ap] = imm; ap++"""
        self._emit(off_dst=0, off_op0=-1, off_op1=1, dst_reg=0, op0_reg=1,
                   op1_src=OP1_SRC_IMM, res_logic=RES_OP1,
                   ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ)
        self.data.append(v % P)

    def copy(self, reg: int, off: int) -> None:
        """[ap] = [reg + off]; ap++"""
        self._emit(off_dst=0, off_op0=-1, off_op1=off, dst_reg=0, op0_reg=1,
                   op1_src=OP1_SRC_FP if reg == _FP else OP1_SRC_AP,
                   res_logic=RES_OP1, ap_update=AP_ADD1,
                   opcode=OPCODE_ASSERT_EQ)

    def add_imm(self, reg: int, off: int, imm: int) -> None:
        """[ap] = [reg + off] + imm; ap++"""
        self._emit(off_dst=0, off_op0=off, off_op1=1, dst_reg=0,
                   op0_reg=1 if reg == _FP else 0, op1_src=OP1_SRC_IMM,
                   res_logic=RES_ADD, ap_update=AP_ADD1,
                   opcode=OPCODE_ASSERT_EQ)
        self.data.append(imm % P)

    def mul_imm(self, reg: int, off: int, imm: int) -> None:
        """[ap] = [reg + off] * imm; ap++"""
        self._emit(off_dst=0, off_op0=off, off_op1=1, dst_reg=0,
                   op0_reg=1 if reg == _FP else 0, op1_src=OP1_SRC_IMM,
                   res_logic=RES_MUL, ap_update=AP_ADD1,
                   opcode=OPCODE_ASSERT_EQ)
        self.data.append(imm % P)

    def add(self, reg0: int, off0: int, reg1: int, off1: int) -> None:
        """[ap] = [reg0 + off0] + [reg1 + off1]; ap++"""
        self._emit(off_dst=0, off_op0=off0, off_op1=off1, dst_reg=0,
                   op0_reg=1 if reg0 == _FP else 0,
                   op1_src=OP1_SRC_FP if reg1 == _FP else OP1_SRC_AP,
                   res_logic=RES_ADD, ap_update=AP_ADD1,
                   opcode=OPCODE_ASSERT_EQ)

    def mul(self, reg0: int, off0: int, reg1: int, off1: int) -> None:
        """[ap] = [reg0 + off0] * [reg1 + off1]; ap++"""
        self._emit(off_dst=0, off_op0=off0, off_op1=off1, dst_reg=0,
                   op0_reg=1 if reg0 == _FP else 0,
                   op1_src=OP1_SRC_FP if reg1 == _FP else OP1_SRC_AP,
                   res_logic=RES_MUL, ap_update=AP_ADD1,
                   opcode=OPCODE_ASSERT_EQ)

    def sub_to_ap(self, dreg: int, doff: int, oreg: int, ooff: int) -> None:
        """[ap] = [dreg + doff] - [oreg + ooff]; ap++  — encoded the way
        cairo-compile does subtraction: [dreg+doff] = [ap] + [oreg+ooff]
        with op0 = [ap] deduced by the VM."""
        self._emit(off_dst=doff, off_op0=0, off_op1=ooff,
                   dst_reg=1 if dreg == _FP else 0, op0_reg=0,
                   op1_src=OP1_SRC_FP if oreg == _FP else OP1_SRC_AP,
                   res_logic=RES_ADD, ap_update=AP_ADD1,
                   opcode=OPCODE_ASSERT_EQ)

    def deref_to_ap(self, preg: int, poff: int, idx: int = 0) -> None:
        """[ap] = [[preg + poff] + idx]; ap++"""
        self._emit(off_dst=0, off_op0=poff, off_op1=idx, dst_reg=0,
                   op0_reg=1 if preg == _FP else 0, op1_src=OP1_SRC_OP0,
                   res_logic=RES_OP1, ap_update=AP_ADD1,
                   opcode=OPCODE_ASSERT_EQ)

    # -- asserts (no ap change) --------------------------------------------

    def assert_deref(self, preg: int, poff: int, idx: int,
                     vreg: int, voff: int) -> None:
        """[[preg + poff] + idx] = [vreg + voff]  (write through pointer)."""
        self._emit(off_dst=voff, off_op0=poff, off_op1=idx,
                   dst_reg=1 if vreg == _FP else 0,
                   op0_reg=1 if preg == _FP else 0, op1_src=OP1_SRC_OP0,
                   res_logic=RES_OP1, ap_update=AP_REGULAR,
                   opcode=OPCODE_ASSERT_EQ)

    def assert_eq(self, dreg: int, doff: int, vreg: int, voff: int) -> None:
        """[dreg + doff] = [vreg + voff]  (set if unknown, check if known)."""
        self._emit(off_dst=doff, off_op0=-1, off_op1=voff,
                   dst_reg=1 if dreg == _FP else 0, op0_reg=1,
                   op1_src=OP1_SRC_FP if vreg == _FP else OP1_SRC_AP,
                   res_logic=RES_OP1, ap_update=AP_REGULAR,
                   opcode=OPCODE_ASSERT_EQ)

    def assert_imm(self, dreg: int, doff: int, imm: int) -> None:
        """[dreg + doff] = imm"""
        self._emit(off_dst=doff, off_op0=-1, off_op1=1,
                   dst_reg=1 if dreg == _FP else 0, op0_reg=1,
                   op1_src=OP1_SRC_IMM, res_logic=RES_OP1,
                   ap_update=AP_REGULAR, opcode=OPCODE_ASSERT_EQ)
        self.data.append(imm % P)

    def assert_sum(self, dreg: int, doff: int, r0: int, o0: int,
                   r1: int, o1: int) -> None:
        """[dreg + doff] = [r0 + o0] + [r1 + o1]"""
        self._emit(off_dst=doff, off_op0=o0, off_op1=o1,
                   dst_reg=1 if dreg == _FP else 0,
                   op0_reg=1 if r0 == _FP else 0,
                   op1_src=OP1_SRC_FP if r1 == _FP else OP1_SRC_AP,
                   res_logic=RES_ADD, ap_update=AP_REGULAR,
                   opcode=OPCODE_ASSERT_EQ)

    # -- control flow -------------------------------------------------------

    def ap_add(self, imm: int) -> None:
        """ap += imm"""
        self._emit(off_dst=-1, off_op0=-1, off_op1=1, dst_reg=1, op0_reg=1,
                   op1_src=OP1_SRC_IMM, res_logic=RES_OP1,
                   pc_update=PC_REGULAR, ap_update=AP_ADD,
                   opcode=OPCODE_NOP)
        self.data.append(imm % P)

    def jnz(self, target: str, reg: int, off: int, inc_ap: bool) -> None:
        """jmp rel <target> if [reg + off] != 0 (optionally ap++)."""
        self._emit(off_dst=off, off_op0=-1, off_op1=1,
                   dst_reg=1 if reg == _FP else 0, op0_reg=1,
                   op1_src=OP1_SRC_IMM, res_logic=RES_OP1,
                   pc_update=PC_JNZ,
                   ap_update=AP_ADD1 if inc_ap else AP_REGULAR,
                   opcode=OPCODE_NOP)
        self._fixups.append((len(self.data), target))
        self.data.append(0)

    def jmp(self, target: str) -> None:
        self._emit(off_dst=-1, off_op0=-1, off_op1=1, dst_reg=1, op0_reg=1,
                   op1_src=OP1_SRC_IMM, res_logic=RES_OP1,
                   pc_update=PC_JUMP_REL, ap_update=AP_REGULAR,
                   opcode=OPCODE_NOP)
        self._fixups.append((len(self.data), target))
        self.data.append(0)

    def call(self, target: str) -> None:
        self._emit(off_dst=0, off_op0=1, off_op1=1, dst_reg=0, op0_reg=0,
                   op1_src=OP1_SRC_IMM, res_logic=RES_OP1,
                   pc_update=PC_JUMP_REL, ap_update=AP_REGULAR,
                   opcode=OPCODE_CALL)
        self._fixups.append((len(self.data), target))
        self.data.append(0)

    def ret(self) -> None:
        self._emit(off_dst=-2, off_op0=-1, off_op1=-1, dst_reg=1, op0_reg=1,
                   op1_src=OP1_SRC_FP, res_logic=RES_OP1,
                   pc_update=PC_JUMP, ap_update=AP_REGULAR,
                   opcode=OPCODE_RET)

    # -- output -------------------------------------------------------------

    def finish(self, main: str, builtins: list[str]) -> dict:
        """Resolve fixups; return a compiled-JSON-shaped dict."""
        for imm_idx, target in self._fixups:
            # relative jump offsets are measured from the instruction pc
            self.data[imm_idx] = (self.labels[target] - (imm_idx - 1)) % P
        return {
            "data": [hex(w) for w in self.data],
            "builtins": builtins,
            "identifiers": {"__main__.main": {"pc": self.labels[main]}},
            "hints": {
                str(pc): hl for pc, hl in sorted(self._hints.items())
            },
            "reference_manager": {"references": self._references},
            "prime": hex(P),
        }

    def program(self, main: str, builtins: list[str]) -> Program:
        return Program.from_json(json.dumps(self.finish(main, builtins)))


# ---------------------------------------------------------------------------
# stdlib function bodies (appended into a program's Asm)
# ---------------------------------------------------------------------------


def emit_assert_nn(a: Asm) -> None:
    """assert_nn{range_check_ptr}(a): args rc=[fp-4], a=[fp-3]; returns rc'.

    starkware.cairo.common.math.assert_nn with its value-check hint."""
    a.label("assert_nn")
    a.hint(H.ASSERT_NN, {"a": "[cast(fp + (-3), felt*)]"})
    a.assert_deref(_FP, -4, 0, _FP, -3)   # [rc] = a  (range check)
    a.add_imm(_FP, -4, 1)                 # push rc + 1
    a.ret()


def emit_assert_le(a: Asm) -> None:
    """assert_le{rc}(a, b) = assert_nn(b - a): rc=[fp-5] a=[fp-4] b=[fp-3]."""
    a.label("assert_le")
    a.sub_to_ap(_FP, -3, _FP, -4)         # [ap] = b - a
    a.copy(_FP, -5)                       # rc
    a.copy(_AP, -2)                       # b - a
    a.call("assert_nn")
    a.ret()


def emit_is_nn(a: Asm) -> None:
    """is_nn{rc}(a) -> felt: rc=[fp-4], a=[fp-3]; returns (rc', 0|1).

    starkware.cairo.common.math_cmp.is_nn, both range-check branches; the
    out-of-both-ranges tail (assert_le_felt in the stdlib) is unreachable
    for range-checked workloads and assembled as a hard failure."""
    a.label("is_nn")
    a.hint(H.IS_NN, {"a": "[cast(fp + (-3), felt*)]"})
    a.jnz("is_nn_oor", _AP, 0, inc_ap=True)
    a.assert_deref(_FP, -4, 0, _FP, -3)   # [rc] = a
    a.add_imm(_FP, -4, 1)                 # rc' = rc + 1
    a.push_imm(1)
    a.ret()
    a.label("is_nn_oor")
    a.hint(H.IS_NN_OUT_OF_RANGE, {"a": "[cast(fp + (-3), felt*)]"})
    a.jnz("is_nn_trap", _AP, 0, inc_ap=True)
    a.mul_imm(_FP, -3, P - 1)             # [ap] = -a
    a.add_imm(_AP, -1, P - 1)             # [ap] = -a - 1
    a.assert_deref(_FP, -4, 0, _AP, -1)   # [rc] = -a - 1
    a.add_imm(_FP, -4, 1)                 # rc'
    a.push_imm(0)
    a.ret()
    a.label("is_nn_trap")
    a.push_imm(0)
    a.assert_imm(_AP, -1, 1)              # 0 = 1: unreachable branch trap


def emit_is_le(a: Asm) -> None:
    """is_le{rc}(a, b) = is_nn(b - a): rc=[fp-5], a=[fp-4], b=[fp-3]."""
    a.label("is_le")
    a.sub_to_ap(_FP, -3, _FP, -4)         # [ap] = b - a
    a.copy(_FP, -5)                       # rc
    a.copy(_AP, -2)                       # b - a
    a.call("is_nn")
    a.ret()


def emit_alloc(a: Asm) -> None:
    """alloc() -> (ptr): starkware.cairo.common.alloc.alloc."""
    a.label("alloc")
    a.hint(H.ADD_SEGMENT)
    a.ap_add(1)                           # the hint wrote [ap]
    a.copy(_AP, -1)                       # return the new segment pointer
    a.ret()


def emit_signed_div_rem(a: Asm) -> None:
    """signed_div_rem{rc}(value, div, bound) -> (q, r).

    rc=[fp-6], value=[fp-5], div=[fp-4], bound=[fp-3]; r and biased_q live
    in the range-check segment at [rc] and [rc+1] (written by the hint),
    rc' = rc + 4 after the two assert_le range checks."""
    a.label("signed_div_rem")
    a.hint(H.SIGNED_DIV_REM, {
        "value": "[cast(fp + (-5), felt*)]",
        "div": "[cast(fp + (-4), felt*)]",
        "bound": "[cast(fp + (-3), felt*)]",
        "r": "[cast([fp + (-6)], felt*)]",
        "biased_q": "[cast([fp + (-6)] + 1, felt*)]",
    })
    a.deref_to_ap(_FP, -6, 1)             # fp+0: biased_q
    a.sub_to_ap(_AP, -1, _FP, -3)         # fp+1: q = biased_q - bound
    a.mul(_AP, -1, _FP, -4)               # fp+2: q * div
    a.deref_to_ap(_FP, -6, 0)             # fp+3: r
    a.assert_sum(_FP, -5, _AP, -2, _AP, -1)  # value = q*div + r
    a.add_imm(_FP, -4, P - 1)             # fp+4: div - 1
    a.add_imm(_FP, -6, 2)                 # fp+5: rc + 2
    a.copy(_AP, -3)                       # fp+6: r        (arg a)
    a.copy(_AP, -3)                       # fp+7: div - 1  (arg b)
    a.call("assert_le")                   # assert_le(r, div - 1)
    # returns rc+3 at [ap-1]
    a.mul_imm(_FP, -3, 2)                 # 2 * bound
    a.add_imm(_AP, -1, P - 1)             # 2*bound - 1
    a.copy(_AP, -3)                       # rc+3
    a.copy(_FP, 0)                        # biased_q
    a.copy(_AP, -3)                       # 2*bound - 1
    a.call("assert_le")                   # assert_le(biased_q, 2*bound - 1)
    # returns rc+4 at [ap-1]
    a.copy(_AP, -1)                       # rc' = rc + 4
    a.copy(_FP, 1)                        # q
    a.copy(_FP, 3)                        # r
    a.ret()


# ---------------------------------------------------------------------------
# The three hinted reference workloads
# ---------------------------------------------------------------------------


def lt_comparison_program() -> Program:
    """cairo_programs/cairo0/lt_comparison.cairo: is_le(2, 6) == 1."""
    a = Asm()
    emit_assert_nn(a)
    emit_is_nn(a)
    emit_is_le(a)
    a.label("main")                       # rc=[fp-3]
    a.copy(_FP, -3)
    a.push_imm(2)
    a.push_imm(6)
    a.call("is_le")
    a.assert_imm(_AP, -1, 1)              # assert result = 1
    a.ret()
    return a.program("main", ["range_check"])


def compare_lesser_array_program(length: int = 10) -> Program:
    """cairo_programs/cairo0/compare_lesser_array.cairo: fills two arrays
    (base 5 step 2 / base 7 step 3) via alloc() and recursively checks
    a[i] <= b[i] for all i."""
    a = Asm()
    emit_assert_nn(a)
    emit_is_nn(a)
    emit_is_le(a)
    emit_alloc(a)

    # fill_array(array, base, step, length, iterator):
    #   args [fp-7..fp-3]
    a.label("fill_array")
    a.sub_to_ap(_FP, -4, _FP, -3)         # [ap] = length - iterator
    a.jnz("fill_body", _AP, -1, inc_ap=False)
    a.ret()
    a.label("fill_body")
    a.mul(_FP, -5, _FP, -3)               # step * iterator
    a.add(_FP, -6, _AP, -1)               # base + step*iterator
    a.add(_FP, -7, _FP, -3)               # &array[iterator]
    a.assert_deref(_AP, -1, 0, _AP, -2)   # array[iterator] = value
    a.copy(_FP, -7)
    a.copy(_FP, -6)
    a.copy(_FP, -5)
    a.copy(_FP, -4)
    a.add_imm(_FP, -3, 1)
    a.call("fill_array")
    a.ret()

    # compare_lesser_array{rc}(a, b, length, iterator) -> (r):
    #   rc=[fp-7], a=[fp-6], b=[fp-5], length=[fp-4], iterator=[fp-3]
    a.label("cla")
    a.sub_to_ap(_FP, -4, _FP, -3)         # [ap] = length - iterator
    a.jnz("cla_body", _AP, -1, inc_ap=False)
    a.copy(_FP, -7)                       # rc
    a.push_imm(1)                         # TRUE
    a.ret()
    a.label("cla_body")
    a.add(_FP, -6, _FP, -3)               # &a[it]
    a.deref_to_ap(_AP, -1)                # a[it]
    a.add(_FP, -5, _FP, -3)               # &b[it]
    a.deref_to_ap(_AP, -1)                # b[it]
    a.copy(_FP, -7)                       # rc
    a.copy(_AP, -4)                       # a[it]
    a.copy(_AP, -3)                       # b[it]
    a.call("is_le")
    a.jnz("cla_rec", _AP, -1, inc_ap=False)
    a.copy(_AP, -2)                       # rc'
    a.push_imm(0)                         # FALSE
    a.ret()
    a.label("cla_rec")
    a.copy(_AP, -2)                       # rc'
    a.copy(_FP, -6)
    a.copy(_FP, -5)
    a.copy(_FP, -4)
    a.add_imm(_FP, -3, 1)
    a.call("cla")
    a.ret()

    a.label("main")                       # rc=[fp-3]; locals len/a/b at fp+0..2
    a.ap_add(3)
    a.assert_imm(_FP, 0, length)
    a.call("alloc")
    a.assert_eq(_FP, 1, _AP, -1)          # array_a
    a.call("alloc")
    a.assert_eq(_FP, 2, _AP, -1)          # array_b
    a.copy(_FP, 1)
    a.push_imm(5)
    a.push_imm(2)
    a.copy(_FP, 0)
    a.push_imm(0)
    a.call("fill_array")
    a.copy(_FP, 2)
    a.push_imm(7)
    a.push_imm(3)
    a.copy(_FP, 0)
    a.push_imm(0)
    a.call("fill_array")
    a.copy(_FP, -3)                       # rc
    a.copy(_FP, 1)
    a.copy(_FP, 2)
    a.copy(_FP, 0)
    a.push_imm(0)
    a.call("cla")
    a.assert_imm(_AP, -1, 1)              # assert result = TRUE
    a.ret()
    return a.program("main", ["range_check"])


def signed_div_rem_program() -> Program:
    """cairo_programs/cairo0/signed_div_rem.cairo: signed_div_rem(-10,3,29)
    twice (stdlib + "manual" twin share one body here), equality asserts,
    output of the four words, then the (10,3,29) pair."""
    a = Asm()
    emit_assert_nn(a)
    emit_assert_le(a)
    emit_signed_div_rem(a)
    a.label("main")                       # output=[fp-4], rc=[fp-3]
    a.ap_add(6)                           # locals q1 r1 q2 r2 q3 r3
    a.copy(_FP, -3)                       # rc
    a.push_imm(P - 10)                    # value = -10
    a.push_imm(3)
    a.push_imm(29)
    a.call("signed_div_rem")
    a.assert_eq(_FP, 0, _AP, -2)          # q1
    a.assert_eq(_FP, 1, _AP, -1)          # r1
    a.copy(_AP, -3)                       # rc'
    a.push_imm(P - 10)
    a.push_imm(3)
    a.push_imm(29)
    a.call("signed_div_rem")
    a.assert_eq(_FP, 2, _AP, -2)          # q2
    a.assert_eq(_FP, 3, _AP, -1)          # r2
    a.assert_eq(_FP, 0, _FP, 2)           # assert q1 = q2
    a.assert_eq(_FP, 1, _FP, 3)           # assert r1 = r2
    # serialize_word x4: output[i] = q1, q2, r1, r2
    a.assert_deref(_FP, -4, 0, _FP, 0)
    a.assert_deref(_FP, -4, 1, _FP, 2)
    a.assert_deref(_FP, -4, 2, _FP, 1)
    a.assert_deref(_FP, -4, 3, _FP, 3)
    a.copy(_AP, -3)                       # rc''
    a.push_imm(10)                        # value = 10
    a.push_imm(3)
    a.push_imm(29)
    a.call("signed_div_rem")
    a.assert_eq(_FP, 4, _AP, -2)          # q3
    a.assert_eq(_FP, 5, _AP, -1)          # r3
    a.copy(_AP, -3)
    a.push_imm(10)
    a.push_imm(3)
    a.push_imm(29)
    a.call("signed_div_rem")
    a.assert_eq(_FP, 4, _AP, -2)          # assert q3 = q4
    a.assert_eq(_FP, 5, _AP, -1)          # assert r3 = r4
    a.ret()
    return a.program("main", ["output", "range_check"])
