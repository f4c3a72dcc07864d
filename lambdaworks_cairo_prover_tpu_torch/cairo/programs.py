"""Hand-assembled Cairo0 programs for tests and benchmarks.

The reference repo ships `.cairo` sources compiled by `cairo-compile`
(cairo_programs/cairo0/*.cairo); this environment has no Cairo compiler, so
the canonical workloads (recursive fibonacci, mul, range-check) are assembled
directly from instruction encodings (decode.py).  The resulting programs are
semantically equivalent Cairo machine programs runnable by any Cairo VM."""

from __future__ import annotations

from ..field.params import P
from .decode import (
    AP_ADD1, AP_REGULAR, OP1_SRC_AP, OP1_SRC_FP, OP1_SRC_IMM, OP1_SRC_OP0,
    OPCODE_ASSERT_EQ, OPCODE_CALL, OPCODE_NOP, OPCODE_RET, PC_JNZ, PC_JUMP,
    PC_JUMP_REL, PC_REGULAR, RES_ADD, RES_MUL, RES_OP1, encode_instruction,
)
from .vm import Program

RET = encode_instruction(
    off_dst=-2, off_op0=-1, off_op1=-1, dst_reg=1, op0_reg=1, op1_src=OP1_SRC_FP,
    res_logic=RES_OP1, pc_update=PC_JUMP, ap_update=AP_REGULAR, opcode=OPCODE_RET,
)


def push_imm(value: int) -> list[int]:
    """[ap] = value; ap++   (two cells: instruction + immediate)."""
    inst = encode_instruction(
        off_dst=0, off_op0=-1, off_op1=1, dst_reg=0, op0_reg=1,
        op1_src=OP1_SRC_IMM, res_logic=RES_OP1, pc_update=PC_REGULAR,
        ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ,
    )
    return [inst, value % P]


def copy_fp(off: int) -> int:
    """[ap] = [fp + off]; ap++"""
    return encode_instruction(
        off_dst=0, off_op0=-1, off_op1=off, dst_reg=0, op0_reg=1,
        op1_src=OP1_SRC_FP, res_logic=RES_OP1, pc_update=PC_REGULAR,
        ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ,
    )


def add_fp_fp(off0: int, off1: int) -> int:
    """[ap] = [fp + off0] + [fp + off1]; ap++"""
    return encode_instruction(
        off_dst=0, off_op0=off0, off_op1=off1, dst_reg=0, op0_reg=1,
        op1_src=OP1_SRC_FP, res_logic=RES_ADD, pc_update=PC_REGULAR,
        ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ,
    )


def mul_ap_ap(off0: int, off1: int) -> int:
    """[ap] = [ap + off0] * [ap + off1]; ap++"""
    return encode_instruction(
        off_dst=0, off_op0=off0, off_op1=off1, dst_reg=0, op0_reg=0,
        op1_src=OP1_SRC_AP, res_logic=RES_MUL, pc_update=PC_REGULAR,
        ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ,
    )


def add_fp_imm(off0: int, imm: int) -> list[int]:
    """[ap] = [fp + off0] + imm; ap++"""
    inst = encode_instruction(
        off_dst=0, off_op0=off0, off_op1=1, dst_reg=0, op0_reg=1,
        op1_src=OP1_SRC_IMM, res_logic=RES_ADD, pc_update=PC_REGULAR,
        ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ,
    )
    return [inst, imm % P]


def call_rel(offset: int) -> list[int]:
    inst = encode_instruction(
        off_dst=0, off_op0=1, off_op1=1, dst_reg=0, op0_reg=0,
        op1_src=OP1_SRC_IMM, res_logic=RES_OP1, pc_update=PC_JUMP_REL,
        ap_update=AP_REGULAR, opcode=OPCODE_CALL,
    )
    return [inst, offset % P]


def jnz_fp(dst_off: int, jump_offset: int) -> list[int]:
    """jmp rel jump_offset if [fp + dst_off] != 0"""
    inst = encode_instruction(
        off_dst=dst_off, off_op0=-1, off_op1=1, dst_reg=1, op0_reg=1,
        op1_src=OP1_SRC_IMM, res_logic=RES_OP1, pc_update=PC_JNZ,
        ap_update=AP_REGULAR, opcode=OPCODE_NOP,
    )
    return [inst, jump_offset % P]


def assert_deref_ap(ptr_off: int, val_off: int) -> int:
    """[[ap + ptr_off]] = [ap + val_off]  (writes through a pointer).

    dst = [ap + val_off]; op0 = [ap + ptr_off] (an address); op1 = [op0 + 0].
    """
    return encode_instruction(
        off_dst=val_off, off_op0=ptr_off, off_op1=0, dst_reg=0, op0_reg=0,
        op1_src=OP1_SRC_OP0, res_logic=RES_OP1, pc_update=PC_REGULAR,
        ap_update=AP_REGULAR, opcode=OPCODE_ASSERT_EQ,
    )


def fibonacci_program(n: int) -> Program:
    """Recursive fib(1, 1, n), mirroring cairo_programs/cairo0/fibonacci_*.cairo."""
    data: list[int] = []
    # main:
    data += push_imm(1)            # 0,1
    data += push_imm(1)            # 2,3
    data += push_imm(n)            # 4,5
    data += call_rel(3)            # 6,7 -> fib at 9
    data += [RET]                  # 8
    fib = len(data)                # 9
    assert fib == 9
    data += jnz_fp(-3, 4)          # 9,10 -> body at 13
    data += [copy_fp(-4)]          # 11
    data += [RET]                  # 12
    # body:
    data += [copy_fp(-4)]          # 13: first' = second
    data += [add_fp_fp(-5, -4)]    # 14: second' = first + second
    data += add_fp_imm(-3, P - 1)  # 15,16: n - 1
    data += call_rel(9 - len(data))  # 17,18 -> fib
    data += [RET]                  # 19
    return Program(data=data, main_pc=0, builtins=[])


def simple_program() -> Program:
    """let x=1; let y=2; assert x+y = 3  (cairo0/simple_program.cairo spirit)."""
    data: list[int] = []
    data += push_imm(1)
    data += push_imm(2)
    # [ap] = [ap-2] + [ap-1]; ap++
    data += [
        encode_instruction(
            off_dst=0, off_op0=-2, off_op1=-1, dst_reg=0, op0_reg=0,
            op1_src=OP1_SRC_AP, res_logic=RES_ADD, pc_update=PC_REGULAR,
            ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ,
        )
    ]
    data += [RET]
    return Program(data=data, main_pc=0, builtins=[])


def mul_program() -> Program:
    """let x=2; let y=3; assert x*y = 6."""
    data: list[int] = []
    data += push_imm(2)
    data += push_imm(3)
    data += [mul_ap_ap(-2, -1)]
    data += [RET]
    return Program(data=data, main_pc=0, builtins=[])


def output_program(values=(42, 123)) -> Program:
    """Writes values into the output builtin segment
    (cairo0/output_program.cairo spirit: main{output_ptr}).

    Stack layout at main: [fp-3] = output base pointer."""
    data: list[int] = []
    data += [copy_fp(-3)]           # [ap] = output_ptr; ap++
    for i, v in enumerate(values):
        data += push_imm(v)
        data += [
            encode_instruction(
                off_dst=-1, off_op0=-2 - i, off_op1=i, dst_reg=0,
                op0_reg=0, op1_src=OP1_SRC_OP0, res_logic=RES_OP1,
                pc_update=PC_REGULAR, ap_update=AP_REGULAR,
                opcode=OPCODE_ASSERT_EQ,
            )
        ]
    data += [RET]
    return Program(data=data, main_pc=0, builtins=["output"])


def _deref_write(ptr_ap_off: int, cell: int) -> int:
    """assert [[ap + ptr_ap_off] + cell] = [ap - 1]: writes the just-pushed
    value through the builtin pointer copy (the VM deduces op1 := dst)."""
    return encode_instruction(
        off_dst=-1, off_op0=ptr_ap_off, off_op1=cell, dst_reg=0,
        op0_reg=0, op1_src=OP1_SRC_OP0, res_logic=RES_OP1,
        pc_update=PC_REGULAR, ap_update=AP_REGULAR, opcode=OPCODE_ASSERT_EQ,
    )


def _deref_read(ptr_ap_off: int, cell: int) -> int:
    """[ap] = [[ap + ptr_ap_off] + cell]; ap++: reads a builtin output cell
    (triggering cairo-vm-style deduction) into the execution segment."""
    return encode_instruction(
        off_dst=0, off_op0=ptr_ap_off, off_op1=cell, dst_reg=0,
        op0_reg=0, op1_src=OP1_SRC_OP0, res_logic=RES_OP1,
        pc_update=PC_REGULAR, ap_update=AP_ADD1, opcode=OPCODE_ASSERT_EQ,
    )


def bitwise_program(pairs=((0b1100, 0b1010), (0xFF00FF, 0x0F0F0F))) -> Program:
    """Writes (x, y) pairs into the bitwise builtin segment and reads back
    x&y, x^y, x|y (cells 2..4 of each 5-cell instance, deduced by the VM —
    reference executes these through cairo-vm builtin runners,
    run.rs:76-101; layout must include bitwise, cairo_layout.rs:2-29).

    Stack layout at main: [fp-3] = bitwise base pointer."""
    data: list[int] = []
    data += [copy_fp(-3)]               # ptr at ap slot 0
    ap_off = 1                          # current ap relative to ptr slot
    for i, (x, y) in enumerate(pairs):
        base = 5 * i
        data += push_imm(x)
        ap_off += 1
        data += [_deref_write(-ap_off, base)]
        data += push_imm(y)
        ap_off += 1
        data += [_deref_write(-ap_off, base + 1)]
        for cell in (2, 3, 4):          # read deduced outputs
            data += [_deref_read(-ap_off, base + cell)]
            ap_off += 1
    data += [RET]
    return Program(data=data, main_pc=0, builtins=["bitwise"])


def pedersen_program(pairs=((1, 2), (7, 11))) -> Program:
    """Writes (a, b) pairs into the pedersen builtin segment and reads back
    H(a, b) (cell 2 of each 3-cell instance, deduced via the STARK-curve
    Pedersen hash in builtins.py).

    Stack layout at main: [fp-3] = pedersen base pointer."""
    data: list[int] = []
    data += [copy_fp(-3)]
    ap_off = 1
    for i, (a, b) in enumerate(pairs):
        base = 3 * i
        data += push_imm(a)
        ap_off += 1
        data += [_deref_write(-ap_off, base)]
        data += push_imm(b)
        ap_off += 1
        data += [_deref_write(-ap_off, base + 1)]
        data += [_deref_read(-ap_off, base + 2)]
        ap_off += 1
    data += [RET]
    return Program(data=data, main_pc=0, builtins=["pedersen"])


def ecdsa_program(sigs) -> Program:
    """Writes (pub_key, msg) pairs into the ecdsa signature builtin segment
    (2-cell instances, cairo-vm SignatureBuiltinRunner); each signature
    (r, s) is registered through a pre-instruction hint exactly when the
    real verify_ecdsa_signature hint would run — before the asserts that
    fill the instance (reference proves Small-layout ecdsa programs via
    cairo-vm's signature runner, run.rs:76-101 / cairo_layout.rs:4).

    ``sigs``: iterable of (pub_key, msg, r, s).  Stack layout at main:
    [fp-3] = ecdsa base pointer."""
    sigs = list(sigs)
    data: list[int] = []
    hints: dict[int, object] = {}

    def reg_sig(i, r, s):
        def h(vm, ap, fp):
            base = vm.builtin_bases["ecdsa"]
            vm.add_signature(base + 2 * i, (r, s))
        return h

    data += [copy_fp(-3)]
    ap_off = 1
    for i, (pub, msg, r, s) in enumerate(sigs):
        base = 2 * i
        hints[len(data)] = reg_sig(i, r, s)
        data += push_imm(pub)
        ap_off += 1
        data += [_deref_write(-ap_off, base)]
        data += push_imm(msg)
        ap_off += 1
        data += [_deref_write(-ap_off, base + 1)]
    data += [RET]
    return Program(data=data, main_pc=0, builtins=["ecdsa"], hints=hints)


def keccak_program(inputs=(1, 2, 3, 4, 5, 6, 7, 8)) -> Program:
    """Writes 8x200-bit input felts into one keccak builtin instance and
    reads back the 8 permuted output felts (cells 8..15, deduced via
    keccak-f[1600] — cairo-vm KeccakBuiltinRunner; layouts with keccak:
    starknet_with_keccak / all_cairo, cairo_layout.rs:2-29).

    Stack layout at main: [fp-3] = keccak base pointer."""
    data: list[int] = []
    data += [copy_fp(-3)]
    ap_off = 1
    for i, v in enumerate(inputs):
        data += push_imm(v)
        ap_off += 1
        data += [_deref_write(-ap_off, i)]
    for cell in range(8, 16):
        data += [_deref_read(-ap_off, cell)]
        ap_off += 1
    data += [RET]
    return Program(data=data, main_pc=0, builtins=["keccak"])


def poseidon_program(triples=((1, 2, 3),)) -> Program:
    """Writes (in0, in1, in2) states into the poseidon builtin segment and
    reads back the hades_permutation outputs (cells 3..5 of each 6-cell
    instance — cairo-vm PoseidonBuiltinRunner; starknet layouts,
    cairo_layout.rs:2-29).

    Stack layout at main: [fp-3] = poseidon base pointer."""
    data: list[int] = []
    data += [copy_fp(-3)]
    ap_off = 1
    for i, (a, b, c) in enumerate(triples):
        base = 6 * i
        for j, v in enumerate((a, b, c)):
            data += push_imm(v)
            ap_off += 1
            data += [_deref_write(-ap_off, base + j)]
        for cell in (3, 4, 5):
            data += [_deref_read(-ap_off, base + cell)]
            ap_off += 1
    data += [RET]
    return Program(data=data, main_pc=0, builtins=["poseidon"])


def rc_program(values=(250, 77, 1 << 100)) -> Program:
    """Writes values into the range-check builtin segment
    (cairo0/rc_program.cairo spirit: main{range_check_ptr}).

    Stack layout at main: [fp-3] = range_check base pointer."""
    data: list[int] = []
    data += [copy_fp(-3)]           # [ap] = rc_ptr; ap++
    for i, v in enumerate(values):
        data += push_imm(v)         # [ap] = v; ap++
        # [[rc_ptr + i]] = v:  op0 = rc base copy at some ap slot
        # keep pointer at a known relative position: after pushes, the rc ptr
        # copy sits at ap - (2*i + 2) ... simpler: re-copy pointer each time.
        data += [
            encode_instruction(
                off_dst=-1, off_op0=-2 - i, off_op1=i, dst_reg=0,
                op0_reg=0, op1_src=OP1_SRC_OP0, res_logic=RES_OP1,
                pc_update=PC_REGULAR, ap_update=AP_REGULAR,
                opcode=OPCODE_ASSERT_EQ,
            )
        ]
    data += [RET]
    return Program(data=data, main_pc=0, builtins=["range_check"])
