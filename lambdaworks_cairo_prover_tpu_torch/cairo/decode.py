"""Cairo instruction decoding (reference src/cairo/decode/instruction_flags.rs
and instruction_offsets.rs).

An instruction word is 63 bits:
  off_dst (16, biased) | off_op0 << 16 | off_op1 << 32 | flags << 48
The 15 flag bits group as: dst_reg(1) op0_reg(1) op1_src(3) res_logic(2)
pc_update(3) ap_update(2) opcode(3).  The trace representation of the flags is
simply bit j of the flag field in column j (cols 0..14, col 15 = 0)."""

from __future__ import annotations

from dataclasses import dataclass


class InstructionDecodingError(Exception):
    pass


# flag bit positions (within the 15-bit flags field)
DST_REG_BIT = 0
OP0_REG_BIT = 1
OP1_SRC_OFF, OP1_SRC_MASK = 2, 0b111
RES_LOGIC_OFF, RES_LOGIC_MASK = 5, 0b11
PC_UPDATE_OFF, PC_UPDATE_MASK = 7, 0b111
AP_UPDATE_OFF, AP_UPDATE_MASK = 10, 0b11
OPCODE_OFF, OPCODE_MASK = 12, 0b111

# group values (one-hot or zero)
OP1_SRC_OP0, OP1_SRC_IMM, OP1_SRC_FP, OP1_SRC_AP = 0, 1, 2, 4
RES_OP1, RES_ADD, RES_MUL, RES_UNCONSTRAINED = 0, 1, 2, 4
PC_REGULAR, PC_JUMP, PC_JUMP_REL, PC_JNZ = 0, 1, 2, 4
AP_REGULAR, AP_ADD, AP_ADD1, AP_ADD2 = 0, 1, 2, 4
OPCODE_NOP, OPCODE_CALL, OPCODE_RET, OPCODE_ASSERT_EQ = 0, 1, 2, 4

_VALID = {
    "op1_src": {0, 1, 2, 4},
    "res_logic": {0, 1, 2},
    "pc_update": {0, 1, 2, 4},
    "ap_update": {0, 1, 2},
    "opcode": {0, 1, 2, 4},
}


@dataclass
class InstructionFlags:
    dst_reg: int
    op0_reg: int
    op1_src: int
    res_logic: int
    pc_update: int
    ap_update: int
    opcode: int

    @classmethod
    def decode(cls, instruction: int) -> "InstructionFlags":
        word = instruction & ((1 << 64) - 1)
        flags = word >> 48
        if flags >> 15:
            raise InstructionDecodingError("instruction flags exceed 15 bits")
        f = cls(
            dst_reg=(flags >> DST_REG_BIT) & 1,
            op0_reg=(flags >> OP0_REG_BIT) & 1,
            op1_src=(flags >> OP1_SRC_OFF) & OP1_SRC_MASK,
            res_logic=(flags >> RES_LOGIC_OFF) & RES_LOGIC_MASK,
            pc_update=(flags >> PC_UPDATE_OFF) & PC_UPDATE_MASK,
            ap_update=(flags >> AP_UPDATE_OFF) & AP_UPDATE_MASK,
            opcode=(flags >> OPCODE_OFF) & OPCODE_MASK,
        )
        if f.op1_src not in _VALID["op1_src"]:
            raise InstructionDecodingError("invalid op1_src")
        if f.res_logic not in _VALID["res_logic"]:
            raise InstructionDecodingError("invalid res_logic")
        if f.pc_update not in _VALID["pc_update"]:
            raise InstructionDecodingError("invalid pc_update")
        if f.ap_update not in _VALID["ap_update"]:
            raise InstructionDecodingError("invalid ap_update")
        if f.opcode not in _VALID["opcode"]:
            raise InstructionDecodingError("invalid opcode")
        return f

    def to_trace_representation(self) -> list[int]:
        """16 bit-columns f0..f15 (f15 always 0)."""
        flags = (
            (self.dst_reg << DST_REG_BIT)
            | (self.op0_reg << OP0_REG_BIT)
            | (self.op1_src << OP1_SRC_OFF)
            | (self.res_logic << RES_LOGIC_OFF)
            | (self.pc_update << PC_UPDATE_OFF)
            | (self.ap_update << AP_UPDATE_OFF)
            | (self.opcode << OPCODE_OFF)
        )
        return [(flags >> j) & 1 for j in range(16)]


@dataclass
class InstructionOffsets:
    off_dst: int  # signed, in [-2^15, 2^15)
    off_op0: int
    off_op1: int

    @classmethod
    def decode(cls, instruction: int) -> "InstructionOffsets":
        word = instruction & ((1 << 64) - 1)

        def off(shift):
            raw = (word >> shift) & 0xFFFF
            return raw - (1 << 15)

        return cls(off(0), off(16), off(32))

    def to_trace_representation(self) -> list[int]:
        """Unbiased offsets in [0, 2^16) (whitepaper section 9.4)."""
        b15 = 1 << 15
        return [self.off_dst + b15, self.off_op0 + b15, self.off_op1 + b15]


def encode_instruction(
    off_dst=0, off_op0=-1, off_op1=1, dst_reg=0, op0_reg=0, op1_src=0,
    res_logic=0, pc_update=0, ap_update=0, opcode=0,
) -> int:
    """Assemble a 63-bit Cairo instruction word."""
    b15 = 1 << 15
    assert all(-b15 <= o < b15 for o in (off_dst, off_op0, off_op1))
    flags = (
        dst_reg | (op0_reg << 1) | (op1_src << OP1_SRC_OFF)
        | (res_logic << RES_LOGIC_OFF) | (pc_update << PC_UPDATE_OFF)
        | (ap_update << AP_UPDATE_OFF) | (opcode << OPCODE_OFF)
    )
    return (
        (off_dst + b15) | ((off_op0 + b15) << 16) | ((off_op1 + b15) << 32)
        | (flags << 48)
    )
