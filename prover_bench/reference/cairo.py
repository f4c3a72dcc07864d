"""The statement a Cairo proof must prove, worked out from the program
alone, and the Cairo AIR that the verifier holds the proof to.

- `encode`: the Cairo0 instruction word, for the programs under
  `programs/`, each assembled there.
- `run(program)`: a Cairo VM for programs without builtins or hints: the
  public inputs of its run (registers at the first and last step, the
  step count, the offsets' range, the program as public memory).
- `CairoAir`: the 49 transition and 8 boundary constraints over the 34 main
  and 18 auxiliary columns of the Cairo AIR without the range-check builtin
  (lambdaworks `src/cairo/air.rs`), evaluated at one frame.

Nothing here comes from the prover under test."""

from __future__ import annotations

from dataclasses import dataclass

from .stark import P

B15 = 1 << 15

# instruction flags (Cairo whitepaper, section 4.5)
OP1_IMM, OP1_FP, OP1_AP = 1, 2, 4
RES_ADD, RES_MUL = 1, 2
PC_ABS, PC_REL, PC_JNZ = 1, 2, 4
AP_ADD, AP_ADD1 = 1, 2
CALL, RET, ASSERT_EQ = 1, 2, 4


def encode(off_dst, off_op0, off_op1, dst_fp, op0_fp, op1_src, res, pc_up,
           ap_up, opcode) -> int:
    flags = (dst_fp | op0_fp << 1 | op1_src << 2 | res << 5 | pc_up << 7
             | ap_up << 10 | opcode << 12)
    return ((off_dst + B15) | (off_op0 + B15) << 16 | (off_op1 + B15) << 32
            | flags << 48)


@dataclass(frozen=True)
class Statement:
    pc_init: int
    ap_init: int
    pc_final: int
    ap_final: int
    num_steps: int
    rc_min: int
    rc_max: int
    public_memory: tuple  # ((address, value), ...) by address


class VMError(Exception):
    pass


def run(program: list[int], max_steps: int = 1 << 26) -> Statement:
    """Run ``program`` (loaded at address 1, entry at its start) to the
    final return, as the Cairo runner lays it out: the execution segment
    follows the program, its first two cells hold the caller's fp and the
    return address, and ap = fp start after them."""
    mem = {a + 1: v for a, v in enumerate(program)}
    end = len(program) + 1          # the return address: past the program
    base = len(program) + 1
    mem[base], mem[base + 1] = base + 2, end
    pc, ap, fp = 1, base + 2, base + 2
    decoded = {}
    rc_min, rc_max = 1 << 16, -1
    steps = 0
    last = None
    while pc != end:
        if steps >= max_steps:
            raise VMError(f"no end after {max_steps} steps")
        d = decoded.get(pc)
        if d is None:
            w = mem[pc]
            if w >> 63:
                raise VMError(f"bad instruction at {pc}")
            offs = (w & 0xFFFF, (w >> 16) & 0xFFFF, (w >> 32) & 0xFFFF)
            f = w >> 48
            d = decoded[pc] = (offs[0] - B15, offs[1] - B15, offs[2] - B15,
                               f & 1, f >> 1 & 1, f >> 2 & 7, f >> 5 & 3,
                               f >> 7 & 7, f >> 10 & 3, f >> 12 & 7,
                               min(offs), max(offs))
        (o_dst, o_op0, o_op1, dst_fp, op0_fp, op1_src, res_l, pc_up, ap_up,
         opcode, lo, hi) = d
        rc_min, rc_max = min(rc_min, lo), max(rc_max, hi)
        last = (pc, ap)
        steps += 1
        dst_addr = (fp if dst_fp else ap) + o_dst
        op0_addr = (fp if op0_fp else ap) + o_op0
        size = 2 if op1_src == OP1_IMM else 1
        if opcode == CALL:
            mem[dst_addr], mem[op0_addr] = fp, pc + size
        op0 = mem.get(op0_addr)
        if op1_src == OP1_IMM:
            op1 = mem[pc + 1]
        elif op1_src == OP1_FP:
            op1 = mem[fp + o_op1]
        elif op1_src == OP1_AP:
            op1 = mem[ap + o_op1]
        else:
            op1 = mem[op0 + o_op1]
        res = (op0 + op1) % P if res_l == RES_ADD else (
            op0 * op1 % P if res_l == RES_MUL else op1)
        if opcode == ASSERT_EQ:
            if dst_addr in mem and mem[dst_addr] != res:
                raise VMError(f"assertion fails at pc {pc}")
            mem[dst_addr] = res
        dst = mem.get(dst_addr)
        if pc_up == PC_ABS:
            new_pc = res
        elif pc_up == PC_REL:
            new_pc = (pc + res) % P
        elif pc_up == PC_JNZ:
            new_pc = (pc + op1) % P if dst else pc + size
        else:
            new_pc = pc + size
        if opcode == CALL:
            fp, ap = ap + 2, ap + 2
        elif opcode == RET:
            fp = dst
        if ap_up == AP_ADD:
            ap += res
        elif ap_up == AP_ADD1:
            ap += 1
        pc = new_pc
    return Statement(pc_init=1, ap_init=base + 2, pc_final=last[0],
                     ap_final=last[1], num_steps=steps, rc_min=rc_min,
                     rc_max=rc_max,
                     public_memory=tuple((a + 1, v % P)
                                         for a, v in enumerate(program)))


# -- the AIR ----------------------------------------------------------------

# main columns: 16 flags, then the registers and memory accesses
(F_DST_FP, F_OP0_FP, F_OP1_VAL, F_OP1_FP, F_OP1_AP, F_RES_ADD, F_RES_MUL,
 F_PC_ABS, F_PC_REL, F_PC_JNZ, F_AP_ADD, F_AP_ONE, F_CALL, F_RET,
 F_AEQ) = range(15)
RES, AP, FP, PC, DST_ADDR, OP0_ADDR, OP1_ADDR, INST, DST, OP0, OP1 = range(
    16, 27)
OFF_DST, OFF_OP0, OFF_OP1, T0, T1, MUL, SELECTOR = range(27, 34)
# auxiliary columns (after the 34 main ones)
RC1, RC2, RC3 = 34, 35, 36
ADDR_SORTED = (37, 38, 39, 40)
VAL_SORTED = (41, 42, 43, 44)
PERM = (45, 46, 47, 48)
RC_PERM = (49, 50, 51)


@dataclass(frozen=True)
class Boundary:
    col: int
    step: int
    value: int


class CairoAir:
    main_columns = 34
    columns = 52
    num_rap_challenges = 3  # alpha and z of memory, z of range checks
    transition_degrees = ([2] * 15 + [1] + [3] * 15 + [2] * 18)
    # the register updates, and the last of each memory and range-check
    # group, read the next row: they are exempt at the last row
    transition_exemptions = ([0] * 20 + [1, 1, 1, 1, 0, 0] + [0] * 5
                             + [0, 0, 0, 1] * 3 + [0, 0, 1] + [0, 0, 0])

    def __init__(self, statement: Statement, trace_length: int):
        if statement.num_steps > trace_length:
            raise ValueError("more steps than trace rows")
        self.s = statement
        self.trace_length = trace_length
        self.composition_degree_bound = 2 * trace_length

    def boundary_constraints(self, rap) -> list:
        s, last = self.s, self.trace_length - 1
        alpha, z = rap[0], rap[1]
        prod = 1
        for addr, value in s.public_memory:
            prod = prod * ((z - (addr + alpha * value)) % P) % P
        perm_final = (pow(z, len(s.public_memory), P) * pow(prod, P - 2, P)
                      % P)
        return [Boundary(PC, 0, s.pc_init), Boundary(AP, 0, s.ap_init),
                Boundary(PC, s.num_steps - 1, s.pc_final),
                Boundary(AP, s.num_steps - 1, s.ap_final),
                Boundary(PERM[3], last, perm_final),
                Boundary(RC_PERM[2], last, 1),
                Boundary(RC1, 0, s.rc_min), Boundary(RC3, last, s.rc_max)]

    def transition(self, c: list, x: list, rap) -> list:
        """The 49 constraints at one frame: ``c`` the row, ``x`` the next."""
        out = []
        for i in range(15):  # flags are bits, the 16th is zero
            out.append(c[i] * (c[i] - 1))
        out.append(c[15])
        f0 = c[14]
        for i in range(13, -1, -1):
            f0 = c[i] + 2 * f0
        ap, fp, pc = c[AP], c[FP], c[PC]
        size = c[F_OP1_VAL] + 1
        sel = [
            c[OFF_DST] + B15 * 2 * c[OFF_OP0] + (1 << 32) * c[OFF_OP1]
            + (1 << 48) * f0 - c[INST],
            c[F_DST_FP] * fp + (1 - c[F_DST_FP]) * ap + c[OFF_DST] - B15
            - c[DST_ADDR],
            c[F_OP0_FP] * fp + (1 - c[F_OP0_FP]) * ap + c[OFF_OP0] - B15
            - c[OP0_ADDR],
            c[F_OP1_VAL] * pc + c[F_OP1_AP] * ap + c[F_OP1_FP] * fp
            + (1 - c[F_OP1_VAL] - c[F_OP1_AP] - c[F_OP1_FP]) * c[OP0]
            + c[OFF_OP1] - B15 - c[OP1_ADDR],
            ap + c[F_AP_ADD] * c[RES] + c[F_AP_ONE] + 2 * c[F_CALL]
            - x[AP],
            c[F_RET] * c[DST] + c[F_CALL] * (ap + 2)
            + (1 - c[F_RET] - c[F_CALL]) * fp - x[FP],
            (c[T1] - c[F_PC_JNZ]) * (x[PC] - (pc + size)),
            c[T0] * (x[PC] - (pc + c[OP1])) + (1 - c[F_PC_JNZ]) * x[PC]
            - ((1 - c[F_PC_ABS] - c[F_PC_REL] - c[F_PC_JNZ]) * (pc + size)
               + c[F_PC_ABS] * c[RES] + c[F_PC_REL] * (pc + c[RES])),
            c[F_PC_JNZ] * c[DST] - c[T0],
            c[T0] * c[RES] - c[T1],
            c[MUL] - c[OP0] * c[OP1],
            c[F_RES_ADD] * (c[OP0] + c[OP1]) + c[F_RES_MUL] * c[MUL]
            + (1 - c[F_RES_ADD] - c[F_RES_MUL] - c[F_PC_JNZ]) * c[OP1]
            - (1 - c[F_PC_JNZ]) * c[RES],
            c[F_CALL] * (c[DST] - fp),
            c[F_CALL] * (c[OP0] - (pc + size)),
            c[F_AEQ] * (c[DST] - c[RES]),
        ]
        out += [v * c[SELECTOR] for v in sel]
        a = [c[k] for k in ADDR_SORTED] + [x[ADDR_SORTED[0]]]
        v = [c[k] for k in VAL_SORTED] + [x[VAL_SORTED[0]]]
        out += [(a[k] - a[k + 1]) * (a[k + 1] - a[k] - 1) for k in range(4)]
        out += [(v[k] - v[k + 1]) * (a[k + 1] - a[k] - 1) for k in range(4)]
        alpha, z, zr = rap
        p = [c[k] for k in PERM] + [x[PERM[0]]]
        acc_a = [c[DST_ADDR], c[OP0_ADDR], c[OP1_ADDR], x[PC]]
        acc_v = [c[DST], c[OP0], c[OP1], x[INST]]
        out += [(z - (a[k + 1] + alpha * v[k + 1])) * p[k + 1]
                - (z - (acc_a[k] + alpha * acc_v[k])) * p[k] for k in range(4)]
        r = [c[RC1], c[RC2], c[RC3], x[RC1]]
        out += [(r[k] - r[k + 1]) * (r[k + 1] - r[k] - 1) for k in range(3)]
        q = [c[k] for k in RC_PERM] + [x[RC_PERM[0]]]
        offs = [c[OFF_OP0], c[OFF_OP1], x[OFF_DST]]
        out += [(zr - r[k + 1]) * q[k + 1] - (zr - offs[k]) * q[k]
                for k in range(3)]
        return [e % P for e in out]
