"""Minimal Cairo0 virtual machine (replaces the `cairo-vm` crate used by the
reference, src/cairo/runner/run.rs:64-240).

Executes compiled Cairo0 programs (the `cairo-compile` JSON format) from the
`main` entrypoint in non-proof mode, with segment-relocated output matching
cairo-vm's binary trace (`ap fp pc` u64 LE rows) and memory (`addr value`)
encodings, so the downstream trace builder sees identical data.

Supported: the full deterministic instruction set (assert_eq with memory
deduction, call/ret, jumps, jnz, ap updates, immediates), the output /
range-check builtin segments, the auto-deduction builtins (bitwise,
pedersen, ec_op, keccak, poseidon) and the ecdsa signature cells
(builtins.py), and the compiled-program hints (hints.py, hints_stdlib.py)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..field.params import P
from .cairo_mem import CairoMemory
from .decode import (
    AP_ADD, AP_ADD1, AP_REGULAR, InstructionFlags, InstructionOffsets,
    OP1_SRC_AP, OP1_SRC_FP, OP1_SRC_IMM, OP1_SRC_OP0, OPCODE_ASSERT_EQ,
    OPCODE_CALL, OPCODE_NOP, OPCODE_RET, PC_JNZ, PC_JUMP, PC_JUMP_REL,
    PC_REGULAR, RES_ADD, RES_MUL, RES_OP1,
)
from .register_states import RegistersState, RegisterStates


class CairoVMError(Exception):
    pass


@dataclass(frozen=True)
class Relocatable:
    segment: int
    offset: int

    def __add__(self, n: int) -> "Relocatable":
        return Relocatable(self.segment, (self.offset + n) % P)

    def __sub__(self, n: int) -> "Relocatable":
        return Relocatable(self.segment, self.offset - n)


MaybeRelocatable = object  # int (felt) or Relocatable


@dataclass
class Program:
    data: list[int]
    main_pc: int
    builtins: list[str] = field(default_factory=list)
    # pc-offset -> [hints.Hint]; executed before the instruction at that pc
    hints: dict = field(default_factory=dict)
    # hints.Reference list indexed by the hints' reference_ids
    references: list = field(default_factory=list)

    @classmethod
    def from_json(cls, content: bytes | str) -> "Program":
        obj = json.loads(content)
        data = [int(x, 16) for x in obj["data"]]
        idents = obj.get("identifiers", {})
        main = idents.get("__main__.main")
        if main is None:
            raise CairoVMError("program has no __main__.main")
        from .hints import parse_program_hints

        hints, references = parse_program_hints(obj)
        return cls(data=data, main_pc=main["pc"],
                   builtins=obj.get("builtins", []), hints=hints,
                   references=references)


class CairoVM:
    def __init__(self, program: Program):
        self.program = program
        # segmented memory: dict[(segment, offset)] -> int | Relocatable
        self.segments: list[dict[int, object]] = []
        self.trace: list[tuple[Relocatable, Relocatable, Relocatable]] = []
        # pc-offset (program segment) -> callable(vm, ap, fp) OR a list of
        # hints.Hint; executed before the instruction at that pc, mirroring
        # cairo-vm hint hooks.  Seeded from the compiled program's hints.
        self.hints: dict[int, object] = dict(program.hints)
        self.builtin_bases: dict[str, Relocatable] = {}
        # segment index -> deduction rule (builtins.DEDUCERS), mirroring
        # cairo-vm's deduce_memory_cell on first read of an output cell
        self._deducers: dict[int, object] = {}
        # ecdsa SignatureBuiltinRunner state: segments under signature
        # validation + (segment, instance_base_offset) -> (r, s) provided by
        # the verify_ecdsa_signature hint (cairo-vm add_signature)
        self._signature_segments: set[int] = set()
        self.signatures: dict[tuple[int, int], tuple[int, int]] = {}
        # hint execution scopes (cairo-vm ExecutionScopes): a stack of dicts
        # manipulated by the vm_enter_scope()/vm_exit_scope() hints; the
        # root scope holds process-wide hint state (e.g. __dict_manager)
        self.exec_scopes: list[dict] = [{}]

    # -- hint execution scopes ------------------------------------------------

    def enter_scope(self, new_vars: dict | None = None) -> None:
        self.exec_scopes.append(dict(new_vars or {}))

    def exit_scope(self) -> None:
        if len(self.exec_scopes) <= 1:
            raise CairoVMError("vm_exit_scope() with no scope to exit")
        self.exec_scopes.pop()

    def scope_get(self, name: str, default=None):
        """Nearest-enclosing-scope lookup (superset of cairo-vm's
        current-scope-only rule; keeps hand-built fixtures simple)."""
        for scope in reversed(self.exec_scopes):
            if name in scope:
                return scope[name]
        return default

    def scope_get_local(self, name: str, default=None):
        """Current-scope-only lookup — cairo-lang hint globals ARE the
        innermost scope, so semantically sensitive names (initial_dict,
        __find_element_index) must not leak in from enclosing scopes."""
        return self.exec_scopes[-1].get(name, default)

    def scope_set(self, name: str, value) -> None:
        self.exec_scopes[-1][name] = value

    # -- segment helpers ----------------------------------------------------

    def add_segment(self) -> Relocatable:
        self.segments.append({})
        return Relocatable(len(self.segments) - 1, 0)

    def get_range(self, addr: Relocatable, size: int) -> list:
        """[mem[addr], ..., mem[addr+size-1]] (cairo-vm memory.get_range)."""
        return [self.mem_get(addr + i) for i in range(size)]

    def mem_get(self, addr: Relocatable):
        seg = self.segments[addr.segment]
        v = seg.get(addr.offset)
        if v is None:
            deduce = self._deducers.get(addr.segment)
            if deduce is not None:
                try:
                    v = deduce(seg, addr.offset)
                except ValueError as e:
                    raise CairoVMError(str(e))
                if v is not None:
                    seg[addr.offset] = v  # reaches relocated memory
        return v

    def mem_set(self, addr: Relocatable, value) -> None:
        seg = self.segments[addr.segment]
        existing = seg.get(addr.offset)
        if existing is not None and existing != value:
            raise CairoVMError(f"memory write conflict at {addr}")
        seg[addr.offset] = value
        if addr.segment in self._signature_segments:
            self._validate_signature_cell(addr)

    # -- ecdsa signature builtin (cairo-vm SignatureBuiltinRunner) ----------

    def add_signature(self, addr: Relocatable, rs: tuple[int, int]) -> None:
        """Register (r, s) for the instance at `addr` (the pub_key cell) —
        the stdlib verify_ecdsa_signature hint's `ecdsa_builtin
        .add_signature(ids.ecdsa_ptr, (r, s))`."""
        from .builtins import ECDSA_CELLS_PER_INSTANCE as SZ

        if addr.segment not in self._signature_segments:
            raise CairoVMError(
                f"add_signature outside the ecdsa segment: {addr}")
        if addr.offset % SZ:
            raise CairoVMError(
                f"add_signature at a non-instance-base offset: {addr}")
        self.signatures[(addr.segment, addr.offset)] = (int(rs[0]),
                                                        int(rs[1]))

    def _validate_signature_cell(self, addr: Relocatable) -> None:
        """cairo-vm validation rule: once BOTH cells of a [pub_key, message]
        instance are present, the hint-provided signature must exist and
        verify on the STARK curve."""
        from .builtins import ECDSA_CELLS_PER_INSTANCE as SZ
        from .builtins import verify_ecdsa

        seg = self.segments[addr.segment]
        base = addr.offset - addr.offset % SZ
        pub = seg.get(base)
        msg = seg.get(base + 1)
        if pub is None or msg is None:
            return  # incomplete instance: validated when the pair completes
        if isinstance(pub, Relocatable) or isinstance(msg, Relocatable):
            raise CairoVMError("ecdsa builtin cells must be felts")
        rs = self.signatures.get((addr.segment, base))
        if rs is None:
            raise CairoVMError(
                f"signature hint is missing for ECDSA builtin at "
                f"segment {addr.segment} offset {base}")
        if not verify_ecdsa(pub, msg, rs[0], rs[1]):
            raise CairoVMError(
                f"invalid ECDSA signature at segment {addr.segment} offset "
                f"{base}: r={rs[0]:#x} s={rs[1]:#x}")

    # -- run ---------------------------------------------------------------

    def run(self, max_steps: int = 1 << 24):
        prog = self.program
        program_base = self.add_segment()
        execution_base = self.add_segment()
        for i, word in enumerate(prog.data):
            self.mem_set(program_base + i, word)

        from .builtins import DEDUCERS

        stack: list[object] = []
        for name in prog.builtins:
            base = self.add_segment()
            self.builtin_bases[name] = base
            if name in DEDUCERS:
                self._deducers[base.segment] = DEDUCERS[name]
            if name == "ecdsa":
                self._signature_segments.add(base.segment)
            stack.append(base)

        return_fp = self.add_segment()
        end = self.add_segment()
        stack.extend([return_fp, end])
        for i, v in enumerate(stack):
            self.mem_set(execution_base + i, v)

        ap = execution_base + len(stack)
        fp = ap
        pc = program_base + prog.main_pc
        return self.run_until(pc, ap, fp, end, max_steps)

    def run_until(self, pc, ap, fp, end, max_steps: int = 1 << 24):
        """Step until pc == end (cairo-vm `run_until_pc`), executing any
        registered hints before each instruction.

        Hint entries may be legacy callables ``f(vm, ap, fp)`` or lists of
        `hints.Hint` parsed from a compiled program's `hints` section
        (resolved against the program's reference manager)."""
        from .hints import Hint, execute_hint

        steps = 0
        hints = self.hints
        refs = self.program.references
        while pc != end:
            if steps >= max_steps:
                raise CairoVMError("maximum steps exceeded")
            if hints and pc.segment == 0 and pc.offset in hints:
                entry = hints[pc.offset]
                if callable(entry):
                    entry(self, ap, fp)
                else:
                    for h in entry:
                        execute_hint(self, h, refs, ap, fp)
            pc, ap, fp = self.step(pc, ap, fp)
            steps += 1
        # final registers are recorded by the last step's next-state in trace
        self.final = (pc, ap, fp)
        return steps

    # -- arithmetic over felts / relocatables --------------------------------

    @staticmethod
    def _add(a, b):
        if isinstance(a, Relocatable) and isinstance(b, int):
            return Relocatable(a.segment, (a.offset + b) % P)
        if isinstance(b, Relocatable) and isinstance(a, int):
            return Relocatable(b.segment, (b.offset + a) % P)
        if isinstance(a, Relocatable) and isinstance(b, Relocatable):
            raise CairoVMError("cannot add two relocatables")
        return (a + b) % P

    @staticmethod
    def _mul(a, b):
        if isinstance(a, Relocatable) or isinstance(b, Relocatable):
            raise CairoVMError("cannot multiply relocatables")
        return (a * b) % P

    def step(self, pc: Relocatable, ap: Relocatable, fp: Relocatable):
        self.trace.append((ap, fp, pc))
        inst = self.mem_get(pc)
        if inst is None or isinstance(inst, Relocatable):
            raise CairoVMError(f"no instruction at {pc}")
        flags = InstructionFlags.decode(inst)
        offs = InstructionOffsets.decode(inst)

        dst_addr = (fp if flags.dst_reg else ap) + offs.off_dst
        op0_addr = (fp if flags.op0_reg else ap) + offs.off_op0

        op0 = self.mem_get(op0_addr)

        if flags.op1_src == OP1_SRC_IMM:
            op1_addr = pc + offs.off_op1
            instruction_size = 2
        elif flags.op1_src == OP1_SRC_FP:
            op1_addr = fp + offs.off_op1
            instruction_size = 1
        elif flags.op1_src == OP1_SRC_AP:
            op1_addr = ap + offs.off_op1
            instruction_size = 1
        elif flags.op1_src == OP1_SRC_OP0:
            if op0 is None:
                raise CairoVMError("op0 unknown for op1 computation")
            if not isinstance(op0, Relocatable):
                raise CairoVMError("op1_src=op0 requires op0 to be an address")
            op1_addr = op0 + offs.off_op1
            instruction_size = 1
        else:
            raise CairoVMError("invalid op1_src")

        op1 = self.mem_get(op1_addr)
        dst = self.mem_get(dst_addr)

        # opcode-specific asserted values (cairo-vm deductions)
        if flags.opcode == OPCODE_CALL:
            self.mem_set(op0_addr, pc + instruction_size)
            self.mem_set(dst_addr, fp)
            op0 = self.mem_get(op0_addr)
            dst = self.mem_get(dst_addr)

        # compute res
        res = None
        if flags.pc_update != PC_JNZ:
            if flags.res_logic == RES_OP1:
                res = op1
            elif flags.res_logic == RES_ADD:
                if op0 is None or op1 is None:
                    # deduce op0/op1 from dst for assert_eq
                    if flags.opcode == OPCODE_ASSERT_EQ and dst is not None:
                        if op0 is None and op1 is not None:
                            deduced = self._sub(dst, op1)
                            self.mem_set(op0_addr, deduced)
                            op0 = deduced
                        elif op1 is None and op0 is not None:
                            deduced = self._sub(dst, op0)
                            self.mem_set(op1_addr, deduced)
                            op1 = deduced
                if op0 is None or op1 is None:
                    raise CairoVMError("cannot compute res: unknown operands")
                res = self._add(op0, op1)
            elif flags.res_logic == RES_MUL:
                if op0 is None or op1 is None:
                    if flags.opcode == OPCODE_ASSERT_EQ and dst is not None:
                        if op1 is None and op0 is not None and op0 != 0:
                            deduced = dst * pow(op0, P - 2, P) % P
                            self.mem_set(op1_addr, deduced)
                            op1 = deduced
                        elif op0 is None and op1 is not None and op1 != 0:
                            deduced = dst * pow(op1, P - 2, P) % P
                            self.mem_set(op0_addr, deduced)
                            op0 = deduced
                if op0 is None or op1 is None:
                    raise CairoVMError("cannot compute res: unknown operands")
                res = self._mul(op0, op1)
            else:
                raise CairoVMError("invalid res_logic")
            if res is None and flags.opcode == OPCODE_ASSERT_EQ and dst is not None:
                # res_logic == op1 with unknown op1: deduce from dst
                res = dst
                self.mem_set(op1_addr, dst)
                op1 = dst

        if flags.opcode == OPCODE_ASSERT_EQ:
            if res is None:
                raise CairoVMError("assert_eq with unknown res")
            if dst is None:
                self.mem_set(dst_addr, res)
                dst = res
            elif dst != res:
                raise CairoVMError("assert_eq failed")

        if dst is None and flags.pc_update == PC_JNZ:
            raise CairoVMError("jnz with unknown dst")

        # pc update
        if flags.pc_update == PC_REGULAR:
            next_pc = pc + instruction_size
        elif flags.pc_update == PC_JUMP:
            if isinstance(res, Relocatable):
                next_pc = res
            else:
                raise CairoVMError("absolute jump to felt is unsupported here")
        elif flags.pc_update == PC_JUMP_REL:
            if isinstance(res, Relocatable):
                raise CairoVMError("relative jump by relocatable")
            next_pc = pc + res
        elif flags.pc_update == PC_JNZ:
            is_zero = dst == 0
            if is_zero:
                next_pc = pc + instruction_size
            else:
                if op1 is None or isinstance(op1, Relocatable):
                    raise CairoVMError("jnz with bad op1")
                next_pc = pc + op1
        else:
            raise CairoVMError("invalid pc_update")

        # ap update
        if flags.ap_update == AP_REGULAR:
            next_ap = ap + (2 if flags.opcode == OPCODE_CALL else 0)
        elif flags.ap_update == AP_ADD:
            if res is None or isinstance(res, Relocatable):
                raise CairoVMError("ap += res with bad res")
            next_ap = ap + res
        elif flags.ap_update == AP_ADD1:
            next_ap = ap + 1
        else:
            raise CairoVMError("invalid ap_update")

        # fp update
        if flags.opcode == OPCODE_CALL:
            next_fp = ap + 2
        elif flags.opcode == OPCODE_RET:
            if not isinstance(dst, Relocatable):
                raise CairoVMError("ret with non-relocatable dst")
            next_fp = dst
        else:
            next_fp = fp

        return next_pc, next_ap, next_fp

    @staticmethod
    def _sub(a, b):
        if isinstance(a, Relocatable) and isinstance(b, int):
            return Relocatable(a.segment, (a.offset - b) % P)
        if isinstance(a, Relocatable) and isinstance(b, Relocatable):
            if a.segment != b.segment:
                raise CairoVMError("sub of different segments")
            return a.offset - b.offset
        if isinstance(b, Relocatable):
            raise CairoVMError("cannot subtract relocatable from felt")
        return (a - b) % P

    # -- relocation ---------------------------------------------------------

    def relocate(self):
        """Returns (RegisterStates, CairoMemory, program_size, builtin_ranges).

        Segments are laid out contiguously from address 1 in index order,
        sized by their used cells (max offset + 1), as cairo-vm does."""
        sizes = []
        for seg in self.segments:
            sizes.append(max(seg.keys()) + 1 if seg else 0)
        bases = []
        acc = 1
        for sz in sizes:
            bases.append(acc)
            acc += sz

        def reloc(v):
            if isinstance(v, Relocatable):
                return bases[v.segment] + v.offset
            return v

        memory = {}
        for si, seg in enumerate(self.segments):
            for off, v in seg.items():
                memory[bases[si] + off] = reloc(v) % P

        rows = [
            RegistersState(pc=reloc(pc), fp=reloc(fp), ap=reloc(ap))
            for (ap, fp, pc) in self.trace
        ]

        builtin_ranges = {}
        for name, base in self.builtin_bases.items():
            start = bases[base.segment]
            end = start + sizes[base.segment]
            builtin_ranges[name] = range(start, end)

        return (
            RegisterStates(rows),
            CairoMemory(memory),
            len(self.program.data),
            builtin_ranges,
        )


def run_program(program: Program):
    """Execute and relocate; mirrors reference `run_program` outputs."""
    vm = CairoVM(program)
    vm.run()
    return vm.relocate()
