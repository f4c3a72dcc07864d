"""The Cairo AIR: public inputs, RAP auxiliary trace, and the 49/50
transition constraints (reference src/cairo/air.rs).

Constraints are written once against the FV wrapper and evaluated either over
the whole LDE domain on device or on the OOD frame on host (see air/values.py).

The counterpart of the JAX package's cairo/air.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..air.base import AIR, AirContext
from ..air.boundary import BoundaryConstraint, BoundaryConstraints
from ..air.trace import TraceTable
from ..field import device as fd
from ..field import host as fh
from ..field.params import N_LIMBS, P
from ..ntt import core as nttc
from ..proof.options import ProofOptions
from ..transcript import transcript_to_field
from .execution_trace import (
    FRAME_AP, FRAME_DST, FRAME_DST_ADDR, FRAME_FP, FRAME_INST, FRAME_MUL,
    FRAME_OP0, FRAME_OP0_ADDR, FRAME_OP1, FRAME_OP1_ADDR, FRAME_PC, FRAME_RES,
    FRAME_SELECTOR, FRAME_T0, FRAME_T1, OFF_DST, OFF_OP0, OFF_OP1,
)

# flag frame ids
F_DST_FP = 0
F_OP_0_FP = 1
F_OP_1_VAL = 2
F_OP_1_FP = 3
F_OP_1_AP = 4
F_RES_ADD = 5
F_RES_MUL = 6
F_PC_ABS = 7
F_PC_REL = 8
F_PC_JNZ = 9
F_AP_ADD = 10
F_AP_ONE = 11
F_OPC_CALL = 12
F_OPC_RET = 13
F_OPC_AEQ = 14

# rc builtin columns
RC_0, RC_1, RC_2, RC_3, RC_4, RC_5, RC_6, RC_7 = range(34, 42)
RC_VALUE = 42

# aux columns (with builtin; subtract BUILTIN_OFFSET without)
RANGE_CHECK_COL_1 = 43
RANGE_CHECK_COL_2 = 44
RANGE_CHECK_COL_3 = 45
MEMORY_ADDR_SORTED_0 = 46
MEMORY_ADDR_SORTED_1 = 47
MEMORY_ADDR_SORTED_2 = 48
MEMORY_ADDR_SORTED_3 = 49
MEMORY_VALUES_SORTED_0 = 50
MEMORY_VALUES_SORTED_1 = 51
MEMORY_VALUES_SORTED_2 = 52
MEMORY_VALUES_SORTED_3 = 53
PERMUTATION_ARGUMENT_COL_0 = 54
PERMUTATION_ARGUMENT_COL_1 = 55
PERMUTATION_ARGUMENT_COL_2 = 56
PERMUTATION_ARGUMENT_COL_3 = 57
PERMUTATION_ARGUMENT_RANGE_CHECK_COL_1 = 58
PERMUTATION_ARGUMENT_RANGE_CHECK_COL_2 = 59
PERMUTATION_ARGUMENT_RANGE_CHECK_COL_3 = 60

MEM_P_TRACE_OFFSET = 17  # ap column
MEM_A_TRACE_OFFSET = 19  # pc column

BUILTIN_OFFSET = 9


@dataclass
class PublicInputs:
    pc_init: int
    ap_init: int
    fp_init: int
    pc_final: int
    ap_final: int
    range_check_min: int | None
    range_check_max: int | None
    memory_segments: dict  # {"range_check"|"output": range}
    public_memory: dict  # {addr(int): value(int)}
    num_steps: int

    @classmethod
    def from_regs_and_mem(cls, register_states, memory, program_size,
                          memory_segments=None):
        memory_segments = memory_segments or {}
        public_memory = {
            addr: memory.get(addr) for addr in range(1, program_size + 1)
        }
        output_range = memory_segments.get("output")
        if output_range is not None:
            for addr in output_range:
                public_memory[addr] = memory.get(addr)
        # Deterministic self-generated output: insertion order IS the wire
        # order (serialize below), so construct sorted by address.
        public_memory = dict(sorted(public_memory.items()))
        first = register_states.rows[0]
        last = register_states.rows[-1]
        return cls(
            pc_init=first.pc,
            ap_init=first.ap,
            fp_init=first.fp,
            pc_final=last.pc,
            ap_final=last.ap,
            range_check_min=None,
            range_check_max=None,
            memory_segments=memory_segments,
            public_memory=public_memory,
            num_steps=register_states.steps,
        )

    # -- wire format (reference air.rs:223-449) -----------------------------

    def serialize(self) -> bytes:
        out = bytearray()
        out.extend((32).to_bytes(8, "big"))
        for v in (self.pc_init, self.ap_init, self.fp_init, self.pc_final,
                  self.ap_final):
            out.extend(fh.to_bytes_be(v % P))
        for rc in (self.range_check_min, self.range_check_max):
            if rc is None:
                out.append(0)
            else:
                out.append(1)
                out.extend(int(rc).to_bytes(2, "big"))
        out.extend(len(self.memory_segments).to_bytes(8, "big"))
        for seg, rng in self.memory_segments.items():
            out.append(0 if seg == "range_check" else 1)
            out.extend(rng.start.to_bytes(8, "big"))
            out.extend(rng.stop.to_bytes(8, "big"))
        out.extend(len(self.public_memory).to_bytes(8, "big"))
        # Insertion order, NOT sorted: deserialize preserves file order, so a
        # reference-produced file (HashMap order, air.rs:223-449) round-trips
        # byte-exactly; self-generated inputs are sorted at construction.
        for addr, value in self.public_memory.items():
            out.extend(fh.to_bytes_be(addr % P))
            out.extend(fh.to_bytes_be(value % P))
        out.extend(self.num_steps.to_bytes(8, "big"))
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "PublicInputs":
        from ..proof.serde import _Reader

        r = _Reader(data)
        felt_len = r.u64()
        pc_init = r.felt(felt_len)
        ap_init = r.felt(felt_len)
        fp_init = r.felt(felt_len)
        pc_final = r.felt(felt_len)
        ap_final = r.felt(felt_len)
        rc_min = r.u16() if r.u8() == 1 else None
        rc_max = r.u16() if r.u8() == 1 else None
        n_segments = r.u64()
        memory_segments = {}
        for _ in range(n_segments):
            seg_type = r.u8()
            start = r.u64()
            end = r.u64()
            memory_segments["range_check" if seg_type == 0 else "output"] = range(
                start, end
            )
        n_pub = r.u64()
        public_memory = {}
        for _ in range(n_pub):
            addr = r.felt(felt_len)
            value = r.felt(felt_len)
            public_memory[addr] = value
        num_steps = r.u64()
        return cls(pc_init, ap_init, fp_init, pc_final, ap_final, rc_min,
                   rc_max, memory_segments, public_memory, num_steps)


# RAP challenge tuple layout: (alpha_memory, z_memory, z_range_check)
RAP_ALPHA_MEMORY, RAP_Z_MEMORY, RAP_Z_RANGE_CHECK = 0, 1, 2

_SIGN_BIT = -(1 << 63)


def _stable_sort_u64(canon: torch.Tensor) -> torch.Tensor:
    """Stable ascending permutation of (16, m) canonical limbs < 2^64.

    Limbs 0-3 make one int64 key; flipping bit 63 turns the signed order of
    int64 into the unsigned order of the 64-bit values, so one stable sort
    gives the permutation of the JAX package's two stable u32 passes."""
    w = canon[:4].to(torch.int64)
    key = (w[0] | (w[1] << 16) | (w[2] << 32) | (w[3] << 48)) ^ _SIGN_BIT
    return torch.sort(key, stable=True).indices


def _de_interleave(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    return torch.movedim(flat.reshape(N_LIMBS, n, k), 2, 1)  # (16, k, n)


def _aux_mem_kernel(addr_cols, val_cols, a_aux, v_aux, z_arr, alpha_arr,
                    n: int) -> torch.Tensor:
    """Memory-argument aux columns: sorted (addr, value) pairs + the
    permutation cumulative product, as (16, 12, n)."""
    # sort (address, value) pairs by canonical address, stable
    perm = _stable_sort_u64(fd.from_mont(a_aux))
    addr_sorted = a_aux.index_select(1, perm)
    val_sorted = v_aux.index_select(1, perm)

    # memory permutation column: cumprod of (z-(a+av))/(z-(a'+av'))
    num = fd.sub(z_arr, fd.add(addr_cols, fd.mul(alpha_arr, val_cols)))
    den = fd.sub(z_arr, fd.add(addr_sorted, fd.mul(alpha_arr, val_sorted)))
    ratio = fd.mul(num, fd.batch_inverse(den))
    perm_col = fd.prefix_product(ratio)
    return torch.cat(
        [_de_interleave(addr_sorted, n, 4), _de_interleave(val_sorted, n, 4),
         _de_interleave(perm_col, n, 4)], dim=1)


def _aux_rc_kernel(off_cols, zr_arr, n: int):
    """Range-check aux columns: sorted offsets + permutation cumulative
    product, as ((16, 3, n), (16, 3, n)).  Offsets are 16-bit, so limb 0 of
    the canonical value is the whole sort key."""
    operm = torch.sort(fd.from_mont(off_cols)[0], stable=True).indices
    off_sorted = off_cols.index_select(1, operm)
    num_rc = fd.sub(zr_arr, off_cols)
    den_rc = fd.sub(zr_arr, off_sorted)
    ratio_rc = fd.mul(num_rc, fd.batch_inverse(den_rc))
    rc_perm_col = fd.prefix_product(ratio_rc)
    return _de_interleave(off_sorted, n, 3), _de_interleave(rc_perm_col, n, 3)


class CairoAIR(AIR):
    """49 (+1 with range-check builtin) transition constraints over the
    61-column (52 without builtin) Cairo trace (air.rs:574-866)."""

    def __init__(self, trace_length, pub_inputs: PublicInputs,
                 proof_options: ProofOptions):
        super().__init__(trace_length, pub_inputs, proof_options)
        assert trace_length & (trace_length - 1) == 0

        trace_columns = 34 + 3 + 12 + 3
        transition_degrees = (
            [2] * 15 + [1]
            + [3] * 15
            + [2, 2, 2, 2]
            + [2, 2, 2, 2]
            + [2, 2, 2, 2]
            + [2, 2, 2]
            + [2, 2, 2]
        )
        transition_exemptions = (
            [0] * 16
            + [0]
            + [0, 0, 0]
            + [1, 1, 1, 1, 0, 0]
            + [0, 0, 0, 0, 0]
            + [0, 0, 0, 1]
            + [0, 0, 0, 1]
            + [0, 0, 0, 1]
            + [0, 0, 1]
            + [0, 0, 0]
        )
        num_transition_constraints = 49

        # NOTE: the reference keys this off ANY segment being present
        # (air.rs:623), which mis-counts columns for output-only programs (a
        # corner its tests never hit); we key off the range-check segment.
        self.has_rc_builtin = "range_check" in pub_inputs.memory_segments
        if self.has_rc_builtin:
            trace_columns += 8 + 1
            transition_degrees.append(1)
            transition_exemptions.append(0)
            num_transition_constraints += 1

        self.context = AirContext(
            proof_options=proof_options,
            trace_columns=trace_columns,
            transition_degrees=transition_degrees,
            transition_offsets=[0, 1],
            transition_exemptions=transition_exemptions,
            num_transition_constraints=num_transition_constraints,
            num_transition_exemptions=1,
        )

    def _builtin_offset(self) -> int:
        return 0 if self.has_rc_builtin else BUILTIN_OFFSET

    def composition_poly_degree_bound(self):
        return 2 * self.trace_length()

    def number_auxiliary_rap_columns(self):
        return 12 + 3 + 3

    def build_rap_challenges(self, transcript):
        return (
            transcript_to_field(transcript),   # alpha_memory
            transcript_to_field(transcript),   # z_memory
            transcript_to_field(transcript),   # z_range_check
        )

    def kernel_cache_key(self):
        return (self.pub_inputs_.num_steps, self.has_rc_builtin,
                len(self.pub_inputs_.public_memory))

    # -- auxiliary (RAP) trace ---------------------------------------------

    def build_auxiliary_trace(self, main_trace: TraceTable, rc) -> TraceTable:
        """The RAP trace, built on the main trace's device: the sorts are
        stable library sorts on integer keys, the ratios' inverses and
        cumulative products `batch_inverse` and `prefix_product` scans (the
        H5 and H6 kernels on a CUDA device).

        The 11 columns it reads come one at a time through
        ``main_trace.col`` (unpacked one by one from the packed trace).
        Where the prover has set ``main_trace._release_after_read``
        (``prove(donate_trace=True)``), the trace is released right after
        that read, so that the sorts and scans reuse its memory."""
        from ..prover.prove import _mem

        n = main_trace.n_rows
        dev = main_trace.data.device
        pub = self.pub_inputs_

        def interleave(cols):  # row-major interleave, (16, len(cols) * n)
            return torch.stack([main_trace.col(c) for c in cols],
                               dim=2).reshape(N_LIMBS, len(cols) * n)

        addr_cols = interleave(
            (FRAME_PC, FRAME_DST_ADDR, FRAME_OP0_ADDR, FRAME_OP1_ADDR))
        val_cols = interleave((FRAME_INST, FRAME_DST, FRAME_OP0, FRAME_OP1))
        off_cols = interleave((OFF_DST, OFF_OP0, OFF_OP1))
        if getattr(main_trace, "_release_after_read", False):
            main_trace.data = None

        # public-memory injection into the last pub_len slots
        pub_addrs = self._get_pub_memory_addrs()
        pub_vals = [pub.public_memory[a] for a in pub_addrs]
        pub_len = len(pub_addrs)
        inj_a = fd.from_ints(pub_addrs, device=dev)
        inj_v = fd.from_ints(pub_vals, device=dev)
        a_aux = torch.cat([addr_cols[:, : 4 * n - pub_len], inj_a], dim=1)
        v_aux = torch.cat([val_cols[:, : 4 * n - pub_len], inj_v], dim=1)

        z_arr = fd.from_int(rc[RAP_Z_MEMORY], device=dev)
        alpha_arr = fd.from_int(rc[RAP_ALPHA_MEMORY], device=dev)
        zr_arr = fd.from_int(rc[RAP_Z_RANGE_CHECK], device=dev)

        mem_part = _aux_mem_kernel(addr_cols, val_cols, a_aux, v_aux, z_arr,
                                   alpha_arr, n)
        del addr_cols, val_cols, a_aux, v_aux
        _mem("aux: mem kernel done", dev)
        off_sorted, rc_perm = _aux_rc_kernel(off_cols, zr_arr, n)
        del off_cols
        _mem("aux: rc kernel done", dev)
        return TraceTable(torch.cat([off_sorted, mem_part, rc_perm], dim=1))

    def build_auxiliary_trace_host(self, main_trace: TraceTable, rc) -> TraceTable:
        """The same RAP trace with python ints on the host: the oracle the
        device build is held against."""
        cols = main_trace.to_int_columns()
        n = main_trace.n_rows

        # flattened row-major memory access sequences
        addresses_original = []
        values_original = []
        for i in range(n):
            for c in (FRAME_PC, FRAME_DST_ADDR, FRAME_OP0_ADDR, FRAME_OP1_ADDR):
                addresses_original.append(cols[c][i])
            for c in (FRAME_INST, FRAME_DST, FRAME_OP0, FRAME_OP1):
                values_original.append(cols[c][i])

        addresses, values = self._add_pub_memory_in_public_input_section(
            addresses_original, values_original
        )
        pairs = sorted(zip(addresses, values), key=lambda t: t[0])
        addresses = [a for a, _ in pairs]
        values = [v for _, v in pairs]

        alpha, z = rc[RAP_ALPHA_MEMORY], rc[RAP_Z_MEMORY]
        denom = fh.batch_inverse(
            [(z - (a + alpha * v)) % P for a, v in zip(addresses, values)]
        )
        perm = []
        prod = 1
        for a, v, d in zip(addresses_original, values_original, denom):
            prod = prod * ((z - (a + alpha * v)) % P) % P * d % P
            perm.append(prod)

        # range-check columns
        offsets_original = []
        for i in range(n):
            for c in (OFF_DST, OFF_OP0, OFF_OP1):
                offsets_original.append(cols[c][i])
        offsets_sorted = sorted(offsets_original)

        zr = rc[RAP_Z_RANGE_CHECK]
        denom_rc = fh.batch_inverse([(zr - x) % P for x in offsets_sorted])
        rc_perm = []
        prod = 1
        for x, d in zip(offsets_original, denom_rc):
            prod = prod * ((zr - x) % P) % P * d % P
            rc_perm.append(prod)

        aux_cols = [
            offsets_sorted[0::3], offsets_sorted[1::3], offsets_sorted[2::3],
            addresses[0::4], addresses[1::4], addresses[2::4], addresses[3::4],
            values[0::4], values[1::4], values[2::4], values[3::4],
            perm[0::4], perm[1::4], perm[2::4], perm[3::4],
            rc_perm[0::3], rc_perm[1::3], rc_perm[2::3],
        ]
        return TraceTable.from_int_columns(aux_cols,
                                           device=main_trace.data.device)

    def _add_pub_memory_in_public_input_section(self, addresses, values):
        pub = self.pub_inputs_
        a_aux = list(addresses)
        v_aux = list(values)
        pub_len = len(pub.public_memory)
        section = len(addresses) - pub_len
        pub_addrs = self._get_pub_memory_addrs()
        for i, addr in enumerate(pub_addrs):
            a_aux[section + i] = addr
            v_aux[section + i] = pub.public_memory[addr]
        return a_aux, v_aux

    def _get_pub_memory_addrs(self):
        pub = self.pub_inputs_
        output_range = pub.memory_segments.get("output")
        pub_len = len(pub.public_memory)
        if output_range is not None:
            output_section = output_range.stop - output_range.start
            program_section = pub_len - output_section
            return list(range(1, program_section + 1)) + list(output_range)
        return list(range(1, pub_len + 1))

    # -- boundary constraints ----------------------------------------------

    def boundary_constraints(self, rc) -> BoundaryConstraints:
        pub = self.pub_inputs_
        off = self._builtin_offset()
        final_index = self.trace_length() - 1

        alpha, z = rc[RAP_ALPHA_MEMORY], rc[RAP_Z_MEMORY]
        prod = 1
        for addr, value in pub.public_memory.items():
            prod = prod * ((z - (addr + alpha * value)) % P) % P
        permutation_final = (
            pow(z, len(pub.public_memory), P) * pow(prod, P - 2, P) % P
        )

        return BoundaryConstraints.from_constraints([
            BoundaryConstraint(MEM_A_TRACE_OFFSET, 0, pub.pc_init % P),
            BoundaryConstraint(MEM_P_TRACE_OFFSET, 0, pub.ap_init % P),
            BoundaryConstraint(MEM_A_TRACE_OFFSET, pub.num_steps - 1, pub.pc_final % P),
            BoundaryConstraint(MEM_P_TRACE_OFFSET, pub.num_steps - 1, pub.ap_final % P),
            BoundaryConstraint(PERMUTATION_ARGUMENT_COL_3 - off, final_index,
                               permutation_final),
            BoundaryConstraint(PERMUTATION_ARGUMENT_RANGE_CHECK_COL_3 - off,
                               final_index, 1),
            BoundaryConstraint(RANGE_CHECK_COL_1 - off, 0, pub.range_check_min),
            BoundaryConstraint(RANGE_CHECK_COL_3 - off, final_index,
                               pub.range_check_max),
        ])

    # -- transition constraints --------------------------------------------

    def compute_transition(self, frame, rc):
        off = self._builtin_offset()
        curr = frame.get_row(0)
        nxt = frame.get_row(1)
        constraints = [None] * self.context.num_transition_constraints

        one = 1
        two = 2
        b15 = 1 << 15
        b16 = 1 << 16
        b32 = 1 << 32
        b48 = 1 << 48

        batched = hasattr(frame.ctx, "batch_shape")  # device whole-domain path

        # instruction bit constraints (0..15)
        if batched:
            dev = frame.ctx.device
            flags_stack = torch.stack([curr[i].v for i in range(15)], dim=1)
            ones_b = fd.from_ints([1] * 15, device=dev)
            bits = fd.mul(flags_stack,
                          fd.sub(flags_stack, ones_b[:, :, None]))
            for i in range(15):
                constraints[i] = frame.ctx.wrap(bits[:, i, :])
        else:
            for i in range(15):
                f = curr[i]
                constraints[i] = f * (f - one)
        constraints[15] = curr[15] * 1

        # instruction unpacking (16)
        if batched:
            pow2 = fd.from_ints([1 << i for i in range(15)], device=dev)
            weighted = fd.mul(flags_stack, pow2[:, :, None])
            f0_squiggle = frame.ctx.wrap(nttc.sum_reduce(weighted, axis=1))
        else:
            f0_squiggle = curr[14]
            for i in range(13, -1, -1):
                f0_squiggle = curr[i] + two * f0_squiggle
        constraints[16] = (
            curr[OFF_DST] + b16 * curr[OFF_OP0] + b32 * curr[OFF_OP1]
            + b48 * f0_squiggle - curr[FRAME_INST]
        )

        # operand constraints (17..19)
        ap = curr[FRAME_AP]
        fp = curr[FRAME_FP]
        pc = curr[FRAME_PC]
        constraints[17] = (
            curr[F_DST_FP] * fp + (one - curr[F_DST_FP]) * ap
            + (curr[OFF_DST] - b15) - curr[FRAME_DST_ADDR]
        )
        constraints[18] = (
            curr[F_OP_0_FP] * fp + (one - curr[F_OP_0_FP]) * ap
            + (curr[OFF_OP0] - b15) - curr[FRAME_OP0_ADDR]
        )
        constraints[19] = (
            curr[F_OP_1_VAL] * pc + curr[F_OP_1_AP] * ap + curr[F_OP_1_FP] * fp
            + (one - curr[F_OP_1_VAL] - curr[F_OP_1_AP] - curr[F_OP_1_FP])
            * curr[FRAME_OP0]
            + (curr[OFF_OP1] - b15) - curr[FRAME_OP1_ADDR]
        )

        # register constraints (20..25)
        inst_size = curr[F_OP_1_VAL] + one
        constraints[20] = (
            ap + curr[F_AP_ADD] * curr[FRAME_RES] + curr[F_AP_ONE]
            + curr[F_OPC_CALL] * two - nxt[FRAME_AP]
        )
        constraints[21] = (
            curr[F_OPC_RET] * curr[FRAME_DST]
            + curr[F_OPC_CALL] * (ap + two)
            + (one - curr[F_OPC_RET] - curr[F_OPC_CALL]) * fp
            - nxt[FRAME_FP]
        )
        constraints[22] = (curr[FRAME_T1] - curr[F_PC_JNZ]) * (
            nxt[FRAME_PC] - (pc + inst_size)
        )
        constraints[23] = (
            curr[FRAME_T0] * (nxt[FRAME_PC] - (pc + curr[FRAME_OP1]))
            + (one - curr[F_PC_JNZ]) * nxt[FRAME_PC]
            - (
                (one - curr[F_PC_ABS] - curr[F_PC_REL] - curr[F_PC_JNZ])
                * (pc + inst_size)
                + curr[F_PC_ABS] * curr[FRAME_RES]
                + curr[F_PC_REL] * (pc + curr[FRAME_RES])
            )
        )
        constraints[24] = curr[F_PC_JNZ] * curr[FRAME_DST] - curr[FRAME_T0]
        constraints[25] = curr[FRAME_T0] * curr[FRAME_RES] - curr[FRAME_T1]

        # opcode constraints (26..30)
        constraints[26] = curr[FRAME_MUL] - curr[FRAME_OP0] * curr[FRAME_OP1]
        constraints[27] = (
            curr[F_RES_ADD] * (curr[FRAME_OP0] + curr[FRAME_OP1])
            + curr[F_RES_MUL] * curr[FRAME_MUL]
            + (one - curr[F_RES_ADD] - curr[F_RES_MUL] - curr[F_PC_JNZ])
            * curr[FRAME_OP1]
            - (one - curr[F_PC_JNZ]) * curr[FRAME_RES]
        )
        constraints[28] = curr[F_OPC_CALL] * (curr[FRAME_DST] - fp)
        constraints[29] = curr[F_OPC_CALL] * (
            curr[FRAME_OP0] - (pc + inst_size)
        )
        constraints[30] = curr[F_OPC_AEQ] * (curr[FRAME_DST] - curr[FRAME_RES])

        # selector (applies to 16..30)
        if batched:
            grp = torch.stack([constraints[i].v for i in range(16, 31)], dim=1)
            sel = curr[FRAME_SELECTOR].v[:, None, :]
            grp = fd.mul(grp, sel)
            for i in range(16, 31):
                constraints[i] = frame.ctx.wrap(grp[:, i - 16, :])
        else:
            for i in range(16, 31):
                constraints[i] = constraints[i] * curr[FRAME_SELECTOR]

        # memory: increasing + consistency (31..38)
        def c(idx):
            return curr[idx - off]

        def nx(idx):
            return nxt[idx - off]

        ms = [c(MEMORY_ADDR_SORTED_0), c(MEMORY_ADDR_SORTED_1),
              c(MEMORY_ADDR_SORTED_2), c(MEMORY_ADDR_SORTED_3)]
        vs = [c(MEMORY_VALUES_SORTED_0), c(MEMORY_VALUES_SORTED_1),
              c(MEMORY_VALUES_SORTED_2), c(MEMORY_VALUES_SORTED_3)]
        ms_next0 = nx(MEMORY_ADDR_SORTED_0)
        vs_next0 = nx(MEMORY_VALUES_SORTED_0)

        if batched:
            # one batched multiply for the 8 memory constraints
            lhs = torch.stack(
                [(ms[k] - ms[k + 1]).v for k in range(3)]
                + [(ms[3] - ms_next0).v]
                + [(vs[k] - vs[k + 1]).v for k in range(3)]
                + [(vs[3] - vs_next0).v],
                dim=1,
            )
            step_diffs = (
                [(ms[k + 1] - ms[k] - one).v for k in range(3)]
                + [(ms_next0 - ms[3] - one).v]
            )
            rhs = torch.stack(step_diffs + step_diffs, dim=1)
            memc = fd.mul(lhs, rhs)
            for k in range(8):
                constraints[31 + k] = frame.ctx.wrap(memc[:, k, :])
        else:
            for k in range(3):
                constraints[31 + k] = (ms[k] - ms[k + 1]) * (ms[k + 1] - ms[k] - one)
            constraints[34] = (ms[3] - ms_next0) * (ms_next0 - ms[3] - one)
            for k in range(3):
                constraints[35 + k] = (vs[k] - vs[k + 1]) * (ms[k + 1] - ms[k] - one)
            constraints[38] = (vs[3] - vs_next0) * (ms_next0 - ms[3] - one)

        # memory permutation argument (39..42)
        alpha, z = rc[RAP_ALPHA_MEMORY], rc[RAP_Z_MEMORY]
        p = [c(PERMUTATION_ARGUMENT_COL_0), c(PERMUTATION_ARGUMENT_COL_1),
             c(PERMUTATION_ARGUMENT_COL_2), c(PERMUTATION_ARGUMENT_COL_3)]
        p0_next = nx(PERMUTATION_ARGUMENT_COL_0)
        a = [curr[FRAME_DST_ADDR], curr[FRAME_OP0_ADDR], curr[FRAME_OP1_ADDR]]
        v = [curr[FRAME_DST], curr[FRAME_OP0], curr[FRAME_OP1]]
        a0_next = nxt[FRAME_PC]
        v0_next = nxt[FRAME_INST]

        for k in range(3):
            constraints[39 + k] = (
                (z - (ms[k + 1] + alpha * vs[k + 1])) * p[k + 1]
                - (z - (a[k] + alpha * v[k])) * p[k]
            )
        constraints[42] = (
            (z - (ms_next0 + alpha * vs_next0)) * p0_next
            - (z - (a0_next + alpha * v0_next)) * p[3]
        )

        # range-check: increasing (43..45)
        r1 = c(RANGE_CHECK_COL_1)
        r2 = c(RANGE_CHECK_COL_2)
        r3 = c(RANGE_CHECK_COL_3)
        r1_next = nx(RANGE_CHECK_COL_1)
        constraints[43] = (r1 - r2) * (r2 - r1 - one)
        constraints[44] = (r2 - r3) * (r3 - r2 - one)
        constraints[45] = (r3 - r1_next) * (r1_next - r3 - one)

        # range-check permutation argument (46..48)
        zr = rc[RAP_Z_RANGE_CHECK]
        q = [c(PERMUTATION_ARGUMENT_RANGE_CHECK_COL_1),
             c(PERMUTATION_ARGUMENT_RANGE_CHECK_COL_2),
             c(PERMUTATION_ARGUMENT_RANGE_CHECK_COL_3)]
        q0_next = nx(PERMUTATION_ARGUMENT_RANGE_CHECK_COL_1)
        constraints[46] = (zr - r2) * q[1] - (zr - curr[OFF_OP0]) * q[0]
        constraints[47] = (zr - r3) * q[2] - (zr - curr[OFF_OP1]) * q[1]
        constraints[48] = (zr - r1_next) * q0_next - (zr - nxt[OFF_DST]) * q[2]

        if self.has_rc_builtin:
            acc = curr[RC_0]
            for k in range(1, 8):
                acc = acc + curr[RC_0 + k] * (1 << (16 * k))
            constraints[49] = acc - curr[RC_VALUE]

        return constraints


def generate_cairo_proof(trace: TraceTable, pub_inputs: PublicInputs,
                         proof_options: ProofOptions, *, device="cuda",
                         mesh=None, shard_axis: str = "domain",
                         donate_trace: bool = False):
    """Prove on ``device`` (the first CUDA card unless the caller names
    another device or the CPU).  Raises `ProvingError` where a CUDA device
    is asked for and there is none.  ``mesh`` and ``shard_axis``: the
    multi-device prover of ``prover.prove.prove``; ``donate_trace``: the
    caller gives ``trace`` up (its ``data`` is None afterwards) and the
    prover frees it once the auxiliary trace is built."""
    from ..prover.prove import prove

    return prove(trace, pub_inputs, proof_options, CairoAIR, device=device,
                 mesh=mesh, shard_axis=shard_axis, donate_trace=donate_trace)


def verify_cairo_proof(proof, pub_inputs: PublicInputs,
                       proof_options: ProofOptions) -> bool:
    from ..verifier.verify import verify

    return verify(proof, pub_inputs, proof_options, CairoAIR)
