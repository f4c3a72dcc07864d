"""Cairo main-trace construction (reference src/cairo/execution_trace.rs).

Builds the 33/34-column main trace from register states + memory: decoded
flag bits, computed operands (dst/op0/op1/res), derived columns (t0/t1/mul),
range-check hole filling, memory hole filling, public-memory dummy rows and
power-of-two padding.  Column layout (reference execution_trace.rs:39-51):

  0-15  flags, 16 res, 17 ap, 18 fp, 19 pc, 20 dst_addr, 21 op0_addr,
  22 op1_addr, 23 inst, 24 dst, 25 op0, 26 op1, 27-29 offsets, 30 t0,
  31 t1, 32 mul, 33 selector [, 34-41 rc_0..rc_7, 42 rc_value]
"""

from __future__ import annotations

import time

import torch

from ..air.trace import TraceTable
from ..field.params import P
from .cairo_mem import CairoMemory
from .decode import (
    AP_UPDATE_OFF, InstructionDecodingError, OP1_SRC_AP, OP1_SRC_IMM,
    OP1_SRC_OFF, OP1_SRC_OP0, OPCODE_ASSERT_EQ, OPCODE_CALL, OPCODE_OFF,
    PC_JNZ, PC_UPDATE_OFF, RES_ADD, RES_LOGIC_OFF, RES_MUL,
)
from .register_states import RegisterStates

# column indices (mirror reference air.rs:93-121)
FRAME_RES = 16
FRAME_AP = 17
FRAME_FP = 18
FRAME_PC = 19
FRAME_DST_ADDR = 20
FRAME_OP0_ADDR = 21
FRAME_OP1_ADDR = 22
FRAME_INST = 23
FRAME_DST = 24
FRAME_OP0 = 25
FRAME_OP1 = 26
OFF_DST = 27
OFF_OP0 = 28
OFF_OP1 = 29
FRAME_T0 = 30
FRAME_T1 = 31
FRAME_MUL = 32
FRAME_SELECTOR = 33

ADDR_COLUMNS = [FRAME_PC, FRAME_DST_ADDR, FRAME_OP0_ADDR, FRAME_OP1_ADDR]
MEMORY_COLUMNS = [
    FRAME_PC, FRAME_DST_ADDR, FRAME_OP0_ADDR, FRAME_OP1_ADDR,
    FRAME_INST, FRAME_DST, FRAME_OP0, FRAME_OP1,
]


def _batch_inv_mod_p(vals: list[int]) -> list[int]:
    """Montgomery-trick batch inverse on host: one modular exponentiation
    for the whole batch instead of one per element (zeros map to zero,
    matching the jnz dst^-1 convention)."""
    nz_idx = [i for i, v in enumerate(vals) if v != 0]
    acc = 1
    prefix = []
    for i in nz_idx:
        acc = acc * vals[i] % P
        prefix.append(acc)
    inv = pow(acc, P - 2, P) if nz_idx else 1
    out = [0] * len(vals)
    for j in range(len(nz_idx) - 1, -1, -1):
        i = nz_idx[j]
        out[i] = inv * (prefix[j - 1] if j else 1) % P
        inv = inv * vals[i] % P
    return out


def build_cairo_execution_trace(
    raw_trace: RegisterStates, memory: CairoMemory, public_inputs
) -> list[list[int]]:
    """Returns trace as a list of int columns (33/34 cols x n_steps).

    Vectorized over steps: registers/instructions/addresses are u64 numpy
    bit math (reference does this per step, execution_trace.rs:261-356);
    only the felt-valued arithmetic (res/t0/t1/mul and memory values) runs
    as host bigints, with the jnz inverses batched into one exponentiation."""
    import numpy as np

    n = raw_trace.steps
    rows = raw_trace.rows

    pcs_l = [r.pc for r in rows]
    instructions = [memory.get(p) for p in pcs_l]
    for p, inst in zip(pcs_l, instructions):
        if inst is None:
            raise ValueError(f"no instruction at pc {p}")
    pc_arr = np.asarray(pcs_l, dtype=np.uint64)
    ap_arr = np.asarray([r.ap for r in rows], dtype=np.uint64)
    fp_arr = np.asarray([r.fp for r in rows], dtype=np.uint64)
    inst_arr = np.asarray(instructions, dtype=np.uint64)

    # ---- flag decode + validation (decode.py semantics, vectorized) ----
    flags_f = inst_arr >> np.uint64(48)
    if (flags_f >> np.uint64(15)).any():
        raise InstructionDecodingError("instruction flags exceed 15 bits")

    def group(off, mask):
        return (flags_f >> np.uint64(off)) & np.uint64(mask)

    op1_src = group(OP1_SRC_OFF, 0b111)
    res_logic = group(RES_LOGIC_OFF, 0b11)
    pc_update = group(PC_UPDATE_OFF, 0b111)
    ap_update = group(AP_UPDATE_OFF, 0b11)
    opcode = group(OPCODE_OFF, 0b111)
    for name, arr, valid in (
        ("op1_src", op1_src, (0, 1, 2, 4)),
        ("res_logic", res_logic, (0, 1, 2)),
        ("pc_update", pc_update, (0, 1, 2, 4)),
        ("ap_update", ap_update, (0, 1, 2)),
        ("opcode", opcode, (0, 1, 2, 4)),
    ):
        if not np.isin(arr, np.asarray(valid, dtype=np.uint64)).all():
            raise InstructionDecodingError(f"invalid {name}")

    flag_cols = [((flags_f >> np.uint64(j)) & np.uint64(1)).tolist()
                 for j in range(16)]

    # ---- offsets: biased raw == unbiased trace representation ----
    od_raw = inst_arr & np.uint64(0xFFFF)
    oo_raw = (inst_arr >> np.uint64(16)) & np.uint64(0xFFFF)
    o1_raw = (inst_arr >> np.uint64(32)) & np.uint64(0xFFFF)
    off_cols = [od_raw.tolist(), oo_raw.tolist(), o1_raw.tolist()]
    od_s = od_raw.astype(np.int64) - (1 << 15)
    oo_s = oo_raw.astype(np.int64) - (1 << 15)
    o1_s = o1_raw.astype(np.int64) - (1 << 15)

    # ---- operand addresses + memory values ----
    dst_reg = (flags_f & np.uint64(1)).astype(bool)
    op0_reg = ((flags_f >> np.uint64(1)) & np.uint64(1)).astype(bool)
    dst_addr = np.where(dst_reg, fp_arr, ap_arr).astype(np.int64) + od_s
    op0_addr = np.where(op0_reg, fp_arr, ap_arr).astype(np.int64) + oo_s
    dst_addrs = dst_addr.tolist()
    op0_addrs = op0_addr.tolist()
    dsts = [memory.get(a) for a in dst_addrs]
    op0s = [memory.get(a) for a in op0_addrs]

    # op1 base: op0-value rows involve felt arithmetic -> per-row path
    op1_base = np.where(
        op1_src == OP1_SRC_IMM, pc_arr,
        np.where(op1_src == OP1_SRC_AP, ap_arr, fp_arr),
    ).astype(np.int64)
    op1_addr_v = op1_base + o1_s
    op1_addrs = op1_addr_v.tolist()
    op0_rows = np.flatnonzero(op1_src == OP1_SRC_OP0)
    for i in op0_rows.tolist():
        op1_addrs[i] = (op0s[i] + int(o1_s[i])) % P
    op1s = [memory.get(a) for a in op1_addrs]

    # ---- res (opcode semantics incl. jnz dst^-1, batched inverse) ----
    res = list(op1s)  # RES_OP1 default
    add_rows = np.flatnonzero(res_logic == RES_ADD)
    for i in add_rows.tolist():
        res[i] = (op0s[i] + op1s[i]) % P
    mul_rows = np.flatnonzero(res_logic == RES_MUL)
    for i in mul_rows.tolist():
        res[i] = op0s[i] * op1s[i] % P
    jnz_rows = np.flatnonzero(pc_update == PC_JNZ).tolist()
    if jnz_rows:
        inv = _batch_inv_mod_p([dsts[i] for i in jnz_rows])
        for j, i in enumerate(jnz_rows):
            res[i] = inv[j]

    # update op0/dst/res for call and assert_eq (execution_trace.rs:570-592)
    call_rows = np.flatnonzero(opcode == OPCODE_CALL)
    inst_size = np.where(op1_src == OP1_SRC_IMM, 2, 1)
    for i in call_rows.tolist():
        op0s[i] = (int(pc_arr[i]) + int(inst_size[i])) % P
        dsts[i] = int(fp_arr[i]) % P
    for i in np.flatnonzero(opcode == OPCODE_ASSERT_EQ).tolist():
        res[i] = dsts[i]

    aps = ap_arr.tolist()
    fps = fp_arr.tolist()
    pcs = pcs_l

    # t0 = f_jnz * dst, t1 = t0 * res: nonzero only on jnz rows
    t0 = [0] * n
    t1 = [0] * n
    for i in jnz_rows:
        t0[i] = dsts[i]
        t1[i] = dsts[i] * res[i] % P
    mul = [op0s[i] * op1s[i] % P for i in range(n)]
    selector = [1] * (n - 1) + [0]

    trace_cols = (
        flag_cols
        + [res, aps, fps, pcs, dst_addrs, op0_addrs, op1_addrs, instructions,
           dsts, op0s, op1s]
        + off_cols
        + [t0, t1, mul, selector]
    )

    rc_range = public_inputs.memory_segments.get("range_check")
    if rc_range is not None:
        _add_rc_builtin_columns(trace_cols, rc_range, memory)

    return trace_cols


def _add_rc_builtin_columns(trace_cols, rc_range, memory):
    """rc_0..rc_7 16-bit limb decomposition + rc_value columns
    (execution_trace.rs:358-379, 604-624)."""
    n = len(trace_cols[0])
    values = [memory.get(addr) for addr in rc_range]
    for limb in range(8):
        col = [(v >> (16 * limb)) & 0xFFFF for v in values]
        col += [0] * (n - len(col))
        trace_cols.append(col)
    vals_col = list(values) + [0] * (n - len(values))
    trace_cols.append(vals_col)


def get_rc_holes(trace_cols) -> tuple[list[int], int, int]:
    """Missing offset values to make the range contiguous
    (execution_trace.rs:136-173); returns (holes padded to x3, min, max)."""
    offset_vals = sorted(
        trace_cols[OFF_DST] + trace_cols[OFF_OP0] + trace_cols[OFF_OP1]
    )
    holes = []
    for a, b in zip(offset_vals, offset_vals[1:]):
        if b != a:
            holes.extend(range(a + 1, b))
    pad = ((len(holes) + 2) // 3) * 3 - len(holes)
    holes.extend([offset_vals[-1]] * pad)
    return holes, offset_vals[0], offset_vals[-1]


def fill_rc_holes(trace_cols, holes) -> None:
    """Appends rows with holes in the offset columns, zeros elsewhere."""
    n_new = len(holes) // 3
    for c, col in enumerate(trace_cols):
        if c == OFF_DST:
            col.extend(holes[0::3])
        elif c == OFF_OP0:
            col.extend(holes[1::3])
        elif c == OFF_OP1:
            col.extend(holes[2::3])
        else:
            col.extend([0] * n_new)


def get_memory_holes(sorted_addrs: list[int], codelen: int) -> list[int]:
    """Unaccessed addresses inside the touched range, excluding the program
    segment (execution_trace.rs:195-222)."""
    holes = []
    prev = sorted_addrs[0]
    for addr in sorted_addrs:
        diff = addr - prev
        if diff not in (0, 1) and addr > codelen:
            for hole in range(prev + 1, addr):
                if hole > codelen:
                    holes.append(hole)
        prev = addr
    return holes


def fill_memory_holes(trace_cols, memory_holes: list[int]) -> None:
    """Pads with the last row, placing hole addresses into address columns."""
    n_addr = len(ADDR_COLUMNS)
    padding_size = -(-len(memory_holes) // n_addr)
    it = iter(memory_holes)
    last_row = [col[-1] for col in trace_cols]
    for _ in range(padding_size):
        row = list(last_row)
        for a_col in ADDR_COLUMNS:
            hole = next(it, None)
            if hole is not None:
                row[a_col] = hole
        for c, col in enumerate(trace_cols):
            col.append(row[c])


def add_pub_memory_dummy_accesses(trace_cols, pub_memory_len: int) -> None:
    """(0,0) dummy accesses for public memory (whitepaper 9.8);
    (pub_memory_len >> 2) + 1 rows padded with last row, memory cols zero."""
    n_rows = (pub_memory_len >> 2) + 1
    last_row = [col[-1] for col in trace_cols]
    for c in MEMORY_COLUMNS:
        last_row[c] = 0
    for _ in range(n_rows):
        for c, col in enumerate(trace_cols):
            col.append(last_row[c])


def pad_with_last_row(trace_cols, number_rows: int) -> None:
    last_row = [col[-1] for col in trace_cols]
    for _ in range(number_rows):
        for c, col in enumerate(trace_cols):
            col.append(last_row[c])


def build_main_trace_columns(
    raw_trace: RegisterStates, memory: CairoMemory, public_inputs
) -> list[list[int]]:
    """Reference build_main_trace (execution_trace.rs:57-87) up to the
    padded int columns, all on the host.  Sets
    ``public_inputs.range_check_min`` / ``range_check_max``."""
    trace_cols = build_cairo_execution_trace(raw_trace, memory, public_inputs)

    address_cols = sorted(
        trace_cols[FRAME_PC] + trace_cols[FRAME_DST_ADDR]
        + trace_cols[FRAME_OP0_ADDR] + trace_cols[FRAME_OP1_ADDR]
    )

    holes, rc_min, rc_max = get_rc_holes(trace_cols)
    public_inputs.range_check_min = rc_min
    public_inputs.range_check_max = rc_max
    fill_rc_holes(trace_cols, holes)

    memory_holes = get_memory_holes(address_cols, len(public_inputs.public_memory))
    if memory_holes:
        fill_memory_holes(trace_cols, memory_holes)

    add_pub_memory_dummy_accesses(trace_cols, len(public_inputs.public_memory))

    n_rows = len(trace_cols[0])
    target = 1 if n_rows <= 1 else 1 << (n_rows - 1).bit_length()
    pad_with_last_row(trace_cols, target - n_rows)
    return trace_cols


def build_main_trace(
    raw_trace: RegisterStates, memory: CairoMemory, public_inputs, *, device
) -> TraceTable:
    """The main trace as a tensor on ``device``: the columns of
    :func:`build_main_trace_columns` through the compact ingest.  The seconds
    of the two stages are left on the trace's ``_timings`` ("trace_build" on
    the host, "ingest" with its device work), as prove() leaves its rounds'
    on ``proof._timings``."""
    device = torch.device(device)
    t0 = time.perf_counter()
    cols = build_main_trace_columns(raw_trace, memory, public_inputs)
    t1 = time.perf_counter()
    trace = TraceTable.from_int_columns(cols, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    trace._timings = {"trace_build": t1 - t0,
                      "ingest": time.perf_counter() - t1}
    return trace
