"""Cairo1 CASM contract-class loading and entrypoint execution (reference
src/cairo/runner/run.rs:102-191, `CairoVersion::V1` arm).

A `CasmContractClass` JSON (`cairo-lang-starknet` compiled contract) carries
felt bytecode for the same CPU instruction set as Cairo0, plus per-pc hint
lists and entrypoint descriptors.  `run_casm_entrypoint` mirrors the
reference's function-runner setup behavior:

- program / execution segments, then one segment per entrypoint builtin
  (range_check for the standard external entrypoint);
- implicit args ``[*builtin_ptrs, initial_gas, syscall_ptr]`` with
  ``initial_gas = usize::MAX`` (run.rs:133-137);
- a builtin-costs segment of five zeros, pointed to by two extra words
  ``[ret_opcode, builtin_costs_ptr]`` appended after the bytecode
  (run.rs:141-152);
- an (empty) calldata segment, passed as ``[calldata_start, calldata_end]``
  (run.rs:154-167);
- a function call frame: args, return fp and a fresh end segment on the
  stack, ``fp = ap = execution_base + len(stack)``, ``pc = entrypoint``
  (cairo-vm `run_from_entrypoint` / `initialize_function_entrypoint`).

The deterministic core-library hints the Cairo1 compiler emits are
interpreted natively (cairo-vm `Cairo1HintProcessor` subset): segment
allocation (`AllocSegment`, `AllocConstantSize`), comparisons
(`TestLessThan`, `TestLessThanOrEqual`), 128/256-bit arithmetic
(`WideMul128`, `DivMod`, `Uint256DivMod`, `SquareRoot`,
`Uint256SquareRoot`, `LinearSplit`), the `assert_le_felt` arc protocol
(`AssertLeFindSmallArcs` + the two exclusion flags), the Felt252Dict /
segment-arena family (`AllocFelt252Dict`, `Felt252DictEntryInit`,
`Felt252DictEntryUpdate`, `GetSegmentArenaIndex`) and the squash-dict loop
(`InitSquashData`, `GetCurrentAccessIndex`, `ShouldSkipSquashLoop`,
`GetCurrentAccessDelta`, `ShouldContinueSquashLoop`, `GetNextDictKey`),
plus `DebugPrint`.  Anything else (EC/syscall hints) raises, as the
reference's prover pipeline has no syscall handler either
(run.rs:102-191)."""

from __future__ import annotations

import json

from ..field.params import P
from .vm import CairoVM, CairoVMError, Program, Relocatable

USIZE_MAX = (1 << 64) - 1
RET_OPCODE = 0x208B7FFF7FFF7FFE


class CasmContractClass:
    """Parsed `cairo-lang-starknet` CASM contract class."""

    def __init__(self, bytecode, hints, entrypoints):
        self.bytecode = bytecode          # list[int] felts
        self.hints = hints                # dict[pc_offset] -> list[hint dict]
        self.entrypoints = entrypoints    # list of {"offset": int, "builtins": [...]}

    @classmethod
    def from_json(cls, content: bytes | str) -> "CasmContractClass":
        obj = json.loads(content)
        bytecode = [int(x, 16) for x in obj["bytecode"]]
        hints = {int(pc): hs for pc, hs in obj.get("hints", [])}
        eps = [
            {"offset": ep["offset"], "builtins": ep.get("builtins", [])}
            for ep in obj.get("entry_points_by_type", {}).get("EXTERNAL", [])
        ]
        return cls(bytecode, hints, eps)


def _cell_addr(ref, ap, fp):
    base = ap if ref["register"].upper() == "AP" else fp
    return base + ref["offset"]


def _res_value(vm, operand, ap, fp):
    """Resolve a hint ResOperand to a felt/relocatable."""
    if "Immediate" in operand:
        return int(operand["Immediate"], 16) % P
    if "Deref" in operand:
        v = vm.mem_get(_cell_addr(operand["Deref"], ap, fp))
        if v is None:
            raise CairoVMError("hint deref of unknown cell")
        return v
    if "DoubleDeref" in operand:
        inner, off = operand["DoubleDeref"]
        ptr = vm.mem_get(_cell_addr(inner, ap, fp))
        if not isinstance(ptr, Relocatable):
            raise CairoVMError("hint double-deref through non-pointer")
        return vm.mem_get(ptr + off)
    if "BinOp" in operand:
        b = operand["BinOp"]
        a = _res_value(vm, {"Deref": b["a"]}, ap, fp)
        rhs = _res_value(vm, b["b"], ap, fp)
        if b["op"] == "Add":
            return CairoVM._add(a, rhs)
        if b["op"] == "Mul":
            return CairoVM._mul(a, rhs)
        raise CairoVMError(f"unsupported hint binop {b['op']}")
    raise CairoVMError(f"unsupported hint operand {list(operand)}")


def _as_int(v) -> int:
    if isinstance(v, Relocatable):
        raise CairoVMError("hint comparison on a relocatable")
    return v


_U128 = 1 << 128
_U64_MASK = (1 << 64) - 1
# canonical math.cairo arc-split constants (see hints_stdlib.py)
_PRIME_OVER_3_HIGH = 0x2AAAAAAAAAAAAB05555555555555556
_PRIME_OVER_2_HIGH = 0x4000000000000110000000000000000


def _isqrt(n: int) -> int:
    import math
    return math.isqrt(n)


class _SquashState:
    """cairo-vm DictSquashExecScope: loop state shared by the squash-dict
    hint family within one squash_dict call."""

    def __init__(self):
        self.access_indices: dict[int, list[int]] = {}
        self.keys: list[int] = []                 # descending; last = current
        self.current_access_indices: list[int] = []  # descending; last = next

    def current_key(self):
        if not self.keys:
            raise CairoVMError("squash-dict hint with no keys left")
        return self.keys[-1]


def _squash_state(vm) -> "_SquashState":
    st = vm.exec_scopes[0].get("__casm_squash__")
    if st is None:
        raise CairoVMError("squash-dict hint before InitSquashData")
    return st


def _dict_manager(vm):
    from .hints_stdlib import DictManager
    mgr = vm.exec_scopes[0].get("__casm_dict_manager__")
    if mgr is None:
        mgr = DictManager()
        mgr.order = []  # allocation order, for GetSegmentArenaIndex
        vm.exec_scopes[0]["__casm_dict_manager__"] = mgr
    return mgr


def _compile_hint(hint: dict):
    """One core-library hint dict -> callable(vm, ap, fp)."""
    (kind, body), = hint.items()
    # cairo-lang-casm wraps hints as {"Core": {...}} / {"Starknet": {...}};
    # unwrap one level so both framings dispatch identically
    if kind in ("Core", "Starknet", "External") and isinstance(body, dict):
        (kind, body), = body.items()

    if kind == "AllocSegment":
        dst = body["dst"]

        def run_alloc(vm, ap, fp):
            vm.mem_set(_cell_addr(dst, ap, fp), vm.add_segment())

        return run_alloc

    if kind in ("TestLessThan", "TestLessThanOrEqual"):
        lhs, rhs, dst = body["lhs"], body["rhs"], body["dst"]
        strict = kind == "TestLessThan"

        def run_cmp(vm, ap, fp):
            a = _as_int(_res_value(vm, lhs, ap, fp))
            b = _as_int(_res_value(vm, rhs, ap, fp))
            ok = a < b if strict else a <= b
            vm.mem_set(_cell_addr(dst, ap, fp), 1 if ok else 0)

        return run_cmp

    if kind == "WideMul128":
        lhs, rhs = body["lhs"], body["rhs"]
        high, low = body["high"], body["low"]

        def run_widemul(vm, ap, fp):
            v = (_as_int(_res_value(vm, lhs, ap, fp))
                 * _as_int(_res_value(vm, rhs, ap, fp)))
            vm.mem_set(_cell_addr(high, ap, fp), v >> 128)
            vm.mem_set(_cell_addr(low, ap, fp), v & (_U128 - 1))

        return run_widemul

    if kind == "DivMod":
        lhs, rhs = body["lhs"], body["rhs"]
        quotient, remainder = body["quotient"], body["remainder"]

        def run_divmod(vm, ap, fp):
            a = _as_int(_res_value(vm, lhs, ap, fp))
            b = _as_int(_res_value(vm, rhs, ap, fp))
            if b == 0:
                raise CairoVMError("DivMod hint: division by zero")
            q, r = divmod(a, b)
            vm.mem_set(_cell_addr(quotient, ap, fp), q)
            vm.mem_set(_cell_addr(remainder, ap, fp), r)

        return run_divmod

    if kind == "Uint256DivMod":
        ops = body

        def run_u256_divmod(vm, ap, fp):
            d0 = _as_int(_res_value(vm, ops["dividend0"], ap, fp))
            d1 = _as_int(_res_value(vm, ops["dividend1"], ap, fp))
            v0 = _as_int(_res_value(vm, ops["divisor0"], ap, fp))
            v1 = _as_int(_res_value(vm, ops["divisor1"], ap, fp))
            dividend = (d1 << 128) + d0
            divisor = (v1 << 128) + v0
            if divisor == 0:
                raise CairoVMError("Uint256DivMod hint: division by zero")
            q, r = divmod(dividend, divisor)
            vm.mem_set(_cell_addr(ops["quotient0"], ap, fp), q & (_U128 - 1))
            vm.mem_set(_cell_addr(ops["quotient1"], ap, fp), q >> 128)
            vm.mem_set(_cell_addr(ops["remainder0"], ap, fp), r & (_U128 - 1))
            vm.mem_set(_cell_addr(ops["remainder1"], ap, fp), r >> 128)

        return run_u256_divmod

    if kind == "SquareRoot":
        value, dst = body["value"], body["dst"]

        def run_sqrt(vm, ap, fp):
            vm.mem_set(_cell_addr(dst, ap, fp),
                       _isqrt(_as_int(_res_value(vm, value, ap, fp))))

        return run_sqrt

    if kind == "Uint256SquareRoot":
        ops = body

        def run_u256_sqrt(vm, ap, fp):
            lo = _as_int(_res_value(vm, ops["value_low"], ap, fp))
            hi = _as_int(_res_value(vm, ops["value_high"], ap, fp))
            n = (hi << 128) + lo
            s = _isqrt(n)
            rem = n - s * s
            vm.mem_set(_cell_addr(ops["sqrt0"], ap, fp), s & _U64_MASK)
            vm.mem_set(_cell_addr(ops["sqrt1"], ap, fp), s >> 64)
            vm.mem_set(_cell_addr(ops["remainder_low"], ap, fp),
                       rem & (_U128 - 1))
            vm.mem_set(_cell_addr(ops["remainder_high"], ap, fp), rem >> 128)
            vm.mem_set(
                _cell_addr(ops["sqrt_mul_2_minus_remainder_ge_u128"], ap, fp),
                1 if (2 * s - rem) >= _U128 else 0)

        return run_u256_sqrt

    if kind == "LinearSplit":
        ops = body

        def run_linear_split(vm, ap, fp):
            value = _as_int(_res_value(vm, ops["value"], ap, fp))
            scalar = _as_int(_res_value(vm, ops["scalar"], ap, fp))
            max_x = _as_int(_res_value(vm, ops["max_x"], ap, fp))
            x = min(value // scalar, max_x)
            vm.mem_set(_cell_addr(ops["x"], ap, fp), x)
            vm.mem_set(_cell_addr(ops["y"], ap, fp), value - x * scalar)

        return run_linear_split

    if kind == "AssertLeFindSmallArcs":
        ops = body

        def run_find_arcs(vm, ap, fp):
            a = _as_int(_res_value(vm, ops["a"], ap, fp)) % P
            b = _as_int(_res_value(vm, ops["b"], ap, fp)) % P
            rc = _res_value(vm, ops["range_check_ptr"], ap, fp)
            arcs = sorted([(a, 0), ((b - a) % P, 1), ((P - 1 - b) % P, 2)])
            vm.exec_scopes[0]["__casm_excluded_arc__"] = arcs[2][1]
            q0, r0 = divmod(arcs[0][0], _PRIME_OVER_3_HIGH)
            q1, r1 = divmod(arcs[1][0], _PRIME_OVER_2_HIGH)
            vm.mem_set(rc + 0, r0)
            vm.mem_set(rc + 1, q0)
            vm.mem_set(rc + 2, r1)
            vm.mem_set(rc + 3, q1)

        return run_find_arcs

    if kind in ("AssertLeIsFirstArcExcluded", "AssertLeIsSecondArcExcluded"):
        which = 0 if kind == "AssertLeIsFirstArcExcluded" else 1
        flag = body["skip_exclude_a_flag" if which == 0
                    else "skip_exclude_b_flag"]

        def run_arc_flag(vm, ap, fp):
            excluded = vm.exec_scopes[0].get("__casm_excluded_arc__")
            if excluded is None:
                raise CairoVMError(
                    "arc-exclusion hint before AssertLeFindSmallArcs")
            vm.mem_set(_cell_addr(flag, ap, fp),
                       1 if excluded != which else 0)

        return run_arc_flag

    if kind == "AllocFelt252Dict":
        arena = body["segment_arena_ptr"]

        def run_alloc_dict(vm, ap, fp):
            arena_ptr = _res_value(vm, arena, ap, fp)
            # SegmentArena layout: [infos_start, n_segments, n_finalized]
            # immediately before arena_ptr (segment_arena.cairo)
            infos = vm.mem_get(arena_ptr - 3)
            n_dicts = vm.mem_get(arena_ptr - 2)
            mgr = _dict_manager(vm)
            base = mgr.new_default_dict(vm, 0)
            mgr.order.append(base.segment)
            vm.mem_set(infos + 3 * n_dicts, base)

        return run_alloc_dict

    if kind == "Felt252DictEntryInit":
        ops = body

        def run_entry_init(vm, ap, fp):
            dict_ptr = _res_value(vm, ops["dict_ptr"], ap, fp)
            key = _res_value(vm, ops["key"], ap, fp)
            mgr = _dict_manager(vm)
            tracker = mgr.trackers.get(dict_ptr.segment)
            if tracker is None:
                raise CairoVMError(
                    f"Felt252DictEntryInit on unknown dict segment "
                    f"{dict_ptr.segment}")
            # entry layout = DictAccess {key, prev_value, new_value}
            vm.mem_set(dict_ptr + 1, tracker.get(key))
            tracker.current_ptr = dict_ptr + 3

        return run_entry_init

    if kind == "Felt252DictEntryUpdate":
        ops = body

        def run_entry_update(vm, ap, fp):
            dict_ptr = _res_value(vm, ops["dict_ptr"], ap, fp)
            value = _res_value(vm, ops["value"], ap, fp)
            mgr = _dict_manager(vm)
            tracker = mgr.trackers.get(dict_ptr.segment)
            if tracker is None:
                raise CairoVMError(
                    f"Felt252DictEntryUpdate on unknown dict segment "
                    f"{dict_ptr.segment}")
            key = vm.mem_get(dict_ptr - 3)
            tracker.data[key] = value

        return run_entry_update

    if kind == "GetSegmentArenaIndex":
        ops = body

        def run_arena_index(vm, ap, fp):
            dict_end = _res_value(vm, ops["dict_end_ptr"], ap, fp)
            mgr = _dict_manager(vm)
            try:
                idx = mgr.order.index(dict_end.segment)
            except ValueError:
                raise CairoVMError(
                    f"GetSegmentArenaIndex: segment {dict_end.segment} is "
                    f"not an arena dict")
            vm.mem_set(_cell_addr(ops["dict_index"], ap, fp), idx)

        return run_arena_index

    if kind == "InitSquashData":
        ops = body

        def run_init_squash(vm, ap, fp):
            address = _res_value(vm, ops["dict_accesses"], ap, fp)
            ptr_diff = _as_int(_res_value(vm, ops["ptr_diff"], ap, fp))
            n_accesses = _as_int(_res_value(vm, ops["n_accesses"], ap, fp))
            if ptr_diff % 3 != 0:
                raise CairoVMError(
                    "InitSquashData: accesses array size must be divisible "
                    "by DictAccess.SIZE")
            st = _SquashState()
            vm.exec_scopes[0]["__casm_squash__"] = st
            for i in range(n_accesses):
                key = vm.mem_get(address + 3 * i)
                st.access_indices.setdefault(key, []).append(i)
            st.keys = sorted(st.access_indices.keys(), reverse=True)
            if not st.keys:
                raise CairoVMError(
                    "InitSquashData: no dict accesses (empty keys)")
            vm.mem_set(_cell_addr(ops["big_keys"], ap, fp),
                       1 if st.keys[0] >= _U128 else 0)
            vm.mem_set(_cell_addr(ops["first_key"], ap, fp),
                       st.current_key())

        return run_init_squash

    if kind == "GetCurrentAccessIndex":
        ops = body

        def run_current_index(vm, ap, fp):
            st = _squash_state(vm)
            if not st.current_access_indices:
                st.current_access_indices = sorted(
                    st.access_indices[st.current_key()], reverse=True)
            rc = _res_value(vm, ops["range_check_ptr"], ap, fp)
            vm.mem_set(rc, st.current_access_indices[-1])

        return run_current_index

    if kind == "ShouldSkipSquashLoop":
        dst = body["should_skip_loop"]

        def run_should_skip(vm, ap, fp):
            st = _squash_state(vm)
            vm.mem_set(_cell_addr(dst, ap, fp),
                       0 if len(st.current_access_indices) > 1 else 1)

        return run_should_skip

    if kind == "GetCurrentAccessDelta":
        dst = body["index_delta_minus1"]

        def run_access_delta(vm, ap, fp):
            st = _squash_state(vm)
            prev = st.current_access_indices.pop()
            vm.mem_set(_cell_addr(dst, ap, fp),
                       st.current_access_indices[-1] - prev - 1)

        return run_access_delta

    if kind == "ShouldContinueSquashLoop":
        dst = body["should_continue"]

        def run_should_continue(vm, ap, fp):
            st = _squash_state(vm)
            vm.mem_set(_cell_addr(dst, ap, fp),
                       1 if len(st.current_access_indices) > 1 else 0)

        return run_should_continue

    if kind == "GetNextDictKey":
        dst = body["next_key"]

        def run_next_key(vm, ap, fp):
            st = _squash_state(vm)
            st.keys.pop()
            st.current_access_indices = []
            vm.mem_set(_cell_addr(dst, ap, fp), st.current_key())

        return run_next_key

    if kind == "AllocConstantSize":
        ops = body

        def run_alloc_const(vm, ap, fp):
            # a fresh segment serves as a buffer of at least `size` cells
            _res_value(vm, ops["size"], ap, fp)
            vm.mem_set(_cell_addr(ops["dst"], ap, fp), vm.add_segment())

        return run_alloc_const

    if kind == "Uint512DivModByUint256":
        ops = body

        def run_u512_divmod(vm, ap, fp):
            d = [_as_int(_res_value(vm, ops[f"dividend{i}"], ap, fp))
                 for i in range(4)]
            dv = [_as_int(_res_value(vm, ops[f"divisor{i}"], ap, fp))
                  for i in range(2)]
            dividend = sum(x << (128 * i) for i, x in enumerate(d))
            divisor = dv[0] | (dv[1] << 128)
            if divisor == 0:
                raise CairoVMError("Uint512DivModByUint256 by zero")
            q, r = divmod(dividend, divisor)
            for i in range(4):
                vm.mem_set(_cell_addr(ops[f"quotient{i}"], ap, fp),
                           (q >> (128 * i)) & (_U128 - 1))
            for i in range(2):
                vm.mem_set(_cell_addr(ops[f"remainder{i}"], ap, fp),
                           (r >> (128 * i)) & (_U128 - 1))

        return run_u512_divmod

    if kind == "RandomEcPoint":
        ops = body

        def run_random_ec_point(vm, ap, fp):
            # deterministic scan for a curve point (any valid point makes
            # the guarantee logic sound; cairo-vm samples randomly)
            from .builtins import ALPHA, BETA, P as _P, sqrt_mod_p

            x = 1
            while True:
                y = sqrt_mod_p((pow(x, 3, _P) + ALPHA * x + BETA) % _P)
                if y is not None:
                    break
                x += 1
            vm.mem_set(_cell_addr(ops["x"], ap, fp), x)
            vm.mem_set(_cell_addr(ops["y"], ap, fp), min(y, _P - y))

        return run_random_ec_point

    if kind == "FieldSqrt":
        ops = body

        def run_field_sqrt(vm, ap, fp):
            # sqrt of val when QR, else sqrt of 3*val (3 is a non-residue
            # mod the Stark prime); the smaller root is written — cairo-vm
            # Cairo1HintProcessor FieldSqrt semantics
            from .builtins import P as _P, sqrt_mod_p

            val = _as_int(_res_value(vm, ops["val"], ap, fp)) % _P
            r = sqrt_mod_p(val)
            if r is None:
                r = sqrt_mod_p(3 * val % _P)
                if r is None:
                    raise CairoVMError("FieldSqrt: 3*val also a non-residue")
            vm.mem_set(_cell_addr(ops["sqrt"], ap, fp), min(r, _P - r))

        return run_field_sqrt

    if kind == "U256InvModN":
        ops = body

        def run_u256_inv_mod_n(vm, ap, fp):
            """Extended-gcd witness for b^-1 mod n over Uint256 limbs
            (cairo-vm U256InvModN): when gcd == 1 writes the inverse limbs
            + Bezout witnesses through `g0_or_no_inv == 0`; otherwise
            writes the gcd limbs with g0_or_no_inv != 0."""
            b = (_as_int(_res_value(vm, ops["b0"], ap, fp))
                 | _as_int(_res_value(vm, ops["b1"], ap, fp)) << 128)
            n = (_as_int(_res_value(vm, ops["n0"], ap, fp))
                 | _as_int(_res_value(vm, ops["n1"], ap, fp)) << 128)

            def ext_gcd(a, m):
                old_r, r = a, m
                old_s, s = 1, 0
                while r:
                    qt = old_r // r
                    old_r, r = r, old_r - qt * r
                    old_s, s = s, old_s - qt * s
                return old_r, old_s

            g = ext_gcd(b % n, n)[0] if n > 1 else 1
            if n > 1 and g == 1:
                inv = ext_gcd(b % n, n)[1] % n
                vm.mem_set(_cell_addr(ops["g0_or_no_inv"], ap, fp), 0)
                vm.mem_set(_cell_addr(ops["s_or_r0"], ap, fp),
                           inv & (_U128 - 1))
                vm.mem_set(_cell_addr(ops["s_or_r1"], ap, fp), inv >> 128)
                t = (inv * b - 1) // n  # Bezout co-witness: inv*b - 1 = t*n
                vm.mem_set(_cell_addr(ops["t_or_k0"], ap, fp),
                           t & (_U128 - 1))
                vm.mem_set(_cell_addr(ops["t_or_k1"], ap, fp), t >> 128)
            else:
                # no inverse (gcd > 1), or the degenerate n == 1: publish a
                # common divisor g with its cofactor witnesses b = r*g,
                # n = k*g (the corelib checks exactly these products)
                r_w, k_w = b // g, n // g
                vm.mem_set(_cell_addr(ops["g0_or_no_inv"], ap, fp),
                           g & (_U128 - 1))
                vm.mem_set(_cell_addr(ops["g1_option"], ap, fp), g >> 128)
                vm.mem_set(_cell_addr(ops["s_or_r0"], ap, fp),
                           r_w & (_U128 - 1))
                vm.mem_set(_cell_addr(ops["s_or_r1"], ap, fp), r_w >> 128)
                vm.mem_set(_cell_addr(ops["t_or_k0"], ap, fp),
                           k_w & (_U128 - 1))
                vm.mem_set(_cell_addr(ops["t_or_k1"], ap, fp), k_w >> 128)

        return run_u256_inv_mod_n

    if kind == "DebugPrint":
        ops = body

        def run_debug_print(vm, ap, fp):
            start = _res_value(vm, ops["start"], ap, fp)
            end = _res_value(vm, ops["end"], ap, fp)
            vals = vm.get_range(start, end.offset - start.offset)
            print("[cairo1 debug]", [hex(v) if isinstance(v, int) else v
                                     for v in vals])

        return run_debug_print

    raise CairoVMError(f"unsupported Cairo1 hint {kind!r}")


def _compile_hints(hint_lists: dict[int, list]):
    out = {}
    for pc, hints in hint_lists.items():
        compiled = [_compile_hint(h) for h in hints]

        def run_all(vm, ap, fp, _c=compiled):
            for h in _c:
                h(vm, ap, fp)

        out[pc] = run_all
    return out


def run_casm_entrypoint(casm: CasmContractClass, entrypoint_idx: int = 0,
                        max_steps: int = 1 << 24):
    """Execute an EXTERNAL entrypoint; returns the same 4-tuple as
    `vm.run_program` (register states, memory, data_len, builtin ranges)."""
    if not casm.entrypoints:
        raise CairoVMError("contract has no EXTERNAL entrypoints")
    ep = casm.entrypoints[entrypoint_idx]

    program = Program(data=list(casm.bytecode), main_pc=ep["offset"],
                      builtins=list(ep["builtins"]))
    vm = CairoVM(program)
    vm.hints = _compile_hints(casm.hints)

    program_base = vm.add_segment()
    execution_base = vm.add_segment()
    for i, word in enumerate(program.data):
        vm.mem_set(program_base + i, word)

    builtin_ptrs = []
    for name in ep["builtins"]:
        base = vm.add_segment()
        vm.builtin_bases[name] = base
        builtin_ptrs.append(base)

    syscall_ptr = vm.add_segment()

    builtin_costs_ptr = vm.add_segment()
    for i in range(5):
        vm.mem_set(builtin_costs_ptr + i, 0)

    # extra words after the bytecode: a `ret` and the builtin-costs pointer
    vm.mem_set(program_base + len(program.data), RET_OPCODE)
    vm.mem_set(program_base + len(program.data) + 1, builtin_costs_ptr)

    calldata_start = vm.add_segment()
    calldata_end = calldata_start  # no calldata

    stack = [*builtin_ptrs, USIZE_MAX, syscall_ptr, calldata_start,
             calldata_end]
    return_fp = vm.add_segment()
    end = vm.add_segment()
    stack.extend([return_fp, end])
    for i, v in enumerate(stack):
        vm.mem_set(execution_base + i, v)

    ap = fp = execution_base + len(stack)
    pc = program_base + ep["offset"]
    vm.run_until(pc, ap, fp, end, max_steps)

    register_states, memory, _, builtin_ranges = vm.relocate()
    # data_len excludes the two extra words (run.rs:213 uses the program's
    # own data length for the public-memory code segment)
    return register_states, memory, len(casm.bytecode), builtin_ranges
