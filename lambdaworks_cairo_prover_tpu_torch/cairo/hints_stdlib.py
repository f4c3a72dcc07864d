"""Starkware-stdlib Cairo0 hints beyond the core math subset in hints.py.

The reference prover executes hinted Cairo0 programs through the `cairo-vm`
crate's `BuiltinHintProcessor` (reference src/cairo/runner/run.rs:76-101),
which dispatches on the hint's exact source string.  This module covers the
high-traffic starkware common-library families that processor knows:

  math.cairo      assert_not_zero / assert_not_equal / assert_le_felt (+ 3
                  exclusion follow-ups) / assert_lt_felt / assert_250_bit /
                  split_felt / split_int / sqrt / abs_value
  memcpy/memset   scope-carried loop counters (vm_enter_scope / n -= 1)
  find_element    find_element / search_sorted_lower
  set.cairo       set_add
  dict.cairo      dict_new / default_dict_new / dict_read / dict_write /
                  dict_update / dict_squash prologue + squash_dict and its
                  eight inner loop hints (DictManager + execution scopes)
  uint256.cairo   uint256_add / split_64 / uint256_sqrt / uint256_signed_nn /
                  uint256_unsigned_div_rem / uint256_mul_div_mod

Source strings follow the starkware cairo-lang common library (the same
registry cairo-vm's hint_code.rs mirrors).  Implementations are native
Python over the VM's memory/scope API — the embedded Python in the hint
text is never executed.  Struct member access (`ids.a.low`,
`ids.loop_temps.should_continue`) is implemented with the canonical member
offsets of the common-library structs (Uint256 {low:0, high:1}, DictAccess
{key:0, prev_value:1, new_value:2}, squash_dict LoopTemps
{index_delta_minus1:0, index_delta:1, ptr_delta:2, should_continue:3}),
which are protocol constants.

Unknown-hint behavior is unchanged: anything not in the merged registry
still raises `UnknownHintError` loudly (hints.py:execute_hint).
"""

from __future__ import annotations

import re

from ..field.params import P

RC_BOUND = 1 << 128

# canonical common-library constants (math.cairo, uint256.cairo); hints
# normally read these through constant references, but hand-assembled test
# programs may omit them, so impls fall back to these values
SHIFT_128 = 1 << 128
UPPER_BOUND_250 = 1 << 250
MAX_HIGH = (P - 1) >> 128
MAX_LOW = (P - 1) & (SHIFT_128 - 1)
PRIME_OVER_3_HIGH = 0x2AAAAAAAAAAAAB05555555555555556
PRIME_OVER_2_HIGH = 0x4000000000000110000000000000000

DICT_ACCESS_SIZE = 3


class _HintErr(Exception):
    # rebound to hints.HintError at registration time (register() below);
    # defined here so the module has no import-time dependency on hints.py
    pass


HintError = _HintErr


def _as_int(v: int) -> int:
    """Signed representative in (-P/2, P/2] (starkware math_utils.as_int)."""
    return v if v < P // 2 else v - P


def _ids_get(ids, name, default=None):
    """ids.<name>, falling back to `default` ONLY when the hint carries no
    reference for the name (hand-assembled fixtures omitting stdlib
    constants).  A present-but-broken reference (uninitialized cell, bad
    AST) propagates — silently substituting the canonical constant would
    mask real program errors."""
    try:
        return ids.get(name)
    except HintError as e:
        if default is not None and "no reference for ids." in str(e):
            return default
        raise


_PTR_CAST_RE = re.compile(r",[^,()]*?(\*+)\s*\)\s*\]?\s*$")


def _member_addr(ids, name, offset):
    """Address of member `offset` of `ids.<name>`, T vs T* aware.

    cairo-vm resolves `ids.x.member` through the reference's cast type: a
    struct-typed reference (T, deref-shaped) has the member at
    addr(x) + offset; a pointer-typed reference (T*, e.g.
    squash_dict_inner's `let loop_temps = cast(ap, LoopTemps*)` — NOT an
    addressable cell) has it at value(x) + offset.  Pointer depth = stars
    on the top-level cast type minus one if the reference itself is a
    deref (`[cast(..., T*)]` holds a T value, `[cast(..., T**)]` a T*)."""
    ref = ids._reference(name)
    m = _PTR_CAST_RE.search(ref.value)
    stars = len(m.group(1)) if m else 0
    if ref.value.lstrip().startswith("["):
        stars -= 1
    if stars >= 1 or ref.ast[0] != "deref":
        return ids._vm._add(ids.get(name), offset)
    return ids.get_address(name) + offset


def _felt(v):
    from .vm import Relocatable
    if isinstance(v, Relocatable):
        raise HintError(f"expected a felt, got relocatable {v}")
    return v


def _u256_read(vm, ids, name):
    base = ids.get_address(name)
    lo = _felt(vm.mem_get(base))
    hi = _felt(vm.mem_get(base + 1))
    if lo is None or hi is None:
        raise HintError(f"uninitialized Uint256 ids.{name}")
    return lo, hi


def _u256_write(vm, ids, name, lo, hi):
    base = ids.get_address(name)
    vm.mem_set(base, lo % P)
    vm.mem_set(base + 1, hi % P)


# ---------------------------------------------------------------------------
# math.cairo
# ---------------------------------------------------------------------------

ASSERT_NOT_ZERO = (
    "from starkware.cairo.common.math_utils import assert_integer\n"
    "assert_integer(ids.value)\n"
    "assert ids.value % PRIME != 0, f'assert_not_zero failed: {ids.value} "
    "= 0.'"
)

ASSERT_NOT_EQUAL = (
    "from starkware.cairo.lang.vm.relocatable import RelocatableValue\n"
    "both_ints = isinstance(ids.a, int) and isinstance(ids.b, int)\n"
    "both_relocatable = (\n"
    "    isinstance(ids.a, RelocatableValue) and isinstance(ids.b, "
    "RelocatableValue) and\n"
    "    ids.a.segment_index == ids.b.segment_index)\n"
    "assert both_ints or both_relocatable, \\\n"
    "    f'assert_not_equal failed: non-comparable values: {ids.a}, "
    "{ids.b}.'\n"
    "assert (ids.a - ids.b) % PRIME != 0, f'assert_not_equal failed: "
    "{ids.a} = {ids.b}.'"
)

ASSERT_LE_FELT = (
    "import itertools\n"
    "\n"
    "from starkware.cairo.common.math_utils import assert_integer\n"
    "assert_integer(ids.a)\n"
    "assert_integer(ids.b)\n"
    "a = ids.a % PRIME\n"
    "b = ids.b % PRIME\n"
    "assert a <= b, f'a = {a} is not less than or equal to b = {b}.'\n"
    "\n"
    "# Find an arc less than PRIME / 3, and another less than PRIME / 2.\n"
    "lengths_and_indices = [(a, 0), (b - a, 1), (PRIME - 1 - b, 2)]\n"
    "lengths_and_indices.sort()\n"
    "assert lengths_and_indices[0][0] <= PRIME // 3 and "
    "lengths_and_indices[1][0] <= PRIME // 2\n"
    "excluded = lengths_and_indices[2][1]\n"
    "\n"
    "memory[ids.range_check_ptr + 1], memory[ids.range_check_ptr + 0] = (\n"
    "    divmod(lengths_and_indices[0][0], ids.PRIME_OVER_3_HIGH))\n"
    "memory[ids.range_check_ptr + 3], memory[ids.range_check_ptr + 2] = (\n"
    "    divmod(lengths_and_indices[1][0], ids.PRIME_OVER_2_HIGH))"
)

ASSERT_LE_FELT_EXCLUDED_0 = "memory[ap] = 1 if excluded != 0 else 0"
ASSERT_LE_FELT_EXCLUDED_1 = "memory[ap] = 1 if excluded != 1 else 0"
ASSERT_LE_FELT_EXCLUDED_2 = "assert excluded == 2"

ASSERT_LT_FELT = (
    "from starkware.cairo.common.math_utils import assert_integer\n"
    "assert_integer(ids.a)\n"
    "assert_integer(ids.b)\n"
    "assert (ids.a % PRIME) < (ids.b % PRIME), \\\n"
    "    f'a = {ids.a % PRIME} is not less than b = {ids.b % PRIME}.'"
)

ASSERT_250_BITS = (
    "from starkware.cairo.common.math_utils import as_int\n"
    "\n"
    "# Correctness check.\n"
    "value = as_int(ids.value, PRIME) % PRIME\n"
    "assert value < ids.UPPER_BOUND, f'{value} is outside of the range "
    "[0, 2**250).'\n"
    "\n"
    "# Calculation for the assertion.\n"
    "ids.high, ids.low = divmod(ids.value, ids.SHIFT)"
)

SPLIT_FELT = (
    "from starkware.cairo.common.math_utils import assert_integer\n"
    "assert ids.MAX_HIGH < 2**128 and ids.MAX_LOW < 2**128\n"
    "assert PRIME - 1 == ids.MAX_HIGH * 2**128 + ids.MAX_LOW\n"
    "assert_integer(ids.value)\n"
    "ids.low = ids.value & ((1 << 128) - 1)\n"
    "ids.high = ids.value >> 128"
)

SPLIT_INT_ASSERT_RANGE = (
    "assert ids.value == 0, 'split_int(): value is out of range.'"
)

SPLIT_INT = (
    "memory[ids.output] = res = (int(ids.value) % PRIME) % ids.base\n"
    "assert res < ids.bound, f'split_int(): Limb {res} is out of range.'"
)

SQRT = (
    "from starkware.python.math_utils import isqrt\n"
    "value = ids.value % PRIME\n"
    'assert value < 2 ** 250, f"value={value} is outside of the range '
    '[0, 2**250)."\n'
    "assert 2 ** 250 < PRIME\n"
    "ids.root = isqrt(value)"
)

ABS_VALUE = (
    "from starkware.cairo.common.math_utils import as_int\n"
    "ids.is_positive = 1 if as_int(ids.value, PRIME) >= 0 else 0"
)


def _h_assert_not_zero(vm, ids, ap, fp):
    if _felt(ids.value) % P == 0:
        raise HintError(f"assert_not_zero failed: {ids.value} = 0.")


def _h_assert_not_equal(vm, ids, ap, fp):
    from .vm import Relocatable
    a, b = ids.a, ids.b
    both_ints = isinstance(a, int) and isinstance(b, int)
    both_reloc = (isinstance(a, Relocatable) and isinstance(b, Relocatable)
                  and a.segment == b.segment)
    if not (both_ints or both_reloc):
        raise HintError(
            f"assert_not_equal failed: non-comparable values: {a}, {b}.")
    diff = (a.offset - b.offset) if both_reloc else (a - b)
    if diff % P == 0:
        raise HintError(f"assert_not_equal failed: {a} = {b}.")


def _h_assert_le_felt(vm, ids, ap, fp):
    a = _felt(ids.a) % P
    b = _felt(ids.b) % P
    if not a <= b:
        raise HintError(f"a = {a} is not less than or equal to b = {b}.")
    p3h = _ids_get(ids, "PRIME_OVER_3_HIGH", PRIME_OVER_3_HIGH)
    p2h = _ids_get(ids, "PRIME_OVER_2_HIGH", PRIME_OVER_2_HIGH)
    lengths_and_indices = sorted([(a, 0), (b - a, 1), (P - 1 - b, 2)])
    if not (lengths_and_indices[0][0] <= P // 3
            and lengths_and_indices[1][0] <= P // 2):
        raise HintError("assert_le_felt: no valid arc split")
    vm.scope_set("excluded", lengths_and_indices[2][1])
    rc = ids.get("range_check_ptr")
    q0, r0 = divmod(lengths_and_indices[0][0], p3h)
    q1, r1 = divmod(lengths_and_indices[1][0], p2h)
    vm.mem_set(rc + 0, r0)
    vm.mem_set(rc + 1, q0)
    vm.mem_set(rc + 2, r1)
    vm.mem_set(rc + 3, q1)


def _h_assert_le_felt_excluded(which):
    def impl(vm, ids, ap, fp):
        excluded = vm.scope_get("excluded")
        if excluded is None:
            raise HintError("assert_le_felt exclusion hint with no "
                            "'excluded' in scope")
        if which == 2:
            if excluded != 2:
                raise HintError(f"excluded == {excluded}, expected 2")
        else:
            vm.mem_set(ap, 1 if excluded != which else 0)
    return impl


def _h_assert_lt_felt(vm, ids, ap, fp):
    a, b = _felt(ids.a) % P, _felt(ids.b) % P
    if not a < b:
        raise HintError(f"a = {a} is not less than b = {b}.")


def _h_assert_250_bits(vm, ids, ap, fp):
    value = _felt(ids.value) % P
    upper = _ids_get(ids, "UPPER_BOUND", UPPER_BOUND_250)
    shift = _ids_get(ids, "SHIFT", SHIFT_128)
    if not value < upper:
        raise HintError(f"{value} is outside of the range [0, 2**250).")
    high, low = divmod(value, shift)
    ids.set("high", high)
    ids.set("low", low)


def _h_split_felt(vm, ids, ap, fp):
    max_high = _ids_get(ids, "MAX_HIGH", MAX_HIGH)
    max_low = _ids_get(ids, "MAX_LOW", MAX_LOW)
    if not (max_high < 2 ** 128 and max_low < 2 ** 128
            and P - 1 == max_high * 2 ** 128 + max_low):
        raise HintError("split_felt: bad MAX_HIGH/MAX_LOW constants")
    value = _felt(ids.value) % P
    ids.set("low", value & (SHIFT_128 - 1))
    ids.set("high", value >> 128)


def _h_split_int_assert_range(vm, ids, ap, fp):
    if _felt(ids.value) % P != 0:
        raise HintError("split_int(): value is out of range.")


def _h_split_int(vm, ids, ap, fp):
    res = (_felt(ids.value) % P) % _felt(ids.base)
    if not res < _felt(ids.bound):
        raise HintError(f"split_int(): Limb {res} is out of range.")
    vm.mem_set(ids.get("output"), res)


def _isqrt(n: int) -> int:
    import math
    return math.isqrt(n)


def _h_sqrt(vm, ids, ap, fp):
    value = _felt(ids.value) % P
    if not value < 2 ** 250:
        raise HintError(f"value={value} is outside of the range [0, 2**250).")
    ids.set("root", _isqrt(value))


def _h_abs_value(vm, ids, ap, fp):
    ids.set("is_positive", 1 if _as_int(_felt(ids.value) % P) >= 0 else 0)


# ---------------------------------------------------------------------------
# memcpy.cairo / memset.cairo + bare scope hints
# ---------------------------------------------------------------------------

VM_ENTER_SCOPE = "vm_enter_scope()"
VM_EXIT_SCOPE = "vm_exit_scope()"
MEMCPY_ENTER_SCOPE = "vm_enter_scope({'n': ids.len})"
MEMCPY_CONTINUE_COPYING = "n -= 1\nids.continue_copying = 1 if n > 0 else 0"
MEMSET_ENTER_SCOPE = "vm_enter_scope({'n': ids.n})"
MEMSET_CONTINUE_LOOP = "n -= 1\nids.continue_loop = 1 if n > 0 else 0"


def _h_vm_enter_scope(vm, ids, ap, fp):
    vm.enter_scope()


def _h_vm_exit_scope(vm, ids, ap, fp):
    if len(vm.exec_scopes) <= 1:
        raise HintError("vm_exit_scope() with no scope to exit")
    vm.exit_scope()


def _h_memcpy_enter_scope(vm, ids, ap, fp):
    vm.enter_scope({"n": _felt(ids.len)})


def _h_memset_enter_scope(vm, ids, ap, fp):
    vm.enter_scope({"n": _felt(ids.n)})


def _h_continue(flag_name):
    def impl(vm, ids, ap, fp):
        n = vm.scope_get("n")
        if n is None:
            raise HintError("loop hint with no 'n' in scope")
        n -= 1
        vm.scope_set("n", n)
        ids.set(flag_name, 1 if n > 0 else 0)
    return impl


# ---------------------------------------------------------------------------
# find_element.cairo / set.cairo
# ---------------------------------------------------------------------------

FIND_ELEMENT = (
    "array_ptr = ids.array_ptr\n"
    "elm_size = ids.elm_size\n"
    "assert isinstance(elm_size, int) and elm_size > 0, \\\n"
    "    f'Invalid value for elm_size. Got: {elm_size}.'\n"
    "key = ids.key\n"
    "\n"
    "if '__find_element_index' in globals():\n"
    "    ids.index = __find_element_index\n"
    "    found_key = memory[array_ptr + elm_size * __find_element_index]\n"
    "    assert found_key == key, \\\n"
    "        f'Invalid index found in __find_element_index. index: "
    "{__find_element_index}, ' \\\n"
    "        f'expected key {key}, found key: {found_key}.'\n"
    "    del __find_element_index\n"
    "else:\n"
    "    n_elms = ids.n_elms\n"
    "    assert isinstance(n_elms, int) and n_elms >= 0, \\\n"
    "        f'Invalid value for n_elms. Got: {n_elms}.'\n"
    "    if '__find_element_max_size' in globals():\n"
    "        assert n_elms <= __find_element_max_size, \\\n"
    "            f'find_element() can only be used with "
    "n_elms<={__find_element_max_size}. ' \\\n"
    "            f'Got: n_elms={n_elms}.'\n"
    "\n"
    "    for i in range(n_elms):\n"
    "        if memory[array_ptr + elm_size * i] == key:\n"
    "            ids.index = i\n"
    "            break\n"
    "    else:\n"
    "        raise ValueError(f'Key {key} was not found.')"
)

SEARCH_SORTED_LOWER = (
    "array_ptr = ids.array_ptr\n"
    "elm_size = ids.elm_size\n"
    "assert isinstance(elm_size, int) and elm_size > 0, \\\n"
    "    f'Invalid value for elm_size. Got: {elm_size}.'\n"
    "\n"
    "n_elms = ids.n_elms\n"
    "assert isinstance(n_elms, int) and n_elms >= 0, \\\n"
    "    f'Invalid value for n_elms. Got: {n_elms}.'\n"
    "if '__find_element_max_size' in globals():\n"
    "    assert n_elms <= __find_element_max_size, \\\n"
    "        f'find_element() can only be used with "
    "n_elms<={__find_element_max_size}. ' \\\n"
    "        f'Got: n_elms={n_elms}.'\n"
    "\n"
    "for i in range(n_elms):\n"
    "    if memory[array_ptr + elm_size * i] >= ids.key:\n"
    "        ids.index = i\n"
    "        break\n"
    "else:\n"
    "    ids.index = n_elms"
)

SET_ADD = (
    "assert ids.elm_size > 0\n"
    "assert ids.set_ptr <= ids.set_end_ptr\n"
    "elm_list = memory.get_range(ids.elm_ptr, ids.elm_size)\n"
    "for i in range(0, ids.set_end_ptr - ids.set_ptr, ids.elm_size):\n"
    "    if memory.get_range(ids.set_ptr + i, ids.elm_size) == elm_list:\n"
    "        ids.index = i // ids.elm_size\n"
    "        ids.is_elm_in_set = 1\n"
    "        break\n"
    "else:\n"
    "    ids.is_elm_in_set = 0"
)


def _h_find_element(vm, ids, ap, fp):
    array_ptr = ids.get("array_ptr")
    elm_size = _felt(ids.elm_size)
    if not elm_size > 0:
        raise HintError(f"Invalid value for elm_size. Got: {elm_size}.")
    key = ids.key
    forced = vm.scope_get_local("__find_element_index")
    if forced is not None:
        found_key = vm.mem_get(array_ptr + elm_size * forced)
        if found_key != key:
            raise HintError(
                f"Invalid index found in __find_element_index. index: "
                f"{forced}, expected key {key}, found key: {found_key}.")
        ids.set("index", forced)
        vm.exec_scopes[-1].pop("__find_element_index", None)
        return
    n_elms = _felt(ids.n_elms)
    max_size = vm.scope_get("__find_element_max_size")
    if max_size is not None and n_elms > max_size:
        raise HintError(
            f"find_element() can only be used with n_elms<={max_size}. "
            f"Got: n_elms={n_elms}.")
    for i in range(n_elms):
        if vm.mem_get(array_ptr + elm_size * i) == key:
            ids.set("index", i)
            return
    raise HintError(f"Key {key} was not found.")


def _h_search_sorted_lower(vm, ids, ap, fp):
    array_ptr = ids.get("array_ptr")
    elm_size = _felt(ids.elm_size)
    if not elm_size > 0:
        raise HintError(f"Invalid value for elm_size. Got: {elm_size}.")
    n_elms = _felt(ids.n_elms)
    max_size = vm.scope_get("__find_element_max_size")
    if max_size is not None and n_elms > max_size:
        raise HintError(
            f"find_element() can only be used with n_elms<={max_size}. "
            f"Got: n_elms={n_elms}.")
    key = _felt(ids.key)
    for i in range(n_elms):
        if _felt(vm.mem_get(array_ptr + elm_size * i)) >= key:
            ids.set("index", i)
            return
    ids.set("index", n_elms)


def _h_set_add(vm, ids, ap, fp):
    elm_size = _felt(ids.elm_size)
    set_ptr = ids.get("set_ptr")
    set_end_ptr = ids.get("set_end_ptr")
    if not elm_size > 0:
        raise HintError("set_add: elm_size must be positive")
    if (set_ptr.segment != set_end_ptr.segment
            or set_ptr.offset > set_end_ptr.offset):
        raise HintError("set_add: set_ptr > set_end_ptr")
    elm = vm.get_range(ids.get("elm_ptr"), elm_size)
    for i in range(0, set_end_ptr.offset - set_ptr.offset, elm_size):
        if vm.get_range(set_ptr + i, elm_size) == elm:
            ids.set("index", i // elm_size)
            ids.set("is_elm_in_set", 1)
            return
    ids.set("is_elm_in_set", 0)


# ---------------------------------------------------------------------------
# dict.cairo / default_dict.cairo / squash_dict.cairo
# ---------------------------------------------------------------------------


class DictTracker:
    """cairo-vm DictTracker: backing store + expected current end pointer
    of one dictionary segment."""

    def __init__(self, data: dict, current_ptr, default=None):
        self.data = dict(data)
        self.current_ptr = current_ptr
        self.default = default

    def get(self, key):
        if key in self.data:
            return self.data[key]
        if self.default is None:
            raise HintError(f"dict key {key} not found (no default)")
        self.data[key] = self.default
        return self.default


class DictManager:
    """cairo-vm DictManager: maps dict segment index -> DictTracker."""

    def __init__(self):
        self.trackers: dict[int, DictTracker] = {}

    def new_dict(self, vm, initial_dict: dict):
        base = vm.add_segment()
        self.trackers[base.segment] = DictTracker(initial_dict, base)
        return base

    def new_default_dict(self, vm, default):
        base = vm.add_segment()
        self.trackers[base.segment] = DictTracker({}, base, default=default)
        return base

    def get_tracker(self, ptr) -> DictTracker:
        t = self.trackers.get(ptr.segment)
        if t is None:
            raise HintError(f"no dict tracker for segment {ptr.segment}")
        if t.current_ptr != ptr:
            raise HintError(
                f"wrong dict pointer: expected {t.current_ptr}, got {ptr}")
        return t

    def get_dict(self, ptr) -> dict:
        return self.get_tracker(ptr).data


def _dict_manager(vm) -> DictManager:
    mgr = vm.scope_get("__dict_manager")
    if mgr is None:
        mgr = DictManager()
        vm.exec_scopes[0]["__dict_manager"] = mgr
    return mgr


DICT_NEW = (
    "if '__dict_manager' not in globals():\n"
    "    from starkware.cairo.common.dict import DictManager\n"
    "    __dict_manager = DictManager()\n"
    "\n"
    "memory[ap] = __dict_manager.new_dict(segments, initial_dict)\n"
    "del initial_dict"
)

DEFAULT_DICT_NEW = (
    "if '__dict_manager' not in globals():\n"
    "    from starkware.cairo.common.dict import DictManager\n"
    "    __dict_manager = DictManager()\n"
    "\n"
    "memory[ap] = __dict_manager.new_default_dict(segments, "
    "ids.default_value)"
)

DICT_READ = (
    "dict_tracker = __dict_manager.get_tracker(ids.dict_ptr)\n"
    "dict_tracker.current_ptr += ids.DictAccess.SIZE\n"
    "ids.value = dict_tracker.data[ids.key]"
)

DICT_WRITE = (
    "dict_tracker = __dict_manager.get_tracker(ids.dict_ptr)\n"
    "dict_tracker.current_ptr += ids.DictAccess.SIZE\n"
    "ids.dict_ptr.prev_value = dict_tracker.data[ids.key]\n"
    "dict_tracker.data[ids.key] = ids.new_value"
)

DICT_UPDATE = (
    "# Verify dict pointer and prev value.\n"
    "dict_tracker = __dict_manager.get_tracker(ids.dict_ptr)\n"
    "current_value = dict_tracker.data[ids.key]\n"
    "assert current_value == ids.prev_value, \\\n"
    "    f'Wrong previous value in dict. Got {ids.prev_value}, expected "
    "{current_value}.'\n"
    "\n"
    "# Update value.\n"
    "dict_tracker.data[ids.key] = ids.new_value\n"
    "dict_tracker.current_ptr += ids.DictAccess.SIZE"
)

DICT_SQUASH_COPY_DICT = (
    "# Prepare arguments for dict_new. In particular, the same dictionary "
    "values should be copied\n"
    "# to the new (squashed) dictionary.\n"
    "vm_enter_scope({\n"
    "    # Make __dict_manager accessible.\n"
    "    '__dict_manager': __dict_manager,\n"
    "    # Create a copy of the dict, in case it changes in the future.\n"
    "    'initial_dict': dict(__dict_manager.get_dict("
    "ids.dict_accesses_end)),\n"
    "})"
)

DICT_SQUASH_UPDATE_PTR = (
    "# Update the DictTracker's current_ptr to point to the end of the "
    "squashed dict.\n"
    "__dict_manager.get_tracker(ids.squashed_dict_start).current_ptr = \\\n"
    "    ids.squashed_dict_end.address_"
)

SQUASH_DICT = (
    "dict_access_size = ids.DictAccess.SIZE\n"
    "address = ids.dict_accesses.address_\n"
    "assert ids.ptr_diff % dict_access_size == 0, \\\n"
    "    'Accesses array size must be divisible by DictAccess.SIZE'\n"
    "n_accesses = ids.n_accesses\n"
    "if '__squash_dict_max_size' in globals():\n"
    "    assert n_accesses <= __squash_dict_max_size, \\\n"
    "        f'squash_dict() can only be used with "
    "n_accesses<={__squash_dict_max_size}. ' \\\n"
    "        f'Got: n_accesses={n_accesses}.'\n"
    "# A map from key to the list of indices accessing it.\n"
    "access_indices = {}\n"
    "for i in range(n_accesses):\n"
    "    key = memory[address + dict_access_size * i]\n"
    "    access_indices.setdefault(key, []).append(i)\n"
    "# Descending list of keys.\n"
    "keys = sorted(access_indices.keys(), reverse=True)\n"
    "# Are the keys used bigger than range_check bound.\n"
    "ids.big_keys = 1 if keys[0] >= range_check_builtin.bound else 0\n"
    "ids.first_key = key = keys.pop()"
)

SQUASH_DICT_INNER_SKIP_LOOP = (
    "ids.should_skip_loop = 0 if current_access_indices else 1"
)

SQUASH_DICT_INNER_FIRST_ITERATION = (
    "current_access_indices = sorted(access_indices[key])[::-1]\n"
    "current_access_index = current_access_indices.pop()\n"
    "memory[ids.range_check_ptr] = current_access_index"
)

SQUASH_DICT_INNER_CHECK_ACCESS_INDEX = (
    "new_access_index = current_access_indices.pop()\n"
    "ids.loop_temps.index_delta_minus1 = new_access_index - "
    "current_access_index - 1\n"
    "current_access_index = new_access_index"
)

SQUASH_DICT_INNER_CONTINUE_LOOP = (
    "ids.loop_temps.should_continue = 1 if current_access_indices else 0"
)

SQUASH_DICT_INNER_LEN_ASSERT = "assert len(current_access_indices) == 0"

SQUASH_DICT_INNER_USED_ACCESSES_ASSERT = (
    "assert ids.n_used_accesses == len(access_indices[key])"
)

SQUASH_DICT_INNER_ASSERT_LEN_KEYS = "assert len(keys) == 0"

SQUASH_DICT_INNER_NEXT_KEY = (
    "assert len(keys) > 0, 'No keys left but remaining_accesses > 0.'\n"
    "ids.next_key = key = keys.pop()"
)

# squash_dict_inner LoopTemps member offsets (squash_dict.cairo struct)
_LT_INDEX_DELTA_MINUS1 = 0
_LT_SHOULD_CONTINUE = 3


def _h_dict_new(vm, ids, ap, fp):
    mgr = _dict_manager(vm)
    # current-scope-only: a stale initial_dict from an enclosing scope must
    # fail loudly here exactly as the reference VM's hint globals would
    initial = vm.scope_get_local("initial_dict")
    if initial is None:
        raise HintError("dict_new with no initial_dict in scope")
    vm.mem_set(ap, mgr.new_dict(vm, initial))
    # del initial_dict (current scope only, mirroring the hint's `del`)
    vm.exec_scopes[-1].pop("initial_dict", None)


def _h_default_dict_new(vm, ids, ap, fp):
    mgr = _dict_manager(vm)
    vm.mem_set(ap, mgr.new_default_dict(vm, _felt(ids.default_value)))


def _h_dict_read(vm, ids, ap, fp):
    mgr = _dict_manager(vm)
    tracker = mgr.get_tracker(ids.get("dict_ptr"))
    tracker.current_ptr = tracker.current_ptr + DICT_ACCESS_SIZE
    ids.set("value", tracker.get(_felt(ids.key)))


def _h_dict_write(vm, ids, ap, fp):
    mgr = _dict_manager(vm)
    dict_ptr = ids.get("dict_ptr")
    tracker = mgr.get_tracker(dict_ptr)
    tracker.current_ptr = tracker.current_ptr + DICT_ACCESS_SIZE
    key = _felt(ids.key)
    # ids.dict_ptr.prev_value = ... (DictAccess.prev_value at offset 1)
    vm.mem_set(dict_ptr + 1, tracker.get(key))
    tracker.data[key] = _felt(ids.new_value)


def _h_dict_update(vm, ids, ap, fp):
    mgr = _dict_manager(vm)
    tracker = mgr.get_tracker(ids.get("dict_ptr"))
    key = _felt(ids.key)
    current = tracker.get(key)
    prev = _felt(ids.prev_value)
    if current != prev:
        raise HintError(
            f"Wrong previous value in dict. Got {prev}, expected {current}.")
    tracker.data[key] = _felt(ids.new_value)
    tracker.current_ptr = tracker.current_ptr + DICT_ACCESS_SIZE


def _h_dict_squash_copy_dict(vm, ids, ap, fp):
    mgr = _dict_manager(vm)
    vm.enter_scope({
        "__dict_manager": mgr,
        "initial_dict": dict(mgr.get_dict(ids.get("dict_accesses_end"))),
    })


def _h_dict_squash_update_ptr(vm, ids, ap, fp):
    mgr = _dict_manager(vm)
    start = ids.get("squashed_dict_start")
    tracker = mgr.trackers.get(start.segment)
    if tracker is None:
        raise HintError(f"no dict tracker for segment {start.segment}")
    tracker.current_ptr = ids.get("squashed_dict_end")


def _h_squash_dict(vm, ids, ap, fp):
    address = ids.get("dict_accesses")
    ptr_diff = _felt(ids.ptr_diff)
    if ptr_diff % DICT_ACCESS_SIZE != 0:
        raise HintError(
            "Accesses array size must be divisible by DictAccess.SIZE")
    n_accesses = _felt(ids.n_accesses)
    max_size = vm.scope_get("__squash_dict_max_size")
    if max_size is not None and n_accesses > max_size:
        raise HintError(
            f"squash_dict() can only be used with n_accesses<={max_size}. "
            f"Got: n_accesses={n_accesses}.")
    access_indices = {}
    for i in range(n_accesses):
        key = _felt(vm.mem_get(address + DICT_ACCESS_SIZE * i))
        access_indices.setdefault(key, []).append(i)
    keys = sorted(access_indices.keys(), reverse=True)
    if not keys:
        raise HintError("squash_dict called with no accesses (empty keys)")
    ids.set("big_keys", 1 if keys[0] >= RC_BOUND else 0)
    first = keys.pop()
    ids.set("first_key", first)
    vm.scope_set("access_indices", access_indices)
    vm.scope_set("keys", keys)
    vm.scope_set("key", first)


def _h_squash_dict_inner_skip_loop(vm, ids, ap, fp):
    cai = vm.scope_get("current_access_indices")
    ids.set("should_skip_loop", 0 if cai else 1)


def _h_squash_dict_inner_first_iteration(vm, ids, ap, fp):
    access_indices = vm.scope_get("access_indices")
    key = vm.scope_get("key")
    if access_indices is None or key is None:
        raise HintError("squash_dict_inner with no squash state in scope")
    cai = sorted(access_indices[key])[::-1]
    current = cai.pop()
    vm.scope_set("current_access_indices", cai)
    vm.scope_set("current_access_index", current)
    vm.mem_set(ids.get("range_check_ptr"), current)


def _h_squash_dict_inner_check_access_index(vm, ids, ap, fp):
    cai = vm.scope_get("current_access_indices")
    current = vm.scope_get("current_access_index")
    new_index = cai.pop()
    vm.mem_set(_member_addr(ids, "loop_temps", _LT_INDEX_DELTA_MINUS1),
               (new_index - current - 1) % P)
    vm.scope_set("current_access_index", new_index)


def _h_squash_dict_inner_continue_loop(vm, ids, ap, fp):
    cai = vm.scope_get("current_access_indices")
    vm.mem_set(_member_addr(ids, "loop_temps", _LT_SHOULD_CONTINUE),
               1 if cai else 0)


def _h_squash_dict_inner_len_assert(vm, ids, ap, fp):
    if vm.scope_get("current_access_indices"):
        raise HintError("len(current_access_indices) != 0")


def _h_squash_dict_inner_used_accesses_assert(vm, ids, ap, fp):
    access_indices = vm.scope_get("access_indices")
    key = vm.scope_get("key")
    if _felt(ids.n_used_accesses) != len(access_indices[key]):
        raise HintError("n_used_accesses != len(access_indices[key])")


def _h_squash_dict_inner_assert_len_keys(vm, ids, ap, fp):
    if vm.scope_get("keys"):
        raise HintError("len(keys) != 0")


def _h_squash_dict_inner_next_key(vm, ids, ap, fp):
    keys = vm.scope_get("keys")
    if not keys:
        raise HintError("No keys left but remaining_accesses > 0.")
    key = keys.pop()
    ids.set("next_key", key)
    vm.scope_set("key", key)


# ---------------------------------------------------------------------------
# uint256.cairo
# ---------------------------------------------------------------------------

UINT256_ADD = (
    "sum_low = ids.a.low + ids.b.low\n"
    "ids.carry_low = 1 if sum_low >= ids.SHIFT else 0\n"
    "sum_high = ids.a.high + ids.b.high + ids.carry_low\n"
    "ids.carry_high = 1 if sum_high >= ids.SHIFT else 0"
)

SPLIT_64 = "ids.low = ids.a & ((1<<64) - 1)\nids.high = ids.a >> 64"

UINT256_SQRT = (
    "from starkware.python.math_utils import isqrt\n"
    "n = (ids.n.high << 128) + ids.n.low\n"
    "root = isqrt(n)\n"
    "assert 0 <= root < 2 ** 128\n"
    "ids.root.low = root\n"
    "ids.root.high = 0"
)

UINT256_SIGNED_NN = (
    "memory[ap] = 1 if 0 <= (ids.a.high % PRIME) < 2 ** 127 else 0"
)

UINT256_UNSIGNED_DIV_REM = (
    "a = (ids.a.high << 128) + ids.a.low\n"
    "div = (ids.div.high << 128) + ids.div.low\n"
    "quotient, remainder = divmod(a, div)\n"
    "\n"
    "ids.quotient.low = quotient & ((1 << 128) - 1)\n"
    "ids.quotient.high = quotient >> 128\n"
    "ids.remainder.low = remainder & ((1 << 128) - 1)\n"
    "ids.remainder.high = remainder >> 128"
)

UINT256_MUL_DIV_MOD = (
    "a = (ids.a.high << 128) + ids.a.low\n"
    "b = (ids.b.high << 128) + ids.b.low\n"
    "div = (ids.div.high << 128) + ids.div.low\n"
    "quotient, remainder = divmod(a * b, div)\n"
    "\n"
    "ids.quotient_low.low = quotient & ((1 << 128) - 1)\n"
    "ids.quotient_low.high = (quotient >> 128) & ((1 << 128) - 1)\n"
    "ids.quotient_high.low = (quotient >> 256) & ((1 << 128) - 1)\n"
    "ids.quotient_high.high = quotient >> 384\n"
    "ids.remainder.low = remainder & ((1 << 128) - 1)\n"
    "ids.remainder.high = remainder >> 128"
)


def _h_uint256_add(vm, ids, ap, fp):
    a_lo, a_hi = _u256_read(vm, ids, "a")
    b_lo, b_hi = _u256_read(vm, ids, "b")
    shift = _ids_get(ids, "SHIFT", SHIFT_128)
    carry_low = 1 if a_lo + b_lo >= shift else 0
    carry_high = 1 if a_hi + b_hi + carry_low >= shift else 0
    ids.set("carry_low", carry_low)
    ids.set("carry_high", carry_high)


def _h_split_64(vm, ids, ap, fp):
    a = _felt(ids.a) % P
    ids.set("low", a & ((1 << 64) - 1))
    ids.set("high", a >> 64)


def _h_uint256_sqrt(vm, ids, ap, fp):
    n_lo, n_hi = _u256_read(vm, ids, "n")
    root = _isqrt((n_hi << 128) + n_lo)
    if not 0 <= root < 2 ** 128:
        raise HintError("uint256_sqrt: root out of range")
    _u256_write(vm, ids, "root", root, 0)


def _h_uint256_signed_nn(vm, ids, ap, fp):
    _, a_hi = _u256_read(vm, ids, "a")
    vm.mem_set(ap, 1 if 0 <= (a_hi % P) < 2 ** 127 else 0)


def _h_uint256_unsigned_div_rem(vm, ids, ap, fp):
    a_lo, a_hi = _u256_read(vm, ids, "a")
    d_lo, d_hi = _u256_read(vm, ids, "div")
    a = (a_hi << 128) + a_lo
    div = (d_hi << 128) + d_lo
    q, r = divmod(a, div)
    _u256_write(vm, ids, "quotient", q & (SHIFT_128 - 1), q >> 128)
    _u256_write(vm, ids, "remainder", r & (SHIFT_128 - 1), r >> 128)


def _h_uint256_mul_div_mod(vm, ids, ap, fp):
    a_lo, a_hi = _u256_read(vm, ids, "a")
    b_lo, b_hi = _u256_read(vm, ids, "b")
    d_lo, d_hi = _u256_read(vm, ids, "div")
    a = (a_hi << 128) + a_lo
    b = (b_hi << 128) + b_lo
    div = (d_hi << 128) + d_lo
    q, r = divmod(a * b, div)
    _u256_write(vm, ids, "quotient_low",
                q & (SHIFT_128 - 1), (q >> 128) & (SHIFT_128 - 1))
    _u256_write(vm, ids, "quotient_high",
                (q >> 256) & (SHIFT_128 - 1), q >> 384)
    _u256_write(vm, ids, "remainder", r & (SHIFT_128 - 1), r >> 128)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# usort.cairo
# ---------------------------------------------------------------------------

USORT_ENTER_SCOPE = (
    "vm_enter_scope(dict(__usort_max_size = "
    "globals().get('__usort_max_size')))"
)

USORT_BODY = (
    "from collections import defaultdict\n\n"
    "input_ptr = ids.input\n"
    "input_len = int(ids.input_len)\n"
    "if __usort_max_size is not None:\n"
    "    assert input_len <= __usort_max_size, (\n"
    "        f\"usort() can only be used with input_len<="
    "{__usort_max_size}. \"\n"
    "        f\"Got: input_len={input_len}.\"\n"
    "    )\n\n"
    "positions_dict = defaultdict(list)\n"
    "for i in range(input_len):\n"
    "    val = memory[input_ptr + i]\n"
    "    positions_dict[val].append(i)\n\n"
    "output = sorted(positions_dict.keys())\n"
    "for i, val in enumerate(output):\n"
    "    memory[ids.output + i] = val\n"
    "ids.output_len = len(output)"
)

USORT_VERIFY = "last_pos = 0\npositions = positions_dict[ids.value][::-1]"

USORT_VERIFY_MULTIPLICITY_ASSERT = "assert len(positions) == 0"

USORT_VERIFY_MULTIPLICITY_BODY = (
    "current_pos = positions.pop()\n"
    "ids.next_item_index = current_pos - last_pos\n"
    "last_pos = current_pos + 1"
)


def _h_usort_enter_scope(vm, ids, ap, fp):
    vm.enter_scope({"__usort_max_size": vm.scope_get("__usort_max_size")})


def _h_usort_body(vm, ids, ap, fp):
    input_ptr = ids.get("input")
    input_len = _felt(ids.input_len)
    max_size = vm.scope_get_local("__usort_max_size")
    if max_size is not None and input_len > max_size:
        raise HintError(
            f"usort() can only be used with input_len<={max_size}. "
            f"Got: input_len={input_len}.")
    positions_dict: dict = {}
    for i in range(input_len):
        val = vm.mem_get(input_ptr + i)
        if val is None:
            raise HintError(f"usort: uninitialized input cell {i}")
        positions_dict.setdefault(val, []).append(i)
    output = sorted(positions_dict.keys())
    out_ptr = ids.get("output")
    for i, val in enumerate(output):
        vm.mem_set(out_ptr + i, val)
    ids.set("output_len", len(output))
    vm.scope_set("positions_dict", positions_dict)


def _h_usort_verify(vm, ids, ap, fp):
    pd = vm.scope_get("positions_dict")
    if pd is None:
        raise HintError("usort verify without positions_dict in scope")
    vm.scope_set("last_pos", 0)
    vm.scope_set("positions", list(reversed(pd.get(_felt(ids.value), []))))


def _h_usort_multiplicity_assert(vm, ids, ap, fp):
    positions = vm.scope_get("positions")
    if positions is None or len(positions) != 0:
        raise HintError("assert len(positions) == 0 failed")


def _h_usort_multiplicity_body(vm, ids, ap, fp):
    positions = vm.scope_get("positions")
    if not positions:
        raise HintError("usort multiplicity body with no positions left")
    current_pos = positions.pop()
    last_pos = vm.scope_get("last_pos") or 0
    ids.set("next_item_index", (current_pos - last_pos) % P)
    vm.scope_set("last_pos", current_pos + 1)


# ---------------------------------------------------------------------------
# cairo_blake2s (blake2s.cairo + blake2s_utils.py)
# ---------------------------------------------------------------------------

BLAKE2S_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
              0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_BLAKE2S_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

_U32 = (1 << 32) - 1


def _rotr32(x, n):
    return ((x >> n) | (x << (32 - n))) & _U32


def blake2s_compress(message, h, t0, t1, f0, f1):
    """One blake2s compression (cairo-lang blake2s_utils.blake2s_compress);
    message: 16 u32 words, h: 8 u32 words.  Pinned to hashlib.blake2s by
    tests/test_hint_crypto.py."""
    v = list(h) + list(BLAKE2S_IV[:4]) + [
        BLAKE2S_IV[4] ^ t0, BLAKE2S_IV[5] ^ t1,
        BLAKE2S_IV[6] ^ f0, BLAKE2S_IV[7] ^ f1,
    ]

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _U32
        v[d] = _rotr32(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _U32
        v[b] = _rotr32(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b] + y) & _U32
        v[d] = _rotr32(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & _U32
        v[b] = _rotr32(v[b] ^ v[c], 7)

    for s in _BLAKE2S_SIGMA:
        g(0, 4, 8, 12, message[s[0]], message[s[1]])
        g(1, 5, 9, 13, message[s[2]], message[s[3]])
        g(2, 6, 10, 14, message[s[4]], message[s[5]])
        g(3, 7, 11, 15, message[s[6]], message[s[7]])
        g(0, 5, 10, 15, message[s[8]], message[s[9]])
        g(1, 6, 11, 12, message[s[10]], message[s[11]])
        g(2, 7, 8, 13, message[s[12]], message[s[13]])
        g(3, 4, 9, 14, message[s[14]], message[s[15]])
    return [hh ^ v[i] ^ v[i + 8] for i, hh in enumerate(h)]


BLAKE2S_COMPUTE = (
    "from starkware.cairo.common.cairo_blake2s.blake2s_utils import "
    "compute_blake2s_func\ncompute_blake2s_func(segments=segments, "
    "output_ptr=ids.output)"
)

BLAKE2S_ADD_UINT256 = (
    "B = 32\n"
    "MASK = 2 ** 32 - 1\n"
    "segments.write_arg(ids.data, [(ids.low >> (B * i)) & MASK for i in "
    "range(4)])\n"
    "segments.write_arg(ids.data + 4, [(ids.high >> (B * i)) & MASK for i "
    "in range(4)])"
)

BLAKE2S_ADD_UINT256_BIGEND = (
    "B = 32\n"
    "MASK = 2 ** 32 - 1\n"
    "segments.write_arg(ids.data, [(ids.high >> (B * (3 - i))) & MASK for "
    "i in range(4)])\n"
    "segments.write_arg(ids.data + 4, [(ids.low >> (B * (3 - i))) & MASK "
    "for i in range(4)])"
)

BLAKE2S_FINALIZE = (
    "# Add dummy pairs of input and output.\n"
    "from starkware.cairo.common.cairo_blake2s.blake2s_utils import IV, "
    "blake2s_compress\n\n"
    "_n_packed_instances = int(ids.N_PACKED_INSTANCES)\n"
    "assert 0 <= _n_packed_instances < 20\n"
    "_blake2s_input_chunk_size_felts = int(ids.INPUT_BLOCK_FELTS)\n"
    "assert 0 <= _blake2s_input_chunk_size_felts < 100\n\n"
    "message = [0] * _blake2s_input_chunk_size_felts\n"
    "modified_iv = [IV[0] ^ 0x01010020] + IV[1:]\n"
    "output = blake2s_compress(\n"
    "    message=message,\n"
    "    h=modified_iv,\n"
    "    t0=0,\n"
    "    t1=0,\n"
    "    f0=0xffffffff,\n"
    "    f1=0,\n"
    ")\n"
    "padded_output = []\n"
    "for _ in range(_n_packed_instances - 1):\n"
    "    padded_output += message + modified_iv + [0, 0xffffffff] + "
    "output\n"
    "segments.write_arg(ids.blake2s_ptr_end, padded_output)"
)


def _write_arg(vm, ptr, values):
    for i, v in enumerate(values):
        vm.mem_set(ptr + i, v)


def _h_blake2s_compute(vm, ids, ap, fp):
    """compute_blake2s_func: state layout before output_ptr is
    [h(8) | message(16) | t | f]; writes the new 8-word state at output."""
    out = ids.get("output")
    h = vm.get_range(out - 26, 8)
    message = vm.get_range(out - 18, 16)
    t = vm.mem_get(out - 2)
    f = vm.mem_get(out - 1)
    if None in h or None in message or t is None or f is None:
        raise HintError("blake2s_compute: uninitialized state cells")
    _write_arg(vm, out, blake2s_compress(message, h, t, 0, f, 0))


def _h_blake2s_add_uint256(vm, ids, ap, fp):
    data = ids.get("data")
    low, high = _felt(ids.low), _felt(ids.high)
    _write_arg(vm, data, [(low >> (32 * i)) & _U32 for i in range(4)])
    _write_arg(vm, data + 4, [(high >> (32 * i)) & _U32 for i in range(4)])


def _h_blake2s_add_uint256_bigend(vm, ids, ap, fp):
    data = ids.get("data")
    low, high = _felt(ids.low), _felt(ids.high)
    _write_arg(vm, data,
               [(high >> (32 * (3 - i))) & _U32 for i in range(4)])
    _write_arg(vm, data + 4,
               [(low >> (32 * (3 - i))) & _U32 for i in range(4)])


def _h_blake2s_finalize(vm, ids, ap, fp):
    n_packed = _ids_get(ids, "N_PACKED_INSTANCES", 7)
    if not 0 <= n_packed < 20:
        raise HintError(f"bad N_PACKED_INSTANCES {n_packed}")
    chunk = _ids_get(ids, "INPUT_BLOCK_FELTS", 16)
    if not 0 <= chunk < 100:
        raise HintError(f"bad INPUT_BLOCK_FELTS {chunk}")
    message = [0] * chunk
    modified_iv = [BLAKE2S_IV[0] ^ 0x01010020] + list(BLAKE2S_IV[1:])
    output = blake2s_compress(message, modified_iv, 0, 0, 0xFFFFFFFF, 0)
    padded = []
    for _ in range(n_packed - 1):
        padded += message + modified_iv + [0, 0xFFFFFFFF] + output
    _write_arg(vm, ids.get("blake2s_ptr_end"), padded)


# ---------------------------------------------------------------------------
# cairo_sha256 (sha256.cairo + sha256_utils.py)
# ---------------------------------------------------------------------------

SHA256_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
             0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_SHA256_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)


def compute_message_schedule(message):
    """64-entry sha256 message schedule from 16 u32 words."""
    w = list(message)
    for i in range(16, 64):
        s0 = _rotr32(w[i - 15], 7) ^ _rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr32(w[i - 2], 17) ^ _rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _U32)
    return w


def sha2_compress_function(state, w):
    """One sha256 compression (cairo-lang sha256_utils); pinned to
    hashlib.sha256 by tests/test_hint_crypto.py."""
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _SHA256_K[i] + w[i]) & _U32
        s0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _U32
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _U32, c, b, a,
                                  (t1 + t2) & _U32)
    return [(x + y) & _U32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


SHA256_MAIN_CONSTANT_INPUT_LENGTH = (
    "from starkware.cairo.common.cairo_sha256.sha256_utils import (\n"
    "    IV, compute_message_schedule, sha2_compress_function)\n\n"
    "_sha256_input_chunk_size_felts = int("
    "ids.SHA256_INPUT_CHUNK_SIZE_FELTS)\n"
    "assert 0 <= _sha256_input_chunk_size_felts < 100\n\n"
    "w = compute_message_schedule(memory.get_range(\n"
    "    ids.sha256_start, _sha256_input_chunk_size_felts))\n"
    "new_state = sha2_compress_function(IV, w)\n"
    "segments.write_arg(ids.output, new_state)"
)

SHA256_MAIN_ARBITRARY_INPUT_LENGTH = (
    "from starkware.cairo.common.cairo_sha256.sha256_utils import (\n"
    "    compute_message_schedule, sha2_compress_function)\n\n"
    "_sha256_input_chunk_size_felts = int("
    "ids.SHA256_INPUT_CHUNK_SIZE_FELTS)\n"
    "assert 0 <= _sha256_input_chunk_size_felts < 100\n"
    "_sha256_state_size_felts = int(ids.SHA256_STATE_SIZE_FELTS)\n"
    "assert 0 <= _sha256_state_size_felts < 100\n"
    "w = compute_message_schedule(memory.get_range(\n"
    "    ids.sha256_start, _sha256_input_chunk_size_felts))\n"
    "new_state = sha2_compress_function(memory.get_range(ids.state, "
    "_sha256_state_size_felts), w)\n"
    "segments.write_arg(ids.output, new_state)"
)

SHA256_FINALIZE = (
    "# Add dummy pairs of input and output.\n"
    "from starkware.cairo.common.cairo_sha256.sha256_utils import (\n"
    "    IV, compute_message_schedule, sha2_compress_function)\n\n"
    "_block_size = int(ids.BLOCK_SIZE)\n"
    "assert 0 <= _block_size < 20\n"
    "_sha256_input_chunk_size_felts = int("
    "ids.SHA256_INPUT_CHUNK_SIZE_FELTS)\n"
    "assert 0 <= _sha256_input_chunk_size_felts < 100\n\n"
    "message = [0] * _sha256_input_chunk_size_felts\n"
    "w = compute_message_schedule(message)\n"
    "output = sha2_compress_function(IV, w)\n"
    "padding = (message + IV + output) * (_block_size - 1)\n"
    "segments.write_arg(ids.sha256_ptr_end, padding)"
)


def _h_sha256_main_constant(vm, ids, ap, fp):
    chunk = _ids_get(ids, "SHA256_INPUT_CHUNK_SIZE_FELTS", 16)
    if not 0 <= chunk < 100:
        raise HintError(f"bad SHA256_INPUT_CHUNK_SIZE_FELTS {chunk}")
    message = vm.get_range(ids.get("sha256_start"), chunk)
    if None in message:
        raise HintError("sha256: uninitialized input cells")
    w = compute_message_schedule(message)
    _write_arg(vm, ids.get("output"),
               sha2_compress_function(list(SHA256_IV), w))


def _h_sha256_main_arbitrary(vm, ids, ap, fp):
    chunk = _ids_get(ids, "SHA256_INPUT_CHUNK_SIZE_FELTS", 16)
    state_size = _ids_get(ids, "SHA256_STATE_SIZE_FELTS", 8)
    if not 0 <= chunk < 100 or not 0 <= state_size < 100:
        raise HintError("bad sha256 size constants")
    message = vm.get_range(ids.get("sha256_start"), chunk)
    state = vm.get_range(ids.get("state"), state_size)
    if None in message or None in state:
        raise HintError("sha256: uninitialized input/state cells")
    w = compute_message_schedule(message)
    _write_arg(vm, ids.get("output"), sha2_compress_function(state, w))


def _h_sha256_finalize(vm, ids, ap, fp):
    block_size = _ids_get(ids, "BLOCK_SIZE", 7)
    chunk = _ids_get(ids, "SHA256_INPUT_CHUNK_SIZE_FELTS", 16)
    if not 0 <= block_size < 20 or not 0 <= chunk < 100:
        raise HintError("bad sha256 finalize constants")
    message = [0] * chunk
    output = sha2_compress_function(list(SHA256_IV),
                                    compute_message_schedule(message))
    padding = (message + list(SHA256_IV) + output) * (block_size - 1)
    _write_arg(vm, ids.get("sha256_ptr_end"), padding)


# ---------------------------------------------------------------------------
# cairo_keccak (keccak.cairo + keccak_utils.py)
# ---------------------------------------------------------------------------

KECCAK_WRITE_ARGS = (
    "segments.write_arg(ids.inputs, [ids.low % 2 ** 64, "
    "ids.low // 2 ** 64])\n"
    "segments.write_arg(ids.inputs + 2, [ids.high % 2 ** 64, "
    "ids.high // 2 ** 64])"
)

COMPARE_BYTES_IN_WORD_NONDET = (
    "memory[ap] = to_felt_or_relocatable(ids.n_bytes < ids.BYTES_IN_WORD)"
)

COMPARE_KECCAK_FULL_RATE_IN_BYTES_NONDET = (
    "memory[ap] = to_felt_or_relocatable(ids.n_bytes >= "
    "ids.KECCAK_FULL_RATE_IN_BYTES)"
)

BLOCK_PERMUTATION = (
    "from starkware.cairo.common.cairo_keccak.keccak_utils import "
    "keccak_func\n"
    "_keccak_state_size_felts = int(ids.KECCAK_STATE_SIZE_FELTS)\n"
    "assert 0 <= _keccak_state_size_felts < 100\n\n"
    "output_values = keccak_func(memory.get_range(\n"
    "    ids.keccak_ptr - _keccak_state_size_felts, "
    "_keccak_state_size_felts))\n"
    "segments.write_arg(ids.keccak_ptr, output_values)"
)

CAIRO_KECCAK_FINALIZE = (
    "# Add dummy pairs of input and output.\n"
    "_keccak_state_size_felts = int(ids.KECCAK_STATE_SIZE_FELTS)\n"
    "_block_size = int(ids.BLOCK_SIZE)\n"
    "assert 0 <= _keccak_state_size_felts < 100\n"
    "assert 0 <= _block_size < 10\n"
    "inp = [0] * _keccak_state_size_felts\n"
    "padding = (inp + keccak_func(inp)) * _block_size\n"
    "segments.write_arg(ids.keccak_ptr_end, padding)"
)


def _keccak_func(lanes):
    from ..hash.keccak_host import keccak_f

    return keccak_f([v & ((1 << 64) - 1) for v in lanes])


def _h_keccak_write_args(vm, ids, ap, fp):
    inputs = ids.get("inputs")
    low, high = _felt(ids.low), _felt(ids.high)
    _write_arg(vm, inputs, [low % (1 << 64), low // (1 << 64)])
    _write_arg(vm, inputs + 2, [high % (1 << 64), high // (1 << 64)])


def _h_compare_bytes_in_word(vm, ids, ap, fp):
    bound = _ids_get(ids, "BYTES_IN_WORD", 8)
    vm.mem_set(ap, 1 if _felt(ids.n_bytes) < bound else 0)


def _h_compare_keccak_full_rate(vm, ids, ap, fp):
    bound = _ids_get(ids, "KECCAK_FULL_RATE_IN_BYTES", 136)
    vm.mem_set(ap, 1 if _felt(ids.n_bytes) >= bound else 0)


def _h_block_permutation(vm, ids, ap, fp):
    size = _ids_get(ids, "KECCAK_STATE_SIZE_FELTS", 25)
    if not 0 <= size < 100:
        raise HintError(f"bad KECCAK_STATE_SIZE_FELTS {size}")
    ptr = ids.get("keccak_ptr")
    state = vm.get_range(ptr - size, size)
    if None in state:
        raise HintError("keccak block permutation: uninitialized state")
    _write_arg(vm, ptr, _keccak_func(state))


def _h_cairo_keccak_finalize(vm, ids, ap, fp):
    size = _ids_get(ids, "KECCAK_STATE_SIZE_FELTS", 25)
    block_size = _ids_get(ids, "BLOCK_SIZE", 3)
    if not 0 <= size < 100 or not 0 <= block_size < 1000:
        raise HintError("bad cairo_keccak finalize constants")
    inp = [0] * size
    padding = (inp + _keccak_func(inp)) * block_size
    _write_arg(vm, ids.get("keccak_ptr_end"), padding)


# ---------------------------------------------------------------------------
# signature.cairo
# ---------------------------------------------------------------------------

VERIFY_ECDSA_SIGNATURE = (
    "ecdsa_builtin.add_signature(ids.ecdsa_ptr.address_, "
    "(ids.signature_r, ids.signature_s))"
)


def _h_verify_ecdsa_signature(vm, ids, ap, fp):
    """Registers (r, s) with the ecdsa SignatureBuiltinRunner for the
    instance ids.ecdsa_ptr points at; validation happens when the program
    writes the [pub_key, message] pair (vm._validate_signature_cell)."""
    addr = ids.get("ecdsa_ptr")  # pointer value = instance base address
    r = _felt(ids.get("signature_r"))
    s = _felt(ids.get("signature_s"))
    try:
        vm.add_signature(addr, (r, s))
    except Exception as e:
        raise HintError(str(e))


STDLIB_IMPLS = {
    ASSERT_NOT_ZERO: _h_assert_not_zero,
    VERIFY_ECDSA_SIGNATURE: _h_verify_ecdsa_signature,
    USORT_ENTER_SCOPE: _h_usort_enter_scope,
    USORT_BODY: _h_usort_body,
    USORT_VERIFY: _h_usort_verify,
    USORT_VERIFY_MULTIPLICITY_ASSERT: _h_usort_multiplicity_assert,
    USORT_VERIFY_MULTIPLICITY_BODY: _h_usort_multiplicity_body,
    BLAKE2S_COMPUTE: _h_blake2s_compute,
    BLAKE2S_ADD_UINT256: _h_blake2s_add_uint256,
    BLAKE2S_ADD_UINT256_BIGEND: _h_blake2s_add_uint256_bigend,
    BLAKE2S_FINALIZE: _h_blake2s_finalize,
    SHA256_MAIN_CONSTANT_INPUT_LENGTH: _h_sha256_main_constant,
    SHA256_MAIN_ARBITRARY_INPUT_LENGTH: _h_sha256_main_arbitrary,
    SHA256_FINALIZE: _h_sha256_finalize,
    KECCAK_WRITE_ARGS: _h_keccak_write_args,
    COMPARE_BYTES_IN_WORD_NONDET: _h_compare_bytes_in_word,
    COMPARE_KECCAK_FULL_RATE_IN_BYTES_NONDET: _h_compare_keccak_full_rate,
    BLOCK_PERMUTATION: _h_block_permutation,
    CAIRO_KECCAK_FINALIZE: _h_cairo_keccak_finalize,
    ASSERT_NOT_EQUAL: _h_assert_not_equal,
    ASSERT_LE_FELT: _h_assert_le_felt,
    ASSERT_LE_FELT_EXCLUDED_0: _h_assert_le_felt_excluded(0),
    ASSERT_LE_FELT_EXCLUDED_1: _h_assert_le_felt_excluded(1),
    ASSERT_LE_FELT_EXCLUDED_2: _h_assert_le_felt_excluded(2),
    ASSERT_LT_FELT: _h_assert_lt_felt,
    ASSERT_250_BITS: _h_assert_250_bits,
    SPLIT_FELT: _h_split_felt,
    SPLIT_INT_ASSERT_RANGE: _h_split_int_assert_range,
    SPLIT_INT: _h_split_int,
    SQRT: _h_sqrt,
    ABS_VALUE: _h_abs_value,
    VM_ENTER_SCOPE: _h_vm_enter_scope,
    VM_EXIT_SCOPE: _h_vm_exit_scope,
    MEMCPY_ENTER_SCOPE: _h_memcpy_enter_scope,
    MEMCPY_CONTINUE_COPYING: _h_continue("continue_copying"),
    MEMSET_ENTER_SCOPE: _h_memset_enter_scope,
    MEMSET_CONTINUE_LOOP: _h_continue("continue_loop"),
    FIND_ELEMENT: _h_find_element,
    SEARCH_SORTED_LOWER: _h_search_sorted_lower,
    SET_ADD: _h_set_add,
    DICT_NEW: _h_dict_new,
    DEFAULT_DICT_NEW: _h_default_dict_new,
    DICT_READ: _h_dict_read,
    DICT_WRITE: _h_dict_write,
    DICT_UPDATE: _h_dict_update,
    DICT_SQUASH_COPY_DICT: _h_dict_squash_copy_dict,
    DICT_SQUASH_UPDATE_PTR: _h_dict_squash_update_ptr,
    SQUASH_DICT: _h_squash_dict,
    SQUASH_DICT_INNER_SKIP_LOOP: _h_squash_dict_inner_skip_loop,
    SQUASH_DICT_INNER_FIRST_ITERATION: _h_squash_dict_inner_first_iteration,
    SQUASH_DICT_INNER_CHECK_ACCESS_INDEX:
        _h_squash_dict_inner_check_access_index,
    SQUASH_DICT_INNER_CONTINUE_LOOP: _h_squash_dict_inner_continue_loop,
    SQUASH_DICT_INNER_LEN_ASSERT: _h_squash_dict_inner_len_assert,
    SQUASH_DICT_INNER_USED_ACCESSES_ASSERT:
        _h_squash_dict_inner_used_accesses_assert,
    SQUASH_DICT_INNER_ASSERT_LEN_KEYS: _h_squash_dict_inner_assert_len_keys,
    SQUASH_DICT_INNER_NEXT_KEY: _h_squash_dict_inner_next_key,
    UINT256_ADD: _h_uint256_add,
    SPLIT_64: _h_split_64,
    UINT256_SQRT: _h_uint256_sqrt,
    UINT256_SIGNED_NN: _h_uint256_signed_nn,
    UINT256_UNSIGNED_DIV_REM: _h_uint256_unsigned_div_rem,
    UINT256_MUL_DIV_MOD: _h_uint256_mul_div_mod,
}


def register(registry: dict, hint_error: type) -> None:
    """Merge the stdlib impls into hints.HINT_IMPLS, rebinding this
    module's error type to the canonical HintError."""
    global HintError
    HintError = hint_error
    registry.update(STDLIB_IMPLS)
