"""Cairo0 hint processor.

Replaces the hint-execution half of the `cairo-vm` crate that the reference
leans on (reference src/cairo/runner/run.rs:76-101 runs hinted Cairo0
programs like cairo_programs/cairo0/signed_div_rem.cairo through
`cairo_run` with the builtin hint processor).  Like cairo-vm's
`BuiltinHintProcessor`, hints are matched by their EXACT source string and
dispatched to native implementations; `ids.<name>` accesses resolve through
the compiled program's reference manager with ap-tracking correction.

Supported hint set = the starkware stdlib hints the reference's test
programs rely on (alloc, is_nn / is_nn_out_of_range / is_le_felt,
signed_div_rem, unsigned_div_rem, is_positive, memcpy's enter-scope-free
subset is NOT included).  Unknown hint codes raise `UnknownHintError` with
the offending source so gaps are loud.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..field.params import P

RC_BOUND = 1 << 128  # range_check_builtin.bound


class HintError(Exception):
    pass


class UnknownHintError(HintError):
    pass


# ---------------------------------------------------------------------------
# Reference-expression parser
# ---------------------------------------------------------------------------
#
# Compiled-JSON reference values are a tiny expression language, e.g.:
#   cast(fp + (-3), felt*)          -> address fp-3
#   [cast(fp + (-3), felt*)]        -> value at fp-3
#   cast([fp + (-6)] + 1, felt*)    -> (value at fp-6) + 1
#   [cast([fp + (-6)] + 1, felt*)]  -> value at ((value at fp-6) + 1)
# AST nodes: ("reg", "ap"|"fp"), ("const", int), ("add", l, r),
# ("mul", l, r), ("deref", expr).


_TOKEN_RE = re.compile(
    r"\s*(cast|ap|fp|[A-Za-z_][A-Za-z0-9_]*|\.|\*+|[0-9]+|\(|\)|\[|\]|,|\+|-)"
)


def _tokenize(s: str) -> list[str]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise HintError(f"cannot tokenize reference value {s!r} at {pos}")
        out.append(m.group(1))
        pos = m.end()
    return out


class _RefParser:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise HintError(f"expected {t!r}, got {got!r}")

    def parse_expr(self):
        node = self.parse_term()
        while self.peek() in ("+", "-"):
            op = self.next()
            rhs = self.parse_term()
            if op == "-":
                rhs = ("mul", ("const", P - 1), rhs)
            node = ("add", node, rhs)
        return node

    def parse_term(self):
        node = self.parse_atom()
        while self.peek() == "*" and self.toks[self.i] == "*":
            self.next()
            node = ("mul", node, self.parse_atom())
        return node

    def parse_atom(self):
        t = self.next()
        if t == "cast":
            self.expect("(")
            inner = self.parse_expr()
            self.expect(",")
            # swallow the type: felt, felt*, felt**, ...
            while self.peek() not in (")", None):
                self.next()
            self.expect(")")
            return inner
        if t == "[":
            inner = self.parse_expr()
            self.expect("]")
            return ("deref", inner)
        if t == "(":
            neg = False
            if self.peek() == "-":
                self.next()
                neg = True
            inner = self.parse_expr()
            self.expect(")")
            if neg:
                return ("mul", ("const", P - 1), inner)
            return inner
        if t in ("ap", "fp"):
            return ("reg", t)
        if t == "-":
            return ("mul", ("const", P - 1), self.parse_atom())
        if t is not None and t.isdigit():
            return ("const", int(t))
        raise HintError(f"unexpected token {t!r} in reference value")


def parse_reference_value(value: str):
    """Parse a reference `value` string into an AST (see module docstring)."""
    p = _RefParser(_tokenize(value))
    node = p.parse_expr()
    if p.peek() is not None:
        raise HintError(f"trailing tokens in reference value {value!r}")
    return node


# ---------------------------------------------------------------------------
# Hint / reference containers (compiled-JSON shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ApTracking:
    group: int = 0
    offset: int = 0

    @classmethod
    def from_json(cls, obj) -> "ApTracking":
        if not obj:
            return cls()
        return cls(group=obj.get("group", 0), offset=obj.get("offset", 0))


@dataclass
class Reference:
    """Lazily-parsed reference-manager entry.

    Real cairo-compile outputs carry struct-typed references (e.g.
    ``cast(ap + (-1), starkware.cairo.common.cairo_builtins.HashBuiltin*)``)
    that the expression grammar above cannot evaluate; parsing happens on
    first use so such entries only fail if a hint actually reads them
    (cairo-vm likewise builds HintReference lazily per hint)."""

    value: str
    ap_tracking: ApTracking
    _ast: object = field(default=None, repr=False)

    @property
    def ast(self):
        if self._ast is None:
            self._ast = parse_reference_value(self.value)
        return self._ast

    @classmethod
    def from_json(cls, obj) -> "Reference":
        return cls(
            value=obj["value"],
            ap_tracking=ApTracking.from_json(obj.get("ap_tracking_data")),
        )


@dataclass
class Hint:
    code: str
    ap_tracking: ApTracking = field(default_factory=ApTracking)
    reference_ids: dict = field(default_factory=dict)  # short name -> ref idx

    @classmethod
    def from_json(cls, obj) -> "Hint":
        ftd = obj.get("flow_tracking_data", {})
        refs = {}
        # Collapse fully-qualified paths to their last component, last one
        # wins — the same rule cairo-vm's get_ids_data applies, so shadowed
        # names resolve identically to the reference stack.
        for name, idx in ftd.get("reference_ids", {}).items():
            refs[name.rsplit(".", 1)[-1]] = idx
        return cls(
            code=obj["code"],
            ap_tracking=ApTracking.from_json(ftd.get("ap_tracking")),
            reference_ids=refs,
        )


def parse_program_hints(obj) -> tuple[dict, list]:
    """(hints: pc_offset -> [Hint], references: [Reference]) from compiled
    JSON's `hints` and `reference_manager` sections."""
    hints = {
        int(pc): [Hint.from_json(h) for h in hlist]
        for pc, hlist in obj.get("hints", {}).items()
    }
    refs = [
        Reference.from_json(r)
        for r in obj.get("reference_manager", {}).get("references", [])
    ]
    return hints, refs


# ---------------------------------------------------------------------------
# ids resolution
# ---------------------------------------------------------------------------


class Ids:
    """`ids.<name>` accessor for one hint execution.

    Reading evaluates the reference AST against (vm, ap, fp); writing
    requires the AST to be a `deref` (an addressable cell) and stores into
    the VM memory.  ap-tracking correction mirrors cairo-vm: a reference
    created at ap-tracking (g, o1) read at hint-time tracking (g, o2) uses
    ap' = ap - (o2 - o1); mismatched groups make ap-based refs unusable.
    """

    def __init__(self, vm, hint: Hint, references, ap, fp):
        self._vm = vm
        self._hint = hint
        self._refs = references
        self._ap = ap
        self._fp = fp

    def _reference(self, name: str) -> Reference:
        if name not in self._hint.reference_ids:
            raise HintError(f"hint has no reference for ids.{name}")
        return self._refs[self._hint.reference_ids[name]]

    def _corrected_ap(self, ref: Reference):
        ht, rt = self._hint.ap_tracking, ref.ap_tracking
        if ht.group != rt.group:
            raise HintError("ap tracking group mismatch for ap-based ref")
        return self._ap - (ht.offset - rt.offset)

    def _eval(self, node, ref: Reference):
        kind = node[0]
        if kind == "const":
            return node[1]
        if kind == "reg":
            return self._corrected_ap(ref) if node[1] == "ap" else self._fp
        if kind == "add":
            return self._vm._add(self._eval(node[1], ref),
                                 self._eval(node[2], ref))
        if kind == "mul":
            return self._vm._mul(self._eval(node[1], ref),
                                 self._eval(node[2], ref))
        if kind == "deref":
            addr = self._eval(node[1], ref)
            val = self._vm.mem_get(addr)
            if val is None:
                raise HintError(f"ids deref of unknown cell {addr}")
            return val
        raise HintError(f"bad AST node {node!r}")

    def get(self, name: str):
        ref = self._reference(name)
        return self._eval(ref.ast, ref)

    def get_address(self, name: str):
        """Address of an assignable (deref) reference."""
        ref = self._reference(name)
        if ref.ast[0] != "deref":
            raise HintError(f"ids.{name} is not an addressable cell")
        return self._eval(ref.ast[1], ref)

    def set(self, name: str, value) -> None:
        self._vm.mem_set(self.get_address(name), value)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)


# ---------------------------------------------------------------------------
# Hint implementations (exact starkware stdlib source strings)
# ---------------------------------------------------------------------------

ADD_SEGMENT = "memory[ap] = segments.add()"

IS_NN = (
    "memory[ap] = 0 if 0 <= (ids.a % PRIME) < range_check_builtin.bound "
    "else 1"
)

IS_NN_OUT_OF_RANGE = (
    "memory[ap] = 0 if 0 <= ((-ids.a - 1) % PRIME) < "
    "range_check_builtin.bound else 1"
)

IS_LE_FELT = "memory[ap] = 0 if (ids.a % PRIME) <= (ids.b % PRIME) else 1"

IS_POSITIVE = (
    "from starkware.cairo.common.math_utils import is_positive\n"
    "ids.is_positive = 1 if is_positive(\n"
    "    value=ids.value, prime=PRIME, rc_bound=range_check_builtin.bound) "
    "else 0"
)

ASSERT_NN = (
    "from starkware.cairo.common.math_utils import assert_integer\n"
    "assert_integer(ids.a)\n"
    "assert 0 <= ids.a % PRIME < range_check_builtin.bound, "
    "f'a = {ids.a} is out of range.'"
)

SIGNED_DIV_REM = (
    "from starkware.cairo.common.math_utils import as_int, assert_integer\n"
    "\n"
    "assert_integer(ids.div)\n"
    "assert 0 < ids.div <= PRIME // range_check_builtin.bound, \\\n"
    "    f'div={hex(ids.div)} is out of the valid range.'\n"
    "\n"
    "assert_integer(ids.bound)\n"
    "assert ids.bound <= range_check_builtin.bound // 2, \\\n"
    "    f'bound={hex(ids.bound)} is out of the valid range.'\n"
    "\n"
    "int_value = as_int(ids.value, PRIME)\n"
    "q, ids.r = divmod(int_value, ids.div)\n"
    "\n"
    "assert -ids.bound <= q < ids.bound, \\\n"
    "    f'{int_value} / {ids.div} = {q} is out of the range "
    "[{-ids.bound}, {ids.bound}).'\n"
    "\n"
    "ids.biased_q = q + ids.bound"
)

UNSIGNED_DIV_REM = (
    "from starkware.cairo.common.math_utils import assert_integer\n"
    "assert_integer(ids.div)\n"
    "assert 0 < ids.div <= PRIME // range_check_builtin.bound, \\\n"
    "    f'div={hex(ids.div)} is out of the valid range.'\n"
    "ids.q, ids.r = divmod(ids.value, ids.div)"
)


def _as_int(v: int) -> int:
    """Signed representative in (-P/2, P/2] (starkware math_utils.as_int)."""
    return v if v < P // 2 else v - P


def _write_ap(vm, ap, value) -> None:
    vm.mem_set(ap, value)


def _h_add_segment(vm, ids, ap, fp):
    _write_ap(vm, ap, vm.add_segment())


def _h_is_nn(vm, ids, ap, fp):
    _write_ap(vm, ap, 0 if 0 <= ids.a % P < RC_BOUND else 1)


def _h_is_nn_out_of_range(vm, ids, ap, fp):
    _write_ap(vm, ap, 0 if 0 <= (-ids.a - 1) % P < RC_BOUND else 1)


def _h_is_le_felt(vm, ids, ap, fp):
    _write_ap(vm, ap, 0 if (ids.a % P) <= (ids.b % P) else 1)


def _h_is_positive(vm, ids, ap, fp):
    int_value = _as_int(ids.value)
    # starkware math_utils.is_positive asserts the value is rc-representable
    if not abs(int_value) < RC_BOUND:
        raise HintError(f"value={ids.value} is out of the valid range.")
    ids.set("is_positive", 1 if 0 < int_value else 0)


def _h_assert_nn(vm, ids, ap, fp):
    if not 0 <= ids.a % P < RC_BOUND:
        raise HintError(f"a = {ids.a} is out of range.")


def _h_signed_div_rem(vm, ids, ap, fp):
    div, bound = ids.div, ids.bound
    if not 0 < div <= P // RC_BOUND:
        raise HintError(f"div={hex(div)} is out of the valid range.")
    if not bound <= RC_BOUND // 2:
        raise HintError(f"bound={hex(bound)} is out of the valid range.")
    int_value = _as_int(ids.value)
    q, r = divmod(int_value, div)
    if not -bound <= q < bound:
        raise HintError(
            f"{int_value} / {div} = {q} is out of range [-{bound}, {bound})."
        )
    ids.set("r", r)
    ids.set("biased_q", (q + bound) % P)


def _h_unsigned_div_rem(vm, ids, ap, fp):
    div = ids.div
    if not 0 < div <= P // RC_BOUND:
        raise HintError(f"div={hex(div)} is out of the valid range.")
    q, r = divmod(ids.value, div)
    ids.set("q", q)
    ids.set("r", r)


HINT_IMPLS = {
    ADD_SEGMENT: _h_add_segment,
    IS_NN: _h_is_nn,
    IS_NN_OUT_OF_RANGE: _h_is_nn_out_of_range,
    IS_LE_FELT: _h_is_le_felt,
    IS_POSITIVE: _h_is_positive,
    ASSERT_NN: _h_assert_nn,
    SIGNED_DIV_REM: _h_signed_div_rem,
    UNSIGNED_DIV_REM: _h_unsigned_div_rem,
}


# starkware stdlib families beyond the core math subset (memcpy/memset,
# find_element, set, dict/squash_dict, uint256, the assert/split/sqrt
# family) live in hints_stdlib.py; merged into the same registry so
# execute_hint dispatches uniformly
from . import hints_stdlib as _stdlib  # noqa: E402

_stdlib.register(HINT_IMPLS, HintError)


def execute_hint(vm, hint: Hint, references, ap, fp) -> None:
    impl = HINT_IMPLS.get(hint.code)
    if impl is None:
        raise UnknownHintError(
            f"unknown hint (pc-matched, code not in registry):\n{hint.code}"
        )
    impl(vm, Ids(vm, hint, references, ap, fp), ap, fp)
