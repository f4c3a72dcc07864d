"""Cairo0 `fib(1, 1, n)`: the reference's
`cairo_programs/cairo0/fibonacci_*.cairo`, assembled by hand."""

from __future__ import annotations

from .. import cairo as c


def _push(v):  # [ap] = v; ap++
    return [c.encode(0, -1, 1, 0, 1, c.OP1_IMM, 0, 0, c.AP_ADD1, c.ASSERT_EQ),
            v % c.P]


def _call_rel(off):
    return [c.encode(0, 1, 1, 0, 0, c.OP1_IMM, 0, c.PC_REL, 0, c.CALL),
            off % c.P]


def _copy_fp(off):  # [ap] = [fp + off]; ap++
    return c.encode(0, -1, off, 0, 1, c.OP1_FP, 0, 0, c.AP_ADD1, c.ASSERT_EQ)


_RET = c.encode(-2, -1, -1, 1, 1, c.OP1_FP, 0, c.PC_ABS, 0, c.RET)


def bytecode(n: int) -> list[int]:
    """main: push 1, 1, n; call fib; ret.  fib: if n == 0 return first, else
    fib(second, first + second, n - 1)."""
    data = _push(1) + _push(1) + _push(n) + _call_rel(3) + [_RET]
    # 9: jnz to the body if n != 0; 11-12: return first
    data += [c.encode(-3, -1, 1, 1, 1, c.OP1_IMM, 0, c.PC_JNZ, 0, 0), 4]
    data += [_copy_fp(-4), _RET]
    # 13: first' = second; 14: second' = first + second; 15: n - 1
    data += [_copy_fp(-4)]
    data += [c.encode(0, -5, -4, 0, 1, c.OP1_FP, c.RES_ADD, 0, c.AP_ADD1,
                      c.ASSERT_EQ)]
    data += [c.encode(0, -3, 1, 0, 1, c.OP1_IMM, c.RES_ADD, 0, c.AP_ADD1,
                      c.ASSERT_EQ), c.P - 1]
    data += _call_rel(9 - len(data)) + [_RET]
    return data
