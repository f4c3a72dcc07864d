"""The benchmark's plain reference: a Cairo VM that works out what a proof
must state, and a STARK verifier that holds the proof's bytes to it.

It imports nothing of the prover under test (a test checks that)."""

from __future__ import annotations

import importlib

from . import cairo, stark
from .stark import Options, Reject


def bytecode(program: str, n: int) -> list[int]:
    """``program`` at size ``n``, from `programs/<program>.py`."""
    return importlib.import_module(f"{__name__}.programs.{program}").bytecode(n)


def statement(program: str, n: int) -> cairo.Statement:
    """The public inputs of ``program``'s run at ``n``, from the reference's
    own assembler and VM."""
    return cairo.run(bytecode(program, n))


def check(proof_bytes: bytes, st: cairo.Statement, rows: int,
          options: Options) -> str | None:
    """None if the proof proves ``st`` over ``rows`` trace rows, else the
    reason it is rejected."""
    try:
        stark.verify(proof_bytes, cairo.CairoAir(st, rows), options)
    except Reject as e:
        return str(e)
    return None
