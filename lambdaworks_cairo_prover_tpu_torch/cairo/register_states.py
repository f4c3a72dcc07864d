"""Register states per execution step (reference src/cairo/register_states.rs).

Binary format: rows of (ap, fp, pc), each 8-byte LE u64."""

from __future__ import annotations

from dataclasses import dataclass

from .cairo_mem import CairoImportError


@dataclass
class RegistersState:
    pc: int
    fp: int
    ap: int


class RegisterStates:
    def __init__(self, rows: list[RegistersState]):
        self.rows = rows

    @property
    def steps(self) -> int:
        return len(self.rows)

    @classmethod
    def from_bytes_le(cls, data: bytes) -> "RegisterStates":
        row = 24
        if len(data) % row != 0:
            raise CairoImportError("incorrect number of bytes")
        rows = []
        for i in range(0, len(data), row):
            ap = int.from_bytes(data[i : i + 8], "little")
            fp = int.from_bytes(data[i + 8 : i + 16], "little")
            pc = int.from_bytes(data[i + 16 : i + 24], "little")
            rows.append(RegistersState(pc=pc, fp=fp, ap=ap))
        return cls(rows)

    @classmethod
    def from_file(cls, path: str) -> "RegisterStates":
        with open(path, "rb") as f:
            return cls.from_bytes_le(f.read())

    def to_bytes_le(self) -> bytes:
        out = bytearray()
        for r in self.rows:
            out.extend(r.ap.to_bytes(8, "little"))
            out.extend(r.fp.to_bytes(8, "little"))
            out.extend(r.pc.to_bytes(8, "little"))
        return bytes(out)
