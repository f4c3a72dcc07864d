"""Relocated Cairo memory (reference src/cairo/cairo_mem.rs).

Addresses are u64, values are Stark252 felts (python ints).  Binary format:
rows of 8-byte LE address + 32-byte LE value."""

from __future__ import annotations

from ..field.params import P


class CairoImportError(Exception):
    pass


class CairoMemory:
    def __init__(self, data: dict[int, int]):
        self.data = data

    def get(self, addr: int) -> int | None:
        return self.data.get(addr)

    def __len__(self) -> int:
        return len(self.data)

    @classmethod
    def from_bytes_le(cls, data: bytes) -> "CairoMemory":
        row = 40
        if len(data) % row != 0:
            raise CairoImportError("incorrect number of bytes")
        mem = {}
        for i in range(0, len(data), row):
            addr = int.from_bytes(data[i : i + 8], "little")
            value = int.from_bytes(data[i + 8 : i + 40], "little")
            if value >= P:
                raise CairoImportError("value out of field range")
            mem[addr] = value
        return cls(mem)

    @classmethod
    def from_file(cls, path: str) -> "CairoMemory":
        with open(path, "rb") as f:
            return cls.from_bytes_le(f.read())

    def to_bytes_le(self) -> bytes:
        out = bytearray()
        for addr in sorted(self.data):
            out.extend(addr.to_bytes(8, "little"))
            out.extend(self.data[addr].to_bytes(32, "little"))
        return bytes(out)
