"""FNV-1a hashing (copy of granite_tpu/utils/hashing.py; reference:
util/hash.hpp:105, util/compile_time_hash.hpp).

Every cached object in the reference is content-hashed with FNV-1a; the
same scheme keeps hashed keys equal across runs and across both
packages.
"""

from __future__ import annotations

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a(data, h: int = FNV_OFFSET) -> int:
    """Hash bytes/str/int with 64-bit FNV-1a."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    elif isinstance(data, int):
        data = data.to_bytes(8, "little", signed=False) if data >= 0 else (
            data & _MASK).to_bytes(8, "little")
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & _MASK
    return h


def hash_combine(h: int, value) -> int:
    return fnv1a(value, h)


class Hasher:
    """Streaming hasher mirroring Util::Hasher (util/hash.hpp)."""

    def __init__(self, h: int = FNV_OFFSET):
        self._h = h

    def data(self, b) -> "Hasher":
        self._h = fnv1a(b, self._h)
        return self

    def u32(self, v: int) -> "Hasher":
        self._h = fnv1a((v & 0xFFFFFFFF).to_bytes(4, "little"), self._h)
        return self

    def u64(self, v: int) -> "Hasher":
        self._h = fnv1a((v & _MASK).to_bytes(8, "little"), self._h)
        return self

    def f32(self, v: float) -> "Hasher":
        import struct
        self._h = fnv1a(struct.pack("<f", v), self._h)
        return self

    def string(self, s: str) -> "Hasher":
        self._h = fnv1a(s, self._h)
        return self

    def get(self) -> int:
        return self._h
