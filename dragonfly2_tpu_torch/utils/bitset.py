"""Piece bitmap.

The port's own copy of dragonfly2_tpu/utils/bitset.py.

Parity with the reference's piece Bitmap (client/daemon/peer, pkg/container
bitset helpers): tracks which pieces of a task are finished; cheap union /
difference drives "which pieces can this parent give me that I don't have".
"""

from __future__ import annotations

from typing import Iterator


class Bitset:
    __slots__ = ("_bits", "_count")

    def __init__(self, bits: int = 0):
        self._bits = bits
        self._count = bits.bit_count()

    @classmethod
    def from_indices(cls, indices) -> "Bitset":
        b = 0
        for i in indices:
            b |= 1 << i
        return cls(b)

    def set(self, i: int) -> bool:
        """Set bit i; returns True if it was newly set."""
        mask = 1 << i
        if self._bits & mask:
            return False
        self._bits |= mask
        self._count += 1
        return True

    def clear(self, i: int) -> None:
        mask = 1 << i
        if self._bits & mask:
            self._bits &= ~mask
            self._count -= 1

    def test(self, i: int) -> bool:
        return bool(self._bits >> i & 1)

    def count(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._bits == 0

    def indices(self) -> Iterator[int]:
        bits, i = self._bits, 0
        while bits:
            if bits & 1:
                yield i
            bits >>= 1
            i += 1

    def missing_until(self, total: int) -> Iterator[int]:
        """Indices in [0, total) not set — the pieces still to download."""
        for i in range(total):
            if not self.test(i):
                yield i

    def difference(self, other: "Bitset") -> "Bitset":
        return Bitset(self._bits & ~other._bits)

    def union(self, other: "Bitset") -> "Bitset":
        return Bitset(self._bits | other._bits)

    def intersection(self, other: "Bitset") -> "Bitset":
        return Bitset(self._bits & other._bits)

    def copy(self) -> "Bitset":
        return Bitset(self._bits)

    def to_int(self) -> int:
        return self._bits

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Bitset) and self._bits == other._bits

    def __repr__(self) -> str:
        return f"Bitset({sorted(self.indices())})"
