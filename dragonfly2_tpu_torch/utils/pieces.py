"""Piece geometry: sizes, ranges, HTTP Range parsing.

The port's own copy of dragonfly2_tpu/utils/pieces.py.

Parity with reference client/daemon/peer/piece_manager.go (computePieceSize —
piece size scales up with content length so huge files don't explode into
millions of pieces) and pkg/net/http/range.go (Range header parse/format).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

DEFAULT_PIECE_SIZE = 4 << 20  # 4 MiB
MAX_PIECE_SIZE = 64 << 20
# Content-length thresholds at which the piece size doubles (reference scales
# piece size by size class: <=256 MiB → 4 MiB pieces, then doubles per 4x).
_SIZE_STEP = 256 << 20


def compute_piece_size(content_length: int) -> int:
    """Piece size for a task: 4 MiB base, doubling per 4x of 256 MiB, cap 64 MiB."""
    if content_length <= 0:
        return DEFAULT_PIECE_SIZE
    size = DEFAULT_PIECE_SIZE
    threshold = _SIZE_STEP
    while content_length > threshold and size < MAX_PIECE_SIZE:
        size *= 2
        threshold *= 4
    return size


def piece_count(content_length: int, piece_size: int) -> int:
    if content_length <= 0:
        return 0
    return (content_length + piece_size - 1) // piece_size


@dataclass(frozen=True, slots=True)
class Range:
    """Byte range [start, start+length), mirroring nethttp.Range."""

    start: int
    length: int

    @property
    def end(self) -> int:  # inclusive, HTTP-style
        return self.start + self.length - 1

    def header(self) -> str:
        return f"bytes={self.start}-{self.end}"


def piece_range(piece_index: int, piece_size: int, content_length: int) -> Range:
    start = piece_index * piece_size
    length = min(piece_size, content_length - start)
    if length <= 0:
        raise ValueError(f"piece {piece_index} out of range for length {content_length}")
    return Range(start, length)


_RANGE_RE = re.compile(r"^\s*bytes\s*=\s*(\d*)\s*-\s*(\d*)\s*$")


def parse_http_range(header: str, total: int) -> Range:
    """Parse a single-part HTTP Range header against a known total size."""
    if total < 0:
        raise ValueError("total size must be known to resolve a Range header")
    m = _RANGE_RE.match(header)
    if not m:
        raise ValueError(f"unsupported Range header: {header!r}")
    first, last = m.group(1), m.group(2)
    if first == "" and last == "":
        raise ValueError(f"empty Range: {header!r}")
    if first == "":  # suffix form: last N bytes
        n = int(last)
        if n <= 0:
            raise ValueError("zero-length suffix range")
        n = min(n, total)
        return Range(total - n, n)
    start = int(first)
    if start >= total > 0:
        raise ValueError(f"range start {start} beyond size {total}")
    end = int(last) if last else total - 1
    end = min(end, total - 1)
    if end < start:
        raise ValueError(f"inverted range: {header!r}")
    return Range(start, end - start + 1)


def parse_range_spec(spec: str) -> Range:
    """Parse a user-facing ``start-end`` spec (dfget --range), end inclusive."""
    m = re.match(r"^(\d+)-(\d+)$", spec.strip())
    if not m:
        raise ValueError(f"invalid range spec {spec!r}, want start-end")
    start, end = int(m.group(1)), int(m.group(2))
    if end < start:
        raise ValueError(f"inverted range spec: {spec!r}")
    return Range(start, end - start + 1)
