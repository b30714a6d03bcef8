"""Byte-size unit parsing/formatting (reference pkg/unit); the port of
dragonfly2_tpu/utils/unit.py."""

from __future__ import annotations

import re

_UNITS = {
    "": 1,
    "B": 1,
    "K": 1 << 10, "KB": 1 << 10, "KI": 1 << 10, "KIB": 1 << 10,
    "M": 1 << 20, "MB": 1 << 20, "MI": 1 << 20, "MIB": 1 << 20,
    "G": 1 << 30, "GB": 1 << 30, "GI": 1 << 30, "GIB": 1 << 30,
    "T": 1 << 40, "TB": 1 << 40, "TI": 1 << 40, "TIB": 1 << 40,
}

_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([A-Za-z]*)\s*$")

KB = 1 << 10
MB = 1 << 20
GB = 1 << 30


def parse_bytes(s: str | int | float) -> int:
    if isinstance(s, (int, float)):
        return int(s)
    m = _RE.match(s)
    if not m:
        raise ValueError(f"invalid size: {s!r}")
    value, suffix = float(m.group(1)), m.group(2).upper()
    if suffix not in _UNITS:
        raise ValueError(f"invalid size unit: {s!r}")
    return int(value * _UNITS[suffix])


def format_bytes(n: int | float) -> str:
    n = float(n)
    for suffix, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.1f}{suffix}"
    return f"{int(n)}B"
