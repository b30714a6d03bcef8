"""The msgpack subset that flax writes for a parameter tree, encoded and decoded.

``flax.serialization.to_bytes`` writes a state dict as msgpack: maps with
str keys, and each ndarray leaf as ``ExtType(1, packb((shape, dtype.name,
bytes)))`` (``flax/serialization.py``, ``_ndarray_to_bytes`` and
``_msgpack_ext_pack``). The port reads and writes the JAX package's
``params.msgpack`` with this copy of that subset, so that it needs no
msgpack package. ``to_bytes`` gives the bytes flax gives for the same tree
(maps in their insertion order, every integer and length in msgpack's
smallest form); ``from_bytes`` gives back a tree of dicts with numpy leaves.
Arrays of 2**30 bytes or more, which flax splits into chunks, are refused.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

_EXT_NDARRAY = 1
_MAX_LEAF_BYTES = 2**30  # flax chunks leaves at this size; parameter trees stay far below it


def _pack_uint(n: int, tags: tuple[int, int, int], out: bytearray, fix: int | None = None,
               fix_limit: int = 0) -> None:
    """A length or count header: a fix form below ``fix_limit``, else the
    8/16/32-bit forms whose tags are given (None where msgpack has none)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
    elif tags[0] is not None and n < 2**8:
        out += bytes((tags[0], n))
    elif n < 2**16:
        out += bytes((tags[1],)) + struct.pack(">H", n)
    elif n < 2**32:
        out += bytes((tags[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack cannot frame {n} items or bytes")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32),
                                (0xCF, ">Q", 2**64)):
            if n < limit:
                out += bytes((tag,)) + struct.pack(fmt, n)
                return
        raise OverflowError(n)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15), (0xD2, ">i", 2**31),
                                (0xD3, ">q", 2**63)):
            if n >= -limit:
                out += bytes((tag,)) + struct.pack(fmt, n)
                return
        raise OverflowError(n)


def _pack_str(s: str, out: bytearray) -> None:
    raw = s.encode("utf-8")
    _pack_uint(len(raw), (0xD9, 0xDA, 0xDB), out, fix=0xA0, fix_limit=32)
    out += raw


def _pack_bin(b: bytes, out: bytearray) -> None:
    _pack_uint(len(b), (0xC4, 0xC5, 0xC6), out)
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_uint(len(data), (0xC7, 0xC8, 0xC9), out)
    out.append(code)
    out += data


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, Mapping):
        _pack_uint(len(obj), (None, 0xDE, 0xDF), out, fix=0x80, fix_limit=16)
        for key, val in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, not {type(key).__name__}")
            _pack_str(key, out)
            _pack(val, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_to_bytes(obj), out)
    elif isinstance(obj, (list, tuple)):
        _pack_uint(len(obj), (None, 0xDC, 0xDD), out, fix=0x90, fix_limit=16)
        for val in obj:
            _pack(val, out)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        _pack_str(obj, out)
    elif isinstance(obj, bytes):
        _pack_bin(obj, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in a parameter tree")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not supported")
    data = np.ascontiguousarray(arr).tobytes()
    if len(data) >= _MAX_LEAF_BYTES:
        raise ValueError(f"array of {len(data)} bytes: flax would chunk it, this codec does not")
    out = bytearray()
    _pack(([int(d) for d in arr.shape], arr.dtype.name, data), out)
    return bytes(out)


def to_bytes(tree: Mapping[str, Any]) -> bytes:
    """Encode a tree of str-keyed maps with numpy leaves as flax does."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos : self.pos + n]
        self.pos += n
        return view

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def sint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big", signed=True)

    def value(self) -> Any:
        tag = self.uint(1)
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        sizes = {0: 1, 1: 2, 2: 4, 3: 8}
        if 0xCC <= tag <= 0xCF:
            return self.uint(sizes[tag - 0xCC])
        if 0xD0 <= tag <= 0xD3:
            return self.sint(sizes[tag - 0xD0])
        if tag in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.uint(sizes[tag - 0xD9])), "utf-8")
        if tag in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(sizes[tag - 0xC4])))
        if tag in (0xDC, 0xDD):
            return [self.value() for _ in range(self.uint(2 if tag == 0xDC else 4))]
        if tag in (0xDE, 0xDF):
            return self.map(self.uint(2 if tag == 0xDE else 4))
        if 0xD4 <= tag <= 0xD8:
            return self.ext(1 << (tag - 0xD4))
        if tag in (0xC7, 0xC8, 0xC9):
            return self.ext(self.uint(sizes[tag - 0xC7]))
        raise ValueError(f"msgpack type 0x{tag:02x} is outside the subset flax writes for parameters")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a str")
            out[key] = self.value()
        return out

    def ext(self, size: int) -> np.ndarray:
        code = self.sint(1)
        payload = bytes(self.take(size))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack extension type {code} is not an ndarray")
        inner = _Reader(payload)
        shape, dtype_name, buf = inner.value()
        if inner.pos != len(payload):
            raise ValueError("trailing bytes in an ndarray extension")
        return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def from_bytes(data: bytes) -> Any:
    """Decode what ``to_bytes`` (or flax's ``to_bytes``) wrote: str-keyed
    dicts with numpy leaves. Raises ValueError on anything outside that
    subset or on truncated or trailing bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out
