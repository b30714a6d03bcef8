"""Dependency-free safetensors reader/writer.

The port's own copy of dragonfly2_tpu/tpuvm/safetensors.py (the port
imports nothing of the JAX package); it writes the same bytes.

Format (the HF safetensors on-disk layout): 8-byte little-endian u64 header
size, then a JSON header mapping tensor name → {dtype, shape, data_offsets}
(offsets relative to the end of the header), then the raw tensor bytes.
Reading goes through np.memmap so staging a single shard of a multi-GB file
touches only that shard's pages — the point of the staging path.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np

_DTYPES: dict[str, np.dtype] = {
    "BOOL": np.dtype(np.bool_),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "I16": np.dtype(np.int16),
    "U16": np.dtype(np.uint16),
    "I32": np.dtype(np.int32),
    "U32": np.dtype(np.uint32),
    "I64": np.dtype(np.int64),
    "U64": np.dtype(np.uint64),
    "F16": np.dtype(np.float16),
    "F32": np.dtype(np.float32),
    "F64": np.dtype(np.float64),
    # bfloat16 has no numpy dtype; expose as uint16 raw bits, which the
    # staging layer reinterprets as torch.bfloat16
    "BF16": np.dtype(np.uint16),
}
_FROM_NP = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.int16): "I16",
    np.dtype(np.uint16): "U16",
    np.dtype(np.int32): "I32",
    np.dtype(np.uint32): "U32",
    np.dtype(np.int64): "I64",
    np.dtype(np.uint64): "U64",
    np.dtype(np.float16): "F16",
    np.dtype(np.float32): "F32",
    np.dtype(np.float64): "F64",
}


class SafetensorsError(Exception):
    pass


def read_header_ex(path: str | Path) -> tuple[dict[str, Any], int]:
    """Parse the JSON header; returns ({name: {dtype, shape, data_offsets}},
    data_start_offset). Reads only the header bytes."""
    path = Path(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: truncated header length")
        (hlen,) = struct.unpack("<Q", raw)
        if hlen > 100 << 20:
            raise SafetensorsError(f"{path}: implausible header size {hlen}")
        header = json.loads(f.read(hlen))
    return header, 8 + hlen


def read_header(path: str | Path) -> dict[str, Any]:
    return read_header_ex(path)[0]


def tensor_names(path: str | Path) -> list[str]:
    return [k for k in read_header(path) if k != "__metadata__"]


def read_tensor(
    path: str | Path,
    name: str,
    *,
    header: dict | None = None,
    data_start: int | None = None,
) -> np.ndarray:
    """Memmap one tensor's bytes; BF16 comes back as uint16 raw bits
    (see _DTYPES). The returned array is a copy-on-read view — cheap until
    touched, so slicing before materialization reads only the slice.

    Pass (header, data_start) from read_header_ex to avoid re-reading the
    header per tensor on multi-hundred-tensor files."""
    path = Path(path)
    if header is None or data_start is None:
        header, data_start = read_header_ex(path)
    info = header.get(name)
    if info is None:
        raise SafetensorsError(f"{path}: no tensor {name!r}")
    dtype = _DTYPES.get(info["dtype"])
    if dtype is None:
        raise SafetensorsError(f"{path}: unsupported dtype {info['dtype']}")
    start, end = info["data_offsets"]
    count = (end - start) // dtype.itemsize
    mm = np.memmap(path, dtype=dtype, mode="r", offset=data_start + start, shape=(count,))
    return mm.reshape(info["shape"])


def write_safetensors(
    path: str | Path,
    tensors: Mapping[str, np.ndarray],
    *,
    metadata: Mapping[str, str] | None = None,
    bf16_names: Iterable[str] = (),
) -> Path:
    """Write tensors (sorted by name, contiguous) to a safetensors file.
    Names in bf16_names must be uint16 raw-bit arrays and are tagged BF16."""
    path = Path(path)
    bf16 = set(bf16_names)
    header: dict[str, Any] = {}
    offset = 0
    order = sorted(tensors)
    blobs: list[bytes] = []
    for name in order:
        arr = np.ascontiguousarray(tensors[name])
        if name in bf16:
            if arr.dtype != np.uint16:
                raise SafetensorsError(f"{name}: BF16 tensors must be uint16 raw bits")
            tag = "BF16"
        else:
            tag = _FROM_NP.get(arr.dtype)
            if tag is None:
                raise SafetensorsError(f"{name}: unsupported dtype {arr.dtype}")
        blob = arr.tobytes()
        header[name] = {
            "dtype": tag,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        offset += len(blob)
        blobs.append(blob)
    if metadata:
        header["__metadata__"] = dict(metadata)
    hjson = json.dumps(header, separators=(",", ":")).encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
    return path
