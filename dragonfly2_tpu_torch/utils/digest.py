"""Digest parse / compute / verify in ``algo:hex`` form (the port's copy of
dragonfly2_tpu/utils/digest.py).

Parity with reference pkg/digest (md5/sha1/sha256, ``md5:xxx`` string format,
used for piece validation in client/daemon/storage and task metadata).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import BinaryIO, Iterable

ALGORITHMS = ("sha256", "sha1", "md5", "sha512", "crc32")

_HEX_LEN = {"md5": 32, "sha1": 40, "sha256": 64, "sha512": 128, "crc32": 8}


class InvalidDigestError(ValueError):
    pass


@dataclass(frozen=True, slots=True)
class Digest:
    algorithm: str
    encoded: str

    def __str__(self) -> str:
        return f"{self.algorithm}:{self.encoded}"

    def verify_bytes(self, data: bytes) -> bool:
        return compute(self.algorithm, [data]).encoded == self.encoded


def parse(s: str) -> Digest:
    algo, sep, enc = s.partition(":")
    if not sep or algo not in ALGORITHMS:
        raise InvalidDigestError(f"invalid digest string: {s!r}")
    enc = enc.lower()
    want = _HEX_LEN[algo]
    if len(enc) != want or any(c not in "0123456789abcdef" for c in enc):
        raise InvalidDigestError(f"invalid {algo} hex (want {want} chars): {s!r}")
    return Digest(algo, enc)


def _hasher(algorithm: str):
    if algorithm == "crc32":
        import zlib

        class _CRC32:
            def __init__(self) -> None:
                self.v = 0

            def update(self, data: bytes) -> None:
                self.v = zlib.crc32(data, self.v)

            def hexdigest(self) -> str:
                return f"{self.v:08x}"

        return _CRC32()
    if algorithm not in ALGORITHMS:
        raise InvalidDigestError(f"unsupported algorithm: {algorithm}")
    return hashlib.new(algorithm)


def compute(algorithm: str, chunks: Iterable[bytes]) -> Digest:
    h = _hasher(algorithm)
    for chunk in chunks:
        h.update(chunk)
    return Digest(algorithm, h.hexdigest())


def compute_file(algorithm: str, f: BinaryIO, *, bufsize: int = 1 << 20) -> Digest:
    h = _hasher(algorithm)
    while True:
        chunk = f.read(bufsize)
        if not chunk:
            break
        h.update(chunk)
    return Digest(algorithm, h.hexdigest())


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()
