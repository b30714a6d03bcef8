"""Task / peer / host ID generation.

The port's own copy of dragonfly2_tpu/utils/idgen.py.

Parity with reference pkg/idgen/task_id.go:37-95 and peer_id.go:27-37:
task IDs are content-addressed (sha256 over the URL with filtered query
params plus download-affecting metadata) so that every peer asking for the
same object lands on the same task; peer IDs are host-scoped and unique per
download attempt; seed peers carry a marker suffix so schedulers can
distinguish them without a lookup.
"""

from __future__ import annotations

import hashlib
import os
import socket
from urllib.parse import parse_qsl, urlencode, urlsplit, urlunsplit

_SEED_PEER_SUFFIX = "_seed"


def filter_query(url: str, filters: tuple[str, ...] | list[str] = ()) -> str:
    """Drop the named query parameters from *url* (order-preserving).

    Used so that signed URLs (expiry tokens etc.) map to one task identity,
    mirroring the reference's filtered-query task keying.
    """
    if not filters:
        return url
    parts = urlsplit(url)
    drop = set(filters)
    params = parse_qsl(parts.query, keep_blank_values=True)
    kept = [(k, v) for k, v in params if k not in drop]
    if len(kept) == len(params):
        # No-op filter lists must not change the task identity: a re-encode
        # can alter equivalent encodings (%20 vs +) and split the task key.
        return url
    return urlunsplit(parts._replace(query=urlencode(kept)))


def task_id(
    url: str,
    *,
    filters: tuple[str, ...] | list[str] = (),
    tag: str = "",
    application: str = "",
    digest: str = "",
    piece_range: str = "",
) -> str:
    """Content-addressed task ID: sha256 over the filtered URL + meta."""
    h = hashlib.sha256()
    h.update(filter_query(url, filters).encode())
    for part in (tag, application, digest, piece_range):
        h.update(b"\x00")
        h.update(part.encode())
    return h.hexdigest()


def persistent_cache_task_id(
    content_digest: str, tag: str = "", application: str = "", piece_size: int = 0
) -> str:
    """Task ID for imported cache objects, keyed by content digest not URL.

    piece_size is part of the identity: the id alone determines the task's
    piece geometry cluster-wide, so two publishers of identical bytes with
    different piece sizes must land on DIFFERENT tasks — merging them would
    hand children one index-keyed digest map spanning two geometries."""
    h = hashlib.sha256()
    h.update(content_digest.encode())
    h.update(b"\x00")
    h.update(tag.encode())
    h.update(b"\x00")
    h.update(application.encode())
    h.update(b"\x00")
    h.update(str(piece_size).encode())
    return h.hexdigest()


def host_id(hostname: str, port: int | None = None) -> str:
    """Stable host identity (reference pkg/idgen/host_id.go)."""
    if port is None:
        return hostname
    return f"{hostname}-{port}"


def peer_id(ip: str | None = None, hostname: str | None = None, *, seed: bool = False) -> str:
    """Unique per-attempt peer ID: ip-hostname-random[(_seed)]."""
    ip = ip or local_ip()
    hostname = hostname or socket.gethostname()
    rand = os.urandom(8).hex()
    suffix = _SEED_PEER_SUFFIX if seed else ""
    return f"{ip}-{hostname}-{rand}{suffix}"


def is_seed_peer_id(pid: str) -> bool:
    return pid.endswith(_SEED_PEER_SUFFIX)


def local_ip() -> str:
    """Best-effort non-loopback IP; falls back to 127.0.0.1 (offline-safe)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # no packet is actually sent
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
