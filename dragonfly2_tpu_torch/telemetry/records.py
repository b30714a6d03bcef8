"""Telemetry record schemas: one row per (child, parent) transfer and one
per (src, dst) probe.

The port's own copy of the two dtypes of dragonfly2_tpu/telemetry/records.py,
byte for byte the same (the tests hold them to that), so that records one
package writes the other reads. Record shapes mirror the reference's Download
and NetworkTopology CSVs (scheduler/storage/types.go:26-235) but normalized:
each transfer and each probe is its own row, the layout that pair batches and
edge lists are built from without unflattening. ``ColumnarStore`` and
``TelemetryStorage`` are the scheduler side's rotating stores of them, copied
too (plus ``ColumnarStore.extend``, a bulk append): rows buffer in a
preallocated structured array and rotate into ``<dir>/<prefix>-<seq>.npz``
files that either package reads.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

_ID_LEN = 64  # sha256 hex task ids; peer/host ids truncated to fit

DOWNLOAD_DTYPE = np.dtype(
    [
        ("task_id", f"S{_ID_LEN}"),
        ("child_peer_id", f"S{_ID_LEN}"),
        ("parent_peer_id", f"S{_ID_LEN}"),
        ("child_host_id", f"S{_ID_LEN}"),
        ("parent_host_id", f"S{_ID_LEN}"),
        ("piece_count", "i4"),
        ("piece_size", "i8"),
        ("content_length", "i8"),
        ("bandwidth_bps", "f4"),  # observed child<-parent throughput
        ("piece_cost_ms_mean", "f4"),
        ("success", "?"),
        ("back_to_source", "?"),
        ("pair_features", "f4", (16,)),  # models.features.FEATURE_NAMES order
        ("created_at", "f8"),
    ]
)

PROBE_DTYPE = np.dtype(
    [
        ("src_host_id", f"S{_ID_LEN}"),
        ("dst_host_id", f"S{_ID_LEN}"),
        ("rtt_mean_ms", "f4"),
        ("rtt_std_ms", "f4"),
        ("rtt_min_ms", "f4"),
        ("probe_count", "i4"),
        ("created_at", "f8"),
    ]
)


class ColumnarStore:
    """Append-only structured-array store with rotation.

    Rows buffer in a preallocated numpy array; at `rotate_rows` the buffer
    flushes to `<dir>/<prefix>-<seq>.npz` and at most `max_backups` files are
    kept (ref storage.go rotation: maxSize/maxBackups).
    """

    def __init__(
        self,
        directory: str | Path,
        prefix: str,
        dtype: np.dtype,
        *,
        rotate_rows: int = 65536,
        max_backups: int = 10,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self.dtype = dtype
        self.rotate_rows = rotate_rows
        self.max_backups = max_backups
        self._buf = np.zeros(rotate_rows, dtype=dtype)
        self._n = 0
        self._seq = self._next_seq()

    def _next_seq(self) -> int:
        seqs = [int(p.stem.rsplit("-", 1)[1]) for p in self._files()]
        return (max(seqs) + 1) if seqs else 0

    def _files(self) -> list[Path]:
        out = []
        for p in self.dir.glob(f"{self.prefix}-*.npz"):
            try:
                int(p.stem.rsplit("-", 1)[1])
                out.append(p)
            except (ValueError, IndexError):
                continue
        return sorted(out, key=lambda p: int(p.stem.rsplit("-", 1)[1]))

    def append(self, **fields) -> None:
        row = self._buf[self._n]
        for k, v in fields.items():
            row[k] = v
        if "created_at" in self.dtype.names and "created_at" not in fields:
            row["created_at"] = time.time()
        self._n += 1
        if self._n >= self.rotate_rows:
            self.flush()

    def extend(self, records: np.ndarray) -> None:
        """Append many rows at once (the port's bulk form of append; the
        rows carry their own created_at): they fill the buffer and rotate
        exactly as one append per row would."""
        records = np.asarray(records, dtype=self.dtype)
        i = 0
        while i < len(records):
            take = min(self.rotate_rows - self._n, len(records) - i)
            self._buf[self._n : self._n + take] = records[i : i + take]
            self._n += take
            i += take
            if self._n >= self.rotate_rows:
                self.flush()

    def flush(self, *, prune: bool = True) -> Path | None:
        if self._n == 0:
            return None
        path = self.dir / f"{self.prefix}-{self._seq}.npz"
        np.savez_compressed(path, records=self._buf[: self._n].copy())
        self._seq += 1
        self._n = 0
        if prune:
            files = self._files()
            for old in files[: max(0, len(files) - self.max_backups)]:
                old.unlink(missing_ok=True)
        return path

    def load_all(self, *, include_buffer: bool = True) -> np.ndarray:
        """All persisted (+ buffered) records, oldest first."""
        parts = [np.load(p)["records"] for p in self._files()]
        if include_buffer and self._n:
            parts.append(self._buf[: self._n].copy())
        if not parts:
            return np.zeros(0, dtype=self.dtype)
        return np.concatenate(parts)

    def snapshot(self) -> tuple[np.ndarray, tuple[Path, ...]]:
        """Consistent upload cut: flush the buffer, then return (records,
        files) for exactly the rows present NOW. Rows appended afterwards
        land in the fresh buffer / later files and are untouched by a
        subsequent discard(files) — the clear-after-upload path that used to
        silently drop anything appended while the upload's RPCs were in
        flight. The cut flush skips max_backups pruning: at the cap, a
        pruning flush would delete the oldest unuploaded file an instant
        before the cut reads it; the upload's own discard() is what brings
        the file count back down."""
        self.flush(prune=False)
        files = tuple(self._files())
        return self.load_all(include_buffer=False), files

    def discard(self, files: tuple[Path, ...]) -> None:
        """Drop exactly the files a snapshot() returned (handed off upstream)."""
        for p in files:
            Path(p).unlink(missing_ok=True)

    def clear(self) -> None:
        for p in self._files():
            p.unlink(missing_ok=True)
        self._n = 0
        self._seq = 0

    def __len__(self) -> int:
        return sum(len(np.load(p)["records"]) for p in self._files()) + self._n


class TelemetryStorage:
    """Download + probe stores under one dir (ref scheduler/storage.Storage)."""

    def __init__(self, directory: str | Path, **kw):
        self.downloads = ColumnarStore(directory, "download", DOWNLOAD_DTYPE, **kw)
        self.probes = ColumnarStore(directory, "networktopology", PROBE_DTYPE, **kw)

    def flush(self) -> None:
        self.downloads.flush()
        self.probes.flush()

    def clear(self) -> None:
        self.downloads.clear()
        self.probes.clear()
