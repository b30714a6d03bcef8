"""Piece store on disk: the port of dragonfly2_tpu/daemon/storage.py (the
same on-disk task layout and metadata JSON, so either package's daemon
recovers a store the other wrote).

Parity with reference client/daemon/storage (storage_manager.go:51-108,
local_storage.go, metadata.go): per-task data file + JSON metadata, piece
write/read with digest validation, completed/partial task reuse lookup, and
GC reclaim. Single sparse data file per task (pieces written at their offset)
instead of the reference's driver split; piece state is a bitset in metadata.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path

from dragonfly2_tpu_torch.resilience import faultline
from dragonfly2_tpu_torch.utils import digest as digestlib
from dragonfly2_tpu_torch.utils.bitset import Bitset
from dragonfly2_tpu_torch.utils.pieces import Range, piece_range

logger = logging.getLogger(__name__)


@dataclass
class TaskMetadata:
    task_id: str
    url: str = ""
    content_length: int = -1
    piece_size: int = 0
    total_pieces: int = -1
    digest: str = ""
    tag: str = ""
    application: str = ""
    finished_pieces: int = 0  # bitset int
    piece_digests: dict[str, str] = field(default_factory=dict)  # index -> sha256 hex
    done: bool = False
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)


class OncePinRelease:
    """Release a TaskStorage operation pin exactly once, from whichever of
    several release paths fires first (a normal completion, an error path, or
    a GC finalizer for handles abandoned before use)."""

    __slots__ = ("_ts", "_released")

    def __init__(self, ts: "TaskStorage"):
        self._ts = ts
        self._released = False

    def __call__(self) -> None:
        if not self._released:
            self._released = True
            self._ts.unpin()


class TaskStorage:
    """One task's on-disk state: <dir>/<task_id>/{data,metadata.json}."""

    def __init__(self, root: Path, meta: TaskMetadata):
        self.dir = root / meta.task_id
        self.dir.mkdir(parents=True, exist_ok=True)
        self.data_path = self.dir / "data"
        self.meta = meta
        self._bitset = Bitset(meta.finished_pieces)
        self._lock = asyncio.Lock()
        self._progress = asyncio.Event()  # replaced on every notify
        # Reclaim protection: `pins` counts live users (a running conductor,
        # an in-flight serving read) — reclaim never deletes a pinned task.
        # `last_access` tracks READS in memory (writes refresh
        # meta.updated_at; a popular seed task that only serves would
        # otherwise look idle and be evicted first).
        self.pins = 0
        # From updated_at, NOT now(): tasks restored from disk at daemon boot
        # must keep their real age, or a daily-restarted daemon never
        # TTL-evicts and its LRU order resets to arbitrary on every boot.
        self.last_access = meta.updated_at
        self._inflight: dict[int, asyncio.Future] = {}  # piece index -> writer
        # In-memory change counter for push-style piece announcements: child
        # peers long-poll "metadata changed past version N" instead of
        # re-fetching on a timer (ref peertask_piecetask_synchronizer.go
        # bidi SyncPieceTasks push). Not persisted: restarts reset it, and
        # long-pollers simply observe a fresh counter on reconnect.
        self.version = 0
        # Metadata persistence is DEBOUNCED on the piece-write hot path: a
        # JSON snapshot + atomic rename per piece costs a disk round-trip per
        # piece (the reference measured ~45 ms a rename on a slow overlayfs,
        # the top cost of its checkpoint fan-out). The in-memory bitset is authoritative
        # during a download; a crash loses at most the last flush window of
        # piece bits, which the next run simply re-fetches (the reference's
        # metadata writes are asynchronous for the same reason).
        self._meta_dirty = False
        self._meta_flushed_count = self._bitset.count()
        self._meta_flushed_at = time.monotonic()
        if not self.data_path.exists():
            self.data_path.touch()

    def _notify_progress(self) -> None:
        """Wake stream readers: a piece landed or metadata changed."""
        self.version += 1
        ev, self._progress = self._progress, asyncio.Event()
        ev.set()

    async def wait_version(self, since: int, timeout: float) -> int:
        """Block until the task state has changed past `since` (or timeout);
        returns the current version either way."""
        if since > self.version:
            # Caller saw a previous incarnation's (larger) counter — the
            # process restarted and reset it. Answer immediately so the
            # long-poller resynchronizes instead of stalling a full window.
            return self.version
        deadline = time.monotonic() + timeout
        while self.version <= since:
            ev = self._progress  # capture BEFORE re-check to not miss a notify
            if self.version > since:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                break
        return self.version

    # ---- metadata ----

    # flush cadence for debounced piece-write metadata persistence
    _META_FLUSH_PIECES = 16
    _META_FLUSH_S = 1.0

    def save_metadata(self) -> None:
        if faultline.ACTIVE is not None:
            # `storage.meta`: injected metadata-flush errors/latency — makes
            # the debounced-metadata loss window (pieces landed but not yet
            # flushed at crash time) exercisable deterministically instead of
            # only by kill timing. Errors propagate like a real disk failure.
            faultline.ACTIVE.check("storage.meta", blocking_latency=True)
        self.meta.finished_pieces = self._bitset.to_int()
        self.meta.updated_at = time.time()
        tmp = self.dir / "metadata.json.tmp"
        tmp.write_text(json.dumps(asdict(self.meta)))
        tmp.replace(self.dir / "metadata.json")
        # sync method on the loop thread: the flag flip cannot interleave with
        # the locked writer path (which sets it True between awaits)
        self._meta_dirty = False  # dflint: disable=DF023 sync path, no await in this method
        self._meta_flushed_count = self._bitset.count()
        self._meta_flushed_at = time.monotonic()

    def _metadata_flush_due(self) -> bool:
        """Persist when the task completes, every _META_FLUSH_PIECES pieces,
        or once the flush window has elapsed — not on every piece."""
        return (
            self.is_complete()
            or self._bitset.count() - self._meta_flushed_count >= self._META_FLUSH_PIECES
            or time.monotonic() - self._meta_flushed_at >= self._META_FLUSH_S
        )

    def set_task_info(
        self, *, content_length: int, piece_size: int, total_pieces: int, digest: str = ""
    ) -> None:
        self.meta.content_length = content_length
        self.meta.piece_size = piece_size
        self.meta.total_pieces = total_pieces
        if digest:
            self.meta.digest = digest
        # Preallocate so piece writes at any offset land in a right-sized file.
        with open(self.data_path, "r+b") as f:
            f.truncate(content_length)
        self.save_metadata()
        self._notify_progress()

    # ---- pieces ----

    @property
    def finished(self) -> Bitset:
        return self._bitset

    def has_piece(self, index: int) -> bool:
        return self._bitset.test(index)

    def finished_count(self) -> int:
        return self._bitset.count()

    def is_complete(self) -> bool:
        total = self.meta.total_pieces
        return total >= 0 and self._bitset.count() == total

    # pieces below this hash/write inline; larger ones offload so a 4 MiB
    # sha256 + disk write never stalls every other transfer on the
    # event loop (hashlib releases the GIL for large buffers, so worker
    # threads truly parallelize on multi-core hosts)
    _INLINE_HASH_BYTES = 256 << 10

    async def write_piece(self, index: int, data: bytes, *, expected_digest: str = "") -> str:
        """Write one piece at its offset; returns the piece sha256 hex.

        The data write runs OUTSIDE the metadata lock: pieces target disjoint
        offsets and only become visible when the bitset bit is set, so
        concurrent piece writers genuinely parallelize. Duplicate writers for
        the SAME index (p2p/back-source overlap) are serialized by an
        in-flight future so racing writes can never interleave bytes."""
        r = self._piece_write_range(index, len(data))
        offload = len(data) > self._INLINE_HASH_BYTES
        if offload:
            d = await asyncio.to_thread(digestlib.sha256_bytes, data)
        else:
            d = digestlib.sha256_bytes(data)
        if expected_digest and d != expected_digest:
            raise digestlib.InvalidDigestError(
                f"piece {index} digest mismatch: {d[:12]} != {expected_digest[:12]}"
            )
        return await self._land_piece(index, data, d, r, offload)

    async def write_piece_view(
        self, index: int, data: "bytes | bytearray | memoryview", *, digest: str
    ) -> str:
        """Land a piece whose sha256 the caller already computed — the
        hash-on-receive pipeline (daemon/pipeline.py HashPump digests the
        bytes AS they arrive off the socket, so the second full hash pass of
        write_piece is gone). `data` is typically a memoryview into a pooled
        buffer: the file write happens directly from it, no copy. The caller
        must keep the buffer untouched until this returns (the conductor's
        _write_fetched_piece releases it back to the pool afterwards), and
        must have verified `digest` against the expected one itself."""
        r = self._piece_write_range(index, len(data))
        return await self._land_piece(
            index, data, digest, r, len(data) > self._INLINE_HASH_BYTES
        )

    def _piece_write_range(self, index: int, nbytes: int) -> Range:
        if self.meta.piece_size <= 0:
            raise ValueError("task info not set before write_piece")
        r = piece_range(index, self.meta.piece_size, self.meta.content_length)
        if nbytes != r.length:
            raise ValueError(f"piece {index}: got {nbytes} bytes, want {r.length}")
        return r

    async def _land_piece(
        self, index: int, data, d: str, r: Range, offload: bool
    ) -> str:
        """Dedup racing writers, write the (already-validated) bytes at their
        offset, flip the bitset bit, debounce-persist metadata."""
        if faultline.ACTIVE is not None:
            # `storage.write`: injected disk latency / write errors — the
            # piece-worker re-enqueue path must absorb these
            await faultline.ACTIVE.fire("storage.write")
        while True:
            if self._bitset.test(index):
                return d  # duplicate download of a finished piece
            racing = self._inflight.get(index)
            if racing is None:
                break  # this writer becomes the primary
            try:
                await racing  # another writer is landing this exact piece
                return d
            except BaseException:
                if not racing.done():
                    raise  # our own cancellation, not the primary's failure
                # The primary failed/was cancelled — but this writer holds
                # its own digest-verified bytes: loop to take over the write
                # (or wait on whichever duplicate claimed primary first)
                continue

        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._inflight[index] = fut

        def _write() -> None:
            with open(self.data_path, "r+b") as f:
                f.seek(r.start)
                f.write(data)

        try:
            if offload:
                await asyncio.to_thread(_write)
            else:
                _write()
            async with self._lock:  # metadata-only critical section
                if self._bitset.set(index):
                    self.meta.piece_digests[str(index)] = d
                    self._meta_dirty = True
                    if self._metadata_flush_due():
                        if offload and len(self.meta.piece_digests) > 64:
                            # the JSON snapshot grows O(pieces); keep big ones
                            # off the loop too (lock still held: serializes
                            # writers' metadata updates, not their data writes)
                            await asyncio.to_thread(self.save_metadata)
                        else:
                            self.save_metadata()
        except BaseException as exc:
            # Duplicate writers awaiting the in-flight future must see the
            # primary's failure — resolving with success here would make them
            # report a piece as landed whose bitset bit was never set, feeding
            # false piece successes into scheduler telemetry.
            if not fut.done():
                fut.set_exception(IOError(f"piece {index} primary writer failed: {exc!r}"))
                fut.exception()  # mark retrieved: there may be no waiter
            raise
        finally:
            self._inflight.pop(index, None)
            if not fut.done():
                fut.set_result(None)
        self._notify_progress()
        return d

    async def read_piece(self, index: int) -> bytes:
        if not self.has_piece(index):
            raise KeyError(f"piece {index} not present")
        r = piece_range(index, self.meta.piece_size, self.meta.content_length)
        return await self.read_range(r)

    async def read_range(self, r: Range) -> bytes:
        # Lock-free: callers only read pieces the bitset says are finished,
        # and finished bytes are immutable — concurrent writers touch other
        # offsets. (Serving reads behind a per-task lock would serialize a
        # seed peer's whole fan-out.)
        self.last_access = time.time()
        self.pins += 1  # a concurrent (threaded) reclaim must not rmtree us mid-read
        try:
            if r.length > TaskStorage._INLINE_HASH_BYTES:
                def _read() -> bytes:
                    with open(self.data_path, "rb") as f:
                        f.seek(r.start)
                        return f.read(r.length)

                return await asyncio.to_thread(_read)
            with open(self.data_path, "rb") as f:
                f.seek(r.start)
                return f.read(r.length)
        finally:
            self.pins -= 1

    async def export_range(self, dest: str | Path, r: Range) -> None:
        """Stream a byte range of the completed task to a file (the dfget
        --range path; ref client/dfget ranged download — here served from the
        piece store so later ranged fetches of a cached task cost nothing)."""
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        # unlink FIRST (as export_to does): dest may be a hard link to this
        # task's own data file from a prior full export — open("wb") would
        # truncate the shared inode and zero the cached task in the store
        dest.unlink(missing_ok=True)
        self.last_access = time.time()
        self.pins += 1
        try:
            def _copy() -> None:
                with open(self.data_path, "rb") as src, open(dest, "wb") as out:
                    src.seek(r.start)
                    remaining = r.length
                    while remaining > 0:
                        chunk = src.read(min(1 << 20, remaining))
                        if not chunk:
                            raise IOError(
                                f"range {r.start}+{r.length} past end of task data"
                            )
                        out.write(chunk)
                        remaining -= len(chunk)

            await asyncio.to_thread(_copy)
        finally:
            self.pins -= 1

    def flush_metadata(self) -> None:
        """Persist any debounced piece-write metadata (shutdown path)."""
        if self._meta_dirty:
            self.save_metadata()

    def pin(self) -> None:
        """Mark a live user (running conductor); pair with unpin()."""
        self.pins += 1

    def unpin(self) -> None:
        self.pins = max(0, self.pins - 1)

    def mark_done(self) -> None:
        self.meta.done = True
        self.save_metadata()
        self._notify_progress()

    async def stream_ordered(self, *, watch: "asyncio.Future | None" = None):
        """Yield piece bytes in index order as they arrive (the daemon's
        StartStreamTask shape, ref peertask_manager.go:52): piece i is yielded
        as soon as it is finished locally, so a proxy/stream consumer sees
        first bytes before the tail of the file lands. `watch` is an optional
        producer future (the conductor): if it fails, the stream raises
        instead of hanging."""
        idx = 0
        while True:
            if self.meta.total_pieces >= 0 and idx >= self.meta.total_pieces:
                return
            if self.meta.total_pieces >= 0 and self.has_piece(idx):
                yield await self.read_piece(idx)
                idx += 1
                continue
            ev = self._progress  # capture BEFORE re-check to not miss a notify
            if self.meta.total_pieces >= 0 and self.has_piece(idx):
                continue
            if watch is not None and watch.done():
                watch.result()  # raises the producer's error
                if self.meta.total_pieces >= 0 and self.has_piece(idx):
                    continue
                raise IOError(f"producer finished but piece {idx} never arrived")
            try:
                await asyncio.wait_for(ev.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass  # periodic re-check (covers producer death + lost wakeups)

    def verify_recovered_pieces(self) -> tuple[int, list[int]]:
        """Crash-recovery audit of the finished-piece bitset (sync — the boot
        path runs it on a worker thread before the upload server opens).

        The debounced-metadata design makes two crash windows possible:
        pieces written but not yet flushed (bits LOST — they simply refetch,
        never double-count), and — on a machine crash, where the metadata
        rename can reach disk while data blocks don't — bits CLAIMED over
        torn/zeroed data. This audit closes the second window: every claimed
        piece of an incomplete task is digest-verified against its recorded
        piece digest; a piece that is out of the data file's actual bounds,
        has no recorded digest, or fails its hash is dropped from the bitset
        so it refetches instead of being served or counted.

        Done tasks take a length-only fast path: completion always flushed
        metadata AFTER the last data write, and the reuse path's full verify()
        still guards serving — re-hashing every seed task at boot would make
        daemon restarts O(store size). A done task whose data length is wrong
        is demoted to the full per-piece audit.

        Returns (kept_count, dropped_indices); metadata is re-persisted when
        anything was dropped (done is cleared if the task is no longer
        complete)."""
        m = self.meta
        if m.total_pieces is None or m.total_pieces < 0 or m.piece_size <= 0:
            return self._bitset.count(), []
        try:
            actual = self.data_path.stat().st_size
        except OSError:
            actual = 0
        if m.done and actual == m.content_length:
            return self._bitset.count(), []
        import hashlib

        dropped: list[int] = []
        with open(self.data_path, "rb") as f:
            for idx in sorted(self._bitset.indices()):
                r = piece_range(idx, m.piece_size, m.content_length)
                expected = m.piece_digests.get(str(idx), "")
                ok = bool(expected) and r.start + r.length <= actual
                if ok:
                    f.seek(r.start)
                    h = hashlib.sha256()
                    remaining = r.length
                    while remaining > 0:
                        chunk = f.read(min(1 << 20, remaining))
                        if not chunk:
                            ok = False
                            break
                        h.update(chunk)
                        remaining -= len(chunk)
                    ok = ok and h.hexdigest() == expected
                if not ok:
                    dropped.append(idx)
        if dropped:
            for idx in dropped:
                self._bitset.clear(idx)
                m.piece_digests.pop(str(idx), None)
            m.done = m.done and self.is_complete()
            self.save_metadata()
        return self._bitset.count(), dropped

    def verify(self) -> bool:
        """Full-content digest check against task digest (if known)."""
        if not self.meta.digest:
            return True
        try:
            want = digestlib.parse(self.meta.digest)
        except digestlib.InvalidDigestError:
            return False
        with open(self.data_path, "rb") as f:
            got = digestlib.compute_file(want.algorithm, f)
        return got.encoded == want.encoded

    async def export_to(self, dest: str | Path) -> None:
        """Hard-link when possible, else copy (ref storage.Store to named file)."""
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.unlink(missing_ok=True)
        self.last_access = time.time()
        self.pins += 1  # a threaded reclaim must not rmtree us mid-export
        try:
            os.link(self.data_path, dest)
        except OSError:
            import shutil

            await asyncio.to_thread(shutil.copyfile, self.data_path, dest)
        finally:
            self.pins -= 1


class StorageManager:
    """All task stores under a root dir (ref storage_manager.go Manager)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._tasks: dict[str, TaskStorage] = {}
        self._load_existing()

    def _load_existing(self) -> None:
        # Crash leftovers first: a metadata.json.tmp with no metadata.json is
        # a crash between the tmp write and the atomic replace — promote it
        # when it parses (it IS the newest durable snapshot); with a final
        # file present the replace completed and the tmp is stale garbage.
        for tmp in self.root.glob("*/metadata.json.tmp"):
            final = tmp.with_name("metadata.json")
            try:
                if final.exists():
                    tmp.unlink(missing_ok=True)
                    continue
                json.loads(tmp.read_text())  # promote only a parseable snapshot
                tmp.replace(final)
            except (json.JSONDecodeError, OSError, UnicodeDecodeError):
                logger.warning("discarding unusable crash leftover %s", tmp)
                tmp.unlink(missing_ok=True)
        for meta_path in self.root.glob("*/metadata.json"):
            try:
                meta = TaskMetadata(**json.loads(meta_path.read_text()))
                self._tasks[meta.task_id] = TaskStorage(self.root, meta)
            except (json.JSONDecodeError, TypeError, ValueError, KeyError,
                    AttributeError, OSError, UnicodeDecodeError):
                # corrupt/truncated metadata (or wrong-typed fields blowing up
                # TaskStorage init): quarantine rather than retry every boot —
                # the rename keeps the evidence, stops this dir from loading,
                # and lets a future register_task start the task over fresh
                logger.warning("quarantining corrupt task metadata %s", meta_path)
                try:
                    meta_path.replace(meta_path.with_name("metadata.json.corrupt"))
                except OSError:
                    logger.warning("quarantine rename failed for %s", meta_path)
                continue

    def recover(self) -> list[tuple[TaskStorage, int, list[int]]]:
        """Audit every restored task's finished-piece bitset against its
        on-disk bytes (TaskStorage.verify_recovered_pieces) — the boot-time
        half of crash-safe restarts. Sync and disk-heavy: the engine runs it
        on a worker thread BEFORE the upload server opens, so a claimed-but-
        torn piece is never servable, even briefly. Returns
        [(task, kept_count, dropped_indices)] for every audited task —
        including kept == 0 (fully torn), so the engine's drop accounting
        sees the worst-damage case too; it only re-announces kept > 0."""
        out: list[tuple[TaskStorage, int, list[int]]] = []
        for ts in list(self._tasks.values()):
            try:
                kept, dropped = ts.verify_recovered_pieces()
            except OSError as e:
                # data file unreadable: quarantine (unload + stop reloading)
                # without deleting bytes — an operator can still inspect them
                logger.warning(
                    "recovery audit of task %s failed (%r): quarantining",
                    ts.meta.task_id[:12], e,
                )
                self._tasks.pop(ts.meta.task_id, None)
                try:
                    (ts.dir / "metadata.json").replace(ts.dir / "metadata.json.corrupt")
                except OSError:
                    logger.warning("quarantine rename failed for %s", ts.dir)
                continue
            if dropped:
                logger.warning(
                    "task %s: dropped %d torn/unverifiable piece(s) at recovery",
                    ts.meta.task_id[:12], len(dropped),
                )
            if kept > 0 or dropped:
                out.append((ts, kept, dropped))
        return out

    def register_task(self, task_id: str, **meta_kw) -> TaskStorage:
        ts = self._tasks.get(task_id)
        if ts is None:
            ts = TaskStorage(self.root, TaskMetadata(task_id=task_id, **meta_kw))
            ts.save_metadata()
            self._tasks[task_id] = ts
        return ts

    def get(self, task_id: str) -> TaskStorage | None:
        return self._tasks.get(task_id)

    def find_completed_task(self, task_id: str) -> TaskStorage | None:
        """Reuse fast path (ref FindCompletedTask, storage_manager.go:100-105)."""
        ts = self._tasks.get(task_id)
        if ts is not None and ts.meta.done and ts.is_complete():
            ts.last_access = time.time()  # reuse counts as use for LRU
            return ts
        return None

    def find_partial_task(self, task_id: str) -> TaskStorage | None:
        ts = self._tasks.get(task_id)
        return ts if ts is not None and ts.finished_count() > 0 else None

    def delete_task(self, task_id: str) -> None:
        ts = self._tasks.pop(task_id, None)
        if ts is not None:
            import shutil

            shutil.rmtree(ts.dir, ignore_errors=True)

    def tasks(self) -> list[TaskStorage]:
        return list(self._tasks.values())

    def flush_all(self) -> None:
        """Persist every task's debounced metadata (daemon shutdown)."""
        for ts in self._tasks.values():
            ts.flush_metadata()

    def reclaim(
        self,
        *,
        ttl: float = 24 * 3600,
        capacity_bytes: int | None = None,
        capacity_low_ratio: float = 0.8,
        disk_high_ratio: float | None = None,
        disk_low_ratio: float | None = None,
    ) -> dict[str, int]:
        """TTL + capacity reclaim (ref Reclaimer iface storage_manager.go:106,
        CleanUp :912, and the diskGCThreshold/diskGCThresholdPercent configs).

        Two triggers beyond the idle-TTL sweep:
          capacity_bytes   — store-size budget: evict when total stored bytes
                             exceed it, down to capacity_low_ratio of it
          disk_high_ratio  — whole-filesystem watermark: evict when the disk
                             holding the store passes it, down to
                             disk_low_ratio (defaults to the high mark)
        Eviction is LRU over COMPLETE tasks by last write OR serving read
        (a popular seed task that only serves must rank hot, not idle);
        PINNED tasks — a running conductor, an in-flight read — are immune
        in BOTH sweeps, so neither trigger ever deletes a live transfer.
        Returns removal counts by trigger.
        """
        now = time.time()

        def last_used(ts: TaskStorage) -> float:
            return max(ts.meta.updated_at, ts.last_access)

        removed_ttl = 0
        for tid, ts in list(self._tasks.items()):
            if ts.pins <= 0 and now - last_used(ts) > ttl:
                self.delete_task(tid)
                removed_ttl += 1

        to_free = 0.0
        total = self.total_bytes()
        if capacity_bytes is not None and total > capacity_bytes:
            to_free = max(to_free, total - capacity_bytes * capacity_low_ratio)
        if disk_high_ratio is not None:
            import shutil

            du = shutil.disk_usage(self.root)
            if du.used / du.total > disk_high_ratio:
                low = disk_low_ratio if disk_low_ratio is not None else disk_high_ratio
                to_free = max(to_free, du.used - low * du.total)

        removed_capacity = 0
        if to_free > 0:
            complete_lru = sorted(
                (ts for ts in self._tasks.values() if ts.meta.done and ts.pins <= 0),
                key=last_used,
            )
            for ts in complete_lru:
                size = ts.data_path.stat().st_size if ts.data_path.exists() else 0
                self.delete_task(ts.meta.task_id)
                removed_capacity += 1
                to_free -= size
                if to_free <= 0:
                    break
        return {"ttl": removed_ttl, "capacity": removed_capacity}

    def total_bytes(self) -> int:
        return sum(
            ts.data_path.stat().st_size for ts in self._tasks.values() if ts.data_path.exists()
        )
