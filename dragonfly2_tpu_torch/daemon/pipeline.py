"""Zero-copy piece-transfer pipeline: pooled buffers + hash-on-receive (the
port of dragonfly2_tpu/daemon/pipeline.py).

The reference's benchmark, on its CPU image, put the checkpoint fan-out path
at ~2.3 ns per payload byte of SERIAL single-core CPU: socket recv (~1.1
ns/B) into a freshly allocated bytearray, a second full pass for sha256
validation (~0.9 ns/B) on a cold buffer, then the store write (~0.3 ns/B) —
plus one heap allocation per piece. This module removes the allocation and
overlaps the stages across cores, the same discipline that keeps input
pipelines feeding accelerators (prefetch + host/device overlap):

  BufferPool     size-bucketed reusable bytearrays: a piece fetch borrows a
                 buffer and the store write returns it, so steady-state
                 transfers allocate nothing. The per-bucket outstanding
                 bound doubles as BACKPRESSURE — when writer threads fall
                 behind, acquire() parks the recv side instead of letting
                 filled buffers pile up unbounded.
  HashPump       incremental sha256 fed from the buffer AS recv_into fills
                 it. Updates run on the pipeline's hash thread (hashlib
                 releases the GIL for buffers > 2 KiB), so recv on the event
                 loop and hashing genuinely run on two cores; by the time
                 the last chunk lands, all but the tail of the piece is
                 already hashed — the second full pass is gone.
  PiecePipeline  the shared facade an engine threads through its conductors
                 (like the shared RawRangeClient): one pool + one hash
                 executor per daemon process.

The third overlap stage — handing a filled buffer to a writer thread and
immediately recycling a fresh buffer into recv — lives in the conductor
(_spawn_piece_write), because it needs the piece-worker loop; storage's
write_piece_view is the no-copy, no-rehash landing half.

dflint expectations for code touching pooled buffers: the pool's sync
methods run on the event-loop thread only (no locks needed — keep it that
way); buffers handed to worker threads (hash updates, store writes) are
READ-ONLY there, and a buffer is released back to the pool only after every
reader of it has finished or been abandoned (an abandoned HashPump may still
read a recycled buffer — harmless, its digest is discarded).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import queue
import threading
from typing import Optional

logger = logging.getLogger(__name__)

# Smallest pooled buffer: requests below this share the 64 KiB bucket (the
# raw fetch path only engages at 256 KiB anyway). Largest: MAX_PIECE_SIZE —
# anything bigger is served unpooled rather than pinning >64 MiB per slot.
MIN_BUCKET = 64 << 10
MAX_BUCKET = 64 << 20

# hash-on-receive geometry: pieces at/below the inline threshold are hashed
# in one pass at finish() (a thread round-trip costs more than the hash);
# larger pieces hand one accumulated chunk at a time to the drain worker —
# 1 MiB amortizes the queue/GIL hand-off without delaying overlap much
INLINE_HASH_BYTES = 256 << 10
HASH_CHUNK_BYTES = 1 << 20


def bucket_size(length: int) -> int:
    """Bucket for a request: next power of two >= max(length, MIN_BUCKET)."""
    size = MIN_BUCKET
    while size < length:
        size <<= 1
    return size


class PooledBuffer:
    """A leased buffer: `view` is a memoryview of EXACTLY the requested
    length (never the full bucket — consumers cannot read a previous piece's
    stale tail past it). release() is idempotent; error paths and finally
    blocks may both call it."""

    __slots__ = ("view", "_pool", "_buf", "_bucket", "_released")

    def __init__(self, pool: "BufferPool", buf: bytearray, bucket: int, length: int):
        self._pool = pool
        self._buf = buf
        self._bucket = bucket
        self.view = memoryview(buf)[:length]
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        # The exported memoryview is NOT .release()d: an aborted pump's
        # queued hash jobs slice this exact view object on the shard thread,
        # and slicing a released view raises — which would kill the shard.
        # The view (and its bytearray) are reclaimed by GC with the lease.
        self._pool._checkin(self._bucket, self._buf)


class BufferPool:
    """Size-bucketed reusable bytearray pool with per-bucket backpressure.

    All methods run on the event-loop thread (single-threaded asyncio — no
    locking); the semaphores are created lazily inside acquire() so they
    bind to the running loop (dflint DF021 discipline).

    Knobs:
      max_idle_per_bucket  buffers RETAINED per bucket when idle (memory cap:
                           idle retention is at most
                           sum(bucket_size * max_idle) over live buckets)
      max_outstanding_per_bucket  leases in flight per bucket before
                           acquire() parks — the pipeline's backpressure:
                           recv stops borrowing when hash/write stages still
                           hold this many buffers
    """

    def __init__(
        self,
        *,
        max_idle_per_bucket: int = 8,
        max_outstanding_per_bucket: int = 32,
    ):
        self._idle: dict[int, list[bytearray]] = {}
        self._sems: dict[int, asyncio.Semaphore] = {}
        self._max_idle = max_idle_per_bucket
        self._max_outstanding = max_outstanding_per_bucket
        self.hits = 0
        self.misses = 0

    async def acquire(self, length: int) -> PooledBuffer:
        if length > MAX_BUCKET:
            # oversized one-off: plain allocation, no pooling, no slot held
            self.misses += 1
            return PooledBuffer(self, bytearray(length), -1, length)
        bucket = bucket_size(length)
        sem = self._sems.get(bucket)
        if sem is None:
            sem = self._sems[bucket] = asyncio.Semaphore(self._max_outstanding)
        await sem.acquire()  # backpressure: parks when the bucket is maxed out
        idle = self._idle.get(bucket)
        if idle:
            self.hits += 1
            return PooledBuffer(self, idle.pop(), bucket, length)
        self.misses += 1
        return PooledBuffer(self, bytearray(bucket), bucket, length)

    def _checkin(self, bucket: int, buf: bytearray) -> None:
        if bucket < 0:
            return  # oversized one-off was never pooled
        idle = self._idle.setdefault(bucket, [])
        if len(idle) < self._max_idle:
            idle.append(buf)
        sem = self._sems.get(bucket)
        if sem is not None:
            sem.release()

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "idle_bytes": sum(b * len(v) for b, v in self._idle.items()),
        }


def _resolve_quietly(fut: asyncio.Future) -> None:
    if not fut.done():
        fut.set_result(None)


class _HashShard:
    """One hasher thread + its FIFO job queue. Pumps are assigned to a shard
    round-robin; the single consumer per shard preserves each pump's update
    order while INTERLEAVING chunks of every assigned pump — no pump waits
    for another to finish before its hashing starts. (A first cut dedicated
    a worker to each pump for its lifetime; with more in-flight pieces than
    workers, late pumps got zero overlap until early ones completed and the
    checkpoint fan-out halved.) Daemon thread: an unclosed pipeline never
    blocks interpreter exit."""

    __slots__ = ("q", "thread", "closed")

    def __init__(self, name: str):
        self.q: queue.SimpleQueue = queue.SimpleQueue()
        self.closed = False
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            job = self.q.get()
            if job is None:
                # Closing: mark closed FIRST, then drain whatever made it
                # into the queue — a pump racing close() either lands its
                # signal before this drain finishes (resolved here) or
                # observes `closed` after its put and fails fast in
                # finish(); without this, a signal enqueued after the
                # sentinel would leave finish() awaiting forever and the
                # piece worker stalling until the 600 s watchdog.
                self.closed = True
                self._drain_after_close()
                return
            if job[0] == 0:  # update: h.update releases the GIL at these sizes
                _, h, view, start, end = job
                try:
                    h.update(view[start:end])
                except Exception as e:  # noqa: BLE001 — an aborted pump's
                    # stale job (e.g. a view over a since-released buffer)
                    # must never kill the shard: every pump assigned here
                    # would then await finish() forever
                    logger.debug("hash shard dropped stale update: %r", e)
            else:  # completion signal for a pump's finish()
                self._signal(job)

    def _drain_after_close(self) -> None:
        while True:
            try:
                job = self.q.get_nowait()
            except queue.Empty:
                return
            if job is not None and job[0] == 1:
                self._signal(job)

    @staticmethod
    def _signal(job) -> None:
        _, loop, fut = job
        try:
            loop.call_soon_threadsafe(_resolve_quietly, fut)
        except RuntimeError:  # loop already closed: nobody awaits
            logger.debug("hash shard signal after loop close")


class HashPump:
    """Incremental sha256 over a buffer being filled in place.

    feed(filled) is called on the event-loop thread as bytes land (`filled`
    = total valid bytes so far); once a full HASH_CHUNK accumulates, its
    range goes onto the pump's shard queue — h.update runs on the shard
    thread with the GIL released, and the hand-off costs ONE queue put, no
    event-loop scheduling. (A first cut chained per-chunk run_in_executor
    calls instead; each chunk then needed two loop-callback slots that
    queued behind the saturated recv loop, and "overlapped" hashing measured
    SLOWER than a serial second pass on the reference's CPU image — 345 vs
    575 MB/s.) finish() flushes
    the tail and awaits a completion signal that rides the same FIFO queue;
    abort() is a no-op placeholder — an abandoned pump holds no worker, and
    its queued updates drain harmlessly (the digest is never read).

    Small buffers (<= inline_bytes) skip the thread entirely and hash in one
    pass at finish() — for them the round-trip would cost more than the
    hash.
    """

    __slots__ = ("_view", "_h", "_shard", "_chunk", "_inline", "_fed")

    def __init__(
        self,
        view: memoryview,
        shard: Optional[_HashShard],
        *,
        chunk_bytes: int = HASH_CHUNK_BYTES,
        inline_bytes: int = INLINE_HASH_BYTES,
    ):
        self._view = view
        self._h = hashlib.sha256()
        self._shard = shard
        self._chunk = chunk_bytes
        self._inline = shard is None or len(view) <= inline_bytes
        self._fed = 0  # bytes already handed to the hasher

    def feed(self, filled: int) -> None:
        if self._inline or filled - self._fed < self._chunk:
            return
        if self._shard.closed:
            return  # shutting down: finish() will fail fast, don't pile jobs
        self._shard.q.put((0, self._h, self._view, self._fed, filled))
        self._fed = filled

    async def finish(self) -> str:
        """Flush the unfed tail, wait for the shard to apply it, return hex."""
        if self._inline:
            self._h.update(self._view)
            return self._h.hexdigest()
        if self._fed < len(self._view):
            self._shard.q.put((0, self._h, self._view, self._fed, len(self._view)))
            self._fed = len(self._view)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._shard.q.put((1, loop, fut))  # FIFO: lands after every update
        if self._shard.closed:
            # pipeline closed under us (daemon shutdown racing a fetch): the
            # shard's post-sentinel drain may or may not have seen the
            # signal — fail the fetch NOW either way; a silent await could
            # hang until the task watchdog, and a partial digest must never
            # be returned
            raise RuntimeError("piece pipeline closed while hashing")
        await fut
        return self._h.hexdigest()

    def abort(self) -> None:
        """Abandon the pump (fetch failed). Queued updates may still read a
        buffer that gets recycled — memory-safe, and the digest of an
        aborted pump is never consumed. No worker or queue is pinned."""


class PiecePipeline:
    """Per-daemon shared pipeline state: one buffer pool + one hash executor.

    Passed to conductors the way the shared RawRangeClient is, so pooled
    buffers and hash threads are reused across every concurrent transfer on
    the host instead of per task."""

    def __init__(
        self,
        *,
        pool: BufferPool | None = None,
        hash_threads: int = 2,
        hash_chunk_bytes: int = HASH_CHUNK_BYTES,
        inline_hash_bytes: int = INLINE_HASH_BYTES,
    ):
        self.pool = pool or BufferPool()
        self._hash_threads = hash_threads
        self._hash_chunk = hash_chunk_bytes
        self._inline = inline_hash_bytes
        self._shards: list[_HashShard] = []
        self._next_shard = 0

    def hash_pump(self, view: memoryview) -> HashPump:
        shard = None
        if len(view) > self._inline:
            if not self._shards:
                self._shards = [
                    _HashShard(f"df-hash-{i}") for i in range(self._hash_threads)
                ]
            shard = self._shards[self._next_shard % len(self._shards)]
            self._next_shard += 1
        return HashPump(
            view,
            shard,
            chunk_bytes=self._hash_chunk,
            inline_bytes=self._inline,
        )

    def close(self) -> None:
        for shard in self._shards:
            shard.q.put(None)
        self._shards = []

    def stats(self) -> dict:
        return self.pool.stats()
