"""Piece upload server: serves stored pieces to child peers over HTTP (the
port of dragonfly2_tpu/daemon/upload.py).

Parity with reference client/daemon/upload/upload_manager.go:92-127,214
(HTTP GET /download/{taskID[:3]}/{taskID}?peerId= with Range headers) plus a
piece-metadata endpoint replacing the reference's gRPC GetPieceTasks/
SyncPieceTasks streams (rpcserver.go:151,268): children poll
GET /metadata/{taskID} for the parent's finished-piece bitset + digests.
Rate-limited by the shared token bucket (1 GiB/s default upload cap,
ref client/config/constants.go:47).

TLS: not ported yet. The reference serves mTLS through a raw server on
``AsyncTlsTransport`` when given a ``tls=`` context; here a non-None
``tls=`` raises ``NotImplementedError`` naming the ROADMAP.md item
(``security/``). The plain path is the reference's: aiohttp + sendfile.
"""

from __future__ import annotations

import logging
import math
import os
import time
import weakref
from collections import OrderedDict

from aiohttp import web

from dragonfly2_tpu_torch.daemon.storage import OncePinRelease, StorageManager, TaskStorage
from dragonfly2_tpu_torch.utils.pieces import parse_http_range
from dragonfly2_tpu_torch.utils.ratelimit import TokenBucket

logger = logging.getLogger(__name__)

def _close_span_once(holder: list) -> None:
    """Exit an entered serve span exactly once (prepare's finally, or the
    GC finalizer for responses aiohttp never prepares). The contextvar
    token may belong to a dead task context — a ValueError from reset must
    not mask the export, so the exit is attempted and the export is what
    matters (Span.__exit__ resets first, then exports)."""
    if not holder:
        return
    span = holder.pop()
    try:
        span.__exit__(None, None, None)
    except ValueError:
        # token from another context (finalizer thread): the reset fails
        # but the span must still export — finish it by hand
        span._token = None
        span.__exit__(None, None, None)


class _PinnedFileResponse(web.FileResponse):
    """FileResponse holding a storage pin from construction until its own
    prepare() (which opens the file and sends the ranged body) completes:
    the threaded storage reclaim must not rmtree the task in the window
    between the handler returning and aiohttp opening the file. A GC
    finalizer covers responses aiohttp never prepares (connection lost).
    When the request carried a traceparent, the serve span rides along the
    same way — closed after prepare so it covers the sendfile, not just the
    handler's validation, with the finalizer closing it on the
    never-prepared path so no span (or stale contextvar) leaks."""

    def __init__(self, *args, ts: TaskStorage, span=None, **kwargs):
        super().__init__(*args, **kwargs)
        release = OncePinRelease(ts)
        ts.pin()
        self._df_release = release
        self._df_span_holder = [span] if span is not None else []
        weakref.finalize(self, release)
        if span is not None:
            weakref.finalize(self, _close_span_once, self._df_span_holder)

    async def prepare(self, request):
        try:
            return await super().prepare(request)
        finally:
            self._df_release()
            _close_span_once(self._df_span_holder)


class UploadServer:
    def __init__(
        self,
        storage: StorageManager,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        rate_limit_bps: float = 1 << 30,
        tls=None,
    ):
        if tls is not None:
            raise NotImplementedError(
                "the mTLS piece plane (security/) is not ported yet "
                "(ROADMAP.md §1, 'Still to do' item 4)"
            )
        self.storage = storage
        self.host = host
        self.port = port
        self.bucket = TokenBucket(rate_limit_bps, burst=64 << 20)
        self.bytes_served = 0
        self.pieces_served = 0
        # hot-piece accounting: ranges served more than once recently (the
        # fan-out shape — one seed, N children pulling the same pieces).
        # Repeat serves ride sendfile straight out of page cache; the fd
        # cache below keeps a readahead hint warm per hot task.
        self.pieces_served_hot = 0
        self._recent_serves: OrderedDict[tuple[str, int, int], int] = OrderedDict()
        self._fd_cache: OrderedDict[str, int] = OrderedDict()  # task_id -> O_RDONLY fd
        self._runner: web.AppRunner | None = None

    _RECENT_SERVES_MAX = 4096
    _FD_CACHE_MAX = 32

    def _app(self) -> web.Application:
        # no /metrics here: the upload port is the public p2p data path;
        # metrics live on the daemon's dedicated debug port (observability.server)
        app = web.Application()
        app.router.add_get("/download/{prefix}/{task_id}", self._handle_download)
        app.router.add_get("/metadata/{task_id}", self._handle_metadata)
        app.router.add_get("/healthz", self._handle_health)
        return app

    async def start(self) -> None:
        # handler_cancellation: parked long-poll metadata handlers must die
        # with the client connection / server shutdown, not hold cleanup for
        # the full longpoll window.
        self._runner = web.AppRunner(
            self._app(), access_log=None, handler_cancellation=True, shutdown_timeout=1.0
        )
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        # resolve the ephemeral port
        self.port = site._server.sockets[0].getsockname()[1]
        logger.info("upload server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        for fd in self._fd_cache.values():
            try:
                os.close(fd)
            except OSError as e:
                logger.debug("fd-cache close failed: %r", e)
        self._fd_cache.clear()

    def _advise_range(self, ts: TaskStorage, start: int, length: int) -> None:
        """Nudge the kernel to keep the served range resident
        (POSIX_FADV_WILLNEED through a cached per-task fd): the first child's
        serve pre-warms page cache for the rest of the fan-out, so repeat
        serves stay on the sendfile/page-cache path with zero userspace
        copies. Best-effort — tmpfs stores and platforms without fadvise just
        skip it."""
        if not hasattr(os, "posix_fadvise"):
            return
        task_id = ts.meta.task_id
        fd = self._fd_cache.get(task_id)
        try:
            if fd is not None and os.fstat(fd).st_ino != os.stat(ts.data_path).st_ino:
                # the task was deleted and re-registered since this fd was
                # cached: advising the orphaned inode would warm nothing
                self._fd_cache.pop(task_id, None)
                os.close(fd)
                fd = None
            if fd is None:
                fd = os.open(ts.data_path, os.O_RDONLY)
                self._fd_cache[task_id] = fd
                if len(self._fd_cache) > self._FD_CACHE_MAX:
                    _, old = self._fd_cache.popitem(last=False)
                    os.close(old)
            else:
                self._fd_cache.move_to_end(task_id)
            os.posix_fadvise(fd, start, length, os.POSIX_FADV_WILLNEED)
        except OSError as e:
            # an unlinked (reclaimed) task or exotic fs: the serve itself is
            # unaffected, only the readahead hint is lost
            logger.debug("fadvise for %s failed: %r", task_id[:12], e)
            stale = self._fd_cache.pop(task_id, None)
            if stale is not None:
                try:
                    os.close(stale)
                except OSError:
                    logger.debug("stale fd close failed for %s", task_id[:12])

    def _prune_fd_cache(self) -> None:
        """Drop cached fds whose tasks were reclaimed (run every 64 serves):
        an open fd pins a deleted task's unlinked inode, so the disk blocks
        storage reclaim thought it freed would stay allocated until LRU
        eviction — on a seed serving few distinct tasks, indefinitely."""
        for tid in list(self._fd_cache):
            if self.storage.get(tid) is None:
                fd = self._fd_cache.pop(tid)
                try:
                    os.close(fd)
                except OSError as e:
                    logger.debug("fd-cache prune close failed: %r", e)

    def _note_serve(self, task_id: str, start: int, length: int) -> bool:
        """Track (task, range) repeat serves; True when this range is hot
        (served before recently). Bounded LRU — eviction only loses hotness
        accounting, never correctness."""
        key = (task_id, start, length)
        seen = self._recent_serves.get(key)
        if seen is None:
            self._recent_serves[key] = 1
            if len(self._recent_serves) > self._RECENT_SERVES_MAX:
                self._recent_serves.popitem(last=False)
            return False
        self._recent_serves.move_to_end(key)
        self._recent_serves[key] = seen + 1
        return True

    async def _handle_health(self, request: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    MAX_LONGPOLL_S = 25.0

    async def _handle_metadata(self, request: web.Request) -> web.Response:
        """Piece-metadata endpoint with long-poll push semantics (replacing
        the reference's bidi SyncPieceTasks stream,
        peertask_piecetask_synchronizer.go:81-237): `?since=<version>&wait=<s>`
        parks the request until the task state changes past `since`, so a
        child learns of a new piece the moment it lands instead of on a
        polling interval.

        `?have=<hex>` (a bitset of piece indices whose digests the caller
        already knows) makes piece_digests a DELTA: without it, every wake
        re-sends all digests — O(pieces²) metadata bytes per child over a
        download, ~40 MB of redundancy for a 1024-piece checkpoint shard."""
        task_id = request.match_info["task_id"]
        ts = self.storage.get(task_id)
        if ts is None:
            raise web.HTTPNotFound(text=f"task {task_id} unknown")
        since = request.query.get("since")
        if since is not None:
            try:
                wait_s = float(request.query.get("wait", "25"))
                if not math.isfinite(wait_s):
                    raise web.HTTPBadRequest(text="wait must be finite")
                await ts.wait_version(int(since), min(max(0.0, wait_s), self.MAX_LONGPOLL_S))
            except ValueError:
                raise web.HTTPBadRequest(text="since/wait must be numeric")
        try:
            return web.json_response(
                self._metadata_payload(ts, task_id, request.query.get("have"))
            )
        except ValueError:
            raise web.HTTPBadRequest(text="have must be a hex bitset")

    @staticmethod
    def _metadata_payload(ts: TaskStorage, task_id: str, have_hex: str | None) -> dict:
        """The metadata response body. Raises ValueError on a malformed
        `have` bitset."""
        m = ts.meta
        digests = m.piece_digests
        if have_hex:
            have = int(have_hex, 16)
            digests = {k: v for k, v in digests.items() if not (have >> int(k)) & 1}
        return {
            "task_id": task_id,
            "content_length": m.content_length,
            "piece_size": m.piece_size,
            "total_pieces": m.total_pieces,
            "digest": m.digest,
            # hex bitset: a 1024-piece task announces in 256 chars
            # instead of ~6 KB; the index list stays alongside so
            # pre-upgrade peers in a mixed cluster still see pieces
            "finished_hex": format(ts.finished.to_int(), "x"),
            "finished_pieces": sorted(ts.finished.indices()),
            "piece_digests": digests,
            "done": m.done,
            "version": ts.version,
        }

    async def _handle_download(self, request: web.Request) -> web.StreamResponse:
        task_id = request.match_info["task_id"]
        if request.match_info["prefix"] != task_id[:3]:
            raise web.HTTPBadRequest(text="prefix/task mismatch")
        ts = self.storage.get(task_id)
        if ts is None:
            raise web.HTTPNotFound(text=f"task {task_id} unknown")
        total = ts.meta.content_length
        if total <= 0 or ts.meta.piece_size <= 0:
            raise web.HTTPNotFound(text=f"task {task_id} metadata not ready")
        range_header = request.headers.get("Range")
        if range_header is None:
            raise web.HTTPBadRequest(text="Range header required (piece-granular server)")
        try:
            rng = parse_http_range(range_header, total)
        except ValueError as e:
            raise web.HTTPRequestRangeNotSatisfiable(text=str(e))

        # The requested range must be fully covered by finished pieces. A
        # done task has every piece — skip the per-piece loop (O(pieces) per
        # serve; ~1k has_piece calls per whole-shard range on a large
        # checkpoint), which is pure overhead on the repeat-serve hot path.
        if not ts.meta.done:
            psize = ts.meta.piece_size
            first_piece = rng.start // psize
            last_piece = (rng.start + rng.length - 1) // psize
            for idx in range(first_piece, last_piece + 1):
                if not ts.has_piece(idx):
                    raise web.HTTPNotFound(text=f"piece {idx} not yet available")

        # the child's piece fetch shipped its trace context in the standard
        # traceparent header (rawrange + the conductor's aiohttp fallback):
        # the serve joins that trace as a server-side span covering the
        # validation AND the sendfile (closed in _PinnedFileResponse.prepare)
        from dragonfly2_tpu_torch.observability.tracing import (
            TRACEPARENT_HEADER,
            SpanContext,
            default_tracer,
        )

        # rate-limit BEFORE the span opens: a client disconnect cancelling
        # the acquire must not leak an entered span
        await self.bucket.acquire(rng.length)
        span = None
        remote = SpanContext.from_traceparent(request.headers.get(TRACEPARENT_HEADER))
        if remote is not None:
            span = default_tracer().span(  # dflint: disable=DF027 entered here, exited by _PinnedFileResponse.prepare so the span covers the body send
                "upload.serve_piece", parent=remote,
                task_id=task_id, range_start=rng.start, range_length=rng.length,
            )
            span.__enter__()
        try:
            return self._serve_range(request, ts, task_id, rng, span)
        except BaseException as exc:
            # anything failing before the response takes over span ownership
            # (rate-limit cancel, fs errors) must close it — a leaked span
            # loses the segment AND leaves later requests on this keep-alive
            # connection parented to a ghost
            if span is not None:
                span.__exit__(type(exc), exc, None)
            raise

    def _account_serve(self, ts, task_id, rng, span) -> None:
        """Serve accounting for the sendfile body path."""
        self.bytes_served += rng.length
        self.pieces_served += 1
        if self.pieces_served % 64 == 0:
            self._prune_fd_cache()
        if self._note_serve(task_id, rng.start, rng.length):
            self.pieces_served_hot += 1
            if span is not None:
                span.set_attr("hot", True)
        else:
            # first serve of this range: pre-warm page cache for the rest of
            # the fan-out (repeat serves then read/send straight from cache)
            self._advise_range(ts, rng.start, rng.length)
        from dragonfly2_tpu_torch.daemon import metrics

        metrics.UPLOAD_BYTES.inc(rng.length)
        ts.last_access = time.time()  # serving keeps the task LRU-hot

    def _serve_range(self, request, ts, task_id, rng, span) -> web.StreamResponse:
        self._account_serve(ts, task_id, rng, span)
        # Zero-copy serving: FileResponse honors the Range header itself and
        # sends via loop.sendfile where the platform supports it, so piece
        # bytes go disk→socket without ever entering Python userspace (the
        # previous read_range path buffered the whole piece then copied it
        # through the response). The pinned subclass keeps the task immune to
        # the threaded reclaim until the file is open and sent; once open,
        # eviction only unlinks the inode and the send is safe.
        return _PinnedFileResponse(
            ts.data_path,
            ts=ts,
            span=span,
            chunk_size=1 << 20,
            headers={"Content-Type": "application/octet-stream"},
        )
