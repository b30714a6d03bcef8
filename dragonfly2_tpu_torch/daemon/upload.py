"""Piece upload server: serves stored pieces to child peers over HTTP (the
port of dragonfly2_tpu/daemon/upload.py, plain and mTLS).

Parity with reference client/daemon/upload/upload_manager.go:92-127,214
(HTTP GET /download/{taskID[:3]}/{taskID}?peerId= with Range headers) plus a
piece-metadata endpoint replacing the reference's gRPC GetPieceTasks/
SyncPieceTasks streams (rpcserver.go:151,268): children poll
GET /metadata/{taskID} for the parent's finished-piece bitset + digests.
Rate-limited by the shared token bucket (1 GiB/s default upload cap,
ref client/config/constants.go:47).

TLS (`tls=` server context from security/transport.py): the piece plane
serves mTLS through a RAW asyncio server built on AsyncTlsTransport instead
of aiohttp — asyncio's SSLProtocol write path measured ~350 MB/s regardless
of peer on the reference's CPU host (per-record Python in the encrypt
pipeline), a 3x tax the fan-out cannot pay. The raw server speaks the same HTTP/1.1 contract (206 ranges
with Content-Length framing, the /metadata long-poll, keep-alive) but
streams bodies through `send_file_range`: preadv into ONE reused
record-aligned buffer, encrypt through the BIO, big blocking sendalls — the
whole chain on a worker thread with the GIL released, which is what
replaces `sendfile` until kTLS exists (probed at context build and reported,
never acted on — see security.transport.probe_ktls). The plain path
keeps aiohttp + sendfile untouched.
"""

from __future__ import annotations

import asyncio
import logging
import math
import os
import socket as socketlib
import ssl as _ssl
import time
import weakref
from collections import OrderedDict
from urllib.parse import parse_qsl, unquote

from aiohttp import web

from dragonfly2_tpu_torch.daemon.storage import OncePinRelease, StorageManager, TaskStorage
from dragonfly2_tpu_torch.utils.pieces import parse_http_range
from dragonfly2_tpu_torch.utils.ratelimit import TokenBucket

logger = logging.getLogger(__name__)

_MAX_REQUEST_HEAD = 16 << 10
# idle bound armed on the threaded TLS body send (per-sendall): a client
# that stops reading cannot park a worker thread in send(2) forever —
# shutdown-on-close wakes it, this self-unblocks it even without a close
_TLS_SEND_TIMEOUT_S = 30.0

_REASONS = {200: "OK", 206: "Partial Content", 400: "Bad Request",
            404: "Not Found", 416: "Range Not Satisfiable", 500: "Internal Server Error"}


class _HttpError(Exception):
    """Routed request failure on the raw TLS server — becomes a plain-text
    error response, mirroring the aiohttp handlers' web.HTTP* raises."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


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
        self.storage = storage
        self.host = host
        self.port = port
        # server ssl.SSLContext (security.transport.data_server_ssl_context):
        # mTLS piece serving with the reused-buffer streaming body path
        self.tls = tls
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
        # raw TLS server state (module docstring): accept loop + live conns
        self._tls_lsock: "socketlib.socket | None" = None
        self._tls_accept: asyncio.Task | None = None
        self._tls_conns: set[asyncio.Task] = set()

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
        if self.tls is not None:
            await self._start_tls_raw()
            return
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
        if self._tls_accept is not None:
            self._tls_accept.cancel()
            await asyncio.gather(self._tls_accept, return_exceptions=True)
            self._tls_accept = None
        if self._tls_lsock is not None:
            self._tls_lsock.close()
            self._tls_lsock = None
        for t in list(self._tls_conns):
            t.cancel()
        if self._tls_conns:
            await asyncio.gather(*list(self._tls_conns), return_exceptions=True)
        self._tls_conns.clear()
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
        """The metadata response body (shared by the aiohttp and raw-TLS
        servers). Raises ValueError on a malformed `have` bitset."""
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
        """Shared serve accounting for the sendfile and TLS body paths."""
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


    # ---- raw TLS server (module docstring: the mTLS piece plane) ----

    async def _start_tls_raw(self) -> None:
        family = socketlib.AF_INET6 if ":" in self.host else socketlib.AF_INET
        lsock = socketlib.socket(family, socketlib.SOCK_STREAM)
        lsock.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
        lsock.bind((self.host, self.port))
        lsock.listen(128)
        lsock.setblocking(False)
        self._tls_lsock = lsock
        self.port = lsock.getsockname()[1]
        self._tls_accept = asyncio.ensure_future(self._tls_accept_loop())
        logger.info("upload server on %s:%d (mTLS, raw)", self.host, self.port)

    async def _tls_accept_loop(self) -> None:
        from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy

        loop = asyncio.get_running_loop()
        # transient-accept pacing: fd pressure clears in ms, so start small
        backoff = BackoffPolicy(base=0.05, multiplier=2.0, max_delay=1.0, jitter=0.3)
        accept_failures = 0
        while True:
            try:
                conn, _addr = await loop.sock_accept(self._tls_lsock)
                accept_failures = 0
            except asyncio.CancelledError:
                return
            except OSError as e:
                if self._tls_lsock.fileno() < 0:
                    return  # listener closed under us (stop())
                # transient accept failure (ECONNABORTED, EMFILE/ENFILE
                # under fd pressure): the listener is still live and bound —
                # returning here would silently stop accepting piece
                # connections forever while clients hang on the backlog
                logger.warning("TLS piece-server accept failed, retrying: %r", e)
                await backoff.sleep(accept_failures)
                accept_failures += 1
                continue
            conn.setblocking(False)
            conn.setsockopt(socketlib.IPPROTO_TCP, socketlib.TCP_NODELAY, 1)
            # deeper kernel pipeline: encrypt-ahead depth for the send path
            conn.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_SNDBUF, 4 << 20)
            t = asyncio.ensure_future(self._tls_conn_loop(conn))
            self._tls_conns.add(t)
            t.add_done_callback(self._tls_conns.discard)

    async def _tls_conn_loop(self, conn: "socketlib.socket") -> None:
        from dragonfly2_tpu_torch.security.transport import AsyncTlsTransport

        try:
            tr = await AsyncTlsTransport.accept(conn, self.tls)
        except (_ssl.SSLError, ConnectionError, OSError, asyncio.TimeoutError) as e:
            # plaintext speaker, bad client cert, or a half-open probe: the
            # mTLS posture refuses it at the handshake, quietly
            logger.debug("TLS piece-server handshake refused: %r", e)
            conn.close()
            return
        try:
            while True:
                try:
                    req = await self._tls_read_request(tr)
                except _HttpError as e:
                    # malformed head (oversized, non-GET, bad request line):
                    # tell the client why, then drop the connection — the
                    # request framing may be desynced past recovery
                    await self._tls_send_simple(
                        tr, e.status, e.text.encode(), connection="close"
                    )
                    # drain what the client already sent (a POST body, the
                    # rest of an oversized head) before closing: close()
                    # with unread bytes queued answers with RST, which can
                    # destroy the in-flight 400 before the client reads it.
                    # Bounded in bytes, per-read idle, AND total wall-clock
                    # — a client that streams (or trickles) forever gets cut
                    # off, response delivered or not
                    try:
                        loop = asyncio.get_running_loop()
                        deadline = loop.time() + 2.0
                        drained = 0
                        while drained < (1 << 20) and loop.time() < deadline:
                            chunk = await asyncio.wait_for(tr.recv(8192), 0.5)
                            if not chunk:
                                break  # client read the 400 and closed
                            drained += len(chunk)
                    except (asyncio.TimeoutError, ConnectionError, OSError):
                        pass
                    return
                if req is None:
                    return  # clean keep-alive close
                path, query, headers = req
                try:
                    await self._tls_dispatch(tr, path, query, headers)
                except _HttpError as e:
                    await self._tls_send_simple(tr, e.status, e.text.encode())
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            logger.debug("TLS piece-server connection dropped: %r", e)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — one bad request/connection must
            # never take down the serve plane; the child retries elsewhere
            logger.exception("TLS piece-server connection failed")
        finally:
            tr.close()

    async def _tls_read_request(self, tr) -> "tuple[str, dict, dict] | None":
        """One request head: (path, query-dict, headers-dict), or None on a
        clean close between requests. GET-only (the piece wire contract)."""
        head = bytearray()
        while True:
            end = head.find(b"\r\n\r\n")
            if end >= 0:
                break
            if len(head) > _MAX_REQUEST_HEAD:
                raise _HttpError(400, "request head too large")
            chunk = await tr.recv(8192)
            if not chunk:
                if head:
                    raise ConnectionError("client closed mid-request")
                return None
            head += chunk
        lines = head[:end].decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or parts[0] != "GET":
            raise _HttpError(400, f"unsupported request line {lines[0]!r}")
        target = parts[1]
        path, _, qs = target.partition("?")
        query = dict(parse_qsl(qs, keep_blank_values=True))
        headers: dict[str, str] = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        return unquote(path), query, headers

    async def _tls_send_simple(
        self, tr, status: int, body: bytes, content_type: str = "text/plain",
        connection: str = "keep-alive",
    ) -> None:
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {connection}\r\n"
            "\r\n"
        ).encode("ascii")
        await tr.sendall(head + body)

    async def _tls_dispatch(self, tr, path: str, query: dict, headers: dict) -> None:
        import json

        if path == "/healthz":
            await self._tls_send_simple(
                tr, 200, b'{"ok": true}', content_type="application/json"
            )
            return
        if path.startswith("/metadata/"):
            task_id = path[len("/metadata/"):]
            ts = self.storage.get(task_id)
            if ts is None:
                raise _HttpError(404, f"task {task_id} unknown")
            since = query.get("since")
            if since is not None:
                try:
                    wait_s = float(query.get("wait", "25"))
                    if not math.isfinite(wait_s):
                        raise _HttpError(400, "wait must be finite")
                    await ts.wait_version(
                        int(since), min(max(0.0, wait_s), self.MAX_LONGPOLL_S)
                    )
                except ValueError:
                    raise _HttpError(400, "since/wait must be numeric")
            try:
                payload = self._metadata_payload(ts, task_id, query.get("have"))
            except ValueError:
                raise _HttpError(400, "have must be a hex bitset")
            await self._tls_send_simple(
                tr, 200, json.dumps(payload).encode(), content_type="application/json"
            )
            return
        if path.startswith("/download/"):
            rest = path[len("/download/"):]
            prefix, _, task_id = rest.partition("/")
            await self._tls_serve_download(tr, prefix, task_id, headers)
            return
        raise _HttpError(404, f"no route for {path}")

    async def _tls_serve_download(self, tr, prefix: str, task_id: str, headers: dict) -> None:
        """The mTLS twin of _handle_download + _serve_range: identical
        validation and accounting, with the body streamed by the transport's
        worker-thread encrypt+send path under the task pin."""
        if prefix != task_id[:3]:
            raise _HttpError(400, "prefix/task mismatch")
        ts = self.storage.get(task_id)
        if ts is None:
            raise _HttpError(404, f"task {task_id} unknown")
        total = ts.meta.content_length
        if total <= 0 or ts.meta.piece_size <= 0:
            raise _HttpError(404, f"task {task_id} metadata not ready")
        range_header = headers.get("range")
        if range_header is None:
            raise _HttpError(400, "Range header required (piece-granular server)")
        try:
            rng = parse_http_range(range_header, total)
        except ValueError as e:
            raise _HttpError(416, str(e))
        if not ts.meta.done:
            psize = ts.meta.piece_size
            for idx in range(rng.start // psize, (rng.start + rng.length - 1) // psize + 1):
                if not ts.has_piece(idx):
                    raise _HttpError(404, f"piece {idx} not yet available")

        from dragonfly2_tpu_torch.observability.tracing import (
            TRACEPARENT_HEADER,
            SpanContext,
            default_tracer,
        )

        # rate-limit BEFORE the span opens (the aiohttp path's discipline):
        # a disconnect cancelling the acquire must not leak an entered span
        await self.bucket.acquire(rng.length)
        span = None
        remote = SpanContext.from_traceparent(headers.get(TRACEPARENT_HEADER))
        if remote is not None:
            span = default_tracer().span(  # dflint: disable=DF027 entered here, exited in this handler's finally so the span covers the threaded body send
                "upload.serve_piece", parent=remote,
                task_id=task_id, range_start=rng.start, range_length=rng.length,
            )
            span.__enter__()
        ts.pin()  # the send IS the handler here: pinned end to end
        try:
            self._account_serve(ts, task_id, rng, span)
            head = (
                "HTTP/1.1 206 Partial Content\r\n"
                "Content-Type: application/octet-stream\r\n"
                f"Content-Length: {rng.length}\r\n"
                f"Content-Range: bytes {rng.start}-{rng.start + rng.length - 1}/{total}\r\n"
                "Connection: keep-alive\r\n"
                "\r\n"
            ).encode("ascii")
            await tr.send_file_range(
                ts.data_path, rng.start, rng.length, head=head,
                timeout=_TLS_SEND_TIMEOUT_S,
            )
        finally:
            ts.unpin()
            if span is not None:
                span.__exit__(None, None, None)
