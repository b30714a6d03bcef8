"""Zero-copy HTTP/1.1 range client for peer piece fetches: the port of
dragonfly2_tpu/daemon/rawrange.py, plain and mTLS.

The piece hot path (conductor._download_one_piece) fetched bodies through
aiohttp: every received chunk passes the protocol's feed_data, is appended to
a chunk list, and resp.read() joins the list — a full extra copy of every
payload byte, plus per-chunk event-loop machinery. A cProfile of the
reference's checkpoint fan-out bench on its CPU image put that assembly
(aiohttp data_received + bytes.join) at ~1.2 ns/byte of the ~3.7 ns/byte
fetch-path total.

This client receives the body DIRECTLY into a caller-provided buffer with
``loop.sock_recv_into`` — bytes go kernel→piece buffer with no intermediate
chunk objects and no join pass. ``get_range_into`` is the pipeline entry:
the caller passes a (typically pooled — daemon/pipeline.py) memoryview plus
an ``on_chunk(filled)`` callback, so a HashPump hashes the piece WHILE it is
still arriving instead of in a second cold-buffer pass. ``get_range`` keeps
the old allocate-and-return shape on top of it.

It speaks just enough HTTP/1.1 for the peer upload server's download
endpoint (daemon/upload.py _handle_download → aiohttp FileResponse): status
206, Content-Length framing (FileResponse never chunk-encodes a known-length
range), keep-alive pooling per (host, port), transparent retries for pooled
connections that turn out to be stale keep-alive sockets. IPv6 parents are
reached with an AF_INET6 socket (``':' in ip``); where the local stack
cannot route the family at all, AddressFamilyError tells the caller to fall
back to the aiohttp path rather than recording a parent failure.

Fault injection: when a ``fault_point`` is given and faultline is ACTIVE,
truncate/corrupt rules are applied to the FIRST body bytes inside the recv
loop — the pipeline's read point — mirroring the source registry's
one-draw-per-stream discipline (per-chunk draws would compound a small rate
into near-certain failure). A truncation surfaces as the short-body IOError
a real early close produces; a corruption flows through hash-on-receive and
is caught by the digest check, so chaos proofs exercise the same rejection
path production corruption would take.

TLS: when built with a ``DataPlaneTls`` bundle (security/transport.py) every
connection handshakes through the bulk-BIO fast path — ciphertext moves in
256 KiB reads and ``SSLObject.read`` decrypts DIRECTLY into the caller's
pooled buffer, preserving the no-intermediate-copy discipline under mTLS.
Sessions are cached per (ip, port): the first connect to a parent pays the
full ECDHE+cert handshake, every later per-piece connection (and the whole
pool after an idle prune or reconnect storm) resumes abbreviated. Handshake
outcomes land in ``piece_tls_handshakes_total{resumed}`` and the failure
counter the alert plane watches.

Reference context: the piece transfer protocol is the reference's HTTP
`GET /download/{taskID[:3]}/{taskID}?peerId=` with a Range header
(client/daemon/peer/piece_downloader.go:203-211); this is the same wire
contract, with the client tuned for multi-hundred-MB/s single-core fan-out
(north-star config 4).
"""

from __future__ import annotations

import asyncio
import errno
import logging
import socket
import ssl as _ssl
from typing import Callable, Optional

from dragonfly2_tpu_torch.resilience import faultline
from dragonfly2_tpu_torch.security.transport import AsyncPlainTransport, AsyncTlsTransport

logger = logging.getLogger(__name__)

_MAX_HEADER_BYTES = 16 << 10
_MAX_IDLE_PER_HOST = 4
# TLS bodies at/above this ride the worker-thread drain (recv+decrypt off
# the loop); below it the thread hop costs more than it overlaps
_TLS_THREADED_BODY_BYTES = 256 << 10
# idle bound armed on the drain's blocking socket (per-recv, not total):
# a parent that stalls mid-body fails the drain this fast, so it cannot
# hold the client-wide _drain_sem for a full piece timeout while waiters'
# own piece timers expire and falsely charge their healthy parents — and
# a blocked worker thread always self-unblocks even if no close arrives
_TLS_DRAIN_IDLE_TIMEOUT_S = 5.0
# pooled sockets older than this are assumed dead (peer upload servers close
# idle keep-alive connections after ~75 s) and are discarded at checkout /
# pruned periodically rather than tried
_IDLE_TTL_S = 60.0

# errnos meaning "this host cannot speak that address family at all" —
# distinct from a refused/unreachable PEER, which is a real parent failure
_AF_ERRNOS = frozenset(
    e
    for e in (
        getattr(errno, "EAFNOSUPPORT", None),
        getattr(errno, "EPFNOSUPPORT", None),
        getattr(errno, "EADDRNOTAVAIL", None),
    )
    if e is not None
)
# On a v4-only host socket(AF_INET6) typically SUCCEEDS and the miss shows
# up at connect() as net/host-unreachable — those must also route to the
# aiohttp fallback for IPv6 targets (a genuinely dead v6 parent still gets
# charged when the fallback fails too, so no blame is lost)
_AF_CONNECT_ERRNOS = _AF_ERRNOS | frozenset(
    e
    for e in (
        getattr(errno, "ENETUNREACH", None),
        getattr(errno, "EHOSTUNREACH", None),
    )
    if e is not None
)


class AddressFamilyError(OSError):
    """The parent's address family is unusable from this host (no IPv6
    stack/route for an IPv6 parent, or vice versa). Callers should retry the
    fetch over the aiohttp path — whose resolver handles mixed stacks —
    instead of charging the parent with a failure."""


class RawRangeClient:
    """Pooled keep-alive range GETs into caller-provided buffers."""

    def __init__(
        self,
        *,
        max_idle_per_host: int = _MAX_IDLE_PER_HOST,
        idle_ttl_s: float = _IDLE_TTL_S,
        tls=None,
    ):
        import time

        self._now = time.monotonic
        # pooled entries are transports (AsyncPlainTransport / AsyncTlsTransport)
        self._pool: dict[tuple[str, int], list[tuple[object, float]]] = {}
        self._max_idle = max_idle_per_host
        self._idle_ttl = idle_ttl_s
        # DataPlaneTls bundle (security/transport.py): client_ctx + per-parent
        # session cache. None = plain TCP (the pre-TLS wire).
        self._tls = tls
        # ONE TLS body drain at a time per client: each drain's per-record
        # Python slice runs ~1.5 µs under the GIL, and N concurrent drain
        # threads convoy on it — 4 parallel drains measured ~290 MB/s
        # aggregate where a single serialized drain does ~630. Piece workers
        # still pipeline: while one body drains, the others' requests are in
        # flight (the parent encrypts ahead into TCP buffers) and their
        # hash/write stages run on their own threads.
        self._drain_sem: asyncio.Semaphore | None = (
            asyncio.Semaphore(1) if tls is not None else None
        )
        self._closed = False

    @property
    def tls_enabled(self) -> bool:
        return self._tls is not None

    async def close(self) -> None:
        self._closed = True
        for conns in self._pool.values():
            for s, _t in conns:
                s.close()
        self._pool.clear()

    def prune(self) -> int:
        """Close pooled sockets idle past the TTL (parents never contacted
        again would otherwise pin CLOSE_WAIT fds for the process lifetime —
        the engine runs this off its GC registry). Returns sockets closed."""
        cutoff = self._now() - self._idle_ttl
        closed = 0
        for key in list(self._pool):
            kept = []
            for s, t in self._pool[key]:
                if t < cutoff:
                    s.close()
                    closed += 1
                else:
                    kept.append((s, t))
            if kept:
                self._pool[key] = kept
            else:
                del self._pool[key]
        return closed

    def _checkout(self, key: tuple[str, int]):
        conns = self._pool.get(key)
        while conns:
            s, t = conns.pop()
            if self._now() - t <= self._idle_ttl:
                return s
            s.close()  # idle past the server's keep-alive window: dead
        return None

    def _checkin(self, key: tuple[str, int], transport) -> None:
        if self._closed:
            transport.close()
            return
        conns = self._pool.setdefault(key, [])
        if len(conns) < self._max_idle:
            conns.append((transport, self._now()))
        else:
            transport.close()

    async def get_range(
        self,
        ip: str,
        port: int,
        path_qs: str,
        range_header: str,
        length: int,
        *,
        timeout: float = 30.0,
    ) -> bytearray:
        """GET path_qs with the given Range header; expects a 206 whose body
        is exactly `length` bytes and returns it as a fresh bytearray
        (received in place). Pipelined callers use get_range_into with a
        pooled buffer instead."""
        buf = bytearray(length)
        await self.get_range_into(
            ip, port, path_qs, range_header, memoryview(buf), timeout=timeout
        )
        return buf

    async def get_range_into(
        self,
        ip: str,
        port: int,
        path_qs: str,
        range_header: str,
        view: memoryview,
        *,
        timeout: float = 30.0,
        on_chunk: "Callable[[int], None] | None" = None,
        fault_point: str | None = None,
    ) -> None:
        """GET path_qs with the given Range header, receiving the body
        directly into `view` (whose length is the expected byte count).
        `on_chunk(filled)` fires on the event loop after each recv with the
        total bytes landed so far — the hash-on-receive hook. Raises IOError
        on any other status or a short body, and builtin TimeoutError past
        `timeout` (before Python 3.11, asyncio.TimeoutError is a separate
        class — callers match the builtin, and as an OSError subclass it
        also rides every IOError retry path)."""
        try:
            await asyncio.wait_for(
                self._get_with_pool(
                    ip, port, path_qs, range_header, view, on_chunk, fault_point,
                    timeout,
                ),
                timeout,
            )
        except asyncio.TimeoutError:
            raise TimeoutError(
                f"range fetch from {ip}:{port} timed out after {timeout}s"
            ) from None

    async def _get_with_pool(
        self,
        ip: str,
        port: int,
        path_qs: str,
        range_header: str,
        view: memoryview,
        on_chunk: "Callable[[int], None] | None",
        fault_point: str | None,
        timeout: float,
    ) -> None:
        # Transparent retries ONLY for pooled sockets that turn out to be
        # stale keep-alive connections: server closed them between uses →
        # ConnectionError BEFORE ANY RESPONSE BYTE. The loop drains however
        # many stale sockets the pool holds — with a cross-task shared
        # pool, EVERY pooled socket to a host can be stale after an idle
        # gap — and the final fresh-connection attempt is authoritative.
        # A ConnectionError AFTER response bytes arrived (mid-body RST) is
        # NOT replayed: the caller's hash pump has already
        # consumed body bytes, a systematically-resetting parent should be
        # charged per attempt, and the conductor's piece retry owns
        # recovery. Deterministic application failures (non-206, bad
        # framing) raise plain IOError and are never replayed either.
        key = (ip, port)
        while True:
            transport = self._checkout(key)
            pooled = transport is not None
            got_response = [False]  # set by _request on the first response byte
            try:
                if transport is None:
                    sock = self._fresh_socket(ip)
                    try:
                        await asyncio.get_running_loop().sock_connect(sock, (ip, port))
                        transport = await self._wrap_fresh(sock, key)
                    except OSError as e:
                        sock.close()
                        if ":" in ip and e.errno in _AF_CONNECT_ERRNOS:
                            raise AddressFamilyError(
                                f"no route to IPv6 target {ip!r} from this host"
                            ) from e
                        raise
                    except BaseException:
                        # timeout cancellation between connect and handshake
                        # completion must not leak the raw fd
                        sock.close()
                        raise
                await self._request(
                    transport, key, ip, port, path_qs, range_header,
                    view, on_chunk, fault_point, got_response, timeout,
                )
                return
            except BaseException as e:
                # every failure path — including timeout cancellation mid-body
                # — must close the socket: a piece timeout against a stalled
                # parent is routine, and each one would otherwise leak an fd
                if transport is not None:
                    transport.close()
                if pooled and isinstance(e, ConnectionError) and not got_response[0]:
                    continue  # drain the next pooled socket (or go fresh)
                raise

    async def _wrap_fresh(self, sock: socket.socket, key: tuple[str, int]):
        """Transport for a just-connected socket: plain pass-through, or the
        TLS fast-path handshake resuming the parent's cached session. The
        session learned from a successful handshake (resumed or not — a full
        handshake re-issues a fresh ticket) replaces the cache entry, so a
        parent that restarted and rejected the old session heals on the very
        next connect."""
        if self._tls is None:
            return AsyncPlainTransport(sock)
        from dragonfly2_tpu_torch.daemon import metrics

        try:
            t = await AsyncTlsTransport.connect(
                sock, self._tls.client_ctx, session=self._tls.sessions.get(key)
            )
        except (_ssl.SSLError, ConnectionError, OSError, asyncio.TimeoutError) as e:
            metrics.PIECE_TLS_HANDSHAKE_FAILURES_TOTAL.inc()
            sock.close()
            # a refused handshake is the parent's problem (bad cert, cipher
            # mismatch, not actually speaking TLS): surface as the IOError the
            # piece retry path charges to the parent, never replay silently
            raise IOError(f"TLS handshake with {key[0]}:{key[1]} failed: {e!r}") from e
        metrics.PIECE_TLS_HANDSHAKES_TOTAL.inc(
            resumed="true" if t.session_reused else "false"
        )
        self._tls.sessions.put(key, t.session)
        return t

    def _fresh_socket(self, ip: str) -> socket.socket:
        """Non-blocking TCP socket in the family `ip` needs (':' marks an
        IPv6 literal — parents advertise addresses, not names). A stack that
        cannot create the family at all raises AddressFamilyError so the
        caller falls back to aiohttp instead of blaming the parent."""
        family = socket.AF_INET6 if ":" in ip else socket.AF_INET
        try:
            sock = socket.socket(family, socket.SOCK_STREAM)
        except OSError as e:
            if e.errno in _AF_ERRNOS:
                raise AddressFamilyError(
                    f"address family for {ip!r} unsupported on this host"
                ) from e
            raise
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._tls is not None:
            # deeper kernel pipeline under TLS: the parent encrypts ahead
            # into these buffers while this side's single drain catches up
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        return sock

    async def _request(
        self,
        transport,
        key: tuple[str, int],
        ip: str,
        port: int,
        path_qs: str,
        range_header: str,
        view: memoryview,
        on_chunk: "Callable[[int], None] | None",
        fault_point: str | None,
        got_response: list,
        timeout: float,
    ) -> None:
        length = len(view)
        host = f"[{ip}]" if ":" in ip else ip
        # piece bodies join the caller's trace: the standard traceparent
        # header carries the context (and its sampled flag) to the parent's
        # upload server, the same way the rpc frame's "t" key does for
        # control RPCs. No active trace → no header, no cost beyond the get.
        from dragonfly2_tpu_torch.observability.tracing import Tracer

        ctx = Tracer.current_context()
        trace_line = f"traceparent: {ctx.traceparent()}\r\n" if ctx is not None else ""
        req = (
            f"GET {path_qs} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Range: {range_header}\r\n"
            f"{trace_line}"
            "Connection: keep-alive\r\n"
            "\r\n"
        ).encode("ascii")
        await transport.sendall(req)

        head = bytearray()
        while True:
            end = head.find(b"\r\n\r\n")
            if end >= 0:
                break
            if len(head) > _MAX_HEADER_BYTES:
                raise IOError("response headers too large")
            chunk = await transport.recv(8192)
            if not chunk:
                raise ConnectionError("connection closed before response headers")
            got_response[0] = True  # past here, ConnectionErrors are not replayed
            head += chunk
        header_blob, leftover = head[:end].decode("latin-1"), head[end + 4 :]
        lines = header_blob.split("\r\n")
        parts = lines[0].split(" ", 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise IOError(f"malformed status line {lines[0]!r}")
        status = int(parts[1])
        headers = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        if status != 206:
            # no pooling across error responses — the error body would have
            # to be drained to reuse the connection, and error paths are not
            # worth a keep-alive optimization
            transport.close()
            raise IOError(f"parent returned HTTP {status}")
        clen = headers.get("content-length")
        if clen is None or not clen.isdigit() or int(clen) != length:
            transport.close()
            raise IOError(f"unexpected Content-Length {clen!r} (want {length})")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            transport.close()
            raise IOError("chunked range response unsupported")

        off = len(leftover)
        if off > length:
            transport.close()
            raise IOError("server sent more body bytes than Content-Length")
        view[:off] = leftover
        faulted = fault_point is None or faultline.ACTIVE is None
        if off:
            if not faulted:
                self._fault_first_body(fault_point, view, 0, off, transport)
                faulted = True
            if on_chunk is not None:
                on_chunk(off)
        if transport.tls and length - off >= _TLS_THREADED_BODY_BYTES:
            # big TLS bodies drain on a worker thread: recv + BIO copy +
            # per-record decrypt run GIL-released off the loop, so the hash
            # pump and store writes overlap the crypto on another core (the
            # loop-thread recv_into shape time-sliced all three). Faults and
            # on_chunk fire from the worker — both are single-producer-safe,
            # and a fault's IOError/close propagates exactly like the
            # loop-side path's.
            def _on_bytes(prev: int, new: int) -> None:
                nonlocal faulted
                if not faulted:
                    self._fault_first_body(fault_point, view, prev, new, transport)
                    faulted = True
                if on_chunk is not None:
                    on_chunk(new)

            async with self._drain_sem:
                # the idle bound (not the full piece timeout) arms the
                # worker's socket timeout: a stalled parent releases the
                # semaphore in seconds, and the worker thread can never
                # outlive its caller by more than the idle window
                off = await transport.recv_body_into(
                    view, off, on_bytes=_on_bytes,
                    timeout=min(timeout, _TLS_DRAIN_IDLE_TIMEOUT_S),
                )
        while off < length:
            n = await transport.recv_into(view[off:])
            if n == 0:
                transport.close()
                raise IOError(f"connection closed at byte {off}/{length}")
            if not faulted:
                self._fault_first_body(fault_point, view, off, off + n, transport)
                faulted = True
            off += n
            if on_chunk is not None:
                on_chunk(off)
        if headers.get("connection", "").lower() == "close":
            transport.close()
        else:
            self._checkin(key, transport)

    @staticmethod
    def _fault_first_body(
        point: str, view: memoryview, start: int, end: int, transport
    ) -> None:
        """Apply one seeded truncate/corrupt draw to the first body bytes —
        the pipeline's read point. Truncation becomes the short-body close a
        real mid-transfer disconnect produces; corruption is written back
        into the buffer so hash-on-receive digests the damaged bytes and the
        digest check rejects them."""
        data = bytes(view[start:end])
        mutated = faultline.ACTIVE.mutate(point, data)
        if len(mutated) != len(data):  # truncate: simulate the dead socket
            view[start : start + len(mutated)] = mutated
            transport.close()
            raise IOError(
                f"connection closed at byte {start + len(mutated)}/{len(view)}"
                " (injected truncation)"
            )
        if mutated is not data:
            view[start:end] = mutated
