"""Data-plane TLS fast path: cipher autoselection, bulk-BIO transports,
session resumption, and an honest kTLS probe. The port of
dragonfly2_tpu/security/transport.py, whole: either package's piece client
handshakes with the other's piece server, and a session one issued resumes
in the other.

The mTLS plane's security posture is manager-CA leaf certs with client certs
required. Measured through asyncio's SSL streams on the reference's CPU host,
it cost about half the piece throughput, and almost none of that was the
cipher itself: AES-GCM and chacha20-poly1305 both run at ~2 GB/s per core
through OpenSSL. The cost was the TRANSPORT SHAPE:

  * ``SSLSocket.recv_into`` returns at most ONE 16 KiB TLS record per call,
    and with a socket BIO (read_ahead off) each record costs ~2 small read
    syscalls — >1000 syscall+GIL round-trips per 16 MiB piece.
  * The send side is worse: ``SSL_write`` over a socket BIO emits one
    ``send(2)`` per record, and with TCP_NODELAY each record goes out as its
    own segment.
  * asyncio's SSLProtocol avoids the syscall storm (it uses memory BIOs) but
    pays per-chunk buffering/copies through the stream reader.

This module keeps the crypto and drops the shape: ``AsyncTlsTransport`` runs
an ``ssl.MemoryBIO`` pair over a plain non-blocking socket — ciphertext moves
in CT_CHUNK bulk reads/writes (tens of syscalls per piece, not thousands),
and ``SSLObject.read(n, buffer)`` decrypts STRAIGHT INTO the caller's buffer
(the piece pipeline's pooled memoryview), so the only userspace copies left
are the ones AEAD itself requires. The same object speaks both sides, so the
tests' servers run the shipping client path's code.

Cipher policy: on hosts without AES-NI, chacha20-poly1305 beats software AES
~3x; on AES-NI hosts AES-GCM wins. A context offers the policy's suite first
and the other after it (``apply_data_policy``), so hosts that picked
differently still share one. ``cipher_policy()`` reads /proc/cpuinfo's
``aes`` flag; ``measure_cipher_rates()`` is the one-shot microbench (an
in-memory TLS pair per cipher) composition roots run at context build when
certs are in hand — the measurement, not the flag, is authoritative.

Data-plane contexts pin TLS 1.2 deliberately:
  * cipher choice is controllable (`set_ciphers` does not govern 1.3 suites),
  * session objects are reusable at connect time — 1.3 tickets arrive
    post-handshake, useless to a pooled-socket client that must decide
    resumption BEFORE the ClientHello.
Under TLS 1.2 both suites ride ECDHE with the same cluster-CA certs, so the
trust model is unchanged. Control-plane RPC keeps its defaults (1.3).

kTLS: offloading the record layer to the kernel would restore sendfile on
the upload path. ``probe_ktls()`` checks for BOTH prerequisites (a kernel
with the ``tls`` ULP, a Python/OpenSSL with ``OP_ENABLE_KTLS``) at runtime
and reports exactly what it found; it is reported, never acted on, and
nothing downstream synthesizes a throughput number from it.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import ssl
import time
from typing import Optional

logger = logging.getLogger(__name__)

# OpenSSL cipher strings for the two data-plane policies (TLS <= 1.2 names;
# the contexts pin 1.2 so these are the suites that actually negotiate)
CIPHER_STRINGS = {
    "aes-gcm": "ECDHE+AESGCM",
    "chacha20": "ECDHE+CHACHA20",
}

# bulk ciphertext transfer unit: ~16 records per syscall amortizes the
# kernel round-trip without holding >1 MiB of ciphertext per connection
CT_CHUNK = 256 << 10

# TLS 1.2 max plaintext record is 16 KiB; senders that batch in multiples of
# this fill records exactly instead of emitting a runt record per chunk
TLS_RECORD_BYTES = 16 << 10


def detect_aes_accel() -> Optional[bool]:
    """Whether the CPU advertises AES acceleration (the ``aes`` cpuinfo
    flag). None when /proc/cpuinfo is unreadable (non-Linux) — callers fall
    back to the microbench or the aes-gcm default."""
    try:
        with open("/proc/cpuinfo", "r", encoding="ascii", errors="replace") as f:
            for line in f:
                if line.startswith("flags") or line.startswith("Features"):
                    return " aes " in f" {line.strip()} " or line.rstrip().endswith(" aes")
            return False
    except OSError:
        return None


def cipher_policy(force: str | None = None) -> str:
    """The data-plane cipher policy for this host: ``aes-gcm`` or
    ``chacha20``. Order: explicit `force` (or DRAGONFLY_PIECE_CIPHER env) →
    /proc/cpuinfo AES flag → aes-gcm default. Composition roots that hold
    certs refine this with measure_cipher_rates() (the microbench beats the
    flag when they disagree)."""
    choice = force or os.environ.get("DRAGONFLY_PIECE_CIPHER", "")
    if choice:
        if choice not in CIPHER_STRINGS:
            raise ValueError(
                f"unknown piece cipher {choice!r} (want one of {sorted(CIPHER_STRINGS)})"
            )
        return choice
    accel = detect_aes_accel()
    if accel is False:
        return "chacha20"
    return "aes-gcm"


def apply_data_policy(ctx: ssl.SSLContext, policy: str) -> ssl.SSLContext:
    """Pin a context to the data-plane posture: TLS 1.2, the policy's cipher
    first and the other AEAD suite after it, the server's order winning. See
    the module docstring for why 1.2 (cipher control + connect-time-reusable
    sessions); the cert/CA trust chain is untouched.

    The reference pins the policy's suite alone, so two hosts whose one-shot
    microbench picked differently (a host where the two rates sit close)
    share no suite and refuse each other's every handshake. Ordering instead
    of pinning keeps each host's pick wherever it serves, and a reference
    peer pinned to either suite still handshakes with this one."""
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.maximum_version = ssl.TLSVersion.TLSv1_2
    others = [s for p, s in CIPHER_STRINGS.items() if p != policy]
    ctx.set_ciphers(":".join([CIPHER_STRINGS[policy], *others]))
    ctx.options |= ssl.OP_CIPHER_SERVER_PREFERENCE
    return ctx


def data_server_ssl_context(
    cert_path: str, key_path: str, ca_path: str | None = None, *, policy: str | None = None
) -> ssl.SSLContext:
    """Server context for the piece upload plane: mTLS when ca_path is given
    (client certs required), cipher per policy."""
    from dragonfly2_tpu_torch.security.ca import server_ssl_context

    return apply_data_policy(
        server_ssl_context(cert_path, key_path, ca_path), policy or cipher_policy()
    )


def data_client_ssl_context(
    ca_path: str, cert_path: str | None = None, key_path: str | None = None,
    *, policy: str | None = None,
) -> ssl.SSLContext:
    """Client context for piece fetches, pinned to the cluster CA."""
    from dragonfly2_tpu_torch.security.ca import client_ssl_context

    return apply_data_policy(
        client_ssl_context(ca_path, cert_path, key_path), policy or cipher_policy()
    )


def probe_ktls() -> dict:
    """Runtime kTLS availability: BOTH the kernel ULP and Python/OpenSSL
    support must exist for SSL_sendfile to be a real option. Returns
    {"available": bool, "reason": str} — a null-report contract: when
    unavailable the reason says exactly which prerequisite is missing, and
    nothing downstream may synthesize a throughput number from it."""
    if not hasattr(ssl, "OP_ENABLE_KTLS"):
        return {
            "available": False,
            "reason": "ssl module lacks OP_ENABLE_KTLS (needs Python 3.12+/OpenSSL 3)",
        }
    # kernel side: attaching the tls ULP to a TCP socket is the definitive
    # probe (the module may be absent or the kernel predates it — 4.13+).
    # tls_init requires TCP_ESTABLISHED (an unconnected socket gets ENOTCONN
    # even on capable kernels — a false negative), so probe over a loopback-
    # connected pair.
    tcp_ulp = getattr(socket, "TCP_ULP", 31)  # TCP_ULP is 31 since Linux 4.13
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    csock = asock = None
    try:
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        csock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        csock.connect(lsock.getsockname())
        asock, _ = lsock.accept()
        try:
            csock.setsockopt(socket.IPPROTO_TCP, tcp_ulp, b"tls")
        except OSError as e:
            return {
                "available": False,
                "reason": f"kernel tls ULP unavailable ({e.strerror})",
            }
    except OSError as e:
        # loopback itself unusable (sandbox): can't tell — report honestly
        return {"available": False, "reason": f"kTLS probe setup failed ({e.strerror})"}
    finally:
        for s in (csock, asock, lsock):
            if s is not None:
                s.close()
    return {"available": True, "reason": "kernel tls ULP + OP_ENABLE_KTLS present"}


def measure_cipher_rates(
    cert_path: str, key_path: str, ca_path: str, *, mb: int = 8
) -> dict:
    """One-shot cipher microbench: an in-memory TLS pair per policy (wrap_bio,
    no sockets, no threads), timing encrypt+decrypt of `mb` MiB in 256 KiB
    batches. Returns {"aes-gcm": MB/s, "chacha20": MB/s, "picked": policy}.
    ~10 ms total — composition roots run it once at data-plane context build
    and let the measurement override the cpuinfo prior."""
    payload = os.urandom(256 << 10)
    rates: dict[str, float] = {}
    for policy in CIPHER_STRINGS:
        srv = data_server_ssl_context(cert_path, key_path, ca_path, policy=policy)
        cli = data_client_ssl_context(ca_path, cert_path, key_path, policy=policy)
        s_in, s_out = ssl.MemoryBIO(), ssl.MemoryBIO()
        c_in, c_out = ssl.MemoryBIO(), ssl.MemoryBIO()
        so = srv.wrap_bio(s_in, s_out, server_side=True)
        co = cli.wrap_bio(c_in, c_out, server_hostname=None)
        for _ in range(8):  # in-memory handshake pump converges in a few laps
            for obj in (co, so):
                try:
                    obj.do_handshake()
                except ssl.SSLWantReadError:
                    pass
                s_in.write(c_out.read())
                c_in.write(s_out.read())
        sink = bytearray(len(payload))
        reps = (mb << 20) // len(payload)
        t0 = time.perf_counter()
        for _ in range(reps):
            so.write(payload)
            c_in.write(s_out.read())
            got = 0
            while got < len(payload):
                got += co.read(len(payload) - got, memoryview(sink)[got:])
        dt = time.perf_counter() - t0
        rates[policy] = round(reps * len(payload) / dt / (1 << 20), 1)
    rates["picked"] = max(("aes-gcm", "chacha20"), key=lambda p: rates[p])
    return rates


class TlsSessionCache:
    """Client-side TLS session store keyed per parent (ip, port): the pooled-
    socket layer in daemon/rawrange.py hands the cached session to the next
    fresh connect so reconnect storms (and every per-piece parent connection
    after the first) resume with an abbreviated handshake instead of a full
    ECDHE + cert exchange. One session per key — the newest wins (tickets are
    single-issuer per server context, and stale sessions simply fall back to
    a full handshake, so eviction can never break a connect)."""

    def __init__(self, *, max_entries: int = 256):
        from collections import OrderedDict

        self._sessions: "OrderedDict[tuple[str, int], ssl.SSLSession]" = OrderedDict()
        self._max = max_entries
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple[str, int]) -> Optional[ssl.SSLSession]:
        sess = self._sessions.get(key)
        if sess is None:
            self.misses += 1
            return None
        self._sessions.move_to_end(key)
        self.hits += 1
        return sess

    def put(self, key: tuple[str, int], session: Optional[ssl.SSLSession]) -> None:
        if session is None:
            return
        self._sessions[key] = session
        self._sessions.move_to_end(key)
        if len(self._sessions) > self._max:
            self._sessions.popitem(last=False)

    def __len__(self) -> int:
        return len(self._sessions)


class AsyncPlainTransport:
    """The no-TLS side of the transport seam: thin delegation to the loop's
    sock_* fast paths so daemon/rawrange.py speaks one API either way (the
    extra method call costs nanoseconds against a 64 KiB recv)."""

    __slots__ = ("_sock", "_loop")
    tls = False

    def __init__(self, sock: socket.socket, loop=None):
        self._sock = sock
        self._loop = loop or asyncio.get_running_loop()

    async def recv(self, n: int) -> bytes:
        return await self._loop.sock_recv(self._sock, n)

    async def recv_into(self, view: memoryview) -> int:
        return await self._loop.sock_recv_into(self._sock, view)

    async def sendall(self, data) -> None:
        await self._loop.sock_sendall(self._sock, data)

    def close(self) -> None:
        self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()


class AsyncTlsTransport:
    """TLS over a non-blocking socket via a MemoryBIO pair, tuned for the
    piece path (see module docstring): bulk CT_CHUNK ciphertext moves,
    decrypt directly into caller buffers, resumable sessions.

    Built by the async classmethods (`connect` / `accept` perform the
    handshake); all I/O methods run on the event loop. A clean TLS shutdown
    or a raw EOF both surface as recv()==0 — the HTTP framing above carries
    its own length checks, so a truncation is caught there either way
    (matching the plain transport's semantics, which the chaos suite pins).
    """

    __slots__ = (
        "_sock", "_loop", "_obj", "_inc", "_out", "_ct", "_ctv", "session_reused",
        "_worker_busy",
    )
    tls = True

    def __init__(self, sock: socket.socket, obj, inc, out, loop):
        self._sock = sock
        self._loop = loop
        self._obj = obj
        self._inc = inc
        self._out = out
        self._ct = bytearray(CT_CHUNK)
        self._ctv = memoryview(self._ct)
        self.session_reused = False
        # True while a recv_body_into/send_file_range worker thread owns the
        # SSLObject; close() must not touch OpenSSL state while it is set
        self._worker_busy = False

    # ---- construction ----

    @classmethod
    async def connect(
        cls,
        sock: socket.socket,
        ctx: ssl.SSLContext,
        *,
        session: Optional[ssl.SSLSession] = None,
        server_hostname: str | None = None,
        handshake_timeout: float = 10.0,
    ) -> "AsyncTlsTransport":
        """Client handshake over an already-connected non-blocking socket,
        optionally resuming `session` (TLS 1.2 abbreviated handshake)."""
        loop = asyncio.get_running_loop()
        inc, out = ssl.MemoryBIO(), ssl.MemoryBIO()
        obj = ctx.wrap_bio(
            inc, out, server_side=False, server_hostname=server_hostname, session=session
        )
        t = cls(sock, obj, inc, out, loop)
        await asyncio.wait_for(t._handshake(), handshake_timeout)
        return t

    @classmethod
    async def accept(
        cls, sock: socket.socket, ctx: ssl.SSLContext, *, handshake_timeout: float = 10.0
    ) -> "AsyncTlsTransport":
        """Server-side handshake. This IS the shipping serve path: the
        upload server's raw mTLS listener (daemon/upload.py _tls_conn_loop)
        accepts every production piece connection through here, alongside
        the bench harnesses and tests."""
        loop = asyncio.get_running_loop()
        inc, out = ssl.MemoryBIO(), ssl.MemoryBIO()
        obj = ctx.wrap_bio(inc, out, server_side=True)
        t = cls(sock, obj, inc, out, loop)
        await asyncio.wait_for(t._handshake(), handshake_timeout)
        return t

    async def _handshake(self) -> None:
        while True:
            try:
                self._obj.do_handshake()
                break
            except ssl.SSLWantReadError:
                await self._flush_out()
                if not await self._fill():
                    raise ConnectionError("peer closed during TLS handshake")
            except ssl.SSLWantWriteError:  # pragma: no cover — memory BIOs grow
                await self._flush_out()
        await self._flush_out()
        self.session_reused = bool(self._obj.session_reused)

    # ---- ciphertext plumbing ----

    async def _flush_out(self) -> None:
        data = self._out.read()
        if data:
            await self._loop.sock_sendall(self._sock, data)

    async def _fill(self) -> bool:
        """One bulk ciphertext read into the incoming BIO; False on EOF."""
        n = await self._loop.sock_recv_into(self._sock, self._ctv)
        if n == 0:
            self._inc.write_eof()
            return False
        self._inc.write(self._ctv[:n])
        return True

    # ---- data path ----

    async def recv_into(self, view: memoryview) -> int:
        """Decrypt up to len(view) plaintext bytes directly into `view`.
        Returns 0 on clean TLS close or raw EOF."""
        while True:
            try:
                return self._obj.read(len(view), view)
            except ssl.SSLWantReadError:
                pass
            except ssl.SSLZeroReturnError:
                return 0
            except ssl.SSLEOFError:
                return 0  # raw EOF mid-record: framing above reports the short body
            if not await self._fill():
                # EOF without close_notify — common from impatient HTTP peers;
                # report 0 and let the length-checked framing above decide
                return 0

    async def recv(self, n: int) -> bytes:
        buf = bytearray(n)
        got = await self.recv_into(memoryview(buf))
        del buf[got:]
        return bytes(buf)

    async def recv_body_into(
        self,
        view: memoryview,
        off: int,
        *,
        on_bytes=None,
        timeout: float | None = None,
    ) -> int:
        """Fill view[off:] to the end on a WORKER THREAD (blocking socket):
        the recv syscalls, the BIO copy, and the per-record SSL_read decrypts
        all run with the GIL released off the event loop, so the piece
        pipeline's hash shard and store writes overlap the crypto on another
        core instead of time-slicing one loop thread. This is the big-body
        fast path — per-chunk readiness awaits (recv_into) only pay off for
        small reads like response headers.

        `on_bytes(prev_off, new_off)` fires from the worker thread, COALESCED
        to ~1 MiB strides (one Python callback per record would re-serialize
        the loop this path exists to keep in C; HashPump.feed batches at the
        same granularity anyway). Both known consumers — the hash pump and
        the faultline first-body hook — are thread-safe single-producer
        calls. Cancellation contract: the caller's timeout path closes the
        transport (rawrange's failure handler already does), whose
        shutdown(2) unblocks a worker mid-recv immediately; `timeout`
        additionally arms the socket timeout as a belt-and-braces
        self-unblock — it bounds each recv call (IDLE time, not total drain
        time), so a parent that stalls mid-body fails the drain within
        `timeout` seconds even if no close ever arrives. Raises IOError on
        EOF/timeout short of the full body."""
        loop = asyncio.get_running_loop()
        sock = self._sock
        obj = self._obj
        inc = self._inc
        ctv = self._ctv
        total = len(view)

        cb_stride = 1 << 20

        def work() -> int:
            o = off
            reported = off  # high-water mark already handed to on_bytes
            # bound hot names once: this loop runs per 16 KiB record — for a
            # 16 MiB piece that is ~1k iterations whose Python overhead is
            # GIL-held time stolen from every other thread
            obj_read = obj.read
            want_read = ssl.SSLWantReadError
            try:
                sock.setblocking(True)
                if timeout is not None:
                    sock.settimeout(timeout)
                while o < total:
                    try:
                        n = obj_read(total - o, view[o:])
                    except want_read:
                        n = 0
                    except (ssl.SSLZeroReturnError, ssl.SSLEOFError):
                        raise IOError(f"connection closed at byte {o}/{total}")
                    if n:
                        o += n
                        if on_bytes is not None and (
                            o - reported >= cb_stride or o >= total
                        ):
                            on_bytes(reported, o)
                            reported = o
                        continue
                    try:
                        r = sock.recv_into(ctv)
                    except socket.timeout:
                        raise IOError(f"TLS body read timed out at byte {o}/{total}")
                    except OSError as e:
                        # loop-side close() during a caller timeout lands here
                        raise IOError(f"connection lost at byte {o}/{total}: {e}")
                    if r == 0:
                        raise IOError(f"connection closed at byte {o}/{total}")
                    inc.write(ctv[:r])
                return o
            finally:
                self._worker_busy = False
                try:
                    sock.setblocking(False)
                except OSError:
                    pass  # closed under us mid-drain: the error already raised

        self._worker_busy = True  # set before the hop: no await in between
        fut = loop.run_in_executor(None, work)
        # a cancelled caller (piece timeout) abandons the future; the close()
        # that follows unblocks the worker, whose IOError must not spam the
        # loop's "exception was never retrieved" log
        fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        return await fut

    async def sendall(self, data) -> None:
        """Encrypt and send, batching plaintext through the BIO in record-
        aligned chunks so big bodies neither balloon the outgoing BIO nor
        emit runt records."""
        mv = memoryview(data)
        step = CT_CHUNK  # multiple of TLS_RECORD_BYTES
        if len(mv) <= step:
            self._obj.write(mv)
            await self._flush_out()
            return
        for off in range(0, len(mv), step):
            self._obj.write(mv[off : off + step])
            await self._flush_out()

    async def send_file_range(
        self,
        path: str,
        offset: int,
        length: int,
        *,
        head: bytes = b"",
        chunk_bytes: int = 64 * TLS_RECORD_BYTES,
        timeout: float | None = None,
    ) -> None:
        """Serve-side mirror of recv_body_into: stream `length` bytes of the
        file at `path` (from `offset`) in ONE worker-thread call — preadv
        into a single reused record-aligned buffer, encrypt through the BIO,
        push ciphertext with big blocking sendalls. The whole
        preadv+SSL_write+send chain runs GIL-released C, so the serving loop
        thread stays free for other connections; this is what replaces
        sendfile under TLS (kTLS would let sendfile itself survive — probed,
        unavailable on the hosts measured). The worker owns the fd (opened and
        closed inside the thread), so caller cancellation can never race a
        close against an in-flight preadv; a cancelled caller just closes
        the SOCKET, which fails the worker's next sendall immediately.

        `head` (response headers) rides the first encrypted flush so the
        body doesn't wait an extra round trip. Raises IOError on a truncated
        file; ConnectionError/OSError surface from a gone peer."""
        loop = asyncio.get_running_loop()
        sock = self._sock
        obj = self._obj
        out = self._out

        def work() -> None:
            try:
                buf = bytearray(chunk_bytes)
                mv = memoryview(buf)
                fd = os.open(path, os.O_RDONLY)
                try:
                    sock.setblocking(True)
                    if timeout is not None:
                        sock.settimeout(timeout)
                    if head:
                        obj.write(head)
                    remaining = length
                    off = offset
                    while remaining > 0:
                        want = min(chunk_bytes, remaining)
                        got = 0
                        while got < want:
                            n = os.preadv(fd, [mv[got:want]], off + got)
                            if n == 0:
                                raise IOError(f"{path} truncated at {off + got}")
                            got += n
                        obj.write(mv[:got])
                        sock.sendall(out.read())
                        off += got
                        remaining -= got
                    if length == 0 and head:
                        sock.sendall(out.read())
                finally:
                    os.close(fd)
                    try:
                        sock.setblocking(False)
                    except OSError:
                        pass  # closed under us: the send error already raised
            finally:
                # outermost so even a failed os.open releases the flag
                self._worker_busy = False

        self._worker_busy = True  # set before the hop: no await in between
        fut = loop.run_in_executor(None, work)
        # cancelled callers abandon the future; the socket close that
        # follows unblocks the worker, whose error must not hit the loop's
        # "exception was never retrieved" log
        fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        await fut

    # ---- introspection / lifecycle ----

    @property
    def session(self) -> Optional[ssl.SSLSession]:
        return self._obj.session

    def cipher(self):
        return self._obj.cipher()

    def close(self) -> None:
        # best-effort close_notify: encrypt the alert if the state machine
        # allows and push it with a non-blocking send; never block a close.
        # NEVER while a worker thread owns the SSLObject though — OpenSSL
        # objects are not thread-safe and the worker may be inside read()/
        # write() with the GIL released; there the raw shutdown below is the
        # whole close (the peer sees an abortive close, which the framing's
        # length checks already treat as truncation).
        if not self._worker_busy:
            try:
                self._obj.unwrap()
            except (ssl.SSLError, OSError, ValueError):
                pass
            try:
                pending = self._out.read()
                if pending:
                    self._sock.send(pending)
            except OSError:
                pass
        # shutdown(2) before close: close() alone does NOT wake another
        # thread blocked in recv(2)/send(2) on this fd — shutdown does,
        # immediately, on both the drain and serve worker paths
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()


class DataPlaneTls:
    """Everything the daemon's piece plane needs to speak TLS, bundled the
    way the engine threads it through (UploadServer ← server_ctx, shared
    RawRangeClient ← client_ctx + sessions, conductor ← url scheme):

        tls = DataPlaneTls.from_paths(cert, key, ca)
        PeerEngine(..., data_tls=tls)

    The cipher policy is resolved once at build: cpuinfo prior, refined by
    the one-shot microbench when `microbench=True` (default — certs are in
    hand here, and the measurement is authoritative). kTLS is probed and the
    result carried for observability; it is never silently acted on.
    """

    def __init__(
        self,
        *,
        server_ctx: ssl.SSLContext,
        client_ctx: ssl.SSLContext,
        policy: str,
        sessions: TlsSessionCache | None = None,
        ktls: dict | None = None,
        cipher_rates: dict | None = None,
    ):
        self.server_ctx = server_ctx
        self.client_ctx = client_ctx
        self.policy = policy
        self.sessions = sessions or TlsSessionCache()
        self.ktls = ktls or probe_ktls()
        self.cipher_rates = cipher_rates
        self.scheme = "https"

    @classmethod
    def from_paths(
        cls,
        cert_path: str,
        key_path: str,
        ca_path: str,
        *,
        policy: str | None = None,
        microbench: bool = True,
    ) -> "DataPlaneTls":
        rates = None
        picked = policy
        if picked is None:
            picked = cipher_policy()
            if microbench:
                try:
                    rates = measure_cipher_rates(cert_path, key_path, ca_path, mb=4)
                    if rates["picked"] != picked:
                        logger.info(
                            "cipher microbench overrides cpuinfo prior: %s -> %s (%s)",
                            picked, rates["picked"],
                            {k: v for k, v in rates.items() if k != "picked"},
                        )
                    picked = rates["picked"]
                except (ssl.SSLError, OSError) as e:
                    logger.warning("cipher microbench failed, keeping %s: %r", picked, e)
        return cls(
            server_ctx=data_server_ssl_context(cert_path, key_path, ca_path, policy=picked),
            client_ctx=data_client_ssl_context(ca_path, cert_path, key_path, policy=picked),
            policy=picked,
            ktls=probe_ktls(),
            cipher_rates=rates,
        )
