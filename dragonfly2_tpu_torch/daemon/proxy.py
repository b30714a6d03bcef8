"""HTTP proxy + registry mirror: route downloads through the P2P engine; the
port of dragonfly2_tpu/daemon/proxy.py, with the same HTTP behaviour
(routes, framing, the ``X-Dragonfly-Via`` header).

Parity with reference client/daemon/proxy (proxy.go:288 ServeHTTP,
:527-535 mirrorRegistry, :632-635 shouldUseDragonflyForMirror,
proxy_manager.go:42-52 rules) and client/daemon/transport
(transport.go:58-119 RoundTrip → StartStreamTask): an explicit-proxy server
that converts matching GET requests into P2P stream tasks, passes everything
else through, and doubles as a registry mirror for container-image
acceleration: origin-form requests are rewritten onto a configured upstream
registry, with immutable blob fetches (`/v2/<name>/blobs/sha256:...`) riding
the P2P engine keyed by digest.

HTTPS interception (ref cert.go + proxy_sni.go): CONNECT targets matching the
hijack host patterns are MITM'd — the proxy completes the client's TLS
handshake with a CA-forged leaf for the target host and routes the decrypted
requests through the same rule engine, so HTTPS registries/origins ride P2P
too. Non-matching CONNECTs get a blind tunnel. The companion SniProxy accepts
raw TLS (no CONNECT), peeks the ClientHello SNI, and either hijacks the same
way or splices a byte tunnel to the named upstream.

Raw asyncio (not aiohttp.web) because a proxy must handle CONNECT and
absolute-form request targets, which web frameworks do not model.

Two departures from the reference, both in how a connection is handled and
neither on the wire: the CONNECT path upgrades its accepted stream with
``StreamWriter.start_tls``, and the SNI proxy's ClientHello peek backs off
instead of spinning while a partial hello sits in the kernel buffer
(``SniProxy._peek_sni``).
"""

from __future__ import annotations

import asyncio
import logging
import re
import socket
from dataclasses import dataclass, field
from typing import Callable, Optional
from urllib.parse import urlsplit

import aiohttp

logger = logging.getLogger(__name__)

_HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "proxy-connection", "te", "trailers", "transfer-encoding", "upgrade",
}
_BLOB_RE = re.compile(r"^/v2/.+/blobs/(sha256:[0-9a-f]{64})$")


async def splice(
    client_r: asyncio.StreamReader, client_w: asyncio.StreamWriter,
    upstream_r: asyncio.StreamReader, upstream_w: asyncio.StreamWriter,
) -> None:
    """Bidirectional byte pump between two stream pairs (blind tunnel)."""

    async def pipe(src: asyncio.StreamReader, dst: asyncio.StreamWriter) -> None:
        try:
            while True:
                data = await src.read(64 << 10)
                if not data:
                    break
                dst.write(data)
                await dst.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                dst.close()
            except (OSError, RuntimeError):
                pass  # peer already gone / loop tearing down

    await asyncio.gather(pipe(client_r, upstream_w), pipe(upstream_r, client_w))


@dataclass
class ProxyRule:
    """One routing rule, first match wins (ref proxy_manager.go rules).

    regex matches the full request URL. use_p2p routes through the engine;
    direct forces pass-through; redirect rewrites scheme://host before
    routing (ref proxy rule Redirect field)."""

    regex: str
    use_p2p: bool = True
    direct: bool = False
    redirect: str = ""
    filtered_query_params: tuple = ()

    def __post_init__(self):
        self._re = re.compile(self.regex)

    def matches(self, url: str) -> bool:
        return self._re.search(url) is not None


@dataclass
class RegistryMirrorConfig:
    """Registry-mirror target (ref config registryMirror.url)."""

    base_url: str  # e.g. "http://127.0.0.1:5000"
    use_p2p_for_blobs: bool = True

    def __post_init__(self):
        # a trailing slash would break the prefix-strip in _decide and make
        # _BLOB_RE silently never match
        self.base_url = self.base_url.rstrip("/")


@dataclass
class HttpsHijack:
    """MITM config (ref proxy config hijackHTTPS): forge leaf certs for hosts
    matching `hosts` regexes; everything else is blind-tunneled."""

    forger: "object"  # security.mitm.CertForger (untyped: optional dependency)
    hosts: tuple = (r".*",)

    def __post_init__(self):
        self._res = [re.compile(p) for p in self.hosts]

    def should(self, host: str) -> bool:
        return any(r.search(host) for r in self._res)


@dataclass
class ProxyConfig:
    rules: list[ProxyRule] = field(default_factory=list)
    registry_mirror: Optional[RegistryMirrorConfig] = None
    # requests below this size are not worth a scheduler round-trip; the
    # reference proxies everything matched, so default 0 keeps parity
    min_p2p_size: int = 0
    https_hijack: Optional[HttpsHijack] = None
    # outbound TLS trust for passthrough/back-to-source of intercepted
    # requests (None = system store)
    upstream_ssl: Optional["object"] = None  # ssl.SSLContext


class ProxyServer:
    """Explicit HTTP proxy + registry mirror in front of a PeerEngine."""

    def __init__(
        self,
        engine,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        config: ProxyConfig | None = None,
    ):
        self.engine = engine
        self.host = host
        self.port = port
        self.cfg = config or ProxyConfig()
        self._server: asyncio.AbstractServer | None = None
        self._session: aiohttp.ClientSession | None = None

    # ---- lifecycle ----

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("proxy listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._session is not None and not self._session.closed:
            await self._session.close()

    def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            connector = None
            if self.cfg.upstream_ssl is not None:
                connector = aiohttp.TCPConnector(ssl=self.cfg.upstream_ssl)
            self._session = aiohttp.ClientSession(auto_decompress=False, connector=connector)
        return self._session

    # ---- connection handling ----

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            request = await self._read_request(reader)
            if request is None:
                return
            method, target, headers = request
            if method == "CONNECT":
                await self._handle_connect(target, reader, writer)
                return
            if target.startswith("http://") or target.startswith("https://"):
                url = target
            elif self.cfg.registry_mirror is not None:
                # origin-form request: we are someone's registry mirror
                url = self.cfg.registry_mirror.base_url.rstrip("/") + target
            else:
                await self._respond_simple(writer, 400, b"proxy expects absolute-form URI")
                return
            await self._route(method, url, headers, reader, writer)
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("proxy connection failed")
            try:
                await self._respond_simple(writer, 502, b"proxy error")
            except (OSError, RuntimeError):
                pass  # client hung up before the error reply landed
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (OSError, RuntimeError):
                pass  # already closed by the peer

    @staticmethod
    async def _respond_simple(
        writer: asyncio.StreamWriter, status: int, body: bytes
    ) -> None:
        reason = {400: "Bad Request", 502: "Bad Gateway"}.get(status, "Error")
        writer.write(
            (
                f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Content-Type: text/plain\r\n"
                "Connection: close\r\n\r\n"
            ).encode("latin1")
            + body
        )
        await writer.drain()

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        """Parse request line + headers (body handling is per-route).

        Header names are lower-cased on parse: HTTP field names are
        case-insensitive and every later lookup (Range, Content-Length,
        Transfer-Encoding) relies on a canonical form."""
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _version = line.decode("latin1").rstrip("\r\n").split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            if b":" in hline:
                k, v = hline.decode("latin1").split(":", 1)
                headers[k.strip().lower()] = v.strip()
        return method, target, headers

    # ---- CONNECT tunnel ----

    async def _handle_connect(
        self, target: str, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        from dragonfly2_tpu_torch.daemon import metrics

        host, _, port_s = target.rpartition(":")  # rpartition: IPv6 literals
        if not host:
            host, port_s = target, ""
        host = host.strip("[]")
        try:
            port = int(port_s or 443)
        except ValueError:
            await self._respond_simple(writer, 400, b"bad CONNECT target")
            return
        hijack = self.cfg.https_hijack
        if hijack is not None and hijack.should(host):
            await self._handle_mitm(host, port, reader, writer)
            return
        try:
            upstream_r, upstream_w = await asyncio.open_connection(host, port)
        except OSError as e:
            await self._respond_simple(writer, 502, f"connect failed: {e}".encode())
            return
        metrics.PROXY_REQUEST_TOTAL.inc(via="tunnel")
        writer.write(b"HTTP/1.1 200 Connection established\r\n\r\n")
        await writer.drain()
        await splice(reader, writer, upstream_r, upstream_w)

    async def _handle_mitm(
        self, host: str, port: int,
        reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
    ) -> None:
        """Terminate the client's TLS with a forged leaf for `host` and route
        decrypted requests through the normal rule engine (ref cert.go MITM
        path). The tunnel is kept alive across requests when the response can
        be length-framed, so registry clients doing token-fetch + manifest on
        one CONNECT don't see an unexpected close; a close-delimited response
        ends the tunnel."""
        from dragonfly2_tpu_torch.daemon import metrics

        try:
            ctx = self.cfg.https_hijack.forger.context_for(host)
        except Exception:
            # forge failure must surface as a clean proxy error BEFORE the
            # client is told the tunnel is up and starts talking TLS
            logger.exception("leaf-cert forge failed for %s", host)
            await self._respond_simple(writer, 502, b"certificate forge failed")
            return
        writer.write(b"HTTP/1.1 200 Connection established\r\n\r\n")
        await writer.drain()
        try:
            # server-side TLS upgrade of the accepted stream: the stream came
            # from asyncio.start_server, so start_tls takes the server side
            await writer.start_tls(ctx)
        except (OSError, asyncio.IncompleteReadError) as e:
            logger.debug("MITM handshake with client failed for %s: %s", host, e)
            return
        netloc = host if port == 443 else f"{host}:{port}"
        await self._serve_tunnel_requests(
            reader,
            writer,
            # absolute-form inside the tunnel is unusual but legal
            lambda t: t if t.startswith(("http://", "https://")) else f"https://{netloc}{t}",
            via="mitm",
        )

    TUNNEL_IDLE_TIMEOUT_S = 75.0

    async def _serve_tunnel_requests(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        build_url,
        via: str,
    ) -> None:
        """Keep-alive request loop over a decrypted (MITM'd) tunnel, shared by
        the CONNECT-MITM and SNI-hijack paths. Length-framed responses keep
        the tunnel open so registry clients doing token-fetch + manifest on
        one connection don't see an unexpected close; a close-delimited
        response or an idle period ends it."""
        from dragonfly2_tpu_torch.daemon import metrics

        while True:
            try:
                request = await asyncio.wait_for(
                    self._read_request(reader), self.TUNNEL_IDLE_TIMEOUT_S
                )
            except asyncio.TimeoutError:
                return  # idle pooled connection: reclaim the task/fd
            if request is None:
                return
            metrics.PROXY_REQUEST_TOTAL.inc(via=via)
            method, req_target, headers = request
            client_wants_close = "close" in headers.get("connection", "").lower()
            alive = await self._route(
                method, build_url(req_target), headers, reader, writer,
                keepalive=not client_wants_close,
            )
            if not alive or client_wants_close:
                return

    # ---- routing ----

    def _decide(self, method: str, url: str) -> tuple[str, str]:
        """Return (route, effective_url); route in {p2p, passthrough}."""
        if method != "GET":
            return "passthrough", url
        mirror = self.cfg.registry_mirror
        if mirror is not None and url.startswith(mirror.base_url):
            path = url[len(mirror.base_url):]
            if mirror.use_p2p_for_blobs and _BLOB_RE.match(urlsplit(path).path):
                return "p2p", url
            return "passthrough", url
        for rule in self.cfg.rules:
            if rule.matches(url):
                if rule.redirect:
                    parts = urlsplit(url)
                    url = rule.redirect.rstrip("/") + parts.path + (
                        f"?{parts.query}" if parts.query else ""
                    )
                if rule.direct or not rule.use_p2p:
                    return "passthrough", url
                return "p2p", url
        return "passthrough", url

    async def _route(
        self,
        method: str,
        url: str,
        headers: dict[str, str],
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        keepalive: bool = False,
    ) -> bool:
        """Serve one request. Returns True iff the response was length-framed
        with keep-alive, so the caller may read another request from the same
        connection."""
        from dragonfly2_tpu_torch.daemon import metrics

        route, url = self._decide(method, url)
        # read any request body up front (it precedes routing: the p2p route
        # may fall back to passthrough, which must still forward the body)
        body = await self._read_body(reader, headers)
        fwd = {k: v for k, v in headers.items() if k not in _HOP_HEADERS}
        fwd.pop("host", None)
        if body:
            fwd["content-length"] = str(len(body))
        if route == "p2p" and "range" not in fwd:
            metrics.PROXY_REQUEST_TOTAL.inc(via="p2p")
            try:
                stream = await self._open_p2p(url, fwd)
            except Exception as e:
                # pass-through fallback (ref transport.go:170 WithCondition
                # fallback) — only possible before response bytes are written
                logger.warning("p2p route for %s failed (%s); falling back", url, e)
                stream = None
            if stream is not None:
                return await self._serve_p2p(stream, writer, keepalive=keepalive)
        metrics.PROXY_REQUEST_TOTAL.inc(via="passthrough")
        return await self._serve_passthrough(
            method, url, fwd, body, writer, keepalive=keepalive
        )

    @staticmethod
    async def _read_body(reader: asyncio.StreamReader, headers: dict[str, str]) -> bytes:
        """Consume the request body: Content-Length or chunked."""
        if "chunked" in headers.get("transfer-encoding", "").lower():
            chunks = []
            while True:
                size_line = await reader.readline()
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    # drain trailers until blank line
                    while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                        pass
                    return b"".join(chunks)
                chunks.append(await reader.readexactly(size))
                await reader.readexactly(2)  # CRLF after each chunk
        length = int(headers.get("content-length", 0) or 0)
        if length > 0:
            return await reader.readexactly(length)
        return b""

    async def _open_p2p(self, url: str, headers: dict[str, str]):
        """Start the stream task; raises (→ fallback) before any response
        bytes are written."""
        digest = ""
        m = _BLOB_RE.match(urlsplit(url).path)
        if m:
            digest = m.group(1)
        return await self.engine.stream_task(url, headers=headers, digest=digest)

    async def _serve_p2p(
        self, stream, writer: asyncio.StreamWriter, keepalive: bool = False
    ) -> bool:
        length, body = stream
        conn = b"keep-alive" if keepalive else b"close"
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            + f"Content-Length: {length}\r\n".encode()
            + b"Content-Type: application/octet-stream\r\n"
            + b"X-Dragonfly-Via: p2p\r\n"
            + b"Connection: " + conn + b"\r\n\r\n"
        )
        await writer.drain()
        # headers are out: any failure past this point aborts the connection
        # (no second response can be written)
        async for chunk in body:
            writer.write(chunk)
            await writer.drain()
        return keepalive

    async def _serve_passthrough(
        self,
        method: str,
        url: str,
        headers: dict[str, str],
        body: bytes,
        writer: asyncio.StreamWriter,
        keepalive: bool = False,
    ) -> bool:
        async with self._http().request(
            method, url, headers=headers, data=body or None, allow_redirects=False
        ) as resp:
            writer.write(f"HTTP/1.1 {resp.status} {resp.reason}\r\n".encode())
            for k, v in resp.headers.items():
                if k.lower() in _HOP_HEADERS or k.lower() == "content-length":
                    continue
                writer.write(f"{k}: {v}\r\n".encode("latin1"))
            data_known = resp.headers.get("Content-Length")
            if data_known is not None:
                keep = keepalive
                conn = b"keep-alive" if keep else b"close"
                writer.write(f"Content-Length: {data_known}\r\n".encode())
                writer.write(b"Connection: " + conn + b"\r\n\r\n")
            else:
                # unknown length: close-delimited response, tunnel must end
                keep = False
                writer.write(b"Connection: close\r\n\r\n")
            await writer.drain()
            async for chunk in resp.content.iter_chunked(64 << 10):
                writer.write(chunk)
                await writer.drain()
            return keep


class SniProxy:
    """Transparent HTTPS interception without CONNECT (ref proxy_sni.go
    ServeSNI/handleTLSConn): clients whose DNS points the origin host at this
    proxy speak raw TLS to it. The proxy peeks the ClientHello's SNI before
    any handshake; hijacked hosts get a forged-cert TLS termination and ride
    the proxy's rule engine, others get a blind byte tunnel to the named
    upstream.

    Owns a raw accept loop (not asyncio.start_server) so the ClientHello can
    be MSG_PEEK'd from the kernel buffer — a started transport would have
    consumed it before the SNI decision.
    """

    def __init__(
        self,
        proxy: ProxyServer,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        hijack: Optional[HttpsHijack] = None,
        resolve: Optional[Callable[[str], tuple[str, int]]] = None,
        peek_timeout: float = 10.0,
    ):
        self.proxy = proxy
        self.host = host
        self.port = port
        self.hijack = hijack if hijack is not None else proxy.cfg.https_hijack
        # sni -> (upstream_host, upstream_port); identity:443 by default
        self.resolve = resolve or (lambda sni: (sni, 443))
        self.peek_timeout = peek_timeout
        self._sock: socket.socket | None = None
        self._accept_task: asyncio.Task | None = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._sock = socket.create_server((self.host, self.port))
        self._sock.setblocking(False)
        self.port = self._sock.getsockname()[1]
        self._accept_task = asyncio.ensure_future(self._accept_loop())
        logger.info("sni proxy listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._accept_task is not None:
            self._accept_task.cancel()
            await asyncio.gather(self._accept_task, return_exceptions=True)
            self._accept_task = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        self._conns.clear()

    async def _accept_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            try:
                conn, _addr = await loop.sock_accept(self._sock)
            except asyncio.CancelledError:
                raise
            except OSError as e:
                # transient accept failure (e.g. EMFILE) must not kill the
                # listener — asyncio.start_server survives these too
                logger.warning("sni proxy accept failed: %s", e)
                await asyncio.sleep(0.1)  # dflint: disable=DF024 fixed listener re-accept pause (EMFILE relief), not a retry ladder
                continue
            conn.setblocking(False)
            t = asyncio.ensure_future(self._handle(conn))
            self._conns.add(t)
            t.add_done_callback(self._conns.discard)

    # the peek's pause while a partial ClientHello waits for its rest: from
    # PEEK_PAUSE_MIN_S, doubling up to PEEK_PAUSE_MAX_S while no byte arrives
    PEEK_PAUSE_MIN_S = 0.001
    PEEK_PAUSE_MAX_S = 0.05

    async def _peek_sni(self, conn: socket.socket) -> str | None:
        """MSG_PEEK the ClientHello (leaving it in the kernel buffer) until
        the SNI parses, the hello proves SNI-less, or the timeout lapses.

        Readability-driven via add_reader until the first bytes arrive. A
        partial hello stays in the kernel buffer, so the socket stays
        readable and a readiness wait would return at once on every turn
        (the reference spins a core that way until the rest arrives): while
        a partial hello waits, the peek pauses instead, with backoff, from
        PEEK_PAUSE_MIN_S after each byte that arrives to PEEK_PAUSE_MAX_S."""
        from dragonfly2_tpu_torch.security.mitm import parse_client_hello_sni

        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.peek_timeout
        fd = conn.fileno()
        seen, pause = 0, self.PEEK_PAUSE_MIN_S
        while True:
            try:
                data = conn.recv(16 << 10, socket.MSG_PEEK)
            except (BlockingIOError, InterruptedError):
                data = None
            except OSError:
                return None
            if data is not None:
                if not data:
                    return None  # EOF before a full ClientHello
                status, sni = parse_client_hello_sni(data)
                if status == "ok":
                    return sni
                if status == "none":
                    return None
                # incomplete: fall through and wait for more bytes
            remaining = deadline - loop.time()
            if remaining <= 0:
                return None
            if data:
                pause = self.PEEK_PAUSE_MIN_S if len(data) > seen else min(2 * pause, self.PEEK_PAUSE_MAX_S)
                seen = len(data)
                await asyncio.sleep(min(pause, remaining))
                continue
            readable = asyncio.Event()
            loop.add_reader(fd, readable.set)
            try:
                await asyncio.wait_for(readable.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                return None
            finally:
                loop.remove_reader(fd)

    async def _handle(self, conn: socket.socket) -> None:
        try:
            sni = await self._peek_sni(conn)
            reader, writer = await asyncio.open_connection(sock=conn)
        except asyncio.CancelledError:
            conn.close()  # no transport owns the fd yet — close it or leak it
            raise
        except Exception as e:
            conn.close()
            logger.debug("sni peek/stream setup failed: %r", e)
            return
        try:
            if sni and self.hijack is not None and self.hijack.should(sni):
                await self._handle_hijack(sni, reader, writer)
            elif sni:
                await self._handle_tunnel(sni, reader, writer)
            # no SNI: nothing to route by — drop (ref logs and closes)
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("sni proxy connection failed")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (OSError, RuntimeError):
                pass  # already closed by the peer

    async def _handle_hijack(
        self, sni: str, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        import ssl as _ssl

        ctx = self.hijack.forger.context_for(sni)
        loop = asyncio.get_running_loop()
        protocol = writer.transport.get_protocol()
        try:
            # Server-side TLS upgrade on an open_connection stream:
            # StreamWriter.start_tls would take the client side here (the
            # protocol has no client_connected_cb), so do what it does with
            # the loop API and server_side=True
            transport = await loop.start_tls(writer.transport, protocol, ctx, server_side=True)
        except (_ssl.SSLError, OSError, asyncio.IncompleteReadError) as e:
            # a client that does not trust the cluster CA aborts here — noisy
            # but normal for a transparent proxy
            logger.debug("sni MITM handshake failed for %s: %s", sni, e)
            return
        # rewire the writer and the protocol onto the TLS transport, as
        # StreamWriter.start_tls does
        writer._transport = transport
        protocol._replace_writer(writer)
        # route via the RESOLVED upstream: with transparent interception the
        # SNI name's DNS typically points back at this proxy — dialing it
        # again would self-loop. The Host header still carries the SNI name.
        up_host, up_port = self.resolve(sni)
        netloc = up_host if up_port == 443 else f"{up_host}:{up_port}"
        await self.proxy._serve_tunnel_requests(
            reader,
            writer,
            lambda t: f"https://{netloc}{t}" if t.startswith("/") else t,
            via="sni_mitm",
        )

    async def _handle_tunnel(
        self, sni: str, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        from dragonfly2_tpu_torch.daemon import metrics

        up_host, up_port = self.resolve(sni)
        try:
            upstream_r, upstream_w = await asyncio.open_connection(up_host, up_port)
        except OSError as e:
            logger.debug("sni tunnel to %s:%d failed: %s", up_host, up_port, e)
            return
        metrics.PROXY_REQUEST_TOTAL.inc(via="sni_tunnel")
        await splice(reader, writer, upstream_r, upstream_w)
