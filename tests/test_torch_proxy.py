"""The port's image-acceleration front (dragonfly2_tpu_torch/daemon/proxy.py,
security/{ca,mitm}.py) against the reference's.

- Routing: ``ProxyRule`` and ``_decide`` give the reference's answers on one
  table of rules and URLs (first match, redirect, registry blobs, a trailing
  slash on the mirror's base URL).
- The wire: the same raw requests through each package's proxy in front of
  its own in-process swarm, behind ``tests/fakeregistry.py`` and a local
  origin, give the same status lines, headers and bodies: a mirrored
  manifest (passed through) and blob (peer to peer, ``X-Dragonfly-Via:
  p2p``), an absolute-form passthrough, a lowercase ``range`` header, a
  chunked POST, and an origin-form request with no mirror. A failing engine
  falls back to passthrough; a second peer's mirror takes the blob from the
  first; ``stream_task`` releases its pin when abandoned and raises on a
  missing origin file.
- HTTPS: CONNECT hijacked with a forged leaf (peer to peer), a tunnel for a
  host that does not match (the origin's own certificate), two requests on
  one CONNECT; the SNI proxy's hijack and tunnel.
- ``parse_client_hello_sni`` equals the reference's on hellos of several
  names and TLS versions, truncated ones included; a ClientHello sent in two
  writes with a pause between them is peeked a bounded number of times (the
  reference's peek spins until the rest arrives).
- CA directories: one made by either package's ``CertificateAuthority``
  loads in the other, whose leaves verify under it, on both of the port's
  issuance backends (the openssl CLI one forced).

Every async body runs under asyncio.wait_for with a 60 s bound.
"""

import asyncio
import hashlib
import json
import ssl
import time

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp import web

from fakeregistry import FakeRegistry
from refdrain import reference_drain_as_the_ports  # noqa: F401 - a fixture, used by name
from test_e2e import Origin

from dragonfly2_tpu.daemon import proxy as ref_proxy
from dragonfly2_tpu.security import ca as ref_ca
from dragonfly2_tpu.security import mitm as ref_mitm
from dragonfly2_tpu_torch.daemon import metrics as port_metrics
from dragonfly2_tpu_torch.daemon import proxy as port_proxy
from dragonfly2_tpu_torch.daemon.conductor import ConductorConfig
from dragonfly2_tpu_torch.daemon.engine import InProcessSchedulerClient, PeerEngine
from dragonfly2_tpu_torch.daemon.source import SourceRegistry
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.security import ca as port_ca
from dragonfly2_tpu_torch.security import mitm as port_mitm

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

BOUND_S = 60.0
PAYLOAD = np.random.default_rng(5).integers(0, 256, 6 << 20, dtype=np.uint8).tobytes()  # 2 pieces


def bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


def _engine(tmp_path, client, name: str, **kw) -> PeerEngine:
    return PeerEngine(storage_root=tmp_path / name, scheduler=client, hostname=name,
                      conductor_config=ConductorConfig(metadata_poll_interval=0.02, piece_timeout=10.0), **kw)


def _parent_pieces() -> float:
    return port_metrics.PIECE_DOWNLOAD_TOTAL.labels(source="parent").value


# ---------------------------------------------------------------------------
# routing


_BLOB = "http://127.0.0.1:5000/v2/library/nginx/blobs/sha256:" + "a" * 64
URLS = [
    ("GET", "http://example.com/a.bin"),
    ("GET", "http://example.com/a.txt"),
    ("GET", "http://other.com/x"),
    ("POST", "http://example.com/a.bin"),
    ("GET", "http://cdn.example.com/file.bin?x=1"),
    ("GET", "http://cdn.example.com/dir/"),
    ("GET", _BLOB),
    ("HEAD", _BLOB),
    ("GET", _BLOB + "?ns=docker.io"),
    ("GET", "http://127.0.0.1:5000/v2/library/nginx/manifests/latest"),
    ("GET", "http://127.0.0.1:5000/v2/library/nginx/blobs/sha256:abc"),
    ("GET", "http://127.0.0.1:5001/v2/x/blobs/sha256:" + "b" * 64),
]
RULE_TABLE = {
    "first-match": dict(rules=[(r"\.bin$", {}), (r"example\.com", {"direct": True})]),
    "redirect": dict(rules=[(r"cdn\.example\.com", {"redirect": "http://mirror.local:9999/"})]),
    "not-p2p": dict(rules=[(r"\.bin", {"use_p2p": False}), (r".*", {})]),
    "registry-blobs": dict(mirror="http://127.0.0.1:5000"),
    "trailing-slash": dict(mirror="http://127.0.0.1:5000/"),
    "mirror-no-p2p-blobs": dict(mirror="http://127.0.0.1:5000", p2p_blobs=False, rules=[(r".*", {})]),
    "mirror-and-rules": dict(mirror="http://127.0.0.1:5000", rules=[(r"nginx", {}), (r"\.txt$", {})]),
}
# a few answers pinned outright, beside the reference's
PINNED = {
    ("first-match", 0): ("p2p", "http://example.com/a.bin"),
    ("first-match", 1): ("passthrough", "http://example.com/a.txt"),
    ("first-match", 3): ("passthrough", "http://example.com/a.bin"),
    ("redirect", 4): ("p2p", "http://mirror.local:9999/file.bin?x=1"),
    ("registry-blobs", 6): ("p2p", _BLOB),
    ("registry-blobs", 9): ("passthrough", "http://127.0.0.1:5000/v2/library/nginx/manifests/latest"),
    ("trailing-slash", 6): ("p2p", _BLOB),
}


def _proxy_config(mod, spec: dict):
    mirror = None
    if "mirror" in spec:
        mirror = mod.RegistryMirrorConfig(base_url=spec["mirror"], use_p2p_for_blobs=spec.get("p2p_blobs", True))
    rules = [mod.ProxyRule(regex=rx, **kw) for rx, kw in spec.get("rules", [])]
    return mod.ProxyConfig(rules=rules, registry_mirror=mirror)


@pytest.mark.parametrize("name", list(RULE_TABLE))
def test_decide_equals_the_reference(name):
    decided = {}
    for mod in (ref_proxy, port_proxy):
        p = mod.ProxyServer(None, config=_proxy_config(mod, RULE_TABLE[name]))
        decided[mod] = [p._decide(method, url) for method, url in URLS]
    assert decided[port_proxy] == decided[ref_proxy]
    for (table, i), want in PINNED.items():
        if table == name:
            assert decided[port_proxy][i] == want, URLS[i]
    rules = [port_proxy.ProxyRule(regex=rx, **kw) for rx, kw in RULE_TABLE[name].get("rules", [])]
    refs = [ref_proxy.ProxyRule(regex=rx, **kw) for rx, kw in RULE_TABLE[name].get("rules", [])]
    assert [[r.matches(u) for _, u in URLS] for r in rules] == [[r.matches(u) for _, u in URLS] for r in refs]


# ---------------------------------------------------------------------------
# the wire, each package's proxy in front of its own swarm


async def _raw(port: int, request: bytes) -> tuple[str, dict, bytes]:
    """Send one raw request; the status line, the headers (Date dropped) and
    the body read to the close."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(request)
    await writer.drain()
    resp = await reader.read()
    writer.close()
    head, _, body = resp.partition(b"\r\n\r\n")
    status, *lines = head.decode("latin1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines)}
    headers.pop("date", None)
    return status, headers, body


async def _wire_answers(pkg: str, tmp_path) -> dict:
    import dragonfly2_tpu.daemon.engine as ref_engine
    import dragonfly2_tpu.scheduler.service as ref_service

    proxy_mod = port_proxy if pkg == "port" else ref_proxy
    reg = FakeRegistry(require_auth=False)
    digest = reg.push("library/app", "v1", PAYLOAD)
    await reg.start()
    seen = {}
    app = web.Application()

    async def echo(req):
        seen["body"] = await req.read()
        return web.Response(text="ok")

    app.router.add_post("/echo", echo)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    echo_port = site._server.sockets[0].getsockname()[1]
    async with Origin({"r.bin": b"0123456789abcdef", "page.txt": b"hello proxy"}) as origin:
        if pkg == "port":
            engine = _engine(tmp_path / pkg, InProcessSchedulerClient(SchedulerService()), "peer")
        else:
            engine = ref_engine.PeerEngine(storage_root=tmp_path / pkg / "peer",
                                           scheduler=ref_engine.InProcessSchedulerClient(ref_service.SchedulerService()),
                                           hostname="peer")
        await engine.start()
        mirror = proxy_mod.ProxyServer(engine, config=proxy_mod.ProxyConfig(
            registry_mirror=proxy_mod.RegistryMirrorConfig(base_url=f"http://127.0.0.1:{reg.port}")))
        plain = proxy_mod.ProxyServer(engine, config=proxy_mod.ProxyConfig(
            rules=[proxy_mod.ProxyRule(regex=r"\.bin$")]))
        await mirror.start()
        await plain.start()
        try:
            accept = "Accept: application/vnd.oci.image.manifest.v1+json\r\n"
            out = {
                "manifest": await _raw(mirror.port, f"GET /v2/library/app/manifests/v1 HTTP/1.1\r\n{accept}\r\n".encode()),
                "blob": await _raw(mirror.port, f"GET /v2/library/app/blobs/{digest} HTTP/1.1\r\n\r\n".encode()),
                "passthrough": await _raw(plain.port, f"GET {origin.url('page.txt')} HTTP/1.1\r\n\r\n".encode()),
                "lowercase-range": await _raw(plain.port, f"GET {origin.url('r.bin')} HTTP/1.1\r\n"
                                                          "range: bytes=0-3\r\n\r\n".encode()),
                "chunked-post": await _raw(plain.port, f"POST http://127.0.0.1:{echo_port}/echo HTTP/1.1\r\n"
                                                       "Transfer-Encoding: chunked\r\n\r\n"
                                                       "5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n".encode()),
                "origin-form-without-mirror": await _raw(plain.port, b"GET /x HTTP/1.1\r\n\r\n"),
            }
            out["posted"] = seen["body"]
        finally:
            await mirror.stop()
            await plain.stop()
            await engine.stop()
            await reg.stop()
            await runner.cleanup()
    return out


def test_the_proxys_http_behaviour_equals_the_references(tmp_path, reference_drain_as_the_ports):
    got = {pkg: bounded(_wire_answers(pkg, tmp_path)) for pkg in ("ref", "port")}
    for case in got["ref"]:
        assert got["port"][case] == got["ref"][case], case
    port = got["port"]
    status, headers, body = port["blob"]
    assert status == "HTTP/1.1 200 OK" and body == PAYLOAD
    assert headers["x-dragonfly-via"] == "p2p" and headers["content-length"] == str(len(PAYLOAD))
    status, headers, body = port["manifest"]
    assert status == "HTTP/1.1 200 OK" and "x-dragonfly-via" not in headers
    assert json.loads(body)["layers"][0]["size"] == len(PAYLOAD)
    assert port["passthrough"][2] == b"hello proxy" and "x-dragonfly-via" not in port["passthrough"][1]
    assert port["lowercase-range"][0].startswith("HTTP/1.1 206") and port["lowercase-range"][2] == b"0123"
    assert port["chunked-post"][0] == "HTTP/1.1 200 OK" and port["posted"] == b"hello world"
    assert port["origin-form-without-mirror"][0] == "HTTP/1.1 400 Bad Request"


def test_a_second_peers_mirror_takes_the_blob_from_the_first(tmp_path):
    async def body():
        reg = FakeRegistry(require_auth=False)
        digest = reg.push("library/app", "v1", PAYLOAD)
        await reg.start()
        client = InProcessSchedulerClient(SchedulerService())
        engines = [_engine(tmp_path, client, f"peer{i}") for i in range(2)]
        proxies = []
        try:
            for e in engines:
                await e.start()
                p = port_proxy.ProxyServer(e, config=port_proxy.ProxyConfig(
                    registry_mirror=port_proxy.RegistryMirrorConfig(base_url=f"http://127.0.0.1:{reg.port}/")))
                await p.start()
                proxies.append(p)
            got = []
            before = _parent_pieces()
            async with aiohttp.ClientSession() as sess:
                for p in proxies:
                    async with sess.get(f"http://127.0.0.1:{p.port}/v2/library/app/blobs/{digest}") as r:
                        got.append((r.status, r.headers.get("X-Dragonfly-Via"), await r.read()))
            return got, _parent_pieces() - before
        finally:
            for p in proxies:
                await p.stop()
            for e in engines:
                await e.stop()
            await reg.stop()

    got, parent_pieces = bounded(body())
    assert got == [(200, "p2p", PAYLOAD)] * 2
    assert parent_pieces >= 2  # the second peer's two pieces came from the first


def test_a_failing_engine_falls_back_to_passthrough(tmp_path):
    class BrokenEngine:
        async def stream_task(self, url, **kw):
            raise IOError("engine down")

    async def body():
        async with Origin({"f.bin": b"fallback bytes"}) as origin:
            proxy = port_proxy.ProxyServer(BrokenEngine(),
                                           config=port_proxy.ProxyConfig(rules=[port_proxy.ProxyRule(regex=r"\.bin$")]))
            await proxy.start()
            before = port_metrics.PROXY_REQUEST_TOTAL.labels(via="passthrough").value
            try:
                async with aiohttp.ClientSession() as sess:
                    async with sess.get(origin.url("f.bin"), proxy=f"http://127.0.0.1:{proxy.port}") as r:
                        return (r.status, r.headers.get("X-Dragonfly-Via"), await r.read(),
                                port_metrics.PROXY_REQUEST_TOTAL.labels(via="passthrough").value - before)
            finally:
                await proxy.stop()

    assert bounded(body()) == (200, None, b"fallback bytes", 1)


def test_an_abandoned_stream_releases_its_pin_and_a_missing_file_raises(tmp_path):
    async def body():
        import gc

        client = InProcessSchedulerClient(SchedulerService())
        async with Origin({"s.bin": PAYLOAD}) as origin:
            engine = _engine(tmp_path, client, "streampeer")
            await engine.start()
            try:
                length, it = await engine.stream_task(origin.url("s.bin"))
                ts = engine.storage.tasks()[0]
                held = ts.pins
                del it  # abandoned without a single __anext__
                gc.collect()
                for _ in range(100):
                    await asyncio.sleep(0.01)
                    if ts.pins == 0:
                        break
                released = ts.pins
                _, it2 = await engine.stream_task(origin.url("s.bin"))
                again = b"".join([c async for c in it2])
                with pytest.raises(Exception):
                    _, it3 = await engine.stream_task(origin.url("missing.bin"))
                    async for _ in it3:
                        pass
                return length, held, released, again
            finally:
                await engine.stop()

    length, held, released, again = bounded(body())
    assert (length, again) == (len(PAYLOAD), PAYLOAD)
    assert held >= 1 and released == 0


# ---------------------------------------------------------------------------
# HTTPS interception


class TlsOrigin(Origin):
    """The origin behind TLS, with a leaf from the port's CA for localhost."""

    def __init__(self, files, ssl_ctx):
        super().__init__(files)
        self._ssl_ctx = ssl_ctx

    async def __aenter__(self):
        app = web.Application()
        app.router.add_get("/{name}", self._handle)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0, ssl_context=self._ssl_ctx)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self

    def url(self, name: str) -> str:
        return f"https://localhost:{self.port}/{name}"


@pytest.fixture
def tls_world(tmp_path):
    """Two of the port's CAs: one signs the origin's leaf, the other is the
    hijack CA whose forger signs the proxy's leaves."""
    origin_ca = port_ca.CertificateAuthority(tmp_path / "origin-ca")
    issued = origin_ca.issue("localhost", sans=["localhost", "127.0.0.1"])
    paths = port_ca.write_issued(issued, tmp_path / "origin-tls")
    hijack_ca = port_ca.CertificateAuthority(tmp_path / "hijack-ca")
    forger = port_mitm.CertForger(hijack_ca)
    yield {
        "server_ctx": port_ca.server_ssl_context(paths["cert"], paths["key"]),
        "origin_trust": ssl.create_default_context(cadata=origin_ca.ca_pem.decode()),
        "hijack_trust": ssl.create_default_context(cadata=hijack_ca.ca_pem.decode()),
        "forger": forger,
        "origin_cert": issued.cert_pem,
    }
    forger.close()


async def _tls_swarm(tmp_path, tls_world, name: str, **proxy_kw):
    engine = _engine(tmp_path, InProcessSchedulerClient(SchedulerService()), name)
    engine.sources = SourceRegistry(http_ssl=tls_world["origin_trust"])
    await engine.start()
    proxy = port_proxy.ProxyServer(engine, config=port_proxy.ProxyConfig(
        rules=[port_proxy.ProxyRule(regex=r"\.bin$")], upstream_ssl=tls_world["origin_trust"], **proxy_kw))
    await proxy.start()
    return engine, proxy


async def _served_cert(port: int, trust: ssl.SSLContext, connect: str | None = None) -> bytes:
    """The certificate a TLS client that trusts ``trust`` is served on
    127.0.0.1:``port`` as "localhost", through a CONNECT to ``connect`` when
    given (the port is then the proxy's)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        if connect is not None:
            writer.write(f"CONNECT {connect} HTTP/1.1\r\n\r\n".encode())
            await writer.drain()
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
        await writer.start_tls(trust, server_hostname="localhost")
        der = writer.get_extra_info("ssl_object").getpeercert(binary_form=True)
        return ssl.DER_cert_to_PEM_cert(der).encode()
    finally:
        writer.close()


def _same_cert(a: bytes, b: bytes) -> bool:
    return ssl.PEM_cert_to_DER_cert(a.decode()) == ssl.PEM_cert_to_DER_cert(b.decode())


def test_connect_is_hijacked_and_served_peer_to_peer(tmp_path, tls_world):
    async def body():
        async with TlsOrigin({"f.bin": PAYLOAD}, tls_world["server_ctx"]) as origin:
            hijack = port_proxy.HttpsHijack(forger=tls_world["forger"], hosts=(r"^localhost$",))
            engine, proxy = await _tls_swarm(tmp_path, tls_world, "mitm", https_hijack=hijack)
            before = port_metrics.PROXY_REQUEST_TOTAL.labels(via="mitm").value
            try:
                async with aiohttp.ClientSession() as sess:
                    async with sess.get(origin.url("f.bin"), proxy=f"http://127.0.0.1:{proxy.port}",
                                        ssl=tls_world["hijack_trust"]) as r:
                        got = (r.status, r.headers.get("X-Dragonfly-Via"), await r.read())
                cert = await _served_cert(proxy.port, tls_world["hijack_trust"], connect=f"localhost:{origin.port}")
                forged = not _same_cert(cert, tls_world["origin_cert"])
                return got, forged, port_metrics.PROXY_REQUEST_TOTAL.labels(via="mitm").value - before
            finally:
                await proxy.stop()
                await engine.stop()

    got, forged, mitm = bounded(body())
    assert got == (200, "p2p", PAYLOAD)
    assert forged and mitm == 1


def test_connect_to_a_host_that_does_not_match_is_tunnelled(tmp_path, tls_world):
    async def body():
        async with TlsOrigin({"t.txt": b"tunnel"}, tls_world["server_ctx"]) as origin:
            hijack = port_proxy.HttpsHijack(forger=tls_world["forger"], hosts=(r"^hijack-only\.example$",))
            engine, proxy = await _tls_swarm(tmp_path, tls_world, "tun", https_hijack=hijack)
            before = port_metrics.PROXY_REQUEST_TOTAL.labels(via="tunnel").value
            try:
                async with aiohttp.ClientSession() as sess:
                    async with sess.get(origin.url("t.txt"), proxy=f"http://127.0.0.1:{proxy.port}",
                                        ssl=tls_world["origin_trust"]) as r:
                        got = (r.status, await r.read())
                cert = await _served_cert(proxy.port, tls_world["origin_trust"], connect=f"localhost:{origin.port}")
                return (*got, cert), port_metrics.PROXY_REQUEST_TOTAL.labels(via="tunnel").value - before
            finally:
                await proxy.stop()
                await engine.stop()

    (status, data, cert), tunnelled = bounded(body())
    assert (status, data, tunnelled) == (200, b"tunnel", 2)  # the request's CONNECT and the probe's
    assert _same_cert(cert, tls_world["origin_cert"])  # the origin's own leaf
    assert "localhost" not in tls_world["forger"]._cache


async def _read_response(reader) -> tuple[str, dict, bytes]:
    status = (await reader.readline()).decode().split()[1]
    headers = {}
    while (line := await reader.readline()) not in (b"\r\n", b"\n", b""):
        k, v = line.decode().split(":", 1)
        headers[k.strip().lower()] = v.strip()
    return status, headers, await reader.readexactly(int(headers.get("content-length", "0")))


def test_two_requests_ride_one_connect(tmp_path, tls_world):
    async def body():
        files = {"a.bin": PAYLOAD, "b.txt": b"second-req"}
        async with TlsOrigin(files, tls_world["server_ctx"]) as origin:
            hijack = port_proxy.HttpsHijack(forger=tls_world["forger"])
            engine, proxy = await _tls_swarm(tmp_path, tls_world, "ka", https_hijack=hijack)
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1", proxy.port)
                writer.write(f"CONNECT localhost:{origin.port} HTTP/1.1\r\n\r\n".encode())
                await writer.drain()
                assert b"200" in await reader.readline()
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass
                await writer.start_tls(tls_world["hijack_trust"], server_hostname="localhost")
                writer.write(b"GET /a.bin HTTP/1.1\r\nHost: localhost\r\n\r\n")
                await writer.drain()
                first = await _read_response(reader)
                writer.write(b"GET /b.txt HTTP/1.1\r\nHost: localhost\r\nConnection: close\r\n\r\n")
                await writer.drain()
                second = await _read_response(reader)
                writer.close()
                return first, second
            finally:
                await proxy.stop()
                await engine.stop()

    (st1, h1, d1), (st2, h2, d2) = bounded(body())
    assert (st1, d1, h1["connection"], h1["x-dragonfly-via"]) == ("200", PAYLOAD, "keep-alive", "p2p")
    assert (st2, d2, h2["connection"]) == ("200", b"second-req", "close")


@pytest.mark.parametrize("mode", ["hijack", "tunnel"])
def test_the_sni_proxy_hijacks_a_matching_name_and_tunnels_the_rest(tmp_path, tls_world, mode):
    async def body():
        async with TlsOrigin({"s.bin": PAYLOAD}, tls_world["server_ctx"]) as origin:
            engine, proxy = await _tls_swarm(tmp_path, tls_world, "sni")
            hijack = port_proxy.HttpsHijack(forger=tls_world["forger"],
                                            hosts=(r"^localhost$",) if mode == "hijack" else (r"^other$",))
            sni = port_proxy.SniProxy(proxy, hijack=hijack, resolve=lambda name: ("127.0.0.1", origin.port))
            await sni.start()
            via = "sni_mitm" if mode == "hijack" else "sni_tunnel"
            before = port_metrics.PROXY_REQUEST_TOTAL.labels(via=via).value
            trust = tls_world["hijack_trust"] if mode == "hijack" else tls_world["origin_trust"]
            try:
                async with aiohttp.ClientSession() as sess:
                    async with sess.get(f"https://localhost:{sni.port}/s.bin", ssl=trust) as r:
                        got = (r.status, r.headers.get("X-Dragonfly-Via"), await r.read())
                own = _same_cert(await _served_cert(sni.port, trust), tls_world["origin_cert"])
                return got, own, port_metrics.PROXY_REQUEST_TOTAL.labels(via=via).value - before
            finally:
                await sni.stop()
                await proxy.stop()
                await engine.stop()

    (status, via, data), own, counted = bounded(body())
    # a hijacked connection counts its requests, a tunnel its connections
    # (the request's and the certificate probe's)
    assert (status, data, counted) == (200, PAYLOAD, 1 if mode == "hijack" else 2)
    assert (via, own) == (("p2p", False) if mode == "hijack" else (None, True))


# ---------------------------------------------------------------------------
# the ClientHello


def _hello(name: str | None, version: ssl.TLSVersion | None = None) -> bytes:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    if version is not None:
        ctx.maximum_version = version
    inbio, outbio = ssl.MemoryBIO(), ssl.MemoryBIO()
    obj = ctx.wrap_bio(inbio, outbio, server_hostname=name)
    try:
        obj.do_handshake()
    except ssl.SSLWantReadError:
        pass
    return outbio.read()


HELLOS = {
    "registry": ("registry.example.com", None),
    "localhost-tls12": ("localhost", ssl.TLSVersion.TLSv1_2),
    "long-name": ("a" * 60 + ".b" * 40 + ".example", None),
    "no-sni": (None, None),
}


@pytest.mark.parametrize("kind", list(HELLOS))
def test_client_hello_sni_equals_the_references(kind):
    hello = _hello(*HELLOS[kind])
    cuts = sorted({0, 1, 3, 4, 5, 9, 43, len(hello) // 2, len(hello) - 1, len(hello)})
    inputs = [hello[:n] for n in cuts] + [b"GET / HTTP/1.1\r\n", b"\x16\x03\x01\x00\x05\x02\x00\x00\x01\x00",
                                          hello[:5] + b"\x00" * (len(hello) - 5), hello + b"trailing"]
    got = [port_mitm.parse_client_hello_sni(x) for x in inputs]
    assert got == [ref_mitm.parse_client_hello_sni(x) for x in inputs]
    name = HELLOS[kind][0]
    assert got[cuts.index(len(hello))] == (("ok", name) if name else ("none", None))
    assert got[cuts.index(3)] == ("incomplete", None)


def test_a_client_hello_in_two_writes_is_peeked_a_bounded_number_of_times(monkeypatch):
    """A partial ClientHello keeps the socket readable: the reference's peek
    returns from its readiness wait at once on every turn and re-peeks the
    same bytes until the rest arrives (thousands of peeks over a 0.5 s
    pause). The port's pauses, with backoff, while no byte arrives."""
    peeks = []
    real = port_mitm.parse_client_hello_sni
    monkeypatch.setattr(port_mitm, "parse_client_hello_sni", lambda data: peeks.append(len(data)) or real(data))

    async def body():
        sni = port_proxy.SniProxy(port_proxy.ProxyServer(None))
        routed = asyncio.get_running_loop().create_future()

        async def tunnel(name, reader, writer):
            routed.set_result(name)

        sni._handle_tunnel = tunnel
        await sni.start()
        try:
            hello = _hello("registry.example")
            _, writer = await asyncio.open_connection("127.0.0.1", sni.port)
            writer.write(hello[:40])
            await writer.drain()
            t0 = time.process_time()
            await asyncio.sleep(0.5)
            writer.write(hello[40:])
            await writer.drain()
            name = await routed
            cpu = time.process_time() - t0
            writer.close()
            return name, cpu
        finally:
            await sni.stop()

    name, cpu = bounded(body())
    assert name == "registry.example"
    assert 2 <= len(peeks) <= 40, len(peeks)
    assert peeks[0] == 40 and peeks[-1] > 40
    assert cpu < 0.25  # a spinning peek holds a core for the whole pause


# ---------------------------------------------------------------------------
# CA directories across the packages


def _handshake(cert_pem: bytes, key_pem: bytes, ca_pem: bytes, tmp_path, hostname: str) -> str:
    """An in-memory TLS handshake: a server with the leaf, a client that
    trusts only ``ca_pem``; the negotiated version."""
    d = tmp_path / f"leaf-{hashlib.sha256(cert_pem).hexdigest()[:8]}"
    d.mkdir()
    (d / "c.pem").write_bytes(cert_pem)
    (d / "k.pem").write_bytes(key_pem)
    server = port_ca.server_ssl_context(str(d / "c.pem"), str(d / "k.pem"))
    client = ssl.create_default_context(cadata=ca_pem.decode())
    bios = [ssl.MemoryBIO() for _ in range(4)]
    s = server.wrap_bio(bios[0], bios[1], server_side=True)
    c = client.wrap_bio(bios[2], bios[3], server_hostname=hostname)
    for _ in range(10):
        for end in (c, s):
            try:
                end.do_handshake()
            except ssl.SSLWantReadError:
                pass
        bios[0].write(bios[3].read())
        bios[2].write(bios[1].read())
    return c.version()


@pytest.mark.parametrize("backend", ["cryptography", "openssl-cli"])
@pytest.mark.parametrize("maker", ["ref", "port"])
def test_a_ca_directory_of_either_package_issues_leaves_the_other_verifies(tmp_path, monkeypatch, maker, backend):
    if backend == "openssl-cli":
        monkeypatch.setattr(port_ca, "_HAVE_CRYPTOGRAPHY", False)
    made = (ref_ca if maker == "ref" else port_ca).CertificateAuthority(tmp_path / "ca")
    loaded = (port_ca if maker == "ref" else ref_ca).CertificateAuthority(tmp_path / "ca")
    port_side = loaded if maker == "ref" else made
    assert port_side.backend == backend
    assert made.ca_pem == loaded.ca_pem == (tmp_path / "ca" / "ca.pem").read_bytes()
    for issuer in (made, loaded):
        leaf = issuer.issue("registry.local", sans=["registry.local", "127.0.0.1"])
        assert leaf.ca_pem == made.ca_pem
        assert _handshake(leaf.cert_pem, leaf.key_pem, made.ca_pem, tmp_path, "registry.local").startswith("TLS")
    # the port's forger serves its contexts from the same directory
    forger = port_mitm.CertForger(port_side)
    try:
        ctx = forger.context_for("hub.example")
        assert forger.context_for("hub.example") is ctx
    finally:
        forger.close()
    paths = port_ca.write_issued(port_side.issue("svc", sans=["svc.local"]), tmp_path / "certs")
    assert _handshake((tmp_path / "certs" / "tls.crt").read_bytes(), (tmp_path / "certs" / "tls.key").read_bytes(),
                      (tmp_path / "certs" / "ca.pem").read_bytes(), tmp_path, "svc.local").startswith("TLS")
    assert set(paths) == {"cert", "key", "ca"}
