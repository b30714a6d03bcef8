"""The port's mTLS piece plane (security/transport.py, the TLS paths of
daemon/rawrange.py, daemon/upload.py, the conductor and the engine) against
the reference's.

- Cipher policy: the env override and its validation, the cpuinfo prior and
  the kTLS probe's null report equal the reference's; the microbench
  measures both suites and picks the faster; a data context pins TLS 1.2
  with the policy's suite first and the other AEAD suite after it, so a
  port context of either policy handshakes with a reference context pinned
  to either suite (the reference's pinned pair refuses a mismatch).
- ``TlsSessionCache``: one sequence of gets, puts and evictions gives the
  reference's hits, misses and entries.
- ``AsyncTlsTransport``, each package's client against the other's server:
  a round trip through ``recv`` and ``recv_into`` and a second connect that
  resumes the first's session; a peer's close reads as 0; ``close()`` wakes
  a threaded body drain blocked on a stalled peer; the drain's idle bound
  fails it on its own.
- The port's ``RawRangeClient`` over mTLS against the reference's
  ``UploadServer``, and the reverse: bit-exact ranges, a pooled second range
  with no handshake, a resumed handshake after the pool is pruned, each in
  the handshake counters of the client's package.
- A plain client is refused by the port's mTLS piece server; a malformed
  request is answered 400 and the connection closed.
- Engines peer to peer over mTLS, bit-exact: port to port, and each
  package's child from the other's parent.
- The mTLS run under chaos faults: the port's manager issues the leaves over
  its token-gated TLS RPC, the port's scheduler serves mutual TLS, two port
  engines move a file over the mTLS piece plane with parent-fetch errors and
  RPC latency injected; a client with no certificate and a plain client are
  refused by the scheduler.

Every coroutine runs under a deadline of 120 s.
"""

from __future__ import annotations

import asyncio
import hashlib
import socket
import ssl
import time

import numpy as np
import pytest
import torch

from refdrain import reference_drain_as_the_ports  # noqa: F401 - a fixture, used by name
from test_e2e import Origin

from dragonfly2_tpu.daemon import conductor as ref_conductor
from dragonfly2_tpu.daemon import engine as ref_engine
from dragonfly2_tpu.daemon import metrics as ref_metrics
from dragonfly2_tpu.daemon import rawrange as ref_rawrange
from dragonfly2_tpu.daemon import storage as ref_storage
from dragonfly2_tpu.daemon import upload as ref_upload
from dragonfly2_tpu.security import transport as ref_tport
from dragonfly2_tpu_torch.daemon import conductor as port_conductor
from dragonfly2_tpu_torch.daemon import engine as port_engine
from dragonfly2_tpu_torch.daemon import metrics as port_metrics
from dragonfly2_tpu_torch.daemon import rawrange as port_rawrange
from dragonfly2_tpu_torch.daemon import storage as port_storage
from dragonfly2_tpu_torch.daemon import upload as port_upload
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.security import transport as port_tport
from dragonfly2_tpu_torch.security.ca import CertificateAuthority, write_issued
from dragonfly2_tpu_torch.utils.pieces import Range, compute_piece_size, piece_count, piece_range

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

DEADLINE_S = 120.0
TPORT = {"port": port_tport, "ref": ref_tport}
PAIRS = [("port", "ref"), ("ref", "port")]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


pytestmark = pytest.mark.usefixtures("reference_drain_as_the_ports")


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """One port CA and one loopback leaf for the module."""
    td = tmp_path_factory.mktemp("tls-ca")
    ca = CertificateAuthority(td / "ca")
    return write_issued(ca.issue("tls-test", sans=["127.0.0.1", "localhost"]), td / "leaf")


def _bundle(pkg: str, certs: dict):
    return TPORT[pkg].DataPlaneTls.from_paths(certs["cert"], certs["key"], certs["ca"], microbench=False)


@pytest.fixture
def payload():
    return np.random.default_rng(5).integers(0, 256, 10 << 20, dtype=np.uint8).tobytes()  # 3 pieces


# ---------------------------------------------------------------------------
# cipher policy and probes


def test_cipher_policy_env_override_and_validation(monkeypatch):
    for value in ("chacha20", "aes-gcm"):
        monkeypatch.setenv("DRAGONFLY_PIECE_CIPHER", value)
        assert port_tport.cipher_policy() == ref_tport.cipher_policy() == value
    monkeypatch.setenv("DRAGONFLY_PIECE_CIPHER", "rot13")
    for t in TPORT.values():
        with pytest.raises(ValueError):
            t.cipher_policy()
    monkeypatch.delenv("DRAGONFLY_PIECE_CIPHER")
    assert port_tport.cipher_policy(force="chacha20") == ref_tport.cipher_policy(force="chacha20")
    assert port_tport.detect_aes_accel() == ref_tport.detect_aes_accel()
    assert port_tport.cipher_policy() == ref_tport.cipher_policy()
    assert port_tport.CIPHER_STRINGS == ref_tport.CIPHER_STRINGS


def test_ktls_probe_reports_what_the_reference_reports():
    port, ref = port_tport.probe_ktls(), ref_tport.probe_ktls()
    assert set(port) == {"available", "reason"} and port == ref


def test_cipher_microbench_measures_both_and_picks_the_faster(certs):
    rates = port_tport.measure_cipher_rates(certs["cert"], certs["key"], certs["ca"], mb=1)
    assert rates["aes-gcm"] > 0 and rates["chacha20"] > 0
    assert rates["picked"] == max(("aes-gcm", "chacha20"), key=lambda p: rates[p])


@pytest.mark.parametrize("policy", ["aes-gcm", "chacha20"])
def test_a_data_context_pins_tls12_and_puts_its_policy_first(certs, policy):
    ctx = port_tport.data_server_ssl_context(certs["cert"], certs["key"], certs["ca"], policy=policy)
    assert ctx.minimum_version == ctx.maximum_version == ssl.TLSVersion.TLSv1_2
    tls12 = [c["name"] for c in ctx.get_ciphers() if not c["name"].startswith("TLS_")]
    mark = "CHACHA20" if policy == "chacha20" else "AES"
    first = [i for i, n in enumerate(tls12) if mark in n]
    other = [i for i, n in enumerate(tls12) if mark not in n]
    assert first and other and max(first) < min(other), tls12


def _handshake(server_ctx, client_ctx) -> str | None:
    """The suite a blocking loopback handshake settles on, or None."""
    import threading

    ls = socket.create_server(("127.0.0.1", 0))
    out: dict = {}

    def serve():
        conn, _ = ls.accept()
        try:
            with server_ctx.wrap_socket(conn, server_side=True) as s:
                s.recv(1)
        except (ssl.SSLError, OSError) as e:
            out["server"] = e

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        with socket.create_connection(ls.getsockname()) as raw, client_ctx.wrap_socket(raw) as s:
            s.send(b"x")
            return s.cipher()[0]
    except (ssl.SSLError, OSError):
        return None
    finally:
        t.join(10)
        ls.close()


@pytest.mark.parametrize("server_policy,client_policy", [("aes-gcm", "chacha20"), ("chacha20", "aes-gcm")])
def test_hosts_whose_policies_differ_still_handshake(certs, server_policy, client_policy):
    def ctxs(t, pkg_policy_server, pkg_policy_client):
        return (t[0].data_server_ssl_context(certs["cert"], certs["key"], certs["ca"], policy=pkg_policy_server),
                t[1].data_client_ssl_context(certs["ca"], certs["cert"], certs["key"], policy=pkg_policy_client))

    mark = "CHACHA20" if server_policy == "chacha20" else "AES"
    # port with port: the server's pick wins
    suite = _handshake(*ctxs((port_tport, port_tport), server_policy, client_policy))
    assert suite is not None and mark in suite
    # a reference peer pinned to either suite still meets a port peer
    for pair in ((port_tport, ref_tport), (ref_tport, port_tport)):
        assert _handshake(*ctxs(pair, server_policy, client_policy)) is not None  # dflint: disable=DF026 one server thread per handshake under test
    # the reference with itself shares no suite across a mismatch
    assert _handshake(*ctxs((ref_tport, ref_tport), server_policy, client_policy)) is None


def test_session_cache_lru_equals_the_reference():
    caches = [t.TlsSessionCache(max_entries=2) for t in TPORT.values()]
    sessions = [object() for _ in range(4)]

    def trace(cache):
        got = [cache.get(("a", 1))]
        cache.put(("a", 1), None)  # a None session is never cached
        got.append(len(cache))
        for i, key in enumerate((("a", 1), ("b", 2), ("a", 1), ("c", 3))):
            cache.put(key, sessions[i])
        got += [cache.get(("b", 2)), cache.get(("a", 1)) is sessions[2], cache.get(("c", 3)) is sessions[3],
                len(cache), cache.hits, cache.misses]
        return got

    port, ref = (trace(c) for c in caches)
    assert port == ref and port[2] is None  # "b" was the least recently used


# ---------------------------------------------------------------------------
# the bulk-BIO transport


async def _listen():
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(4)
    ls.setblocking(False)
    return ls, ls.getsockname()[1]


async def _accept_one(mod, ls, ctx):
    conn, _ = await asyncio.get_running_loop().sock_accept(ls)
    conn.setblocking(False)
    return await mod.AsyncTlsTransport.accept(conn, ctx)


async def _connect(mod, port, ctx, session=None):
    s = socket.socket()
    s.setblocking(False)
    await asyncio.get_running_loop().sock_connect(s, ("127.0.0.1", port))
    return await mod.AsyncTlsTransport.connect(s, ctx, session=session)


def _ctxs(server_pkg, client_pkg, certs):
    return (TPORT[server_pkg].data_server_ssl_context(certs["cert"], certs["key"], certs["ca"]),
            TPORT[client_pkg].data_client_ssl_context(certs["ca"], certs["cert"], certs["key"]))


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_transport_round_trip_and_resumption(certs, server_pkg, client_pkg):
    srv_ctx, cli_ctx = _ctxs(server_pkg, client_pkg, certs)
    srv_mod, cli_mod = TPORT[server_pkg], TPORT[client_pkg]
    body = bytes(range(256)) * 4096  # 1 MiB

    async def main():
        ls, port = await _listen()

        async def serve():
            t = await _accept_one(srv_mod, ls, srv_ctx)
            await t.sendall(b"OK\r\n" + body)
            t.close()

        reused = []
        sess = None
        for _ in range(2):
            server = asyncio.ensure_future(serve())
            t = await _connect(cli_mod, port, cli_ctx, session=sess)
            reused.append(t.session_reused)
            assert await t.recv(4) == b"OK\r\n"
            buf = bytearray(len(body))
            view, off = memoryview(buf), 0
            while off < len(body):
                n = await t.recv_into(view[off:])
                assert n > 0
                off += n
            assert bytes(buf) == body
            sess = t.session
            t.close()
            await server
        ls.close()
        return reused

    assert run(main()) == [False, True]


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_a_peers_close_reads_as_zero(certs, server_pkg, client_pkg):
    srv_ctx, cli_ctx = _ctxs(server_pkg, client_pkg, certs)

    async def main():
        ls, port = await _listen()

        async def serve():
            t = await _accept_one(TPORT[server_pkg], ls, srv_ctx)
            await t.sendall(b"xy")
            t.close()  # close_notify, then FIN

        server = asyncio.ensure_future(serve())
        t = await _connect(TPORT[client_pkg], port, cli_ctx)
        got = await t.recv(2)
        n = await t.recv_into(memoryview(bytearray(8)))
        t.close()
        await server
        ls.close()
        return got, n

    assert run(main()) == (b"xy", 0)


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
@pytest.mark.parametrize("how", ["close", "idle-timeout"])
def test_a_stalled_drain_ends(certs, server_pkg, client_pkg, how):
    """A threaded body drain blocked on a stalled peer ends: woken by
    ``close()`` at once, or by its own idle bound."""
    srv_ctx, cli_ctx = _ctxs(server_pkg, client_pkg, certs)

    async def main():
        ls, port = await _listen()
        stall = asyncio.Event()

        async def serve():
            t = await _accept_one(TPORT[server_pkg], ls, srv_ctx)
            await t.sendall(b"x" * 1024)  # a partial body, then nothing
            await stall.wait()
            t.close()

        server = asyncio.ensure_future(serve())
        t = await _connect(TPORT[client_pkg], port, cli_ctx)
        buf = memoryview(bytearray(1 << 20))
        try:
            if how == "close":
                drain = asyncio.ensure_future(t.recv_body_into(buf, 0))
                await asyncio.sleep(0.2)  # the worker drains 1 KiB and blocks in recv
                t0 = time.monotonic()
                t.close()
                with pytest.raises(IOError):
                    await drain
            else:
                t0 = time.monotonic()
                with pytest.raises(IOError, match="timed out"):
                    await t.recv_body_into(buf, 0, timeout=0.3)
            return time.monotonic() - t0
        finally:
            t.close()
            stall.set()
            await server
            ls.close()

    assert run(main()) < 2.0


# ---------------------------------------------------------------------------
# the raw range client and the upload server over mTLS

UPLOAD = {"port": (port_storage, port_upload), "ref": (ref_storage, ref_upload)}
RAWRANGE = {"port": port_rawrange, "ref": ref_rawrange}
METRICS = {"port": port_metrics, "ref": ref_metrics}


async def _serving(pkg: str, root, payload: bytes, tls_ctx):
    storage_mod, upload_mod = UPLOAD[pkg]
    sm = storage_mod.StorageManager(root)
    ts = sm.register_task("abc123task", url="http://x/f")
    psize = compute_piece_size(len(payload))
    ts.set_task_info(content_length=len(payload), piece_size=psize, total_pieces=piece_count(len(payload), psize))
    for idx in range(ts.meta.total_pieces):
        r = piece_range(idx, psize, len(payload))
        await ts.write_piece(idx, payload[r.start:r.start + r.length])
    ts.mark_done()
    srv = upload_mod.UploadServer(sm, tls=tls_ctx)
    await srv.start()
    return srv, ts


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_rawrange_over_mtls_across_the_packages(tmp_path, certs, payload, server_pkg, client_pkg):
    server_tls, client_tls = _bundle(server_pkg, certs), _bundle(client_pkg, certs)
    hs = METRICS[client_pkg].PIECE_TLS_HANDSHAKES_TOTAL

    async def main():
        srv, ts = await _serving(server_pkg, tmp_path / "srv", payload, server_tls.server_ctx)
        client = RAWRANGE[client_pkg].RawRangeClient(tls=client_tls)
        path_qs = "/download/abc/abc123task?peerId=p1"
        counts = []
        try:
            full0, res0 = hs.labels(resumed="false").value, hs.labels(resumed="true").value
            bodies = []
            for idx in (0, 1):  # the second range rides the pooled connection
                r = Range(idx * ts.meta.piece_size, ts.meta.piece_size)
                bodies.append(bytes(await client.get_range("127.0.0.1", srv.port, path_qs, r.header(), r.length)))
                counts.append((hs.labels(resumed="false").value - full0, hs.labels(resumed="true").value - res0))
            client._idle_ttl = -1.0  # an idle prune drops the pool
            client.prune()
            client._idle_ttl = 60.0
            r = Range(0, ts.meta.piece_size)
            bodies.append(bytes(await client.get_range("127.0.0.1", srv.port, path_qs, r.header(), r.length)))
            counts.append((hs.labels(resumed="false").value - full0, hs.labels(resumed="true").value - res0))
            return bodies, counts, ts.meta.piece_size
        finally:
            await client.close()
            await srv.stop()

    bodies, counts, psize = run(main())
    assert bodies == [payload[:psize], payload[psize:2 * psize], payload[:psize]]
    assert counts == [(1, 0), (1, 0), (1, 1)]


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_a_plain_client_is_refused_by_the_mtls_piece_server(tmp_path, certs, payload, client_pkg):
    async def main():
        srv, ts = await _serving("port", tmp_path / "srv", payload, _bundle("port", certs).server_ctx)
        client = RAWRANGE[client_pkg].RawRangeClient()  # no TLS bundle
        try:
            r = Range(0, ts.meta.piece_size)
            with pytest.raises((IOError, ConnectionError)):
                await client.get_range("127.0.0.1", srv.port, "/download/abc/abc123task?peerId=p1",
                                       r.header(), r.length, timeout=5.0)
        finally:
            await client.close()
            await srv.stop()

    run(main())


def test_a_malformed_request_is_answered_400_then_closed(tmp_path, certs, payload):
    tls = _bundle("port", certs)

    async def main():
        srv, _ = await _serving("port", tmp_path / "srv", payload, tls.server_ctx)
        t = await _connect(port_tport, srv.port, tls.client_ctx)
        try:
            # a POST with a body: unread body bytes are the reset trap that
            # would destroy the 400 in flight if the server closed undrained
            await t.sendall(b"POST /download/abc/abc123task HTTP/1.1\r\nContent-Length: 65536\r\n\r\n"
                            + b"p" * 65536)
            resp = bytearray()
            while b"\r\n\r\n" not in resp:
                chunk = await t.recv(4096)
                if not chunk:
                    break
                resp += chunk
            while await asyncio.wait_for(t.recv(4096), 5.0):
                pass  # drains to EOF: no second request is awaited
            return bytes(resp)
        finally:
            t.close()
            await srv.stop()

    resp = run(main())
    assert resp.startswith(b"HTTP/1.1 400") and b"connection: close" in resp.lower()


# ---------------------------------------------------------------------------
# engines over mTLS

ENGINE = {"port": (port_engine, port_conductor), "ref": (ref_engine, ref_conductor)}


def _engine(pkg: str, tmp_path, svc, name: str, tls):
    engine_mod, conductor_mod = ENGINE[pkg]
    return engine_mod.PeerEngine(
        storage_root=tmp_path / name, scheduler=engine_mod.InProcessSchedulerClient(svc), hostname=name,
        conductor_config=conductor_mod.ConductorConfig(metadata_poll_interval=0.02, piece_timeout=10.0),
        data_tls=tls)


@pytest.mark.parametrize("parent_pkg,child_pkg", [("port", "port"), ("ref", "port"), ("port", "ref")])
def test_engines_peer_to_peer_over_mtls(tmp_path, certs, payload, parent_pkg, child_pkg):
    async def body():
        svc = port_service.SchedulerService()
        async with Origin({"model.bin": payload}) as origin:
            parent = _engine(parent_pkg, tmp_path, svc, "tlsparent", _bundle(parent_pkg, certs))
            child = _engine(child_pkg, tmp_path, svc, "tlschild", _bundle(child_pkg, certs))
            await parent.start()
            await child.start()
            try:
                url = origin.url("model.bin")
                await parent.download_task(url)
                served0, sent = parent.upload.bytes_served, origin.bytes_sent
                out = tmp_path / "tls-dl.bin"
                await child.download_task(url, output=out)
                return (hashlib.sha256(out.read_bytes()).hexdigest(), parent.upload.bytes_served - served0,
                        origin.bytes_sent - sent, parent.upload.tls is not None)
            finally:
                await parent.stop()
                await child.stop()

    digest, served, origin_more, tls = run(body())
    assert digest == hashlib.sha256(payload).hexdigest()
    assert served == len(payload) and origin_more == 0 and tls


def test_mtls_under_chaos_faults(tmp_path):
    """The port's manager issues the leaves over its token-gated TLS RPC;
    the port's scheduler serves mutual TLS; two port engines on the mTLS
    piece plane move a file with parent-fetch errors and RPC latency
    injected, bit-exact. A client with no certificate and a plain client
    are refused by the scheduler."""
    from dragonfly2_tpu_torch.manager.server import ManagerServer
    from dragonfly2_tpu_torch.resilience import faultline
    from dragonfly2_tpu_torch.rpc.core import RpcError
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient
    from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient, serve_scheduler
    from dragonfly2_tpu_torch.security.ca import IssuedCert, client_ssl_context, server_ssl_context
    from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy

    payload = np.random.default_rng(8).integers(0, 256, 9 << 20, dtype=np.uint8).tobytes()

    async def body():
        ca = CertificateAuthority(tmp_path / "ca")
        mgr = write_issued(ca.issue("manager", sans=["127.0.0.1"]), tmp_path / "mgr")
        manager = ManagerServer(db_path=":memory:", port=0, rest_port=None, ca_dir=str(tmp_path / "ca"),
                                cert_token="boot-token", ssl=server_ssl_context(mgr["cert"], mgr["key"]))
        await manager.start()
        clients, engines, server = [], [], None
        try:
            mclient = RemoteManagerClient(manager.address, ssl=client_ssl_context(mgr["ca"]), retries=0)
            clients.append(mclient)

            async def issue(name: str) -> dict:
                d = await mclient.issue_certificate(name, sans=["127.0.0.1"], token="boot-token")
                return write_issued(IssuedCert(**{k: v.encode() for k, v in d.items()}), tmp_path / name)

            sched, daemon = await issue("scheduler"), await issue("daemon")
            svc = port_service.SchedulerService()
            server = serve_scheduler(svc, ssl=server_ssl_context(sched["cert"], sched["key"], mgr["ca"]))
            await server.start()
            addr = f"127.0.0.1:{server.port}"
            for ctx in (client_ssl_context(mgr["ca"]), None):  # no certificate; no TLS
                c = RemoteSchedulerClient(addr, timeout=2.0, retries=0, ssl=ctx)
                clients.append(c)
                with pytest.raises((RpcError, ConnectionError, OSError)):
                    await c.stat_task("x")  # dflint: disable=DF025 one refused call per client kind
            tls = port_tport.DataPlaneTls.from_paths(daemon["cert"], daemon["key"], daemon["ca"], microbench=False)
            async with Origin({"f.bin": payload}) as origin:
                url = origin.url("f.bin")
                for name in ("tls-peer1", "tls-peer2"):
                    c = RemoteSchedulerClient(addr, timeout=5.0, retries=5,
                                              backoff=BackoffPolicy(base=0.02, jitter=0.0),
                                              ssl=client_ssl_context(daemon["ca"], daemon["cert"], daemon["key"]))
                    clients.append(c)
                    engines.append(port_engine.PeerEngine(
                        storage_root=tmp_path / name, scheduler=c, hostname=name, data_tls=tls,
                        conductor_config=port_conductor.ConductorConfig(metadata_poll_interval=0.02,
                                                                        piece_timeout=10.0)))
                    await engines[-1].start()
                fl = faultline.enable("parent.fetch:error:0.35,rpc.read:latency:0.3:0.01,seed=77")
                try:
                    await engines[0].download_task(url)
                    out = tmp_path / "tls.bin"
                    await engines[1].download_task(url, output=out)
                finally:
                    faultline.disable()
                return out.read_bytes() == payload, fl.injected_total()
        finally:
            faultline.disable()
            for e in engines:
                await e.stop()
            for c in clients:
                await c.close()
            if server is not None:
                await server.stop()
            await manager.stop()

    exact, injected = run(body())
    assert exact and injected > 0
