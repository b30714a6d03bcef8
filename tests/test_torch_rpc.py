"""The port's RPC wire against the JAX package's: byte-equal frames, and each
package's server answering the other's client.

The port encodes frames with its own codec (``trainer/_msgpack.packb``);
every payload the trainer and manager methods send is held byte for byte to
``msgpack.packb(use_bin_type=True)``, and its decoder to
``msgpack.unpackb(raw=False)``. Then a port ``RpcServer`` answers a reference
``RpcClient`` and a reference ``RpcServer`` answers a port ``RpcClient``,
results and error frames alike, and the reference's trainer client drives
the port's trainer front.
"""

import asyncio
import socket

import msgpack
import numpy as np
import pytest
import torch

from dragonfly2_tpu.manager.service import ManagerService
from dragonfly2_tpu.observability.tracing import default_tracer as ref_tracer
from dragonfly2_tpu.resilience import backoff as ref_backoff
from dragonfly2_tpu.resilience import breaker as ref_breaker
from dragonfly2_tpu.resilience import budget as ref_budget
from dragonfly2_tpu.resilience import deadline as ref_deadline
from dragonfly2_tpu.rpc import core as ref_core
from dragonfly2_tpu.rpc.trainer import RemoteTrainerClient as RefTrainerClient
from dragonfly2_tpu_torch.resilience import backoff, breaker, budget, deadline
from dragonfly2_tpu_torch.rpc import core
from dragonfly2_tpu_torch.rpc.trainer import TRAINER_METHODS, RemoteTrainerClient, register_trainer
from dragonfly2_tpu_torch.trainer import _msgpack
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import synth_telemetry_records

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

DEADLINE_S = 60.0


def _records():
    downloads, probes = synth_telemetry_records(64, 48, 12, seed=3)
    return downloads, probes


def _payloads() -> dict:
    """What the trainer and manager methods put on the wire: requests as the
    clients build them, replies as the services return them."""
    downloads, probes = _records()
    mgr = ManagerService()
    row = mgr.publish_model("gnn", "v1", scheduler_id=0, evaluation={"loss": 0.125, "steps": 20},
                            artifact_path="/models/gnn-v1", artifact_digest="ab" * 32)
    return {
        "train_open": {"hostname": "sch1", "scheduler_id": 0},
        "train_chunk_downloads": {"token": "t" * 32, "kind": "downloads", "data": pack_records(downloads)},
        "train_chunk_probes": {"token": "t" * 32, "kind": "probes", "data": pack_records(probes)},
        "train_close": {"token": "t" * 32},
        "status_reply": {"training": False, "queue_depth": 0, "pool_pairs": 64, "last_result": None,
                         "trains_succeeded": 1},
        "publish_model": {"type": "gnn", "version": "20261017-1", "scheduler_id": 0,
                          "evaluation": {"train_mse": 0.0123, "eval_mse": None, "steps": 300,
                                         "steps_per_sec": 97.24, "contributors": ["sch1"]},
                          "artifact_path": "/models/gnn-20261017-1", "artifact_digest": "cd" * 32},
        "publish_model_reply": row,
        "keepalive": {"source_type": "trainer", "hostname": "trainer-0", "cluster_id": None},
        "error_frame": {"i": 7, "e": {"code": "not_found", "message": "no session 'x'"}},
        "request_frame": {"i": 2**31, "m": "status", "p": None, "t": "00-" + "1" * 32 + "-" + "2" * 16 + "-01"},
        "floats": [0.0, -0.0, 1e-300, 1.5, float("inf"), -2.25e17],
        "wide": {"k" * 40: list(range(20)), "n": -2**40, "b": bytearray(b"x" * 300), "t": (True, False)},
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_codec_frames_are_byte_equal_to_msgpack(name):
    obj = _payloads()[name]
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_reads_float32_and_refuses_what_rpc_does_not_carry():
    assert _msgpack.unpackb(msgpack.packb(np.float32(0.5).item(), use_single_float=True)) == 0.5
    with pytest.raises(TypeError, match="RPC payload"):
        _msgpack.packb({"a": np.zeros(2)})
    with pytest.raises(TypeError, match="RPC payload"):
        _msgpack.packb({"a": np.float32(1.0)})
    with pytest.raises(ValueError, match="outside the subset RPC"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"xx")))
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(_msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(_msgpack.packb({"a": b"xyz"})[:-1])
    # the flax pair stays as strict as flax
    with pytest.raises(ValueError, match="outside the subset"):
        _msgpack.from_bytes(_msgpack.packb({"a": None}))


class _Echo:
    async def echo(self, p):
        return p

    async def slow(self, p):
        await asyncio.sleep(p)
        return p

    async def refuse(self, p):
        raise core.RpcError("no session 'x'", code="not_found")

    async def refuse_ref(self, p):
        raise ref_core.RpcError("no session 'x'", code="not_found")

    async def crash(self, p):
        raise ValueError("bad chunk")


METHODS = ["echo", "slow", "refuse", "refuse_ref", "crash"]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


@pytest.mark.parametrize("direction", ["port_server_ref_client", "ref_server_port_client"])
def test_each_package_answers_the_others_client(direction):
    async def body():
        port_server = direction == "port_server_ref_client"
        server = (core.RpcServer if port_server else ref_core.RpcServer)(host="127.0.0.1", port=0)
        server.register_service(_Echo(), METHODS)
        await server.start()
        client = (ref_core.RpcClient(server.address, retries=0) if port_server
                  else core.RpcClient(server.address))
        try:
            payload = {"data": b"\x00\x01" * 40_000, "f": 0.25, "n": None, "ok": True, "rows": [1, -2, 3]}
            assert await client.call("echo", payload) == payload
            # a traced caller stamps "t" on the frame; the port's server ignores it
            with ref_tracer().span("test.caller"):
                assert await client.call("echo", [1, 2]) == [1, 2]
            # many calls in flight on one connection, answered by id
            got = await asyncio.gather(*(client.call("slow", 0.05 * (5 - i)) for i in range(5)))
            assert got == [0.05 * (5 - i) for i in range(5)]
            err_type = ref_core.RpcError if port_server else core.RpcError
            with pytest.raises(err_type) as e:
                await client.call("nope")
            assert e.value.code == "unimplemented"
            refuse = "refuse" if port_server else "refuse_ref"
            with pytest.raises(err_type) as e:
                await client.call(refuse)
            assert (e.value.code, str(e.value)) == ("not_found", "no session 'x'")
            with pytest.raises(err_type) as e:
                await client.call("crash")
            assert (e.value.code, str(e.value)) == ("internal", "ValueError: bad chunk")
            assert await client.healthy()
            with pytest.raises(err_type) as e:
                await client.call("slow", 5.0, timeout=0.2)
            assert e.value.code == "deadline_exceeded"
            assert await client.call("echo", "still open") == "still open"
        finally:
            await client.close()
            await server.stop()

    _run(body())


def _client_of(port: bool):
    """A client factory of one package, with a short fixed backoff."""
    cls, policy = (core.RpcClient, backoff.BackoffPolicy) if port else (ref_core.RpcClient, ref_backoff.BackoffPolicy)
    return lambda addr, **kw: cls(addr, **{"backoff": policy(base=0.01, jitter=0.0), **kw})


def test_port_client_reconnects_and_fails_pending_calls_on_close():
    """close() fails the calls in flight with ConnectionClosed. A client
    with retries takes that as a dropped connection and answers the call on
    a new one, as the reference's client does on the same script; with
    retries=0 the call raises. Either way the next call reconnects."""

    async def script(make_client):
        server = core.RpcServer()
        server.register_service(_Echo(), METHODS)
        await server.start()
        outcomes = []
        try:
            for retries in (0, 3):
                client = make_client(server.address, retries=retries)
                try:
                    assert await client.call("echo", 1) == 1  # dflint: disable=DF025 one client per retry setting
                    pending = asyncio.ensure_future(client.call("slow", 0.3))
                    await asyncio.sleep(0.1)
                    await client.close()
                    try:
                        outcomes.append(("ok", await pending))
                    except (core.RpcError, ref_core.RpcError) as e:
                        outcomes.append((type(e).__name__, e.code))
                    assert await client.call("echo", 2) == 2  # dflint: disable=DF025 a new connection, one per client
                finally:
                    await client.close()
            await server.stop()
            assert not await client.healthy()
        finally:
            await client.close()
        return outcomes

    port, ref = _run(script(_client_of(True))), _run(script(_client_of(False)))
    assert port == ref == [("ConnectionClosed", "unavailable"), ("ok", 0.3)]


class _Scripted:
    """Handlers that answer by a script; ``calls`` counts each one's calls."""

    def __init__(self):
        self.calls: dict[str, int] = {}

    def _n(self, name: str) -> int:
        self.calls[name] = self.calls.get(name, 0) + 1
        return self.calls[name]

    async def busy_then_ok(self, p):
        if self._n("busy_then_ok") <= 2:
            raise core.RpcError("busy", code="resource_exhausted")
        return "ok"

    async def always_busy(self, p):
        self._n("always_busy")
        raise core.RpcError("busy", code="resource_exhausted")

    async def hint(self, p):
        self._n("hint")
        raise core.RpcError("overloaded", code="resource_exhausted", retry_after_s=5.0)

    async def refuse(self, p):
        self._n("refuse")
        raise core.RpcError("no such peer", code="not_found")

    async def slow(self, p):
        self._n("slow")
        await asyncio.sleep(p)
        return p


def test_retries_deadlines_and_hints_on_one_scripted_server_as_the_reference_client():
    """One script on a port server per client package: retries on
    resource_exhausted, no retry on other codes, a retry_after_s hint
    pre-charging the retry budget, deadline_exceeded from the per-call
    timeout and from a propagated deadline (the breaker charged only for a
    silent full window), the server's QPS bucket, and the breaker opening
    on refused connections. Both clients must see the same outcomes."""

    async def script(port: bool):
        make = _client_of(port)
        budget_mod, dl_mod = (budget, deadline) if port else (ref_budget, ref_deadline)
        handlers = _Scripted()
        server = core.RpcServer()
        server.register_service(handlers, ["busy_then_ok", "always_busy", "hint", "refuse", "slow"])
        limited = core.RpcServer(qps_limit=2, qps_burst=1)
        limited.register_service(_Echo(), METHODS)
        await server.start()
        await limited.start()
        out = []

        async def attempt(client, method, payload=None, **kw):
            try:
                got = ("ok", await client.call(method, payload, **kw))
            except (core.RpcError, ref_core.RpcError) as e:
                # the message up to the measured window or the last error
                got = (type(e).__name__, e.code, str(e).split(" (last")[0].split(" after ")[0], e.retry_after_s)
            except OSError as e:
                got = (type(e).__name__,)
            out.append((method, got, client.breaker.state, client.breaker.failures))

        spent = budget_mod.RetryBudget("scheduler", rate=1.0, burst=5.0)
        clients = [make(server.address), make(server.address, retries=2),
                   make(server.address, retry_budget=spent)]
        try:
            c, c2, cb = clients
            await attempt(c, "busy_then_ok")
            await attempt(c2, "always_busy")
            await attempt(c, "refuse")
            await attempt(cb, "hint")
            out.append(("budget", spent.charges, spent.spent, spent.denied))
            await attempt(c, "slow", 1.0, timeout=0.2)  # silent for its whole window
            with dl_mod.scope(0.2):
                await attempt(c, "slow", 1.0, timeout=5.0)  # the caller's deadline cut it
            with dl_mod.scope(0.0):
                await attempt(c, "slow", 0.0)
            await attempt(c, "slow", 0.0)
            out.append(("calls", sorted(handlers.calls.items())))
            lc = make(limited.address, retries=0)
            clients.append(lc)
            await attempt(lc, "echo", 1)
            await attempt(lc, "echo", 2)  # past the burst: rate limited
            lr = make(limited.address, retries=1, backoff=(backoff if port else ref_backoff).BackoffPolicy(
                base=0.6, jitter=0.0))
            clients.append(lr)
            await attempt(lr, "echo", 3)  # limited once, then answered after the backoff
            dead = make("127.0.0.1:1", retries=3, breaker=(breaker if port else ref_breaker).CircuitBreaker(
                failure_threshold=2))
            clients.append(dead)
            await attempt(dead, "echo", 4)
            await attempt(dead, "echo", 5)
        finally:
            for cl in clients:
                await cl.close()
            await server.stop()
            await limited.stop()
        return out

    got, want = _run(script(True)), _run(script(False))
    assert got == want
    by = {(m, i): o for i, (m, *o) in enumerate(got)}
    assert by[("busy_then_ok", 0)][0] == ("ok", "ok")
    assert by[("always_busy", 1)][0][:2] == ("RpcError", "resource_exhausted")
    assert by[("hint", 3)][0][:3] == ("RpcError", "unavailable", "hint: retry budget exhausted for scheduler")
    assert got[4] == ("budget", 1, 0, 1)
    assert [o[1][1] for o in got[5:8]] == ["deadline_exceeded"] * 3 and [o[3] for o in got[5:7]] == [1, 1]
    assert got[9] == ("calls", [("always_busy", 3), ("busy_then_ok", 3), ("hint", 1), ("refuse", 1), ("slow", 3)])
    assert got[11][1][:3] == ("RpcError", "resource_exhausted", "rate limited") and got[12][1] == ("ok", 3)
    # two refused connections open the breaker; the third attempt, and the
    # next call, are refused at the breaker without a connection
    for o in got[13:15]:
        assert o[1][:3] == ("RpcError", "unavailable", "circuit open to 127.0.0.1:1") and o[2:] == ("open", 2)


def test_target_class_shares_one_process_wide_budget_as_the_reference():
    """Clients naming one target class spend from one process-wide budget,
    created with the reference's rate and burst; another class gets its
    own, and a client naming none retries unbudgeted."""
    seen = []
    for core_mod, budget_mod in ((core, budget), (ref_core, ref_budget)):
        a = core_mod.RpcClient("127.0.0.1:1", target_class="rpc-test-class")
        b = core_mod.RpcClient("127.0.0.1:2", target_class="rpc-test-class")
        other = core_mod.RpcClient("127.0.0.1:3", target_class="rpc-test-other")
        assert a.retry_budget is b.retry_budget is budget_mod.budget_for("rpc-test-class")
        assert other.retry_budget is not a.retry_budget
        assert core_mod.RpcClient("127.0.0.1:4").retry_budget is None
        seen.append((a.retry_budget.name, a.retry_budget.rate, a.retry_budget.burst, other.retry_budget.name))
    assert seen[0] == seen[1] == ("rpc-test-class", 10.0, 20.0, "rpc-test-other")


def test_stop_returns_with_a_connection_accepted_as_it_began():
    """A connection the loop accepts while ``stop()`` begins (its handler
    not yet run) must not hold ``wait_closed()`` until the peer hangs up:
    stop() is called 0-7 loop steps after the peer connects, so that it
    lands in each stage of the accept."""

    async def body():
        stopped = []
        for steps in range(8):
            server = core.RpcServer()
            await server.start()
            peer = socket.create_connection(("127.0.0.1", server.port))
            try:
                for _ in range(steps):
                    await asyncio.sleep(0)
                await asyncio.wait_for(server.stop(), 5.0)
                stopped.append(steps)
            finally:
                peer.close()
        return stopped

    assert _run(body()) == list(range(8))


def test_port_server_refuses_an_oversized_frame():
    async def body():
        server = core.RpcServer()
        server.register_service(_Echo(), METHODS)
        await server.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            writer.write((core.MAX_FRAME + 1).to_bytes(4, "big"))
            await writer.drain()
            assert await reader.read() == b""  # the server closed the connection
            writer.close()
        finally:
            await server.stop()

    _run(body())


@pytest.mark.parametrize("client_kind", ["port", "reference"])
def test_trainer_front_over_the_wire(client_kind, tmp_path):
    """Either package's trainer client opens, chunks and closes a session on
    the port's trainer front; status and train_history cross the wire."""

    async def body():
        svc = TrainerService(TrainerConfig(model_dir=str(tmp_path / "models"), device="cpu", min_pairs=10**9))
        server = core.RpcServer()
        register_trainer(server, svc)
        await server.start()
        client = (RemoteTrainerClient if client_kind == "port" else RefTrainerClient)(server.address)
        downloads, probes = _records()
        try:
            token = await client.train_open("sch1", 0)
            assert await client.train_chunk(token, "downloads", downloads) == len(downloads)
            assert await client.train_chunk(token, "probes", probes) == len(downloads) + len(probes)
            await client.train_close(token)
            await svc.wait_idle()
            status = await client.status()
            assert status == await svc.status()  # every field as the service gives it
            assert status["trains_started"] == 1 and 0 < status["pool_pairs"] <= len(downloads)
            history = await client.train_history(limit=4, with_curves=False)
            assert history == await svc.train_history({"limit": 4, "with_curves": False})
            assert history["total"] == 1 and history["runs"][0]["status"] == "skipped"
            with pytest.raises(Exception, match="bogus"):
                await client.train_chunk("bogus", "downloads", downloads)
        finally:
            await client.close()
            await server.stop()

    assert TRAINER_METHODS == __import__("dragonfly2_tpu.rpc.trainer", fromlist=["x"]).TRAINER_METHODS
    _run(body())


def test_port_manager_client_publishes_and_keeps_alive(tmp_path):
    """The trainer side's manager calls, from the port's client to the
    reference ManagerServer: publish_model lands an active row; keepalive
    answers as it answers the reference's client (a trainer has no registry
    row, so without a stats frame it records nothing: False)."""
    from dragonfly2_tpu.manager.server import ManagerServer
    from dragonfly2_tpu.rpc.manager import RemoteManagerClient as RefManagerClient
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient

    async def body():
        manager = ManagerServer(db_path=str(tmp_path / "m.db"))
        await manager.start()
        client, ref = RemoteManagerClient(manager.address), RefManagerClient(manager.address)
        try:
            assert await client.healthy()
            row = await client.publish_model("gnn", "v-port", scheduler_id=0, evaluation={"final_loss": 0.125},
                                             artifact_path="/models/gnn-v-port", artifact_digest="ab" * 32)
            assert row["state"] == "active" and row["version"] == "v-port"
            assert await ref.active_model("gnn", 0) == row
            want = await ref.keepalive("trainer", "trainer-0")
            assert await client.keepalive("trainer", "trainer-0") is want is False
        finally:
            await client.close()
            await ref.close()
            await manager.stop()

    _run(body())


@pytest.mark.parametrize("direction", ["port-client-ref-server", "ref-client-port-server"])
def test_big_frames_and_coalesced_writes_cross_the_packages(direction):
    """Frames past the 64 KiB zero-copy threshold, and 200 calls in flight
    on one connection (their frames coalesced into batched writes), each
    way between the packages, answered exactly."""
    client_mod, server_mod = (core, ref_core) if direction.startswith("port") else (ref_core, core)
    rng = np.random.default_rng(11)
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (64 << 10, (64 << 10) + 1, 3 << 20)]

    async def body():
        server = server_mod.RpcServer(port=0)

        async def echo(p):
            return p

        server.register("echo", echo)
        await server.start()
        client = client_mod.RpcClient(f"127.0.0.1:{server.port}", retries=0)
        try:
            big = [await client.call("echo", {"b": b}) for b in blobs]  # dflint: disable=DF025 one call per frame size under test
            many = await asyncio.gather(*(client.call("echo", {"i": i, "pad": "x" * (i % 97)}) for i in range(200)))
            return big, many
        finally:
            await client.close()
            await server.stop()

    big, many = _run(body())
    assert [b["b"] for b in big] == blobs
    assert many == [{"i": i, "pad": "x" * (i % 97)} for i in range(200)]
