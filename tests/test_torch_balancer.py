"""The port's scheduler client, balancer and resilience copies against the
reference's.

``ConsistentHashRing.pick`` gives the reference's owner for 10,000 keys over
3 addresses, with and without ``avoid`` and after an add and a remove; one
scripted failure/success sequence under a fake clock takes both
``CircuitBreaker``s through the same states; one seed gives both
``BackoffPolicy``s the same delays; and ``RetryBudget`` spends, refuses and
absorbs hints as the reference's does. Then the cases of
tests/test_balancer.py run against the port's ``BalancedSchedulerClient``
with fake clients, and the port's ``RemoteSchedulerClient`` drives a
reference ``serve_scheduler`` through every verb the swarm sends, answered
as the reference's client is answered by a twin scheduler. The fail-over
over real schedulers is in tests/test_torch_swarm.py.
"""

import asyncio
import dataclasses
import random

import pytest
import torch

from dragonfly2_tpu.cli.dfstress import _SWARM_RPC_VERBS as REF_SWARM_VERBS
from dragonfly2_tpu.resilience import backoff as ref_backoff
from dragonfly2_tpu.resilience import breaker as ref_breaker
from dragonfly2_tpu.resilience import budget as ref_budget
from dragonfly2_tpu.rpc import balancer as ref_balancer
from dragonfly2_tpu.rpc import scheduler as ref_rpc_scheduler
from dragonfly2_tpu.scheduler import service as ref_service
from dragonfly2_tpu.scheduler.evaluator import new_evaluator
from dragonfly2_tpu.utils.clock import VirtualClock as RefVirtualClock
from dragonfly2_tpu_torch.cli.dfstress import _SWARM_RPC_VERBS
from dragonfly2_tpu_torch.resilience import backoff, breaker, budget
from dragonfly2_tpu_torch.rpc.balancer import (
    VIRTUAL_NODES,
    BalancedSchedulerClient,
    ConsistentHashRing,
    make_scheduler_client,
)
from dragonfly2_tpu_torch.rpc.core import RpcError
from dragonfly2_tpu_torch.rpc.scheduler import (
    SCHEDULER_METHODS,
    HostInfo,
    ParentInfo,
    RegisterResult,
    RemoteSchedulerClient,
    TaskMeta,
)
from dragonfly2_tpu_torch.utils.clock import VirtualClock

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

DEADLINE_S = 30.0
SPEC = "plugin:dragonfly2_tpu_torch.scheduler.evaluator:MLEvaluator"


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


# ---- ring, breaker, backoff, budget against the reference ----


def test_ring_picks_the_references_owners_on_10000_keys():
    addrs = ["10.0.0.1:8002", "10.0.0.2:8002", "10.0.0.3:8002"]
    keys = [f"task-{i:05d}" for i in range(10_000)]
    port, ref = ConsistentHashRing(addrs), ref_balancer.ConsistentHashRing(addrs)
    assert VIRTUAL_NODES == ref_balancer.VIRTUAL_NODES == 120

    def same(avoid=frozenset(), n=len(keys)):
        got = [port.pick(k, avoid=avoid) for k in keys[:n]]
        assert got == [ref.pick(k, avoid=avoid) for k in keys[:n]]
        return got

    natural = same()
    assert len(set(natural)) == 3
    same({addrs[0]})
    # everything avoided gives the natural owner after a walk of the whole
    # ring, so on fewer keys
    assert same(set(addrs), n=200) == natural[:200]
    for ring in (port, ref):
        ring.add("10.0.0.4:8002")
    same()
    same({addrs[1], "10.0.0.4:8002"})
    for ring in (port, ref):
        ring.remove(addrs[2])
    same()
    assert port.addresses == ref.addresses
    with pytest.raises(RpcError):
        ConsistentHashRing([]).pick("x")


# (op, fake-clock advance before it): allow, success, failure or is_open
BREAKER_SCRIPT = [
    ("allow", 0), ("failure", 0), ("failure", 0), ("allow", 0), ("failure", 0), ("is_open", 0),
    ("allow", 1.0), ("allow", 4.0), ("allow", 0), ("failure", 0), ("is_open", 0), ("allow", 5.0),
    ("success", 0), ("allow", 0), ("failure", 0), ("failure", 0), ("failure", 0), ("allow", 5.0),
    ("allow", 0), ("allow", 5.0), ("failure", 0), ("allow", 0.5), ("is_open", 4.0), ("allow", 0.6),
    ("success", 0), ("is_open", 0),
]


def _breaker_trace(mod) -> list:
    now = [100.0]
    b = mod.CircuitBreaker(failure_threshold=3, reset_timeout=5.0, clock=lambda: now[0])
    trace = []
    for op, dt in BREAKER_SCRIPT:
        now[0] += dt
        out = {"allow": b.allow, "is_open": lambda: b.is_open, "success": b.record_success,
               "failure": b.record_failure}[op]()
        trace.append((op, out, b.state, b.failures))
    return trace


def test_breaker_goes_through_the_references_states():
    got, want = _breaker_trace(breaker), _breaker_trace(ref_breaker)
    assert got == want
    assert {s for _op, _out, s, _n in got} == {"closed", "open", "half_open"}


def test_backoff_gives_the_references_delays_from_one_seed():
    for kw in ({"seed": 3}, {"seed": 3, "jitter": 0.0, "max_delay": 1.0}, {"seed": 9, "base": 0.05, "multiplier": 3.0}):
        port, ref = backoff.BackoffPolicy(**kw), ref_backoff.BackoffPolicy(**kw)
        assert [port.delay(a) for a in range(12)] == [ref.delay(a) for a in range(12)]
    port = backoff.BackoffPolicy(rng=random.Random(5))
    ref = ref_backoff.BackoffPolicy(rng=random.Random(5))
    assert [port.delay(a) for a in range(6)] == [ref.delay(a) for a in range(6)]
    with pytest.raises(ValueError):
        backoff.BackoffPolicy(multiplier=0.5)


def test_retry_budget_spends_and_absorbs_hints_as_the_reference():
    port = budget.RetryBudget("scheduler", rate=2.0, burst=3.0, clock=VirtualClock())
    ref = ref_budget.RetryBudget("scheduler", rate=2.0, burst=3.0, clock=RefVirtualClock())
    trace = []
    for b in (port, ref):
        out = [b.spend() for _ in range(5)]
        b._clock.advance(1.0)
        out += [b.spend(), b.spend(), b.spend()]
        b.charge(2.0)
        out += [b.spend(), b.retry_after_remaining()]
        b._clock.advance(2.5)
        out += [b.spend(), b.stats()]
        trace.append(out)
    assert trace[0] == trace[1]


# ---- tests/test_balancer.py's cases, on the port's balancer ----


class FakeClient:
    """Records calls; used as client_factory."""

    instances: dict[str, "FakeClient"] = {}

    def __init__(self, addr: str):
        self.addr = addr
        self.calls: list[tuple] = []
        FakeClient.instances[addr] = self

    async def register_peer(self, peer_id, meta, host):
        self.calls.append(("register_peer", peer_id, meta.task_id))
        return RegisterResult(scope="normal", task_id=meta.task_id, back_to_source=True)

    async def report_piece_result(self, peer_id, piece_index, **kw):
        self.calls.append(("report_piece_result", peer_id, piece_index))

    async def report_peer_result(self, peer_id, **kw):
        self.calls.append(("report_peer_result", peer_id))

    async def announce_host(self, host, stats=None):
        self.calls.append(("announce_host", host.id))

    async def sync_probes(self, host_id, results):
        self.calls.append(("sync_probes", host_id))
        return []

    async def healthy(self):
        return True

    async def close(self):
        self.calls.append(("close",))


@pytest.fixture(autouse=True)
def _clear_fakes():
    FakeClient.instances = {}
    yield


def _balanced(addrs, **kw):
    return BalancedSchedulerClient(addrs, client_factory=FakeClient, **kw)


class TestRing:
    def test_pick_deterministic_and_distributed(self):
        addrs = [f"10.0.0.{i}:9000" for i in range(4)]
        ring = ConsistentHashRing(addrs)
        keys = [f"task-{i}" for i in range(2000)]
        owners = {k: ring.pick(k) for k in keys}
        assert owners == {k: ring.pick(k) for k in keys}  # deterministic
        counts = {a: 0 for a in addrs}
        for owner in owners.values():
            counts[owner] += 1
        for a, c in counts.items():
            assert 250 < c < 850, f"{a} owns {c}/2000 — ring badly unbalanced"

    def test_membership_change_moves_only_affected_keys(self):
        addrs = [f"10.0.0.{i}:9000" for i in range(4)]
        ring = ConsistentHashRing(addrs)
        keys = [f"task-{i}" for i in range(2000)]
        before = {k: ring.pick(k) for k in keys}
        ring.remove(addrs[0])
        after = {k: ring.pick(k) for k in keys}
        moved = sum(1 for k in keys if before[k] != after[k])
        lost = sum(1 for k in keys if before[k] == addrs[0])
        assert moved == lost  # only the removed node's keys re-hash
        ring.add(addrs[0])
        assert {k: ring.pick(k) for k in keys} == before  # add restores

    def test_empty_ring_raises(self):
        with pytest.raises(RpcError):
            ConsistentHashRing([]).pick("x")


class TestBalancedClient:
    def test_task_affinity_and_peer_map(self, run):
        async def body():
            bc = _balanced(["a:1", "b:2", "c:3"])
            meta = TaskMeta(task_id="t" * 64, url="http://x")
            host = HostInfo(id="h1", ip="127.0.0.1", hostname="h1")
            await bc.register_peer("peer-1", meta, host)
            owner = bc.ring.pick(meta.task_id)
            assert FakeClient.instances[owner].calls[0][0] == "register_peer"
            # per-peer calls follow the learned mapping, not a re-hash of peer id
            await bc.report_piece_result("peer-1", 0, success=True)
            await bc.report_peer_result("peer-1", success=True)
            calls = FakeClient.instances[owner].calls
            assert [c[0] for c in calls] == ["register_peer", "report_piece_result", "report_peer_result"]
            for addr, fc in FakeClient.instances.items():
                if addr != owner:
                    assert fc.calls == []
            await bc.close()

        run(body())

    def test_announce_host_fans_out(self, run):
        async def body():
            bc = _balanced(["a:1", "b:2", "c:3"])
            await bc.announce_host(HostInfo(id="h1", ip="1.1.1.1", hostname="h1"))
            assert sorted(FakeClient.instances) == ["a:1", "b:2", "c:3"]
            for fc in FakeClient.instances.values():
                assert ("announce_host", "h1") in fc.calls
            await bc.close()

        run(body())

    def test_resolver_updates_membership(self, run):
        async def body():
            addrs_holder = {"addrs": ["a:1", "b:2"]}

            async def resolve():
                return addrs_holder["addrs"]

            bc = _balanced(["a:1", "b:2"], resolve=resolve, resolve_interval=0.01)
            bc.start_resolver()
            # seed a client for b:2 then drop it from membership
            await bc.announce_host(HostInfo(id="h", ip="1.1.1.1", hostname="h"))
            addrs_holder["addrs"] = ["a:1", "c:3"]
            await asyncio.sleep(0.1)
            assert bc.ring.addresses == {"a:1", "c:3"}
            # the evicted client is retired (usable by in-flight calls),
            # closed only at shutdown
            assert ("close",) not in FakeClient.instances["b:2"].calls
            await bc.close()
            assert ("close",) in FakeClient.instances["b:2"].calls

        run(body())

    def test_make_scheduler_client_dispatch(self):
        assert isinstance(make_scheduler_client("127.0.0.1:9000"), RemoteSchedulerClient)
        assert isinstance(make_scheduler_client("127.0.0.1:9000,127.0.0.1:9001"), BalancedSchedulerClient)

    def test_peer_map_evicts_on_terminal_report(self, run):
        async def body():
            bc = _balanced(["a:1", "b:2"])
            meta = TaskMeta(task_id="t" * 64, url="http://x")
            host = HostInfo(id="h1", ip="127.0.0.1", hostname="h1")
            await bc.register_peer("p1", meta, host)
            assert "p1" in bc._peer_addr and meta.task_id in bc._task_addr
            await bc.report_peer_result("p1", success=True)
            assert "p1" not in bc._peer_addr  # terminal call evicts
            await bc.close()

        run(body())

    def test_task_calls_follow_learned_map_after_membership_change(self, run):
        async def body():
            bc = _balanced(["a:1", "b:2"])
            meta = TaskMeta(task_id="t" * 64, url="http://x")
            host = HostInfo(id="h1", ip="127.0.0.1", hostname="h1")
            await bc.register_peer("p1", meta, host)
            owner = bc._task_addr[meta.task_id]
            bc.ring.add("c:3")  # membership change mid-download
            client = bc._for_task(meta.task_id)
            assert client.addr == owner  # still routed to the owner
            await bc.close()

        run(body())


class TestBreakerAwareRouting:
    def test_ring_pick_avoid_walks_forward_consistently(self):
        addrs = [f"10.0.0.{i}:9000" for i in range(4)]
        ring = ConsistentHashRing(addrs)
        keys = [f"task-{i}" for i in range(500)]
        natural = {k: ring.pick(k) for k in keys}
        dead = addrs[0]
        rerouted = {k: ring.pick(k, avoid={dead}) for k in keys}
        for k in keys:
            if natural[k] != dead:
                assert rerouted[k] == natural[k]  # unaffected keys stay put
            else:
                assert rerouted[k] != dead
        # fallback owners are themselves deterministic
        assert rerouted == {k: ring.pick(k, avoid={dead}) for k in keys}
        # everything avoided → natural owner comes back (breaker fast-fails)
        assert ring.pick(keys[0], avoid=set(addrs)) == natural[keys[0]]

    def test_new_tasks_route_around_open_breaker(self, run):
        async def body():
            bc = _balanced(["a:1", "b:2", "c:3"])
            host = HostInfo(id="h1", ip="127.0.0.1", hostname="h1")
            # find a task whose natural owner is "a:1", then open a:1's breaker
            tid = next(f"{i:064d}" for i in range(1000) if bc.ring.pick(f"{i:064d}") == "a:1")
            b = breaker.CircuitBreaker(failure_threshold=1, reset_timeout=60.0)
            b.record_failure()
            bc._client("a:1").breaker = b  # FakeClient grows a breaker
            meta = TaskMeta(task_id=tid, url="http://x")
            await bc.register_peer("p1", meta, host)
            assert bc._task_addr[tid] != "a:1"  # routed around the open target
            assert FakeClient.instances["a:1"].calls == []
            await bc.close()

        run(body())

    def test_sticky_tasks_stay_on_open_owner(self, run):
        async def body():
            bc = _balanced(["a:1", "b:2"])
            meta = TaskMeta(task_id="t" * 64, url="http://x")
            host = HostInfo(id="h1", ip="127.0.0.1", hostname="h1")
            await bc.register_peer("p1", meta, host)
            owner = bc._task_addr[meta.task_id]
            b = breaker.CircuitBreaker(failure_threshold=1, reset_timeout=60.0)
            b.record_failure()
            bc._client(owner).breaker = b
            # learned route is NOT rerouted: its state lives on the owner
            assert bc._for_task(meta.task_id).addr == owner
            await bc.close()

        run(body())


# ---- the port's scheduler client on a reference scheduler ----


def test_wire_dataclasses_are_the_references_field_for_field():
    host = dict(id="h1", ip="10.0.0.1", hostname="host1", port=1, download_port=2, type="seed", idc="i",
                location="a|b")
    meta = dict(task_id="t1", url="http://o/f", digest="sha256:x", tag="g", application="app",
                filters=("a",), priority=3.0)
    parent = dict(peer_id="p", host_id="h", ip="1.1.1.1", download_port=9)
    for port_cls, ref_cls, kw, required in ((HostInfo, ref_service.HostInfo, host, 3),
                                            (TaskMeta, ref_service.TaskMeta, meta, 2),
                                            (ParentInfo, ref_service.ParentInfo, parent, 4)):
        least = {k: kw[k] for k in list(kw)[:required]}  # the defaults too
        for args in (kw, least):
            assert dataclasses.asdict(port_cls(**args)) == dataclasses.asdict(ref_cls(**args))
    res = dict(scope="normal", task_id="t1")
    full = dict(res, back_to_source=True, direct_piece=b"x", content_length=5, piece_size=4, total_pieces=2,
                digest="d", error="overloaded", retry_after_s=1.5)
    for kw in (res, full):
        assert dataclasses.asdict(RegisterResult(**kw)) == dataclasses.asdict(ref_service.RegisterResult(**kw))
    assert (dataclasses.asdict(RegisterResult(parents=[ParentInfo(**parent)], **res))
            == dataclasses.asdict(ref_service.RegisterResult(parents=[ref_service.ParentInfo(**parent)], **res)))
    assert SCHEDULER_METHODS == ref_rpc_scheduler.SCHEDULER_METHODS
    assert _SWARM_RPC_VERBS == REF_SWARM_VERBS


def _wire(x):
    """A result as the wire carries it: dataclasses as dicts."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


async def _verbs(client, host_cls, meta_cls) -> list:
    """Every verb the swarm sends, in a swarm round's order and beyond."""
    hosts = [host_cls(id=f"h{i}", ip=f"10.0.0.{i}", hostname=f"host{i}", download_port=8000 + i,
                      idc="idc1", location="cn|a") for i in range(4)]
    meta = meta_cls(task_id="t" * 64, url="http://origin/f.bin")
    out = []
    for h in hosts:
        out.append(await client.announce_host(h, {"cpu": 0.5}))  # dflint: disable=DF025 one host each, the swarm's start
    seed = await client.register_peer("p0", meta, hosts[0])
    out.append(seed)
    out.append(await client.report_task_metadata(meta.task_id, content_length=8 << 20, piece_size=4 << 20))
    out.append(await client.report_pieces("p0", [(0, 8.0, ""), (1, 9.0, "")]))
    out.append(await client.report_piece_result("p0", 1, success=True, cost_ms=4.0))
    out.append(await client.report_peer_result("p0", success=True, bandwidth_bps=2e8))
    child = await client.register_peer("p1", meta, hosts[1])
    out.append(child)
    out.append(await client.report_pieces("p1", [(0, 5.0, "p0")]))
    out.append(await client.reschedule("p1"))
    out.append(await client.sync_probes("h1", [{"dst_host_id": "h2", "rtt_ms": 3.0, "success": True}]))
    out.append(await client.announce_task("p2", meta, hosts[2], content_length=8 << 20, piece_size=4 << 20,
                                          piece_indices=[0, 1]))
    out.append(await client.stat_task(meta.task_id))
    out.append(await client.leave_peer("p1"))
    out.append(await client.leave_host("h2"))
    out.append(await client.stat_task(meta.task_id))
    try:
        await client.reschedule("nobody")
        out.append("no error")
    except Exception as e:
        out.append((type(e).__name__, e.code, str(e)))
    out.append(await client.healthy())
    return [_wire(x) for x in out]


def test_port_scheduler_client_on_a_reference_scheduler_answers_as_the_references():
    async def one(port: bool):
        svc = ref_service.SchedulerService(evaluator=new_evaluator(SPEC), topology_rng=random.Random(0))
        server = ref_rpc_scheduler.serve_scheduler(svc)
        await server.start()
        client = (RemoteSchedulerClient if port else ref_rpc_scheduler.RemoteSchedulerClient)(server.address)
        try:
            return await _verbs(client, HostInfo if port else ref_service.HostInfo,
                                TaskMeta if port else ref_service.TaskMeta)
        finally:
            await client.close()
            await server.stop()
            svc.close()

    got, want = _run(one(True)), _run(one(False))
    assert got == want
    seed, child = got[4], got[9]
    assert seed["back_to_source"] and child["parents"] and child["parents"][0]["peer_id"] == "p0"
