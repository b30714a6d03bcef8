"""The port's scheduler federation (``FederationSync``) against the reference's.

The wire-sync cases of tests/test_federation.py run between two port
services, and between a port scheduler and a reference one over the wire in
both directions (the port's gossip loop syncing a reference responder, the
reference's syncing a port responder): push-pull converges both sides over
one edge, steady state ships nothing, a replay after lost watermarks is
idempotent, a restarted peer resets the watermarks and replays, a member that
reaches itself excludes the address, and the loop counts a dead peer without
stopping. The merged views of every pairing equal the reference pair's.
Membership from the manager: two port schedulers registered with the port's
manager find each other through their ManagerLinks' address books. Failover:
a ring member dies; the survivor keeps the edges it merged from it, its sync
counts the dead peer, and the port's balanced client re-shards to it.
"""

from __future__ import annotations

import asyncio
import types

import pytest
import torch

import dragonfly2_tpu.rpc.scheduler as ref_rpc
import dragonfly2_tpu.scheduler.federation as ref_federation
import dragonfly2_tpu.scheduler.service as ref_service
import dragonfly2_tpu_torch.rpc.scheduler as port_rpc
import dragonfly2_tpu_torch.scheduler.federation as port_federation
import dragonfly2_tpu_torch.scheduler.service as port_service
from dragonfly2_tpu_torch.manager.server import ManagerServer
from dragonfly2_tpu_torch.rpc.balancer import BalancedSchedulerClient
from dragonfly2_tpu_torch.scheduler import metrics as port_metrics
from dragonfly2_tpu_torch.scheduler.manager_link import ManagerLink
from dragonfly2_tpu_torch.scheduler.service import HostInfo

torch.set_num_threads(1)


# each test's coroutine runs under this deadline (conftest's runner has
# none), so that a stuck await fails its test instead of holding the suite
DEADLINE_S = 120.0


@pytest.fixture
def run():
    """conftest's runner (a fresh loop in debug mode) under DEADLINE_S."""
    return lambda coro: asyncio.run(asyncio.wait_for(coro, DEADLINE_S), debug=True)

PKGS = {
    "port": types.SimpleNamespace(Service=port_service.SchedulerService, serve=port_rpc.serve_scheduler,
                                  FederationSync=port_federation.FederationSync),
    "ref": types.SimpleNamespace(Service=ref_service.SchedulerService, serve=ref_rpc.serve_scheduler,
                                 FederationSync=ref_federation.FederationSync),
}
# (initiator, responder): the initiator's service runs the gossip loop
PAIRS = pytest.mark.parametrize("pair", [("port", "port"), ("port", "ref"), ("ref", "port")],
                                ids=["port-port", "port-ref", "ref-port"])


def merged_view(svc) -> dict:
    """What a member merged from its peers: remote edges by (src, dst) with
    the rtt they answer, and the merged bandwidth pairs."""
    topo = {k: svc.topology.avg_rtt_ms(*k) for k in sorted(svc.topology._remote)}
    return {"edges": topo, "remote_bw": svc.bandwidth.remote_entry_count(),
            "bw": svc.bandwidth.query("seed", "child")}


async def _pair(initiator: str, responder: str):
    a, b = PKGS[initiator], PKGS[responder]
    sa, sb = a.Service(), b.Service()
    srv_a, srv_b = a.serve(sa, port=0), b.serve(sb, port=0)
    await srv_a.start()
    await srv_b.start()
    return a, b, sa, sb, srv_a, srv_b


async def _converge(initiator: str, responder: str) -> dict:
    a, b, sa, sb, srv_a, srv_b = await _pair(initiator, responder)
    sb.topology.enqueue("child", "seed", 4.2)
    sb.topology.enqueue("c2", "seed", 1.5)
    sa.bandwidth.observe("seed", "child", 3e8)
    sa.topology.enqueue("x", "y", 2.0)
    fed = a.FederationSync(sa, self_addr=srv_a.address, name="schA", peers=[srv_b.address])
    try:
        first = await fed.sync_peer(srv_b.address)
        views = {"a": merged_view(sa), "b": merged_view(sb)}
        out = await fed.sync_peer(srv_b.address)
        steady = (out["edges"], out["bandwidth"])
        fed._state.clear()
        before = sa.topology.remote_edge_count()
        await fed.sync_peer(srv_b.address)
        replay_same = sa.topology.remote_edge_count() == before
        return {"views": views, "steady": steady, "replay_same": replay_same,
                "first_edges": len(first["edges"]), "status": fed.status()}
    finally:
        await fed.stop()
        await srv_a.stop()
        await srv_b.stop()
        sa.close()
        sb.close()


@PAIRS
def test_push_pull_converges_both_sides_over_one_edge(run, pair):
    got = run(_converge(*pair))
    assert got["views"]["a"]["edges"] == {("c2", "seed"): 1.5, ("child", "seed"): 4.2}
    assert got["views"]["b"]["bw"] == 3e8 and got["views"]["b"]["edges"] == {("x", "y"): 2.0}
    assert got["steady"] == ([], [])
    assert got["replay_same"]
    assert got["status"]["peers"] == [got["status"]["peers"][0]] and got["status"]["syncs_failed"] == 0
    # the merged views equal the reference pair's
    assert got["views"] == run(_converge("ref", "ref"))["views"]


@PAIRS
def test_peer_restart_resets_watermarks_and_replays(run, pair):
    async def body():
        a, b, sa, sb, srv_a, srv_b = await _pair(*pair)
        port = srv_b.port
        sa.topology.enqueue("a-src", "a-dst", 1.0)
        for i in range(5):
            sb.topology.enqueue(f"b{i}", "hub", 2.0)
        fed = a.FederationSync(sa, self_addr=srv_a.address, name="schA", peers=[srv_b.address])
        try:
            await fed.sync_peer(srv_b.address)
            assert sa.topology.remote_edge_count() == 5
            assert sb.topology.avg_rtt_ms("a-src", "a-dst") == 1.0
            await srv_b.stop()
            sb.close()
            sb2 = b.Service()
            srv_b2 = b.serve(sb2, port=port)
            await srv_b2.start()
            sb2.topology.enqueue("fresh", "edge", 3.0)
            await fed.sync_peer(srv_b.address)
            assert sa.topology.avg_rtt_ms("fresh", "edge") == 3.0
            assert sb2.topology.avg_rtt_ms("a-src", "a-dst") == 1.0
            assert sa.topology.remote_edge_count() == 1
            assert sa.topology.avg_rtt_ms("b0", "hub") is None
            await srv_b2.stop()
            sb2.close()
        finally:
            await fed.stop()
            await srv_a.stop()
            sa.close()

    run(body())


def test_member_reaching_itself_self_excludes(run):
    async def body():
        sa = port_service.SchedulerService()
        srv = port_rpc.serve_scheduler(sa, port=0)
        await srv.start()
        sa.topology.enqueue("x", "y", 1.0)
        fed = port_federation.FederationSync(sa, self_addr="0.0.0.0:9999", name="schA", peers=[srv.address])
        try:
            await fed.sync_once()
            assert sa.topology.remote_edge_count() == 0
            assert srv.address not in fed.peer_addresses()
        finally:
            await fed.stop()
            await srv.stop()
            sa.close()

    run(body())


@PAIRS
def test_sync_loop_runs_and_recovers_from_dead_peer(run, pair):
    async def body():
        a, b, sa, sb, srv_a, srv_b = await _pair(*pair)
        fed = a.FederationSync(sa, self_addr="127.0.0.1:0", name="schA",
                               peers=["127.0.0.1:1", srv_b.address], interval=0.05)
        sb.topology.enqueue("x", "y", 1.0)
        fails = port_metrics.FEDERATION_SYNCS_TOTAL.labels(result="error").value
        fed.start()
        try:
            deadline = asyncio.get_running_loop().time() + 5.0
            while asyncio.get_running_loop().time() < deadline:
                if fed.syncs_ok >= 2 and sa.topology.remote_edge_count() == 1:
                    break
                await asyncio.sleep(0.02)
            assert fed.syncs_ok >= 2 and fed.syncs_failed >= 1
            assert sa.topology.avg_rtt_ms("x", "y") == 1.0
            if pair[0] == "port":
                assert port_metrics.FEDERATION_SYNCS_TOTAL.labels(result="error").value > fails
                assert port_metrics.FEDERATION_PEERS_GAUGE.value == 2
                assert port_metrics.FEDERATION_LAST_SYNC_TIMESTAMP.value > 0
        finally:
            await fed.stop()
            await srv_a.stop()
            await srv_b.stop()
            sa.close()
            sb.close()

    run(body())


def test_membership_follows_the_managers_address_book(run, tmp_path):
    """Two port schedulers register with the port's manager; each link's
    address book names the other, and ``federation_peers`` feeds the sync."""

    async def body():
        manager = ManagerServer(db_path=str(tmp_path / "m.db"))
        await manager.start()
        svcs = [port_service.SchedulerService() for _ in range(2)]
        srvs = [port_rpc.serve_scheduler(s, port=0) for s in svcs]
        for s in srvs:
            await s.start()
        links = [ManagerLink(svc, manager.address, hostname=f"sch-{i}", ip="127.0.0.1", port=srv.port)
                 for i, (svc, srv) in enumerate(zip(svcs, srvs))]
        feds = []
        try:
            for link in links:
                await link.start()
            for link in links:
                await link.dynconfig.refresh()
            assert links[0].federation_peers() == [srvs[1].address]
            assert links[1].federation_peers() == [srvs[0].address]
            svcs[1].topology.enqueue("p", "q", 7.0)
            feds = [port_federation.FederationSync(svc, self_addr=srv.address, peers_fn=link.federation_peers)
                    for svc, srv, link in zip(svcs, srvs, links)]
            for fed in feds:
                await fed.sync_once()
            assert svcs[0].topology.avg_rtt_ms("p", "q") == 7.0
            assert svcs[0].federation_state()["remote_edges"] == 1
            status = feds[0].status()
            assert status["peers"] == [srvs[1].address] and status["syncs_ok"] == 1
        finally:
            for fed in feds:
                await fed.stop()
            for link in links:
                await link.stop()
            for s in srvs:
                await s.stop()
            for svc in svcs:
                svc.close()
            await manager.stop()

    run(body())


def test_failover_the_survivor_keeps_merged_edges_and_serves(run):
    async def body():
        svcs = [port_service.SchedulerService() for _ in range(2)]
        srvs = [port_rpc.serve_scheduler(s, port=0) for s in svcs]
        for s in srvs:
            await s.start()
        addrs = [s.address for s in srvs]
        live = list(addrs)

        async def resolve():
            return list(live)

        svcs[0].topology.enqueue("child", "seed", 3.0)
        fed = port_federation.FederationSync(svcs[1], self_addr=addrs[1], peers=[addrs[0]])
        client = BalancedSchedulerClient(addrs, resolve=resolve, resolve_interval=0.05)
        client.start_resolver()
        try:
            await fed.sync_once()
            assert svcs[1].topology.avg_rtt_ms("child", "seed") == 3.0
            await srvs[0].stop()
            live.remove(addrs[0])
            await asyncio.sleep(0.3)  # a resolver tick re-shards the ring
            assert client.ring.addresses == {addrs[1]}
            await fed.sync_once()
            assert fed.syncs_failed == 1
            # the survivor keeps what it merged from the dead member
            assert svcs[1].topology.avg_rtt_ms("child", "seed") == 3.0
            for i in range(4):
                await client.announce_host(HostInfo(id=f"h{i}", ip="10.0.0.1", hostname=f"h{i}"))  # dflint: disable=DF025 each host announces once, as a daemon does
            assert len(svcs[1].pool.hosts) == 4
        finally:
            await client.close()
            await fed.stop()
            await srvs[1].stop()
            for svc in svcs:
                svc.close()

    run(body())
