"""Scheduler federation: push-pull topology/bandwidth gossip between ring
members.

The port's own copy of dragonfly2_tpu/scheduler/federation.py.

One scheduler is the scale ceiling for "millions of users": N schedulers run
behind the consistent-hash balancer (rpc/balancer.py), each owning the tasks
the ring assigns it — but probe results route to ONE ring owner per source
host and bandwidth observations land on the task's owner, so each member
sees only a shard of the cluster's measurements. The reference shares this
state through Redis (scheduler/networktopology/network_topology.go); here
the members gossip it directly:

- every LOCAL topology/bandwidth mutation stamps its edge with a
  monotonically increasing sequence (the store's coarse version counter —
  NetworkTopology._local_seq / BandwidthHistory._local_seq);
- each member periodically runs one `federation_sync` RPC per peer, pushing
  its own local deltas above what that peer has acknowledged and pulling the
  peer's local deltas above its own pull watermark (push-pull in a single
  round trip, so even a ONE-directional peer config converges both sides);
- merged data lands in a separate remote view consulted as a fallback by
  avg_rtt_ms / bandwidth query — never re-gossiped (origin-only shipping:
  with a full- or star-mesh every member converges in one hop and loops are
  structurally impossible), never re-emitted as telemetry (each scheduler
  uploads only what it ingested; the trainer merges across uploads).

Watermark semantics: `since` values are the RESPONDER's store versions as of
the last successful sync; a failed RPC leaves them unchanged, so the next
round retransmits — merge_remote is idempotent, making at-least-once
delivery safe. Steady-state payloads are O(edges changed since the
watermark).

Membership comes from the manager (the same address book the daemons'
balancer resolver polls) or a static peer list; a member never syncs with
itself.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Iterable, Optional

from dragonfly2_tpu_torch.observability.tracing import default_tracer
from dragonfly2_tpu_torch.scheduler import metrics
from dragonfly2_tpu_torch.scheduler.service import SchedulerService

logger = logging.getLogger(__name__)

DEFAULT_SYNC_INTERVAL = 5.0


class _PeerState:
    """Per-peer sync bookkeeping: what we've pulled of the peer's local data
    (its store versions), what the peer has acknowledged of ours, and the
    peer's instance epoch the watermarks are valid against."""

    __slots__ = ("pull_topo", "pull_bw", "pushed_topo", "pushed_bw",
                 "failures", "epoch")

    def __init__(self) -> None:
        self.pull_topo = 0
        self.pull_bw = 0
        self.pushed_topo = 0
        self.pushed_bw = 0
        self.failures = 0
        self.epoch: str | None = None

    def reset_watermarks(self) -> None:
        self.pull_topo = self.pull_bw = self.pushed_topo = self.pushed_bw = 0


class FederationSync:
    def __init__(
        self,
        service: SchedulerService,
        *,
        self_addr: str,
        name: str = "",
        peers: Iterable[str] = (),
        peers_fn: Optional[Callable[[], list[str]]] = None,
        interval: float = DEFAULT_SYNC_INTERVAL,
        client_factory: Optional[Callable[[str], Any]] = None,
    ):
        from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

        self.service = service
        self.self_addr = self_addr
        self.name = name or self_addr
        self.interval = interval
        self._static_peers = [p for p in peers if p and p != self_addr]
        self._peers_fn = peers_fn
        self._factory = client_factory or (
            lambda addr: RemoteSchedulerClient(addr, retries=0)
        )
        self._clients: dict[str, Any] = {}
        self._state: dict[str, _PeerState] = {}
        # addresses that answered with OUR OWN epoch (a 0.0.0.0-bound member
        # listed in its own static peer list) — permanently excluded
        self._self_addrs: set[str] = set()
        self._task: asyncio.Task | None = None
        self.syncs_ok = 0
        self.syncs_failed = 0
        self.deltas_pushed = 0
        self.deltas_pulled = 0

    # ---- membership ----

    def peer_addresses(self) -> list[str]:
        addrs = list(self._static_peers)
        if self._peers_fn is not None:
            try:
                for a in self._peers_fn():
                    if a and a != self.self_addr and a not in addrs:
                        addrs.append(a)
            except Exception:
                logger.warning("federation peer resolution failed", exc_info=True)
        return [a for a in addrs if a not in self._self_addrs]

    def _client(self, addr: str) -> Any:
        c = self._clients.get(addr)
        if c is None:
            c = self._clients[addr] = self._factory(addr)
        return c

    # ---- sync ----

    async def sync_peer(self, addr: str, *, _replay: bool = False) -> dict:
        """One push-pull round trip with one peer. Watermarks advance only
        on success; failures leave them for the retransmit. The peer's
        instance epoch rides every response: a mismatch means the peer
        RESTARTED (its version counters reset, its merged view is gone), so
        both watermark directions restart from zero and the exchange replays
        once immediately — without this, a restarted responder-only peer in
        a chain config would never ship its post-restart measurements (its
        fresh counters sit below our stale watermark) and would never
        re-receive ours."""
        st = self._state.setdefault(addr, _PeerState())
        svc = self.service
        with svc.state_lock:
            push_topo_wm, topo_push = svc.topology.local_edges_since(st.pushed_topo)
            push_bw_wm, bw_push = svc.bandwidth.local_entries_since(st.pushed_bw)
        with default_tracer().span(
            "federation.sync", peer=addr, scheduler=self.name,
            push_edges=len(topo_push), push_bw=len(bw_push),
        ) as sp:
            out = await self._client(addr).federation_sync(
                self.name,
                topo_since=st.pull_topo,
                bw_since=st.pull_bw,
                topo_push=topo_push,
                bw_push=bw_push,
                epoch=svc.federation_epoch,
            )
            peer_epoch = out.get("epoch", "")
            if out.get("self") or peer_epoch == svc.federation_epoch:
                # that's us in the mirror (0.0.0.0 bind + own address in a
                # shared static peer list): exclude the address for good
                self._self_addrs.add(addr)
                logger.warning("federation peer %s is this scheduler; excluded", addr)
                return out
            if st.epoch is not None and peer_epoch != st.epoch and not _replay:
                st.reset_watermarks()
                st.epoch = peer_epoch
                # the dead instance's merged entries can never be tombstoned
                # (its successor's clock is empty) — purge them; whatever
                # still exists comes back in the replay below
                with svc.state_lock:
                    purged = svc.topology.purge_remote_origin(addr)
                    purged += svc.bandwidth.purge_remote_origin(addr)
                logger.info(
                    "federation peer %s restarted; purged %d merged entries, "
                    "replaying from zero", addr, purged,
                )
                return await self.sync_peer(addr, _replay=True)
            st.epoch = peer_epoch
            applied = 0
            with svc.state_lock:
                if out.get("edges"):
                    applied += svc.topology.merge_remote(out["edges"], origin=addr)
                if out.get("bandwidth"):
                    applied += svc.bandwidth.merge_remote(out["bandwidth"], origin=addr)
            st.pull_topo = out["topo_watermark"]
            st.pull_bw = out["bw_watermark"]
            st.pushed_topo = push_topo_wm
            st.pushed_bw = push_bw_wm
            st.failures = 0
            self.deltas_pushed += len(topo_push) + len(bw_push)
            self.deltas_pulled += len(out.get("edges", ())) + len(out.get("bandwidth", ()))
            if applied:
                metrics.FEDERATION_DELTAS_APPLIED_TOTAL.inc(applied)
            if topo_push or bw_push:
                metrics.FEDERATION_DELTAS_SENT_TOTAL.inc(len(topo_push) + len(bw_push))
            if sp.sampled:
                sp.set_attr("pulled_edges", len(out.get("edges", ())))
                sp.set_attr("pulled_bw", len(out.get("bandwidth", ())))
                sp.set_attr("applied", applied)
        return out

    async def sync_once(self) -> int:
        """Sync with every current peer CONCURRENTLY; returns how many
        succeeded. Concurrent, not serial: a blackholed peer (TCP connect
        hangs, not refused) must cost its own RPC timeout, never stall the
        gossip tick to every healthy member behind it — failures are already
        isolated per peer."""
        peers = self.peer_addresses()
        metrics.FEDERATION_PEERS_GAUGE.set(len(peers))
        # evict clients/state for departed members (manager-fed churn would
        # otherwise accumulate dead RPC clients for the process lifetime);
        # cheap to recreate if a resolver blip transiently empties the set
        for addr in [a for a in self._clients if a not in peers]:
            await self._clients.pop(addr).close()
            self._state.pop(addr, None)

        async def _one(addr: str) -> bool:
            try:
                await self.sync_peer(addr)
                self.syncs_ok += 1
                metrics.FEDERATION_SYNCS_TOTAL.inc(result="ok")
                return True
            except Exception as e:
                st = self._state.setdefault(addr, _PeerState())
                st.failures += 1
                self.syncs_failed += 1
                metrics.FEDERATION_SYNCS_TOTAL.inc(result="error")
                # a down peer is routine during membership churn: log at
                # warning on the first failure, debug while it stays down
                log = logger.warning if st.failures == 1 else logger.debug
                log("federation sync with %s failed (#%d): %s", addr, st.failures, e)
                return False

        ok = sum(await asyncio.gather(*(_one(a) for a in peers)))
        if ok:
            metrics.FEDERATION_LAST_SYNC_TIMESTAMP.set(time.time())
        return ok

    # ---- lifecycle ----

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy

        # downward jitter desynchronizes the members' ticks (N schedulers
        # booted by one script would otherwise sync in lockstep forever)
        backoff = BackoffPolicy(
            base=self.interval, multiplier=1.0, max_delay=self.interval, jitter=0.2
        )
        while True:
            await backoff.sleep(0)
            try:
                await self.sync_once()
            except Exception:
                logger.exception("federation sync round failed")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for c in self._clients.values():
            await c.close()
        self._clients.clear()

    def status(self) -> dict:
        return {
            "peers": self.peer_addresses(),
            "syncs_ok": self.syncs_ok,
            "syncs_failed": self.syncs_failed,
            "deltas_pushed": self.deltas_pushed,
            "deltas_pulled": self.deltas_pulled,
        }
