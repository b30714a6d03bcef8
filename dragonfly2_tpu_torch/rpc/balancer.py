"""Consistent-hash scheduler balancer + dynamic resolver.

The port of dragonfly2_tpu/rpc/balancer.py: the same ring (sha256, first 8
bytes, VIRTUAL_NODES replicas an address), so a key picks the same owner
in both packages (tests/test_torch_balancer.py holds them on 10,000 keys),
over the port's ``RemoteSchedulerClient``.

Parity with reference pkg/balancer/consistent_hashing.go:51-124 (task-ID
affinity: every RPC about one task lands on the same scheduler, so its
in-memory peer DAG sees the whole task) and pkg/resolver (dynconfig-fed
address list). Design differences for this stack:

- The ring hashes *addresses* with virtual nodes and picks by task id. Calls
  that carry no task id (per-peer reports) route via a peer→address map
  learned at register/announce time.
- Host-scoped calls (announce_host, leave_host) fan out to every scheduler:
  each one keeps its own host table; probes go to one owner per host.
- The resolver polls a callback and rebuilds the ring on membership change;
  a dead address's tasks re-hash to survivors on the next pick.
- Per-target circuit breakers (each RpcClient carries one) feed placement:
  NEW keys walk the ring past addresses whose breaker is open, so a dead
  scheduler costs its first callers a failure burst and everyone else
  nothing; learned (sticky) routes are NOT rerouted — their state lives on
  the original scheduler — they fast-fail at the breaker until its
  half-open probe readmits the target.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import logging
from typing import Any, Awaitable, Callable, Iterable, Optional

from dragonfly2_tpu_torch.rpc.core import RpcError
from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

logger = logging.getLogger(__name__)

VIRTUAL_NODES = 120  # ring replicas per address (ref defaultReplicaCount)


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Hash ring with virtual nodes; pick(key) is stable under membership
    churn except for keys owned by the changed address."""

    def __init__(self, addresses: Iterable[str] = (), *, replicas: int = VIRTUAL_NODES):
        self._replicas = replicas
        self._ring: list[tuple[int, str]] = []
        self._addresses: set[str] = set()
        self.reset(addresses)

    def reset(self, addresses: Iterable[str]) -> None:
        self._addresses = set(addresses)
        self._ring = sorted(
            (_hash(f"{addr}#{i}"), addr)
            for addr in self._addresses
            for i in range(self._replicas)
        )

    def add(self, address: str) -> None:
        if address not in self._addresses:
            self.reset(self._addresses | {address})

    def remove(self, address: str) -> None:
        if address in self._addresses:
            self.reset(self._addresses - {address})

    @property
    def addresses(self) -> set[str]:
        return set(self._addresses)

    def pick(self, key: str, avoid: "set[str] | frozenset[str]" = frozenset()) -> str:
        """Owner address for `key`. `avoid` (e.g. addresses whose circuit
        breaker is open) is skipped by walking the ring forward — keys not
        owned by an avoided address keep their placement, and the fallback
        owner is itself consistent, so reroutes are stable too. If every
        address is avoided the natural owner is returned (the breaker there
        will fast-fail, which is still cheaper than no answer)."""
        if not self._ring:
            raise RpcError("no scheduler addresses available", code="unavailable")
        h = _hash(key)
        idx = bisect.bisect_right(self._ring, (h, "￿")) % len(self._ring)
        natural = self._ring[idx][1]
        if natural not in avoid:
            return natural
        for step in range(1, len(self._ring)):
            addr = self._ring[(idx + step) % len(self._ring)][1]
            if addr not in avoid:
                return addr
        return natural


class BalancedSchedulerClient:
    """Task-affine fan-in over N schedulers; daemon-facing interface matches
    RemoteSchedulerClient (daemon.conductor.SchedulerClient protocol)."""

    def __init__(
        self,
        addresses: Iterable[str],
        *,
        resolve: Optional[Callable[[], Awaitable[list[str]]]] = None,
        resolve_interval: float = 30.0,
        client_factory: Callable[[str], Any] = RemoteSchedulerClient,
    ):
        self.ring = ConsistentHashRing(addresses)
        self._clients: dict[str, Any] = {}
        # learned routing: once a task/peer registers on a scheduler, every
        # later call about it goes there even if the ring membership changes
        # mid-download (the state lives on the original scheduler)
        self._peer_addr: dict[str, str] = {}
        self._task_addr: dict[str, str] = {}
        self._map_cap = 20_000  # bound learned maps (entries also evict on peer completion)
        self._factory = client_factory
        self._resolve = resolve
        self._resolve_interval = resolve_interval
        self._resolver_task: asyncio.Task | None = None
        self._retired: list[Any] = []  # evicted clients, closed on close()

    # ---- membership ----

    def start_resolver(self) -> None:
        if self._resolve is not None and self._resolver_task is None:
            self._resolver_task = asyncio.ensure_future(self._resolve_loop())

    async def _resolve_loop(self) -> None:
        while True:
            try:
                addrs = await self._resolve()
                if addrs and set(addrs) != self.ring.addresses:
                    logger.info("scheduler set changed: %s", sorted(addrs))
                    self.ring.reset(addrs)
                    for addr in list(self._clients):
                        if addr not in self.ring.addresses:
                            # retire, don't close: in-flight RPCs on other
                            # coroutines may still hold this client; it is
                            # closed at shutdown
                            self._retired.append(self._clients.pop(addr))
                    self._peer_addr = {
                        p: a for p, a in self._peer_addr.items() if a in self.ring.addresses
                    }
                    self._task_addr = {
                        t: a for t, a in self._task_addr.items() if a in self.ring.addresses
                    }
            except Exception:
                logger.warning("scheduler resolve failed", exc_info=True)
            await asyncio.sleep(self._resolve_interval)

    def _client(self, addr: str) -> Any:
        client = self._clients.get(addr)
        if client is None:
            client = self._clients[addr] = self._factory(addr)
        return client

    def _open_addresses(self) -> set[str]:
        """Addresses whose circuit breaker is currently refusing calls.
        Only instantiated clients can be open (no traffic, no failures); the
        breaker's cooldown lapse re-admits an address so probes still flow."""
        out = set()
        for addr, client in self._clients.items():
            breaker = getattr(client, "breaker", None)
            if breaker is not None and breaker.is_open:
                out.add(addr)
        return out

    @staticmethod
    def _prune(mapping: dict, cap: int) -> None:
        while len(mapping) > cap:  # drop oldest entries (dict insert order)
            mapping.pop(next(iter(mapping)))

    def _learn(self, peer_id: str, task_id: str, addr: str) -> None:
        self._peer_addr[peer_id] = addr
        self._task_addr[task_id] = addr
        self._prune(self._peer_addr, self._map_cap)
        self._prune(self._task_addr, self._map_cap)

    def _for_task(self, task_id: str) -> Any:
        # learned owners stay sticky even through an open breaker: the task's
        # state lives there, and rerouting would answer from a scheduler that
        # has never seen the peer
        addr = self._task_addr.get(task_id)
        if addr is None or addr not in self.ring.addresses:
            addr = self.ring.pick(task_id, avoid=self._open_addresses())
        return self._client(addr)

    def _for_peer(self, peer_id: str) -> Any:
        addr = self._peer_addr.get(peer_id)
        if addr is None or addr not in self.ring.addresses:
            # unknown peer (restart?) — fall back to hashing the peer id so
            # at least routing is deterministic
            addr = self.ring.pick(peer_id, avoid=self._open_addresses())
        return self._client(addr)

    # ---- SchedulerClient protocol ----

    def _owner_for_task(self, task_id: str) -> str:
        """Learned owner first (sticky across membership change), else ring —
        routing NEW tasks away from schedulers whose breaker is open."""
        addr = self._task_addr.get(task_id)
        if addr is None or addr not in self.ring.addresses:
            addr = self.ring.pick(task_id, avoid=self._open_addresses())
        return addr

    async def register_peer(self, peer_id, meta, host):
        addr = self._owner_for_task(meta.task_id)
        self._learn(peer_id, meta.task_id, addr)
        return await self._client(addr).register_peer(peer_id, meta, host)

    async def report_task_metadata(self, task_id, **kw):
        await self._for_task(task_id).report_task_metadata(task_id, **kw)

    async def report_piece_result(self, peer_id, piece_index, **kw):
        await self._for_peer(peer_id).report_piece_result(peer_id, piece_index, **kw)

    async def report_pieces(self, peer_id, reports):
        return await self._for_peer(peer_id).report_pieces(peer_id, reports)

    async def announce_task(self, peer_id, meta, host, **kw):
        addr = self._owner_for_task(meta.task_id)
        self._learn(peer_id, meta.task_id, addr)
        await self._client(addr).announce_task(peer_id, meta, host, **kw)

    async def report_peer_result(self, peer_id, **kw):
        client = self._for_peer(peer_id)
        self._peer_addr.pop(peer_id, None)  # terminal per-peer call: evict
        await client.report_peer_result(peer_id, **kw)

    async def report_batch(self, peer_id, reports, result=None):
        client = self._for_peer(peer_id)
        if result is not None:
            self._peer_addr.pop(peer_id, None)  # terminal when a result rides
        return await client.report_batch(peer_id, reports, result=result)

    async def reschedule(self, peer_id):
        return await self._for_peer(peer_id).reschedule(peer_id)

    async def leave_peer(self, peer_id):
        client = self._for_peer(peer_id)
        self._peer_addr.pop(peer_id, None)
        await client.leave_peer(peer_id)

    async def stat_task(self, task_id):
        return await self._for_task(task_id).stat_task(task_id)

    # ---- host-scoped: fan out to all schedulers ----

    async def announce_host(self, host, stats=None):
        errors = []
        for addr in self.ring.addresses:
            try:
                await self._client(addr).announce_host(host, stats)
            except Exception as e:  # one dead scheduler must not mute the rest
                errors.append((addr, e))
        if errors and len(errors) == len(self.ring.addresses):
            raise errors[0][1]
        for addr, e in errors:
            logger.warning("announce_host to %s failed: %s", addr, e)

    async def sync_probes(self, host_id, results):
        """Probes go to one deterministic owner per host (its topology rows
        live on one scheduler; ref networktopology is per-scheduler)."""
        return await self._client(self.ring.pick(host_id)).sync_probes(host_id, results)

    async def leave_host(self, host_id):
        """Graceful departure fans out: any scheduler may hold this host's
        peers (tasks hash to different owners). Concurrent, not serial — the
        shutdown path must pay at most ONE RPC timeout even when several
        schedulers are unreachable."""

        async def _one(addr):
            try:
                await self._client(addr).leave_host(host_id)
            except Exception as e:
                logger.warning("leave_host to %s failed: %s", addr, e)

        await asyncio.gather(*(_one(a) for a in self.ring.addresses))

    async def healthy(self) -> bool:
        for addr in self.ring.addresses:
            try:
                if await self._client(addr).healthy():
                    return True
            except Exception as e:
                logger.debug("health probe of %s failed: %s", addr, e)
                continue
        return False

    async def close(self):
        import contextlib

        if self._resolver_task is not None:
            self._resolver_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._resolver_task
            self._resolver_task = None
        for client in list(self._clients.values()) + self._retired:
            await client.close()
        self._clients.clear()
        self._retired.clear()


def make_scheduler_client(
    spec: str, *, resolve: Optional[Callable[[], Awaitable[list[str]]]] = None, **kw: Any
):
    """One address → plain client; comma-separated list → balanced client
    (kw forwarded to every per-address client either way)."""
    addrs = [a.strip() for a in spec.split(",") if a.strip()]
    if len(addrs) <= 1 and resolve is None:
        return RemoteSchedulerClient(addrs[0] if addrs else spec, **kw)
    return BalancedSchedulerClient(
        addrs,
        resolve=resolve,
        client_factory=lambda a: RemoteSchedulerClient(a, **kw),
    )
