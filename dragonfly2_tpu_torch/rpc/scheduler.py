"""The scheduler's wire client: the port of the client half of
dragonfly2_tpu/rpc/scheduler.py.

``RemoteSchedulerClient`` speaks the reference scheduler's RPC methods
(``SCHEDULER_METHODS``) over the port's ``RpcClient``, so a port caller
drives a reference scheduler (``python -m dragonfly2_tpu.scheduler.server``)
over the wire. The wire dataclasses ``HostInfo``, ``TaskMeta``,
``ParentInfo`` and ``RegisterResult`` are the port's own copies of the
reference's (``scheduler/service.py``): ``dataclasses.asdict`` of each
equals the reference's field for field, which is what crosses the wire.

Not ported: the server half (``SchedulerRpcAdapter``, ``serve_scheduler``),
which wraps the reference's ``SchedulerService``; the port has no
scheduler service of its own.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

from dragonfly2_tpu_torch.rpc.core import RpcClient


@dataclass
class HostInfo:
    id: str
    ip: str
    hostname: str
    port: int = 0
    download_port: int = 0
    type: str = "normal"
    idc: str = ""
    location: str = ""


@dataclass
class TaskMeta:
    task_id: str
    url: str
    digest: str = ""
    tag: str = ""
    application: str = ""
    filters: tuple = ()
    # the traffic shaper's tenant weight, carried to the scheduler so its
    # admission-control brownout rung sheds the lowest first
    priority: float = 1.0


@dataclass
class ParentInfo:
    """What a child needs to reach a parent's piece server."""

    peer_id: str
    host_id: str
    ip: str
    download_port: int


@dataclass
class RegisterResult:
    scope: str
    task_id: str
    back_to_source: bool = False
    parents: list[ParentInfo] = field(default_factory=list)
    direct_piece: bytes = b""
    content_length: int | None = None
    piece_size: int | None = None
    total_pieces: int | None = None
    digest: str = ""
    error: str = ""  # non-empty: registration refused (e.g. cache gone)
    # error == "overloaded": come back after this many seconds
    retry_after_s: float = 0.0


SCHEDULER_METHODS = [
    "register_peer",
    "report_task_metadata",
    "report_piece_result",
    "report_pieces",
    "report_batch",
    "announce_task",
    "report_peer_result",
    "reschedule",
    "leave_peer",
    "leave_host",
    "announce_host",
    "stat_task",
    "sync_probes",
    "federation_sync",
    "federation_state",
    "decision_records",
]


def _result_from_wire(d: dict) -> RegisterResult:
    parents = [ParentInfo(**p) for p in d.pop("parents", [])]
    return RegisterResult(parents=parents, **d)


class RemoteSchedulerClient:
    """A scheduler over the wire, one address (the reference daemon's
    ``SchedulerClient`` protocol)."""

    def __init__(self, address: str, **client_kw: Any):
        self._rpc = RpcClient(address, **client_kw)

    @property
    def breaker(self):
        """The per-target circuit breaker (the balancer's breaker-aware
        placement reads it)."""
        return self._rpc.breaker

    async def register_peer(self, peer_id: str, meta: TaskMeta, host: HostInfo) -> RegisterResult:
        out = await self._rpc.call(
            "register_peer",
            {"peer_id": peer_id, "meta": asdict(meta), "host": asdict(host)},
        )
        return _result_from_wire(out)

    async def report_task_metadata(self, task_id, *, content_length, piece_size, digest="", direct_piece=b""):
        await self._rpc.call(
            "report_task_metadata",
            {"task_id": task_id, "content_length": content_length,
             "piece_size": piece_size, "digest": digest, "direct_piece": direct_piece},
        )

    async def report_piece_result(self, peer_id, piece_index, *, success, cost_ms=0.0, parent_id=""):
        await self._rpc.call(
            "report_piece_result",
            {"peer_id": peer_id, "piece_index": piece_index, "success": success,
             "cost_ms": cost_ms, "parent_id": parent_id},
        )

    async def report_pieces(self, peer_id, reports):
        triples = [list(r) for r in reports]
        # both wire shapes in one frame: an older adapter reads the flat
        # piece_indices and one shared cost, a current one the triples
        return await self._rpc.call(
            "report_pieces",
            {"peer_id": peer_id, "reports": triples,
             "piece_indices": [t[0] for t in triples],
             "cost_ms": (sum(t[1] for t in triples) / len(triples)) if triples else 0.0},
        )

    async def report_batch(self, peer_id, reports, result=None):
        return await self._rpc.call(
            "report_batch",
            {"peer_id": peer_id, "reports": [list(r) for r in reports], "result": result},
        )

    async def announce_task(self, peer_id, meta, host, *, content_length, piece_size, piece_indices, digest=""):
        await self._rpc.call(
            "announce_task",
            {"peer_id": peer_id, "meta": asdict(meta), "host": asdict(host),
             "content_length": content_length, "piece_size": piece_size,
             "piece_indices": list(piece_indices), "digest": digest},
        )

    async def report_peer_result(self, peer_id, *, success, bandwidth_bps=0.0):
        await self._rpc.call(
            "report_peer_result",
            {"peer_id": peer_id, "success": success, "bandwidth_bps": bandwidth_bps},
        )

    async def reschedule(self, peer_id):
        return _result_from_wire(await self._rpc.call("reschedule", {"peer_id": peer_id}))

    async def leave_peer(self, peer_id):
        await self._rpc.call("leave_peer", {"peer_id": peer_id})

    async def leave_host(self, host_id):
        await self._rpc.call("leave_host", {"host_id": host_id})

    async def announce_host(self, host: HostInfo, stats: dict | None = None):
        await self._rpc.call("announce_host", {"host": asdict(host), "stats": stats})

    async def stat_task(self, task_id: str):
        return await self._rpc.call("stat_task", {"task_id": task_id})

    async def sync_probes(self, host_id: str, results: list[dict]):
        return await self._rpc.call("sync_probes", {"host_id": host_id, "results": results})

    async def federation_sync(
        self, origin: str, *, topo_since=0, bw_since=0, topo_push=None, bw_push=None, epoch="",
    ):
        """Scheduler-to-scheduler push-pull gossip exchange."""
        return await self._rpc.call(
            "federation_sync",
            {"origin": origin, "topo_since": topo_since, "bw_since": bw_since,
             "topo_push": topo_push or [], "bw_push": bw_push or [], "epoch": epoch},
        )

    async def federation_state(self):
        return await self._rpc.call("federation_state")

    async def decision_records(self, *, task_id=None, child=None, limit: int = 64, with_features: bool = True):
        """The scheduler's sampled scoring decision records."""
        return await self._rpc.call(
            "decision_records",
            {"task_id": task_id, "child": child, "limit": limit, "with_features": with_features},
        )

    async def healthy(self) -> bool:
        return await self._rpc.healthy()

    async def close(self):
        await self._rpc.close()
