"""Scheduler RPC adapters over the port's rpc/core.py: the port of
dragonfly2_tpu/rpc/scheduler.py, whole.

Server half: ``SchedulerRpcAdapter`` maps wire payloads onto the port's
``SchedulerService`` (scheduler/service.py) one method for one, and
``serve_scheduler`` registers it on an ``RpcServer`` under
``SCHEDULER_METHODS``; ``python -m dragonfly2_tpu_torch.scheduler.server``
serves it. Client half: ``RemoteSchedulerClient`` speaks the same methods
over the port's ``RpcClient``, so a port caller drives either package's
scheduler process, and the reference's client drives the port's.

The wire dataclasses ``HostInfo``, ``TaskMeta``, ``ParentInfo`` and
``RegisterResult`` live in scheduler/service.py, as in the reference, and are
re-exported here: ``dataclasses.asdict`` of each equals the reference's
field for field, which is what crosses the wire.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Any

from dragonfly2_tpu_torch.rpc.core import RpcClient, RpcError, RpcServer
from dragonfly2_tpu_torch.scheduler.service import (  # noqa: F401 — the wire dataclasses' public home here too
    HostInfo,
    ParentInfo,
    RegisterResult,
    SchedulerService,
    TaskMeta,
)


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


def _result_to_wire(r: RegisterResult) -> dict:
    return asdict(r)  # recursive: ParentInfo entries become dicts too


def _result_from_wire(d: dict) -> RegisterResult:
    parents = [ParentInfo(**p) for p in d.pop("parents", [])]
    return RegisterResult(parents=parents, **d)


class SchedulerRpcAdapter:
    """Server-side: msgpack payloads -> SchedulerService calls."""

    def __init__(self, service: SchedulerService):
        self.svc = service

    async def register_peer(self, p: dict) -> dict:
        out = await self.svc.register_peer(
            p["peer_id"],
            TaskMeta(**{**p["meta"], "filters": tuple(p["meta"].get("filters", ()))}),
            HostInfo(**p["host"]),
        )
        return _result_to_wire(out)

    async def report_task_metadata(self, p: dict) -> None:
        self.svc.report_task_metadata(
            p["task_id"],
            content_length=p["content_length"],
            piece_size=p.get("piece_size"),
            digest=p.get("digest", ""),
            direct_piece=p.get("direct_piece", b""),
        )

    async def report_piece_result(self, p: dict) -> None:
        self.svc.report_piece_result(
            p["peer_id"],
            p["piece_index"],
            success=p["success"],
            cost_ms=p.get("cost_ms", 0.0),
            parent_id=p.get("parent_id", ""),
        )

    async def report_pieces(self, p: dict) -> int:
        # triples arrive as msgpack lists; the applied count rides back so
        # callers (and tests) can observe idempotent re-applies
        if "reports" in p:
            reports = p["reports"]
        else:
            # the older wire shape (flat index list + one shared cost): accept it —
            # a rolling upgrade must not silently zero an old daemon's batch
            # (a payload with NEITHER key is malformed: KeyError -> rpc error)
            reports = [(i, p.get("cost_ms", 0.0), "") for i in p["piece_indices"]]
        return self.svc.report_pieces(p["peer_id"], reports)

    async def report_batch(self, p: dict) -> int:
        # task-close combo: residual piece triples + the final peer result in
        # one frame (both legs idempotent server-side, so the rpc client's
        # retries re-apply as no-ops)
        return self.svc.report_batch(
            p["peer_id"], p.get("reports", []), result=p.get("result")
        )

    async def announce_task(self, p: dict) -> None:
        self.svc.announce_task(
            p["peer_id"],
            TaskMeta(**{**p["meta"], "filters": tuple(p["meta"].get("filters", ()))}),
            HostInfo(**p["host"]),
            content_length=p["content_length"],
            piece_size=p["piece_size"],
            piece_indices=p["piece_indices"],
            digest=p.get("digest", ""),
        )

    async def report_peer_result(self, p: dict) -> None:
        self.svc.report_peer_result(
            p["peer_id"], success=p["success"], bandwidth_bps=p.get("bandwidth_bps", 0.0)
        )

    async def reschedule(self, p: dict) -> dict:
        try:
            return _result_to_wire(await self.svc.reschedule(p["peer_id"]))
        except KeyError:
            # a restarted (or GC'd) scheduler does not know this peer; the
            # typed code lets the conductor re-register and rebuild the
            # scheduler's view instead of treating this as an internal fault
            raise RpcError(f"unknown peer {p['peer_id']}", code="not_found")

    async def leave_peer(self, p: dict) -> None:
        self.svc.leave_peer(p["peer_id"])

    async def leave_host(self, p: dict) -> None:
        self.svc.leave_host(p["host_id"])

    async def announce_host(self, p: dict) -> None:
        self.svc.announce_host(HostInfo(**p["host"]), p.get("stats"))

    async def stat_task(self, p: dict) -> dict | None:
        return self.svc.stat_task(p["task_id"])

    async def sync_probes(self, p: dict) -> list[dict]:
        return self.svc.sync_probes(p["host_id"], p.get("results", []))

    async def federation_sync(self, p: dict) -> dict:
        from dragonfly2_tpu_torch.observability.tracing import default_tracer

        # named span on the RESPONDER: a trace shows the gossip exchange on
        # the member that applied it
        with default_tracer().span("federation.apply", origin=p.get("origin", "")):
            return self.svc.federation_sync(
                p.get("origin", ""),
                topo_since=p.get("topo_since", 0),
                bw_since=p.get("bw_since", 0),
                topo_push=p.get("topo_push"),
                bw_push=p.get("bw_push"),
                epoch=p.get("epoch", ""),
            )

    async def federation_state(self, p: Any = None) -> dict:
        return self.svc.federation_state()

    async def decision_records(self, p: dict | None = None) -> dict:
        p = p or {}
        return self.svc.decision_records(
            task_id=p.get("task_id"),
            child=p.get("child"),
            limit=int(p.get("limit", 64)),
            with_features=bool(p.get("with_features", True)),
        )


def serve_scheduler(service: SchedulerService, **server_kw: Any) -> RpcServer:
    server = RpcServer(**server_kw)
    server.register_service(SchedulerRpcAdapter(service), SCHEDULER_METHODS)
    return server


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
