"""The port's own copy of dragonfly2_tpu/daemon/engine.py, reduced to
``InProcessSchedulerClient``: the scheduler-client protocol over a
same-process ``SchedulerService``, which the swarm simulator (``sim/engine.py``)
drives with no sockets. ``PeerEngine`` and the modules it stands on
(conductor, storage, upload server, source registry) are not ported yet
(ROADMAP.md §1, queue item 4)."""

from __future__ import annotations

from dragonfly2_tpu_torch.scheduler.service import SchedulerService


class InProcessSchedulerClient:
    """SchedulerClient over a same-process SchedulerService (test/e2e wiring;
    the wire client in dragonfly2_tpu_torch.rpc implements the same protocol)."""

    def __init__(self, service: SchedulerService):
        self._svc = service

    async def register_peer(self, peer_id, meta, host):
        return await self._svc.register_peer(peer_id, meta, host)

    async def report_task_metadata(self, task_id, *, content_length, piece_size, digest="", direct_piece=b""):
        self._svc.report_task_metadata(
            task_id, content_length=content_length, piece_size=piece_size,
            digest=digest, direct_piece=direct_piece,
        )

    async def report_piece_result(self, peer_id, piece_index, *, success, cost_ms=0.0, parent_id=""):
        self._svc.report_piece_result(
            peer_id, piece_index, success=success, cost_ms=cost_ms, parent_id=parent_id
        )

    async def report_pieces(self, peer_id, reports):
        return self._svc.report_pieces(peer_id, list(reports))

    async def report_batch(self, peer_id, reports, result=None):
        return self._svc.report_batch(peer_id, list(reports), result=result)

    async def announce_task(self, peer_id, meta, host, *, content_length, piece_size, piece_indices, digest=""):
        self._svc.announce_task(
            peer_id, meta, host, content_length=content_length,
            piece_size=piece_size, piece_indices=list(piece_indices), digest=digest,
        )

    async def report_peer_result(self, peer_id, *, success, bandwidth_bps=0.0):
        self._svc.report_peer_result(peer_id, success=success, bandwidth_bps=bandwidth_bps)

    async def reschedule(self, peer_id):
        return await self._svc.reschedule(peer_id)

    async def leave_peer(self, peer_id):
        self._svc.leave_peer(peer_id)

    async def leave_host(self, host_id):
        self._svc.leave_host(host_id)

    async def announce_host(self, host, stats=None):
        self._svc.announce_host(host, stats)

    async def sync_probes(self, host_id, results):
        return self._svc.sync_probes(host_id, results)
