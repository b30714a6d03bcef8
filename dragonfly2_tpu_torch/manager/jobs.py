"""Async job framework: durable job rows + per-queue dispatch with long-poll.

The port's own copy of dragonfly2_tpu/manager/jobs.py.

Reference equivalent: internal/job (machinery on Redis: queues, group states,
job.go:28-160) + manager/job/preheat.go (producer). Redis queues become
in-process asyncio queues with the `jobs` table as the durable record; workers
(schedulers) long-poll `pull` over RPC instead of subscribing to Redis —
same at-least-once, cluster-sharded dispatch, no external broker.

Group semantics: one job fans out to N scheduler clusters; the job is
SUCCESS when every cluster item succeeds, FAILURE if any fails
(machinery group states, internal/job/constants.go).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from dragonfly2_tpu_torch.manager.db import Database

logger = logging.getLogger(__name__)

JOB_PENDING = "PENDING"
JOB_STARTED = "STARTED"
JOB_SUCCESS = "SUCCESS"
JOB_FAILURE = "FAILURE"

JOB_TYPE_PREHEAT = "preheat"


def cluster_queue(scheduler_cluster_id: int) -> str:
    """Machinery used one queue per scheduler cluster (job.go:66-71)."""
    return f"scheduler_cluster_{scheduler_cluster_id}"


class JobQueue:
    def __init__(self, db: Database, *, lease_timeout: float = 1800.0):
        self.db = db
        self.lease_timeout = lease_timeout  # ref preheat handler timeout 20 min
        self._queues: dict[str, asyncio.Queue] = {}
        self._pending: dict[int, set[int]] = {}  # job_id -> outstanding cluster_ids
        self._results: dict[int, list[dict]] = {}
        # (job_id, cluster_id) -> (queue, item, lease deadline); see reap_leases
        self._inflight: dict[tuple[int, int], tuple[str, dict, float]] = {}

    def _queue(self, name: str) -> asyncio.Queue:
        q = self._queues.get(name)
        if q is None:
            q = self._queues[name] = asyncio.Queue()  # dflint: disable=DF034 backlog is one row per (job, cluster) in the operator-created jobs table; a maxsize would make the lease-reap requeue (put_nowait) DROP a live job instead of redelivering it
        return q

    async def create(
        self, job_type: str, args: dict, *, scheduler_cluster_ids: list[int]
    ) -> dict:
        if not scheduler_cluster_ids:
            raise ValueError("job needs at least one scheduler cluster")
        job_id = self.db.insert(
            "jobs",
            type=job_type,
            state=JOB_PENDING,
            args=args,
            scheduler_cluster_ids=scheduler_cluster_ids,
        )
        self._pending[job_id] = set(scheduler_cluster_ids)
        self._results[job_id] = []
        for cid in scheduler_cluster_ids:
            await self._queue(cluster_queue(cid)).put(
                {"job_id": job_id, "type": job_type, "args": args, "cluster_id": cid}
            )
        return self.db.get("jobs", job_id)

    async def pull(self, queue: str, *, timeout: float = 30.0) -> Optional[dict]:
        """Long-poll one work item; None on timeout (worker retries).

        The item stays leased until `complete` or lease expiry — if delivery
        to the worker fails (connection reset mid-long-poll), `reap_leases`
        requeues it, preserving at-least-once.
        """
        try:
            item = await asyncio.wait_for(self._queue(queue).get(), timeout)
        except asyncio.TimeoutError:
            return None
        job = self.db.get("jobs", item["job_id"])
        if job is not None and job["state"] == JOB_PENDING:
            self.db.update("jobs", item["job_id"], state=JOB_STARTED)
        self._inflight[(item["job_id"], item["cluster_id"])] = (
            queue, item, time.time() + self.lease_timeout
        )
        return item

    def reap_leases(self) -> int:
        """Requeue in-flight items whose lease expired (lost worker)."""
        now = time.time()
        n = 0
        for key, (queue, item, deadline) in list(self._inflight.items()):
            if deadline <= now:
                del self._inflight[key]
                self._queue(queue).put_nowait(item)
                n += 1
        return n

    def complete(
        self, job_id: int, *, success: bool, result: dict | None = None,
        cluster_id: int | None = None,
    ) -> None:
        """Idempotent per (job_id, cluster_id): RPC retries of the same
        completion don't finalize the group early. Without cluster_id (legacy
        callers) falls back to one arbitrary outstanding cluster."""
        left = self._pending.get(job_id)
        if left is None:
            logger.warning("complete for unknown/finished job %s", job_id)
            return
        if cluster_id is None:
            cluster_id = next(iter(left))
        if cluster_id not in left:
            return  # duplicate completion (retried RPC) — already counted
        left.discard(cluster_id)
        self._inflight.pop((job_id, cluster_id), None)
        self._results[job_id].append(
            {"success": success, "cluster_id": cluster_id, **(result or {})}
        )
        results = self._results[job_id]
        if not left:
            ok = all(r["success"] for r in results)
            self.db.update(
                "jobs", job_id,
                state=JOB_SUCCESS if ok else JOB_FAILURE,
                result={"items": results},
            )
            self._pending.pop(job_id, None)
            self._results.pop(job_id, None)
        elif not success:
            # group keeps draining but is already doomed; record incrementally
            self.db.update("jobs", job_id, result={"items": results})

    def state(self, job_id: int) -> Optional[dict]:
        return self.db.get("jobs", job_id)

    def requeue_pending(self) -> int:
        """On manager restart, re-enqueue jobs that never finished."""
        n = 0
        for job in self.db.find("jobs", state=JOB_PENDING) + self.db.find("jobs", state=JOB_STARTED):
            cids = job["scheduler_cluster_ids"] or []
            self._pending[job["id"]] = set(cids)
            self._results[job["id"]] = []
            for cid in cids:
                self._queue(cluster_queue(cid)).put_nowait(
                    {"job_id": job["id"], "type": job["type"], "args": job["args"], "cluster_id": cid}
                )
                n += 1
        return n
