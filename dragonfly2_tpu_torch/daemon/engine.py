"""Peer engine: task-level API over the conductor (download / stream / seed).
The port of dragonfly2_tpu/daemon/engine.py, whole: ``PeerEngine``,
``RangeOutOfBounds`` and ``InProcessSchedulerClient`` (the swarm simulator,
``sim/engine.py``, reaches each scheduler through the latter).

Parity with reference client/daemon/peer/peertask_manager.go:47-58
(StartFileTask / StartSeedTask) and the reuse fast path (peertask_reuse.go):
completed tasks short-circuit to local storage, partial tasks resume from
their finished-piece bitset. One engine per daemon process; it owns the
storage manager, the upload (piece) server, and the scheduler client.

With a ``data_tls=`` bundle (``security.transport.DataPlaneTls``) the upload
server and every piece fetch run mTLS; either package's engine fetches
pieces from the other's over it.
"""

from __future__ import annotations

import asyncio
import logging
import weakref
from pathlib import Path

from dragonfly2_tpu_torch.daemon.conductor import ConductorConfig, PeerTaskConductor, SchedulerClient
from dragonfly2_tpu_torch.daemon.source import SourceRegistry
from dragonfly2_tpu_torch.daemon.storage import OncePinRelease, StorageManager, TaskStorage
from dragonfly2_tpu_torch.daemon.upload import UploadServer
from dragonfly2_tpu_torch.resilience import deadline as dl
from dragonfly2_tpu_torch.scheduler.service import HostInfo, SchedulerService, TaskMeta
from dragonfly2_tpu_torch.utils import idgen

logger = logging.getLogger(__name__)


class RangeOutOfBounds(ValueError):
    """An output_range outside the downloaded task's content length — a
    caller error, distinguished from internal ValueErrors so rpc adapters can
    map ONLY this to bad_request."""


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


class PeerEngine:
    def __init__(
        self,
        *,
        storage_root: str | Path,
        scheduler: SchedulerClient,
        ip: str = "127.0.0.1",
        hostname: str = "",
        host_type: str = "normal",
        idc: str = "",
        location: str = "",
        upload_port: int = 0,
        conductor_config: ConductorConfig | None = None,
        total_download_rate_bps: float | None = None,
        storage_gc_interval: float = 900.0,
        storage_ttl: float = 24 * 3600,
        storage_capacity_bytes: int | None = None,
        disk_gc_threshold: float | None = None,
        data_tls=None,
    ):
        from dragonfly2_tpu_torch.daemon.traffic_shaper import (
            TOTAL_DOWNLOAD_RATE_BPS,
            SamplingTrafficShaper,
        )

        self.ip = ip
        self.hostname = hostname or f"peer-{idgen.local_ip()}"
        # TCP RPC port, set by the daemon server when it listens on TCP —
        # advertised via HostInfo.port so the scheduler can trigger seeds.
        self.rpc_port = 0
        self.host_type = host_type
        self.idc = idc
        self.location = location
        self.storage = StorageManager(storage_root)
        self.scheduler = scheduler
        self.sources = SourceRegistry()
        # secure-by-default data plane: a DataPlaneTls bundle
        # (security/transport.py) puts the upload server AND every piece
        # fetch on mTLS with the cipher the host's one-shot probe picked;
        # None keeps the plain wire (tests, closed networks)
        self.data_tls = data_tls
        self.upload = UploadServer(
            self.storage, host=ip, port=upload_port,
            tls=None if data_tls is None else data_tls.server_ctx,
        )
        self.conductor_config = conductor_config or ConductorConfig()
        # ONE host-wide download budget shared by all concurrent conductors
        # (ref NewSamplingTrafficShaper, traffic_shaper.go:139) — per-task
        # buckets alone would oversubscribe the host N×.
        self.shaper = SamplingTrafficShaper(
            total_rate_bps=(
                TOTAL_DOWNLOAD_RATE_BPS
                if total_download_rate_bps is None
                else total_download_rate_bps
            ),
            per_flow_cap_bps=self.conductor_config.download_rate_bps,
        )
        # Periodic storage reclaim (ref gc_manager.go:54-77 ticker →
        # storage CleanUp): TTL plus capacity/disk watermarks, LRU over
        # complete tasks, in-progress immune (daemon/storage.py reclaim).
        from dragonfly2_tpu_torch.utils.gcreg import GC

        self.gc = GC()
        self.gc.add(
            "storage-reclaim",
            storage_gc_interval,
            lambda: self._run_reclaim(
                ttl=storage_ttl,
                capacity_bytes=storage_capacity_bytes,
                disk_high_ratio=disk_gc_threshold,
            ),
        )
        # close pooled piece-fetch sockets idle past their keep-alive window
        # (parents never contacted again must not pin fds forever)
        self.gc.add("raw-pool-prune", 120.0, self._prune_raw_pool)
        self._raw_client = None
        self._piece_pipeline = None
        # Live conductor tasks: a caller cancelling its download_task future
        # does NOT cancel the conductor (awaiting a task never owns it) — the
        # engine owns them, so stop() (and the test crash harness) can
        # terminate in-flight downloads instead of leaving orphan tasks
        # writing into storage after the engine is gone.
        self._conductors: set[asyncio.Task] = set()
        # Stable per-task peer id for possession announces: announce_task
        # supersedes every OTHER same-host row, and create_peer returns an
        # existing row unchanged — so reusing one id per task makes the
        # periodic keepalive announce an exact no-op on the scheduler
        # (a fresh random id per announce would delete the live seed row,
        # severing children's DAG edges every interval). A conductor's
        # download registers its own id here so later announces adopt the
        # very row children are already attached to.
        self._announce_peer_ids: dict[str, str] = {}
        self._started = False

    async def _run_reclaim(self, **kw) -> None:
        # Off the event loop: the sweep stats every task file and rmtree's
        # evictees — seconds of blocking disk I/O on a large store would
        # freeze every active transfer (pins keep the thread from deleting
        # anything a conductor or an in-flight read is using).
        removed = await asyncio.to_thread(self.storage.reclaim, **kw)
        if any(removed.values()):
            logger.info("storage reclaim: %s", removed)

    @property
    def host_id(self) -> str:
        return idgen.host_id(self.hostname, self.upload.port)

    def host_info(self) -> HostInfo:
        return HostInfo(
            id=self.host_id,
            ip=self.ip,
            hostname=self.hostname,
            port=self.rpc_port,
            download_port=self.upload.port,
            type=self.host_type,
            idc=self.idc,
            location=self.location,
        )

    async def start(self) -> None:
        if not self._started:
            from dragonfly2_tpu_torch.daemon import metrics

            # one-hot wire posture for dftop: which cipher piece MB/s rides
            active = self.data_tls.policy if self.data_tls is not None else "plain"
            for cipher in ("plain", "aes-gcm", "chacha20"):
                metrics.PIECE_CIPHER.set(
                    1.0 if cipher == active else 0.0, cipher=cipher
                )
            # Crash recovery BEFORE the upload server opens: the audit
            # digest-verifies every claimed piece of restored incomplete
            # tasks (a metadata snapshot can claim bits over torn data after
            # a machine crash), so a torn piece is never servable even
            # briefly. Disk-heavy → worker thread.
            recovered = await asyncio.to_thread(self.storage.recover)
            await self.upload.start()
            self.gc.start()
            self._started = True
            await self._announce_recovered(recovered)

    async def _announce_recovered(self, recovered) -> None:
        """Re-announce every restored task's surviving pieces so this peer
        rejoins the swarm as a (possibly partial) seed — the reference daemon
        reloads data+metadata and resumes serving (local_storage.go), but a
        rejoin the scheduler never hears about serves nobody. Best-effort:
        a scheduler that is down at boot is retried by the daemon's periodic
        announce loop (announce_tasks)."""
        from dragonfly2_tpu_torch.daemon import metrics

        for ts, kept, dropped in recovered:
            if dropped:
                metrics.PIECE_DROPPED_RECOVERY_TOTAL.inc(len(dropped))
            if kept == 0:
                continue  # fully-torn task: drops counted, nothing to announce
            metrics.PIECE_RECOVERED_TOTAL.inc(kept)
            state = "done" if ts.meta.done else "partial"
            if await self._announce_possession(ts):
                metrics.TASK_RECOVERED_TOTAL.inc(state=state)
                logger.info(
                    "task %s: recovered %d piece(s) (%s), re-announced",
                    ts.meta.task_id[:12], kept, state,
                )

    async def _announce_possession(self, ts: TaskStorage) -> bool:
        """One announce_task RPC claiming this host's on-disk pieces; the
        scheduler supersedes any ghost peer rows this host left behind."""
        m = ts.meta
        meta = TaskMeta(
            task_id=m.task_id, url=m.url, digest=m.digest,
            tag=m.tag, application=m.application,
        )
        peer_id = self._announce_peer_ids.setdefault(
            m.task_id, idgen.peer_id(self.ip, self.hostname)
        )
        try:
            await self.scheduler.announce_task(
                peer_id, meta, self.host_info(),
                content_length=m.content_length, piece_size=m.piece_size,
                piece_indices=sorted(ts.finished.indices()), digest=m.digest,
            )
            return True
        except Exception:  # noqa: BLE001 — boot/keepalive announce is advisory;
            # the periodic loop retries and downloads still work unannounced
            logger.warning("announce of task %s failed", m.task_id[:12], exc_info=True)
            return False

    async def announce_tasks(self, *, include_partial: bool = True) -> int:
        """Re-announce possession of locally-held tasks (daemon announce
        loop): after a scheduler restart its resource pool is empty, and the
        existing backoff+breaker reconnect alone would leave this host's
        content invisible — the scheduler rebuilds its view from these
        announces alone. Stable per-task peer ids make this idempotent on a
        scheduler that did NOT restart (the announce adopts the existing
        row). Partial tasks are included by default — a recovered partial
        seed must survive a scheduler restart that postdates the boot
        announce — but a PINNED incomplete task is skipped: its running
        conductor owns the scheduler-side peer row."""
        n = 0
        for ts in self.storage.tasks():
            m = ts.meta
            if m.total_pieces is None or m.total_pieces < 0 or ts.finished_count() == 0:
                continue
            if not m.done and not include_partial:
                continue
            if not m.done and ts.pins > 0:
                continue  # a running conductor owns this task's peer row
            if await self._announce_possession(ts):
                n += 1
        return n

    def _shared_raw_client(self):
        """One raw range client for ALL conductors: keep-alive connections to
        a parent survive across tasks, so a recursive dfget (or a multi-file
        checkpoint fetch) reuses sockets instead of reconnecting per file.
        Under TLS the sharing matters twice: pooled connections skip the
        handshake entirely, and the bundle's session cache lets every fresh
        connect across all tasks resume abbreviated."""
        if self._raw_client is None:
            from dragonfly2_tpu_torch.daemon.rawrange import RawRangeClient

            self._raw_client = RawRangeClient(tls=self.data_tls)
        return self._raw_client

    def _shared_pipeline(self):
        """One piece pipeline (buffer pool + hash threads) for ALL
        conductors: pooled piece buffers and the hash-on-receive executor
        are host-level resources — per-task pools would re-pay the warmup
        allocations on every file of a multi-file checkpoint fetch."""
        if self._piece_pipeline is None:
            from dragonfly2_tpu_torch.daemon.pipeline import PiecePipeline

            self._piece_pipeline = PiecePipeline()
        return self._piece_pipeline

    async def _prune_raw_pool(self) -> None:
        if self._raw_client is not None:
            closed = self._raw_client.prune()
            if closed:
                logger.debug("raw range pool: pruned %d idle sockets", closed)

    async def cancel_conductors(self) -> None:
        """Terminate in-flight downloads (shutdown / crash-harness path)."""
        for t in list(self._conductors):
            t.cancel()
        if self._conductors:
            await asyncio.gather(*list(self._conductors), return_exceptions=True)
        self._conductors.clear()

    async def stop(self) -> None:
        if self._started:
            await self.cancel_conductors()
            self.gc.stop()
            await self.upload.stop()
            await self.sources.close()
            if self._raw_client is not None:
                await self._raw_client.close()
                self._raw_client = None
            if self._piece_pipeline is not None:
                self._piece_pipeline.close()
                self._piece_pipeline = None
            self.storage.flush_all()  # persist debounced piece metadata
            self._started = False

    # ---- task API (ref StartFileTask / StartSeedTask) ----

    def make_meta(self, url: str, **kw) -> TaskMeta:
        if url.startswith("d7y://cache/"):
            # imported cache object: the URL carries its digest-keyed task id
            # (see import_file) — recompute nothing, or two hosts disagree
            task_id = url.rsplit("/", 1)[1]
        else:
            task_id = idgen.task_id(
                url,
                filters=kw.get("filters", ()),
                tag=kw.get("tag", ""),
                application=kw.get("application", ""),
                digest=kw.get("digest", ""),
            )
        return TaskMeta(
            task_id=task_id,
            url=url,
            digest=kw.get("digest", ""),
            tag=kw.get("tag", ""),
            application=kw.get("application", ""),
            filters=tuple(kw.get("filters", ())),
        )

    async def _reuse_or_conduct(
        self,
        meta: TaskMeta,
        headers: dict[str, str] | None,
        *,
        seed: bool = False,
        priority: float = 1.0,
    ):
        """Shared reuse/purge/conductor logic for download_task + stream_task.

        Returns (ts, producer): producer is None on the reuse fast path, else
        a running conductor future; ts has metadata set (Content-Length known)
        by the time this returns."""
        import asyncio

        ts = self.storage.find_completed_task(meta.task_id)
        if ts is not None:
            # Pin across the verify AND the caller's subsequent use (export /
            # stream): the reclaim sweep runs in a thread and must never
            # rmtree a task an operation holds. Callers unpin when done.
            ts.pin()
            ok = False
            try:
                # verify() hashes the whole file — off the event loop
                ok = await asyncio.to_thread(ts.verify)
            finally:
                if not ok:
                    ts.unpin()
            if ok:
                logger.info("task %s: reuse fast path", meta.task_id[:12])
                return ts, None
            # completed-but-corrupt local copy: purge so the conductor
            # re-fetches instead of short-circuiting on the full bitset
            logger.warning("task %s: local copy corrupt, purging", meta.task_id[:12])
            self.storage.delete_task(meta.task_id)
        peer_id = idgen.peer_id(self.ip, self.hostname, seed=seed)
        # later possession announces adopt this download's row (same id)
        # instead of superseding it out from under attached children
        self._announce_peer_ids[meta.task_id] = peer_id
        conductor = PeerTaskConductor(
            peer_id=peer_id,
            meta=meta,
            host=self.host_info(),
            scheduler=self.scheduler,
            storage=self.storage,
            sources=self.sources,
            config=self.conductor_config,
            headers=headers,
            shaper=self.shaper,
            raw_client=self._shared_raw_client(),
            pipeline=self._shared_pipeline(),
            data_tls=self.data_tls,
            flow_weight=priority,
        )
        producer = asyncio.ensure_future(conductor.run())
        self._conductors.add(producer)
        producer.add_done_callback(self._conductors.discard)
        # Wait until the conductor registered storage + metadata. Polling:
        # the TaskStorage (and its progress event) does not exist until the
        # conductor registers with the scheduler, so there is nothing to
        # subscribe to yet; registration is a couple of RPC round-trips.
        while True:
            ts = self.storage.get(meta.task_id)
            if ts is not None and ts.meta.total_pieces >= 0:
                ts.pin()  # released by the caller when its operation completes
                return ts, producer
            if producer.done():
                producer.result()  # raise the failure
                raise IOError(f"task {meta.task_id}: no metadata after completion")
            await asyncio.sleep(0.01)

    async def download_task(
        self,
        url: str,
        *,
        output: str | Path | None = None,
        output_range: "tuple[int, int] | None" = None,
        seed: bool = False,
        headers: dict[str, str] | None = None,
        timeout: float | None = None,
        priority: float = 1.0,
        **meta_kw,
    ) -> TaskStorage:
        """Download (or reuse) a task; optionally export to a named file.

        `priority` is the task's tenant weight in the host traffic shaper:
        under contention, concurrent tasks' bandwidth shares converge to the
        ratio of their weights (a priority-3 task gets ~3x a priority-1
        neighbor); with headroom it changes nothing.

        `output_range=(start, end)` (inclusive bytes, HTTP Range semantics)
        exports just that slice — performed HERE, under this operation's pin,
        so a threaded storage reclaim can never evict the task between the
        download completing and the ranged export reading it. Raises
        ValueError when the range falls outside the task's content length.

        `timeout` is the task's whole-download budget: it rides the deadline
        contextvar into the conductor (whose watchdog narrows it) and from
        there into every rpc call and piece fetch (resilience.deadline)."""
        from dragonfly2_tpu_torch.daemon import metrics
        from dragonfly2_tpu_torch.observability.tracing import default_tracer
        from dragonfly2_tpu_torch.utils.pieces import Range

        await self.start()
        meta = self.make_meta(url, **meta_kw)
        metrics.TASK_TOTAL.inc(type="seed" if seed else "file")
        if seed:
            metrics.SEED_TASK_TOTAL.inc()

        # the span opens BEFORE the conductor task is created so every
        # conductor-side span (dispatch rounds, pieces, report flushes, the
        # scheduler RPCs) nests under daemon.peer_task through the task's
        # captured Context — spanning only the await left the conductor
        # parented to whatever the caller had current
        with default_tracer().span(
            "daemon.peer_task", task_id=meta.task_id, url=url, seed=seed
        ):
            with dl.scope(timeout):
                # the conductor task is created inside the scope, so it
                # inherits the budget through its captured Context
                ts, producer = await self._reuse_or_conduct(
                    meta, headers, seed=seed, priority=priority
                )
            pinned = ts  # engine-held pin for this operation (reclaim immunity)
            try:
                if producer is not None:
                    metrics.CONCURRENT_TASKS.inc()
                    try:
                        ts = await producer
                    except Exception:
                        metrics.TASK_RESULT_TOTAL.inc(success="false")
                        raise
                    finally:
                        metrics.CONCURRENT_TASKS.dec()
                    metrics.TASK_RESULT_TOTAL.inc(success="true")
                if output is not None:
                    if output_range is not None:
                        start, end = output_range
                        if start < 0 or end < start or end >= ts.meta.content_length:
                            raise RangeOutOfBounds(
                                f"range {start}-{end} out of bounds for "
                                f"{ts.meta.content_length} bytes"
                            )
                        await ts.export_range(output, Range(start, end - start + 1))
                    else:
                        await ts.export_to(output)
                return ts
            finally:
                pinned.unpin()

    async def stream_task(
        self,
        url: str,
        *,
        headers: dict[str, str] | None = None,
        timeout: float | None = None,
        **meta_kw,
    ):
        """Start (or reuse) a task and return (content_length, async-iterator)
        yielding the body in piece order as pieces land — the daemon's
        StartStreamTask path (ref peertask_manager.go:52, used by the proxy
        transport, transport.go:58-119). Returns as soon as task metadata is
        known, so a proxy can send response headers before the download
        finishes."""
        from dragonfly2_tpu_torch.daemon import metrics

        await self.start()
        meta = self.make_meta(url, **meta_kw)
        metrics.TASK_TOTAL.inc(type="stream")

        with dl.scope(timeout):
            ts, producer = await self._reuse_or_conduct(meta, headers)

        # The operation pin from _reuse_or_conduct is normally released by the
        # body generator's finally — but a caller that never iterates (or
        # closes) the generator (proxy client gone before the transport reads)
        # would leak it, making the task permanently reclaim-immune. A
        # once-only release also wired to the generator's GC covers that path.
        release = OncePinRelease(ts)

        async def body(ts=ts, producer=producer):
            if producer is not None:
                metrics.CONCURRENT_TASKS.inc()
            try:
                async for chunk in ts.stream_ordered(watch=producer):
                    yield chunk
                if producer is not None:
                    await producer  # surface trailing failures (digest check)
                metrics.TASK_RESULT_TOTAL.inc(success="true")
            except BaseException:
                metrics.TASK_RESULT_TOTAL.inc(success="false")
                if producer is not None and not producer.done():
                    producer.cancel()
                raise
            finally:
                release()  # the stream held the operation pin to the last chunk
                if producer is not None:
                    metrics.CONCURRENT_TASKS.dec()

        gen = body()
        weakref.finalize(gen, release)
        return ts.meta.content_length, gen

    async def import_file(
        self,
        path: str | Path,
        *,
        tag: str = "",
        application: str = "",
        piece_size: int | None = None,
    ) -> TaskStorage:
        """Import a local file into the P2P cache (ref dfcache Import,
        client/dfcache/dfcache.go:105 importTask): slice it into pieces in
        local storage, then register with the scheduler as an instantly
        successful peer so other peers can parent off this host (the
        reference's AnnounceTask path, scheduler/service/service_v1.go).
        Keyed by content digest (idgen.persistent_cache_task_id), so identical
        bytes imported under any filename on any host dedupe to one task.
        File I/O and hashing run off the event loop; pieces stream from disk
        (multi-GB model files must not be held in RAM)."""
        await self.start()
        import asyncio

        from dragonfly2_tpu_torch.utils import digest as digestlib
        from dragonfly2_tpu_torch.utils.pieces import compute_piece_size, piece_count, piece_range

        path = Path(path)

        def _hash_and_size() -> tuple[str, int]:
            with open(path, "rb") as f:
                d = digestlib.compute_file("sha256", f)
            return str(d), path.stat().st_size

        dig, size = await asyncio.to_thread(_hash_and_size)
        # piece_size override: checkpoint publishers pick larger pieces than
        # the generic ladder (fewer per-piece round-trips on the fan-out
        # path). The effective size is baked into the task id, so publishers
        # using different geometries yield distinct tasks instead of one task
        # with a conflicting index-keyed digest map.
        if piece_size is None:
            piece_size = compute_piece_size(size)
        task_id = idgen.persistent_cache_task_id(dig, tag, application, piece_size)
        url = f"d7y://cache/{task_id}"
        meta = TaskMeta(
            task_id=task_id, url=url, digest=dig, tag=tag, application=application
        )

        ts = self.storage.find_completed_task(task_id)
        if ts is None:
            ts = self.storage.register_task(task_id, url=url, tag=tag, digest=dig)
            n = piece_count(size, piece_size)
            ts.set_task_info(
                content_length=size, piece_size=piece_size, total_pieces=n, digest=dig
            )
            with open(path, "rb") as f:
                for idx in range(n):
                    r = piece_range(idx, piece_size, size)
                    chunk = await asyncio.to_thread(f.read, r.length)
                    await ts.write_piece(idx, chunk)
            ts.mark_done()

        # announce possession so the scheduler adds this peer as a ready
        # parent — one RPC, no scheduling round (ref AnnounceTask)
        peer_id = idgen.peer_id(self.ip, self.hostname)
        await self.scheduler.announce_task(
            peer_id, meta, self.host_info(),
            content_length=size, piece_size=ts.meta.piece_size,
            piece_indices=list(range(ts.meta.total_pieces)), digest=dig,
        )
        return ts

    async def seed_task(self, task) -> None:
        """seed_trigger hook for SchedulerService: pull the task from origin
        so normal peers can parent off this engine (ref StartSeedTask +
        seeder.ObtainSeeds, client/daemon/rpcserver/seeder.go:49-53)."""
        await self.download_task(
            task.url, seed=True, tag=task.tag, application=task.application,
            digest=task.digest, filters=task.filters,
        )
