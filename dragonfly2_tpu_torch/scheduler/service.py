"""Scheduler service: the control-plane business logic.

The port's own copy of dragonfly2_tpu/scheduler/service.py.

Parity with reference scheduler/service/service_v2.go (AnnouncePeer handler
family, :81-189 and :641-1308) and service_v1.go: peer registration with
size-scope fast paths (EMPTY/TINY inline, SMALL single-parent, NORMAL DAG),
piece-result accounting, peer-result completion with telemetry records,
host announce/leave, and seed-peer triggering. In-process async API; the RPC
server wraps these methods 1:1, so the full logic is testable without sockets
(the reference needed 4,182 lines of mock-stream tests for the same coverage).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

import numpy as np

from dragonfly2_tpu_torch.observability.tracing import default_tracer
from dragonfly2_tpu_torch.scheduler import metrics
from dragonfly2_tpu_torch.scheduler.evaluator import FALLBACK_REASONS, Evaluator, build_pair_features, new_evaluator
from dragonfly2_tpu_torch.scheduler.resource import (
    GCPolicy,
    HostType,
    PEER_BACK_TO_SOURCE,
    PEER_FAILED,
    PEER_SUCCEEDED,
    Peer,
    ResourcePool,
    SizeScope,
    Task,
)
from dragonfly2_tpu_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_tpu_torch.telemetry import TelemetryStorage

logger = logging.getLogger(__name__)


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
    # the daemon traffic shaper's tenant weight, carried to the scheduler so
    # the admission-control brownout rung sheds the lowest first
    priority: float = 1.0


@dataclass
class ParentInfo:
    """What a child needs to reach a parent's piece server."""

    peer_id: str
    host_id: str
    ip: str
    download_port: int

    @classmethod
    def of(cls, p: Peer) -> "ParentInfo":
        return cls(p.id, p.host.id, p.host.ip, p.host.download_port)


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
    # error == "overloaded": come back after this many seconds — the typed
    # brownout answer; clients pre-charge their retry budget with
    # it so the whole process backs off, not just this request
    retry_after_s: float = 0.0


class SchedulerService:
    def __init__(
        self,
        *,
        evaluator: Evaluator | None = None,
        scheduling_config: SchedulingConfig | None = None,
        telemetry: TelemetryStorage | None = None,
        gc_policy: GCPolicy | None = None,
        seed_trigger: Callable[[Task], Awaitable[None]] | None = None,
        clock=None,
        topology_rng=None,
        decision_sample_rate: float | None = None,
    ):
        from dragonfly2_tpu_torch.observability.sketches import DriftDetector
        from dragonfly2_tpu_torch.scheduler.evaluator import (
            DECISION_SAMPLE_DEFAULT,
            DecisionRecorder,
        )
        from dragonfly2_tpu_torch.scheduler.networktopology import NetworkTopology
        from dragonfly2_tpu_torch.telemetry import BandwidthHistory
        from dragonfly2_tpu_torch.utils import clock as clockmod

        # Injectable time source (utils/clock.py): every wall/monotonic read
        # on the scheduling and TTL paths goes through this — production
        # default is the system clock, the swarm simulator injects a
        # VirtualClock so one process can play hours of TTL/GC and
        # federation behavior in seconds.
        self.clock = clock or clockmod.SYSTEM
        self.pool = ResourcePool(gc_policy, clock=self.clock)
        self.evaluator = evaluator or new_evaluator("base")
        # registry-scoped serving-health counters: rollout health
        # baselines window THESE, so N services in one process never share a
        # baseline; the process-global families keep serving /metrics
        self.local_metrics = metrics.ServiceMetrics()
        self.evaluator.local_metrics = self.local_metrics
        self.scheduling = Scheduling(self.evaluator, scheduling_config)
        # ---- ML-plane observability ----
        # Decision records: a bounded sampled ring of scoring rounds (who the
        # candidates were, the feature rows as scored, scores, chosen top-k,
        # serving version, trace id) served at /debug/decisions and the
        # decision_records RPC; `dfml explain` replays them. Clock-injected
        # so simulated rounds stamp virtual time (DF029).
        if decision_sample_rate is None:
            import os as _os2

            decision_sample_rate = float(
                _os2.environ.get("DRAGONFLY_DECISION_SAMPLE", "")
                or DECISION_SAMPLE_DEFAULT
            )
        self.decisions = DecisionRecorder(
            sample_rate=decision_sample_rate,
            topk=self.scheduling.config.candidate_parent_limit,
            clock=self.clock,
        )
        self.evaluator.decisions = self.decisions
        # Feature drift: live-sketch feed at the evaluator's _prepare vs the
        # training-reference sketch the ManagerLink installs from the model
        # artifact; dormant (a None-check per round) until a reference lands.
        self.drift = DriftDetector(clock=self.clock)
        self.evaluator.drift = self.drift
        # Scheduler state lock (see Scheduling.state_lock): every mutator
        # below holds it around its mutating block so the round dispatcher's
        # worker threads (sample+filter) see consistent peer state. With no
        # dispatcher configured (the default) every acquire is uncontended
        # loop-side noise. NEVER held across an await.
        self.state_lock = self.scheduling.state_lock
        self.telemetry = telemetry
        # topology_rng: seedable randomness for probe-target selection —
        # production leaves it None (fresh entropy); the simulator seeds it
        # so a run's probe schedule (and thus its telemetry/dataset) is
        # bit-reproducible from SimConfig.seed
        self.topology = NetworkTopology(
            telemetry=telemetry, clock=self.clock, rng=topology_rng
        )
        self.evaluator.topology = self.topology  # rtt_norm feature source
        self.bandwidth = BandwidthHistory()  # bandwidth_norm feature source
        if telemetry is not None:
            # warm-start from persisted download records so the feature
            # survives scheduler restarts
            self.bandwidth.load_from(telemetry)
        self.evaluator.bandwidth = self.bandwidth
        self.seed_trigger = seed_trigger
        self._seed_triggered: set[str] = set()
        # Federation instance epoch: version counters reset on restart, so a
        # peer's saved watermarks against THIS instance are meaningless for
        # the next one — the sync protocol compares epochs and restarts from
        # zero (and a member that reaches itself through a misconfigured
        # static peer list sees its own epoch and self-excludes).
        import os as _os

        self.federation_epoch = _os.urandom(8).hex()
        # Brownout ladder: attached by the composition root (or
        # the sim); None = admit everything, shed nothing
        self.degradation = None

    def attach_degradation(self, controller) -> None:
        """Wire a DegradationController: register_peer consults its admission
        gate and the evaluator reads its shed flags."""
        self.degradation = controller
        self.evaluator.degradation = controller

    def enable_native_mirror(self):
        """Opt in to the native mirrored peer table: build a
        MirrorClient over the serving bundle's C++ scorer, full-sync it from
        the current pool under the state lock, and wire the mutation hooks
        (resource pool, topology, bandwidth) so every version bump streams an
        incremental delta to the C side. Subsequent native batches sample,
        filter, gather and score without the snapshot-under-lock leg.

        Explicit opt-in (chip_smoke.py's mirror wave, tests) rather than default-on: the mirror changes no results, but a
        deployment that never measured it shouldn't silently grow a C-side
        copy of its peer table. Returns the MirrorClient, or None when the
        evaluator has no eligible native bundle (base evaluator, torch
        engine, brownout at base_only)."""
        entry = getattr(self.evaluator, "native_round_entry", None)
        bundle = entry() if entry is not None else None
        if bundle is None:
            return None
        old = self.scheduling._mirror
        if old is not None:
            old.close()
            self.scheduling._mirror = None  # dflint: disable=DF036 lifecycle owner: unwiring the replaced client before attaching its successor
        from dragonfly2_tpu_torch.scheduler.mirror import MirrorClient

        client = MirrorClient(bundle.scorer)
        with self.state_lock:
            client.attach(self.pool, self.evaluator)
        self.scheduling._mirror = client  # dflint: disable=DF036 lifecycle owner: the one designated attach site (client just full-synced under the state lock)
        return client

    def close(self) -> None:
        """Release dispatcher worker threads (no-op in serial mode) and the
        native mirror, when one was enabled."""
        m = self.scheduling._mirror
        if m is not None:
            self.scheduling._mirror = None  # dflint: disable=DF036 lifecycle owner: deliberate unwiring at service close
            m.close()
        self.scheduling.close()

    # ---- registration (ref handleRegisterPeerRequest → schedule()) ----

    def _supersede_host_peers(self, task: Task, host_id: str, keep_peer_id: str) -> int:
        """Resurrection: a host (re)claiming a task owns its durable state,
        so any OTHER peer row for the same (task, host) is a dead
        incarnation's ghost — a crashed daemon never sent leave_host, and its
        ghost still holds parent upload slots and DAG edges that would
        collide with the returning host's announce/register. Dropping the
        ghosts is atomic from the caller's view (no await): children of a
        ghost lose their edge and reschedule; a superseded-but-actually-live
        peer (pathological double-download on one host) self-heals through
        the conductor's reschedule→not_found→re-register path. Returns the
        number of ghosts removed. Walks the HOST's peer index (a handful of
        rows), not the task's whole DAG: at flash-crowd scale the task holds
        10^5 peers and this runs on every registration — the O(task-peers)
        scan was O(N²) across the crowd (swarm-simulator finding)."""
        host = self.pool.hosts.get(host_id)
        if host is None:
            return 0
        stale = [
            pid
            for pid in host.peer_ids
            if pid != keep_peer_id
            and (p := self.pool.peer(pid)) is not None
            and p.task is task
        ]
        for pid in stale:
            self.pool.delete_peer(pid)
        if stale:
            metrics.PEER_SUPERSEDED_TOTAL.inc(len(stale))
        return len(stale)

    async def register_peer(
        self, peer_id: str, meta: TaskMeta, host_info: HostInfo
    ) -> RegisterResult:
        # Admission control (brownout rung 4): refuse BEFORE any resource
        # rows exist — a shed registration must cost one priority compare,
        # not a peer/host/task allocation it then abandons. The typed answer
        # (vs letting the RPC time out) turns a would-be retry storm into a
        # scheduled comeback at retry_after_s.
        deg = self.degradation
        if deg is not None:
            # consulted on EVERY registration (not just at rung 4) so the
            # controller learns the live priority classes before it ever
            # needs a shed cutoff; below rung 4 this is one set lookup
            admitted, retry_after = deg.admit(getattr(meta, "priority", 1.0))
            if not admitted:
                metrics.ADMISSION_SHED_TOTAL.inc(
                    priority=f"{getattr(meta, 'priority', 1.0):g}"
                )
                return RegisterResult(
                    scope=SizeScope.UNKNOWN.value, task_id=meta.task_id,
                    error="overloaded", retry_after_s=retry_after,
                )
        with self.state_lock:
            host = self.pool.load_or_create_host(
                host_info.id,
                host_info.ip,
                host_info.hostname,
                port=host_info.port,
                download_port=host_info.download_port,
                host_type=HostType(host_info.type),
                idc=host_info.idc,
                location=host_info.location,
            )
            task = self.pool.load_or_create_task(
                meta.task_id,
                meta.url,
                digest=meta.digest,
                tag=meta.tag,
                application=meta.application,
                filters=tuple(meta.filters),
            )
            self._supersede_host_peers(task, host.id, peer_id)
            peer = self.pool.create_peer(peer_id, task, host)
            if task.fsm.can("download"):
                task.fsm.fire("download")

        def ensure_received() -> None:
            # Idempotent for RPC retries: a reused peer may already be past
            # PENDING; finished peers restart (ref FSM "restart" event).
            if peer.fsm.can("register"):
                peer.fsm.fire("register")
            elif peer.fsm.can("restart"):
                peer.fsm.fire("restart")

        # Unstarted task: hand it to a seed peer if we have one, else this
        # peer goes back-to-source (ref downloadTaskBySeedPeer, :1134).
        if not task.has_available_peer(blocklist={peer.id}):
            if task.url.startswith("d7y://"):
                # cache imports have no origin: with every holder gone there
                # is nothing to go back to — refuse cleanly instead of
                # pointing the peer at an unfetchable scheme
                ensure_received()
                if peer.fsm.can("fail"):
                    peer.fsm.fire("fail")
                return RegisterResult(
                    scope=SizeScope.UNKNOWN.value, task_id=task.id,
                    error="cache content unavailable: no peer holds this task",
                )
            seed_incoming = task.id in self._seed_triggered
            if self.seed_trigger is not None and not seed_incoming and host.type != HostType.SEED:
                self._seed_triggered.add(task.id)
                asyncio.ensure_future(self._run_seed_trigger(task))
                seed_incoming = True
            if not seed_incoming or host.type == HostType.SEED:
                # Seed hosts fetch the origin by definition; normal peers do
                # too when there is no seed infrastructure to wait for.
                ensure_received()
                if peer.fsm.can("back_to_source"):
                    peer.fsm.fire("back_to_source")
                return RegisterResult(
                    scope=SizeScope.UNKNOWN.value, task_id=task.id, back_to_source=True
                )
            # A seed download is starting (or in flight): fall through to the
            # NORMAL scheduling round — its retry loop waits for the seed to
            # appear in the DAG and still escalates to back-to-source after
            # the retry budget (ref downloadTaskBySeedPeer → schedule()).

        scope = task.size_scope()
        common = dict(
            task_id=task.id,
            content_length=task.content_length,
            piece_size=task.piece_size,
            total_pieces=task.total_pieces,
            digest=task.digest,
        )
        metrics.REGISTER_PEER_TOTAL.inc(scope=scope.value)
        if scope == SizeScope.EMPTY:
            ensure_received()
            return RegisterResult(scope=scope.value, **common)
        if scope == SizeScope.TINY and task.direct_piece:
            ensure_received()
            return RegisterResult(scope=scope.value, direct_piece=task.direct_piece, **common)
        if scope == SizeScope.SMALL:
            parent = self.scheduling.find_success_parent(peer)
            if parent is not None:
                ensure_received()
                with self.state_lock:
                    task.add_edge(parent.id, peer.id)
                return RegisterResult(
                    scope=scope.value, parents=[ParentInfo.of(parent)], **common
                )
        # NORMAL (or SMALL fallback): full scheduling round
        ensure_received()
        with default_tracer().span("scheduler.schedule", task_id=task.id, peer_id=peer.id), \
                metrics.SCHEDULE_DURATION.time(), \
                self.local_metrics.schedule_duration.time():
            outcome = await self.scheduling.schedule_candidate_parents(peer)
        if outcome.back_to_source:
            metrics.BACK_TO_SOURCE_TOTAL.inc()
            return RegisterResult(
                scope=SizeScope.NORMAL.value, task_id=task.id, back_to_source=True,
                content_length=task.content_length, piece_size=task.piece_size,
                total_pieces=task.total_pieces, digest=task.digest,
            )
        if peer.fsm.can("download"):
            peer.fsm.fire("download")
        return RegisterResult(
            scope=SizeScope.NORMAL.value,
            parents=[ParentInfo.of(p) for p in outcome.parents],
            **common,
        )

    async def _run_seed_trigger(self, task: Task) -> None:
        try:
            await self.seed_trigger(task)
        except Exception:
            logger.exception("seed trigger failed for task %s", task.id)
            self._seed_triggered.discard(task.id)

    # ---- metadata from the first back-to-source peer ----

    def report_task_metadata(
        self,
        task_id: str,
        *,
        content_length: int,
        piece_size: int | None = None,
        digest: str = "",
        direct_piece: bytes = b"",
    ) -> None:
        task = self.pool.tasks.get(task_id)
        if task is None:
            return
        with self.state_lock:
            task.set_metadata(content_length, piece_size)
            if digest:
                task.digest = digest
            if direct_piece:
                task.direct_piece = direct_piece

    # ---- piece + peer results (ref handleDownloadPiece*Request) ----

    def _apply_piece_success(
        self, peer: Peer, piece_index: int, cost_ms: float, parent_id: str, *, dedupe: bool
    ) -> bool:
        """One successful piece's full accounting — shared by the unary and
        batched report paths so they cannot diverge. With dedupe=True an
        already-finished index is skipped WHOLE (no metrics, no cost sample,
        no parent credit): that is what makes a retried batch flush an exact
        no-op (exactly-once accounting under at-least-once delivery)."""
        task = peer.task
        newly_set = peer.finished_pieces.set(piece_index)
        if dedupe and not newly_set:
            metrics.PIECE_REPORT_DUPLICATE_TOTAL.inc()
            return False
        metrics.PIECE_RESULT_TOTAL.inc(success="true")
        if task.piece_size:
            if task.content_length:
                # final piece is usually partial
                nbytes = min(task.piece_size, task.content_length - piece_index * task.piece_size)
            else:
                nbytes = task.piece_size
            if nbytes > 0:
                metrics.DOWNLOAD_TRAFFIC_BYTES.inc(nbytes)
        if peer.fsm.can("download"):
            peer.fsm.fire("download")
        peer.add_piece_cost(cost_ms)  # bumps the peer's feature version
        if parent_id:
            parent = self.pool.peer(parent_id)
            if parent is not None:
                parent.host.upload_count += 1
                parent.host.bump_feat()
                parent.touch()
        return True

    def report_piece_result(
        self,
        peer_id: str,
        piece_index: int,
        *,
        success: bool,
        cost_ms: float = 0.0,
        parent_id: str = "",
    ) -> None:
        peer = self.pool.peer(peer_id)
        if peer is None:
            return
        peer.touch()
        with self.state_lock:
            if success:
                self._apply_piece_success(peer, piece_index, cost_ms, parent_id, dedupe=False)
                return
            metrics.PIECE_RESULT_TOTAL.inc(success="false")
            if parent_id:
                parent = self.pool.peer(parent_id)
                if parent is not None:
                    parent.host.upload_failed_count += 1
                    parent.host.bump_feat()
                peer.block_parents.add(parent_id)

    def announce_task(
        self,
        peer_id: str,
        meta: TaskMeta,
        host_info: HostInfo,
        *,
        content_length: int,
        piece_size: int,
        piece_indices: list[int],
        digest: str = "",
    ) -> None:
        """A peer announces it already HOLDS task content (ref AnnounceTask,
        scheduler/service/service_v1.go — the dfcache import path, and the
        crash-recovery rejoin): create the resource rows, set metadata, mark
        pieces finished, and drive the peer FSM to Succeeded when the
        announce covers the whole task — a PARTIAL announce (a daemon
        restarting mid-download rejoins as a partial seed) stays Running, a
        valid parent state whose real piece availability children learn from
        the host's metadata long-poll. One RPC, no scheduling round. An
        announce supersedes any ghost peer rows its host left behind
        (host crashed without leave_host): the durable on-disk state it
        claims IS the host's state for this task."""
        with self.state_lock:
            host = self.pool.load_or_create_host(
                host_info.id, host_info.ip, host_info.hostname,
                port=host_info.port, download_port=host_info.download_port,
                host_type=HostType(host_info.type), idc=host_info.idc,
                location=host_info.location,
            )
            # ports move across restarts; the announce carries the live ones
            if host_info.port:
                host.port = host_info.port
            if host_info.download_port and host.download_port != host_info.download_port:
                host.download_port = host_info.download_port
                host.bump_feat()
            task = self.pool.load_or_create_task(
                meta.task_id, meta.url, digest=meta.digest or digest,
                tag=meta.tag, application=meta.application, filters=tuple(meta.filters),
            )
            task.set_metadata(content_length, piece_size)
            if digest:
                task.digest = digest
            if task.fsm.can("download"):
                task.fsm.fire("download")
            self._supersede_host_peers(task, host.id, peer_id)
            peer = self.pool.create_peer(peer_id, task, host)
            for ev in ("register", "download"):
                if peer.fsm.can(ev):
                    peer.fsm.fire(ev)
            for idx in piece_indices:
                peer.finished_pieces.set(idx)
            peer.bump_feat()
            total = task.total_pieces or 0
            complete = (
                (total > 0 and peer.finished_pieces.count() >= total)
                or content_length == 0  # empty objects have no pieces to hold
            )
            if complete:
                if peer.fsm.can("succeed"):
                    peer.fsm.fire("succeed")
                if task.fsm.can("succeed"):
                    task.fsm.fire("succeed")

    def report_pieces(self, peer_id: str, reports) -> int:
        """Batched success report: one RPC for N pieces (the conductor's
        piece-report buffer flush — the hot-path replacement for one
        report_piece_result round trip per piece).

        `reports` is a sequence of (piece_index, cost_ms, parent_id) triples
        (lists over the wire). Each entry gets the SAME accounting as a unary
        report_piece_result(success=True) — shared _apply_piece_success —
        except that an index already in the peer's finished set is skipped
        whole, duplicate-counted in PIECE_REPORT_DUPLICATE_TOTAL: a flush
        retried by the rpc client (injected rpc.write fault, timeout after a
        server-side apply) re-applies as an exact no-op. Returns the number
        of newly applied pieces."""
        peer = self.pool.peer(peer_id)
        if peer is None:
            return 0
        peer.touch()
        metrics.PIECE_REPORT_BATCH_TOTAL.inc()
        applied = 0
        # one lock hold per BATCH, not per piece: the whole flush applies as
        # a single critical section against in-flight dispatcher rounds
        with self.state_lock:
            for rep in reports:
                idx, cost_ms, parent_id = rep[0], rep[1], rep[2]
                if self._apply_piece_success(peer, idx, cost_ms, parent_id, dedupe=True):
                    applied += 1
        return applied

    async def reschedule(self, peer_id: str) -> RegisterResult:
        """Child lost its parents; run another round (ref reschedule path)."""
        peer = self.pool.peer(peer_id)
        if peer is None:
            raise KeyError(peer_id)
        task = peer.task
        with default_tracer().span("scheduler.reschedule", task_id=task.id, peer_id=peer.id), \
                metrics.SCHEDULE_DURATION.time(), \
                self.local_metrics.schedule_duration.time():
            outcome = await self.scheduling.schedule_candidate_parents(peer, blocklist=peer.block_parents)
        if outcome.back_to_source:
            metrics.BACK_TO_SOURCE_TOTAL.inc()
            return RegisterResult(
                scope=task.size_scope().value, task_id=task.id, back_to_source=True,
                content_length=task.content_length, piece_size=task.piece_size,
                total_pieces=task.total_pieces, digest=task.digest,
            )
        return RegisterResult(
            scope=task.size_scope().value,
            task_id=task.id,
            parents=[ParentInfo.of(p) for p in outcome.parents],
            content_length=task.content_length,
            piece_size=task.piece_size,
            total_pieces=task.total_pieces,
            digest=task.digest,
        )

    def report_peer_result(
        self, peer_id: str, *, success: bool, bandwidth_bps: float = 0.0
    ) -> None:
        peer = self.pool.peer(peer_id)
        if peer is None:
            return
        metrics.PEER_RESULT_TOTAL.inc(success=str(success).lower())
        with self.state_lock:
            records = self._apply_peer_result(
                peer, success=success, bandwidth_bps=bandwidth_bps
            )
        # Telemetry emit OUTSIDE the state lock: ColumnarStore.append
        # synchronously savez-rotates tens of thousands of rows to disk at
        # its cap — holding the lock across that would stall every
        # dispatcher worker's sample/filter leg for tens of ms.
        for kw in records:
            self.telemetry.downloads.append(**kw)

    def report_batch(
        self, peer_id: str, reports, result: dict | None = None
    ) -> int:
        """Task-completion flush + peer result in ONE RPC and ONE lock pass:
        the conductor's close_with_result ships its residual piece batch and
        the final report_peer_result together, collapsing the two awaited
        control-plane round trips at task close into one.

        `reports` carries the same (piece_index, cost_ms, parent_id) triples
        as report_pieces, applied with the same dedupe=True idempotent
        re-apply discipline. `result` (optional) is
        {"success": bool, "bandwidth_bps": float}; its apply is ALSO
        idempotent — a peer whose FSM already reached a terminal state is
        skipped whole (no second result metric, no double bandwidth observe,
        no duplicate telemetry rows), so a flush retried by the rpc client
        after a server-side apply is an exact no-op. Unary peers keep calling
        report_peer_result unchanged. Returns newly applied piece count."""
        peer = self.pool.peer(peer_id)
        if peer is None:
            return 0
        peer.touch()
        metrics.PIECE_REPORT_BATCH_TOTAL.inc()
        applied = 0
        records: list[dict] = []
        with self.state_lock:
            for rep in reports:
                if self._apply_piece_success(
                    peer, rep[0], rep[1], rep[2], dedupe=True
                ):
                    applied += 1
            if result is not None:
                if peer.fsm.current in (PEER_SUCCEEDED, PEER_FAILED):
                    # retried close flush: the result already landed
                    metrics.PIECE_REPORT_DUPLICATE_TOTAL.inc()
                else:
                    success = bool(result.get("success"))
                    metrics.PEER_RESULT_TOTAL.inc(success=str(success).lower())
                    records = self._apply_peer_result(
                        peer, success=success,
                        bandwidth_bps=float(result.get("bandwidth_bps", 0.0)),
                    )
        for kw in records:
            self.telemetry.downloads.append(**kw)
        return applied

    def _apply_peer_result(
        self, peer: Peer, *, success: bool, bandwidth_bps: float
    ) -> list[dict]:
        """One peer result's full accounting — shared by the unary and the
        batched (report_batch) paths so they cannot diverge. Caller holds
        the state lock; the returned telemetry rows must be appended AFTER
        the lock is released."""
        task = peer.task
        if success:
            if peer.fsm.can("succeed"):
                peer.fsm.fire("succeed")
            if task.fsm.can("succeed"):
                task.fsm.fire("succeed")
        else:
            if peer.fsm.can("fail"):
                peer.fsm.fire("fail")
            if not task.has_available_peer() and task.fsm.can("fail"):
                task.fsm.fire("fail")
        # Record FIRST, observe SECOND: the persisted pair_features must
        # carry the schedule-time history, not this download's own
        # bandwidth — otherwise f[8] equals the label on first transfers
        # and the trainer learns to read the answer off the feature
        # (train/serve skew). Rows are BUILT here (feature snapshot
        # pre-observe, parents still edged) but appended after the lock.
        records = self._build_download_records(peer, success, bandwidth_bps)
        if success and bandwidth_bps > 0:
            # feed the bandwidth-history EWMA (feature f[8]) before the
            # parent edges are dropped below — apportioned across parents:
            # bandwidth_bps is the child's AGGREGATE rate, so crediting it
            # whole to each of up to 4 parents would overstate every
            # parent's EWMA (and the trainer's labels) by the parent-count
            # factor
            parents = task.parents_of(peer.id)
            if parents:
                per_parent = bandwidth_bps / len(parents)
                for parent in parents:
                    self.bandwidth.observe(parent.host.id, peer.host.id, per_parent)
        # The peer stops downloading either way: release its parents'
        # upload slots now, not at the 24h GC (it stays in the DAG as a
        # parent).
        task.delete_parents(peer.id)
        return records

    def _build_download_records(
        self, peer: Peer, success: bool, bandwidth_bps: float
    ) -> list[dict]:
        """Telemetry rows for one peer result (ref createDownloadRecord,
        service_v1.go:1241) — BUILT under the caller's state lock (the
        feature snapshot must precede the bandwidth observe and the parent
        edges' removal), appended by the caller outside it."""
        if self.telemetry is None:
            return []
        task = peer.task
        parents = task.parents_of(peer.id)
        costs = peer.piece_costs_ms
        # Per-ROW bandwidth is apportioned across parents: each row is one
        # (parent, child) pair and bandwidth_bps is the child's aggregate, so
        # stamping the aggregate into every row would overstate the trainer's
        # per-pair labels AND the warm-start (BandwidthHistory.load_from
        # replays rows through observe) by the parent-count factor — the
        # persisted rows must agree with the apportioned live observe below.
        row_bw = bandwidth_bps / len(parents) if parents else bandwidth_bps
        base = dict(
            task_id=task.id.encode()[:64],
            child_peer_id=peer.id.encode()[:64],
            child_host_id=peer.host.id.encode()[:64],
            piece_count=peer.finished_pieces.count(),
            piece_size=task.piece_size or 0,
            content_length=task.content_length or -1,
            bandwidth_bps=row_bw,
            piece_cost_ms_mean=float(np.mean(costs)) if costs else 0.0,
            success=success,
            back_to_source=peer.fsm.is_(PEER_BACK_TO_SOURCE) or peer.state == PEER_SUCCEEDED and not parents,
            # record stamps ride the service clock: simulated traffic carries
            # virtual timestamps end-to-end (identical to the store's own
            # time.time() default under the production system clock)
            created_at=self.clock.time(),
        )
        if parents:
            feats = build_pair_features(peer, parents, self.topology, self.bandwidth)
            return [
                dict(
                    parent_peer_id=p.id.encode()[:64],
                    parent_host_id=p.host.id.encode()[:64],
                    pair_features=f,
                    **base,
                )
                for p, f in zip(parents, feats)
            ]
        return [
            dict(
                parent_peer_id=b"", parent_host_id=b"",
                pair_features=np.zeros(16, np.float32), **base,
            )
        ]

    # ---- host lifecycle (ref AnnounceHost / LeaveHost / LeaveTask) ----

    def announce_host(self, info: HostInfo, stats: dict[str, float] | None = None) -> None:
        with self.state_lock:
            host = self.pool.load_or_create_host(
                info.id, info.ip, info.hostname,
                port=info.port, download_port=info.download_port,
                host_type=HostType(info.type), idc=info.idc, location=info.location,
            )
            # Refresh connection endpoints: the host row may predate this
            # announce (created by register_peer with no RPC port) and ports
            # move on restart.
            if info.port:
                host.port = info.port
            if info.download_port:
                host.download_port = info.download_port
            host.type = HostType(info.type)
            host.bump_feat()  # type/idc/location feed evaluator features
            if stats:
                for k, v in stats.items():
                    if hasattr(host.stats, k):
                        setattr(host.stats, k, float(v))
            host.touch()

    def leave_peer(self, peer_id: str) -> None:
        peer = self.pool.peer(peer_id)
        if peer is None:
            return
        with self.state_lock:
            if peer.fsm.can("leave"):
                peer.fsm.fire("leave")
            # children of this peer must reschedule; drop its edges now
            self.pool.delete_peer(peer_id)

    def leave_host(self, host_id: str) -> None:
        host = self.pool.hosts.get(host_id)
        if host is None:
            return
        with self.state_lock:
            for pid in list(host.peer_ids):
                self.leave_peer(pid)
            self.pool.delete_host(host_id)
            self.topology.forget_host(host_id)
            self.bandwidth.forget_host(host_id)

    # ---- network topology probes (ref SyncProbes, finished here) ----

    def sync_probes(self, src_host_id: str, results: list[dict]) -> list[dict]:
        """Ingest a probe round from a daemon and hand back the next targets."""
        with self.state_lock:
            targets = self.topology.sync_probes(
                src_host_id, results, self.pool.hosts,
                host_list=self.pool.host_values(),
            )
        if results:
            metrics.PROBES_SYNCED_TOTAL.inc(len(results))
        return [{"host_id": t.host_id, "ip": t.ip, "port": t.port} for t in targets]

    # ---- scheduler federation (scheduler/federation.py drives this) ----

    def federation_sync(
        self,
        origin: str,
        *,
        topo_since: int = 0,
        bw_since: int = 0,
        topo_push: list[dict] | None = None,
        bw_push: list[dict] | None = None,
        epoch: str = "",
    ) -> dict[str, Any]:
        """One push-pull gossip exchange, served to a peer scheduler: merge
        the peer's pushed deltas into the remote view, then answer with OUR
        local deltas above the peer's watermarks. Merging and enumeration
        run under the state lock (dispatcher workers read these structures
        lock-free via the version keys; the merge bumps versions with the
        same stats-before-bump ordering the local mutators use).

        `epoch` is the CALLER's instance epoch: when it equals ours the
        caller reached itself (0.0.0.0 bind + its own address in a shared
        static peer list) — refuse the exchange instead of mirroring the
        member's own edges back into its remote view."""
        if epoch and epoch == self.federation_epoch:
            return {
                "epoch": self.federation_epoch, "self": True,
                "topo_watermark": 0, "bw_watermark": 0,
                "edges": [], "bandwidth": [], "applied": 0,
            }
        applied = 0
        with self.state_lock:
            if topo_push:
                applied += self.topology.merge_remote(topo_push, origin=origin)
            if bw_push:
                applied += self.bandwidth.merge_remote(bw_push, origin=origin)
            topo_wm, edges = self.topology.local_edges_since(topo_since)
            bw_wm, entries = self.bandwidth.local_entries_since(bw_since)
        if applied:
            metrics.FEDERATION_DELTAS_APPLIED_TOTAL.inc(applied)
        if edges or entries:
            metrics.FEDERATION_DELTAS_SENT_TOTAL.inc(len(edges) + len(entries))
        return {
            "epoch": self.federation_epoch,
            "topo_watermark": topo_wm,
            "bw_watermark": bw_wm,
            "edges": edges,
            "bandwidth": entries,
            "applied": applied,
        }

    def federation_state(self) -> dict[str, Any]:
        """Merged-view introspection for tests and operators (served over RPC as `federation_state`)."""
        return {
            "epoch": self.federation_epoch,
            "local_edges": self.topology.edge_count(),
            "remote_edges": self.topology.remote_edge_count(),
            "topo_watermark": self.topology.version,
            "local_bandwidth_pairs": len(self.bandwidth),
            "remote_bandwidth_pairs": self.bandwidth.remote_entry_count(),
            "bw_watermark": self.bandwidth.version,
            "hosts": len(self.pool.hosts),
            "peers": self.pool.peer_count(),
            "tasks": len(self.pool.tasks),
        }

    def stat_task(self, task_id: str) -> dict[str, Any] | None:
        task = self.pool.tasks.get(task_id)
        if task is None:
            return None
        return {
            "id": task.id,
            "url": task.url,
            "state": task.state,
            "content_length": task.content_length,
            "piece_size": task.piece_size,
            "total_pieces": task.total_pieces,
            "peer_count": task.peer_count(),
            "size_scope": task.size_scope().value,
        }

    # ---- ML-plane observability ----

    def decision_records(
        self,
        *,
        task_id: str | None = None,
        child: str | None = None,
        limit: int = 64,
        with_features: bool = True,
    ) -> dict[str, Any]:
        """Recorded scoring decisions + the drift/serving context `dfml
        explain` replays them against (served over the `decision_records`
        RPC). ``fallbacks`` adds to the reference's answer the process's
        ML_BASE_FALLBACK_TOTAL by reason (also on the debug server's
        /metrics): a round that fell back is recorded without its
        reason."""
        return {
            "recorder": self.decisions.stats(),
            "records": self.decisions.snapshot(
                task_id=task_id, child=child, limit=limit,
                with_features=with_features,
            ),
            "serving_version": getattr(self.evaluator, "serving_version", ""),
            "drift": self.drift.snapshot(),
            "fallbacks": {
                reason: metrics.ML_BASE_FALLBACK_TOTAL.labels(reason=reason).value
                for reason in FALLBACK_REASONS
            },
        }
