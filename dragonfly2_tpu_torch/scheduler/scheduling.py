"""Parent-selection algorithm.

The port's own copy of dragonfly2_tpu/scheduler/scheduling.py.

Parity with reference scheduler/scheduling/scheduling.go:81-207 and the
constants at scheduler/config/constants.go:36-76: per round, sample up to 40
random peers from the task DAG, run the candidate filters, score the
survivors with the (batched) evaluator, and hand back the top 4; retry up to
10 times, escalating to back-to-source after 5 empty rounds.

Retry pacing is the shared resilience BackoffPolicy (exponential from
retry_interval with seeded jitter, capped at 16x the base) instead of the
reference's fixed 50 ms ticks: empty rounds early in a task's life are
common (parents still registering) and deserve a fast re-try, while a task
that stays parentless shouldn't hammer the DAG sampler every 50 ms.

The retry loop is async (the reference used a goroutine sleep loop); filters
are pure functions over the resource model so they unit-test without mocks.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from dragonfly2_tpu_torch.models.features import FEATURE_DIM
from dragonfly2_tpu_torch.observability.tracing import default_tracer
from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy
from dragonfly2_tpu_torch.scheduler.evaluator import (
    Evaluator,
    _export_pair_rows,
    _round_col_values,
    build_pair_features,
)
from dragonfly2_tpu_torch.scheduler.resource import (
    PEER_BACK_TO_SOURCE,
    PEER_RUNNING,
    PEER_SUCCEEDED,
    Peer,
)
from dragonfly2_tpu_torch.utils.dag import DAGError

logger = logging.getLogger(__name__)


def usable_cpu_count() -> int:
    """CPUs this process may actually run on: the scheduling affinity mask
    when the platform exposes one (cgroup-pinned containers report the real
    grant here while os.cpu_count() reports the machine), else
    os.cpu_count(). Sizes the dispatcher's worker pool."""
    try:
        return len(os.sched_getaffinity(0)) or (os.cpu_count() or 1)
    except (AttributeError, OSError):  # non-Linux / restricted platforms
        return os.cpu_count() or 1


@dataclass
class SchedulingConfig:
    """Reference defaults (scheduler/config/constants.go:36-79)."""

    candidate_parent_limit: int = 4
    filter_parent_limit: int = 40
    retry_limit: int = 10
    retry_back_to_source_limit: int = 5
    retry_interval: float = 0.05
    max_tree_depth: int = 4
    # Round-dispatcher worker threads sharding concurrent scheduling calls
    # across cores (0 = serial: every round runs on the event loop, scoring
    # coalesced by the micro-batcher). Workers overlap
    # the GIL-releasing legs (native FFI scoring via per-thread handles,
    # numpy feature assembly); the mutating apply step stays serialized
    # under the scheduler state lock either way.
    dispatch_workers: int = 0
    # Native round driver: "auto" lets DISPATCHED batches ride
    # df_round_drive when the evaluator serves an eligible native bundle
    # (each round degrades to the bit-identical serial leg otherwise);
    # "native" additionally routes the serial (no-dispatcher) async path
    # through one-round driver batches — the swarm simulator's shape;
    # "serial" pins the Python loop everywhere (the equivalence
    # A/B leg). The serial DEFAULT path (no dispatcher, "auto")
    # is byte-for-byte unchanged.
    round_driver: str = "auto"


@dataclass
class ScheduleOutcome:
    """One scheduling decision for a child peer."""

    parents: list[Peer] = field(default_factory=list)
    back_to_source: bool = False
    rounds: int = 0


class _RoundArena:
    """Reusable flat buffers for the native round driver — ONE per calling
    thread (dispatcher workers each own theirs; see Scheduling._arena), so a
    drive call's inputs/outputs can never be overwritten by a concurrent
    batch. Grow-only: steady-state batches allocate nothing.

    Layout is exactly df_round_drive's arena contract (native/scorer.cc):
    survivor rows are packed flat across the batch's rounds with an offsets
    fence, filter fields snapshotted under the state lock ride an int32
    [T,4] block, and the round-constant feature scalars go in a [M,3] side
    array the driver broadcasts into columns 10/11/13.
    """

    __slots__ = (
        "rows_cap", "rounds_cap", "k", "feats", "filt", "parent_idx",
        "out_scores", "offsets", "child_idx", "round_cols", "sel", "n_sel",
        "status", "binding", "task_slot", "child_slot", "child_host",
        "blocked_off", "blocked", "blocked_cap", "mbinding",
    )

    def __init__(self):
        self.rows_cap = 0
        self.rounds_cap = 0
        self.k = -1
        self.blocked_cap = 0
        # cached ctypes pointer tuple for drive_rounds (bind_drive); buffers
        # only move on growth, so per-call re-marshalling would be pure waste
        self.binding = None
        # same contract for the mirror drive's pointer tuple (df_mirror_drive
        # binds descriptor + blocked + rng buffers on top of the shared ones)
        self.mbinding = None

    def ensure(self, rounds: int, rows: int, k: int) -> None:
        if rows > self.rows_cap:
            cap = max(rows, 2 * self.rows_cap, 1024)
            self.feats = np.zeros((cap, FEATURE_DIM), np.float32)
            self.filt = np.zeros((cap, 4), np.int32)
            self.parent_idx = np.zeros(cap, np.int32)
            self.out_scores = np.zeros(cap, np.float32)
            self.rows_cap = cap
            self.binding = None
            self.mbinding = None
        if rounds > self.rounds_cap or k != self.k:
            rcap = max(rounds, 2 * self.rounds_cap, 64)
            self.offsets = np.zeros(rcap + 1, np.int32)
            self.child_idx = np.zeros(rcap, np.int32)
            self.round_cols = np.zeros((rcap, 3), np.float32)
            # row stride must equal k exactly (the driver writes sel[r*k+j])
            self.sel = np.zeros((rcap, max(k, 1)), np.int32)
            self.n_sel = np.zeros(rcap, np.int32)
            self.status = np.zeros(rcap, np.int32)
            # mirror-drive round descriptors (task/child/child-host slots +
            # the blocked fence) share the rounds capacity
            self.task_slot = np.zeros(rcap, np.int32)
            self.child_slot = np.zeros(rcap, np.int32)
            self.child_host = np.zeros(rcap, np.int32)
            self.blocked_off = np.zeros(rcap + 1, np.int32)
            self.rounds_cap = rcap
            self.k = k
            self.binding = None
            self.mbinding = None
        if self.blocked_cap == 0:
            self.blocked = np.zeros(256, np.int32)
            self.blocked_cap = 256
            self.mbinding = None

    def ensure_blocked(self, n: int) -> None:
        if n > self.blocked_cap:
            cap = max(n, 2 * self.blocked_cap, 256)
            self.blocked = np.zeros(cap, np.int32)
            self.blocked_cap = cap
            self.mbinding = None


class Scheduling:
    def __init__(self, evaluator: Evaluator, config: SchedulingConfig | None = None):
        self.evaluator = evaluator
        self.config = config or SchedulingConfig()
        self._rng = random.Random(0)
        # Own rng (not self._rng): backoff draws must not perturb the
        # candidate-sampling sequence, which tests pin by seed.
        self._backoff = BackoffPolicy(
            base=self.config.retry_interval,
            multiplier=2.0,
            max_delay=self.config.retry_interval * 16,
            jitter=0.3,
            rng=random.Random(0),
        )
        # Scheduler state lock (the dispatcher's "narrow lock"): serializes
        # [candidate sampling + filtering] on worker threads with every
        # control-plane MUTATION (piece-result apply, peer/host lifecycle,
        # probe ingest, edge commits — SchedulerService holds it around each
        # mutating block). Feature assembly and scoring run OUTSIDE it on
        # version-keyed atomic snapshots. RLock: service mutators nest
        # (report_peer_result → delete_parents) and the SMALL-scope path
        # filters inside an already-locked register. With no dispatcher
        # attached everything runs on the event loop and the uncontended
        # acquire is noise (~100 ns).
        self.state_lock = threading.RLock()
        # per-thread native-driver arenas (dispatcher workers snapshot/drive
        # concurrently; each thread's buffers are private and reused)
        self._arena_local = threading.local()
        # instance-local twin of NATIVE_ROUNDS_TOTAL (the global family mixes
        # every service in the process; A/B runs need THIS scheduler's)
        self.native_rounds_served = 0
        # Native mirrored peer table: set by MirrorClient wiring
        # (SchedulerService.enable_native_mirror). When ready, dispatched
        # batches sample/filter/score against the C-side mirror and Python
        # only enqueues round descriptors + commits parents.
        self._mirror = None
        self.mirror_rounds_served = 0
        self.mirror_stale_rounds = 0
        # The candidate-sampling rng stream has ONE authority at a time:
        # `_rng` (Python truth) or the 625-word MT buffer the native drive
        # advances in place. `_rng_ahead` says the buffer is ahead; any
        # serial draw first folds it back (_rng_serial). Steady-state native
        # batches therefore marshal NOTHING per drive — the getstate/setstate
        # round-trip (~40 µs) happens only when the serving shape flips.
        self._rng_lock = threading.Lock()
        self._rng_buf = (ctypes.c_uint32 * 625)()
        self._rng_ahead = False
        # per-stage wall-clock accumulators (ns) for dfstress's round-loop
        # attribution: snapshot/delta-apply leg, the native drive itself, and
        # the event-loop commit block (satellite: stage decomposition)
        self.stage_snapshot_ns = 0
        self.stage_drive_ns = 0
        self.stage_commit_ns = 0
        self.dispatcher: RoundDispatcher | None = None
        if self.config.dispatch_workers > 0:
            self.attach_dispatcher(self.config.dispatch_workers)

    def attach_dispatcher(self, workers: int | None = None) -> "RoundDispatcher":
        """Enable sharded rounds: schedule_candidate_parents' find leg runs
        on `workers` threads (default: the usable CPU count). Idempotent-ish:
        replaces any previous dispatcher (shutting it down)."""
        if self.dispatcher is not None:
            self.dispatcher.shutdown()
        self.dispatcher = RoundDispatcher(self, workers=workers)
        return self.dispatcher

    def close(self) -> None:
        if self.dispatcher is not None:
            self.dispatcher.shutdown()
            self.dispatcher = None

    # ---- filters (ref filterCandidateParents' 8 conditions) ----
    #
    # The reference builds a fresh closure per condition per call; an earlier
    # version kept that shape (`_filters` returned 8 closures) for the
    # SMALL-scope path while the NORMAL path inlined the checks. Both now
    # share ONE flattened predicate over a per-round context tuple: the
    # context (blocklist union, lineage walk) is computed once per scheduling
    # call, and each candidate costs one short-circuit boolean chain — no
    # closure list, no generator machinery (the `all(f(p) for f in filters)`
    # form measured ~60% of round cost in call overhead at 40 candidates).

    _OK_PARENT_STATES = (PEER_RUNNING, PEER_BACK_TO_SOURCE, PEER_SUCCEEDED)

    def _filter_ctx(self, child: Peer, blocklist: set[str]) -> tuple:
        """Per-round filter inputs: (child_id, child_host_id, block, lineage).
        One DAG lineage walk and one set union per scheduling call — hoisted
        out of the per-candidate pass."""
        try:
            lineage = child.task.dag.lineage(child.id)
        except DAGError:
            lineage = set()  # child not registered yet — nothing to exclude
        return child.id, child.host.id, set(blocklist) | child.block_parents, lineage

    def _passes(self, p: Peer, ctx: tuple) -> bool:
        """The 8 filter conditions, cheapest first, as one flattened pass.

        ONE permitted divergence from the reference's filter list: no
        per-candidate can_add_edge reachability walk — a p->child cycle
        requires p reachable FROM child, and every such p is in `lineage`
        (descendants), as is an existing parent (ancestors); the commit path
        re-validates via add_edge's CycleError for anything that changed
        during the scoring await. The SMALL-scope path re-adds the edge
        check explicitly (find_success_parent)."""
        child_id, child_host_id, block, lineage = ctx
        pid = p.id
        return not (
            pid == child_id
            or pid in block
            or pid in lineage
            or p.host.id == child_host_id
            or p.fsm.current not in self._OK_PARENT_STATES
            or p.host.free_upload_slots <= 0
            or p.depth() >= self.config.max_tree_depth
            or self.evaluator.is_bad_node(p)
        )

    def _rng_serial(self) -> random.Random:
        """The sampling rng for SERIAL draw sites: folds the native drive's
        in-place MT advancement back into `_rng` first, so serial and native
        rounds consume one coherent stream (bit-exact with an all-serial run
        when the interleaving is quiesced). Callers hold state_lock; the
        nested rng-lock acquisition is uncontended except across the
        serving-shape flip itself."""
        if self._rng_ahead:
            with self._rng_lock:
                if self._rng_ahead:
                    self._rng.setstate((3, tuple(self._rng_buf), None))
                    self._rng_ahead = False
        return self._rng

    def rng_state(self):
        """Current MT19937 state regardless of which side (Python rng or the
        native drive buffer) last advanced it."""
        return self._rng_serial().getstate()

    def set_rng_state(self, state) -> None:
        """Install an rng state, revoking the native buffer's authority —
        the raw `self._rng.setstate(...)` idiom silently loses the write
        when a mirror drive left `_rng_ahead` set."""
        with self._rng_lock:
            self._rng.setstate(state)
            self._rng_ahead = False

    def _sample_candidates(self, child: Peer, blocklist: set[str]) -> list[Peer]:
        """Sample ≤40 random DAG peers and keep those passing the flattened
        filter pass (one predicate call per candidate, context hoisted)."""
        task = child.task
        sample = task.dag.random_vertices(self.config.filter_parent_limit, self._rng_serial())
        ctx = self._filter_ctx(child, blocklist)
        passes = self._passes
        return [v.value for v in sample if passes(v.value, ctx)]

    def _top_parents(self, child: Peer, candidates: list[Peer], scores) -> list[Peer]:
        order = np.argsort(-np.asarray(scores), kind="stable")
        top = [candidates[i] for i in order[: self.config.candidate_parent_limit]]
        logger.debug(
            "schedule %s: %d candidates, top %s",
            child.id, len(candidates), [p.id for p in top],
        )
        return top

    def find_candidate_parents(
        self, child: Peer, blocklist: set[str] = frozenset()
    ) -> list[Peer]:
        """One filtering+scoring round: sample ≤40, filter, score, top-4.

        This IS the unit of work a dispatcher worker runs (_find_round_sync
        is an alias): sample+filter under the state lock — they read peer
        sets/deques that service mutators change — then feature assembly and
        scoring OUTSIDE the lock, where the FFI/numpy legs drop the GIL and
        overlap across workers. Serial callers run the identical code path,
        which is what makes the sharded/serial equivalence exact."""
        with self.state_lock:
            candidates = self._sample_candidates(child, blocklist)
        if not candidates:
            return []
        return self._top_parents(child, candidates, self.evaluator.evaluate(child, candidates))

    def find_candidate_parents_batch(
        self, reqs: list[tuple[Peer, set[str]]]
    ) -> list[list[Peer]]:
        """A batch of find rounds in one call — the dispatcher's worker-side
        unit. Sampling+filtering lock per round (short holds, so the event
        loop's mutators interleave); every round with surviving candidates
        then rides ONE evaluator batch (MLEvaluator.evaluate_many = one FFI
        crossing per batch). Equivalent to calling find_candidate_parents
        per round in order — same rng draws, same filters, same scores."""
        sampled = []
        for child, blocklist in reqs:
            with self.state_lock:
                sampled.append((child, self._sample_candidates(child, blocklist)))
        outs: list[list[Peer]] = [[] for _ in reqs]
        scorable = [i for i, (_c, cands) in enumerate(sampled) if cands]
        if scorable:
            scores = self.evaluator.evaluate_many(
                [(sampled[i][0], sampled[i][1]) for i in scorable]
            )
            for i, s in zip(scorable, scores):
                child, cands = sampled[i]
                outs[i] = self._top_parents(child, cands, s)
        return outs

    # state-code export for the driver's filter re-validation: any state
    # outside _OK_PARENT_STATES maps to -1 (ineligible); the dict get is
    # semantically identical to `fsm.current not in _OK_PARENT_STATES`
    _STATE_CODES = {s: i for i, s in enumerate(_OK_PARENT_STATES)}

    def _arena(self) -> _RoundArena:
        a = getattr(self._arena_local, "arena", None)
        if a is None:
            a = self._arena_local.arena = _RoundArena()
        return a

    def _find_batch_entry(self):
        """The dispatcher's worker-side find runner: the native round driver
        unless the config pins the serial Python leg."""
        if self.config.round_driver == "serial":
            return self.find_candidate_parents_batch
        return self.find_candidate_parents_batch_native

    def _find_batch_mirror(
        self, reqs: list[tuple[Peer, set[str]]], bundle, mirror
    ) -> list[list[Peer]] | None:
        """A batch of find rounds against the native mirrored peer table:
        Python's per-round work shrinks to an O(1) descriptor
        (task/child/child-host slots, blocked-peer slots, the three
        round-constant feature scalars) — the sample draw, the 8-condition
        filter, the feature-row gather, scoring, and stable top-k all run
        inside ONE df_mirror_drive call with the GIL released, against state
        the mutation hooks keep incrementally synced. No state-lock hold, no
        peer-pool walk, no snapshot copy.

        Bit-exactness: the C side reproduces `rng.sample`'s draw sequence on
        the same MT19937 stream (`_rng`'s state lives in the shared 625-word
        buffer between drives), the mirror's vlist is DAG insertion order,
        and cached rows carry the same 5-version keys `_export_pair_rows`
        computes — a stale row flips its round to the UNCHANGED evaluate_many
        leg (identical scores, records, shadow sampling) and the refreshed
        rows make the next drive native. Returns None when the batch cannot
        ride the mirror (pre-drive miss, poisoned client, driver error); the
        caller falls back to the snapshot leg, counted by reason."""
        from dragonfly2_tpu_torch.scheduler import metrics

        cfg = self.config
        ev = self.evaluator
        k = cfg.candidate_parent_limit
        sample_n = cfg.filter_parent_limit
        max_depth = cfg.max_tree_depth
        M = len(reqs)
        t_snap0 = time.perf_counter_ns()
        arena = self._arena()
        arena.ensure(M, M * sample_n, k)
        task_slot = arena.task_slot
        child_slot = arena.child_slot
        child_host = arena.child_host
        blocked_off = arena.blocked_off
        round_cols = arena.round_cols
        peer_slot = mirror.peer_slot
        blocked_list: list[int] = []
        for r, (child, blocklist) in enumerate(reqs):
            cs = child._mirror_slot
            ts = child.task._mirror_slot
            hs = child.host._mirror_slot
            if cs < 0 or ts < 0 or hs < 0:
                # an unmirrored object would consume no native rng for its
                # round, reordering the stream vs the serial leg — bail on
                # the WHOLE batch pre-drive so the fallback stays bit-exact
                metrics.NATIVE_MIRROR_FALLBACK_TOTAL.inc(
                    float(M), reason="mirror_miss"
                )
                return None
            child_slot[r] = cs
            task_slot[r] = ts
            child_host[r] = hs
            round_cols[r] = _round_col_values(child)
            blocked_off[r] = len(blocked_list)
            for pid in blocklist | child.block_parents:
                s = peer_slot(pid)
                if s >= 0:  # unmirrored ids cannot be drawn natively anyway
                    blocked_list.append(s)
        blocked_off[M] = len(blocked_list)
        arena.ensure_blocked(len(blocked_list))
        if blocked_list:
            arena.blocked[: len(blocked_list)] = blocked_list
        self.stage_snapshot_ns += time.perf_counter_ns() - t_snap0

        status = arena.status
        t_drv0 = time.perf_counter_ns()
        bundle.begin()
        try:
            scorer = bundle.thread_scorer()
            # drives serialize on the rng lock: there is ONE sampling stream,
            # and holding it across sync_bundle + drive also guarantees a
            # concurrent hot-swap can never mix two bundles' node indices
            # inside one batch
            with self._rng_lock:
                if not mirror.sync_bundle(bundle):
                    return None  # poisoned mid-sync (counted)
                mb = arena.mbinding
                if mb is None:
                    mb = arena.mbinding = mirror.native.bind_drive(
                        arena.task_slot, arena.child_slot, arena.child_host,
                        arena.blocked_off, arena.blocked, arena.round_cols,
                        self._rng_buf, arena.offsets, arena.parent_idx,
                        arena.feats, arena.out_scores, arena.sel,
                        arena.n_sel, arena.status,
                    )
                if not self._rng_ahead:
                    self._rng_buf[:] = self._rng.getstate()[1]
                    self._rng_ahead = True
                try:
                    mirror.native.drive_bound(
                        scorer, mb, rounds=M, sample_n=sample_n, k=k,
                        max_depth=max_depth, row_cap=arena.rows_cap,
                    )
                except Exception:
                    # the C side validates arguments BEFORE any rng draw, so
                    # a rejected batch leaves the stream untouched and the
                    # snapshot leg replays it bit-exactly
                    logger.exception(
                        "native mirror drive failed; batch re-runs on the "
                        "snapshot leg"
                    )
                    metrics.NATIVE_MIRROR_FALLBACK_TOTAL.inc(
                        float(M), reason="driver_error"
                    )
                    return None
        finally:
            bundle.end()
        self.stage_drive_ns += time.perf_counter_ns() - t_drv0

        t_out0 = time.perf_counter_ns()
        sel = arena.sel
        n_sel = arena.n_sel
        offsets = arena.offsets
        cand_slots = arena.parent_idx
        out_scores = arena.out_scores
        feats = arena.feats
        peer_by_slot = mirror.peer_by_slot
        outs: list[list[Peer]] = [[] for _ in reqs]
        native_items = []
        native_count = 0
        stale_rounds: list[tuple[int, list[Peer]]] = []  # status 2: push rows
        serial_rounds: list[tuple[int, list[Peer]]] = []  # status 1: no push
        miss_rounds: list[int] = []  # status 3: full serial re-run
        dropped = 0
        rounds_cands: list[tuple[list, bool]] = []
        with self.state_lock:
            # one lock hold maps every survivor slot back to its Peer; a
            # slot whose peer was deleted (and possibly recycled) mid-drive
            # is dropped here — commit re-validation bounds anything that
            # slips through the tiny drive→map window
            for r in range(M):
                lo, hi = int(offsets[r]), int(offsets[r + 1])
                cands: list = []
                holes = False
                for j in range(lo, hi):
                    s = int(cand_slots[j])
                    p = peer_by_slot(s)
                    if p is None or p._mirror_slot != s:
                        cands.append(None)
                        holes = True
                        dropped += 1
                    else:
                        cands.append(p)
                rounds_cands.append((cands, holes))
        for r in range(M):
            st = int(status[r])
            cands, holes = rounds_cands[r]
            if st == 3:
                miss_rounds.append(r)
                continue
            if not cands:
                continue  # sampled empty: outs[r] stays [] (serial-identical)
            if st == 0:
                sel_r = sel[r]
                chosen = [cands[sel_r[j]] for j in range(int(n_sel[r]))]
                outs[r] = [p for p in chosen if p is not None]
                native_count += 1
                if not holes:
                    lo, hi = int(offsets[r]), int(offsets[r + 1])
                    native_items.append(
                        (reqs[r][0], cands, feats[lo:hi], out_scores[lo:hi])
                    )
            else:
                live = [p for p in cands if p is not None]
                if not live:
                    continue
                if st == 2:
                    stale_rounds.append((r, live))
                else:
                    serial_rounds.append((r, live))
        if miss_rounds:
            # a mirrored object vanished between the pre-check and its round
            # (concurrent delete): the native drive drew no rng for it, so
            # the full serial find replays it — the stream reorders across
            # the batch boundary, which only a quiesced equivalence run
            # could observe (and there this path cannot trigger)
            metrics.NATIVE_MIRROR_FALLBACK_TOTAL.inc(
                float(len(miss_rounds)), reason="mirror_miss"
            )
            fb = self.find_candidate_parents_batch(
                [reqs[r] for r in miss_rounds]
            )
            for r, o in zip(miss_rounds, fb):
                outs[r] = o
        score_list = sorted(stale_rounds + serial_rounds)
        if score_list:
            # stale/unknown-child rounds score on the UNCHANGED serial leg —
            # same survivors the drive produced, same scores, records,
            # shadow sampling and fallback taxonomy as evaluate_many always
            scores = ev.evaluate_many(
                [(reqs[r][0], cands) for r, cands in score_list]
            )
            for (r, cands), s in zip(score_list, scores):
                outs[r] = self._top_parents(reqs[r][0], cands, s)
        if stale_rounds and ev.feature_builder is build_pair_features:
            # refresh the mirror's rows from the Python cache the serial
            # scoring just (re)built: the next drive on unchanged versions
            # goes fully native — O(changed entries), never a full re-export.
            # A NON-default feature builder (the sim's uncached override, a
            # rowwise A/B) must never seed the native cache: a later
            # native round would score default-builder rows where the serial
            # leg would call the override — so those deployments stay on the
            # stale leg (native sample/filter, serial scoring) by design.
            for r, cands in stale_rounds:
                mirror.push_round_rows(reqs[r][0], cands)
        self.stage_snapshot_ns += time.perf_counter_ns() - t_out0
        if native_count:
            metrics.NATIVE_ROUNDS_TOTAL.inc(float(native_count))
            metrics.NATIVE_MIRROR_ROUNDS_TOTAL.inc(float(native_count))
            self.native_rounds_served += native_count
            self.mirror_rounds_served += native_count
        if stale_rounds:
            metrics.NATIVE_MIRROR_STALE_ROUNDS_TOTAL.inc(float(len(stale_rounds)))
            self.mirror_stale_rounds += len(stale_rounds)
        if dropped:
            metrics.NATIVE_MIRROR_FALLBACK_TOTAL.inc(
                float(dropped), reason="slot_race"
            )
        if native_items:
            # observability tail: drift folds, mode-honest sampled decision
            # records (copy-on-record — these are arena views), batched shadow
            ev.finish_native_rounds(native_items, bundle)
        return outs

    def find_candidate_parents_batch_native(
        self, reqs: list[tuple[Peer, set[str]]]
    ) -> list[list[Peer]]:
        """A batch of find rounds through the native round driver: Python
        does exactly two jobs — snapshot candidates into the flat arena
        under the state lock (same rng draws, same inline filter conditions
        as `_passes`), and hand back per-round Peer lists for the caller to
        commit under the state lock. Everything between (filter
        re-validation, round-constant feature columns, scoring, stable
        top-k) is ONE df_round_drive FFI call with the GIL released.

        Bit-identical to `find_candidate_parents_batch`: survivor sets come
        from the same predicate over the same sampled vertices; feature
        rows come from the same version-keyed cache (`_export_pair_rows`)
        with the same float32 round-constant scalars; the driver's per-row
        scoring math and stable top-k equal the serial scorer + numpy
        argsort (pinned by tests); and any round the driver cannot score
        (unknown host, stale artifact, degradation rung, driver error)
        re-runs on the UNCHANGED evaluate_many leg — including its
        partial-known base-score merges and fallback metrics."""
        from dragonfly2_tpu_torch.scheduler import metrics

        ev = self.evaluator
        bundle = ev.native_round_entry()
        if bundle is None:
            # no eligible native bundle (base evaluator, torch engine, not
            # ready, or brownout rung 3) — the whole batch is the serial leg
            metrics.NATIVE_ROUND_FALLBACK_TOTAL.inc(len(reqs), reason="no_native")
            return self.find_candidate_parents_batch(reqs)
        mirror = self._mirror
        if mirror is not None:
            if mirror.ready:
                out = self._find_batch_mirror(reqs, bundle, mirror)
                if out is not None:
                    return out
                # mirror refused the batch (pre-drive miss, driver error) —
                # fall through to the snapshot-under-lock leg below; the
                # refusal was counted with its reason
            elif mirror.poisoned:
                # a poisoned mirror is never silent: every batch that would
                # have ridden it counts its Python fallback until re-attach
                metrics.NATIVE_MIRROR_FALLBACK_TOTAL.inc(
                    float(len(reqs)), reason="poisoned"
                )
        cfg = self.config
        node_index = bundle.node_index
        k = cfg.candidate_parent_limit
        max_depth = cfg.max_tree_depth
        state_codes = self._STATE_CODES
        is_bad = ev.is_bad_node
        M = len(reqs)
        arena = self._arena()
        arena.ensure(M, M * cfg.filter_parent_limit, k)
        offsets = arena.offsets
        filt = arena.filt
        parent_idx = arena.parent_idx
        child_idx = arena.child_idx
        round_cols = arena.round_cols
        feats = arena.feats
        # the sim's uncached-assembly override (and a rowwise A/B)
        # must be honored: a non-default builder assembles the round's matrix
        # itself and we copy its rows into the arena
        default_builder = ev.feature_builder is build_pair_features

        cands_per_round: list[list[Peer]] = []
        t = 0
        offsets[0] = 0
        t_snap0 = time.perf_counter_ns()
        for r, (child, blocklist) in enumerate(reqs):
            with self.state_lock:
                # identical rng consumption and filter semantics to
                # _sample_candidates/_passes, with the driver's re-validated
                # fields (state code, free slots, depth) snapshotted in the
                # same pass — same lock scope as the serial leg
                sample = child.task.dag.random_vertices(
                    cfg.filter_parent_limit, self._rng_serial()
                )
                child_id, child_host_id, block, lineage = self._filter_ctx(
                    child, blocklist
                )
                cands: list[Peer] = []
                # survivor fields accumulate as plain ints under the lock and
                # land in the arena as ONE bulk assignment per round — per-
                # element numpy scalar stores cost ~100 ns each, a real tax
                # at 4+1 stores per candidate on the hot path
                quads: list[int] = []
                pidx: list[int] = []
                for v in sample:
                    p = v.value
                    pid = p.id
                    if pid == child_id or pid in block or pid in lineage:
                        continue
                    h = p.host
                    if h.id == child_host_id:
                        continue
                    sc = state_codes.get(p.fsm.current, -1)
                    if sc < 0:
                        continue
                    slots = h.free_upload_slots
                    if slots <= 0:
                        continue
                    d = p.depth()
                    if d >= max_depth:
                        continue
                    if is_bad(p):
                        continue
                    quads += (0, sc, slots, d)
                    pidx.append(node_index.get(h.id, -1))
                    cands.append(p)
            cands_per_round.append(cands)
            n = len(cands)
            if n:
                t0, t = t, t + n
                filt[t0:t] = np.asarray(quads, dtype=np.int32).reshape(n, 4)
                parent_idx[t0:t] = pidx
                child_idx[r] = node_index.get(child.host.id, -1)
                round_cols[r] = _round_col_values(child)
                rows = feats[t0:t]
                if default_builder:
                    # version-cached rows written straight into the arena —
                    # no intermediate matrix, no np.stack
                    _export_pair_rows(child, cands, ev.topology, ev.bandwidth, rows)
                else:
                    rows[:] = ev.feature_builder(
                        child, cands, ev.topology, ev.bandwidth
                    )
            offsets[r + 1] = t
        self.stage_snapshot_ns += time.perf_counter_ns() - t_snap0

        status = arena.status
        driver_failed = False
        t_drv0 = time.perf_counter_ns()
        if t > 0:
            bundle.begin()
            try:
                scorer = bundle.thread_scorer()
                try:
                    binding = arena.binding
                    if binding is None:
                        binding = arena.binding = scorer.bind_drive(
                            offsets, child_idx, parent_idx, feats, round_cols,
                            filt, arena.out_scores, arena.sel, arena.n_sel,
                            status,
                        )
                    scorer.drive_rounds_bound(
                        binding, rounds=M, k=k, max_depth=max_depth
                    )
                except Exception:
                    logger.exception(
                        "native round driver failed; batch re-runs on the serial leg"
                    )
                    status[:M] = 1
                    driver_failed = True
                    metrics.NATIVE_ROUND_FALLBACK_TOTAL.inc(
                        float(M), reason="driver_error"
                    )
            finally:
                bundle.end()
        else:
            status[:M] = 0  # every round sampled empty — nothing to score
        self.stage_drive_ns += time.perf_counter_ns() - t_drv0

        outs: list[list[Peer]] = [[] for _ in reqs]
        native_items = []
        fb_rounds: list[int] = []
        sel = arena.sel
        n_sel = arena.n_sel
        out_scores = arena.out_scores
        for r in range(M):
            cands = cands_per_round[r]
            if not cands:
                continue  # empty round: outs[r] stays [] (serial-identical)
            if status[r] != 0:
                fb_rounds.append(r)
                continue
            sel_r = sel[r]
            outs[r] = [cands[sel_r[j]] for j in range(n_sel[r])]
            t0, t1 = int(offsets[r]), int(offsets[r + 1])
            native_items.append(
                (reqs[r][0], cands, feats[t0:t1], out_scores[t0:t1])
            )
        if fb_rounds:
            # rounds the driver refused re-run on the bit-identical serial
            # leg (evaluate_many keeps its fallback taxonomy + records)
            if not driver_failed:
                metrics.NATIVE_ROUND_FALLBACK_TOTAL.inc(
                    float(len(fb_rounds)), reason="unknown_hosts"
                )
            scores = ev.evaluate_many(
                [(reqs[r][0], cands_per_round[r]) for r in fb_rounds]
            )
            for r, s in zip(fb_rounds, scores):
                outs[r] = self._top_parents(reqs[r][0], cands_per_round[r], s)
        if native_items:
            metrics.NATIVE_ROUNDS_TOTAL.inc(float(len(native_items)))
            self.native_rounds_served += len(native_items)
            # observability tail: drift folds, mode-honest sampled decision
            # records (copy-on-record — these are arena views), batched shadow
            ev.finish_native_rounds(native_items, bundle)
        return outs

    async def find_candidate_parents_async(
        self, child: Peer, blocklist: set[str] = frozenset()
    ) -> list[Peer]:
        """Async variant of find_candidate_parents: scoring awaits the
        evaluator's async entry, so concurrent scheduling rounds coalesce in
        the native scorer's micro-batcher instead of crossing the FFI one by
        one (MLEvaluator.evaluate_async). The serial counterpart of the
        dispatcher path — used when no dispatcher is attached."""
        # serial-vs-dispatched is a first-class span attribute: the trace
        # itself answers which serving shape a round took
        with default_tracer().span("scheduler.round", dispatched=False) as sp:
            if self.config.round_driver == "native":
                # explicit native mode without a dispatcher (the swarm
                # simulator's single-threaded loop): each round is a
                # one-round driver batch — snapshot + one FFI + commit-ready
                # parents, no micro-batcher, no evaluate_many padding
                out = self.find_candidate_parents_batch_native([(child, blocklist)])[0]
                if sp.sampled:
                    sp.set_attr("candidates", len(out))
                    sp.set_attr("native_driver", True)
                return out
            with self.state_lock:
                candidates = self._sample_candidates(child, blocklist)
            if not candidates:
                return []
            if sp.sampled:
                sp.set_attr("candidates", len(candidates))
            scores = await self.evaluator.evaluate_async(child, candidates)
            return self._top_parents(child, candidates, scores)

    def find_success_parent(self, child: Peer, blocklist: set[str] = frozenset()) -> Peer | None:
        """SMALL-scope path: a single finished parent (ref FindSuccessParent).
        Shares the flattened predicate with the NORMAL path plus the explicit
        can_add_edge check the sampler omits (see _passes)."""
        task = child.task
        with self.state_lock:  # filter reads racing worker-visible mutations
            ctx = self._filter_ctx(child, set(blocklist))
            done = [
                p
                for p in task.peers()
                if p.fsm.is_(PEER_SUCCEEDED)
                and self._passes(p, ctx)
                and task.can_add_edge(p.id, child.id)
            ]
        if not done:
            return None
        scores = np.asarray(self.evaluator.evaluate(child, done))
        return done[int(np.argmax(scores))]

    async def schedule_candidate_parents(
        self, child: Peer, blocklist: set[str] = frozenset()
    ) -> ScheduleOutcome:
        """Retry loop with back-to-source escalation (ref scheduling.go:81-153)."""
        cfg = self.config
        for attempt in range(cfg.retry_limit):
            if child.fsm.is_(PEER_BACK_TO_SOURCE):
                return ScheduleOutcome(back_to_source=True, rounds=attempt)
            if attempt >= cfg.retry_back_to_source_limit and child.task.can_back_to_source():
                child.fsm.fire("back_to_source")
                return ScheduleOutcome(back_to_source=True, rounds=attempt)
            if self.dispatcher is not None:
                parents = await self.dispatcher.find(child, blocklist)
            else:
                parents = await self.find_candidate_parents_async(child, blocklist)
            if parents:
                # The await above suspended between filtering and commit, so a
                # concurrent round may have consumed upload slots or added
                # edges that invalidate these candidates (the coalescing and
                # dispatcher paths both make this overlap the COMMON case).
                # Re-validate at commit: stale candidates are skipped, a
                # CycleError round retries. The whole apply is one state-lock
                # critical section — a dispatcher worker mid-filter sees
                # either none or all of this round's edges, never half.
                task = child.task
                committed = []
                t_commit0 = time.perf_counter_ns()
                with self.state_lock:
                    task.delete_parents(child.id)
                    for p in parents:
                        if p.host.free_upload_slots <= 0:
                            continue
                        try:
                            task.add_edge(p.id, child.id)
                        except DAGError:
                            continue  # raced into a cycle/duplicate; skip
                        committed.append(p)
                self.stage_commit_ns += time.perf_counter_ns() - t_commit0
                if committed:
                    child.schedule_rounds += 1
                    return ScheduleOutcome(parents=committed, rounds=attempt + 1)
            await self._backoff.sleep(attempt)
        # retries exhausted: last resort is back-to-source, else failure
        if child.task.can_back_to_source():
            child.fsm.fire("back_to_source")
            return ScheduleOutcome(back_to_source=True, rounds=cfg.retry_limit)
        return ScheduleOutcome(rounds=cfg.retry_limit)


class RoundDispatcher:
    """Thread-pool round dispatcher: shards concurrent scheduling rounds
    across cores.

    The single-loop serving path tops out at the single-core Python
    ceiling: every round's feature assembly and glue runs on
    the event loop, so adding cores adds nothing. Podracer (arxiv 2104.06272)
    makes the same move decoupling a sequential control loop into sharded
    workers that keep the accelerator-side scoring saturated — here each
    worker thread runs whole find rounds (sample → filter → assemble →
    score → top-k):

      - sample+filter hold Scheduling.state_lock (they read peer sets/
        deques the service mutates), a few tens of µs per round;
      - feature assembly + scoring run lock-free — ctypes FFI calls release
        the GIL outright (per-thread native handles via ScorerHandlePool; a
        shared handle would re-serialize on scorer.cc's internal mutex), so
        one worker's GEMMs run under another worker's Python;
      - the mutating apply (DAG edges, peer state, metrics) never runs
        here: schedule_candidate_parents commits on the event loop under
        the same state lock, keeping scheduling semantics bit-identical to
        the serial path (pinned by tests/test_dispatch.py equivalence).

    Dispatch granularity is a BATCH, not a round: a per-round
    run_in_executor hop costs two thread wakeups + a loop callback, which
    measured ~40% of the round at these rates (the same lesson as
    per-chunk executor hops — bind workers to WORK, not to items). Rounds
    queue on the loop; each free worker takes the whole backlog up to
    queue_cap (1 under no load — no latency floor; growing with arrival
    rate under load, exactly the micro-batcher's self-adjusting shape) and
    resolves each round's future via call_soon_threadsafe as it finishes.
    Queue/slot state is mutated ONLY on the event loop.

    Worker threads are created once and live with the dispatcher — never
    per round (dflint DF026 exists to keep it that way).
    """

    def __init__(
        self, scheduling: Scheduling, *, workers: int | None = None,
        queue_cap: int = 32,
    ):
        from dragonfly2_tpu_torch.scheduler import metrics

        self.scheduling = scheduling
        self.workers = workers if workers and workers > 0 else usable_cpu_count()
        self.queue_cap = queue_cap
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="df-round"
        )
        self._pending: list[tuple] = []  # (kind, args, future) — loop-owned
        # submitted-but-maybe-not-started batches, keyed by their executor
        # future: shutdown(cancel_futures=True) silently cancels QUEUED work
        # items, and a cancelled _run_batch never resolves its rounds'
        # asyncio futures — without this map those awaits would hang forever
        self._inflight: dict = {}
        self._free = self.workers
        self._closed = False
        self.rounds = 0  # rounds dispatched (observability)
        self.batches = 0  # worker submissions (rounds/batches = amortization)
        metrics.DISPATCH_WORKERS.set(float(self.workers))

    _KIND_FIND = 0
    _KIND_EVAL = 1

    @property
    def busy(self) -> int:
        """Workers currently running a batch (loop-owned state; the
        loop-health monitor samples this into the utilization histogram)."""
        return self.workers - self._free

    async def find(self, child: Peer, blocklist: set[str] = frozenset()) -> list[Peer]:
        """One find round on a worker thread; returns the top candidates
        (uncommitted — the caller commits on the loop)."""
        from dragonfly2_tpu_torch.scheduler import metrics

        metrics.DISPATCHED_ROUNDS_TOTAL.inc()
        # span attrs answer the dispatcher questions a timeline needs:
        # how long the round queued before a worker took it, which worker
        # ran it, and how many rounds amortized that worker wakeup
        with default_tracer().span("scheduler.round", dispatched=True) as sp:
            meta = {"enq": time.perf_counter()} if sp.sampled else None
            out = await self._submit(self._KIND_FIND, (child, blocklist), meta)
            if meta is not None and "start" in meta:
                sp.set_attr(
                    "queue_wait_ms", round((meta["start"] - meta["enq"]) * 1e3, 3)
                )
                sp.set_attr("worker", meta.get("worker", ""))
                sp.set_attr("batch_size", meta.get("batch", 0))
            return out

    async def evaluate(self, child: Peer, parents: list[Peer]):
        """Score a fixed candidate set on a worker thread (the
        eval-leg probe — same assembly+FFI path find() runs, minus the
        sample/filter leg)."""
        return await self._submit(self._KIND_EVAL, (child, parents))

    def _submit(self, kind, args, meta: dict | None = None) -> "asyncio.Future":
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if self._closed:
            fut.set_exception(RuntimeError("round dispatcher is shut down"))
            return fut
        self.rounds += 1
        self._pending.append((kind, args, fut, meta))
        self._maybe_dispatch(loop)
        return fut

    def _maybe_dispatch(self, loop) -> None:
        while self._free > 0 and self._pending:
            # Split the backlog relative to the TOTAL worker count: dividing
            # by the currently-free count hands the whole queue to whichever
            # worker frees first (workers free one at a time), re-serializing
            # the very rounds the pool exists to overlap. ceil(pending/workers)
            # leaves proportionate shares for the workers about to free.
            n = -(-len(self._pending) // self.workers)
            batch = self._pending[: min(n, self.queue_cap)]
            del self._pending[: len(batch)]
            self._free -= 1
            self.batches += 1
            cf = self._pool.submit(self._run_batch, loop, batch)
            self._inflight[cf] = batch
            cf.add_done_callback(lambda f: self._inflight.pop(f, None))

    def _run_batch(self, loop, batch) -> None:
        """Worker-side: run the batch's find/eval jobs grouped per kind (the
        find group shares one evaluator FFI crossing, see
        find_candidate_parents_batch), then resolve every future and free
        the worker slot in ONE loop callback — per-round
        call_soon_threadsafe wakeups measured ~40% of a dispatched round."""
        # stamp trace metadata before running: queue-wait is measured to the
        # moment a worker picked the batch up, not to its first round
        t_start = time.perf_counter()
        worker = threading.current_thread().name
        for _k, _a, _f, meta in batch:
            if meta is not None:
                meta["start"] = t_start
                meta["worker"] = worker
                meta["batch"] = len(batch)
        out: list = [None] * len(batch)
        errs: list = [None] * len(batch)
        for kind, runner in (
            # config-selected find leg: the native round driver ("auto"/
            # "native", with per-round serial fallback inside) or the pinned
            # serial Python loop ("serial" — the equivalence A/B leg)
            (self._KIND_FIND, self.scheduling._find_batch_entry()),
            (self._KIND_EVAL, self.scheduling.evaluator.evaluate_many),
        ):
            group = [(i, args) for i, (k, args, _f, _m) in enumerate(batch) if k == kind]
            if not group:
                continue
            try:
                results = runner([args for _i, args in group])
                for (i, _args), r in zip(group, results):
                    out[i] = r
            except BaseException as e:  # noqa: BLE001 — delivered to the awaiting rounds
                for i, _args in group:
                    errs[i] = e
        loop.call_soon_threadsafe(
            self._finish_batch, loop,
            [(fut, out[i], errs[i]) for i, (_k, _a, fut, _m) in enumerate(batch)],
        )

    def _finish_batch(self, loop, triples) -> None:
        for fut, result, err in triples:
            if fut.cancelled():
                continue
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(result)
        self._free += 1
        if not self._closed:
            self._maybe_dispatch(loop)

    def shutdown(self) -> None:
        """Tear down the worker pool. Must run on the event-loop thread
        (every call site does — service.close, attach_dispatcher): it cancels the asyncio futures of rounds that will never
        run, which is only legal loop-side."""
        self._closed = True
        for _kind, _args, fut, _meta in self._pending:
            if not fut.done():
                fut.cancel()
        self._pending.clear()
        # snapshot BEFORE shutdown: cancel_futures fires the executor
        # futures' done callbacks inline, which pops _inflight
        inflight = list(self._inflight.items())
        # cancel_futures: queued (never-started) batches are dropped by the
        # executor (3.9+ kwarg; this image is 3.10) — their rounds' asyncio
        # futures are cancelled below so no await strands; batches already
        # RUNNING complete and resolve their rounds via the loop callback.
        self._pool.shutdown(wait=False, cancel_futures=True)
        for cf, batch in inflight:
            if cf.cancelled():
                for _kind, _args, fut, _meta in batch:
                    if not fut.done():
                        fut.cancel()
