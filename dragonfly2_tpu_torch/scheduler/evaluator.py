"""Pluggable parent evaluator with a *batched* scoring API: the port of
dragonfly2_tpu/scheduler/evaluator.py, whole.

A reference scheduler loads it through its evaluator plugin slot:

    python -m dragonfly2_tpu.scheduler.server \
        --evaluator plugin:dragonfly2_tpu_torch.scheduler.evaluator:MLEvaluator

The reference's ``load_object`` calls ``MLEvaluator`` with no arguments, which
gives an ml evaluator in base-fallback mode until its ManagerLink calls
``attach_scorer``, exactly as ``new_evaluator("ml")`` does. It serves the
port's scorers (the native C++ scorer, engine "native", or ``GNNScorer``,
engine "torch") and labels them honestly in ``ML_SERVING_MODE``
(native | torch | jax | base, the port's registry: scheduler/metrics.py).
A reference scheduler's own ManagerLink loads through the reference's
loader, which hands over the C++ scorer or, where that is not active, the
reference's JAX ``GNNScorer``: that serves as ``jax``, with a warning that
the native scorer is not active. It serves ``torch`` only where the
ManagerLink loads through the port's loader
(``scheduler/manager_link.load_scorer_verified``).

Parity with reference scheduler/scheduling/evaluator/: `default` linear blend
(evaluator_base.go:31-49), statistical bad-node detection (3σ / 20×mean piece
cost outliers, evaluator_base.go:193-229), and the `ml` slot that was left as
`// TODO Implement MLAlgorithm` (evaluator.go:48) — implemented here via the
GNN scorer with base fallback.

The evaluator receives ALL candidates of a round at once and returns a
score vector — one vectorized numpy pass (base) or one scorer call (ml).

The feature build reads the reference scheduler's Peer, Host and Task by
duck typing and writes the same (version, row) tuples onto a peer as the
reference's evaluator does (``Peer._feat_row``, ``Peer._pair_rows``,
``Peer._bad_memo``), so a reference evaluator and this one in one process
share those caches harmlessly: both compute the same bytes for a version
(tests/test_torch_evaluator.py holds them bit-equal).
"""

from __future__ import annotations

import functools
import logging
import statistics
import threading
from collections import deque
from typing import Any, Sequence

import numpy as np

from dragonfly2_tpu_torch.models.features import (
    BASE_WEIGHTS,
    FEATURE_DIM,
    location_affinity,
)
from dragonfly2_tpu_torch.utils import clock as clockmod

# The scheduler's Peer, Host and Task are the reference's (the port has no
# resource pool of its own): every function here reads them by duck typing.
Peer = Any
# HostType is a str enum in the reference (resource.py); its SEED member
# compares equal to this value
_SEED = "seed"

logger = logging.getLogger(__name__)

# ML_SERVING_MODE's labels: the port's torch engine (models/scorer.GNNScorer)
# beside the reference's; "jax" is the reference's GNNScorer, which a
# reference scheduler's own loader hands this evaluator
SERVING_MODES = ("native", "torch", "jax", "base")

# Bad-node thresholds (ref evaluator_base.go:193-229)
_MIN_SAMPLES_FOR_SIGMA = 30
_SIGMA_FACTOR = 3.0
_SMALL_SAMPLE_MEAN_FACTOR = 20.0


_LOG_1TIB = float(np.log1p(1 << 40))

# pair location strings are drawn from a small set of datacenter paths;
# memoizing the prefix-match keeps it off the per-candidate hot path
_location_affinity_cached = functools.lru_cache(maxsize=4096)(location_affinity)


def _parent_static_row(p: Peer, h) -> np.ndarray:
    """The child-independent feature columns of one candidate parent
    (indices 0,1,2,3,7,9,12), cached ON THE PEER keyed by the peer's and
    host's feature versions — every mutation of an attribute read here bumps
    a version (resource.Host.feat_version / Peer.feat_version), so a cached
    row is exact except for ancestor-depth staleness (documented there).
    Child-dependent and round-constant columns are left zero; the caller
    fills them into the stacked matrix.

    Thread safety (round dispatcher): the cache is published as ONE
    (version, row) tuple so concurrent worker threads can never observe a
    version stamp paired with another version's row; all inputs read here are
    either scalars published before their version bump (piece_cost_avg_ms),
    ints/enums (atomic attribute reads), or DAG walks that snapshot under the
    DAG's own lock (children_of, depth). Racing writers may both compute the
    row — they compute identical bytes for the same version, so last-write
    wins harmlessly."""
    ver = (p.feat_version, h.feat_version)
    hit_ver, hit_row = p._feat_row
    if hit_ver == ver:
        return hit_row
    row = np.array(
        (
            p.finished_piece_ratio(),
            h.upload_success_rate,
            h.free_upload_slots / max(1, h.upload_limit),
            1.0 if h.type == _SEED else 0.0,
            0.0,  # f4 idc affinity (child-dependent)
            0.0,  # f5 location affinity (child-dependent)
            0.0,  # f6 rtt (child-dependent)
            p.piece_cost_avg_ms / 30_000.0,
            0.0,  # f8 bandwidth history (child-dependent)
            min(p.depth(), 10) / 10.0,
            0.0,  # f10 child ratio (round constant)
            0.0,  # f11 size norm (round constant)
            len(p.task.children_of(p.id)) / 40.0,
            0.0,  # f13 schedule rounds (round constant)
            1.0,  # f14 bias
            0.0,  # f15 reserved
        ),
        dtype=np.float32,
    )
    p._feat_row = (ver, row)
    return row


# A parent's pair-row cache is bounded by the hosts that ever scheduled
# against it; past this many distinct child hosts the dict is cleared whole
# (rows rebuild on demand — eviction bookkeeping would cost more than the
# rebuild at these row sizes).
_PAIR_ROW_CACHE_MAX = 4096


def _build_pair_features_rowwise(
    child: Peer, parents: Sequence[Peer], topology=None, bandwidth=None
) -> np.ndarray:
    """Reference-shaped feature assembly (the earlier hot path): version-cached
    static rows stacked, then the four child-dependent columns recomputed via
    per-column comprehensions EVERY round. Kept as the equivalence baseline
    — `build_pair_features` below must stay bit-identical to this on any
    pool state."""
    n = len(parents)
    if n == 0:
        return np.zeros((0, FEATURE_DIM), dtype=np.float32)
    child_host = child.host
    child_host_id = child_host.id
    child_idc = child_host.idc
    child_loc = child_host.location
    avg_rtt = topology.avg_rtt_ms if topology is not None else None
    bw_norm = bandwidth.normalized if bandwidth is not None else None

    hs = [p.host for p in parents]  # dflint: disable=DF035 rowwise reference leg: the equivalence baseline, never on the shipping path
    f = np.stack([_parent_static_row(p, h) for p, h in zip(parents, hs)])  # dflint: disable=DF035 rowwise reference leg (equivalence baseline)
    f[:, 4] = [1.0 if h.idc and h.idc == child_idc else 0.0 for h in hs]
    f[:, 5] = [_location_affinity_cached(h.location, child_loc) for h in hs]
    if avg_rtt is not None:
        f[:, 6] = [
            min(rtt, 1000.0) / 1000.0 if (rtt := avg_rtt(child_host_id, h.id)) is not None else 0.0
            for h in hs
        ]
    if bw_norm is not None:
        f[:, 8] = [bw_norm(h.id, child_host_id) for h in hs]
    _fill_round_columns(f, child)
    return f


def _round_col_values(child: Peer) -> tuple[float, float, float]:
    """The three round-constant scalars (columns 10/11/13) as Python floats.

    Single source of truth for BOTH fill paths: `_fill_round_columns`
    broadcasts them onto an assembled matrix, and the native round driver
    receives them in a float32 side array and broadcasts in C++ — the same
    Python-float → float32 cast either way, so the resulting feature bytes
    are identical."""
    task = child.task
    return (
        child.finished_piece_ratio(),
        float(np.log1p(task.content_length)) / _LOG_1TIB if task.content_length else 0.0,
        min(child.schedule_rounds, 10) / 10.0,
    )


def _shadow_slice_key(child: Peer) -> str:
    """Shadow-divergence slice label for a round's child population: coarse
    region (first `location` segment, falling back to idc) × task peer-count
    band. Divergence that is invisible in the global mean — a candidate model
    mis-ranking only one region's flash crowds — shows up as a bad slice."""
    host = child.host
    region = (host.location.split("|", 1)[0] if host.location else "") or host.idc or "?"
    n = len(child.task.dag)
    if n < 100:
        band = "p<1e2"
    elif n < 1_000:
        band = "p<1e3"
    elif n < 10_000:
        band = "p<1e4"
    else:
        band = "p>=1e4"
    return f"{region}|{band}"


def _fill_round_columns(f: np.ndarray, child: Peer) -> None:
    """Round-constant columns (child progress / task size / retry count) —
    scalar broadcasts onto the stacked matrix, shared by both assembly paths."""
    r10, r11, r13 = _round_col_values(child)
    f[:, 10] = r10
    f[:, 11] = r11
    f[:, 13] = r13


def build_pair_features(
    child: Peer, parents: Sequence[Peer], topology=None, bandwidth=None
) -> np.ndarray:
    """Feature matrix [len(parents), FEATURE_DIM] per models.features schema.

    topology: scheduler.networktopology.NetworkTopology (or None) — fills
    rtt_norm from live probe data. bandwidth: telemetry.BandwidthHistory (or
    None) — fills bandwidth_norm from observed transfer history.

    Hot path: runs once per scheduling round, 40 candidates each, against a
    10k-rounds/s serving budget. The FULL per-pair row (static columns AND
    the child-dependent idc/location/rtt/bandwidth columns) is cached on the
    parent peer keyed by (parent peer, parent host, child host, topology
    pair, bandwidth parent) versions — every mutation of an input bumps one
    of those counters (resource.Host/Peer.bump_feat,
    NetworkTopology.pair_version, BandwidthHistory.parent_version). The
    topology/bandwidth legs are PER-EDGE: a probe landing on one
    (src, dst) pair, or one parent's bandwidth observation, invalidates only
    the rows it can actually change — unrelated edges stay warm instead of
    the whole cluster re-assembling per probe. A steady-state round is
    therefore a couple of dict lookups + a version compare per candidate and
    one row memcpy: the rtt/bw/affinity recomputes (dominated by
    statistics.fmean inside avg_rtt_ms) drop out entirely. Only the three
    round-constant columns (10/11/13) are written per call — onto the
    stacked COPY, so cached rows stay pristine.

    Safe under the concurrent round dispatcher WITHOUT the scheduler's state
    lock: cache entries are immutable (key, row) tuples published in one
    store; version sources bump AFTER their value writes (see
    BandwidthHistory.observe), so reading the key before the values can at
    worst cache a NEWER value under an older key — one extra rebuild on the
    next probe, never a stuck-stale row."""
    n = len(parents)
    if n == 0:
        return np.zeros((0, FEATURE_DIM), dtype=np.float32)
    # preallocate + per-row memcpy instead of np.stack: stack's dispatcher
    # (asanyarray per row, shape set, concat) was the largest single item
    # left after the caching landed (~25% of the assembled round)
    f = np.empty((n, FEATURE_DIM), dtype=np.float32)
    _export_pair_rows(child, parents, topology, bandwidth, f)
    _fill_round_columns(f, child)
    return f


def _export_pair_rows(
    child: Peer, parents: Sequence[Peer], topology, bandwidth, f: np.ndarray
) -> None:
    """Write the version-cached pair rows for `parents` into f[:n] — the
    assembly core of `build_pair_features`, split out so the native round
    driver (scheduling._RoundArena) can fill its flat feature arena directly
    with zero intermediate matrix. The round-constant columns (10/11/13)
    stay zero here: build_pair_features broadcasts them in numpy, the driver
    broadcasts the same float32 scalars in C++ (see _round_col_values)."""
    child_host = child.host
    child_host_id = child_host.id
    child_idc = child_host.idc
    child_loc = child_host.location
    topo_pver = topology.pair_version if topology is not None else None
    bw_pver = bandwidth.parent_version if bandwidth is not None else None

    child_feat_ver = child_host.feat_version
    for i, p in enumerate(parents):  # dflint: disable=DF035 this IS the kept assembly loop: version-keyed dict reads + one row memcpy per candidate feed the arena the native driver consumes
        h = p.host
        key = (
            p.feat_version, h.feat_version, child_feat_ver,
            topo_pver(child_host_id, h.id) if topo_pver is not None else -1,
            bw_pver(h.id) if bw_pver is not None else -1,
        )
        hit = p._pair_rows.get(child_host_id)
        if hit is not None and hit[0] == key:
            f[i] = hit[1]
            continue
        row = _parent_static_row(p, h).copy()
        row[4] = 1.0 if h.idc and h.idc == child_idc else 0.0
        row[5] = _location_affinity_cached(h.location, child_loc)
        if topology is not None:
            rtt = topology.avg_rtt_ms(child_host_id, h.id)
            if rtt is not None:
                row[6] = min(rtt, 1000.0) / 1000.0
        if bandwidth is not None:
            row[8] = bandwidth.normalized(h.id, child_host_id)
        if len(p._pair_rows) >= _PAIR_ROW_CACHE_MAX:
            p._pair_rows.clear()
        p._pair_rows[child_host_id] = (key, row)
        f[i] = row


# ---------------------------------------------------------------------------
# scoring decision records: why did THOSE parents win that round?

# Sampled, not exhaustive: one full record (feature matrix + scores + ids)
# is a few KB; the default records 1 round in 50 into a 256-slot ring.
# The reference's DRAGONFLY_DECISION_SAMPLE / SchedulerService
# (decision_sample_rate=) override it; tests run at 1.0.
DECISION_SAMPLE_DEFAULT = 0.02
DECISION_RING_DEFAULT = 256


class DecisionRecorder:
    """Bounded, sampled ring of scoring decisions.

    Each recorded round captures the full evidence a post-hoc "why did these
    parents win" question needs: the candidate parent set (peer + host ids),
    the assembled feature rows EXACTLY as scored, the score vector, the
    chosen top-k (recomputed with the same stable argsort
    Scheduling._top_parents uses, so the stored choice is bit-exact with the
    round's), the serving model version/mode, and the active trace_id when a
    trace is recording — `dftrace` finds the round, `dfml explain` replays
    it. Served at /debug/decisions and over the `decision_records` scheduler
    RPC.

    Sampling is a deterministic stride (ratio-exact, no rng — the
    ShadowTracker discipline); the ring and counters live behind one small
    lock because rounds record from dispatcher worker threads. Timestamps
    come from an injected clock (DF029) so recorded rounds inside the swarm
    simulator stamp virtual time.
    """

    def __init__(
        self,
        *,
        sample_rate: float = DECISION_SAMPLE_DEFAULT,
        capacity: int = DECISION_RING_DEFAULT,
        topk: int = 4,
        clock: clockmod.Clock | None = None,
    ):
        self.sample_rate = float(sample_rate)
        self._stride = (
            max(1, round(1.0 / sample_rate)) if sample_rate > 0 else 0
        )
        self.topk = int(topk)
        self._clock = clock or clockmod.SYSTEM
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.rounds_seen = 0
        self.recorded = 0
        self._seq = 0

    def maybe_record(
        self, child, parents, feats, scores, *, bundle=None, copy=False
    ) -> None:
        """Record this round if the stride elects it. Cheap when it doesn't:
        one lock + counter. Never raises into the scoring path.

        The sampled-in path stays lean too (it rides the serving round):
        per-parent ids as tuples, score/feature arrays stored by REFERENCE
        (both are freshly allocated per round and never mutated after — see
        build_pair_features/_base_from), chosen computed with the exact
        stable argsort Scheduling._top_parents runs (the bit-exact replay
        contract), everything else deferred to snapshot(). Callers whose
        arrays are VIEWS into a reused buffer (the native round driver's
        arena) pass copy=True — only sampled-in rounds pay the copy."""
        stride = self._stride
        if stride == 0:
            return
        try:
            with self._lock:
                self.rounds_seen += 1
                if self.rounds_seen % stride:
                    return
                self._seq += 1
                seq = self._seq
            if copy:
                scores = np.array(scores, dtype=np.float32)
                feats = np.array(feats, dtype=np.float32)
            # EXACTLY _top_parents' selection: same negation dtype, same
            # stable argsort — the stored chosen must replay bit-for-bit
            order = np.argsort(-np.asarray(scores), kind="stable")
            chosen = [parents[i].id for i in order[: self.topk]]
            from dragonfly2_tpu_torch.observability.tracing import Tracer

            ctx = Tracer.current_context()
            record = {
                "seq": seq,
                "ts": self._clock.time(),
                "task_id": child.task.id,
                "child_peer": child.id,
                "child_host": child.host.id,
                "parents": [(p.id, p.host.id) for p in parents],
                "scores": scores,  # by reference until snapshot()
                "feats": feats,
                "chosen": chosen,
                "topk": self.topk,
                "model_version": getattr(bundle, "version", "") or "",
                "serving_mode": self._mode_label(bundle),
                # the port's tracer records every span it opens (no sampling)
                "trace_id": ctx.trace_id if ctx is not None else "",
            }
            with self._lock:
                self._ring.append(record)
                self.recorded += 1
        except Exception:
            logger.exception("decision record failed")

    @staticmethod
    def _mode_label(bundle) -> str:
        if bundle is None:
            return "base"
        scorer = getattr(bundle, "scorer", None)
        return getattr(scorer, "engine", None) or (
            "native" if hasattr(scorer, "score_rounds") else "torch"
        )

    def snapshot(
        self,
        *,
        task_id: str | None = None,
        child: str | None = None,
        limit: int = 64,
        with_features: bool = True,
    ) -> list[dict]:
        """Newest-first JSON-safe records; `child` matches the child peer OR
        child host id. Scores/features serialize exactly (no rounding) — the
        replay contract is bit-exact."""
        with self._lock:
            records = list(self._ring)
        out: list[dict] = []
        for r in reversed(records):
            if task_id is not None and r["task_id"] != task_id:
                continue
            if child is not None and child not in (r["child_peer"], r["child_host"]):
                continue
            d = {
                k: v for k, v in r.items()
                if k not in ("scores", "feats", "parents")
            }
            d["parents"] = [{"peer": p, "host": h} for p, h in r["parents"]]
            d["scores"] = [float(x) for x in r["scores"]]
            if with_features:
                d["feats"] = [[float(x) for x in row] for row in np.asarray(r["feats"])]  # dflint: disable=DF033 cold introspection path — per-record JSON conversion of a ring snapshot, not a columnar pass
            out.append(d)
            if len(out) >= limit:
                break
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "capacity": self._ring.maxlen,
                "records": len(self._ring),
                "rounds_seen": self.rounds_seen,
                "recorded": self.recorded,
                "topk": self.topk,
            }


class Evaluator:
    """Base linear evaluator + bad-node detection. Subclass for `ml`."""

    name = "base"
    topology = None  # NetworkTopology, attached by the scheduler service
    bandwidth = None  # telemetry.BandwidthHistory, attached by the service
    # ML-plane observability seams, attached by the scheduler
    # service / manager link; None = recording/drift off (library default)
    decisions: "DecisionRecorder | None" = None
    drift = None  # observability.sketches.DriftDetector
    # Brownout ladder, attached by the scheduler service; None =
    # no shedding (library default). Hot paths read ONE published bool per
    # gate — the controller recomputes them on level changes.
    degradation = None  # scheduler.degradation.DegradationController
    # Assembly seam: a baseline instance swaps in
    # _build_pair_features_rowwise; production always serves the cached
    # path (and the port's chip smoke sets precomputed rows here).
    feature_builder = staticmethod(build_pair_features)

    def _record_decision(
        self, child, parents, feats, scores, bundle=None, copy=False
    ) -> None:
        """Sampled decision-record hook: cheap None-check per
        round when no recorder is attached; maybe_record never raises.
        Shed at brownout rung 2 (shed_obs) — recording is observability tax,
        not serving. copy=True when feats/scores are views into a reused
        arena (the native round driver path)."""
        rec = self.decisions
        if rec is not None:
            deg = self.degradation
            if deg is not None and deg.shed_obs:
                return
            rec.maybe_record(child, parents, feats, scores, bundle=bundle, copy=copy)

    def _observe_drift(self, feats) -> None:
        """Feature-drift live-sketch feed; shed with decision
        recording at brownout rung 2."""
        d = self.drift
        if d is not None:
            deg = self.degradation
            if deg is not None and deg.shed_obs:
                return
            d.observe(feats)

    def native_round_entry(self):
        """Serving bundle for the native round driver, or None: the base
        evaluator has no native scorer, so rounds always take the Python
        path. MLEvaluator overrides with the real gate."""
        return None

    def evaluate(self, child: Peer, parents: Sequence[Peer]) -> np.ndarray:
        if not parents:
            return np.zeros(0, dtype=np.float32)
        feats = self.feature_builder(child, parents, self.topology, self.bandwidth)
        out = feats @ BASE_WEIGHTS
        self._record_decision(child, parents, feats, out)
        return out

    def evaluate_many(
        self, rounds: Sequence[tuple[Peer, Sequence[Peer]]]
    ) -> list[np.ndarray]:
        """Score a BATCH of independent rounds in one call — the round
        dispatcher's worker-side entry. The base evaluator has no FFI hop to
        amortize, so this is the per-round loop; MLEvaluator overrides it to
        cross the native FFI once per batch (score_rounds)."""
        return [self.evaluate(c, ps) for c, ps in rounds]

    async def evaluate_async(self, child: Peer, parents: Sequence[Peer]) -> np.ndarray:
        """Async scoring entry: the base evaluator is pure numpy, so this is
        just the sync path; MLEvaluator overrides it to await the micro-batched
        native scorer (concurrent scheduling rounds coalesce into one FFI call).
        """
        return self.evaluate(child, parents)

    def is_bad_node(self, peer: Peer) -> bool:
        """Piece-cost outlier ejection (ref evaluator_base.go:193-229),
        memoized per feature version: the cost statistics only change when a
        new piece-cost sample lands, which bumps the version — without the
        memo this recomputes mean/stdev per candidate per round (40x the
        work on the serving hot path)."""
        if peer.fsm.current == "failed":
            return True
        ver, cached = peer._bad_memo
        if ver == peer.feat_version:
            return cached
        costs = list(peer.piece_costs_ms)
        if len(costs) < 2:
            bad = False
        elif len(costs) < _MIN_SAMPLES_FOR_SIGMA:
            bad = costs[-1] > statistics.fmean(costs[:-1]) * _SMALL_SAMPLE_MEAN_FACTOR
        else:
            bad = costs[-1] > statistics.fmean(costs) + _SIGMA_FACTOR * statistics.pstdev(costs)
        peer._bad_memo = (peer.feat_version, bad)
        return bad


class _ShadowSlot:
    """Candidate model + its divergence tracker, published as ONE attribute
    store so a shadow round never mixes one candidate's bundle with another's
    tracker (same read-once discipline as the serving bundle)."""

    __slots__ = ("bundle", "tracker")

    def __init__(self, bundle, tracker):
        self.bundle = bundle
        self.tracker = tracker


class MLEvaluator(Evaluator):
    """GNN-scored evaluator with base fallback (the reference's unfilled slot).

    node_index maps host_id -> row in the topology graph the scorer was
    refreshed with; hosts unknown to the graph fall back to the base score.

    Serving state is ONE immutable rollout.ModelBundle published as a single
    attribute (`_serving`): every scoring entry reads it once and scores
    entirely through that reference, so a hot-swap mid-traffic can never
    produce a round scored half on the old model and half on the new
    (the zero-torn-rounds property). Bundle begin/end refcounts tell
    the swapper when a replaced bundle has drained and its native forks can
    be freed. A second slot (`_shadow`) carries a CANDIDATE model that scores
    the same rounds log-only, recording divergence against whatever was
    actually served — the evidence the rollout gate promotes on.
    """

    name = "ml"

    def __init__(self, scorer=None, node_index: dict[str, int] | None = None):
        self._serving: "rollout.ModelBundle | None" = None
        self._shadow: _ShadowSlot | None = None
        self.refreshed_at: float | None = None
        if scorer is not None:
            self.attach_scorer(scorer, node_index or {})
        else:
            self._set_serving_mode("base")

    @staticmethod
    def _mode_of(scorer) -> str:
        # scorers self-label via `engine`: "native" for the C++ scorer of
        # either package, "torch" for the port's GNNScorer, "jax" for the
        # reference's
        return getattr(scorer, "engine", None) or (
            "native" if hasattr(scorer, "score_rounds") else "torch"
        )

    @staticmethod
    def _set_serving_mode(mode: str) -> None:
        """Expose the active scoring implementation: exactly one of native,
        torch, jax and base reads 1. The port's engines log at info level.
        Base while ml is selected logs a warning, since a failed artifact
        load then serves no model at all; so does jax, as the reference
        warns that its native scorer is not active, and so does an engine
        no label names (every gauge then reads 0)."""
        from dragonfly2_tpu_torch.scheduler import metrics

        for m in SERVING_MODES:
            metrics.ML_SERVING_MODE.set(1.0 if m == mode else 0.0, mode=m)
        if mode in ("native", "torch"):
            logger.info("ml evaluator serving mode: %s", mode)
        elif mode == "base":
            logger.warning(
                "ml evaluator serving mode: base (no model serves: every round takes the base evaluator's blend)"
            )
        elif mode == "jax":
            logger.warning(
                "ml evaluator serving mode: jax (the reference's GNNScorer serves: the native scorer is NOT active)"
            )
        else:
            logger.warning("ml evaluator serving mode: %s (an engine no ML_SERVING_MODE label names)", mode)

    def _count_fallback(self, reason: str) -> None:
        from dragonfly2_tpu_torch.scheduler import metrics

        metrics.ML_BASE_FALLBACK_TOTAL.inc(reason=reason)
        # registry-scoped twin: the reference's SchedulerService wires its
        # ServiceMetrics here so rollout health baselines window THIS
        # service's fallbacks, not every service's in the process
        local = getattr(self, "local_metrics", None)
        if local is not None:
            local.base_fallback.inc(reason=reason)

    def attach_scorer(
        self, scorer, node_index: dict[str, int], *,
        microbatch=None, handle_pool=None, version: str = "",
    ):
        """Hot-swap the model (called when the trainer publishes a version);
        until then evaluate() serves the base fallback. Returns the PREVIOUS
        serving bundle (or None) — the caller owns its lifecycle: the
        ManagerLink keeps it warm for instant rollback, everyone else can
        drop it (native handles free on GC as before).

        microbatch: optional native.MicroBatchScorer wrapping `scorer` — when
        set, evaluate_async coalesces concurrent scheduling rounds into one
        multi-round scorer call (the batched serving path); the sync
        evaluate() keeps calling `scorer` directly.

        handle_pool: optional native.ScorerHandlePool over `scorer` — when
        set, the sync evaluate() scores through the CALLING THREAD's own
        native handle (scorer.cc: one handle per thread, a shared handle
        serializes on an internal mutex), which is what lets the round
        dispatcher's workers overlap their FFI legs across cores.
        """
        from dragonfly2_tpu_torch.scheduler import rollout

        return self.swap_bundle(
            rollout.ModelBundle(
                scorer, node_index, version=version,
                microbatch=microbatch, handle_pool=handle_pool,
            )
        )

    def swap_bundle(self, bundle):
        """Publish `bundle` as the serving model in ONE attribute store (the
        zero-drop swap primitive: in-flight rounds finish on the bundle they
        read at entry; new rounds read this one). Returns the previous
        bundle. Accepts None to drop to base serving."""
        import time

        from dragonfly2_tpu_torch.scheduler import metrics

        old, self._serving = self._serving, bundle
        if bundle is not None:
            self.refreshed_at = time.time()
            metrics.ML_EMBEDDINGS_REFRESH_TIMESTAMP.set(self.refreshed_at)
            self._set_serving_mode(self._mode_of(bundle.scorer))
        else:
            self._set_serving_mode("base")
        return old

    @property
    def serving_bundle(self):
        return self._serving

    @property
    def serving_version(self) -> str:
        b = self._serving
        return b.version if b is not None else ""

    # ---- candidate (shadow) slot: shadow-scored rollout ----

    def attach_candidate(
        self, scorer, node_index: dict[str, int], *,
        version: str, sample_rate: float = 1.0, topk: int = 4,
        handle_pool=None,
    ):
        """Install a CANDIDATE model: every (sampled) scheduling round is
        additionally scored by it, log-only, with per-round divergence
        against the served scores recorded into the returned ShadowTracker.
        Returns (tracker, previous_candidate_bundle_or_None); the caller
        drains/frees the replaced bundle. Works under the round dispatcher:
        candidate handle_pool forks give each worker thread its own handle,
        and the tracker is thread-safe."""
        from dragonfly2_tpu_torch.scheduler import rollout

        bundle = rollout.ModelBundle(
            scorer, node_index, version=version, handle_pool=handle_pool
        )
        tracker = rollout.ShadowTracker(version, sample_rate=sample_rate, topk=topk)
        old = self._shadow
        self._shadow = _ShadowSlot(bundle, tracker)
        logger.info(
            "shadow scoring candidate %s (%d hosts, sample_rate=%.2f)",
            version, len(node_index), sample_rate,
        )
        return tracker, (old.bundle if old is not None else None)

    def detach_candidate(self):
        """Stop shadow scoring; returns the candidate bundle (or None) for
        the caller to drain and free."""
        old, self._shadow = self._shadow, None
        return old.bundle if old is not None else None

    @property
    def candidate_version(self) -> str:
        s = self._shadow
        return s.tracker.version if s is not None else ""

    @property
    def candidate_tracker(self):
        s = self._shadow
        return s.tracker if s is not None else None

    def _shadow_score(self, child, parents, feats: np.ndarray, served: np.ndarray) -> None:
        """Score the round with the candidate model and record divergence.
        Never raises and never touches the served result — a broken
        candidate shows up as tracker errors (gated on), not as traffic
        impact. Subset comparison: parents unknown to the candidate's graph
        are dropped from BOTH vectors; a round with <2 comparable parents
        (or an unknown child) counts as uncovered."""
        slot = self._shadow
        if slot is None:
            return
        deg = self.degradation
        if deg is not None and deg.shed_shadow:
            return  # brownout rung 1: log-only work is the first thing shed
        tracker = slot.tracker
        try:
            if not tracker.should_sample():
                return
            bundle = slot.bundle
            if not bundle.ready:
                tracker.record_uncovered()
                return
            idx = bundle.node_index
            child_idx = idx.get(child.host.id)
            if child_idx is None:
                tracker.record_uncovered()
                return
            parent_idx = [idx.get(p.host.id) for p in parents]  # dflint: disable=DF035 kept serial shadow leg: the sync fallback behind _shadow_score_batch, off the served round's critical path
            keep = [i for i, pi in enumerate(parent_idx) if pi is not None]  # dflint: disable=DF035 kept serial shadow leg (subset mask, log-only)
            if len(keep) < 2:
                tracker.record_uncovered()
                return
            p = np.array([parent_idx[i] for i in keep], np.int32)
            c = np.full(len(keep), child_idx, np.int32)
            f = feats[keep] if len(keep) < len(parents) else feats
            bundle.begin()
            try:
                cand = bundle.thread_scorer().score(f, child=c, parent=p)
            finally:
                bundle.end()
            cand = np.asarray(cand, np.float64)
            if not np.isfinite(cand).all():
                # a model emitting NaN/inf scores is broken, full stop —
                # count it as a candidate ERROR so the gate's error-rate
                # bound rejects it (a NaN delta would silently PASS every
                # `>` bound; found live: a diverged 12-step train run)
                logger.warning(
                    "candidate %s produced non-finite scores", tracker.version
                )
                tracker.record_error()
                return
            srv = np.asarray(served, np.float64)
            if len(keep) < len(parents):
                srv = srv[keep]
            if not np.isfinite(srv).all():
                # the SERVED scores are unusable as a comparison baseline;
                # that is not the candidate's fault — no divergence evidence
                tracker.record_uncovered()
                return
            tracker.record(srv, cand, slice_key=_shadow_slice_key(child))
        except Exception:
            logger.exception("shadow scoring failed (candidate %s)", tracker.version)
            tracker.record_error()

    def _shadow_score_batch(self, items) -> None:
        """Shadow-score a BATCH of rounds against the candidate model in ONE
        multi-round FFI call instead of a sync per-round `score()` each —
        the shadow leg riding the same amortized entry the serving path uses.

        items: (child, parents, feats, served) tuples in round order.
        Per-round outcomes are bit-identical to `_shadow_score`: the
        sampling stride and the uncovered/error taxonomy advance in the same
        round order, and per-row scoring math does not depend on the batch
        shape (native scorer property pinned by tests). A batch-level scorer
        rejection retries per round so one bad round degrades alone."""
        slot = self._shadow
        if slot is None or not items:
            return
        deg = self.degradation
        if deg is not None and deg.shed_shadow:
            return  # brownout rung 1: log-only work is the first thing shed
        tracker = slot.tracker
        bundle = slot.bundle
        sampled = []  # (c, p, f, srv_kept, slice_key) per elected round
        try:
            for child, parents, feats, served in items:
                if not tracker.should_sample():
                    continue
                if not bundle.ready:
                    tracker.record_uncovered()
                    continue
                idx = bundle.node_index
                child_idx = idx.get(child.host.id)
                if child_idx is None:
                    tracker.record_uncovered()
                    continue
                parent_idx = [idx.get(p.host.id) for p in parents]  # dflint: disable=DF035 batched-entry prepare: per-candidate dict lookups feed ONE multi-round FFI; the scoring loop itself is native
                keep = [i for i, pi in enumerate(parent_idx) if pi is not None]  # dflint: disable=DF035 batched-entry prepare (subset mask, log-only)
                if len(keep) < 2:
                    tracker.record_uncovered()
                    continue
                p = np.array([parent_idx[i] for i in keep], np.int32)
                c = np.full(len(keep), child_idx, np.int32)
                subset = len(keep) < len(parents)
                f = np.asarray(feats)[keep] if subset else np.asarray(feats)  # dflint: disable=DF033 feats is one ROUND's [B,FP] matrix (already ndarray: no-copy view), not a per-row build
                srv = np.asarray(served, np.float64)  # dflint: disable=DF033 one [B] vector per round; float64 copy needed for the divergence math
                if subset:
                    srv = srv[keep]
                sampled.append((c, p, f, srv, _shadow_slice_key(child)))
        except Exception:
            logger.exception("shadow batch prepare failed (candidate %s)", tracker.version)
            tracker.record_error()
            return
        if not sampled:
            return
        bundle.begin()
        try:
            scorer = bundle.thread_scorer()
            cands: list[np.ndarray | None]
            if len(sampled) > 1 and hasattr(scorer, "score_rounds"):
                widths = [len(c) for c, _p, _f, _s, _k in sampled]
                B = max(widths)
                fp = sampled[0][2].shape[1]
                mf = np.zeros((len(sampled), B, fp), np.float32)
                mc = np.zeros((len(sampled), B), np.int32)
                mp = np.zeros((len(sampled), B), np.int32)
                for m, (c, p, f, _s, _k) in enumerate(sampled):
                    mf[m, : widths[m]] = f
                    mc[m, : widths[m]] = c
                    mp[m, : widths[m]] = p
                try:
                    out = scorer.score_rounds(mf, child=mc, parent=mp)
                    cands = [out[m, : widths[m]] for m in range(len(sampled))]
                except Exception:
                    logger.exception(
                        "batched shadow scoring failed (candidate %s); retrying per round",
                        tracker.version,
                    )
                    cands = [None] * len(sampled)
            else:
                cands = [None] * len(sampled)
            for m, (c, p, f, srv, skey) in enumerate(sampled):
                cand = cands[m]
                if cand is None:
                    try:
                        cand = scorer.score(f, child=c, parent=p)
                    except Exception:
                        logger.exception(
                            "shadow scoring failed (candidate %s)", tracker.version
                        )
                        tracker.record_error()
                        continue
                cand = np.asarray(cand, np.float64)
                if not np.isfinite(cand).all():
                    logger.warning(
                        "candidate %s produced non-finite scores", tracker.version
                    )
                    tracker.record_error()
                    continue
                if not np.isfinite(srv).all():
                    tracker.record_uncovered()
                    continue
                tracker.record(srv, cand, slice_key=skey)
        finally:
            bundle.end()

    def native_round_entry(self):
        """The serving ModelBundle the native round driver may score through,
        or None when the round must take the serial Python path. Gated
        exactly like the serial ML legs: a brownout at base_only (rung 3)
        sheds the driver too, no bundle / not ready serves base, and only
        the C++ engine (drive_rounds + matching feature schema) qualifies —
        the torch engine keeps the per-round path."""
        deg = self.degradation
        if deg is not None and deg.base_only:
            return None
        bundle = self._serving
        if bundle is None or not bundle.ready:
            return None
        scorer = bundle.scorer
        if getattr(scorer, "engine", None) != "native" or not hasattr(scorer, "drive_rounds"):
            return None
        if getattr(scorer, "feature_dim", None) != FEATURE_DIM:
            return None
        return bundle

    def finish_native_rounds(self, items, bundle) -> None:
        """Observability tail for natively-driven rounds, in round order:
        feature-drift folds, sampled decision records (copy-on-record —
        feats/scores are views into the reused arena), then ONE batched
        shadow pass. Mode-honest: records carry the serving bundle the
        driver actually scored through."""
        for child, parents, feats, scores in items:
            self._observe_drift(feats)
            self._record_decision(
                child, parents, feats, scores, bundle=bundle, copy=True
            )
        self._shadow_score_batch(items)

    def embeddings_age_s(self) -> float | None:
        """Seconds since the serving embeddings were refreshed (staleness);
        None while no model is attached."""
        import time

        return None if self.refreshed_at is None else time.time() - self.refreshed_at

    def _prepare(self, child: Peer, parents: Sequence[Peer], bundle=None):
        """Shared pre-scoring step: (feats, child_ids, parent_ids, known);
        feats is ALWAYS a real matrix — child_ids (c) is None when the ML
        path can't score this round (no host known to the graph), which is
        the sentinel both callers test before falling back to
        `_base_from(feats)`. Builds the feature matrix ONCE; the base score is
        NOT computed here — the common all-hosts-known round never needs it,
        and `feats @ BASE_WEIGHTS` is pure so error paths derive it on demand.
        known is None when every host is known (the steady-state fast path:
        no mask array, no np.where on return). `bundle` is the round's
        read-once serving bundle (defaults to the current one for external
        probes like dfstress)."""
        if bundle is None:
            bundle = self._serving
        feats = self.feature_builder(child, parents, self.topology, self.bandwidth)
        # feature-drift live sketch: sampled fold of the assembled
        # matrix — the drift detector compares exactly what scoring sees
        # against the distribution the serving model trained on
        self._observe_drift(feats)
        child_idx = bundle.node_index.get(child.host.id) if bundle is not None else None
        if child_idx is None:
            return feats, None, None, None
        idx = bundle.node_index
        parent_idx = [idx.get(p.host.id) for p in parents]  # dflint: disable=DF035 kept serial reference leg: the evaluate/evaluate_many path the native driver falls back to, pinned bit-identical by the equivalence tests
        if None in parent_idx:
            known = np.array([i is not None for i in parent_idx])  # dflint: disable=DF035 kept serial reference leg (partial-known mask)
            if not known.any():
                return feats, None, None, None
            p = np.array([i if i is not None else 0 for i in parent_idx], np.int32)  # dflint: disable=DF035 kept serial reference leg (partial-known merge)
        else:
            known = None  # all known — skip masking entirely
            p = np.array(parent_idx, np.int32)
        c = np.full(len(parents), child_idx, np.int32)
        return feats, c, p, known

    @staticmethod
    def _base_from(feats: np.ndarray) -> np.ndarray:
        return (feats @ BASE_WEIGHTS).astype(np.float32)

    def evaluate(self, child: Peer, parents: Sequence[Peer]) -> np.ndarray:
        if not parents:
            return np.zeros(0, dtype=np.float32)
        deg = self.degradation
        if deg is not None and deg.base_only:
            # brownout rung 3: skip ML prepare/FFI entirely — the round
            # costs one cached feature assembly + base matmul (shadow,
            # recording, and drift are already shed at rungs 1-2)
            self._count_fallback("degraded")
            return self._base_from(
                self.feature_builder(child, parents, self.topology, self.bandwidth)
            )
        # read the serving bundle ONCE: everything below scores through this
        # reference, so a concurrent hot-swap can't produce a torn round
        bundle = self._serving
        if bundle is None or not bundle.ready:
            self._count_fallback("no_scorer")
            feats = self.feature_builder(child, parents, self.topology, self.bandwidth)
            self._observe_drift(feats)
            out = self._base_from(feats)
            self._shadow_score(child, parents, feats, out)
            self._record_decision(child, parents, feats, out)
            return out
        feats, c, p, known = self._prepare(child, parents, bundle)
        if c is None:
            self._count_fallback("unknown_hosts")
            out = self._base_from(feats)
            self._shadow_score(child, parents, feats, out)
            self._record_decision(child, parents, feats, out)
            return out
        # Per-thread handle when a pool is attached: dispatcher workers each
        # score on their own native handle (the pool hands the constructing
        # thread the primary, so the serial path is byte-for-byte unchanged).
        bundle.begin()
        try:
            try:
                ml = bundle.thread_scorer().score(feats, child=c, parent=p)
            except Exception:
                logger.exception("ml scorer failed; using base evaluator")
                self._count_fallback("scorer_error")
                out = self._base_from(feats)
                self._shadow_score(child, parents, feats, out)
                self._record_decision(child, parents, feats, out)
                return out
        finally:
            bundle.end()
        if known is None:
            out = np.asarray(ml, dtype=np.float32)
        else:
            out = np.where(known, ml, self._base_from(feats)).astype(np.float32)
        self._shadow_score(child, parents, feats, out)
        self._record_decision(child, parents, feats, out, bundle=bundle)
        return out

    def evaluate_many(
        self, rounds: Sequence[tuple[Peer, Sequence[Peer]]]
    ) -> list[np.ndarray]:
        """Batch entry for the round dispatcher's workers: every round's
        features are assembled here (GIL-held numpy), then ALL scorable
        rounds cross the FFI in ONE score_rounds call on the calling
        thread's own handle — the per-round wrapper overhead (array
        conversions, ctypes marshalling) that kept the single-round call
        GIL-bound is paid once per batch, and the GEMM leg (GIL released)
        is wide enough to genuinely overlap another worker's Python.

        Fallback semantics per round match evaluate(): unknown hosts or a
        scorer failure degrade that round to the base score, never the
        batch."""
        # one bundle read for the WHOLE batch: every round in this call
        # scores on the same model even if a swap lands mid-batch
        deg = self.degradation
        if deg is not None and deg.base_only:
            # brownout rung 3: the whole batch serves base (evaluate() takes
            # the same gate per round — kept here so the batch never touches
            # the bundle/FFI machinery at all)
            return [self.evaluate(c, ps) for c, ps in rounds]
        bundle = self._serving
        if bundle is None or not bundle.ready:
            return [self.evaluate(c, ps) for c, ps in rounds]
        outs: list[np.ndarray | None] = [None] * len(rounds)
        prepared = []
        for i, (child, parents) in enumerate(rounds):
            if not parents:
                outs[i] = np.zeros(0, dtype=np.float32)
                continue
            feats, c, p, known = self._prepare(child, parents, bundle)
            if c is None:
                self._count_fallback("unknown_hosts")
                outs[i] = self._base_from(feats)
                self._shadow_score(child, parents, feats, outs[i])
                self._record_decision(child, parents, feats, outs[i])
            else:
                prepared.append((i, feats, c, p, known))
        if not prepared:
            return outs
        bundle.begin()
        try:
            scorer = bundle.thread_scorer()
            if len(prepared) == 1 or not hasattr(scorer, "score_rounds"):
                single = True
            else:
                single = False
                widths = [len(c) for _i, _f, c, _p, _k in prepared]
                B = max(widths)
                M = len(prepared)
                fp = prepared[0][1].shape[1]
                mf = np.zeros((M, B, fp), np.float32)
                mc = np.zeros((M, B), np.int32)
                mp = np.zeros((M, B), np.int32)
                for m, (_i, f, c, p, _k) in enumerate(prepared):
                    mf[m, : widths[m]] = f
                    mc[m, : widths[m]] = c
                    mp[m, : widths[m]] = p
                try:
                    ml_rounds = scorer.score_rounds(mf, child=mc, parent=mp)
                except Exception:
                    # one bad round (stale node index) rejects the flat batch —
                    # retry per round below so the culprit degrades alone
                    logger.exception("batched ml scoring failed; retrying per round")
                    single = True
            for m, (i, f, c, p, known) in enumerate(prepared):
                if single:
                    try:
                        ml = scorer.score(f, child=c, parent=p)
                    except Exception:
                        logger.exception("ml scorer failed; using base evaluator")
                        self._count_fallback("scorer_error")
                        outs[i] = self._base_from(f)
                        ch, ps = rounds[i]
                        self._record_decision(ch, ps, f, outs[i])
                        continue
                else:
                    ml = ml_rounds[m, : len(c)]
                if known is None:
                    outs[i] = np.asarray(ml, dtype=np.float32)
                else:
                    outs[i] = np.where(known, ml, self._base_from(f)).astype(np.float32)
                ch, ps = rounds[i]
                self._record_decision(ch, ps, f, outs[i], bundle=bundle)
        finally:
            bundle.end()
        if self._shadow is not None:
            # one batched candidate FFI for the whole batch's shadow rounds
            # (round order preserved — the tracker stride advances exactly
            # as the per-round leg would)
            self._shadow_score_batch(
                [
                    (rounds[i][0], rounds[i][1], f, outs[i])
                    for i, f, _c, _p, _known in prepared
                    if outs[i] is not None
                ]
            )
        return outs

    async def evaluate_async(self, child: Peer, parents: Sequence[Peer]) -> np.ndarray:
        """Micro-batched scoring: concurrent rounds on the event loop land in
        ONE native multi-round call; falls back to the sync path when no
        micro-batcher is attached, and to the base score on scorer errors."""
        deg = self.degradation
        if deg is not None and deg.base_only:
            return self.evaluate(child, parents)  # rung 3: base-only gate there
        bundle = self._serving
        mb = bundle.microbatch if bundle is not None else None
        if mb is None or not getattr(mb, "ready", False):
            return self.evaluate(child, parents)
        if not parents:
            return np.zeros(0, dtype=np.float32)
        feats, c, p, known = self._prepare(child, parents, bundle)
        if c is None:
            self._count_fallback("unknown_hosts")
            out = self._base_from(feats)
            self._shadow_score(child, parents, feats, out)
            self._record_decision(child, parents, feats, out)
            return out
        # the refcount spans the await: the coalesced flush scores on this
        # bundle's primary scorer, which must not be freed under it
        bundle.begin()
        try:
            ml = await mb.score(feats, child=c, parent=p)
        except Exception:
            logger.exception("micro-batched ml scorer failed; using base evaluator")
            self._count_fallback("scorer_error")
            out = self._base_from(feats)
            self._shadow_score(child, parents, feats, out)
            self._record_decision(child, parents, feats, out)
            return out
        finally:
            bundle.end()
        if known is None:
            out = np.asarray(ml, dtype=np.float32)
        else:
            out = np.where(known, ml, self._base_from(feats)).astype(np.float32)
        self._shadow_score(child, parents, feats, out)
        self._record_decision(child, parents, feats, out, bundle=bundle)
        return out


def new_evaluator(algorithm: str = "base", **kw) -> Evaluator:
    """Factory (ref evaluator.go:35-54): "base" | "ml" |
    "plugin:pkg.mod:attr"; unknown → base.

    "ml" without a scorer starts in base-fallback mode and upgrades when
    attach_scorer() is called (the scheduler boots before any model exists).
    "plugin:" loads an external evaluator by import path (the reference's
    dlopen plugin slot, evaluator/plugin.go:1-39) and duck-checks its
    interface at boot.
    """
    if algorithm == "ml":
        return MLEvaluator(kw.get("scorer"), kw.get("node_index"))
    if algorithm.startswith("plugin:"):
        from dragonfly2_tpu_torch.utils.plugins import load_object, require_methods

        spec = algorithm[len("plugin:"):]
        obj = load_object(spec, **kw)
        require_methods(obj, ("evaluate", "is_bad_node"), spec=spec, kind="evaluator")
        if not callable(getattr(obj, "evaluate_async", None)):
            # the async scheduling path calls evaluate_async; plugins that
            # only implement the sync pair get a delegating shim so they
            # still fail (or work) at boot, never mid-round
            class _SyncPluginShim:
                def __init__(self, inner):
                    self._inner = inner

                def __getattr__(self, name):
                    return getattr(self._inner, name)

                async def evaluate_async(self, child, parents):
                    return self._inner.evaluate(child, parents)

            obj = _SyncPluginShim(obj)
        return obj
    if algorithm != "base":
        logger.warning("unknown evaluator %r, using base", algorithm)
    return Evaluator()
