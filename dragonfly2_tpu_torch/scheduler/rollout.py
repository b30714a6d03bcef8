"""Safe-rollout primitives for live serving models, in part: the port of
the serving side of dragonfly2_tpu/scheduler/rollout.py, what the port's
evaluator (scheduler/evaluator.py) and a scheduler's ManagerLink touch
through the bundle protocol.

  ModelBundle       one immutable served model (scorer + node index + serving
                    facades) published as a SINGLE evaluator attribute — a
                    scheduling round reads the bundle once at entry and scores
                    entirely through it, so a hot-swap mid-round can never
                    produce a torn old/new score mix. Per-round begin/end
                    refcounting tells the swapper when a replaced bundle has
                    drained (its native forks are only freed then).

  ShadowTracker     thread-safe per-round divergence accumulation between the
                    SERVED scores and a candidate model's scores: top-k
                    overlap, rank correlation, score-delta histogram.

  round_divergence, delta_hist_quantile: the pure pieces the tracker is
                    built from.

  HealthGates       the post-swap regression bounds, the dataclass the
                    scheduler's YAML ``rollout:`` section builds
                    (scheduler/config.py).

Not ported yet: DivergenceGates and merge_reports (the promotion gate over
the federation's merged shadow reports), HealthSample, PostSwapHealth and
RolloutPolicy. They are decided in a scheduler's ManagerLink over this
tracker's snapshots, and the port's scheduler has no ManagerLink yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np

# Score-delta histogram buckets (absolute |served - candidate| per round
# mean). Scores are roughly unit-scale (base weights are normalized feature
# blends, the GNN head is trained on [0,1] labels), so these cover "noise"
# through "different model family".
DELTA_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0)


class ModelBundle:
    """One immutable served model: scorer + node index + serving facades.

    The evaluator publishes the CURRENT bundle as one attribute store
    (atomic under the GIL); every scoring entry reads it once and uses only
    that reference, which is the whole torn-mix proof: a round that started
    on bundle A finishes on bundle A even if B was attached mid-round.

    begin()/end() bracket each scoring call so the swapper can tell when a
    replaced bundle has DRAINED (quiesced) — only then may its native forked
    handles be freed (freeing a fork while a dispatcher worker is inside its
    FFI call is a use-after-free). close() is idempotent and refuses to run
    while rounds are active unless force=True.
    """

    __slots__ = (
        "scorer", "node_index", "microbatch", "handle_pool", "version",
        "drift_sketch", "drift_sketch_version",
        "_lock", "_active", "_closed",
    )

    def __init__(
        self, scorer, node_index: dict[str, int], *,
        version: str = "", microbatch=None, handle_pool=None,
    ):
        self.scorer = scorer
        self.node_index = node_index or {}
        self.microbatch = microbatch
        self.handle_pool = handle_pool
        self.version = version
        # the model's training-reference feature sketch rides the bundle so
        # an auto-rollback restores the previous model WITH its own drift
        # baseline (the warm bundle has no artifact path to re-load it from);
        # None = the artifact shipped no sketch
        self.drift_sketch = None
        self.drift_sketch_version = ""
        self._lock = threading.Lock()
        self._active = 0
        self._closed = False

    @property
    def ready(self) -> bool:
        return not self._closed and bool(getattr(self.scorer, "ready", False))

    def begin(self) -> None:
        with self._lock:
            self._active += 1

    def end(self) -> None:
        with self._lock:
            self._active -= 1

    @property
    def active_rounds(self) -> int:
        with self._lock:
            return self._active

    @property
    def quiesced(self) -> bool:
        with self._lock:
            return self._active == 0

    def thread_scorer(self):
        """The calling thread's scoring handle: its fork from the pool when
        sharded serving is on, else the primary scorer."""
        return self.scorer if self.handle_pool is None else self.handle_pool.get()

    def close(self, *, force: bool = False) -> bool:
        """Free the bundle's native resources (forked handles, then the
        primary). Returns False (and does nothing) while rounds are still
        inside the bundle, so callers poll drain-then-close."""
        with self._lock:
            if self._closed:
                return True
            if self._active > 0 and not force:
                return False
            self._closed = True
        if self.handle_pool is not None:
            self.handle_pool.close()
        close = getattr(self.scorer, "close", None)
        if callable(close):
            close()
        return True

    def __repr__(self) -> str:
        return (
            f"ModelBundle(version={self.version!r}, hosts={len(self.node_index)}, "
            f"active={self.active_rounds}, closed={self._closed})"
        )


def round_divergence(served: np.ndarray, candidate: np.ndarray, *, topk: int = 4) -> dict:
    """Per-round divergence between the scores that were SERVED and the
    candidate's scores for the same candidate set: top-k overlap fraction,
    Spearman rank correlation, mean absolute delta. Pure, unit-tested."""
    s = np.asarray(served, dtype=np.float64)
    c = np.asarray(candidate, dtype=np.float64)
    n = len(s)
    if n == 0 or c.shape != s.shape:
        raise ValueError(f"bad divergence shapes: {s.shape} vs {c.shape}")
    k = min(topk, n)
    top_s = set(np.argsort(-s, kind="stable")[:k].tolist())
    top_c = set(np.argsort(-c, kind="stable")[:k].tolist())
    overlap = len(top_s & top_c) / k
    if n < 2:
        corr = 1.0
    else:
        s_const = bool(np.ptp(s) == 0.0)
        c_const = bool(np.ptp(c) == 0.0)
        if s_const or c_const:
            # degenerate VALUES (argsort of a constant still yields ranks
            # 0..n-1, so detect on the scores themselves): two constant
            # vectors agree on every ordering; a constant vector against a
            # varying one carries no rank signal and scores 0 — the
            # conservative direction for a gate (a collapsed candidate head
            # is exactly what this catches)
            corr = 1.0 if (s_const and c_const) else 0.0
        else:
            rs = np.argsort(np.argsort(s, kind="stable"))
            rc = np.argsort(np.argsort(c, kind="stable"))
            corr = float(np.corrcoef(rs, rc)[0, 1])
    return {
        "topk_overlap": overlap,
        "rank_corr": corr,
        "abs_delta_mean": float(np.abs(s - c).mean()),
    }


class ShadowTracker:
    """Thread-safe shadow-window accumulator for ONE candidate version.

    Dispatcher worker threads record concurrently (one lock hold per round);
    snapshot() is what the scheduler ships to the manager each watch tick.
    Sampling is deterministic and thread-safe: round i is shadow-scored when
    floor(i*rate) advances — exactly rate of the traffic, no rng state."""

    def __init__(self, version: str, *, sample_rate: float = 1.0, topk: int = 4):
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(f"shadow sample_rate must be in (0,1], got {sample_rate}")
        self.version = version
        self.sample_rate = sample_rate
        self.topk = topk
        self._lock = threading.Lock()
        self._seen = 0
        self._sampled = 0
        self.rounds = 0        # rounds with recorded divergence
        self.uncovered = 0     # sampled rounds the candidate couldn't score
        self.errors = 0        # candidate scorer exceptions
        self._sum_overlap = 0.0
        self._sum_corr = 0.0
        self._sum_delta = 0.0
        self._max_delta = 0.0
        # worst-round slicing: the aggregate means hide
        # a candidate that is fine on average but catastrophic on 1% of
        # rounds — track the single worst top-k overlap, and derive a
        # per-round delta p99 from the bucketed histogram at snapshot time
        self._min_overlap: float | None = None
        self._delta_counts = [0] * (len(DELTA_BUCKETS) + 1)
        # population slicing: the same aggregate means
        # also hide a candidate that diverges ONLY for one child population —
        # a region whose topology features the candidate re-weights, or the
        # small-pool regime where one rank flip swings the whole top-k.
        # Callers pass a slice key ("region|peer-band"); per-slice overlap /
        # rank-corr accumulate here and the worst slice surfaces in dfmodel.
        self._slices: dict[str, list[float]] = {}  # key -> [n, ov, corr, delta, min_ov]

    def should_sample(self) -> bool:
        """Claim the next round for shadow scoring iff the sampler picks it."""
        with self._lock:
            self._seen += 1
            want = int(self._seen * self.sample_rate)
            if want > self._sampled:
                self._sampled += 1
                return True
            return False

    def record(self, served: np.ndarray, candidate: np.ndarray,
               slice_key: str | None = None) -> dict:
        d = round_divergence(served, candidate, topk=self.topk)
        delta = d["abs_delta_mean"]
        bucket = len(DELTA_BUCKETS)
        for i, b in enumerate(DELTA_BUCKETS):
            if delta <= b:
                bucket = i
                break
        with self._lock:
            self.rounds += 1
            self._sum_overlap += d["topk_overlap"]
            self._sum_corr += d["rank_corr"]
            self._sum_delta += delta
            self._max_delta = max(self._max_delta, delta)
            ov = d["topk_overlap"]
            self._min_overlap = ov if self._min_overlap is None else min(self._min_overlap, ov)
            self._delta_counts[bucket] += 1
            if slice_key is not None:
                s = self._slices.get(slice_key)
                if s is None:
                    s = self._slices[slice_key] = [0, 0.0, 0.0, 0.0, ov]
                s[0] += 1
                s[1] += ov
                s[2] += d["rank_corr"]
                s[3] += delta
                s[4] = min(s[4], ov)
        self._export_metrics(d)
        return d

    def record_uncovered(self) -> None:
        with self._lock:
            self.uncovered += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def _export_metrics(self, d: dict) -> None:
        from dragonfly2_tpu_torch.scheduler import metrics

        metrics.SHADOW_ROUNDS_TOTAL.inc()
        metrics.SHADOW_SCORE_DELTA.observe(d["abs_delta_mean"])
        with self._lock:
            n = max(1, self.rounds)
            overlap, corr = self._sum_overlap / n, self._sum_corr / n
        metrics.SHADOW_TOPK_OVERLAP.set(overlap)
        metrics.SHADOW_RANK_CORR.set(corr)

    def snapshot(self) -> dict:
        """The divergence report for this window so far (manager-mergeable)."""
        with self._lock:
            n = self.rounds
            return {
                "version": self.version,
                "sample_rate": self.sample_rate,
                "seen": self._seen,
                "rounds": n,
                "uncovered": self.uncovered,
                "errors": self.errors,
                "topk_overlap_mean": self._sum_overlap / n if n else 0.0,
                # worst single round: 0.0 here means at least one round where
                # served and candidate agreed on NO top-k parent
                "topk_overlap_min": self._min_overlap if n else None,
                "rank_corr_mean": self._sum_corr / n if n else 0.0,
                "abs_delta_mean": self._sum_delta / n if n else 0.0,
                "abs_delta_p99": delta_hist_quantile(self._delta_counts, 0.99),
                "abs_delta_max": self._max_delta,
                "delta_hist": {
                    "buckets": list(DELTA_BUCKETS),
                    "counts": list(self._delta_counts),
                },
                "slices": {
                    k: {
                        "rounds": s[0],
                        "topk_overlap_mean": s[1] / s[0],
                        "rank_corr_mean": s[2] / s[0],
                        "abs_delta_mean": s[3] / s[0],
                        "topk_overlap_min": s[4],
                    }
                    for k, s in self._slices.items()
                },
                "worst_slice": min(
                    self._slices, key=lambda k: self._slices[k][1] / self._slices[k][0],
                    default=None,
                ),
            }


def delta_hist_quantile(counts: Sequence[int], q: float) -> float | None:
    """Per-round |delta| quantile from the DELTA_BUCKETS histogram counts
    (last slot = overflow past the final bucket, answered with the final
    bucket bound), by the reference's observability/timeseries
    bucket_quantile (copied below as _bucket_quantile). None when the
    histogram is empty."""
    total = sum(counts)
    if total <= 0:
        return None
    # the shared helper takes finite-bucket counts; mass in the overflow
    # slot pushes the quantile past them and answers the last bucket bound
    return _bucket_quantile(
        DELTA_BUCKETS, [float(c) for c in counts[: len(DELTA_BUCKETS)]], total, q
    )


def _bucket_quantile(
    buckets: tuple, dcounts: list[float], total: float, q: float
) -> float:
    """Quantile from bucketed counts, linearly interpolated inside the
    landing bucket (lower bound = previous bucket's upper bound, 0 for the
    first). Observations past the last finite bucket answer with that
    bucket's bound — the honest ceiling of what bucketed data can say.
    The port's copy of dragonfly2_tpu/observability/timeseries.py's
    bucket_quantile."""
    if total <= 0:
        return 0.0
    want = q * total
    cum = 0.0
    lo = 0.0
    for b, c in zip(buckets, dcounts):
        if cum + c >= want and c > 0:
            frac = (want - cum) / c
            return lo + (b - lo) * min(1.0, max(0.0, frac))
        cum += c
        lo = b
    return float(buckets[-1]) if buckets else 0.0


@dataclass
class HealthGates:
    """Post-swap regression bounds (scheduler-side auto-rollback trigger).

    Evaluated once per watch tick against deltas of the scheduler's own
    serving metrics since the swap; the first tick at/after min_rounds
    observed rounds (or window_s elapsed with at least one round) decides.
    Rate bounds are ABSOLUTE-increase bounds over the pre-swap baseline
    rate: a cluster already serving 10% base fallback doesn't rollback a
    model that holds 10%."""

    window_s: float = 60.0
    min_rounds: int = 50
    max_fallback_rate_increase: float = 0.2   # base-fallback per round
    max_error_rate_increase: float = 0.05     # scorer_error fallbacks per round
    max_latency_ratio: float = 5.0            # mean round latency vs baseline
