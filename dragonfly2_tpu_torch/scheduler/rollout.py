"""Safe-rollout primitives for live serving models: the port's own copy of
dragonfly2_tpu/scheduler/rollout.py.

Without them the telemetry→train→register→infer loop would be *trusting*:
whatever version the registry marked active would be attached mid-traffic,
with no quality gate, no artifact integrity check, and no way back. This
module holds the pieces the safe-rollout state machine is built from:

  ModelBundle       one immutable served model (scorer + node index + serving
                    facades) published as a SINGLE evaluator attribute — a
                    scheduling round reads the bundle once at entry and scores
                    entirely through it, so a hot-swap mid-round can never
                    produce a torn old/new score mix. Per-round begin/end
                    refcounting tells the swapper when a replaced bundle has
                    drained (its native forks are only freed then).

  ShadowTracker     thread-safe per-round divergence accumulation between the
                    SERVED scores and a candidate model's scores: top-k
                    overlap, rank correlation, score-delta histogram. Workers
                    of the RoundDispatcher record concurrently; snapshot()
                    produces the report the scheduler ships to the manager's
                    rollout state machine.

  DivergenceGates   the promotion criterion: a shadow window of >= min_rounds
                    whose aggregate divergence stays inside the configured
                    bounds. Evaluated manager-side (rollout state machine)
                    and unit-testable here.

  HealthGates /     post-swap regression detection: base-fallback rate,
  PostSwapHealth    scoring latency, and scorer-error rate compared against a
                    baseline captured just before the swap. A regression
                    triggers the ManagerLink's auto-rollback onto the
                    previous bundle, which is kept warm for exactly this.

Registry states (manager-side, stored on the models row):

    candidate → shadowing → active | rejected        (promotion path)
    active → rejected (+ previous re-activated)      (rollback path)

The ml loop's serving side (scheduler/evaluator.py MLEvaluator) consumes
ModelBundle/ShadowTracker; the control side (scheduler/manager_link.py)
drives verification, swap, reporting, and rollback.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

# Registry rollout states (manager/service.py enforces the transitions; the
# constants live here so scheduler + manager + CLI share one vocabulary).
STATE_CANDIDATE = "candidate"
STATE_SHADOWING = "shadowing"
STATE_ACTIVE = "active"
STATE_INACTIVE = "inactive"
STATE_REJECTED = "rejected"

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


@dataclass
class DivergenceGates:
    """Promotion criterion for a shadow window (manager-side evaluation).

    A candidate promotes only after min_rounds shadow-scored rounds whose
    AGGREGATE divergence stays inside every bound; a window that finishes
    outside any bound rejects it. Bounds are tuned loose by default — the
    point of the gate is catching a *broken* train run (constant scores,
    exploded head, wrong host index), not enforcing agreement with the old
    model (a genuinely better model legitimately reorders parents).
    """

    min_rounds: int = 200
    min_topk_overlap: float = 0.25   # mean fraction of top-k parents shared
    min_rank_corr: float = 0.0       # mean Spearman rank correlation
    max_mean_abs_delta: float = 2.0  # mean |served - candidate| score gap
    max_error_rate: float = 0.01     # candidate scorer exceptions / round
    # rounds the candidate could not score at all (hosts unknown to its
    # graph) don't contribute divergence; too many of them means the shadow
    # evidence is about a different population than the traffic
    max_uncovered_rate: float = 0.75

    def to_dict(self) -> dict:
        return {
            "min_rounds": self.min_rounds,
            "min_topk_overlap": self.min_topk_overlap,
            "min_rank_corr": self.min_rank_corr,
            "max_mean_abs_delta": self.max_mean_abs_delta,
            "max_error_rate": self.max_error_rate,
            "max_uncovered_rate": self.max_uncovered_rate,
        }

    @classmethod
    def from_dict(cls, d: dict | None) -> "DivergenceGates":
        if not d:
            return cls()
        kw = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**kw)

    def evaluate(self, report: dict) -> tuple[bool | None, list[str]]:
        """(verdict, reasons) for an aggregate shadow report (the shape
        ShadowTracker.snapshot() / merge_reports() produce). verdict None =
        window not finished (keep shadowing); True = promote; False =
        reject, with the failed bounds named."""
        rounds = int(report.get("rounds", 0))
        attempts = rounds + int(report.get("errors", 0))
        observed = attempts + int(report.get("uncovered", 0))
        if observed < self.min_rounds:
            return None, [f"window {observed}/{self.min_rounds} rounds"]
        reasons: list[str] = []
        err_rate = report.get("errors", 0) / max(1, attempts)
        if err_rate > self.max_error_rate:
            reasons.append(f"error_rate {err_rate:.4f} > {self.max_error_rate}")
        unc_rate = report.get("uncovered", 0) / max(1, observed)
        if unc_rate > self.max_uncovered_rate:
            reasons.append(f"uncovered_rate {unc_rate:.3f} > {self.max_uncovered_rate}")
        if rounds > 0:
            if report.get("topk_overlap_mean", 0.0) < self.min_topk_overlap:
                reasons.append(
                    f"topk_overlap {report.get('topk_overlap_mean', 0.0):.3f}"
                    f" < {self.min_topk_overlap}"
                )
            if report.get("rank_corr_mean", 0.0) < self.min_rank_corr:
                reasons.append(
                    f"rank_corr {report.get('rank_corr_mean', 0.0):.3f}"
                    f" < {self.min_rank_corr}"
                )
            if report.get("abs_delta_mean", 0.0) > self.max_mean_abs_delta:
                reasons.append(
                    f"abs_delta {report.get('abs_delta_mean', 0.0):.4f}"
                    f" > {self.max_mean_abs_delta}"
                )
        elif attempts == 0:
            # the whole window was uncovered — no divergence evidence at all
            reasons.append("no scorable rounds in window")
        return (not reasons), reasons


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
    bucket bound). Delegates to the ONE shared bucket-quantile
    (observability/timeseries.bucket_quantile) so the same distribution
    never reads differently from `dfmodel status` vs /debug/ts. None when
    the histogram is empty."""
    from dragonfly2_tpu_torch.observability.timeseries import bucket_quantile

    total = sum(counts)
    if total <= 0:
        return None
    # the shared helper takes finite-bucket counts; mass in the overflow
    # slot pushes the quantile past them and answers the last bucket bound
    return bucket_quantile(
        DELTA_BUCKETS, [float(c) for c in counts[: len(DELTA_BUCKETS)]], total, q
    )


def merge_reports(reports: list[dict]) -> dict:
    """Aggregate per-scheduler shadow reports into one cluster-wide window
    (rounds-weighted means, summed counters, elementwise histogram). The
    manager's rollout state machine gates on THIS, so every federation
    member's traffic counts toward the same window."""
    out: dict[str, Any] = {
        "rounds": 0, "uncovered": 0, "errors": 0, "seen": 0,
        "topk_overlap_mean": 0.0, "topk_overlap_min": None,
        "rank_corr_mean": 0.0,
        "abs_delta_mean": 0.0, "abs_delta_p99": None, "abs_delta_max": 0.0,
        "delta_hist": {"buckets": list(DELTA_BUCKETS),
                       "counts": [0] * (len(DELTA_BUCKETS) + 1)},
        "slices": {}, "worst_slice": None,
    }
    slices: dict[str, list[float]] = {}  # key -> [n, ov*n, corr*n, delta*n, min]
    for r in reports:
        n = int(r.get("rounds", 0))
        out["rounds"] += n
        out["uncovered"] += int(r.get("uncovered", 0))
        out["errors"] += int(r.get("errors", 0))
        out["seen"] += int(r.get("seen", 0))
        out["topk_overlap_mean"] += r.get("topk_overlap_mean", 0.0) * n
        # cluster-wide worst round = min over every member's worst round
        mn = r.get("topk_overlap_min")
        if mn is not None:
            cur = out["topk_overlap_min"]
            out["topk_overlap_min"] = mn if cur is None else min(cur, mn)
        out["rank_corr_mean"] += r.get("rank_corr_mean", 0.0) * n
        out["abs_delta_mean"] += r.get("abs_delta_mean", 0.0) * n
        out["abs_delta_max"] = max(out["abs_delta_max"], r.get("abs_delta_max", 0.0))
        counts = (r.get("delta_hist") or {}).get("counts") or []
        if len(counts) == len(out["delta_hist"]["counts"]):
            out["delta_hist"]["counts"] = [
                a + int(b) for a, b in zip(out["delta_hist"]["counts"], counts)
            ]
        # population slices merge like the aggregates: rounds-weighted
        # means per key, min-of-mins for the worst round within the slice
        for key, sv in (r.get("slices") or {}).items():
            sn = int(sv.get("rounds", 0))
            if sn <= 0:
                continue
            acc = slices.setdefault(key, [0, 0.0, 0.0, 0.0, 1.0])
            acc[0] += sn
            acc[1] += sv.get("topk_overlap_mean", 0.0) * sn
            acc[2] += sv.get("rank_corr_mean", 0.0) * sn
            acc[3] += sv.get("abs_delta_mean", 0.0) * sn
            mn = sv.get("topk_overlap_min")
            if mn is not None:
                acc[4] = min(acc[4], mn)
    n = out["rounds"]
    if n:
        out["topk_overlap_mean"] /= n
        out["rank_corr_mean"] /= n
        out["abs_delta_mean"] /= n
    # per-round p99 recomputed from the MERGED histogram, not averaged from
    # members' p99s (a quantile of quantiles is not a quantile)
    out["abs_delta_p99"] = delta_hist_quantile(out["delta_hist"]["counts"], 0.99)
    out["slices"] = {
        k: {
            "rounds": a[0],
            "topk_overlap_mean": a[1] / a[0],
            "rank_corr_mean": a[2] / a[0],
            "abs_delta_mean": a[3] / a[0],
            "topk_overlap_min": a[4],
        }
        for k, a in slices.items()
    }
    out["worst_slice"] = min(
        slices, key=lambda k: slices[k][1] / slices[k][0], default=None
    )
    return out


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


@dataclass
class HealthSample:
    """One reading of the serving-health counters (deltas drive the gates).

    `source` is a registry-scoped counter set — scheduler/metrics.py
    ServiceMetrics, owned by ONE SchedulerService — so two services in the
    same process (federation tests, dfcluster-in-pytest) each window their
    OWN traffic; the process-global read survives as the source=None
    fallback for external probes."""

    rounds: float = 0.0        # scheduling rounds observed (histogram count)
    latency_total: float = 0.0  # histogram sum (seconds)
    fallbacks: float = 0.0     # base-fallback rounds, all reasons
    errors: float = 0.0        # scorer_error fallbacks

    @classmethod
    def capture(cls, source=None) -> "HealthSample":
        if source is not None:
            sd = source.schedule_duration.labels()
            return cls(
                rounds=float(sd.count),
                latency_total=float(sd.total),
                fallbacks=float(source.base_fallback.value),
                errors=float(source.base_fallback.labels(reason="scorer_error").value),
            )
        from dragonfly2_tpu_torch.scheduler import metrics

        sd = metrics.SCHEDULE_DURATION.labels()
        return cls(
            rounds=float(sd.count),
            latency_total=float(sd.total),
            fallbacks=float(metrics.ML_BASE_FALLBACK_TOTAL.value),
            errors=float(metrics.ML_BASE_FALLBACK_TOTAL.labels(reason="scorer_error").value),
        )


class PostSwapHealth:
    """Compares post-swap serving health against the pre-swap baseline.

    Built at swap time from the baseline WINDOW (the deltas observed since
    the previous model's attach, i.e. the rates the outgoing model actually
    served at) and the instant-of-swap counter values; check() returns
    None while the observation window is still open, (True, []) on a clean
    bill, (False, reasons) on a regression — the caller rolls back."""

    def __init__(
        self,
        gates: HealthGates,
        *,
        baseline_rates: dict[str, float] | None = None,
        at_swap: HealthSample | None = None,
        now: float | None = None,
        source=None,
    ):
        import time

        self.gates = gates
        self.baseline = baseline_rates or {}
        self.source = source  # registry-scoped ServiceMetrics (or None = global)
        self.at_swap = at_swap or HealthSample.capture(source)
        self.started = now if now is not None else time.monotonic()
        self.decided: bool | None = None

    @staticmethod
    def rates_of(before: HealthSample, after: HealthSample) -> dict[str, float]:
        """Per-round serving rates over a counter window."""
        rounds = max(0.0, after.rounds - before.rounds)
        if rounds <= 0:
            return {}
        return {
            "fallback_rate": max(0.0, after.fallbacks - before.fallbacks) / rounds,
            "error_rate": max(0.0, after.errors - before.errors) / rounds,
            "latency_mean": max(0.0, after.latency_total - before.latency_total) / rounds,
            "rounds": rounds,
        }

    def check(self, *, now: float | None = None) -> tuple[bool, list[str]] | None:
        import time

        if self.decided is not None:
            return self.decided, []
        now = now if now is not None else time.monotonic()
        cur = HealthSample.capture(self.source)
        rates = self.rates_of(self.at_swap, cur)
        rounds = rates.get("rounds", 0.0)
        window_done = rounds >= self.gates.min_rounds or (
            now - self.started >= self.gates.window_s and rounds > 0
        )
        if not window_done:
            return None
        reasons: list[str] = []
        base_fb = self.baseline.get("fallback_rate", 0.0)
        if rates["fallback_rate"] > base_fb + self.gates.max_fallback_rate_increase:
            reasons.append(
                f"fallback_rate {rates['fallback_rate']:.3f} > baseline "
                f"{base_fb:.3f} + {self.gates.max_fallback_rate_increase}"
            )
        base_err = self.baseline.get("error_rate", 0.0)
        if rates["error_rate"] > base_err + self.gates.max_error_rate_increase:
            reasons.append(
                f"error_rate {rates['error_rate']:.3f} > baseline "
                f"{base_err:.3f} + {self.gates.max_error_rate_increase}"
            )
        base_lat = self.baseline.get("latency_mean", 0.0)
        if base_lat > 0 and rates["latency_mean"] > base_lat * self.gates.max_latency_ratio:
            reasons.append(
                f"latency_mean {rates['latency_mean'] * 1e3:.2f}ms > "
                f"{self.gates.max_latency_ratio}x baseline {base_lat * 1e3:.2f}ms"
            )
        self.decided = not reasons
        return self.decided, reasons


@dataclass
class RolloutPolicy:
    """Manager-side rollout policy (the `model_rollout` config row): which
    model types go through the shadow gate, whether passing the gate
    promotes automatically, and the gate bounds themselves."""

    enabled: bool = False
    types: tuple[str, ...] = ("gnn",)
    auto_promote: bool = True
    gates: DivergenceGates = field(default_factory=DivergenceGates)

    @classmethod
    def from_config(cls, value: dict | None) -> "RolloutPolicy":
        if not value:
            return cls()
        return cls(
            enabled=bool(value.get("enabled", False)),
            types=tuple(value.get("types") or ("gnn",)),
            auto_promote=bool(value.get("auto_promote", True)),
            gates=DivergenceGates.from_dict(value.get("gates")),
        )

    def gated(self, model_type: str) -> bool:
        return self.enabled and model_type in self.types
