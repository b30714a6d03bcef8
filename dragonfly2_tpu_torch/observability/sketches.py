"""Streaming per-feature histogram sketches + PSI feature-drift scoring.

The port's own copy of ``FeatureSketch`` and ``psi`` from
dragonfly2_tpu/observability/sketches.py; the tests hold the two to the same
counts, dictionaries and PSI. The trainer freezes a sketch of the pair
features a dataset trains on (trainer/dataset.py) and ships it inside both
model artifacts (trainer/artifacts.py ``save_sketch``); a serving scheduler
compares live scoring features against it through ``DriftDetector``,
which the port's evaluator feeds (scheduler/evaluator.py ``_observe_drift``).

  FeatureSketch   one fixed-bin histogram per feature column, streaming and
                  bounded: (F, bins+2) int64 counts — underflow + overflow
                  bins catch values outside the normalized [lo, hi) band the
                  feature schema promises (models/features.py builds ~[0,1]).
                  update() is one vectorized bincount per matrix.

  psi()           Population Stability Index per feature between a reference
                  and a live sketch: sum((p-q) * ln(p/q)) over bins with
                  probability clamping. Conventional thresholds: < 0.1
                  stable, 0.1-0.25 moderate shift, > 0.25 major shift
                  (``classify_psi``).

  DriftDetector   the serving-side harness: the training-reference sketch
                  vs a live sketch fed with sampled feature matrices from
                  the evaluator's _prepare; every `compute_every` sampled
                  updates it recomputes PSI and exports
                  dragonfly_feature_drift{feature} and its _max gauge in
                  the port's registry.

Clock discipline: stamps come from an injected utils.clock.Clock, so the
same sketch runs under a virtual clock; drift "periodicity" is counted in
sampled updates, not wall seconds.

Thread safety: the evaluator's _prepare runs on round-dispatcher worker
threads; DriftDetector's update/observe/compute hold one small lock.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Mapping, Sequence

import numpy as np

from dragonfly2_tpu_torch.observability.metrics import default_registry
from dragonfly2_tpu_torch.utils.clock import SYSTEM, Clock

logger = logging.getLogger(__name__)

DEFAULT_BINS = 16
# PSI probability clamp: a bin empty on one side contributes a large-but-
# finite term instead of an infinity a single stray sample could produce
PSI_EPS = 1e-4
# conventional PSI decision thresholds
PSI_MODERATE = 0.1
PSI_MAJOR = 0.25

FEATURE_DRIFT = default_registry().gauge(
    "feature_drift",
    "PSI between the serving model's training-reference feature "
    "distribution and the live scoring distribution, per feature "
    "(observability/sketches.py; >0.25 = major population shift)",
    labels=("feature",),
)
FEATURE_DRIFT_MAX = default_registry().gauge(
    "feature_drift_max",
    "Max per-feature PSI vs the training reference (labeled per-feature "
    "detail in dragonfly_feature_drift)",
)


class FeatureSketch:
    """Fixed-bin streaming histogram over the columns of a feature matrix.

    Memory is BOUNDED by construction: (num_features, bins + 2) int64 —
    ~2.3 KB at the 16-feature x 16-bin default — regardless of how many rows
    ever stream through. Bin 0 is underflow (< lo), bin -1 overflow (>= hi);
    the interior bins split [lo, hi) uniformly. NaN rows land in overflow
    (a non-finite feature IS an anomaly worth seeing).
    """

    __slots__ = (
        "names", "lo", "hi", "bins", "counts", "rows", "created_at",
        "updated_at", "_clock", "_scale", "_col_offsets",
    )

    def __init__(
        self,
        num_features: int,
        *,
        names: Sequence[str] | None = None,
        bins: int = DEFAULT_BINS,
        lo: float = 0.0,
        hi: float = 1.0,
        clock: Clock | None = None,
    ):
        if names is not None and len(names) != num_features:
            raise ValueError(
                f"{len(names)} names for {num_features} features"
            )
        if hi <= lo:
            raise ValueError(f"bad sketch range [{lo}, {hi})")
        self.names = tuple(names) if names is not None else tuple(
            f"f{i}" for i in range(num_features)
        )
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)
        self.counts = np.zeros((num_features, bins + 2), np.int64)
        self.rows = 0
        self._clock = clock or SYSTEM
        self.created_at = self._clock.time()
        self.updated_at = self.created_at
        # hot-path precomputes: update() runs inside the scoring round at
        # stride-sampled cadence — every numpy dispatch avoided there counts
        self._scale = float(bins) / (self.hi - self.lo)
        self._col_offsets = (
            np.arange(num_features, dtype=np.int64) * (bins + 2)
        )[None, :]

    @property
    def num_features(self) -> int:
        return self.counts.shape[0]

    def _bin_indices(self, feats: np.ndarray) -> np.ndarray:
        # floor-then-int keeps negatives honest (plain int truncation would
        # send (-1, 0) to bin 0's interior side). The clip happens in FLOAT
        # space, BEFORE the int cast: a huge finite value (an epoch-ns
        # timestamp leaking through a broken normalization) overflows the
        # int64 cast to INT64_MIN and would masquerade as underflow —
        # clipped first, it lands on the overflow/underflow extreme it
        # actually belongs to.
        with np.errstate(invalid="ignore"):
            idxf = np.floor((feats - self.lo) * self._scale)
            np.clip(idxf, -1.0, float(self.bins), out=idxf)
            idx = idxf.astype(np.int64)
        idx += 1
        # NaN survives the float clip and casts to INT64_MIN; force it into
        # overflow — a non-finite feature IS an anomaly worth seeing. The
        # isfinite scan costs one vector pass.
        bad = ~np.isfinite(feats)
        if bad.any():
            idx[bad] = self.bins + 1
        return idx

    def update(self, feats: np.ndarray) -> int:
        """Fold a [rows, num_features] (or [num_features]) matrix in; returns
        rows folded. One flattened bincount — no Python per-row work."""
        f = np.asarray(feats)
        if f.ndim == 1:
            f = f[None, :]
        if f.shape[1] != self.num_features:
            raise ValueError(
                f"matrix has {f.shape[1]} features, sketch {self.num_features}"
            )
        if not len(f):
            return 0
        width = self.bins + 2
        # column-major flattening: one bincount covers every (column, bin)
        flat = self._bin_indices(f)
        flat += self._col_offsets
        self.counts += np.bincount(
            flat.ravel(), minlength=self.num_features * width
        ).reshape(self.num_features, width)
        self.rows += len(f)
        self.updated_at = self._clock.time()
        return len(f)

    def merge(self, other: "FeatureSketch") -> None:
        if (
            other.num_features != self.num_features
            or other.bins != self.bins
            or other.lo != self.lo
            or other.hi != self.hi
        ):
            raise ValueError("incompatible sketch layouts never merge")
        self.counts += other.counts
        self.rows += other.rows
        self.updated_at = self._clock.time()

    def distribution(self) -> np.ndarray:
        """Per-feature bin probabilities [num_features, bins+2] (uniform when
        the sketch is empty — PSI vs anything equally empty reads 0)."""
        totals = self.counts.sum(axis=1, keepdims=True).astype(np.float64)
        width = self.bins + 2
        out = np.full(self.counts.shape, 1.0 / width, np.float64)
        nz = totals[:, 0] > 0
        out[nz] = self.counts[nz] / totals[nz]
        return out

    # ---- (de)serialization: JSON-safe, shipped inside model artifacts ----

    def to_dict(self) -> dict:
        return {
            "names": list(self.names),
            "lo": self.lo,
            "hi": self.hi,
            "bins": self.bins,
            "rows": self.rows,
            "created_at": self.created_at,
            "counts": self.counts.tolist(),
        }

    @classmethod
    def from_dict(
        cls, d: Mapping, *, clock: Clock | None = None
    ) -> "FeatureSketch":
        counts = np.asarray(d["counts"], np.int64)
        sk = cls(
            counts.shape[0], names=d.get("names"), bins=int(d["bins"]),
            lo=float(d["lo"]), hi=float(d["hi"]), clock=clock,
        )
        if counts.shape != sk.counts.shape:
            raise ValueError(f"sketch counts shape {counts.shape} invalid")
        sk.counts = counts
        sk.rows = int(d.get("rows", int(counts[0].sum()) if len(counts) else 0))
        if "created_at" in d:
            sk.created_at = float(d["created_at"])
        return sk


def psi(
    reference: FeatureSketch, live: FeatureSketch, *, eps: float = PSI_EPS
) -> np.ndarray:
    """Per-feature Population Stability Index between two compatible
    sketches: sum((p - q) * ln(p / q)) over bins, probabilities clamped to
    `eps` so an empty-on-one-side bin contributes a large finite term."""
    if (
        reference.num_features != live.num_features
        or reference.bins != live.bins
        or reference.lo != live.lo
        or reference.hi != live.hi
    ):
        raise ValueError("incompatible sketch layouts never compare")
    p = np.clip(reference.distribution(), eps, None)
    q = np.clip(live.distribution(), eps, None)
    return np.sum((q - p) * np.log(q / p), axis=1)


class DriftDetector:
    """Training-reference vs live feature distribution, with PSI export.

    The evaluator calls observe(feats) on every prepared scoring round;
    every `sample_stride`-th call folds the matrix into the live sketch, and
    every `compute_every` folded updates the per-feature PSI is recomputed
    and exported (dragonfly_feature_drift{feature} + _max). Without a
    reference (no model attached, or a pre-sketch artifact) observe() is a
    None-check — the detector costs nothing until a sketch arrives.

    The live sketch RESETS whenever the reference changes (a new model's
    reference must not be compared against traffic scored under the old one)
    and decays by halving once live rows exceed `live_cap` — a bounded
    recency window in row count, not wall time (virtual-clock safe).
    """

    # The reference's defaults: 1 round in 32 folds into the live sketch,
    # PSI recomputes every 32 folds.
    def __init__(
        self,
        *,
        sample_stride: int = 32,
        compute_every: int = 32,
        live_cap: int = 200_000,
        clock: Clock | None = None,
        export: bool = True,
    ):
        self.sample_stride = max(1, int(sample_stride))
        self.compute_every = max(1, int(compute_every))
        self.live_cap = int(live_cap)
        self.export = export
        self._clock = clock or SYSTEM
        self._lock = threading.Lock()
        self._ref: FeatureSketch | None = None
        self._live: FeatureSketch | None = None
        self.reference_version = ""
        self._calls = 0
        self._folds = 0
        self.updates = 0
        self.computes = 0
        self._scores: np.ndarray | None = None
        self.computed_at: float | None = None

    @property
    def reference(self) -> FeatureSketch | None:
        return self._ref

    def set_reference(
        self, sketch: FeatureSketch | None, *, version: str = ""
    ) -> None:
        """Install (or clear, with None) the training-reference sketch —
        called by the model-install path with the artifact's sketch. Resets
        the live sketch and the exported scores."""
        with self._lock:
            old = self._ref
            self._ref = sketch
            self.reference_version = version if sketch is not None else ""
            self._live = None
            self._scores = None
            self.computed_at = None
            self._calls = 0
            self._folds = 0
        if self.export:
            # zero stale per-feature gauges — BOTH the outgoing reference's
            # features (a cleared detector must not leave last week's PSI
            # frozen on /metrics) and the incoming one's
            for sk in (old, sketch):
                if sk is not None:
                    for name in sk.names:
                        FEATURE_DRIFT.set(0.0, feature=name)
            FEATURE_DRIFT_MAX.set(0.0)
        logger.info(
            "feature-drift reference %s (%s)",
            "cleared" if sketch is None else "installed",
            version or "unversioned",
        )

    def observe(self, feats: np.ndarray) -> None:
        """Sampled live-sketch feed — the evaluator's per-round hook. Never
        raises (a drift bookkeeping bug must not fail a scheduling round)."""
        try:
            with self._lock:
                ref = self._ref
                if ref is None:
                    return
                self._calls += 1
                if self._calls % self.sample_stride:
                    return
                live = self._live
                if live is None:
                    live = self._live = FeatureSketch(
                        ref.num_features, names=ref.names, bins=ref.bins,
                        lo=ref.lo, hi=ref.hi, clock=self._clock,
                    )
                live.update(feats)
                self.updates += 1
                if self.live_cap > 0 and live.rows > self.live_cap:
                    # halve instead of reset: the window keeps shape while
                    # bounding the weight of ancient traffic
                    live.counts //= 2
                    live.rows = int(live.counts[0].sum()) if live.num_features else 0
                self._folds += 1
                if self._folds % self.compute_every == 0:
                    self._compute_locked()
        except Exception:
            logger.exception("feature-drift observe failed")

    def compute(self) -> dict[str, float] | None:
        """Force a PSI recompute now (tests / debug endpoints); returns the
        per-feature scores or None without reference/live data."""
        with self._lock:
            return self._compute_locked()

    def _compute_locked(self) -> dict[str, float] | None:
        # callers hold self._lock (observe()'s periodic trigger and
        # compute() both acquire it before entering)
        ref, live = self._ref, self._live
        if ref is None or live is None or live.rows == 0:
            return None
        scores = psi(ref, live)
        self._scores = scores  # dflint: disable=DF023 caller holds self._lock (see method docstring contract)
        self.computes += 1
        self.computed_at = self._clock.time()  # dflint: disable=DF023 caller holds self._lock
        if self.export:
            for name, s in zip(ref.names, scores):
                FEATURE_DRIFT.set(float(s), feature=name)
            FEATURE_DRIFT_MAX.set(float(scores.max()) if len(scores) else 0.0)
        return {n: float(s) for n, s in zip(ref.names, scores)}

    def scores(self) -> dict[str, float] | None:
        with self._lock:
            if self._scores is None or self._ref is None:
                return None
            return {
                n: float(s) for n, s in zip(self._ref.names, self._scores)
            }

    def max_score(self) -> float | None:
        with self._lock:
            if self._scores is None or not len(self._scores):
                return None
            return float(self._scores.max())

    def snapshot(self) -> dict:
        """JSON-safe state for /debug/decisions, dfml, and dfmodel status."""
        with self._lock:
            ref, live = self._ref, self._live
            scores = self._scores
            out: dict = {
                "reference_version": self.reference_version,
                "reference_rows": ref.rows if ref is not None else None,
                "live_rows": live.rows if live is not None else 0,
                "sample_stride": self.sample_stride,
                "compute_every": self.compute_every,
                "updates": self.updates,
                "computes": self.computes,
                "computed_at": self.computed_at,
            }
            if scores is not None and ref is not None:
                per = {n: round(float(s), 5) for n, s in zip(ref.names, scores)}
                out["psi"] = per
                out["psi_max"] = round(float(scores.max()), 5) if len(scores) else 0.0
                out["drifted"] = sorted(
                    n for n, s in per.items() if s > PSI_MAJOR
                )
            return out


def classify_psi(score: float) -> str:
    """Human label for one PSI score (README-documented thresholds)."""
    if not math.isfinite(score):
        return "invalid"
    if score > PSI_MAJOR:
        return "major"
    if score > PSI_MODERATE:
        return "moderate"
    return "stable"
