"""Streaming per-feature histogram sketches + PSI feature-drift scoring.

The port's own copy of ``FeatureSketch`` and ``psi`` from
dragonfly2_tpu/observability/sketches.py; the tests hold the two to the same
counts, dictionaries and PSI. The trainer freezes a sketch of the pair
features a dataset trains on (trainer/dataset.py) and ships it inside both
model artifacts (trainer/artifacts.py ``save_sketch``); a serving scheduler
compares live scoring features against it. The serving-side
``DriftDetector`` and its gauges come with the wiring slice.

  FeatureSketch   one fixed-bin histogram per feature column, streaming and
                  bounded: (F, bins+2) int64 counts — underflow + overflow
                  bins catch values outside the normalized [lo, hi) band the
                  feature schema promises (models/features.py builds ~[0,1]).
                  update() is one vectorized bincount per matrix.

  psi()           Population Stability Index per feature between a reference
                  and a live sketch: sum((p-q) * ln(p/q)) over bins with
                  probability clamping. Conventional thresholds: < 0.1
                  stable, 0.1-0.25 moderate shift, > 0.25 major shift.

Clock discipline: stamps come from an injected utils.clock.Clock, so the
same sketch runs under a virtual clock.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from dragonfly2_tpu_torch.utils.clock import SYSTEM, Clock

DEFAULT_BINS = 16
# PSI probability clamp: a bin empty on one side contributes a large-but-
# finite term instead of an infinity a single stray sample could produce
PSI_EPS = 1e-4


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
