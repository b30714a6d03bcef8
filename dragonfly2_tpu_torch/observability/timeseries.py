"""Time-series layer above /metrics: bounded in-process rings + rate queries.

The port's own copy of dragonfly2_tpu/observability/timeseries.py.

Every number the services export today is an instantaneous process-local
value: the Prometheus text endpoint (observability/metrics.py) answers "what
is the counter NOW", never "how fast is it moving" or "what did the last ten
minutes look like". The reference assumes an external Prometheus/Grafana
stack stores that history; this reproduction has no such luxury — honest
throughput accounting needs windowed rates, not lifetime totals, and the
rollout health gates, SLO alerts, and dftop all read windows.

MetricsRecorder samples a MetricsRegistry every ~2 s into one bounded ring
per (metric family, label set):

  counters    cumulative values; rate() sums adjacent deltas over the query
              window (each delta clamped >= 0, so a counter reset after an
              in-process service restart reads as a missing interval, not a
              huge negative rate)
  gauges      raw values; latest()/window mean
  histograms  cumulative (count, sum, per-bucket counts); hist_window()
              subtracts the oldest in-window sample from the newest and
              interpolates p50/p95 from the bucket deltas — a TRUE windowed
              quantile, not the lifetime one the text endpoint implies

Bounds are hard: retention_s/interval samples per ring (default ~10 min),
max_series label sets total — past the cap new series are counted in
`dropped_series` and never allocated, so a label-cardinality accident costs
a counter, not the heap. Sampling cost is measured every tick
(`last_sample_cost_us`).

Consumed by observability/alerts.py (SLO rules) and build_stats_frame() —
the compact per-service frame the manager aggregates cluster-wide (rpc
`cluster_stats`). The reference also serves it at GET /debug/ts and in
dftop; the port has neither yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Iterable, Mapping

from dragonfly2_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)

DEFAULT_INTERVAL_S = 2.0
DEFAULT_RETENTION_S = 600.0
DEFAULT_MAX_SERIES = 4096
DEFAULT_WINDOW_S = 60.0


class _Series:
    """One (family, label set) ring. Points are tuples:
    scalar kinds (counter/gauge): (t, value)
    histogram: (t, count, total, bucket_counts_tuple)"""

    __slots__ = ("kind", "labels", "buckets", "points")

    def __init__(self, kind: str, labels: tuple, samples_cap: int, buckets=None):
        self.kind = kind
        self.labels = labels  # ((k, v), ...) sorted
        self.buckets = buckets  # histogram upper bounds, else None
        self.points: deque = deque(maxlen=samples_cap)


def _labels_match(series_labels: tuple, want: Mapping[str, str] | None) -> bool:
    """want=None matches everything; otherwise every given (k, v) must be
    present in the series' label set (partial match → aggregation over the
    remaining labels, the PromQL sum-by shape)."""
    if not want:
        return True
    have = dict(series_labels)
    return all(have.get(k) == str(v) for k, v in want.items())


class MetricsRecorder:
    """Samples one MetricsRegistry into bounded per-series rings.

    start() schedules the sampler on the running event loop (call_later,
    the loophealth pattern — sampling on the loop keeps the walk free of
    cross-thread registry surprises and costs ~one tick per interval);
    sample_once() is the synchronous entry tests and bench use directly.
    All query methods are thread-safe (alert engines and RPC handlers read
    while the loop samples).
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        interval: float = DEFAULT_INTERVAL_S,
        retention_s: float = DEFAULT_RETENTION_S,
        max_series: int = DEFAULT_MAX_SERIES,
    ):
        self.registry = registry or default_registry()
        self.interval = interval
        self.retention_s = retention_s
        self.max_series = max_series
        # ring length = retention/interval, clamped: a fast interval (smoke
        # cadences, stress probes) with the default 10-min retention must
        # not balloon every ring to tens of thousands of points — 4096
        # points is the hard per-series ceiling, retention shrinks to fit
        self._samples_cap = max(2, min(4096, int(retention_s / max(interval, 1e-3)) + 1))
        self._series: dict[tuple, _Series] = {}
        self._lock = threading.Lock()
        self._handle: Any = None
        self.samples = 0
        # DISTINCT refused series (not refusals-per-tick: re-counting the
        # same over-cap label set every 2 s would report an 18k-series
        # "explosion" after an hour when exactly 10 were ever refused). The
        # tracking set is itself bounded at 4x max_series — past that the
        # count undercounts and the overflow flag says so.
        self._dropped_keys: set[tuple] = set()
        self.dropped_overflow = False
        self.last_sample_cost_us = 0.0
        self.started_at = 0.0

    @property
    def dropped_series(self) -> int:
        return len(self._dropped_keys)

    # ---- sampling ----

    def sample_once(self, now: float | None = None) -> float:
        """One full registry walk; returns the walk's cost in seconds."""
        t0 = time.perf_counter()
        t = now if now is not None else time.time()
        for fam in self.registry.families():
            if isinstance(fam, Histogram):
                kind = "histogram"
            elif isinstance(fam, Counter):
                kind = "counter"
            elif isinstance(fam, Gauge):
                kind = "gauge"
            else:
                continue
            for key, child in fam._snapshot_children():
                skey = (fam.name, key)
                s = self._series.get(skey)
                if s is None:
                    with self._lock:
                        s = self._series.get(skey)
                        if s is None:
                            if len(self._series) >= self.max_series:
                                if len(self._dropped_keys) < 4 * self.max_series:
                                    self._dropped_keys.add(skey)
                                else:
                                    self.dropped_overflow = True
                                continue
                            s = self._series[skey] = _Series(
                                kind,
                                tuple(sorted(fam._labels_of(key).items())),
                                self._samples_cap,
                                buckets=getattr(fam, "buckets", None),
                            )
                if kind == "histogram":
                    # snapshot under the child lock — same torn-histogram
                    # rule Histogram.render follows
                    with child._lock:  # type: ignore[attr-defined]
                        point = (
                            t,
                            child.count,  # type: ignore[attr-defined]
                            child.total,  # type: ignore[attr-defined]
                            tuple(child.counts),  # type: ignore[attr-defined]
                        )
                else:
                    point = (t, float(child.value))  # type: ignore[attr-defined]
                s.points.append(point)
        self.samples += 1
        cost = time.perf_counter() - t0
        self.last_sample_cost_us = cost * 1e6
        return cost

    def start(self) -> None:
        """Begin sampling on the RUNNING loop. Idempotent."""
        import asyncio

        if self._handle is not None:
            return
        loop = asyncio.get_running_loop()
        self.started_at = time.time()
        self._handle = loop.call_later(self.interval, self._tick, loop)

    def stop(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    @property
    def running(self) -> bool:
        return self._handle is not None

    def _tick(self, loop) -> None:
        try:
            self.sample_once()
        except Exception:  # noqa: BLE001 — a torn family must not kill sampling
            import logging

            logging.getLogger(__name__).exception("timeseries sample failed")
        self._handle = loop.call_later(self.interval, self._tick, loop)

    # ---- queries ----

    def _matching(self, name: str, labels: Mapping[str, str] | None) -> list[_Series]:
        with self._lock:
            return [
                s
                for (fam_name, _key), s in self._series.items()
                if fam_name == name and _labels_match(s.labels, labels)
            ]

    def _window_points(self, s: _Series, window_s: float, now: float) -> list:
        cutoff = now - window_s
        # list(deque) is one GIL-held C call — the atomic snapshot that lets
        # alert engines / RPC handlers read while the loop thread appends
        # (iterating the live deque would RuntimeError on a concurrent append)
        return [p for p in list(s.points) if p[0] >= cutoff]

    def rate(
        self,
        name: str,
        labels: Mapping[str, str] | None = None,
        *,
        window_s: float = DEFAULT_WINDOW_S,
        now: float | None = None,
    ) -> float | None:
        """Per-second increase of a counter (or a histogram's observation
        count) over the window, summed across matching label sets. Each
        adjacent delta is clamped >= 0 so a counter reset costs the one
        interval it happened in, never a negative rate. None when no series
        has >= 2 in-window samples (absent != zero — callers distinguish
        "no data" from "rate 0")."""
        now = now if now is not None else time.time()
        total = 0.0
        span = 0.0
        seen = False
        for s in self._matching(name, labels):
            pts = self._window_points(s, window_s, now)
            if len(pts) < 2:
                continue
            seen = True
            # p[1] is the counter/gauge value — or, for histogram points,
            # the observation count: one extraction serves every kind
            vals = [p[1] for p in pts]
            for a, b in zip(vals, vals[1:]):
                total += max(0.0, b - a)
            span = max(span, pts[-1][0] - pts[0][0])
        if not seen or span <= 0:
            return None
        return total / span

    def latest(
        self, name: str, labels: Mapping[str, str] | None = None
    ) -> float | None:
        """Most recent sampled value, summed across matching label sets
        (gauges/counters; histograms answer with their observation count)."""
        out = None
        for s in self._matching(name, labels):
            if not s.points:
                continue
            p = s.points[-1]
            v = float(p[1])
            out = v if out is None else out + v
        return out

    def hist_window(
        self,
        name: str,
        labels: Mapping[str, str] | None = None,
        *,
        window_s: float = DEFAULT_WINDOW_S,
        now: float | None = None,
        q: float | None = None,
    ) -> dict | None:
        """Windowed histogram summary: observation count/rate, mean, and
        bucket-interpolated p50/p95 over the window's bucket-count deltas
        (merged across matching label sets). `q` adds a "pq" key with that
        quantile (the alert engine's arbitrary-q entry). None when no data."""
        now = now if now is not None else time.time()
        buckets: tuple | None = None
        dcounts: list[float] | None = None
        count_d = 0.0
        total_d = 0.0
        span = 0.0
        for s in self._matching(name, labels):
            if s.kind != "histogram" or s.buckets is None:
                continue
            pts = self._window_points(s, window_s, now)
            if len(pts) < 2:
                continue
            first, last = pts[0], pts[-1]
            if buckets is None:
                buckets = s.buckets
                dcounts = [0.0] * len(buckets)
            if s.buckets != buckets or dcounts is None:
                continue  # incompatible bucket layouts never merge
            count_d += max(0.0, last[1] - first[1])
            total_d += max(0.0, last[2] - first[2])
            for i, (a, b) in enumerate(zip(first[3], last[3])):
                dcounts[i] += max(0.0, b - a)
            span = max(span, last[0] - first[0])
        if buckets is None or dcounts is None or span <= 0:
            return None
        # Histogram bucket counts are CUMULATIVE-le (observe() increments
        # EVERY bucket whose bound covers the value), so the windowed deltas
        # are cumulative too — difference adjacent deltas into the disjoint
        # per-bucket masses bucket_quantile expects. Feeding it the
        # cumulative vector deflated every windowed quantile the moment a
        # window's observations spanned more than one bucket.
        masses = [
            max(0.0, dcounts[i] - (dcounts[i - 1] if i else 0.0))
            for i in range(len(dcounts))
        ]
        out = {
            "count": count_d,
            "rate_per_s": count_d / span,
            "mean": (total_d / count_d) if count_d else 0.0,
            "p50": bucket_quantile(buckets, masses, count_d, 0.50),
            "p95": bucket_quantile(buckets, masses, count_d, 0.95),
            "window_s": span,
        }
        if q is not None:
            out["pq"] = bucket_quantile(buckets, masses, count_d, q)
        return out

    def series(self) -> list[dict]:
        with self._lock:
            items = list(self._series.items())
        return [
            {
                "name": name,
                "labels": dict(s.labels),
                "kind": s.kind,
                "points": len(s.points),
            }
            for (name, _key), s in items
        ]

    def query(
        self,
        name: str,
        labels: Mapping[str, str] | None = None,
        *,
        since: float | None = None,
    ) -> list[dict]:
        """Raw points for matching series (the /debug/ts range API)."""
        out = []
        for s in self._matching(name, labels):
            pts: Iterable = list(s.points)  # atomic snapshot (see _window_points)
            if since is not None:
                pts = [p for p in pts if p[0] >= since]
            if s.kind == "histogram":
                points = [
                    {"t": p[0], "count": p[1], "sum": p[2]} for p in pts
                ]
            else:
                points = [{"t": p[0], "value": p[1]} for p in pts]
            out.append(
                {"name": name, "labels": dict(s.labels), "kind": s.kind, "points": points}
            )
        return out

    def stats(self) -> dict:
        with self._lock:
            n = len(self._series)
        return {
            "running": self.running,
            "interval_s": self.interval,
            "retention_s": self.retention_s,
            "series": n,
            "max_series": self.max_series,
            "dropped_series": self.dropped_series,
            "dropped_overflow": self.dropped_overflow,
            "samples": self.samples,
            "last_sample_cost_us": round(self.last_sample_cost_us, 1),
        }


def bucket_quantile(
    buckets: tuple, dcounts: list[float], total: float, q: float
) -> float:
    """Quantile from bucketed counts, linearly interpolated inside the
    landing bucket (lower bound = previous bucket's upper bound, 0 for the
    first). Observations past the last finite bucket answer with that
    bucket's bound — the honest ceiling of what bucketed data can say.
    THE shared bucket-quantile: hist_window() above and the rollout
    shadow-divergence p99 (scheduler/rollout.delta_hist_quantile) both
    delegate here, so the same distribution never reads differently from
    /debug/ts vs `dfmodel status`."""
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


# ---------------------------------------------------------------------------
# stats frame: the compact per-service report the manager aggregates


def build_stats_frame(
    recorder: MetricsRecorder,
    *,
    service: str,
    hostname: str = "",
    alerts=None,
    window_s: float = DEFAULT_WINDOW_S,
    extra: Mapping[str, Any] | None = None,
) -> dict:
    """One compact frame of this process's windowed health, riding the
    existing manager keepalive tick (rpc/manager.py `keepalive(stats=...)`).

    Only keys whose metric families exist in the recorder are emitted, so a
    daemon's frame carries byte rates and a scheduler's carries round rates
    without any per-service frame schema. Everything is a small flat number
    (or short string) — the manager keeps a ring of these per member and
    dftop renders them directly; frame size is pinned by bench metrics_plane.
    """
    r = recorder
    rates: dict[str, float] = {}

    def put(key: str, val: float | None, nd: int = 3) -> None:
        if val is not None:
            rates[key] = round(val, nd)

    # scheduler plane
    sched = r.hist_window(
        "dragonfly_scheduler_schedule_duration_seconds", window_s=window_s
    )
    if sched is not None:
        put("rounds_per_s", sched["rate_per_s"], 2)
        put("round_p95_ms", sched["p95"] * 1e3, 2)
    put("pieces_ok_per_s", r.rate(
        "dragonfly_scheduler_piece_result_total", {"success": "true"}, window_s=window_s
    ), 2)
    put("pieces_failed_per_s", r.rate(
        "dragonfly_scheduler_piece_result_total", {"success": "false"}, window_s=window_s
    ), 3)
    put("base_fallback_per_s", r.rate(
        "dragonfly_scheduler_ml_base_fallback_total", window_s=window_s
    ), 3)
    put("scorer_errors_per_s", r.rate(
        "dragonfly_scheduler_ml_base_fallback_total", {"reason": "scorer_error"},
        window_s=window_s,
    ), 3)
    # daemon plane (bytes → MB/s)
    down = r.rate("dragonfly_dfdaemon_download_bytes_total", window_s=window_s)
    up = r.rate("dragonfly_dfdaemon_upload_bytes_total", window_s=window_s)
    put("piece_down_mb_per_s", None if down is None else down / (1 << 20), 3)
    put("piece_up_mb_per_s", None if up is None else up / (1 << 20), 3)
    put("tasks_per_s", r.rate(
        "dragonfly_dfdaemon_task_result_total", window_s=window_s
    ), 3)
    # data-plane TLS health: handshake volume + how much of it resumed (the
    # fast-path contract is resumed/total ≥ 0.9 under reconnect storms)
    put("tls_handshakes_per_s", r.rate(
        "dragonfly_dfdaemon_piece_tls_handshakes_total", window_s=window_s
    ), 3)
    put("tls_resumed_per_s", r.rate(
        "dragonfly_dfdaemon_piece_tls_handshakes_total", {"resumed": "true"},
        window_s=window_s,
    ), 3)
    put("tls_handshake_failures_per_s", r.rate(
        "dragonfly_dfdaemon_piece_tls_handshake_failures_total", window_s=window_s
    ), 3)
    # trainer plane: a trainer member shows live learner work —
    # keys appear only in processes where the dragonfly_train_* families
    # have children (the only-present-families schema, like everything here)
    put("train_steps_per_s", r.rate(
        "dragonfly_train_steps_total", window_s=window_s
    ), 2)
    put("train_examples_per_s", r.rate(
        "dragonfly_train_examples_total", window_s=window_s
    ), 1)
    runs = r.latest("dragonfly_train_runs_total")
    if runs is not None:
        rates["train_runs_total"] = int(runs)
    put("train_last_loss", r.latest("dragonfly_train_last_run_loss"), 5)
    # ML-plane drift: max per-feature PSI vs the serving model's
    # training reference — the number the feature_drift alert gates on
    put("feature_drift_max", r.latest("dragonfly_feature_drift_max"), 4)
    # brownout ladder: current rung + admission shed rate — dftop
    # shows which schedulers are degraded cluster-wide from these two keys
    deg = r.latest("dragonfly_scheduler_degradation_level")
    if deg is not None:
        rates["degradation_level"] = int(deg)
    put("admission_shed_per_s", r.rate(
        "dragonfly_scheduler_admission_shed_total", window_s=window_s
    ), 3)
    mgr_down = r.latest("dragonfly_scheduler_manager_unreachable")
    if mgr_down is not None and mgr_down >= 1.0:
        rates["manager_unreachable"] = 1
    # loop health
    lag = r.hist_window("dragonfly_loop_lag_seconds", window_s=window_s)
    if lag is not None:
        put("loop_lag_p95_ms", lag["p95"] * 1e3, 3)
    util = r.hist_window("dragonfly_loop_dispatcher_utilization", window_s=window_s)
    if util is not None:
        put("dispatcher_utilization", util["mean"], 3)
    # federation sync health
    put("federation_syncs_ok_per_s", r.rate(
        "dragonfly_scheduler_federation_syncs_total", {"result": "ok"},
        window_s=window_s,
    ), 3)
    put("federation_syncs_err_per_s", r.rate(
        "dragonfly_scheduler_federation_syncs_total", {"result": "error"},
        window_s=window_s,
    ), 3)

    frame: dict[str, Any] = {
        "service": service,
        "ts": round(time.time(), 3),
        "window_s": window_s,
        "rates": rates,
    }
    if hostname:
        frame["hostname"] = hostname
    peers = r.latest("dragonfly_scheduler_federation_peers")
    if peers is not None:
        frame["federation_peers"] = int(peers)
    mode = _one_hot_mode(r, "dragonfly_scheduler_ml_serving_mode", "mode")
    if mode is not None:
        frame["serving_mode"] = mode
    # wire posture labels for the daemon's byte rates: which cipher piece
    # MB/s is riding, and what the write-behind governor decided
    cipher = _one_hot_mode(r, "dragonfly_dfdaemon_piece_cipher", "cipher")
    if cipher is not None:
        frame["piece_cipher"] = cipher
    wb = _one_hot_mode(r, "dragonfly_dfdaemon_write_behind_mode", "mode")
    if wb is not None:
        frame["write_behind"] = wb
    state = _one_hot_mode(r, "dragonfly_scheduler_model_rollout_state", "state")
    if state is not None:
        frame["rollout_state"] = state
    if alerts is not None:
        frame["alerts"] = [a["name"] for a in alerts.active()]
    if extra:
        frame.update(extra)
    return frame


def _one_hot_mode(r: MetricsRecorder, name: str, label: str) -> str | None:
    """Resolve a one-hot gauge family ({mode} with exactly one 1) to its
    active label value."""
    active = None
    seen = False
    for s in r._matching(name, None):
        if not s.points:
            continue
        seen = True
        if s.points[-1][1] >= 1.0:
            active = dict(s.labels).get(label)
    return active if seen else None


# ---------------------------------------------------------------------------
# process-wide default (composition roots start it; /debug/ts reads it)

_default: MetricsRecorder | None = None


def default_recorder() -> MetricsRecorder:
    global _default
    if _default is None:
        import os

        interval = float(os.environ.get("DRAGONFLY_TS_INTERVAL", DEFAULT_INTERVAL_S))
        _default = MetricsRecorder(interval=interval)
    return _default
