"""Event-loop health telemetry: scheduled-callback lag + worker utilization.

The port's own copy of dragonfly2_tpu/observability/loophealth.py.

A scheduler's serving ceiling can be HOST-shaped (the loop's per-round
glue plus one worker saturating the GIL). This module is the direct
instrument for it — a monitor that schedules a callback every `interval` seconds and records how
LATE the loop actually ran it (drift = observed - expected). On a healthy
loop the lag is microseconds; a loop starved by GIL-holding threads, a
blocking call, or simple overload shows up as a fat lag tail long before
anything times out. The same monitor samples the round dispatcher's worker
utilization (busy/total) so "the loop is lagging AND the workers are idle"
vs "both are pegged" is answerable from one endpoint.

Everything lands in the default metrics registry as histograms
(`dragonfly_loop_lag_seconds`, `dragonfly_loop_dispatcher_utilization`) plus
an in-memory ring served by GET /debug/loop (observability.server) as
p50/p95/max summaries. Cost: one loop callback per interval (default 250 ms
= 4 clock reads/s), nothing on any hot path.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Callable, Optional

from dragonfly2_tpu_torch.observability.metrics import MetricsRegistry, default_registry
from dragonfly2_tpu_torch.utils.stats import quantile as _quantile

DEFAULT_INTERVAL_S = 0.25
_RING = 512  # ~2 min of samples at the default cadence


class LoopHealthMonitor:
    """Samples event-loop scheduling lag (and, when a probe is attached,
    dispatcher-worker utilization) on a fixed cadence.

    `dispatcher_probe` is any zero-arg callable returning (busy, total)
    worker counts — `monitor.attach_dispatcher(d)` wires a RoundDispatcher's
    `busy`/`workers` pair. The probe runs on the event loop, so it may read
    loop-owned state without locks.
    """

    def __init__(
        self,
        *,
        interval: float = DEFAULT_INTERVAL_S,
        registry: MetricsRegistry | None = None,
        ring: int = _RING,
    ):
        self.interval = interval
        reg = registry or default_registry()
        # lag buckets: µs-grade healthy ticks up to multi-second stalls
        self._lag_hist = reg.histogram(
            "lag_seconds",
            "observed minus expected delay of a scheduled loop callback",
            subsystem="loop",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
        )
        self._util_hist = reg.histogram(
            "dispatcher_utilization",
            "fraction of round-dispatcher workers busy at sample time",
            subsystem="loop",
            buckets=(0.0, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self._lag_ring: deque = deque(maxlen=ring)
        self._util_ring: deque = deque(maxlen=ring)
        self._dispatcher_probe: Optional[Callable[[], tuple]] = None
        self._handle: Any = None
        self._expected_at = 0.0
        self._started_at = 0.0
        self.samples = 0
        self.max_lag_s = 0.0

    # ---- wiring ----

    def attach_dispatcher(self, dispatcher: Any) -> None:
        """Sample a RoundDispatcher's worker occupancy each tick (any object
        with `busy` and `workers` attributes works)."""
        self._dispatcher_probe = lambda: (dispatcher.busy, dispatcher.workers)

    def start(self) -> None:
        """Begin sampling on the RUNNING loop. Idempotent."""
        if self._handle is not None:
            return
        loop = asyncio.get_running_loop()
        self._started_at = time.monotonic()
        self._expected_at = self._started_at + self.interval
        self._handle = loop.call_later(self.interval, self._tick, loop)

    def stop(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        # drop the probe: the process-wide singleton must not pin a
        # shut-down dispatcher's object graph (Scheduling → pool →
        # evaluator) across in-process restarts; the composition root
        # re-attaches at the next boot
        self._dispatcher_probe = None

    @property
    def running(self) -> bool:
        return self._handle is not None

    # ---- sampling ----

    def _tick(self, loop) -> None:
        now = time.monotonic()
        # drift of THIS callback: the loop promised to run us at
        # _expected_at; everything between then and now is time the loop
        # spent elsewhere (other callbacks, a GIL-holding thread, a stall)
        lag = max(0.0, now - self._expected_at)
        self.samples += 1
        self.max_lag_s = max(self.max_lag_s, lag)
        self._lag_hist.observe(lag)
        self._lag_ring.append(lag)
        if self._dispatcher_probe is not None:
            try:
                busy, total = self._dispatcher_probe()
                util = busy / total if total else 0.0
            except Exception:  # noqa: BLE001 — a dead dispatcher must not kill sampling
                self._dispatcher_probe = None
            else:
                self._util_hist.observe(util)
                self._util_ring.append(util)
        # schedule relative to NOW (not expected): a long stall must cost
        # one fat sample, not a burst of back-to-back catch-up ticks that
        # each read as near-zero lag
        self._expected_at = now + self.interval
        self._handle = loop.call_later(self.interval, self._tick, loop)

    # ---- reporting ----

    def stats(self) -> dict:
        lags = sorted(self._lag_ring)
        out = {
            "running": self.running,
            "interval_s": self.interval,
            "samples": self.samples,
            "uptime_s": round(time.monotonic() - self._started_at, 1)
            if self._started_at
            else 0.0,
            "lag_p50_ms": round(_quantile(lags, 0.50) * 1e3, 3),
            "lag_p95_ms": round(_quantile(lags, 0.95) * 1e3, 3),
            "lag_max_ms": round(self.max_lag_s * 1e3, 3),
        }
        if self._util_ring:
            utils = sorted(self._util_ring)
            out["dispatcher_utilization_p50"] = round(_quantile(utils, 0.50), 3)
            out["dispatcher_utilization_p95"] = round(_quantile(utils, 0.95), 3)
        return out


_default: LoopHealthMonitor | None = None


def default_monitor() -> LoopHealthMonitor:
    """Process-wide monitor (composition roots start it; /debug/loop reads
    it). Created lazily so importing this module costs nothing."""
    global _default
    if _default is None:
        _default = LoopHealthMonitor()
    return _default
