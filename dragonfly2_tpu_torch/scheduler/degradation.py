"""Scheduler brownout ladder: explicit, reversible load-shedding modes.

The port's own copy of dragonfly2_tpu/scheduler/degradation.py.

The scheduler can *observe* its own overload (loop-lag p95, dispatcher
utilization, queue depth); without a ladder it would keep
serving every feature of every round right up to collapse: under a flash
crowd the loop lag climbs, registrations time out, every daemon retries, and
the retry storm finishes the job. The reference's answer is implicit (gRPC
deadline kills + client back-off); ours is explicit — a ladder of
DEGRADATION LEVELS that sheds the most expendable work first and says so in
a metric:

  level 0  normal        everything on
  level 1  shed_shadow   candidate shadow scoring off (log-only work, zero
                         traffic impact — the cheapest thing to drop)
  level 2  shed_obs      + decision recording and drift sampling off (the
                         ML-plane observability tax)
  level 3  base_only     + serve the base evaluator: skip ML prepare/FFI
                         entirely, rounds cost one cached-feature matmul
  level 4  admission     + priority-aware admission control: register_peer
                         answers a typed `overloaded` + retry_after_s for
                         the lowest traffic-shaper priority classes instead
                         of timing out on everyone equally

Every rung is REVERSIBLE with hysteresis: stepping up needs the pressure
signal sustained for `sustain_s`; stepping down needs it quiet for `cool_s`
(longer, so the ladder cannot flap at the boundary). Within level 4 the shed
cutoff itself escalates class by class — lowest priority first, exactly the
order the traffic shaper already encodes (daemon/trafficshaper.py weights).

State is exported as the `dragonfly_scheduler_degradation_level` gauge (a
stock alert rule fires on level >= 1) and carried in the stats frame, so
dftop shows a browned-out member cluster-wide.

Pressure probes are injected zero-arg callables (None = signal absent), so
the controller is testable without a loop and the swarm simulator drives it
from MODELED queue depth on a virtual clock — the same object, the same
thresholds, chaos-proven at 10^5 peers before production trusts it.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Any, Callable, Optional

from dragonfly2_tpu_torch.utils import clock as clockmod

logger = logging.getLogger(__name__)

__all__ = ["DegradationController", "LEVEL_NAMES"]

LEVEL_NAMES = ("normal", "shed_shadow", "shed_obs", "base_only", "admission")
MAX_LEVEL = len(LEVEL_NAMES) - 1

DEFAULT_INTERVAL_S = 1.0
# pressure = max(signal/budget) over the attached probes; >= 1.0 sustained
# steps the ladder up, <= exit_pressure sustained steps it down
DEFAULT_LAG_BUDGET_MS = 250.0  # the loop_lag_p95 alert boundary
DEFAULT_UTIL_BUDGET = 0.95
DEFAULT_QUEUE_BUDGET = 64.0
DEFAULT_ENTER_PRESSURE = 1.0
DEFAULT_EXIT_PRESSURE = 0.5
DEFAULT_SUSTAIN_S = 3.0
DEFAULT_COOL_S = 10.0
DEFAULT_RETRY_AFTER_S = 5.0
# bounded set of distinct priority classes tracked for the admission cutoff
_MAX_PRIORITY_CLASSES = 32


class DegradationController:
    """Steps through the brownout ladder from injected pressure probes.

    Probes are zero-arg callables returning a float (or None when the signal
    has no data yet): `lag_p95_ms`, `utilization` (0..1 busy fraction),
    `queue_depth`. Pressure is the max of each signal over its budget; the
    ladder moves one rung at a time with asymmetric hysteresis.

    The shed flags (`shed_shadow`, `shed_obs`, `base_only`,
    `admission_control`) are plain bool attributes recomputed on every level
    change — hot paths read one attribute, never compute anything. Thread
    safety: evaluate_once runs on the loop (or the sim's virtual ticks);
    admit() may be called concurrently and only reads the published flags
    plus a lock-held cutoff.
    """

    def __init__(
        self,
        *,
        lag_p95_ms: Optional[Callable[[], Optional[float]]] = None,
        utilization: Optional[Callable[[], Optional[float]]] = None,
        queue_depth: Optional[Callable[[], Optional[float]]] = None,
        lag_budget_ms: float = DEFAULT_LAG_BUDGET_MS,
        utilization_budget: float = DEFAULT_UTIL_BUDGET,
        queue_budget: float = DEFAULT_QUEUE_BUDGET,
        enter_pressure: float = DEFAULT_ENTER_PRESSURE,
        exit_pressure: float = DEFAULT_EXIT_PRESSURE,
        sustain_s: float = DEFAULT_SUSTAIN_S,
        cool_s: float = DEFAULT_COOL_S,
        retry_after_s: float = DEFAULT_RETRY_AFTER_S,
        interval: float = DEFAULT_INTERVAL_S,
        clock: clockmod.Clock | None = None,
    ):
        self._probe_lag = lag_p95_ms
        self._probe_util = utilization
        self._probe_queue = queue_depth
        self.lag_budget_ms = lag_budget_ms
        self.utilization_budget = utilization_budget
        self.queue_budget = queue_budget
        self.enter_pressure = enter_pressure
        self.exit_pressure = exit_pressure
        self.sustain_s = sustain_s
        self.cool_s = cool_s
        self.retry_after_s = retry_after_s
        self.interval = interval
        self._clock = clock or clockmod.SYSTEM
        self._lock = threading.Lock()
        # ladder state
        self.level = 0
        self._shed_rank = 0  # within level 4: how many priority classes shed
        self._above_since: float | None = None
        self._below_since: float | None = None
        self.last_pressure = 0.0
        self.transitions_up = 0
        self.transitions_down = 0
        self.sheds = 0  # registrations refused by admit()
        self.admits = 0
        # distinct traffic-shaper priorities observed (sorted ascending when
        # read); bounded — clusters carry a handful of classes, not thousands
        self._priorities: set = set()
        # published shed flags (read lock-free on hot paths)
        self.shed_shadow = False
        self.shed_obs = False
        self.base_only = False
        self.admission_control = False
        self._handle: Any = None
        self._export_level()

    # ---- probes ----

    def attach_loop_monitor(self, monitor) -> None:
        """Wire a LoopHealthMonitor's lag p95 as the lag probe."""
        self._probe_lag = lambda: monitor.stats().get("lag_p95_ms")

    def attach_dispatcher(self, dispatcher) -> None:
        """Wire a RoundDispatcher: busy fraction + pending-round queue."""
        self._probe_util = lambda: (
            dispatcher.busy / dispatcher.workers if dispatcher.workers else None
        )
        self._probe_queue = lambda: float(len(dispatcher._pending))

    def pressure(self) -> float:
        """Max of each present signal over its budget (0.0 = all quiet)."""
        worst = 0.0
        if self._probe_lag is not None:
            v = self._safe(self._probe_lag)
            if v is not None and self.lag_budget_ms > 0:
                worst = max(worst, v / self.lag_budget_ms)
        if self._probe_util is not None:
            v = self._safe(self._probe_util)
            if v is not None and self.utilization_budget > 0:
                worst = max(worst, v / self.utilization_budget)
        if self._probe_queue is not None:
            v = self._safe(self._probe_queue)
            if v is not None and self.queue_budget > 0:
                worst = max(worst, v / self.queue_budget)
        return worst

    @staticmethod
    def _safe(probe) -> Optional[float]:
        try:
            return probe()
        except Exception:  # noqa: BLE001 — a dead probe must not kill the ladder
            return None

    # ---- ladder ----

    def evaluate_once(self, now: float | None = None) -> int:
        """One hysteresis step; returns the (possibly new) level.

        Asymmetric by design: stepping UP needs `sustain_s` of pressure at or
        above enter_pressure (a one-tick spike never sheds); stepping DOWN
        needs `cool_s` at or below exit_pressure (recovery is slower than
        engagement so the ladder cannot oscillate at the boundary — and the
        sustain window restarts after every step, so a deep brownout engages
        rung by visible rung, not in one jump)."""
        now = now if now is not None else self._clock.monotonic()
        p = self.pressure()
        self.last_pressure = p
        with self._lock:
            if p >= self.enter_pressure:
                self._below_since = None
                if self._above_since is None:
                    self._above_since = now
                elif now - self._above_since >= self.sustain_s:
                    self._step_up()
                    self._above_since = now
            elif p <= self.exit_pressure:
                self._above_since = None
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.cool_s:
                    self._step_down()
                    self._below_since = now
            else:
                # between thresholds: neither trend is sustained
                self._above_since = None
                self._below_since = None
            return self.level

    def _step_up(self) -> None:
        if self.level >= MAX_LEVEL:
            # already at admission control: escalate the shed cutoff one
            # priority class further (lowest first)
            if self._shed_rank < max(1, len(self._priorities)):
                self._shed_rank += 1
                self.transitions_up += 1
                logger.warning(
                    "degradation: admission shed cutoff -> rank %d (pressure %.2f)",
                    self._shed_rank, self.last_pressure,
                )
            return
        self.level += 1
        if self.level == MAX_LEVEL:
            self._shed_rank = 1
        self.transitions_up += 1
        self._apply()
        logger.warning(
            "degradation: level %d (%s), pressure %.2f",
            self.level, LEVEL_NAMES[self.level], self.last_pressure,
        )

    def _step_down(self) -> None:
        if self.level == MAX_LEVEL and self._shed_rank > 1:
            self._shed_rank -= 1
            self.transitions_down += 1
            logger.info(
                "degradation: admission shed cutoff -> rank %d", self._shed_rank
            )
            return
        if self.level == 0:
            return
        self.level -= 1
        self._shed_rank = 0
        self.transitions_down += 1
        self._apply()
        logger.info(
            "degradation: level %d (%s), pressure %.2f",
            self.level, LEVEL_NAMES[self.level], self.last_pressure,
        )

    def _apply(self) -> None:
        lvl = self.level
        self.shed_shadow = lvl >= 1
        self.shed_obs = lvl >= 2
        self.base_only = lvl >= 3
        self.admission_control = lvl >= MAX_LEVEL
        self._export_level()

    def _export_level(self) -> None:
        from dragonfly2_tpu_torch.scheduler import metrics

        metrics.DEGRADATION_LEVEL.set(float(self.level))

    # ---- admission control (level 4) ----

    def admit(self, priority: float = 1.0) -> tuple[bool, float]:
        """Priority-aware admission decision for one register_peer.

        Returns (admitted, retry_after_s). Below level 4 everything is
        admitted (one attribute read). At level 4 the `_shed_rank` lowest
        distinct priority classes observed so far are refused with a
        retry-after hint scaled by how far over budget the pressure is —
        the hint pre-charges the caller's retry budget so the WHOLE process
        backs off, not just the refused request."""
        self._note_priority(priority)
        if not self.admission_control:
            return True, 0.0
        with self._lock:
            cutoff = self._cutoff_locked()
            if priority > cutoff:
                self.admits += 1
                return True, 0.0
            self.sheds += 1
        retry_after = self.retry_after_s * min(4.0, max(1.0, self.last_pressure))
        return False, retry_after

    def _cutoff_locked(self) -> float:
        """Highest priority value still being SHED (admit strictly above)."""
        if not self._priorities:
            return float("inf")  # no class info: shed everything at rung 4
        ranked = sorted(self._priorities)
        idx = min(self._shed_rank, len(ranked)) - 1
        return ranked[idx] if idx >= 0 else float("-inf")

    def _note_priority(self, priority: float) -> None:
        if priority in self._priorities:
            return
        with self._lock:
            if len(self._priorities) < _MAX_PRIORITY_CLASSES:
                self._priorities.add(priority)

    # ---- lifecycle (production loop ticking; sim calls evaluate_once) ----

    def start(self) -> None:
        """Begin evaluating on the RUNNING loop. Idempotent."""
        if self._handle is not None:
            return
        loop = asyncio.get_running_loop()
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
            self.evaluate_once()
        except Exception:  # noqa: BLE001 — a probe bug must not kill the ladder
            logger.exception("degradation evaluation failed")
        self._handle = loop.call_later(self.interval, self._tick, loop)

    # ---- reporting ----

    def stats(self) -> dict:
        with self._lock:
            return {
                "level": self.level,
                "mode": LEVEL_NAMES[self.level],
                "pressure": round(self.last_pressure, 3),
                "shed_rank": self._shed_rank,
                "priority_classes": sorted(self._priorities),
                "transitions_up": self.transitions_up,
                "transitions_down": self.transitions_down,
                "admits": self.admits,
                "sheds": self.sheds,
                "sustain_s": self.sustain_s,
                "cool_s": self.cool_s,
            }
