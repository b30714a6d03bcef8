"""Per-target circuit breaker.

The port's own copy of dragonfly2_tpu/resilience/breaker.py: one scripted
sequence takes both through the same states (tests/test_torch_balancer.py).

The classic three-state machine (closed → open after N consecutive failures,
open → half-open after a cooldown, half-open → closed on a successful probe /
back to open on a failed one). Shape follows the reference's health-aware
client-side balancing (pkg/balancer + interceptor retry): a dead scheduler
should cost one burst of failures and then a cheap local refusal per call,
not a full timeout per call, until a single probe proves it back.

Single-loop asyncio use: no locks needed — every transition is a synchronous
method on the loop thread. The clock is injectable for tests.
"""

from __future__ import annotations

import time
from typing import Callable

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe slot."""

    __slots__ = (
        "failure_threshold", "reset_timeout", "_clock",
        "state", "failures", "_opened_at", "_probe_inflight", "_probe_started",
    )

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1 or reset_timeout < 0:
            raise ValueError(
                f"bad breaker config: threshold={failure_threshold} reset={reset_timeout}"
            )
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self.state = CLOSED
        self.failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0

    def _take_probe_slot(self) -> None:
        self._probe_inflight = True
        self._probe_started = self._clock()

    def allow(self) -> bool:
        """May a call proceed now? In half-open, exactly one probe passes;
        the rest are refused until the probe reports. The probe slot is
        time-bound: a probe whose caller vanished without reporting (the rpc
        was cancelled mid-flight by a task watchdog, say) releases the slot
        after reset_timeout, so an abandoned probe can never wedge the
        breaker in half-open forever."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - self._opened_at >= self.reset_timeout:
                self.state = HALF_OPEN
                self._take_probe_slot()
                return True
            return False
        # HALF_OPEN: one probe at a time
        if (
            not self._probe_inflight
            or self._clock() - self._probe_started >= self.reset_timeout
        ):
            self._take_probe_slot()
            return True
        return False

    @property
    def is_open(self) -> bool:
        """Open AND still inside the cooldown — i.e. a call right now would be
        refused outright. Used by the balancer to route new keys elsewhere;
        returns False once the cooldown lapses so probe traffic still reaches
        the target and can close the breaker again."""
        return (
            self.state == OPEN
            and self._clock() - self._opened_at < self.reset_timeout
        )

    def record_success(self) -> None:
        self.state = CLOSED
        self.failures = 0
        self._probe_inflight = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == HALF_OPEN or self.failures >= self.failure_threshold:
            self.state = OPEN
            self._opened_at = self._clock()
            self._probe_inflight = False

    def __repr__(self) -> str:
        return f"CircuitBreaker(state={self.state}, failures={self.failures})"
