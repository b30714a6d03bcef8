"""Cluster retry budgets: per-process token buckets gating RETRY traffic.

The port's own copy of dragonfly2_tpu/resilience/budget.py, on the port's
injectable clock.

Per-client backoff (backoff.py) paces one caller's retries; it cannot stop a
THOUSAND callers from pacing in lockstep. When a scheduler stalls for two
seconds under a flash crowd, every daemon's rpc client independently decides
to retry — the cluster-wide result is a synchronized storm that arrives just
as the target comes back, re-killing it (the classic retry-amplification
failure; the reference's answer is the interceptor chain's budgeted retry).

A RetryBudget is a token bucket over retries-per-second for one TARGET CLASS
("scheduler", "manager", "source", ...), shared by every client it is handed
to (``RpcClient(retry_budget=)``):

  first attempts are FREE       the budget never blocks new work, only the
                                amplification on top of it
  each retry spends one token   refilled at `rate` per second up to `burst`
  spend() False => fail fast    the caller moves to its NEXT fallback
                                (another parent, back-to-source, the cached
                                snapshot) instead of hammering the sick target
  charge(seconds)               servers propagating a `retry_after_s` hint
                                pre-charge the budget: one overloaded answer
                                mutes the whole process's retries against that
                                class for the hinted window, not just the one
                                caller that heard it

Clock-injected (utils/clock.py) so the swarm simulator and chaos tests drive
refill in virtual time. Thread-safe: conductor piece workers consult the same
bucket the loop's rpc clients do.

The process-wide registry's ``budget_for`` is what
``RpcClient(target_class=)`` draws from: every client naming one class
spends from the same bucket (the scheduler's ManagerLink passes
``"manager"``). Not ported: the reference's ``reset_budgets`` and
``budget_stats``, which no caller of the port needs.
"""

from __future__ import annotations

import threading
from typing import Callable

from dragonfly2_tpu_torch.utils import clock as clockmod

__all__ = ["RetryBudget"]

# retries/s the process may spend per target class; generous next to steady
# state (a healthy cluster retries rarely) and tiny next to a storm (1000
# in-flight tasks retrying at 1/s would want 1000/s)
DEFAULT_RATE = 10.0
DEFAULT_BURST = 20.0


class RetryBudget:
    """Token bucket over retries/second for one target class."""

    __slots__ = (
        "name", "rate", "burst", "_tokens", "_charged_until", "_last",
        "_clock", "_lock", "spent", "denied", "charges",
    )

    def __init__(
        self,
        name: str = "",
        *,
        rate: float = DEFAULT_RATE,
        burst: float = DEFAULT_BURST,
        clock: clockmod.Clock | None = None,
    ):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"bad retry budget: rate={rate} burst={burst}")
        self.name = name
        self.rate = rate
        self.burst = burst
        self._clock = clock or clockmod.SYSTEM
        self._tokens = burst
        self._charged_until = 0.0  # retry_after_s pre-charge horizon
        self._last = self._clock.monotonic()
        self._lock = threading.Lock()
        self.spent = 0  # retries allowed
        self.denied = 0  # retries refused (caller fell through to fallback)
        self.charges = 0  # retry_after_s hints absorbed

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)  # dflint: disable=DF023 only reachable from spend()/stats(), both of which hold self._lock around the call
        self._last = now

    def spend(self, tokens: float = 1.0) -> bool:
        """Try to spend budget for ONE retry. False = beyond budget: fail
        fast to the next fallback instead of amplifying load."""
        now = self._clock.monotonic()
        with self._lock:
            if now < self._charged_until:
                self.denied += 1
                return False
            self._refill(now)
            if self._tokens < tokens:
                self.denied += 1
                return False
            self._tokens -= tokens
            self.spent += 1
            return True

    def charge(self, retry_after_s: float) -> None:
        """Absorb a server's retry_after hint: no retry against this class
        until the hint expires (the horizon only ever extends — two servers
        hinting different windows leave the longer one standing)."""
        if retry_after_s <= 0:
            return
        now = self._clock.monotonic()
        with self._lock:
            self._charged_until = max(self._charged_until, now + retry_after_s)
            self.charges += 1

    def retry_after_remaining(self) -> float:
        """Seconds until the current pre-charge horizon expires (0 = none)."""
        with self._lock:
            return max(0.0, self._charged_until - self._clock.monotonic())

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "rate": self.rate,
                "burst": self.burst,
                "tokens": round(self._tokens, 3),
                "spent": self.spent,
                "denied": self.denied,
                "charges": self.charges,
                "charged_for_s": round(
                    max(0.0, self._charged_until - self._clock.monotonic()), 3
                ),
            }


# ---------------------------------------------------------------------------
# process-wide registry: every call site retrying against "scheduler" spends
# from the SAME bucket — that sharing is the whole point

_budgets: dict[str, RetryBudget] = {}
_registry_lock = threading.Lock()


def budget_for(
    target_class: str,
    *,
    rate: float = DEFAULT_RATE,
    burst: float = DEFAULT_BURST,
    clock: clockmod.Clock | None = None,
) -> RetryBudget:
    """The process-wide budget for a target class, created on first use
    (rate/burst/clock apply only at creation)."""
    b = _budgets.get(target_class)
    if b is None:
        with _registry_lock:
            b = _budgets.get(target_class)
            if b is None:
                b = _budgets[target_class] = RetryBudget(
                    target_class, rate=rate, burst=burst, clock=clock
                )
    return b

