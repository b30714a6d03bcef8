"""Exponential backoff with deterministic, seeded jitter.

The port's own copy of dragonfly2_tpu/resilience/backoff.py: one seed
gives the same delays in both packages (tests/test_torch_balancer.py).

One policy object replaces the tree's hand-rolled retry pacing (rpc/core.py's
linear `retry_backoff * (attempt + 1)`, scheduling.py's fixed
`retry_interval`, conductor's bare 0.5 s sleeps). The shape follows the
reference interceptor chain's exponential retry (pkg/rpc retry interceptor;
also the classic "full jitter" recommendation): delay for attempt k is

    min(max_delay, base * multiplier**k) * (1 - jitter * U[0,1))

i.e. jitter only ever shortens the delay, so `delay(k)` is bounded above by
the deterministic ladder — callers can reason about worst-case wait, and
tests can assert hard bounds. Determinism: pass a seeded random.Random; the
default is an rng seeded at construction so one policy's sequence is
reproducible under a fixed seed (chaos runs pin this).
"""

from __future__ import annotations

import asyncio
import random

__all__ = ["BackoffPolicy"]


class BackoffPolicy:
    """Delay schedule for retry attempt numbers 0, 1, 2, ...

    Immutable configuration, mutable rng. `attempt` is how many tries have
    already failed (first retry waits ~base)."""

    __slots__ = ("base", "multiplier", "max_delay", "jitter", "_rng")

    def __init__(
        self,
        *,
        base: float = 0.2,
        multiplier: float = 2.0,
        max_delay: float = 30.0,
        jitter: float = 0.5,
        rng: random.Random | None = None,
        seed: int | None = None,
    ):
        if base < 0 or multiplier < 1.0 or max_delay < 0 or not 0 <= jitter <= 1:
            raise ValueError(
                f"bad backoff policy: base={base} multiplier={multiplier} "
                f"max_delay={max_delay} jitter={jitter}"
            )
        self.base = base
        self.multiplier = multiplier
        self.max_delay = max_delay
        self.jitter = jitter
        self._rng = rng if rng is not None else random.Random(seed)

    def delay(self, attempt: int) -> float:
        """Seconds to wait after `attempt` failures (attempt >= 0)."""
        d = min(self.max_delay, self.base * self.multiplier ** max(0, attempt))
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    async def sleep(self, attempt: int) -> float:
        """asyncio.sleep(delay(attempt)); returns the slept delay."""
        d = self.delay(attempt)
        if d > 0:
            await asyncio.sleep(d)
        return d

    def __repr__(self) -> str:  # readable in logs/test failures
        return (
            f"BackoffPolicy(base={self.base}, multiplier={self.multiplier}, "
            f"max_delay={self.max_delay}, jitter={self.jitter})"
        )
