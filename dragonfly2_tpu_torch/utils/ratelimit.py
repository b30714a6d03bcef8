"""Token-bucket rate limiting.

The port's own copy of dragonfly2_tpu/utils/ratelimit.py: the RPC server's
QPS bucket.

Parity with reference rate limits: per-peer download 512 MB/s, total
download/upload 1 GiB/s (client/config/constants.go:45-47) and the 10k QPS /
20k burst gRPC server limiter (pkg/rpc/scheduler/server/server.go:43-44).
"""

from __future__ import annotations

import asyncio
import time


class TokenBucket:
    """Async token bucket. rate = tokens/sec, burst = bucket capacity."""

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = asyncio.Lock()

    # Lock discipline (dflint DF023 suppressions below): _tokens is mutated
    # both under the asyncio lock (acquire, to serialize WAITERS across its
    # sleeps) and without it (the sync paths: try_acquire/set_rate run on the
    # loop thread with no await inside, so they are atomic w.r.t. coroutine
    # interleaving). acquire() re-checks the balance after every sleep, so
    # tokens taken by a sync caller mid-wait extend the wait instead of racing.

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)  # dflint: disable=DF023 sync path, no await between read and write
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n  # dflint: disable=DF023 sync path, no await between read and write
            return True
        return False

    async def acquire(self, n: float = 1.0) -> None:
        if n > self.burst:
            # A request larger than the bucket drains in chunks.
            remaining = n
            while remaining > 0:
                chunk = min(remaining, self.burst)
                await self.acquire(chunk)
                remaining -= chunk
            return
        async with self._lock:
            # Loop instead of clamping: tokens taken by try_acquire() during the
            # sleep must extend the wait, not be forgiven as debt. `take`
            # re-clamps to the CURRENT burst each pass — set_rate() may shrink
            # the bucket below n mid-wait (traffic-shaper reallocation) and a
            # fixed n would then never be satisfiable.
            while n > 0:
                self._refill()
                take = min(n, self.burst)
                if self._tokens >= take:
                    self._tokens -= take
                    n -= take
                    continue
                await asyncio.sleep((take - self._tokens) / self.rate)

    def set_rate(self, rate: float, burst: float | None = None) -> None:
        """Retarget the bucket (traffic-shaper reallocation). Accrued tokens
        are settled at the OLD rate first; a waiter inside acquire() picks up
        the new rate on its next loop iteration."""
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self._refill()
        self.rate = float(rate)
        if burst is not None:
            self.burst = float(burst)
            self._tokens = min(self._tokens, self.burst)  # dflint: disable=DF023 sync path, no await between read and write

    @property
    def available(self) -> float:
        self._refill()
        return self._tokens
