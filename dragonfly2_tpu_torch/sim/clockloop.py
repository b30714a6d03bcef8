"""Virtual-clock asyncio event loop (the port's own copy of
dragonfly2_tpu/sim/clockloop.py).

The scheduler's retry path awaits real coroutine sleeps (the resilience
BackoffPolicy): under a flash crowd an empty scheduling round backs off
50-800 ms before retrying. Simulating 10^5 peers cannot pay those sleeps in
wall time — so the simulator runs the whole control plane on an event loop
whose `time()` is the shared VirtualClock and whose selector, instead of
blocking, ADVANCES the clock to the next timer deadline. An `asyncio.sleep`
inside the scheduler then costs nanoseconds of wall time while still moving
simulated time by exactly its delay, in correct order against every other
pending timer.

No sockets exist in the simulator, so nothing can ever become ready on the
selector: advancing virtual time to the next timer IS the wait. A select with
no timeout (no timers, no ready callbacks) is a deadlock — some coroutine
awaits a future nothing will resolve — and raises instead of spinning.
"""

from __future__ import annotations

import asyncio
import selectors
from typing import Any, Coroutine, TypeVar

from dragonfly2_tpu_torch.utils.clock import VirtualClock

T = TypeVar("T")


class _TimeAdvancingSelector(selectors.SelectSelector):
    """select(timeout) advances the virtual clock by `timeout` and reports
    no ready file objects (the loop's self-pipe is registered but never
    written: the simulator is single-threaded with no signals in flight)."""

    def __init__(self, clock: VirtualClock):
        super().__init__()
        self._vclock = clock

    def select(self, timeout: float | None = None) -> list:
        if timeout is None:
            raise RuntimeError(
                "virtual-clock loop would block forever: no scheduled timers "
                "and no ready callbacks (a coroutine is awaiting a future "
                "nothing in the simulation will resolve)"
            )
        if timeout > 0:
            self._vclock.advance(timeout)
        return []


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """SelectorEventLoop reading time from a VirtualClock.

    call_later/call_at deadlines, asyncio.sleep, and wait_for timeouts all
    resolve against virtual time; the loop's own timer heap keeps them
    ordered. The clock object is shared with the scheduler services under
    simulation (their TTL sweeps and freshness stamps read the same time).
    """

    def __init__(self, clock: VirtualClock | None = None):
        self.vclock = clock or VirtualClock()
        super().__init__(_TimeAdvancingSelector(self.vclock))

    def time(self) -> float:
        return self.vclock.monotonic()


def run_virtual(
    coro: Coroutine[Any, Any, T], clock: VirtualClock | None = None
) -> T:
    """asyncio.run for simulated time: run `coro` to completion on a fresh
    VirtualClockLoop over `clock` (or a new one), closing the loop after."""
    loop = VirtualClockLoop(clock)
    try:
        asyncio.set_event_loop(loop)
        return loop.run_until_complete(coro)
    finally:
        asyncio.set_event_loop(None)
        loop.close()
