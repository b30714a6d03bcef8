"""Injectable time source for the control plane.

The port's own copy of dragonfly2_tpu/utils/clock.py. The feature sketch and
the training-run telemetry take ``clock=``.

The scheduler's TTL/GC sweeps, peer/host `updated_at` freshness, the depth
memo's staleness bound, and probe-edge timestamps all read the clock. In
production that is the process clock; the discrete-event swarm simulator
(the JAX package's sim/) drives the SAME scheduler objects under a virtual clock
so that 24 h of TTL behavior, federation convergence, or a flash crowd can
play out in seconds of wall time — which only works if every time read on
those paths goes through one injectable seam.

Two readings, mirroring the stdlib split the call sites already used:

  monotonic()  elapsed-time comparisons (TTL sweeps, memo ages, touch())
  time()       wall-clock stamps that cross process boundaries (probe-edge
               updated_at rides the federation gossip's monotonic-merge rule,
               telemetry created_at)

`SYSTEM` is the module-level default; constructors take `clock=None` meaning
"the system clock" so production call sites never change. VirtualClock is
seedable (explicit start/epoch) and advanced only by its owner — it never
moves on its own, which is the whole point: event ORDER, not the wall,
defines simulated time.
"""

from __future__ import annotations

import time as _time


class Clock:
    """The system clock (production default)."""

    def monotonic(self) -> float:
        return _time.monotonic()

    def time(self) -> float:
        return _time.time()


class VirtualClock(Clock):
    """Manually-advanced clock for discrete-event simulation.

    monotonic() starts at `start`; time() reports `epoch + elapsed` so wall
    stamps are deterministic run-to-run (seedable). advance() moves forward
    only — simulated time, like real time, never goes backward.
    """

    __slots__ = ("_mono", "_epoch")

    def __init__(self, start: float = 0.0, epoch: float = 1_600_000_000.0):
        self._mono = float(start)
        self._epoch = float(epoch) - float(start)

    def monotonic(self) -> float:
        return self._mono

    def time(self) -> float:
        return self._epoch + self._mono

    def advance(self, dt: float) -> float:
        """Move time forward by dt seconds (dt < 0 is an error)."""
        if dt < 0:
            raise ValueError(f"virtual clock cannot go backward (dt={dt})")
        self._mono += dt
        return self._mono

    def advance_to(self, t: float) -> float:
        """Jump to monotonic time t; a t in the past is a no-op (an event
        processed tardily executes at the current now — see sim.engine)."""
        if t > self._mono:
            self._mono = t
        return self._mono


SYSTEM = Clock()
