"""Process lifecycle helpers of the port's service entry points (from
dragonfly2_tpu/utils/proc.py)."""

from __future__ import annotations

import asyncio
import signal
from typing import Callable


async def run_until_signalled(
    ready_event: asyncio.Event | None = None, on_ready: Callable[[], None] | None = None,
) -> None:
    """Signal readiness (``ready_event``, then ``on_ready``), then block until
    SIGINT/SIGTERM. The handlers are in place before readiness is signalled,
    so a signal sent as soon as a caller reads the ready line is not lost."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover - non-unix loops
            pass
    if ready_event is not None:
        ready_event.set()
    if on_ready is not None:
        on_ready()
    await stop.wait()
