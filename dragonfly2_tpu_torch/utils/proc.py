"""Process lifecycle helpers of the port's service entry points (from
dragonfly2_tpu/utils/proc.py)."""

from __future__ import annotations

import asyncio
import concurrent.futures
import signal
import subprocess
import time
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


def ready_address(proc: subprocess.Popen, prefix: str, deadline: float) -> str:
    """The address on a child service's ready line (``<prefix> <address>``,
    the first line of its stdout, read as text). A child that prints none by
    ``deadline`` (a ``time.monotonic()`` instant) is killed, which ends the
    blocked read; one that prints another line did not start. Both raise
    RuntimeError."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        line = pool.submit(proc.stdout.readline)
        try:
            line = line.result(timeout=max(0.1, deadline - time.monotonic()))
        except concurrent.futures.TimeoutError:
            proc.kill()
            raise RuntimeError(f"no {prefix} line by the deadline") from None
    if not line.startswith(prefix + " "):
        raise RuntimeError(f"the service did not start: {line!r}, exit {proc.poll()}")
    return line.split()[1]
