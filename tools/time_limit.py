"""A wall-clock limit for a block of code, for test runners.

``time_limit(seconds, what)`` arms ``SIGALRM``: once the block has run for
``seconds``, it raises ``TimeLimitExceeded`` where the main thread is. The
handler re-arms the timer for ``REARM_S`` before it raises, so a block that
swallows the exception meets it again. asyncio's ``Handle._run`` logs and
drops an exception raised inside a loop callback; the next one comes from
wherever the loop waits, and ends ``asyncio.run``.

A hang that no Python handler reaches, a C call holding the interpreter
lock, or a loop that catches every exception, is named by ``faulthandler``:
``WATCHDOG_GRACE_S`` after the limit it prints every thread's stack to the
stderr the block started with. It does not end the process: pytest-xdist
puts a crashed worker's whole file back in its queue, the test that hung
included, so a hang that repeats would crash worker after worker until
xdist stops the run. faulthandler keeps one such dump at a time, so the
block replaces any armed before it (pytest's ``faulthandler_timeout``).

Off the main thread no signal reaches the block, and the limit does
nothing. Limits do not nest: a block entered while a real-time timer is
armed raises ``RuntimeError``.

Only the standard library: the tests' root ``conftest.py`` imports this
before ``tests/conftest.py`` has set JAX's platform.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import threading
from collections.abc import Iterator
from contextlib import contextmanager

REARM_S = 1.0
WATCHDOG_GRACE_S = 60.0


class TimeLimitExceeded(Exception):
    """A block ran past its wall-clock limit."""


@contextmanager
def time_limit(seconds: float, what: str) -> Iterator[None]:
    """Raise ``TimeLimitExceeded`` in the block once it has run ``seconds``."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    if signal.getitimer(signal.ITIMER_REAL)[0]:
        raise RuntimeError(f"{what}: a real-time timer is already armed, and time limits do not nest")
    live = True

    def expired(signum, frame):
        # A signal already pending as the block ends is handled as late as
        # the first call of the exit path below, which runs after ``live``
        # is cleared.
        if live:
            signal.setitimer(signal.ITIMER_REAL, REARM_S)
            raise TimeLimitExceeded(f"{what}: still running after its limit of {seconds:g} s")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    # faulthandler writes to a file descriptor; a copy of fd 2 keeps the
    # stack visible while pytest's capture points fd 2 at a temp file.
    dump_to = os.dup(2)
    faulthandler.dump_traceback_later(seconds + WATCHDOG_GRACE_S, file=dump_to)
    try:
        yield
    finally:
        live = False
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()
        os.close(dump_to)
