"""Cooperative deadline propagation (the Go context.WithTimeout analogue).

The port's own copy of dragonfly2_tpu/resilience/deadline.py.

A download enters the engine with one overall budget; before this module the
budget stopped at the conductor's watchdog while every nested operation used
its own independent constant (30 s rpc timeout, 25 s long-poll, 600 s
watchdog) — so a task could burn its whole budget inside a single stuck rpc.
Now the budget rides a contextvar: `scope(seconds)` narrows it (never
extends — nesting takes the min), and leaf operations ask
`timeout(per_op)` for min(per_op, remaining).

contextvars propagate into tasks created inside the scope (asyncio.Task
copies the current Context at creation), which is exactly the engine →
conductor → scheduler-client chain: the conductor future is created under
the engine's scope, so every rpc call and piece fetch it makes sees the
budget without any signature threading.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Iterator

__all__ = ["Deadline", "current", "remaining", "timeout", "scope"]


class Deadline:
    """An absolute expiry on the monotonic clock."""

    __slots__ = ("expires_at",)

    def __init__(self, seconds: float, *, _expires_at: float | None = None):
        self.expires_at = (
            _expires_at if _expires_at is not None else time.monotonic() + seconds
        )

    def remaining(self) -> float:
        """Seconds left; never negative (0.0 means expired)."""
        return max(0.0, self.expires_at - time.monotonic())

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def timeout(self, per_op: float | None) -> float:
        """min(per_op, remaining) — the per-operation slice of the budget."""
        rem = self.remaining()
        return rem if per_op is None else min(per_op, rem)

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


_current: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "df_deadline", default=None
)


def current() -> Deadline | None:
    """The active deadline, or None when no budget is set."""
    return _current.get()


def remaining() -> float | None:
    """Seconds left in the active budget, or None when no budget is set."""
    dl = _current.get()
    return None if dl is None else dl.remaining()


def timeout(per_op: float | None) -> float | None:
    """min(per_op, remaining): the timeout a leaf operation should use.
    With no active deadline this is just per_op (possibly None)."""
    dl = _current.get()
    if dl is None:
        return per_op
    return dl.timeout(per_op)


@contextmanager
def scope(seconds: float | None) -> Iterator[Deadline | None]:
    """Run a block under a (possibly narrowed) deadline.

    `seconds=None` is a no-op that yields the inherited deadline — callers
    with an optional user-supplied budget don't need two code paths. A nested
    scope can only shrink the budget: the effective expiry is
    min(parent expiry, now + seconds)."""
    parent = _current.get()
    if seconds is None:
        yield parent
        return
    expires = time.monotonic() + seconds
    if parent is not None:
        expires = min(expires, parent.expires_at)
    token = _current.set(Deadline(0, _expires_at=expires))
    try:
        yield _current.get()
    finally:
        _current.reset(token)
