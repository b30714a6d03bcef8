"""Minimal finite-state machine.

The port's own copy of dragonfly2_tpu/utils/fsm.py.

Parity with the looplab/fsm usage in reference scheduler/resource/peer.go:50-243
and task.go: every peer/task/host transition is gated by an FSM so illegal
control-plane transitions surface as errors instead of corrupt state.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable


class TransitionError(Exception):
    def __init__(self, event: str, state: str):
        super().__init__(f"event {event!r} inappropriate in current state {state!r}")
        self.event = event
        self.state = state


class Event:
    __slots__ = ("name", "src", "dst")

    def __init__(self, name: str, src: Iterable[str], dst: str):
        self.name = name
        self.src = frozenset([src] if isinstance(src, str) else src)
        self.dst = dst


class FSM:
    """Tiny synchronous FSM with per-event and wildcard callbacks."""

    def __init__(
        self,
        initial: str,
        events: Iterable[Event],
        callbacks: dict[str, Callable[["FSM", str, str, str], None]] | None = None,
    ):
        self._state = initial
        self._events: dict[str, Event] = {e.name: e for e in events}
        self._callbacks = callbacks or {}
        self._lock = threading.RLock()

    @property
    def current(self) -> str:
        return self._state

    def is_(self, state: str) -> bool:
        return self._state == state

    def can(self, event: str) -> bool:
        e = self._events.get(event)
        return e is not None and self._state in e.src

    def fire(self, event: str) -> None:
        with self._lock:
            e = self._events.get(event)
            if e is None or self._state not in e.src:
                raise TransitionError(event, self._state)
            src = self._state
            self._state = e.dst
            cb = self._callbacks.get(event) or self._callbacks.get("*")
            if cb is not None:
                cb(self, event, src, e.dst)
