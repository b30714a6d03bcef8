"""Contextvar span tracer, in-process part.

The port's own copy of what the trainer service's spans use from
dragonfly2_tpu/observability/tracing.py: ``SpanContext``, ``Span``
(``set_attr``, ``sampled``), ``Tracer.span``, ``Tracer.current``,
``Tracer.current_context``, ``finished`` and ``default_tracer``.

- ``Tracer.span(name, **attrs)`` opens a child of the current contextvar
  span; nesting follows Python async context automatically. An explicit
  ``parent=`` (a ``SpanContext``) wins over the contextvar: the trainer's
  background run parents to the ``train_close`` that queued it.
- Every span is recorded (``Span.sampled`` is always true): head sampling
  comes back with the config section that sets its rate, in the wiring
  slice, as do the JSON-lines and OTLP exporters and the W3C traceparent
  codec. Finished spans go to an in-memory ring (``finished()``).
"""

from __future__ import annotations

import contextvars
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "dragonfly_torch_current_span", default=None
)

# finished spans kept for finished(); the oldest drop first
_RING_SIZE = 2048


@dataclass
class SpanContext:
    trace_id: str
    span_id: str


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "attrs", "status", "error", "_tracer", "_token",
    )

    sampled = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: str, parent_id: str, attrs: dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent_id
        self.start = time.time()
        self.end = 0.0
        self.attrs = attrs
        self.status = "ok"
        self.error = ""
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
        if exc is not None:
            self.status = "error"
            self.error = f"{exc_type.__name__}: {exc}"
        self.end = time.time()
        self._tracer._export(self)


class Tracer:
    """Per-process tracer; finished spans land in an in-memory ring."""

    def __init__(self) -> None:
        self._ring: deque[Span] = deque(maxlen=_RING_SIZE)
        self._lock = threading.Lock()

    def span(self, name: str, parent: SpanContext | None = None, **attrs: Any) -> Span:
        """Open a span. Parent resolution: explicit context > current
        contextvar span > new root."""
        cur = _current_span.get()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
        else:
            trace_id, parent_id = secrets.token_hex(16), ""
        return Span(self, name, trace_id, parent_id, attrs)

    @staticmethod
    def current() -> Optional[Span]:
        return _current_span.get()

    @staticmethod
    def current_context() -> Optional[SpanContext]:
        s = _current_span.get()
        return s.context if s is not None else None

    def _export(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)

    def finished(self) -> list[Span]:
        with self._lock:
            return list(self._ring)


_default = Tracer()


def default_tracer() -> Tracer:
    return _default
