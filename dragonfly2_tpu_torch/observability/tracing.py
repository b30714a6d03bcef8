"""Contextvar span tracer with head sampling, in-process part.

The port's own copy of what the port's services use from
dragonfly2_tpu/observability/tracing.py: ``SpanContext`` (with its
``sampled`` flag), ``Span``, ``Tracer.span``, ``Tracer.current``,
``Tracer.current_context``, ``finished``, ``default_tracer``, the YAML
``TracingSection`` and ``configure_default_tracer``.

- ``Tracer.span(name, **attrs)`` opens a child of the current contextvar
  span; nesting follows Python async context automatically. An explicit
  ``parent=`` (a ``SpanContext``) wins over the contextvar: the trainer's
  background run parents to the ``train_close`` that queued it.
- Head-based sampling: the ROOT span draws once against ``sample_rate`` and
  every descendant inherits the decision through its context's ``sampled``
  flag, so a trace is recorded all or nothing. An unsampled span costs an
  object and a contextvar set/reset: no id generation, no clock reads, no
  export. A ``Tracer()`` records everything (rate 1.0, or
  ``DRAGONFLY_TRACE_SAMPLE``); a service boot applies
  ``DEFAULT_SERVICE_SAMPLE_RATE`` through ``configure_default_tracer``.
- Finished sampled spans go to an in-memory ring (``finished()``).

- A context crosses the daemon's HTTP piece path as a W3C ``traceparent``
  header (``SpanContext.traceparent`` / ``from_traceparent``); the port's
  RPC client stamps none.

Not ported: the JSON-lines and OTLP exporters.
``TracingSection`` keeps the reference's fields, so one YAML file configures
either package's scheduler; the port's scheduler refuses a section that
names an exporter (scheduler/server.py).
"""

from __future__ import annotations

import contextvars
import os
import random
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from dragonfly2_tpu_torch.utils.config import cfgfield

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "dragonfly_torch_current_span", default=None
)

TRACEPARENT_HEADER = "traceparent"

# finished spans kept for finished(); the oldest drop first
_RING_SIZE = 2048

# Sample rate service composition roots apply when the config carries none:
# 1-in-100 traces recorded end to end, the rest cost one unsampled-root draw
# per entry point. Library/test Tracer() instances keep sample_rate=1.0.
DEFAULT_SERVICE_SAMPLE_RATE = 0.01


@dataclass
class SpanContext:
    trace_id: str
    span_id: str
    sampled: bool = True

    def traceparent(self) -> str:
        # trace-flags 01 = sampled (W3C trace context); the flag IS the
        # all-or-nothing head-sampling decision riding the wire
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    @classmethod
    def from_traceparent(cls, header: str | None) -> Optional["SpanContext"]:
        if not header:
            return None
        parts = header.split("-")
        if len(parts) != 4:
            return None
        return cls(trace_id=parts[1], span_id=parts[2], sampled=parts[3] != "00")


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "attrs", "status", "error", "sampled", "_tracer", "_token",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        parent_id: str,
        attrs: dict[str, Any],
        sampled: bool = True,
    ):
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.sampled = sampled
        if sampled:
            self.span_id = secrets.token_hex(8)
            self.start = time.time()
        else:
            # unsampled spans still hold the lineage (children inherit the
            # decision) but skip id generation and clock reads
            self.span_id = ""
            self.start = 0.0
        self.end = 0.0
        self.attrs = attrs
        self.status = "ok"
        self.error = ""
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
        if not self.sampled:
            return
        if exc is not None:
            self.status = "error"
            self.error = f"{exc_type.__name__}: {exc}"
        self.end = time.time()
        self._tracer._export(self)


class Tracer:
    """Per-process tracer; finished sampled spans land in an in-memory ring.

    ``sample_rate`` is the head-sampling probability drawn once per root
    span (``DRAGONFLY_TRACE_SAMPLE`` overrides it); ``rng`` is the
    ``random.random``-compatible draw source (tests seed it); ``service``
    tags every sampled span."""

    def __init__(
        self,
        *,
        service: str = "dragonfly",
        sample_rate: float = 1.0,
        rng: Callable[[], float] | None = None,
    ) -> None:
        self.service = service
        self.sample_rate = sample_rate
        env_rate = os.environ.get("DRAGONFLY_TRACE_SAMPLE", "")
        if env_rate:
            try:
                self.sample_rate = min(1.0, max(0.0, float(env_rate)))
            except ValueError:
                pass
        self.rng = rng or random.random
        self._ring: deque[Span] = deque(maxlen=_RING_SIZE)
        self._lock = threading.Lock()

    def span(self, name: str, parent: SpanContext | None = None, **attrs: Any) -> Span:
        """Open a span. Parent resolution: explicit context > current
        contextvar span > new root. The sampling decision is made at the
        root only; children inherit it."""
        cur = _current_span.get()
        if parent is not None:
            trace_id, parent_id, sampled = parent.trace_id, parent.span_id, parent.sampled
        elif cur is not None:
            trace_id, parent_id, sampled = cur.trace_id, cur.span_id, cur.sampled
        else:
            sampled = self.sample_rate >= 1.0 or (
                self.sample_rate > 0.0 and self.rng() < self.sample_rate
            )
            trace_id = secrets.token_hex(16) if sampled else "0" * 32
            parent_id = ""
        if sampled:
            attrs.setdefault("service", self.service)
        return Span(self, name, trace_id, parent_id, attrs, sampled)

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


@dataclass
class TracingSection:
    """YAML ``tracing:`` section, field for field the reference's. The port
    records into its ring only: a scheduler boot refuses the three exporter
    fields (scheduler/server.py)."""

    otlp_file: Optional[str] = cfgfield(
        None, help="append OTLP/JSON trace batches to this file"
    )
    otlp_endpoint: Optional[str] = cfgfield(
        None,
        help="POST OTLP/JSON batches to this collector base URL "
             "(e.g. http://jaeger:4318)",
    )
    trace_file: Optional[str] = cfgfield(
        None, help="append finished spans as JSON lines to this file "
                   "(the dftrace input format)"
    )
    sample_rate: Optional[float] = cfgfield(
        None, minimum=0.0, maximum=1.0,
        help="head-sampling probability per trace root (default 0.01; "
             "1.0 records everything, 0.0 disables recording)",
    )


def configure_default_tracer(
    service: str = "", *, sample_rate: float | None = None
) -> Tracer:
    """Apply config-surface tracing options to the process tracer at boot:
    service boots get head sampling at DEFAULT_SERVICE_SAMPLE_RATE unless
    the config (or DRAGONFLY_TRACE_SAMPLE) says otherwise."""
    t = default_tracer()
    if service:
        t.service = service
    if sample_rate is not None:
        t.sample_rate = min(1.0, max(0.0, sample_rate))
    elif not os.environ.get("DRAGONFLY_TRACE_SAMPLE"):
        t.sample_rate = DEFAULT_SERVICE_SAMPLE_RATE
    return t
