"""Contextvar span tracer with JSON-lines export and wire propagation: the
port of dragonfly2_tpu/observability/tracing.py, whole. With the same span
ids and clock, its JSON-lines records and OTLP requests are the reference's,
so each package's ``dftrace`` reads the other's span files, and a trace
continues across either package's RPC client and server.

Parity with the reference's OpenTelemetry usage (otelgrpc interceptors on
every RPC chain, explicit spans with typed attributes on peer tasks and
preheat jobs — peertask_conductor.go:182-208, manager/job/preheat.go:91-93,
client/config/constants_otel.go). Dependency-free design:

- `Tracer.span(name, **attrs)` opens a child of the current contextvar span;
  nesting follows Python async context automatically.
- Trace context propagates across processes as a W3C traceparent string
  (rpc/core.py carries it in the frame's "t" key; the HTTP piece/metadata
  paths carry the standard `traceparent` header).
- Head-based sampling: the ROOT span draws once against `sample_rate` and
  every descendant — local child or remote continuation — inherits the
  decision through the context's sampled flag (the traceparent trace-flags
  byte), so a trace is recorded all-or-nothing across the cluster. An
  unsampled span costs an object + a contextvar set/reset and nothing else:
  no id generation, no clock reads, no export.
- Finished sampled spans go to an exporter: in-memory ring (tests, /debug)
  and/or JSON-lines file (the jaeger-exporter stand-in — one dict per span
  with trace_id, span_id, parent_id, name, start, duration_ms, attrs,
  status), and/or OTLP/JSON batches (file or collector endpoint).
- While a ``torch.profiler`` records, `stage(name)` opens a profiler range
  of that name, so the program's stages sit on the profiler's clock beside
  the kernels they launch. Otherwise it hands back one shared no-op, at the
  cost of one flag read; the module never imports torch itself.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import queue as queue_mod
import random
import secrets
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "dragonfly_torch_current_span", default=None
)

TRACEPARENT_HEADER = "traceparent"

# Sample rate service composition roots apply when the config carries none:
# 1-in-100 traces recorded end to end, the rest cost one unsampled-root draw
# per entry point. Library/test Tracer() instances keep sample_rate=1.0.
DEFAULT_SERVICE_SAMPLE_RATE = 0.01


class _NoStage:
    """The context manager `stage` hands back while no profiler records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NO_STAGE = _NoStage()


def stage(name: str):
    """A profiler range named ``name`` around a stage of device work while a
    ``torch.profiler`` records, so that the kernels the stage launches (on
    any thread, autograd's included) can be charged to it by their launch
    time; otherwise the shared no-op. Nothing is exported: the range lives
    only in the profiler's trace. The module is looked up, never imported:
    without torch loaded no profiler can record."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return _NO_STAGE
    return prof.record_function(name)


def _gen_trace_id() -> str:
    return secrets.token_hex(16)


def _gen_span_id() -> str:
    return secrets.token_hex(8)


@dataclass
class SpanContext:
    trace_id: str
    span_id: str
    sampled: bool = True

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
        }

    def traceparent(self) -> str:
        # trace-flags 01 = sampled (W3C trace context); the flag IS the
        # all-or-nothing head-sampling decision riding the wire
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> Optional["SpanContext"]:
        if not d or "trace_id" not in d:
            return None
        return cls(
            trace_id=str(d["trace_id"]),
            span_id=str(d.get("span_id", "")),
            sampled=bool(d.get("sampled", True)),
        )

    @classmethod
    def from_traceparent(cls, header: str | None) -> Optional["SpanContext"]:
        if not header:
            return None
        parts = header.split("-")
        if len(parts) != 4:
            return None
        return cls(
            trace_id=parts[1],
            span_id=parts[2],
            sampled=parts[3] != "00",
        )


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
            self.span_id = _gen_span_id()
            self.start = time.time()
        else:
            # unsampled spans still hold the trace lineage for propagation
            # (children and remote continuations inherit the decision) but
            # skip id generation and clock reads — this is what makes the
            # unsampled hot path cost an object + contextvar churn only
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

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "duration_ms": round((self.end - self.start) * 1000, 3),
            "attrs": self.attrs,
            "status": self.status,
            "error": self.error,
        }


def _otlp_value(v: Any) -> dict:
    """Python value → OTLP AnyValue."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # int64 is a JSON string per OTLP spec
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def spans_to_otlp(spans: list["Span"], service: str) -> dict:
    """Batch of finished spans → one OTLP/JSON ExportTraceServiceRequest —
    the body Jaeger's (and any collector's) OTLP HTTP ingest accepts on
    POST /v1/traces (the reference bootstraps a Jaeger exporter via --jaeger,
    cmd/dependency/dependency.go:72-95; this is its collector-compatible
    equivalent without an SDK dependency)."""
    status_code = {"ok": 1, "error": 2}
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {"key": "service.name", "value": {"stringValue": service}}
                    ]
                },
                "scopeSpans": [
                    {
                        # the reference's scope name: a batch from either
                        # package reads the same to a collector
                        "scope": {"name": "dragonfly2_tpu.observability"},
                        "spans": [
                            {
                                "traceId": s.trace_id,
                                "spanId": s.span_id,
                                **(
                                    {"parentSpanId": s.parent_id}
                                    if s.parent_id
                                    else {}
                                ),
                                "name": s.name,
                                "kind": 1,  # SPAN_KIND_INTERNAL
                                "startTimeUnixNano": str(int(s.start * 1e9)),
                                "endTimeUnixNano": str(int(s.end * 1e9)),
                                "attributes": [
                                    {"key": k, "value": _otlp_value(v)}
                                    for k, v in s.attrs.items()
                                ],
                                "status": (
                                    {"code": status_code.get(s.status, 0)}
                                    | ({"message": s.error} if s.error else {})
                                ),
                            }
                            for s in spans
                        ],
                    }
                ],
            }
        ]
    }


@dataclass
class Tracer:
    """Per-process tracer. `service` tags every span; spans export to an
    in-memory ring always, to a JSON-lines file when `path` is set
    (DRAGONFLY_TRACE_FILE env overrides), and — when `otlp_path` or
    `otlp_endpoint` is set — as OTLP/JSON ExportTraceServiceRequest batches
    (one request per line in the file; HTTP POST to <endpoint>/v1/traces for
    the endpoint, e.g. a Jaeger collector's OTLP port).

    `sample_rate` is the head-sampling probability drawn ONCE per root span;
    descendants (local and remote) inherit the decision. 1.0 records
    everything (library/test default), 0.0 records nothing while keeping
    propagation wired; service boots default to
    DEFAULT_SERVICE_SAMPLE_RATE via configure_default_tracer."""

    service: str = "dragonfly"
    path: str = ""
    otlp_path: str = ""
    otlp_endpoint: str = ""
    otlp_batch: int = 64
    otlp_max_age_s: float = 10.0  # flush a partial batch once its oldest span ages past this
    ring_size: int = 2048
    sample_rate: float = 1.0
    rng: Any = None  # random.random-compatible draw source (tests seed it)
    _ring: deque = field(default_factory=lambda: deque(maxlen=2048), repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _fh: Any = field(default=None, repr=False)
    _otlp_fh: Any = field(default=None, repr=False)
    _otlp_buf: list = field(default_factory=list, repr=False)
    _otlp_buf_since: float = field(default=0.0, repr=False)
    _otlp_queue: Any = field(default=None, repr=False)
    _otlp_worker: Any = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self._ring = deque(maxlen=self.ring_size)
        self.path = self.path or os.environ.get("DRAGONFLY_TRACE_FILE", "")
        self.otlp_path = self.otlp_path or os.environ.get("DRAGONFLY_OTLP_FILE", "")
        self.otlp_endpoint = self.otlp_endpoint or os.environ.get(
            "DRAGONFLY_OTLP_ENDPOINT", ""
        )
        env_rate = os.environ.get("DRAGONFLY_TRACE_SAMPLE", "")
        if env_rate:
            try:
                self.sample_rate = min(1.0, max(0.0, float(env_rate)))
            except ValueError:
                pass
        if self.rng is None:
            self.rng = random.random

    def span(self, name: str, parent: SpanContext | None = None, **attrs: Any) -> Span:
        """Open a span. Parent resolution: explicit remote context > current
        contextvar span > new root. The sampling decision is made at the
        root only — children inherit it, which is what makes a trace
        all-or-nothing across processes."""
        cur = _current_span.get()
        if parent is not None:
            trace_id, parent_id, sampled = parent.trace_id, parent.span_id, parent.sampled
        elif cur is not None:
            trace_id, parent_id, sampled = cur.trace_id, cur.span_id, cur.sampled
        else:
            sampled = self.sample_rate >= 1.0 or (
                self.sample_rate > 0.0 and self.rng() < self.sample_rate
            )
            if sampled:
                trace_id, parent_id = _gen_trace_id(), ""
            else:
                # lineage id still propagates downstream so remote peers see
                # a context (and its not-sampled flag) rather than opening
                # fresh roots of their own; a cheap counter-free id suffices
                trace_id, parent_id = "0" * 32, ""
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
            if self.path:
                if self._fh is None:
                    self._fh = open(self.path, "a", encoding="utf-8", buffering=1 << 16)
                    # the exporter worker flushes this fh on its poll tick:
                    # per-span flushes would stall the loop on a contended
                    # disk, but a LIVE service's span file must be readable
                    # by dftrace within ~a second — 64 KiB of spans sitting
                    # in the userspace buffer until process exit made the
                    # file useless mid-incident (found in verification)
                    self._ensure_otlp_worker()
                self._fh.write(json.dumps(span.to_dict()) + "\n")
            if self.otlp_path or self.otlp_endpoint:
                if not self._otlp_buf:
                    self._otlp_buf_since = time.monotonic()
                    # the single long-lived exporter worker owns the age
                    # flush (its queue wait doubles as the age timer) — the
                    # earlier shape started one threading.Timer per batch,
                    # thread churn on every partial batch (DF026's smell)
                    self._ensure_otlp_worker()
                self._otlp_buf.append(span)
                if len(self._otlp_buf) >= self.otlp_batch:
                    self._flush_otlp_locked()

    def _flush_otlp_locked(self, *, sync: bool = False) -> None:
        if not self._otlp_buf:
            return
        batch, self._otlp_buf = self._otlp_buf, []
        req = spans_to_otlp(batch, self.service)
        if self.otlp_path:
            if self._otlp_fh is None:
                self._otlp_fh = open(
                    self.otlp_path, "a", encoding="utf-8", buffering=1 << 16
                )
            self._otlp_fh.write(json.dumps(req) + "\n")
        if self.otlp_endpoint:
            if sync:
                # shutdown path: POST in the caller's thread so the final
                # batch lands before the interpreter exits
                self._post_otlp(req)
            else:
                # ONE long-lived exporter thread drains a bounded queue: a
                # slow/unreachable collector must cost a constant (dropped
                # batches), never an unbounded thread pile-up
                self._ensure_otlp_worker()
                try:
                    self._otlp_queue.put_nowait(req)
                except queue_mod.Full:  # drop the batch, don't block the loop
                    pass

    def _ensure_otlp_worker(self) -> None:
        if self._otlp_worker is None or not self._otlp_worker.is_alive():
            if self._otlp_queue is None:
                self._otlp_queue = queue_mod.Queue(maxsize=64)
            self._otlp_worker = threading.Thread(
                target=self._otlp_worker_loop, daemon=True
            )
            self._otlp_worker.start()

    def _otlp_worker_loop(self) -> None:
        """The single exporter worker: drains POST batches AND serves every
        time-based flush — the OTLP age flush (a partial batch that never
        reaches otlp_batch still exports within ~otlp_max_age_s; no
        per-batch timer threads) and the buffered file handles (span/OTLP
        files stay dftrace-readable while the process runs)."""
        poll = max(0.05, min(self.otlp_max_age_s / 4.0, 1.0))
        while True:
            try:
                req = self._otlp_queue.get(timeout=poll)
            except queue_mod.Empty:
                with self._lock:
                    if (
                        self._otlp_buf
                        and time.monotonic() - self._otlp_buf_since
                        >= self.otlp_max_age_s
                    ):
                        self._flush_otlp_locked()
                    if self._otlp_fh is not None:
                        self._otlp_fh.flush()
                    if self._fh is not None:
                        self._fh.flush()
                continue
            if req is None:
                return
            self._post_otlp(req)

    def _post_otlp(self, req: dict) -> None:
        import urllib.request

        try:
            r = urllib.request.Request(
                self.otlp_endpoint.rstrip("/") + "/v1/traces",
                data=json.dumps(req).encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(r, timeout=10).close()
        except Exception as e:  # noqa: BLE001 — tracing must never take a service down
            logging.getLogger(__name__).debug("otlp export failed: %s", e)

    def flush_otlp(self, *, sync: bool = False) -> None:
        """Force out any buffered OTLP batch (shutdown / tests)."""
        with self._lock:
            self._flush_otlp_locked(sync=sync)
            if self._otlp_fh is not None:
                self._otlp_fh.flush()

    def finished(self) -> list[Span]:
        with self._lock:
            return list(self._ring)

    def close(self) -> None:
        with self._lock:
            self._flush_otlp_locked(sync=True)
        # sentinel + join OUTSIDE the lock: the worker's idle tick takes the
        # same lock, so holding it here would deadline-race the join — a
        # slow collector during the sync flush above would leave the worker
        # parked on the lock, unable to consume the sentinel, and every
        # process exit would burn the full join timeout
        if self._otlp_worker is not None and self._otlp_queue is not None:
            self._otlp_queue.put(None)  # drain-then-exit sentinel
            self._otlp_worker.join(timeout=10)
            self._otlp_worker = None
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
            if self._otlp_fh is not None:
                self._otlp_fh.flush()
                self._otlp_fh.close()
                self._otlp_fh = None


_default = Tracer()


def default_tracer() -> Tracer:
    return _default


from dragonfly2_tpu_torch.utils.config import cfgfield  # noqa: E402 — section schema below


@dataclass
class TracingSection:
    """YAML `tracing:` section shared by scheduler/daemon/manager configs —
    the validated-config equivalent of the reference's --jaeger flag
    (cmd/dependency/dependency.go:72-95)."""

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
    service: str = "",
    *,
    otlp_file: str | None = None,
    otlp_endpoint: str | None = None,
    trace_file: str | None = None,
    sample_rate: float | None = None,
) -> Tracer:
    """Apply config-surface tracing options to the process tracer at boot.
    Registers an atexit close so partially-filled OTLP batches flush on
    shutdown — a low-traffic process must not export nothing. Service boots
    get head sampling at DEFAULT_SERVICE_SAMPLE_RATE unless the config (or
    DRAGONFLY_TRACE_SAMPLE) says otherwise."""
    import atexit

    t = default_tracer()
    if service:
        t.service = service
    if otlp_file:
        t.otlp_path = otlp_file
    if otlp_endpoint:
        t.otlp_endpoint = otlp_endpoint
    if trace_file:
        t.path = trace_file
    if sample_rate is not None:
        t.sample_rate = min(1.0, max(0.0, sample_rate))
    elif not os.environ.get("DRAGONFLY_TRACE_SAMPLE"):
        t.sample_rate = DEFAULT_SERVICE_SAMPLE_RATE
    # condition on the tracer's RESOLVED outputs, not the arguments: exports
    # configured via DRAGONFLY_TRACE_FILE/DRAGONFLY_OTLP_* env (no config
    # args) must flush at exit too, or their buffered tails are lost
    if t.path or t.otlp_path or t.otlp_endpoint:
        atexit.register(t.close)
    return t
