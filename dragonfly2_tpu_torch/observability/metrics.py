"""Typed metrics with Prometheus text-format exposition.

The port's own copy of the counter, gauge, histogram, registry and
``/metrics`` handler of dragonfly2_tpu/observability/metrics.py. The port's
services render the port's registry on their debug server's ``/metrics``
(observability/server.py); a reference process renders only the
reference's.

The reference exposes Prometheus counters/gauges/histograms per service on a
dedicated metrics port (scheduler/metrics/metrics.go:46-179,
trainer/metrics/metrics.go). This is the same model without the prometheus
client dependency: a registry of named metric families, label support, and a
text/plain v0.0.4 render suitable for any scraper.

Thread-safety: family creation holds the registry/family lock, and
Counter.inc holds a small per-child lock: the trainers report from worker
threads, and a bare ``self.value += x`` is a read-modify-write the GIL can
preempt mid-update. An uncontended Lock
acquire is ~100 ns, noise next to the dict lookups around it.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Mapping, Sequence


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = ""

    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Mapping[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name}: labels {sorted(labels)} != declared {sorted(self.label_names)}"
            )
        return tuple(str(labels[k]) for k in self.label_names)

    def _labels_of(self, key: tuple[str, ...]) -> dict[str, str]:
        return dict(zip(self.label_names, key))

    def _snapshot_children(self) -> list:
        """Sorted (key, child) pairs under the family lock: a worker thread
        recording a NEW label set resizes the child dict, and iterating it
        bare would raise RuntimeError mid-scrape."""
        with self._lock:
            return sorted(self._children.items())

    def render(self) -> Iterable[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def labels(self, **labels: str) -> "Counter._Child":
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, Counter._Child())
        return child  # type: ignore[return-value]

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if self.label_names:
            self.labels(**labels).inc(amount)
        else:
            self.labels().inc(amount)

    @property
    def value(self) -> float:
        with self._lock:  # a thread creating a new child resizes the dict
            children = list(self._children.values())
        return sum(c.value for c in children)  # type: ignore[attr-defined]

    class _Child:
        __slots__ = ("value", "_lock")

        def __init__(self) -> None:
            self.value = 0.0
            self._lock = threading.Lock()

        def inc(self, amount: float = 1.0) -> None:
            if amount < 0:
                raise ValueError("counter cannot decrease")
            with self._lock:  # += is a preemptible read-modify-write
                self.value += amount

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        if not self._children and not self.label_names:
            yield f"{self.name} 0"
        for key, child in self._snapshot_children():
            yield f"{self.name}{_fmt_labels(self._labels_of(key))} {_fmt_value(child.value)}"  # type: ignore[attr-defined]


class Gauge(_Metric):
    kind = "gauge"

    def labels(self, **labels: str) -> "Gauge._Child":
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, Gauge._Child())
        return child  # type: ignore[return-value]

    def set(self, value: float, **labels: str) -> None:
        self.labels(**labels).set(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        self.labels(**labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.labels(**labels).inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:  # a thread creating a new child resizes the dict
            children = list(self._children.values())
        return sum(c.value for c in children)  # type: ignore[attr-defined]

    class _Child:
        __slots__ = ("value", "_lock")

        def __init__(self) -> None:
            self.value = 0.0
            self._lock = threading.Lock()

        def set(self, value: float) -> None:
            self.value = float(value)  # dflint: disable=DF023 a gauge set is one STORE (no read-modify-write), atomic under the GIL

        def inc(self, amount: float = 1.0) -> None:
            with self._lock:  # += is a preemptible read-modify-write
                self.value += amount

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        if not self._children and not self.label_names:
            yield f"{self.name} 0"
        for key, child in self._snapshot_children():
            yield f"{self.name}{_fmt_labels(self._labels_of(key))} {_fmt_value(child.value)}"  # type: ignore[attr-defined]


_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str, label_names: Sequence[str], buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))

    def labels(self, **labels: str) -> "Histogram._Child":
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, Histogram._Child(self.buckets))
        return child  # type: ignore[return-value]

    def observe(self, value: float, **labels: str) -> None:
        self.labels(**labels).observe(value)

    def time(self, **labels: str) -> "_HistTimer":
        """A context manager that observes the seconds its block took."""
        return _HistTimer(self.labels(**labels))

    class _Child:
        __slots__ = ("buckets", "counts", "total", "count", "_lock")

        def __init__(self, buckets: tuple[float, ...]):
            self.buckets = buckets
            self.counts = [0] * len(buckets)
            self.total = 0.0
            self.count = 0
            self._lock = threading.Lock()

        def observe(self, value: float) -> None:
            # sum, count and buckets move together under one lock, or a
            # concurrent render sees a torn histogram
            with self._lock:
                self.total += value
                self.count += 1
                for i, b in enumerate(self.buckets):
                    if value <= b:
                        self.counts[i] += 1

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        for key, child in self._snapshot_children():
            base = self._labels_of(key)
            with child._lock:  # type: ignore[attr-defined]
                counts = list(child.counts)  # type: ignore[attr-defined]
                count, total = child.count, child.total  # type: ignore[attr-defined]
            for b, c in zip(child.buckets, counts):  # type: ignore[attr-defined]
                yield f"{self.name}_bucket{_fmt_labels(dict(base, le=_fmt_value(b)))} {c}"
            yield f"{self.name}_bucket{_fmt_labels(dict(base, le='+Inf'))} {count}"
            yield f"{self.name}_sum{_fmt_labels(base)} {_fmt_value(total)}"
            yield f"{self.name}_count{_fmt_labels(base)} {count}"


class _HistTimer:
    def __init__(self, child: "Histogram._Child"):
        self._child = child
        self._start = 0.0

    def __enter__(self) -> "_HistTimer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._child.observe(time.perf_counter() - self._start)


class MetricsRegistry:
    """Named metric families for one service process."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if existing.kind != metric.kind:
                    raise ValueError(f"metric {metric.name} re-registered as different kind")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def _name(self, subsystem: str, name: str) -> str:
        parts = [p for p in ("dragonfly", subsystem, name) if p]
        return "_".join(parts)

    def counter(self, name: str, help_: str = "", *, subsystem: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(self._name(subsystem, name), help_, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "", *, subsystem: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(self._name(subsystem, name), help_, labels))  # type: ignore[return-value]

    def histogram(
        self, name: str, help_: str = "", *, subsystem: str = "", labels: Sequence[str] = (),
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram(self._name(subsystem, name), help_, labels, buckets))  # type: ignore[return-value]

    def get(self, full_name: str) -> _Metric | None:
        return self._metrics.get(full_name)

    def families(self) -> list[_Metric]:
        """Snapshot of the registered families (the time-series recorder walks
        this every sample tick; a family registered mid-walk must not raise
        under it)."""
        with self._lock:
            return list(self._metrics.values())

    def render_text(self) -> str:
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def metrics_http_handler(registry: MetricsRegistry | None = None):
    """aiohttp handler for GET /metrics (text/plain; version=0.0.4)."""
    from aiohttp import web

    reg = registry or _default

    async def handler(_req):
        return web.Response(
            text=reg.render_text(),
            content_type="text/plain",
            charset="utf-8",
        )

    return handler
