"""Profile a slice of a run with ``torch.profiler`` and reduce its trace:
the device's busy time (the union of its kernel, copy and set spans, so no
span counts twice), device time by kernel, GEMM against other kernels, and
the longest idle gaps labelled by what the host was doing.

The trace is written under ``TMPDIR`` and removed once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
SLICE = "bench.slice"
GEMM_LIST = Path(__file__).with_name("gemm_kernels.json")


def gemm_patterns() -> list[str]:
    """Lower-case substrings that mark a kernel name as a matrix product."""
    return json.loads(GEMM_LIST.read_text())["patterns"]


def is_gemm(name: str, patterns: list[str]) -> bool:
    low = name.lower()
    return any(p in low for p in patterns)


def merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering ``spans``."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label(t: float, host: list[dict]) -> str:
    """The benchmark's range and the innermost host operation open at ``t``."""
    covering = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
    if not covering:
        return "host idle"
    bench = [e["name"] for e in covering if e["name"].startswith("bench.") and e["name"] != SLICE]
    inner = min(covering, key=lambda e: e["dur"])["name"]
    top = bench[0] if bench else "outside bench ranges"
    return top if inner == top else f"{top} > {inner}"


def reduce(events: list[dict], top: int = 10) -> dict | None:
    """The slice's numbers from a chrome trace's events, or None when the
    trace holds no slice range or no device span inside it."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == SLICE]
    if not marks:
        return None
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= lo or a >= hi:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((max(a, lo), min(b, hi), e.get("name", "?"), e["cat"]))
        elif e.get("cat") in HOST_CATS:
            host.append({"ts": a, "dur": b - a, "name": e.get("name", "?")})
    if not dev:
        return None
    patterns = gemm_patterns()
    by_name: dict[str, float] = {}
    gemm = other = 0.0
    for a, b, name, cat in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if cat == "kernel" and is_gemm(name, patterns):
            gemm += b - a
        elif cat == "kernel":
            other += b - a
    merged = merge([(a, b) for a, b, _, _ in dev])
    gaps = [(lo, merged[0][0])] + [(x[1], y[0]) for x, y in zip(merged, merged[1:])] + [(merged[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in merged) * 1e-6,
        "gemm_s": gemm * 1e-6,
        "nongemm_s": other * 1e-6,
        "device_ops": [[n[:160], s * 1e-6] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[_label(0.5 * (a + b), host), (b - a) * 1e-6] for a, b in gaps],
    }


class Slice:
    """Profiles a slice of a run. ``start`` turns the profiler on one unit
    of work before the slice, so that its own start-up falls outside it;
    ``open`` and ``close`` bracket the slice; ``trace`` is then the
    reduction, or None."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.trace: dict | None = None
        self._stack = contextlib.ExitStack()
        self._prof = None
        self._slice: contextlib.ExitStack | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = self._stack.enter_context(profile(activities=acts))

    def open(self) -> None:
        from torch.profiler import record_function

        self._slice = self._stack.enter_context(contextlib.ExitStack())
        self._slice.enter_context(record_function(SLICE))

    def close(self) -> None:
        """End the slice and the profiler and read the trace; a no-op when
        the profiler never started."""
        if self._prof is None:
            return
        import torch

        if self._slice is not None:
            self._slice.close()
        if self.cuda:
            torch.cuda.synchronize()
        self._stack.close()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            events = json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.trace = reduce(events)
