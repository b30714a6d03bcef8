"""dftrace: merge per-process span files, reassemble traces, find the
critical path. The port of dragonfly2_tpu/cli/dftrace.py: either package's
tool reads span files that either package wrote, with the same output.

Every service (and `dfget --trace-file`) writes finished spans as JSON lines
(`tracing.trace_file` / DRAGONFLY_TRACE_FILE); OTLP batch files
(`tracing.otlp_file`) are readable too. A cluster run therefore leaves one
span file per process — this tool is the collector-less way to read them as
ONE timeline:

  python -m dragonfly2_tpu_torch.cli.dftrace /tmp/trace-*.jsonl
      per-trace critical path (who actually gated the wall clock) plus a
      p50/p95 stage table per span name across all traces

  python -m dragonfly2_tpu_torch.cli.dftrace --trace <id16..> files...
      one trace in detail

  python -m dragonfly2_tpu_torch.cli.dftrace --otlp http://jaeger:4318 files...
      forward the merged spans as OTLP/JSON batches to a collector (the
      same body the live otlp_endpoint exporter POSTs), so an offline run's
      files can still land in Jaeger afterwards.

Critical-path rule: starting at the trace root, repeatedly descend into the
child whose interval ENDS last — the child that gated the parent's return.
Each hop reports its exclusive time (duration minus the on-path child's
duration), so the exclusive times along the path sum exactly to the root's
duration: the printed path IS an account of the measured wall time.
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import sys
from collections import defaultdict
from typing import Iterable

from dragonfly2_tpu_torch.utils.stats import quantile as _quantile


def _spans_from_otlp_request(req: dict) -> Iterable[dict]:
    """OTLP/JSON ExportTraceServiceRequest → plain span dicts (the tracer's
    JSONL shape), so both export formats merge into one pool."""
    for rs in req.get("resourceSpans", ()):
        service = ""
        for attr in rs.get("resource", {}).get("attributes", ()):
            if attr.get("key") == "service.name":
                service = attr.get("value", {}).get("stringValue", "")
        for ss in rs.get("scopeSpans", ()):
            for s in ss.get("spans", ()):
                start = int(s.get("startTimeUnixNano", "0")) / 1e9
                end = int(s.get("endTimeUnixNano", "0")) / 1e9
                attrs = {}
                for a in s.get("attributes", ()):
                    v = a.get("value", {})
                    # decode by the key PRESENT, not an or-chain over
                    # values: False/0.0 are valid attr values (dispatched=
                    # false, queue_wait_ms=0.0) and must survive, and OTLP
                    # int64s are JSON strings that must come back as ints
                    if "stringValue" in v:
                        attrs[a.get("key", "")] = v["stringValue"]
                    elif "boolValue" in v:
                        attrs[a.get("key", "")] = v["boolValue"]
                    elif "intValue" in v:
                        try:
                            attrs[a.get("key", "")] = int(v["intValue"])
                        except (TypeError, ValueError):
                            attrs[a.get("key", "")] = v["intValue"]
                    elif "doubleValue" in v:
                        attrs[a.get("key", "")] = v["doubleValue"]
                attrs.setdefault("service", service)
                yield {
                    "trace_id": s.get("traceId", ""),
                    "span_id": s.get("spanId", ""),
                    "parent_id": s.get("parentSpanId", ""),
                    "name": s.get("name", ""),
                    "start": start,
                    "duration_ms": round((end - start) * 1e3, 3),
                    "attrs": attrs,
                    "status": {1: "ok", 2: "error"}.get(
                        s.get("status", {}).get("code"), "ok"
                    ),
                    "error": s.get("status", {}).get("message", ""),
                }


def load_spans(paths: list[str]) -> list[dict]:
    """Read span JSONL and/or OTLP-request JSONL files; skip unparsable
    lines (a crashed process may leave a torn tail) rather than dying."""
    spans: list[dict] = []
    for pattern in paths:
        matches = globlib.glob(pattern) or [pattern]
        for path in matches:
            try:
                fh = open(path, "r", encoding="utf-8")
            except OSError as e:
                print(f"dftrace: {path}: {e}", file=sys.stderr)
                continue
            with fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail of a killed process
                    if "resourceSpans" in obj:
                        spans.extend(_spans_from_otlp_request(obj))
                    elif "trace_id" in obj:
                        spans.append(obj)
    return spans


def assemble_traces(spans: list[dict]) -> dict[str, list[dict]]:
    """trace_id → spans, de-duplicated by span_id (a file may be read twice
    via overlapping globs), time-ordered."""
    traces: dict[str, dict[str, dict]] = defaultdict(dict)
    for s in spans:
        if s.get("span_id"):
            traces[s["trace_id"]][s["span_id"]] = s
    return {
        tid: sorted(by_id.values(), key=lambda s: s.get("start", 0.0))
        for tid, by_id in traces.items()
    }


def _roots(spans: list[dict]) -> list[dict]:
    ids = {s["span_id"] for s in spans}
    # a root is a span whose parent was never exported — either a true root
    # (parent_id "") or the local fragment of a trace whose upstream file is
    # missing; both are valid timeline anchors
    return [s for s in spans if not s.get("parent_id") or s["parent_id"] not in ids]


def critical_path(spans: list[dict]) -> list[tuple[dict, float]]:
    """[(span, exclusive_ms)] from the root down: at each hop descend into
    the child that finished LAST (it gated the parent's return). Exclusive
    time = span duration minus the on-path child's duration, so the column
    sums exactly to the root's duration."""
    children: dict[str, list[dict]] = defaultdict(list)
    for s in spans:
        if s.get("parent_id"):
            children[s["parent_id"]].append(s)
    roots = _roots(spans)
    if not roots:
        return []
    root = max(roots, key=lambda s: s.get("duration_ms", 0.0))
    path: list[dict] = [root]
    seen = {root["span_id"]}
    cur = root
    while True:
        kids = [c for c in children.get(cur["span_id"], ()) if c["span_id"] not in seen]
        if not kids:
            break
        cur = max(kids, key=lambda s: s.get("start", 0.0) + s.get("duration_ms", 0.0) / 1e3)
        path.append(cur)
        seen.add(cur["span_id"])
    out = []
    for i, s in enumerate(path):
        child_ms = path[i + 1].get("duration_ms", 0.0) if i + 1 < len(path) else 0.0
        out.append((s, max(0.0, s.get("duration_ms", 0.0) - child_ms)))
    return out


def stage_table(spans: list[dict]) -> list[dict]:
    """Per-span-name duration stats across every trace in the pool."""
    by_name: dict[str, list[float]] = defaultdict(list)
    for s in spans:
        by_name[s.get("name", "?")].append(float(s.get("duration_ms", 0.0)))
    rows = []
    for name, vals in by_name.items():
        vals.sort()
        rows.append(
            {
                "name": name,
                "count": len(vals),
                "p50_ms": round(_quantile(vals, 0.50), 3),
                "p95_ms": round(_quantile(vals, 0.95), 3),
                "max_ms": round(vals[-1], 3),
                "total_ms": round(sum(vals), 3),
            }
        )
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def _span_label(s: dict) -> str:
    attrs = s.get("attrs", {}) or {}
    svc = attrs.get("service", "")
    interesting = {
        k: v
        for k, v in attrs.items()
        if k in ("method", "piece", "round", "task_id", "worker", "version",
                 "recv_ms", "hash_wait_ms", "queue_wait_ms", "batch_size",
                 "path", "pieces")
    }
    extra = " ".join(f"{k}={v}" for k, v in sorted(interesting.items()))
    base = f"{s.get('name', '?')}"
    if svc:
        base += f" [{svc}]"
    if s.get("status") == "error":
        base += " !ERROR"
    return f"{base} {extra}".rstrip()


def print_trace(tid: str, spans: list[dict], *, out=sys.stdout) -> None:
    path = critical_path(spans)
    if not path:
        return
    root_ms = path[0][0].get("duration_ms", 0.0)
    excl_sum = sum(e for _s, e in path)
    print(f"trace {tid}  spans={len(spans)}  wall={root_ms:.1f}ms", file=out)
    print("  critical path (exclusive ms sums to wall):", file=out)
    for s, excl in path:
        print(
            f"    {excl:9.2f}ms  (span {s.get('duration_ms', 0.0):9.2f}ms)  {_span_label(s)}",
            file=out,
        )
    print(f"    {'-' * 9}\n    {excl_sum:9.2f}ms  total exclusive", file=out)


def forward_otlp(spans: list[dict], endpoint: str, *, batch: int = 256) -> int:
    """POST merged spans to <endpoint>/v1/traces as OTLP/JSON batches,
    grouped by their recorded service name. Returns batches sent."""
    import urllib.request

    from dragonfly2_tpu_torch.observability.tracing import Span, Tracer, spans_to_otlp

    tracer = Tracer()
    by_service: dict[str, list] = defaultdict(list)
    for d in spans:
        attrs = dict(d.get("attrs", {}) or {})
        service = str(attrs.get("service", "dragonfly"))
        s = Span(tracer, d.get("name", "?"), d.get("trace_id", ""),
                 d.get("parent_id", ""), attrs)
        s.span_id = d.get("span_id", s.span_id)
        s.start = float(d.get("start", 0.0))
        s.end = s.start + float(d.get("duration_ms", 0.0)) / 1e3
        s.status = d.get("status", "ok")
        s.error = d.get("error", "")
        by_service[service].append(s)
    sent = 0
    for service, group in by_service.items():
        for i in range(0, len(group), batch):
            req = spans_to_otlp(group[i : i + batch], service)
            r = urllib.request.Request(
                endpoint.rstrip("/") + "/v1/traces",
                data=json.dumps(req).encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(r, timeout=30).close()
            sent += 1
    return sent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dftrace", description="merge span files; critical paths + stage table"
    )
    ap.add_argument("files", nargs="+", help="span JSONL / OTLP JSONL files (globs ok)")
    ap.add_argument("--trace", default="", help="only this trace id (prefix match)")
    ap.add_argument("--top", type=int, default=5,
                    help="print the N longest traces (default 5)")
    ap.add_argument("--otlp", default="",
                    help="forward merged spans to this collector base URL")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (traces + stage table)")
    args = ap.parse_args(argv)

    spans = load_spans(args.files)
    if not spans:
        print("dftrace: no spans found", file=sys.stderr)
        return 1
    traces = assemble_traces(spans)
    if args.trace:
        traces = {t: s for t, s in traces.items() if t.startswith(args.trace)}
        if not traces:
            print(f"dftrace: no trace matches {args.trace!r}", file=sys.stderr)
            return 1
        # the stage table must describe the trace(s) being inspected, not
        # every span the input files happened to hold
        spans = [s for items in traces.values() for s in items]

    if args.otlp:
        sent = forward_otlp(spans, args.otlp)
        print(f"forwarded {len(spans)} spans in {sent} OTLP batches to {args.otlp}")

    def trace_wall(items: list[dict]) -> float:
        p = critical_path(items)
        return p[0][0].get("duration_ms", 0.0) if p else 0.0

    ranked = sorted(traces.items(), key=lambda kv: -trace_wall(kv[1]))
    if args.json:
        payload = {
            "traces": [
                {
                    "trace_id": tid,
                    "spans": len(items),
                    "wall_ms": trace_wall(items),
                    "critical_path": [
                        {
                            "name": s.get("name"),
                            "service": (s.get("attrs") or {}).get("service", ""),
                            "span_ms": s.get("duration_ms", 0.0),
                            "exclusive_ms": round(excl, 3),
                            "attrs": s.get("attrs", {}),
                        }
                        for s, excl in critical_path(items)
                    ],
                }
                for tid, items in ranked[: args.top]
            ],
            "stages": stage_table(spans),
        }
        json.dump(payload, sys.stdout, indent=1)
        print()
        return 0

    print(f"{len(spans)} spans, {len(traces)} traces from {len(args.files)} inputs\n")
    for tid, items in ranked[: args.top]:
        print_trace(tid, items)
        print()
    print("stage table (all traces):")
    print(f"  {'span name':34s} {'count':>6s} {'p50 ms':>9s} {'p95 ms':>9s} {'max ms':>9s} {'total ms':>10s}")
    for row in stage_table(spans):
        print(
            f"  {row['name']:34s} {row['count']:6d} {row['p50_ms']:9.2f} "
            f"{row['p95_ms']:9.2f} {row['max_ms']:9.2f} {row['total_ms']:10.1f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
