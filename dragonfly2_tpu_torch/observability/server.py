"""Debug/metrics HTTP endpoint shared by all services.

The reference gives every service a dedicated metrics port plus pprof/statsview
(cmd/dependency/dependency.go:95-102). Equivalent here: a tiny aiohttp app with
  GET /metrics            Prometheus text exposition
  GET /healthz            liveness
  GET /debug/spans        last finished tracing spans as JSON
  GET /debug/loop         event-loop lag + dispatcher-worker utilization
                          (observability.loophealth)
  GET /debug/ts[?name=N&window=S]
                          timeseries recorder (observability.timeseries):
                          no name → recorder stats + series catalog; with a
                          family name → raw ring points plus the windowed
                          rate / histogram summary
  GET /debug/alerts       SLO rule engine state (observability.alerts)
  GET /debug/decisions[?task=T&child=C&limit=N&features=0]
                          sampled scoring decision records + feature-drift
                          state (scheduler processes; `dfml explain` replays
                          these — scheduler/evaluator.DecisionRecorder)
  GET /debug/stacks       every thread's stack + every asyncio task's frame
                          (the /debug/pprof/goroutine analogue)
  GET /debug/profile?seconds=N[&mode=sample&hz=H]
                          mode=cprofile (default): cProfile the event-loop
                          thread, pstats by cumulative time. mode=sample: a
                          sampling profiler over sys._current_frames() that
                          sees EVERY thread — dispatcher workers, hash
                          shards, writers — which cProfile structurally
                          cannot (it hooks only the calling thread)
started via `start_debug_server(port=...)` from any service composition root.

The port of dragonfly2_tpu/observability/server.py: the port's services
serve it on ``--metrics-port``, and its ``/metrics`` renders the port's
registry.
"""

from __future__ import annotations

from aiohttp import web

from dragonfly2_tpu_torch.observability.loophealth import LoopHealthMonitor, default_monitor
from dragonfly2_tpu_torch.observability.metrics import MetricsRegistry, default_registry
from dragonfly2_tpu_torch.observability.tracing import Tracer, default_tracer


def _dump_stacks() -> str:
    """All thread stacks + live asyncio tasks with their awaiting frames."""
    import asyncio
    import sys
    import traceback

    out: list[str] = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ---")
        out.extend(ln.rstrip() for ln in traceback.format_stack(frame))
    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:
        tasks = set()
    out.append(f"--- asyncio tasks ({len(tasks)}) ---")
    for t in tasks:
        out.append(repr(t))
        stack = t.get_stack(limit=8)
        for frame in stack:
            out.extend(
                ln.rstrip() for ln in traceback.format_stack(frame, limit=1)
            )
    return "\n".join(out) + "\n"


def _sample_threads(seconds: float, hz: float) -> str:
    """Sampling profiler over ALL threads (runs on a worker thread so a busy
    event loop cannot starve its own measurement): every 1/hz seconds, grab
    sys._current_frames() and count (thread, function) hits — leaf frame =
    self time, any frame = cumulative. cProfile only instruments the thread
    that enables it, so round CPU on dispatcher workers was
    invisible to /debug/profile; this mode sees every thread the process
    owns, including libgomp-adjacent native stubs parked in ctypes calls."""
    import sys
    import threading
    import time as _time
    from collections import Counter

    me = threading.get_ident()
    leaf: Counter = Counter()
    cum: Counter = Counter()
    names = {}
    period = 1.0 / hz
    deadline = _time.monotonic() + seconds
    ticks = 0
    while _time.monotonic() < deadline:
        ticks += 1
        names.update({t.ident: t.name for t in threading.enumerate()})
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # the sampler itself is noise
            tname = names.get(tid, str(tid))
            depth = 0
            seen = set()
            while frame is not None and depth < 64:
                code = frame.f_code
                key = (tname, f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{code.co_firstlineno})")
                if depth == 0:
                    leaf[key] += 1
                if key not in seen:  # recursion must not double-count
                    cum[key] += 1
                    seen.add(key)
                frame = frame.f_back
                depth += 1
        _time.sleep(period)
    # percentages are PER-THREAD occupancy (hits / ticks): a function
    # burning 100% of one worker reads 100%, not 100/nthreads — dividing by
    # total thread-samples diluted hot workers by the idle thread count
    out = [
        f"sampling profile: {seconds}s at {hz:.0f} Hz, {ticks} ticks "
        "(pct = fraction of ticks that thread sat in that frame)\n"
    ]
    for title, counter in (("self (leaf frames)", leaf), ("cumulative (any frame)", cum)):
        out.append(f"--- {title} ---")
        for (tname, where), n in counter.most_common(40):
            pct = 100.0 * n / max(1, ticks)
            out.append(f"{pct:6.1f}%  {n:6d}  [{tname}] {where}")
        out.append("")
    return "\n".join(out) + "\n"


def make_debug_app(
    registry: MetricsRegistry | None = None,
    tracer: Tracer | None = None,
    loophealth: LoopHealthMonitor | None = None,
    recorder=None,
    alerts=None,
    decisions=None,
) -> web.Application:
    from dragonfly2_tpu_torch.observability.alerts import default_engine
    from dragonfly2_tpu_torch.observability.metrics import metrics_http_handler
    from dragonfly2_tpu_torch.observability.timeseries import default_recorder

    reg = registry or default_registry()
    tr = tracer or default_tracer()
    lh = loophealth or default_monitor()
    rec = recorder or default_recorder()
    eng = alerts or default_engine()
    app = web.Application()
    metrics = metrics_http_handler(reg)
    profiling = {"active": False}

    async def healthz(_req: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def spans(_req: web.Request) -> web.Response:
        return web.json_response([s.to_dict() for s in tr.finished()])

    async def loop_health(_req: web.Request) -> web.Response:
        return web.json_response(lh.stats())

    async def timeseries(req: web.Request) -> web.Response:
        name = req.query.get("name")
        if not name:
            return web.json_response(
                {"recorder": rec.stats(), "series": rec.series()}
            )
        try:
            window = min(
                rec.retention_s, max(1.0, float(req.query.get("window", "60")))
            )
        except ValueError:
            raise web.HTTPBadRequest(text="window must be a number of seconds")
        out = {
            "name": name,
            "rate_per_s": rec.rate(name, window_s=window),
            "latest": rec.latest(name),
            "histogram": rec.hist_window(name, window_s=window),
            "series": rec.query(name),
        }
        return web.json_response(out)

    async def alerts_status(_req: web.Request) -> web.Response:
        return web.json_response(eng.status())

    async def decision_records(req: web.Request) -> web.Response:
        # decisions: a SchedulerService (composition roots pass theirs) — a
        # non-scheduler process answers with a typed "not here" instead of 404
        # so curl against the wrong port is self-explaining
        if decisions is None:
            return web.json_response(
                {"error": "no decision recorder in this process"}, status=404
            )
        try:
            limit = min(256, max(1, int(req.query.get("limit", "16"))))
        except ValueError:
            raise web.HTTPBadRequest(text="limit must be an integer")
        return web.json_response(decisions.decision_records(
            task_id=req.query.get("task") or None,
            child=req.query.get("child") or None,
            limit=limit,
            with_features=req.query.get("features", "1") != "0",
        ))

    async def stacks(_req: web.Request) -> web.Response:
        return web.Response(text=_dump_stacks(), content_type="text/plain")

    async def profile(req: web.Request) -> web.Response:
        import asyncio
        import cProfile
        import io
        import pstats

        try:
            seconds = min(60.0, max(0.1, float(req.query.get("seconds", "5"))))
            hz = min(1000.0, max(10.0, float(req.query.get("hz", "200"))))
        except ValueError:
            raise web.HTTPBadRequest(text="seconds/hz must be numbers")
        mode = req.query.get("mode", "cprofile")
        if mode not in ("cprofile", "sample"):
            raise web.HTTPBadRequest(text="mode must be cprofile or sample")
        if profiling["active"]:
            raise web.HTTPConflict(text="a profile is already running")
        profiling["active"] = True
        try:
            if mode == "sample":
                text = await asyncio.to_thread(_sample_threads, seconds, hz)
                return web.Response(text=text, content_type="text/plain")
            pr = cProfile.Profile()
            pr.enable()
            await asyncio.sleep(seconds)
            pr.disable()
        finally:
            profiling["active"] = False
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(60)
        return web.Response(text=buf.getvalue(), content_type="text/plain")

    app.router.add_get("/metrics", metrics)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/debug/spans", spans)
    app.router.add_get("/debug/loop", loop_health)
    app.router.add_get("/debug/ts", timeseries)
    app.router.add_get("/debug/alerts", alerts_status)
    app.router.add_get("/debug/decisions", decision_records)
    app.router.add_get("/debug/stacks", stacks)
    app.router.add_get("/debug/profile", profile)
    return app


class DebugServer:
    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        loophealth: LoopHealthMonitor | None = None,
        recorder=None,
        alerts=None,
        decisions=None,
    ):
        self.host = host
        self.port = port
        self._app = make_debug_app(
            registry, tracer, loophealth, recorder, alerts, decisions
        )
        self._runner: web.AppRunner | None = None

    async def start(self) -> None:
        self._runner = web.AppRunner(self._app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            self.port = site._server.sockets[0].getsockname()[1]  # type: ignore[union-attr]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None


async def start_debug_server(
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    registry: MetricsRegistry | None = None,
    tracer: Tracer | None = None,
    loophealth: LoopHealthMonitor | None = None,
    recorder=None,
    alerts=None,
    decisions=None,
) -> DebugServer:
    srv = DebugServer(
        host=host, port=port, registry=registry, tracer=tracer,
        loophealth=loophealth, recorder=recorder, alerts=alerts,
        decisions=decisions,
    )
    await srv.start()
    return srv
