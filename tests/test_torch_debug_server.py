"""The port's debug server (observability/server.py) against the
reference's, and ``--metrics-port`` on the port's three servers.

- Every endpoint, the port's and the reference's app each over its own
  package's registry, tracer, loop monitor, recorder and alert engine:
  ``/metrics`` renders the registry, ``/healthz``, ``/debug/spans``,
  ``/debug/loop``, ``/debug/ts`` (catalog, one series, a bad window),
  ``/debug/alerts``, ``/debug/decisions`` (none in the process; a
  scheduler's records; a bad limit), ``/debug/stacks`` and
  ``/debug/profile`` (cProfile, the sampler that sees every thread, bad
  arguments, one profile at a time). Statuses and JSON keys are equal.
- The port's manager, scheduler and daemon processes with ``--metrics-port
  0`` serve the debug server: ``/metrics`` renders the port's families, and
  ``/debug/decisions`` answers on the scheduler alone.

Every coroutine and process runs under a deadline of 120 s.
"""

from __future__ import annotations

import asyncio
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import aiohttp
import pytest
import torch

from dragonfly2_tpu.observability import loophealth as ref_loophealth
from dragonfly2_tpu.observability import metrics as ref_metrics
from dragonfly2_tpu.observability import server as ref_server
from dragonfly2_tpu.observability import tracing as ref_tracing
from dragonfly2_tpu.scheduler import service as ref_service
from dragonfly2_tpu_torch.observability import loophealth as port_loophealth
from dragonfly2_tpu_torch.observability import metrics as port_metrics
from dragonfly2_tpu_torch.observability import server as port_server
from dragonfly2_tpu_torch.observability import tracing as port_tracing
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.utils.proc import ready_address

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 120.0
PKG = {
    "port": (port_server, port_metrics, port_tracing, port_loophealth, port_service),
    "ref": (ref_server, ref_metrics, ref_tracing, ref_loophealth, ref_service),
}


def _shape(x):
    """A JSON answer's keys all the way down (values differ by run)."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [_shape(x[0])] if x else []
    return type(x).__name__


async def _drive(pkg: str, decisions: bool) -> dict:
    server_mod, metrics_mod, tracing_mod, loop_mod, service_mod = PKG[pkg]
    reg = metrics_mod.MetricsRegistry()
    reg.counter("hits").inc(5)
    tracer = tracing_mod.Tracer(service="dbg")
    with tracer.span("something", k=1):
        pass
    mon = loop_mod.LoopHealthMonitor(interval=0.02, registry=metrics_mod.MetricsRegistry())
    svc = service_mod.SchedulerService(decision_sample_rate=1.0) if decisions else None
    mon.start()
    srv = await server_mod.start_debug_server(registry=reg, tracer=tracer, loophealth=mon, decisions=svc)
    base = f"http://127.0.0.1:{srv.port}"
    out: dict = {}
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(2000))

    spinner = threading.Thread(target=spin, name="df-test-spin", daemon=True)  # dflint: disable=DF026 the sampler needs a live non-loop thread to find
    try:
        await asyncio.sleep(0.1)
        async with aiohttp.ClientSession() as sess:
            async def get(path: str, kind: str = "json"):
                async with sess.get(base + path) as r:
                    body = await (r.json() if kind == "json" and r.status == 200 else r.text())
                    return r.status, body

            status, text = await get("/metrics", "text")
            out["metrics"] = (status, "dragonfly_hits 5" in text)
            out["healthz"] = await get("/healthz")
            status, spans = await get("/debug/spans")
            out["spans"] = (status, [(s["name"], s["attrs"]) for s in spans])
            status, loop = await get("/debug/loop")
            out["loop"] = (status, _shape(loop), loop["running"], loop["samples"] >= 1)
            status, ts = await get("/debug/ts")
            out["ts"] = (status, sorted(ts))
            status, one = await get("/debug/ts?name=dragonfly_hits&window=30")
            out["ts_one"] = (status, sorted(one))
            out["ts_bad"] = (await get("/debug/ts?name=x&window=nope", "text"))[0]
            status, alerts = await get("/debug/alerts")
            out["alerts"] = (status, _shape(alerts))
            status, dec = await get("/debug/decisions?limit=4&features=0")
            if status == 200 and pkg == "port":
                # the port's answer adds the fallbacks by reason (its one
                # difference, scheduler/service.py)
                assert set(dec.pop("fallbacks")) == {"no_scorer", "unknown_hosts", "scorer_error", "degraded"}
            out["decisions"] = (status, _shape(dec) if status == 200 else dec)
            out["decisions_bad"] = (await get("/debug/decisions?limit=x", "text"))[0] if decisions else None
            status, stacks = await get("/debug/stacks", "text")
            out["stacks"] = (status, "asyncio tasks" in stacks and "--- thread" in stacks)
            status, prof = await get("/debug/profile?seconds=0.2", "text")
            out["cprofile"] = (status, "cumulative" in prof)
            spinner.start()  # only while the sampler looks
            status, sample = await get("/debug/profile?mode=sample&seconds=0.3&hz=100", "text")
            stop.set()
            spinner.join(10)
            out["sample"] = (status, "df-test-spin" in sample)
            out["profile_bad"] = [(await get(q, "text"))[0] for q in
                                  ("/debug/profile?seconds=nope", "/debug/profile?mode=perf")]
            first = asyncio.ensure_future(get("/debug/profile?seconds=1.5", "text"))
            await asyncio.sleep(0.5)
            out["profile_busy"] = (await get("/debug/profile?seconds=0.1", "text"))[0]
            out["profile_first"] = (await first)[0]
    finally:
        stop.set()
        if spinner.ident is not None:
            spinner.join(10)
        mon.stop()
        await srv.stop()
        if svc is not None:
            svc.close()
    return out


@pytest.mark.parametrize("decisions", [False, True], ids=["no-recorder", "a-scheduler"])
def test_every_endpoint_answers_as_the_references(decisions):
    port = asyncio.run(asyncio.wait_for(_drive("port", decisions), DEADLINE_S))
    ref = asyncio.run(asyncio.wait_for(_drive("ref", decisions), DEADLINE_S))
    assert port == ref
    assert port["metrics"] == (200, True) and port["healthz"] == (200, {"status": "ok"})
    assert port["spans"] == (200, [("something", {"k": 1, "service": "dbg"})])
    assert port["loop"][2:] == (True, True) and port["sample"] == (200, True)
    assert port["ts_bad"] == 400 and port["profile_bad"] == [400, 400]
    assert (port["profile_busy"], port["profile_first"]) == (409, 200)
    if decisions:
        assert port["decisions"][0] == 200 and port["decisions_bad"] == 400
    else:
        assert port["decisions"] == (404, '{"error": "no decision recorder in this process"}')


# ---------------------------------------------------------------------------
# --metrics-port on the three servers


def _env() -> dict:
    import os

    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def _boot(args: list[str], prefix: str, log: Path, cwd: Path) -> subprocess.Popen:
    with open(log, "w") as err:
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                             stderr=err, text=True)
    ready_address(p, prefix, time.monotonic() + 60)
    return p


def _metrics_port(log: Path, what: str) -> int:
    deadline = time.monotonic() + 30
    while True:
        m = re.search(rf"{what} metrics on [\d.]+:(\d+)", log.read_text())
        if m:
            return int(m.group(1))
        assert time.monotonic() < deadline, log.read_text()[-2000:]
        time.sleep(0.05)


async def _scrape(port: int) -> dict:
    async with aiohttp.ClientSession() as sess:
        async with sess.get(f"http://127.0.0.1:{port}/metrics") as r:
            text = await r.text()
        async with sess.get(f"http://127.0.0.1:{port}/debug/decisions?features=0") as r:
            decisions = r.status
        async with sess.get(f"http://127.0.0.1:{port}/debug/alerts") as r:
            alerts = r.status
    families = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}
    return {"families": families, "decisions": decisions, "alerts": alerts}


def test_each_server_serves_metrics_on_its_metrics_port(tmp_path):
    procs = []
    try:
        mgr = _boot(["dragonfly2_tpu_torch.manager.server", "--port", "0", "--db", str(tmp_path / "m.db"),
                     "--metrics-port", "0"], "manager ready", tmp_path / "manager.log", tmp_path)
        procs.append(mgr)
        sched = subprocess.Popen([sys.executable, "-m", "dragonfly2_tpu_torch.scheduler.server", "--port", "0",
                                  "--metrics-port", "0"], cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
                                 stderr=open(tmp_path / "scheduler.log", "w"), text=True)
        procs.append(sched)
        addr = ready_address(sched, "SCHEDULER_READY", time.monotonic() + 60)
        daemon = _boot(["dragonfly2_tpu_torch.daemon.server", "--scheduler", addr, "--storage",
                        str(tmp_path / "d"), "--sock", str(tmp_path / "d.sock"), "--metrics-port", "0"],
                       "DAEMON_READY", tmp_path / "daemon.log", tmp_path)
        procs.append(daemon)
        got = {}
        for name, what in (("manager", "manager"), ("scheduler", "scheduler"), ("daemon", "daemon")):
            port = _metrics_port(tmp_path / f"{name}.log", what)
            got[name] = asyncio.run(asyncio.wait_for(_scrape(port), DEADLINE_S))
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert "dragonfly_scheduler_ml_serving_mode" in got["scheduler"]["families"]
    assert "dragonfly_dfdaemon_piece_tls_handshakes_total" in got["daemon"]["families"]
    assert all("dragonfly_loop_lag_seconds" in g["families"] for g in got.values()), got
    assert {k: (g["decisions"], g["alerts"]) for k, g in got.items()} == {
        "manager": (404, 200), "scheduler": (200, 200), "daemon": (404, 200)}
