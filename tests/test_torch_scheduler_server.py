"""The port's scheduler over the wire and as a process.

- The port's ``serve_scheduler`` answers the reference's
  ``RemoteSchedulerClient`` and the port's one sequence of calls (hosts,
  probes, registrations, piece and peer results, batched reports, an
  announce, reschedules, an unknown peer, leaves, stats, federation and
  decision records) exactly as an in-process client of an identical service
  does.
- ``python -m dragonfly2_tpu_torch.scheduler.server --port 0 --evaluator
  ml`` prints ``SCHEDULER_READY <addr>``, logs the port evaluator's serving
  mode, serves a short ``dfstress --swarm`` from the port's client with no
  error, and stops on SIGTERM within 10 s with exit code 0.
- A booted server (base, a model-less ml with telemetry and a trainer
  announcer, and a model-less ml with a manager link and federation) has
  loaded no module of jax, flax, torch or dragonfly2_tpu.
- ``--manager``, the link's settings, a ``rollout:`` section and
  ``--federation-peers`` boot (with the manager down, the scheduler serves
  standalone); a port scheduler process attaches a model published to a
  port manager process, and its stats frames reach the manager.
- The flags the port once refused (``--metrics-port``, a ``tracing:``
  exporter) boot, with or without a manager: the debug server answers
  ``/metrics`` with the port's registry, and the booted process has loaded
  no torch.

Every subprocess has a deadline of 120 s or less.
"""

import asyncio
import json
import os
import random
import signal
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from dragonfly2_tpu.daemon.engine import InProcessSchedulerClient
from dragonfly2_tpu.rpc import scheduler as ref_rpc
from dragonfly2_tpu_torch.rpc import scheduler as port_rpc
from dragonfly2_tpu_torch.rpc.core import RpcError
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.scheduler.scheduling import SchedulingConfig
from dragonfly2_tpu_torch.utils.clock import VirtualClock
from dragonfly2_tpu_torch.utils.proc import ready_address

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 60.0
SERVER = [sys.executable, "-m", "dragonfly2_tpu_torch.scheduler.server", "--host", "127.0.0.1", "--port", "0"]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def _service():
    svc = port_service.SchedulerService(
        scheduling_config=SchedulingConfig(retry_interval=0.001), clock=VirtualClock(start=50.0),
        topology_rng=random.Random(2), decision_sample_rate=1.0,
    )
    svc.scheduling.set_rng_state(random.Random(1).getstate())
    return svc


def _plain(x):
    """A result as plain values, whichever package's dataclasses carry it."""
    if hasattr(x, "__dataclass_fields__"):
        return asdict(x)
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


async def _steps(client, wire) -> list:
    """One sequence of scheduler calls; ``wire`` is the module whose
    HostInfo/TaskMeta the client takes. Returns every answer, plain."""
    hosts = [wire.HostInfo(id=f"h{i}", ip=f"10.2.0.{i}", hostname=f"n{i}", port=7000 + i, download_port=8000 + i,
                           idc=f"idc{i % 2}", location=f"cn|r{i % 3}") for i in range(12)]
    meta = wire.TaskMeta(task_id="t", url="http://origin/t", tag="x", filters=("sig",))
    out = []
    for h in hosts:
        out.append(await client.announce_host(h, {"cpu_usage": 0.25}))  # dflint: disable=DF025 one call at a time: the answers are compared in order
    for i, h in enumerate(hosts):
        out.append(await client.sync_probes(  # dflint: disable=DF025 one call at a time, as above
            h.id, [{"dst_host_id": f"h{(i + d) % 12}", "rtt_ms": 1.5 * d + i, "success": True} for d in (1, 2, 5)]))
    out.append(await client.register_peer("p0", meta, hosts[0]))
    await client.report_task_metadata("t", content_length=20 << 20, piece_size=4 << 20, digest="sha256:t")
    out.append(await client.report_pieces("p0", [(i, 2.0 + i, "") for i in range(5)]))
    out.append(await client.report_pieces("p0", [(1, 2.0, "")]))  # a retried flush: applies nothing
    await client.report_peer_result("p0", success=True, bandwidth_bps=3e8)
    for j in range(1, 8):
        r = await client.register_peer(f"p{j}", meta, hosts[j])  # dflint: disable=DF025 one round at a time, as above
        out.append(r)
        for k, par in enumerate(r.parents):
            await client.report_piece_result(f"p{j}", k, success=True, cost_ms=4.0 + k, parent_id=par.peer_id)  # dflint: disable=DF025 one report at a time, as above
        if j % 2:
            out.append(await client.report_batch(  # dflint: disable=DF025 one flush at a time, as above
                f"p{j}", [(k, 3.0, "p0") for k in range(3, 5)], {"success": True, "bandwidth_bps": 1e8}))
    await client.report_piece_result("p2", 4, success=False, parent_id="p0")
    await client.announce_task("a", meta, hosts[9], content_length=20 << 20, piece_size=4 << 20,
                               piece_indices=[0, 1, 2, 3, 4], digest="sha256:t")
    out.append(await client.reschedule("p2"))
    try:
        await client.reschedule("nobody")
        out.append("no error")
    except (KeyError, RpcError, ref_rpc.RpcError) as e:
        out.append(getattr(e, "code", "not_found"))
    await client.leave_peer("p3")
    await client.leave_host("h5")
    out.append(await client.stat_task("t"))
    out.append(await client.stat_task("none"))
    return [_plain(x) for x in out]


class _InProcess(InProcessSchedulerClient):
    """The reference daemon's in-process client, with the calls a daemon
    does not make."""

    async def stat_task(self, task_id):
        return self._svc.stat_task(task_id)


def _decisions(payload: dict) -> list:
    """A decision_records answer's records, less their (random) trace ids."""
    return [{k: v for k, v in r.items() if k != "trace_id"} for r in payload["records"]]


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_a_wire_client_gets_the_in_process_answers(client_pkg):
    rpc = port_rpc if client_pkg == "port" else ref_rpc

    async def body():
        local = _service()
        want = await _steps(_InProcess(local), port_service)
        want_decisions = _decisions(local.decision_records(limit=1000))
        want_fed = {k: v for k, v in local.federation_state().items() if k != "epoch"}
        served = _service()
        server = port_rpc.serve_scheduler(served, host="127.0.0.1", port=0)
        await server.start()
        client = rpc.RemoteSchedulerClient(server.address)
        try:
            got = await _steps(client, rpc)
            got_decisions = _decisions(await client.decision_records(limit=1000))
            got_fed = {k: v for k, v in (await client.federation_state()).items() if k != "epoch"}
            gossip = await client.federation_sync("peer-a", epoch="other")
        finally:
            await client.close()
            await server.stop()
            local.close()
            served.close()
        assert got == want
        assert got_decisions == want_decisions and len(want_decisions) >= 5
        assert got_fed == want_fed
        assert gossip["edges"] and gossip["epoch"] == served.federation_epoch

    asyncio.run(asyncio.wait_for(body(), DEADLINE_S))


def _stop(proc: subprocess.Popen, timeout: float) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    finally:
        proc.stdout.close()


def test_the_server_process_serves_a_swarm_and_stops_on_sigterm(tmp_path):
    deadline = time.monotonic() + 100.0
    log = tmp_path / "scheduler.log"
    with open(log, "w") as err:
        proc = subprocess.Popen([*SERVER, "--evaluator", "ml", "--telemetry-dir", str(tmp_path / "tel")],
                                cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        addr = ready_address(proc, "SCHEDULER_READY", deadline)
        p = subprocess.run(
            [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfstress", "--swarm", "--schedulers", addr,
             "--peers", "40", "--duration", "1.5"],
            cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=max(1.0, deadline - time.monotonic()),
        )
    finally:
        rc = _stop(proc, 10.0)  # raises if SIGTERM does not stop it within 10 s
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["extra"]["errors"] == 0 and out["extra"]["rounds"] > 0
    assert rc == 0
    text = log.read_text()
    assert "WARNING dragonfly2_tpu_torch.scheduler.evaluator ml evaluator serving mode: base" in text, text[-2000:]


_PROBE = """
import os, runpy, signal, sys
from dragonfly2_tpu_torch.utils import proc

serve = proc.run_until_signalled

async def probed(ready_event=None, on_ready=None):
    def report():
        on_ready()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "torch", "dragonfly2_tpu"))
        print("LOADED " + ",".join(bad), flush=True)
        os.kill(os.getpid(), signal.SIGTERM)
    await serve(ready_event, report)

proc.run_until_signalled = probed
sys.argv = ["server", *sys.argv[1:]]
runpy.run_module("dragonfly2_tpu_torch.scheduler.server", run_name="__main__")
"""


@pytest.mark.parametrize("args", [["--evaluator", "base"],
                                  ["--evaluator", "ml", "--telemetry-dir", "tel", "--trainer", "127.0.0.1:9"],
                                  ["--evaluator", "ml", "--manager", "127.0.0.1:9", "--federation-peers", "auto"]])
def test_a_booted_server_has_loaded_no_jax_torch_or_reference_module(args, tmp_path):
    p = subprocess.run([sys.executable, "-c", _PROBE, "--host", "127.0.0.1", "--port", "0", *args],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.splitlines()
    assert lines[0].startswith("SCHEDULER_READY 127.0.0.1:")
    assert lines[1] == "LOADED ", lines[1]


def _scrape(log: Path, deadline: float) -> str:
    """``/metrics`` of the debug server the scheduler's log names."""
    import re
    import urllib.request

    while True:
        m = re.search(r"scheduler metrics on [\d.]+:(\d+)", log.read_text())
        if m:
            with urllib.request.urlopen(f"http://127.0.0.1:{m.group(1)}/metrics", timeout=10) as r:
                return r.read().decode()
        assert time.monotonic() < deadline, log.read_text()[-2000:]
        time.sleep(0.05)


@pytest.mark.parametrize("args,item", [
    (["--metrics-port", "0"], "observability/server.py"),
    (["--config", "metrics.yaml"], "observability/server.py"),
    (["--config", "tracing.yaml"], "tracing exporters"),
    (["--config", "otlp.yaml"], "tracing exporters"),
    (["--manager", "127.0.0.1:65000", "--metrics-port", "0"], "observability/server.py"),
    (["--federation-peers", "auto", "--config", "tracing.yaml"], "tracing exporters"),
    (["--evaluator", "ml", "--metrics-port", "0", "--config", "otlp.yaml"], "observability/server.py"),
])
def test_flags_the_port_has_not_ported_are_refused(args, item, tmp_path):
    """Once refused with exit code 2, now ported: each boots and serves. The
    debug server's /metrics renders the port's registry; the booted process
    has loaded no torch."""
    (tmp_path / "tracing.yaml").write_text(f"tracing:\n  trace_file: {tmp_path / 'spans.jsonl'}\n")
    (tmp_path / "otlp.yaml").write_text(f"tracing:\n  otlp_file: {tmp_path / 'otlp.jsonl'}\n")
    (tmp_path / "metrics.yaml").write_text("metrics_port: 0\n")
    deadline = time.monotonic() + 60.0
    log = tmp_path / "scheduler.log"
    with open(log, "w") as err:
        proc = subprocess.Popen([*SERVER, *args], cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=err,
                                text=True)
    try:
        assert ready_address(proc, "SCHEDULER_READY", deadline).startswith("127.0.0.1:")
        if item == "observability/server.py":
            text = _scrape(log, deadline)
            assert "# TYPE dragonfly_scheduler_ml_serving_mode gauge" in text, text[:2000]
    finally:
        assert _stop(proc, 10.0) == 0
    p = subprocess.run([sys.executable, "-c", _PROBE, "--host", "127.0.0.1", "--port", "0", *args],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines()[1] == "LOADED ", p.stdout


@pytest.mark.parametrize("args", [
    ["--manager", "127.0.0.1:9", "--keepalive-interval", "5", "--model-watch-interval", "5",
     "--shadow-sample-rate", "0.5", "--idc", "idc-a", "--location", "cn|hz"],
    ["--federation-peers", "127.0.0.1:9001,127.0.0.1:9002", "--federation-interval", "0.5"],
    ["--config", "rollout.yaml", "--evaluator", "ml"],
])
def test_the_manager_link_and_federation_flags_boot(args, tmp_path):
    """With the manager down the link fails to start and the scheduler
    serves standalone, as the reference's does."""
    (tmp_path / "rollout.yaml").write_text("rollout:\n  shadow_sample_rate: 0.5\n  health_min_rounds: 10\n")
    deadline = time.monotonic() + 60.0
    proc = subprocess.Popen([*SERVER, *args], cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        addr = ready_address(proc, "SCHEDULER_READY", deadline)
        assert addr.startswith("127.0.0.1:")
    finally:
        assert _stop(proc, 10.0) == 0


def _train_artifact(root: Path) -> dict:
    """A small GNN artifact from the port's trainer service on the CPU."""
    from dragonfly2_tpu_torch.trainer import train_gnn, train_mlp
    from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records
    from dragonfly2_tpu_torch.trainer.synthetic import synth_telemetry_records

    cfg = TrainerConfig(
        model_dir=str(root / "models"), device="cpu",
        mlp=train_mlp.MLPTrainConfig(hidden=(16,), steps=4, batch_size=64),
        gnn=train_gnn.GNNTrainConfig(hidden=16, embed_dim=8, num_layers=2, batch_size=64, warmup_steps=1),
        gnn_steps=4, gnn_steps_per_call=4,
    )
    d, p = synth_telemetry_records(300, 200, 16, seed=4)

    async def body():
        svc = TrainerService(cfg)
        token = (await svc.train_open({"hostname": "sch1"}))["token"]
        for kind, arr in (("downloads", d), ("probes", p)):
            await svc.train_chunk({"token": token, "kind": kind, "data": pack_records(arr)})  # dflint: disable=DF025 one chunk per kind
        await svc.train_close({"token": token})
        await svc.wait_idle()
        return svc.last_result

    out = asyncio.run(asyncio.wait_for(body(), DEADLINE_S))
    assert "gnn" in out, out
    return out["gnn"]


def test_a_scheduler_process_attaches_a_model_from_a_manager_process(tmp_path):
    """Manager process, then a port scheduler process with ``--manager``
    and short intervals; a model published to the manager is attached
    (native engine) and the scheduler's frames name its serving mode."""
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient

    gnn = _train_artifact(tmp_path)
    deadline = time.monotonic() + 110.0
    env = {**_env(), "DRAGONFLY_TS_INTERVAL": "0.2"}
    mgr = subprocess.Popen([sys.executable, "-m", "dragonfly2_tpu_torch.manager.server", "--port", "0",
                            "--db", str(tmp_path / "m.db")],
                           cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    sched = None
    try:
        maddr = ready_address(mgr, "manager ready", deadline).removeprefix("rpc=")
        sched = subprocess.Popen([*SERVER, "--evaluator", "ml", "--manager", maddr, "--keepalive-interval", "0.5",
                                  "--model-watch-interval", "0.5", "--hostname", "sch-proc"],
                                 cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        ready_address(sched, "SCHEDULER_READY", deadline)

        async def drive():
            c = RemoteManagerClient(maddr, retries=0)
            try:
                row = await c.publish_model("gnn", "v1", artifact_path=gnn["artifact"], artifact_digest=gnn["digest"])
                assert row["state"] == "active"
                while time.monotonic() < deadline:
                    view = await c.cluster_stats()
                    frames = {m["hostname"]: m["frame"] for m in view["members"]}
                    if frames.get("sch-proc", {}).get("serving_mode") == "native":
                        return frames["sch-proc"], await c.list_schedulers()
                    await asyncio.sleep(0.2)
                raise AssertionError(f"no frame with serving mode native: {view}")
            finally:
                await c.close()

        frame, scheds = asyncio.run(asyncio.wait_for(drive(), DEADLINE_S))
        assert frame["service"] == "scheduler" and [s["hostname"] for s in scheds] == ["sch-proc"]
    finally:
        if sched is not None:
            assert _stop(sched, 10.0) == 0
        assert _stop(mgr, 10.0) == 0
