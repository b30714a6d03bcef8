"""The port's operator CLIs against the reference's: ``dftop``, ``dfml``,
``dfmodel`` and ``dfsim``.

Both packages' CLIs run against the same in-process port servers (a
manager with scheduler and trainer members and a model registry, a
scheduler whose decision recorder keeps every round, a trainer with a
finished run), started on an event loop of their own thread, as
``tests/test_torch_manager.py`` starts them. Each command's standard output
and exit code must be equal; the only fields allowed to differ are a
``cluster_stats`` answer's ``ts`` and a member's ``age_s``. The commands
that change the registry (``dfmodel promote``, ``rollback``) run against
two managers built by the same script, one for each package, whose rows'
own timestamps may differ too.

Covered: ``dftop --once`` (0, and 3 with no member reporting), its screen;
``dfml explain`` (0, 2 for no record, 3 for a record whose scores were
tampered with), ``decisions`` and ``train``; ``dfmodel status``, ``promote``
and ``rollback``, and ``publish``/``fetch`` exiting 2 in the port with the
ROADMAP.md item named; ``python -m dragonfly2_tpu_torch.cli.dfsim
flash-crowd --peers 300 --json`` as a subprocess against the reference's
(both under one hash seed, on which the order of events depends), its
human screen and its usage errors.

Every subprocess has a deadline of 120 s or less.
"""

import asyncio
import io
import json
import os
import random
import re
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from dragonfly2_tpu.cli import dfml as ref_dfml
from dragonfly2_tpu.cli import dfmodel as ref_dfmodel
from dragonfly2_tpu.cli import dfsim as ref_dfsim
from dragonfly2_tpu.cli import dftop as ref_dftop
from dragonfly2_tpu_torch.cli import dfml, dfmodel, dfsim, dftop
from dragonfly2_tpu_torch.daemon.engine import InProcessSchedulerClient
from dragonfly2_tpu_torch.manager.server import ManagerServer
from dragonfly2_tpu_torch.rpc import scheduler as port_rpc
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.scheduler.scheduling import SchedulingConfig
from dragonfly2_tpu_torch.trainer import train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer.server import start_trainer, stop_trainer
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import synth_telemetry_records
from dragonfly2_tpu_torch.utils.clock import VirtualClock

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 120.0
TIMESTAMPS = frozenset({"ts", "age_s"})


# and in two registries built by one script, their rows' own times
ROW_TIMES = TIMESTAMPS | {"created_at", "updated_at", "last_keepalive", "at"}


def strip_times(x, keys=TIMESTAMPS):
    if isinstance(x, dict):
        return {k: strip_times(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, list):
        return [strip_times(v, keys) for v in x]
    return x


class Loop:
    """An event loop on a thread of its own: the servers live there, so a
    CLI's ``asyncio.run`` can run on the test's thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def __call__(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(DEADLINE_S)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10.0)
        self.loop.close()


def cli(main, argv: list[str], *, sys_argv: bool = False) -> tuple[int, str, str]:
    """Exit code, standard output and standard error of one CLI call;
    ``sys_argv`` for a ``main()`` that reads ``sys.argv`` (dfmodel's)."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    with redirect_stdout(out), redirect_stderr(err):
        try:
            if sys_argv:
                sys.argv = ["dfmodel", *argv]
                rc = main()
            else:
                rc = main(argv)
        except SystemExit as e:
            rc = e.code
        finally:
            sys.argv = saved
    return rc, out.getvalue(), err.getvalue()


def both(port_main, ref_main, argv, **kw) -> tuple[int, str]:
    """Run the port's and the reference's CLI; exit codes and standard
    output must be equal. Returns them."""
    rc, out, _ = cli(port_main, argv, **kw)
    ref_rc, ref_out, _ = cli(ref_main, argv, **kw)
    assert (rc, out) == (ref_rc, ref_out), argv
    return rc, out


def both_json(port_main, ref_main, argv, **kw) -> tuple[int, dict]:
    rc, out, _ = cli(port_main, argv, **kw)
    ref_rc, ref_out, _ = cli(ref_main, argv, **kw)
    doc, ref_doc = json.loads(out), json.loads(ref_out)
    assert rc == ref_rc and strip_times(doc) == strip_times(ref_doc), argv
    return rc, doc


def frame(host: str, service: str = "scheduler", **rates) -> dict:
    return {"service": service, "ts": time.time(), "window_s": 60.0, "hostname": host, "rates": rates,
            "serving_mode": "torch" if service == "scheduler" else "-", "rollout_state": "serving",
            "piece_cipher": "none", "alerts": ["scorer_error_rate"] if rates.get("degradation_level") else []}


def registry(svc) -> None:
    """Members with frames and a model registry: v1 then v2 active, v3 a
    candidate shadowing under a gate."""
    svc.update_scheduler("sch-a", "10.0.0.1", 8002, idc="idc-a", location="eu|r1")
    svc.update_scheduler("sch-b", "10.0.0.2", 8002)
    svc.keepalive("scheduler", "sch-a", stats=frame("sch-a", rounds_per_s=120.5, round_p95_ms=3.25,
                                                    feature_drift_max=0.31, degradation_level=2.0,
                                                    manager_unreachable=1.0))
    svc.keepalive("scheduler", "sch-b", stats=frame("sch-b", rounds_per_s=7.0, feature_drift_max=0.02,
                                                    dispatcher_utilization=0.5, loop_lag_p95_ms=1.5))
    svc.keepalive("trainer", "trainer-1", stats=frame("trainer-1", "trainer", train_steps_per_s=3.5))
    svc.publish_model("gnn", "v1", artifact_path="/m/v1", artifact_digest="d1", evaluation={"auc": 0.7})
    svc.publish_model("gnn", "v2", artifact_path="/m/v2", artifact_digest="d2")
    svc.set_config("model_rollout", {"enabled": True, "types": ["gnn"], "auto_promote": False,
                                     "gates": {"min_rounds": 4}})
    svc.publish_model("gnn", "v3", artifact_path="/m/v3", artifact_digest="d3")
    v3 = svc.db.find_one("models", version="v3")["id"]
    svc.report_shadow(v3, "sch-a", {"rounds": 8, "uncovered": 0, "errors": 0, "seen": 8, "topk_overlap_mean": 0.75,
                                    "topk_overlap_min": 0.5, "rank_corr_mean": 0.6, "abs_delta_mean": 0.05,
                                    "abs_delta_max": 0.2, "abs_delta_p99": 0.19,
                                    "delta_hist": {"buckets": [], "counts": []}, "slices": {}})


async def scheduler_rounds(svc) -> None:
    """Hosts, probes and a few dozen scheduling rounds over the port's
    in-process client: every round is recorded (sample rate 1)."""
    client = InProcessSchedulerClient(svc)
    hosts = [port_service.HostInfo(id=f"h{i}", ip=f"10.4.0.{i}", hostname=f"n{i}", download_port=8000 + i,
                                   idc=f"idc{i % 2}", location=f"eu|rack{i % 3}") for i in range(24)]
    for i, h in enumerate(hosts):
        await client.announce_host(h)  # dflint: disable=DF025 in-process set-up, one host at a time
        await client.sync_probes(h.id, [  # dflint: disable=DF025 in-process set-up, as above
            {"dst_host_id": f"h{(i + d) % 24}", "rtt_ms": 0.7 * d + 0.1 * i, "success": True} for d in (1, 3, 7)])
    meta = port_service.TaskMeta("task-a", "http://origin/a")
    await client.register_peer("p0", meta, hosts[0])
    await client.report_task_metadata("task-a", content_length=32 << 20, piece_size=4 << 20)
    await client.report_pieces("p0", [(k, 2.0, "") for k in range(8)])
    await client.report_peer_result("p0", success=True, bandwidth_bps=3e8)
    for j in range(1, 24):
        r = await client.register_peer(f"p{j}", meta, hosts[j])  # dflint: disable=DF025 one round at a time: each child sees its predecessors as parents
        if r.parents:
            await client.report_pieces(f"p{j}", [(k, 2.0 + j % 5, r.parents[k % len(r.parents)].peer_id)  # dflint: disable=DF025 as above
                                                 for k in range(8)])
            await client.report_peer_result(f"p{j}", success=True, bandwidth_bps=1e8 + j)  # dflint: disable=DF025 as above


async def train_once(service) -> None:
    d, p = synth_telemetry_records(300, 200, 20, seed=11)
    token = (await service.train_open({"hostname": "sch-a", "scheduler_id": 0}))["token"]
    for kind, arr in (("downloads", d), ("probes", p)):
        await service.train_chunk({"token": token, "kind": kind, "data": pack_records(arr)})  # dflint: disable=DF025 the upload protocol is one train_chunk per kind here
    await service.train_close({"token": token})
    await service.wait_idle()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ops")
    loop = Loop()
    svc = port_service.SchedulerService(
        scheduling_config=SchedulingConfig(retry_interval=0.001), clock=VirtualClock(start=80.0),
        topology_rng=random.Random(5), decision_sample_rate=1.0)
    svc.scheduling.set_rng_state(random.Random(6).getstate())
    config = TrainerConfig(
        model_dir=str(tmp / "models"), device="cpu",
        mlp=train_mlp.MLPTrainConfig(hidden=(32, 16), steps=25, batch_size=64),
        gnn=train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=64, warmup_steps=2),
        gnn_steps=12, gnn_steps_per_call=4)

    async def up():
        manager = ManagerServer(db_path=str(tmp / "m.db"), host="127.0.0.1", port=0)
        empty = ManagerServer(db_path=str(tmp / "empty.db"), host="127.0.0.1", port=0)
        await manager.start()
        await empty.start()
        registry(manager.service)
        await scheduler_rounds(svc)
        server = port_rpc.serve_scheduler(svc, host="127.0.0.1", port=0)
        await server.start()
        trainer, tservice = await start_trainer(config, port=0)
        await train_once(tservice)
        return manager, empty, server, trainer, tservice

    manager, empty, server, trainer, tservice = loop(up())
    try:
        yield {"loop": loop, "manager": manager, "empty": empty, "scheduler": server.address, "svc": svc,
               "trainer": trainer.address, "tmp": tmp}
    finally:
        async def down():
            await stop_trainer(trainer, tservice)
            await server.stop()
            await empty.stop()
            await manager.stop()

        loop(down())
        loop.close()
        svc.close()


# ---------------------------------------------------------------------------
# dftop


def test_dftop_once(cluster):
    addr = cluster["manager"].address
    rc, doc = both_json(dftop.main, ref_dftop.main, ["--manager", addr, "--once", "--json"])
    assert rc == 0 and {m["hostname"] for m in doc["members"]} == {"sch-a", "sch-b", "trainer-1"}
    rc, doc = both_json(dftop.main, ref_dftop.main, ["--manager", addr, "--once", "--json", "--history", "2"])
    assert rc == 0 and all(m.get("history") for m in doc["members"])
    # the screen's clock and ages move between two calls: its text is held
    # to the reference's in the next test, on one cluster_stats answer
    rc, out, _ = cli(dftop.main, ["--manager", addr, "--once"])
    assert rc == cli(ref_dftop.main, ["--manager", addr, "--once"])[0] == 0
    assert "sch-a" in out and "mgr_down" in out and "trainer-1" in out
    # no member has reported a frame: 3, in both
    rc, doc = both_json(dftop.main, ref_dftop.main, ["--manager", cluster["empty"].address, "--once", "--json"])
    assert rc == 3 and doc["members"] == []
    rc, out = both(dftop.main, ref_dftop.main, ["--manager", cluster["empty"].address, "--once"])
    assert rc == 3 and "no members have reported" in out


def test_dftop_screen_is_the_references(cluster):
    stats = cluster["manager"].service.cluster_stats(history=1)
    assert dftop.render(stats) == ref_dftop.render(stats)
    assert dftop.render(stats, clear=True) == ref_dftop.render(stats, clear=True)
    assert dftop.members_healthy(stats) is ref_dftop.members_healthy(stats) is True
    assert dftop.members_healthy(stats, max_age_s=-1.0) is ref_dftop.members_healthy(stats, max_age_s=-1.0) is False
    assert dftop.render({}) == ref_dftop.render({})
    frameless = {"members": [{"hostname": "s", "frame": {"serving_mode": "torch"}}]}
    assert dftop.members_healthy(frameless) is ref_dftop.members_healthy(frameless) is False


# ---------------------------------------------------------------------------
# dfml


def _records(cluster) -> list:
    return cluster["svc"].decision_records(limit=1000, with_features=False)["records"]


def test_dfml_explain(cluster):
    sched = cluster["scheduler"]
    records = [r for r in _records(cluster) if len(r["parents"]) >= 2]
    assert len(records) >= 8
    rec = records[0]
    for extra in ([], ["--all"], ["--json"], ["--limit", "2", "--all"]):
        rc, out = both(dfml.main, ref_dfml.main, ["explain", "--scheduler", sched, rec["task_id"],
                                                 rec["child_peer"], *extra])
        assert rc == 0 and ("bit-exact" in out or '"replay_exact": [\n    true' in out)
    rc, out = both(dfml.main, ref_dfml.main, ["explain", "--scheduler", sched, rec["task_id"], rec["child_host"]])
    assert rc == 0 and rec["child_peer"] in out
    # no matching record: 2
    for extra in ([], ["--json"]):
        rc, _ = both(dfml.main, ref_dfml.main, ["explain", "--scheduler", sched, "no-such-task", "p1", *extra])
        assert rc == 2


def test_dfml_explain_exits_3_on_a_tampered_record(cluster):
    ring = cluster["svc"].decisions._ring
    rec = next(r for r in reversed(ring) if len(r["parents"]) >= 2 and len(set(np.asarray(r["scores"]))) >= 2)
    saved = rec["scores"]
    rec["scores"] = -np.asarray(saved)  # the recorded choice no longer replays
    try:
        for extra in ([], ["--json"]):
            rc, out = both(dfml.main, ref_dfml.main, ["explain", "--scheduler", cluster["scheduler"],
                                                     rec["task_id"], rec["child_peer"], *extra])
            assert rc == 3 and ("!= recorded" in out or "false" in out)
    finally:
        rec["scores"] = saved


def test_dfml_decisions(cluster):
    sched = cluster["scheduler"]
    rc, doc = both_json(dfml.main, ref_dfml.main, ["decisions", "--scheduler", sched, "--json", "--limit", "64"])
    assert rc == 0 and len(doc["records"]) >= 8 and all("feats" not in r for r in doc["records"])
    for extra in ([], ["--task", "task-a"], ["--task", "other"]):
        rc, out = both(dfml.main, ref_dfml.main, ["decisions", "--scheduler", sched, *extra])
        assert rc == 0 and "decision recorder:" in out


def test_dfml_train(cluster):
    trainer = cluster["trainer"]
    rc, doc = both_json(dfml.main, ref_dfml.main, ["train", "--trainer", trainer, "--json"])
    assert rc == 0 and doc["total"] == 1 and doc["runs"][0]["status"] == "ok"
    assert set(doc["runs"][0]["models"]) == {"mlp", "gnn"} and doc["runs"][0]["models"]["gnn"]["curve"]
    for extra in ([], ["--no-curves"], ["--limit", "1"]):
        rc, out = both(dfml.main, ref_dfml.main, ["train", "--trainer", trainer, *extra])
        assert rc == 0 and "train runs: 1 recorded" in out
    assert dfml.sparkline([3.0, float("nan"), 1.0, 0.5] * 30) == ref_dfml.sparkline([3.0, float("nan"), 1.0, 0.5] * 30)
    assert dfml.replay_topk([0.5, 0.5, 0.9, -1.0], 3) == ref_dfml.replay_topk([0.5, 0.5, 0.9, -1.0], 3) == [2, 0, 1]


# ---------------------------------------------------------------------------
# dfmodel


def test_dfmodel_status(cluster):
    addr = cluster["manager"].address
    rc, doc = both_json(dfmodel.main, ref_dfmodel.main, ["status", "--manager", addr, "--json"], sys_argv=True)
    assert rc == 0 and doc["active"]["version"] == "v2"
    assert [c["version"] for c in doc["candidates"]] == ["v3"]
    rc, out = both(dfmodel.main, ref_dfmodel.main, ["status", "--manager", addr], sys_argv=True)
    assert rc == 0 and "active:    v2" in out and "feature_drift_max=0.310" in out
    rc, out = both(dfmodel.main, ref_dfmodel.main, ["status", "--manager", addr, "--type", "mlp"], sys_argv=True)
    assert rc == 0 and "<none>" in out


def _twin_managers(cluster, run):
    """Two managers built by the same script: one per package's CLI."""
    loop, tmp = cluster["loop"], cluster["tmp"]

    async def up():
        out = []
        for tag in ("port", "ref"):
            m = ManagerServer(db_path=str(tmp / f"{run}-{tag}.db"), host="127.0.0.1", port=0)
            await m.start()
            registry(m.service)
            out.append(m)
        return out

    return loop(up())


def test_dfmodel_promote_and_rollback(cluster):
    port_m, ref_m = _twin_managers(cluster, "promote")
    steps = [
        (["promote", "--version", "v3"], 0),
        (["promote", "--version", "v9"], 1),  # no such row
        (["promote", "--id", "1"], 0),
        (["rollback", "--reason", "operator rollback test"], 0),
        (["rollback", "--type", "mlp"], 1),  # nothing active to roll back
        (["promote"], 2),  # neither --version nor --id
        (["status", "--json"], 0),
    ]
    try:
        for argv, want in steps:
            rc, out, _ = cli(dfmodel.main, [*argv, "--manager", port_m.address], sys_argv=True)
            ref_rc, ref_out, _ = cli(ref_dfmodel.main, [*argv, "--manager", ref_m.address], sys_argv=True)
            assert rc == ref_rc == want, argv
            if "--json" in argv:  # two registries: their rows' own timestamps differ
                assert strip_times(json.loads(out), ROW_TIMES) == strip_times(json.loads(ref_out), ROW_TIMES)
            else:
                assert out == ref_out, argv
        assert json.loads(out)["active"]["version"] == "v3"
        states = {r["version"]: r["state"] for r in port_m.service.list_models(type="gnn")}
        assert states == {r["version"]: r["state"] for r in ref_m.service.list_models(type="gnn")}
        assert states["v1"] == "rejected"
    finally:
        async def down():
            await port_m.stop()
            await ref_m.stop()

        cluster["loop"](down())


@pytest.mark.parametrize("argv", [["publish", "ckpt-dir"], ["fetch", "m.json", "-O", "out"],
                                  ["--no-spawn", "publish", "ckpt-dir", "--name", "x"]])
def test_dfmodel_publish_and_fetch_exit_2_naming_the_roadmap_item(argv, tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, out, err = cli(dfmodel.main, argv, sys_argv=True)
    finally:
        os.chdir(cwd)
    assert rc == 2 and out == "" and "ROADMAP.md §1, queue item 4" in err and "daemon" in err
    assert list(tmp_path.iterdir()) == []  # it touched nothing


def test_dfmodel_parser_is_the_references():
    for argv in (["status"], ["bogus"], ["promote", "--manager", "x", "--id", "no"]):
        rc, _, err = cli(dfmodel.main, argv, sys_argv=True)
        ref_rc, _, ref_err = cli(ref_dfmodel.main, argv, sys_argv=True)
        assert rc == ref_rc == 2 and err == ref_err, argv
    assert "dfget" not in sys.modules.get("dragonfly2_tpu_torch.cli.dfmodel").__dict__


def test_the_clis_load_no_torch_jax_daemon_or_aiohttp():
    """The operator CLIs and dfsim talk RPC or run the simulator: importing
    them loads no torch, JAX, aiohttp, daemon module or reference module."""
    code = ("import sys\n"
            "import dragonfly2_tpu_torch.cli.dfsim, dragonfly2_tpu_torch.cli.dftop\n"
            "import dragonfly2_tpu_torch.cli.dfml, dragonfly2_tpu_torch.cli.dfmodel\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'aiohttp', 'dragonfly2_tpu') or m.startswith('dragonfly2_tpu_torch.daemon')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=DEADLINE_S, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# dfsim


def _dfsim(module: str, args: list[str]) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO), "PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=DEADLINE_S)


def test_dfsim_json_as_a_process_is_the_references():
    args = ["flash-crowd", "--peers", "300", "--seed", "1", "--json"]
    port = _dfsim("dragonfly2_tpu_torch.cli.dfsim", args)
    assert port.returncode == 0, port.stderr[-2000:]
    ref = _dfsim("dragonfly2_tpu.cli.dfsim", args)
    assert ref.returncode == 0, ref.stderr[-2000:]
    got, want = json.loads(port.stdout.strip().splitlines()[-1]), json.loads(ref.stdout.strip().splitlines()[-1])
    for doc in (got, want):
        for k in ("wall_s", "events_per_sec", "time_compression"):
            doc.pop(k)
        for k in ("sched_s", "rounds_per_s"):
            doc["scheduler"].pop(k)
    assert got == want
    assert got["peers"] == 300 and got["assertions"]["passed"] and got["telemetry"]["nodes"] > 0


def test_dfsim_screen_and_usage_errors():
    argv = ["thundering-rejoin", "--peers", "120", "--no-telemetry"]
    rc, out, _ = cli(dfsim.main, argv)
    ref_rc, ref_out, _ = cli(ref_dfsim.main, argv)
    meter = re.compile(r"^events \d+ in .*$", re.MULTILINE)  # the wall-time meter line
    assert rc == ref_rc == 0 and meter.sub("", out) == meter.sub("", ref_out) and "PASS" in out
    for argv in (["partition-and-heal", "--scoring", "ml-native"], ["no-such-scenario"],
                 ["flash-crowd", "--scoring", "torch"]):
        rc, _, err = cli(dfsim.main, argv)
        ref_rc, _, ref_err = cli(ref_dfsim.main, argv)
        assert rc == ref_rc == 2 and err == ref_err, argv
    assert "--scoring is flash-crowd only" in cli(dfsim.main, ["gray-parents", "--scoring", "ml-serial"])[2]
