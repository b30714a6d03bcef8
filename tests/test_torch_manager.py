"""The port's manager (registry, rollout state machine, jobs, RPC front and
process) against the reference's.

- One scripted sequence of calls goes through the port's ``ManagerService``
  and the reference's: registration, keepalive with stats frames,
  ``cluster_config``, ``cluster_stats``, publish (ungated and gated),
  superseded candidates, ``report_shadow`` with promotion and rejection,
  ``rollout_status``, promote and reject refusals, rollback, the reaper,
  applications and config rows. Every answer and every row must be equal;
  the only fields allowed to differ are the timestamps (``created_at``,
  ``updated_at``, ``last_keepalive``, a history event's ``at``, a
  ``cluster_stats`` answer's ``ts`` and a member's ``age_s``). Ids are
  compared as they are: both databases hand them out in the same order.
- The job queue: group success and failure, pull timeout, lease requeue and
  ``requeue_pending`` after a restart, equal in both packages.
- Both wire clients against both servers: the same answers as the
  in-process service, and ``issue_certificate`` answers ``unavailable`` (no
  CA) from both.
- The process: ``python -m dragonfly2_tpu_torch.manager.server --port 0``
  prints ``manager ready rpc=<addr> rest=None``, serves a client, keeps its
  registry across a restart on the same database file and stops on SIGTERM
  with exit code 0; the flags it once refused (REST, metrics, the CA, the
  cert token, auth, the admin user, object storage, a tracing exporter) boot
  a serving manager that has loaded no torch.

Every subprocess has a deadline of 120 s or less.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from dragonfly2_tpu.manager import searcher as ref_searcher
from dragonfly2_tpu.manager.db import Database as RefDatabase
from dragonfly2_tpu.manager.jobs import JobQueue as RefJobQueue
from dragonfly2_tpu.manager.server import ManagerServer as RefManagerServer
from dragonfly2_tpu.manager.service import ManagerService as RefManagerService
from dragonfly2_tpu.rpc.core import RpcError as RefRpcError
from dragonfly2_tpu.rpc.manager import MANAGER_METHODS as REF_MANAGER_METHODS
from dragonfly2_tpu.rpc.manager import RemoteManagerClient as RefRemoteManagerClient
from dragonfly2_tpu_torch.manager import searcher
from dragonfly2_tpu_torch.manager.db import Database
from dragonfly2_tpu_torch.manager.jobs import JOB_FAILURE, JOB_SUCCESS, JobQueue, cluster_queue
from dragonfly2_tpu_torch.manager.server import ManagerServer
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.rpc.core import RpcError
from dragonfly2_tpu_torch.rpc.manager import MANAGER_METHODS, RemoteManagerClient

torch.set_num_threads(1)


# each test's coroutine runs under this deadline (conftest's runner has
# none), so that a stuck await fails its test instead of holding the suite
DEADLINE_S = 120.0


@pytest.fixture
def run():
    """conftest's runner (a fresh loop in debug mode) under DEADLINE_S."""
    return lambda coro: asyncio.run(asyncio.wait_for(coro, DEADLINE_S), debug=True)

REPO = Path(__file__).resolve().parent.parent
SERVER = [sys.executable, "-m", "dragonfly2_tpu_torch.manager.server", "--host", "127.0.0.1", "--port", "0"]
READY_S = 60.0

# the only fields in which the two packages' answers may differ
TIMESTAMPS = frozenset({"created_at", "updated_at", "last_keepalive", "at", "ts", "age_s"})


def strip_times(x):
    if isinstance(x, dict):
        return {k: strip_times(v) for k, v in x.items() if k not in TIMESTAMPS}
    if isinstance(x, (list, tuple)):
        return [strip_times(v) for v in x]
    return x


def frame(host: str, **rates) -> dict:
    return {"service": "scheduler", "ts": time.time(), "window_s": 60.0, "hostname": host,
            "rates": rates, "serving_mode": "torch", "alerts": ["scorer_error_rate"] if rates.get("bad") else []}


def _call(svc, name: str, *args, **kw):
    """One step: the answer, or the exception's type name and message."""
    try:
        return getattr(svc, name)(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the refusal itself is compared
        return {"raised": type(e).__name__, "message": str(e)}


REPORT_OK = {"rounds": 8, "uncovered": 0, "errors": 0, "seen": 8, "topk_overlap_mean": 0.75,
             "topk_overlap_min": 0.5, "rank_corr_mean": 0.6, "abs_delta_mean": 0.05,
             "abs_delta_max": 0.2, "delta_hist": {"buckets": [], "counts": []}, "slices": {}}


def script(svc) -> list:
    """The scripted sequence; each step's answer, plus the tables it left."""
    out = []
    step = lambda name, *a, **k: out.append((name, _call(svc, name, *a, **k)))  # noqa: E731

    def mid(version: str) -> int:
        return svc.db.find_one("models", version=version)["id"]

    step("create_scheduler_cluster", "east", scopes={"idc": "idc-e", "location": "asia|cn"})
    step("update_scheduler", "s1", "10.0.0.1", 8002, idc="idc-e", location="asia|cn")
    step("update_scheduler", "s2", "10.0.0.2", 8002)
    step("update_scheduler", "s3", "10.0.0.3", 8002, scheduler_cluster_id=1)
    step("update_seed_peer", "seed1", "10.0.1.1", 65006, download_port=65002)
    step("keepalive", "scheduler", "s1", stats=frame("s1", rounds_per_s=12.5, bad=1))
    step("keepalive", "scheduler", "s2", 2, stats=frame("s2", rounds_per_s=7.25))
    step("keepalive", "seed_peer", "seed1")
    step("keepalive", "trainer", "t1", stats={"service": "trainer", "ts": 1.0, "rates": {"train_steps_per_s": 3.0}})
    step("keepalive", "daemon", "d1")
    step("report_stats", "daemon", "d1", {"service": "daemon", "rates": {"piece_down_mb_per_s": 40.0}})
    step("cluster_stats", history=2)
    step("cluster_config", 1)
    step("cluster_config", 2)
    step("cluster_config", 99)
    step("list_schedulers", "10.0.0.9", {"idc": "idc-e"})
    step("list_seed_peers", 2)
    step("get_scheduler", "s1", 2)
    # ungated registry: publish activates, a second publish displaces it
    step("publish_model", "gnn", "v1", artifact_path="/a/v1", artifact_digest="d1", evaluation={"auc": 0.7})
    step("publish_model", "mlp", "m1", artifact_path="/a/m1")
    step("publish_model", "gnn", "v2", artifact_path="/a/v2", artifact_digest="d2")
    step("create_model", "other", "x")
    # gated: candidates, superseding, shadow reports, promotion, rejection
    step("set_config", "model_rollout", {"enabled": True, "types": ["gnn"], "auto_promote": True,
                                         "gates": {"min_rounds": 10, "min_topk_overlap": 0.5}})
    step("publish_model", "gnn", "v3", artifact_path="/a/v3", artifact_digest="d3")
    step("publish_model", "gnn", "v4", artifact_path="/a/v4", artifact_digest="d4")
    step("rollout_status", "gnn", 0)
    step("report_shadow", mid("v3"), "s1", dict(REPORT_OK))  # superseded: answers the truth
    step("report_shadow", mid("v4"), "s1", dict(REPORT_OK))
    step("report_shadow", mid("v4"), "s2", dict(REPORT_OK))  # 16 merged rounds: promotes
    step("publish_model", "gnn", "v5", artifact_path="/a/v5", artifact_digest="d5")
    step("report_shadow", mid("v5"), "s1", {"error": "digest_mismatch: bytes differ"})
    step("publish_model", "gnn", "v6", artifact_path="/a/v6", artifact_digest="d6")
    step("report_shadow", mid("v6"), "s1", {**REPORT_OK, "rounds": 12, "topk_overlap_mean": 0.1})
    step("promote_model", mid("v6"))
    step("reject_model", mid("v1"))
    step("promote_model", 99)
    step("rollout_status", "gnn", 0)
    step("rollback_model", "gnn", 0, reason="post-swap health regression")
    step("rollback_model", "mlp", 0)
    step("rollback_model", "gnn", 3)
    step("promote_model", mid("v2"))
    step("active_model", "gnn", 0)
    step("rollout_status", "gnn", 2)
    step("set_config", "model_rollout", {"enabled": True, "types": ["gnn"], "auto_promote": False,
                                         "gates": {"min_rounds": 4}})
    step("publish_model", "gnn", "v7", artifact_path="/a/v7")
    step("report_shadow", mid("v7"), "s1", dict(REPORT_OK))
    step("list_models", type="gnn")
    step("delete_model", mid("m1"))
    step("upsert_application", "app", url="http://a", priority={"value": 3})
    step("list_applications")
    step("get_config", "model_rollout")
    step("get_config", "none")
    svc.keepalive_ttl = -1.0  # every instance is past its TTL
    step("reap_stale")
    step("list_schedulers")
    tables = {t: svc.db.find(t) for t in ("scheduler_clusters", "schedulers", "seed_peer_clusters",
                                          "seed_peers", "applications", "configs", "models")}
    return strip_times([out, tables])


def test_the_scripted_sequence_is_equal_in_both_services(tmp_path):
    port = script(ManagerService(Database(tmp_path / "port.db")))
    ref = script(RefManagerService(RefDatabase(tmp_path / "ref.db")))
    for (name, a), (_, b) in zip(port[0], ref[0]):
        assert a == b, name
    assert port == ref
    # the script reaches every state of the rollout machine
    states = {r["version"]: r["state"] for r in port[1]["models"] if r["type"] == "gnn"}
    assert states == {"v1": "inactive", "v2": "active", "v3": "rejected", "v4": "rejected",
                      "v5": "rejected", "v6": "rejected", "v7": "shadowing"}


def test_databases_are_interchangeable(tmp_path):
    """One schema: a registry the reference wrote reads the same through the
    port, and the other way."""
    script(RefManagerService(RefDatabase(tmp_path / "ref.db")))
    script(ManagerService(Database(tmp_path / "port.db")))
    for a, b in ((tmp_path / "ref.db", tmp_path / "port.db"),):
        mine, theirs = Database(a), RefDatabase(b)
        for table in ("schedulers", "models", "configs", "jobs", "users"):
            assert strip_times(mine.find(table)) == strip_times(theirs.find(table))
        mine.close()
        theirs.close()


@pytest.mark.parametrize("ip,conditions", [("10.0.0.9", {"idc": "idc-e"}), ("", None),
                                           ("10.0.0.9", {"location": "asia|cn|sh"})])
def test_searcher_ranks_as_the_references(ip, conditions):
    clusters = [
        {"id": 1, "name": "a", "scopes": {"idc": "idc-e|idc-w", "location": "asia|cn"}, "is_default": False},
        {"id": 2, "name": "b", "scopes": {"cidrs": ["10.0.0.0/24"]}, "is_default": True},
        {"id": 3, "name": "c", "scopes": {}, "is_default": False},
    ]
    active = {1: True, 2: True, 3: True}
    mine = searcher.find_scheduler_clusters(clusters, ip, conditions, has_active_schedulers=active)
    theirs = ref_searcher.find_scheduler_clusters(clusters, ip, conditions, has_active_schedulers=active)
    assert [c["id"] for c in mine] == [c["id"] for c in theirs]
    with pytest.raises(Exception, match="unknown searcher"):
        searcher.new_searcher("custom")


async def _jobs(db_cls, queue_cls, path) -> list:
    out = []
    q = queue_cls(db_cls(path), lease_timeout=0.05)
    job = await q.create("preheat", {"urls": ["http://o/a"]}, scheduler_cluster_ids=[1, 2])
    out.append(job)
    a = await q.pull(cluster_queue(1), timeout=0.5)
    b = await q.pull(cluster_queue(2), timeout=0.5)
    out += [a, b, await q.pull(cluster_queue(1), timeout=0.05)]
    q.complete(job["id"], success=True, result={"preheated": 1}, cluster_id=1)
    q.complete(job["id"], success=True, result={"preheated": 1}, cluster_id=1)  # a retried completion
    out.append(q.state(job["id"]))
    q.complete(job["id"], success=False, result={"error": "x"}, cluster_id=2)
    out.append(q.state(job["id"]))
    job2 = await q.create("preheat", {"urls": []}, scheduler_cluster_ids=[3])
    out.append(await q.pull(cluster_queue(3), timeout=0.5))
    await asyncio.sleep(0.1)
    out.append(q.reap_leases())  # the lease ran out: requeued
    out.append(await q.pull(cluster_queue(3), timeout=0.5))
    q.complete(job2["id"], success=True, cluster_id=3)
    out.append(q.state(job2["id"]))
    job3 = await q.create("preheat", {"urls": ["u"]}, scheduler_cluster_ids=[4])
    q2 = queue_cls(q.db)  # a restarted manager on the same database
    out.append(q2.requeue_pending())
    out.append(await q2.pull(cluster_queue(4), timeout=0.5))
    out.append(q2.state(job3["id"]))
    return strip_times(out)


def test_job_queue_is_equal_in_both_packages(run, tmp_path):
    mine = run(_jobs(Database, JobQueue, tmp_path / "p.db"))
    theirs = run(_jobs(RefDatabase, RefJobQueue, tmp_path / "r.db"))
    assert mine == theirs
    assert mine[4]["state"] not in (JOB_SUCCESS, JOB_FAILURE) and mine[5]["state"] == JOB_FAILURE
    assert mine[7] == 1 and mine[9]["state"] == JOB_SUCCESS and mine[10] == 1


async def _wire_sequence(client) -> list:
    out = []
    row = await client.update_scheduler("s1", "10.0.0.1", 8002, idc="i")
    out.append(row)
    out.append(await client.keepalive("scheduler", "s1", row["scheduler_cluster_id"],
                                      stats=frame("s1", rounds_per_s=3.0)))
    out.append(await client.keepalive("scheduler", "nobody"))
    out.append(await client.report_stats("daemon", "d1", {"service": "daemon", "rates": {"x": 1.0}}))
    out.append(await client.cluster_stats(history=1))
    out.append(await client.cluster_config(row["scheduler_cluster_id"]))
    out.append(await client.list_schedulers())
    out.append(await client.update_seed_peer("seed", "10.0.1.1", 65006))
    out.append(await client.publish_model("gnn", "v1", artifact_path="/p", artifact_digest="d"))
    out.append(await client.set_config("model_rollout", {"enabled": True, "gates": {"min_rounds": 2}}))
    cand = await client.publish_model("gnn", "v2", artifact_path="/q", artifact_digest="e")
    out.append(cand)
    out.append(await client.report_shadow(cand["id"], "s1", dict(REPORT_OK)))
    out.append(await client.rollout_status("gnn", 0))
    out.append(await client.rollback_model("gnn", 0, reason="r"))
    out.append(await client.active_model("gnn", 0))
    out.append(await client.list_models(type="gnn", state="rejected"))
    out.append(await client.create_model("mlp", "m"))
    out.append(await client.activate_model(3))
    out.append(await client.promote_model(3))
    cand = await client.publish_model("gnn", "v4")
    out.append(await client.reject_model(cand["id"], "veto"))
    out.append(await client.list_applications())
    out.append(await client.get_config("model_rollout"))
    job = await client.create_job("preheat", {"urls": ["u"]}, [row["scheduler_cluster_id"]])
    out.append(job)
    item = await client.pull_job(cluster_queue(row["scheduler_cluster_id"]), timeout=1.0)
    out.append(item)
    await client.complete_job(job["id"], success=True, result={"n": 1}, cluster_id=item["cluster_id"])
    out.append(await client.job_state(job["id"]))
    for bad in (lambda: client.activate_model(999), lambda: client.reject_model(1),
                lambda: client.issue_certificate("svc", ["127.0.0.1"], token="t")):
        try:
            await bad()
        except Exception as e:  # noqa: BLE001 - the error's code is compared
            out.append({"code": getattr(e, "code", None), "type": type(e).__name__})
    return strip_times(out)


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_wire_clients_get_equal_answers_from_both_servers(run, tmp_path, client_pkg, server_pkg):
    server_cls = ManagerServer if server_pkg == "port" else RefManagerServer
    client_cls = RemoteManagerClient if client_pkg == "port" else RefRemoteManagerClient

    async def over_wire():
        kw = {} if server_pkg == "port" else {"rest_port": None}
        server = server_cls(db_path=str(tmp_path / "wire.db"), **kw)
        await server.start()
        client = client_cls(server.address, retries=0)
        try:
            return await _wire_sequence(client)
        finally:
            await client.close()
            await server.stop()

    async def in_process():
        server = ManagerServer(db_path=str(tmp_path / "local.db"))
        await server.start()
        client = RemoteManagerClient(server.address, retries=0)
        try:
            return await _wire_sequence(client)
        finally:
            await client.close()
            await server.stop()

    got, want = run(over_wire()), run(in_process())
    assert got == want
    assert got[-1]["type"] in ("RpcError",) and got[-1]["code"] == "unavailable"


def test_both_packages_serve_the_same_methods():
    assert MANAGER_METHODS == REF_MANAGER_METHODS


def test_issue_certificate_has_no_ca(run):
    async def body():
        server = ManagerServer()
        await server.start()
        client = RemoteManagerClient(server.address, retries=0)
        ref_client = RefRemoteManagerClient(server.address, retries=0)
        try:
            with pytest.raises(RpcError, match="no CA configured") as e:
                await client.issue_certificate("svc", token="t")
            assert e.value.code == "unavailable"
            with pytest.raises(RefRpcError, match="no CA configured"):
                await ref_client.issue_certificate("svc", token="t")
        finally:
            await client.close()
            await ref_client.close()
            await server.stop()

    run(body())


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(args, cwd) -> tuple[subprocess.Popen, str]:
    """The manager process and its RPC address, from its ready line; a
    process silent for READY_S is killed (which ends the blocked read)."""
    with open(cwd / "manager.err", "a") as err:
        p = subprocess.Popen([*SERVER, *args], cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                             stderr=err, text=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        read = pool.submit(p.stdout.readline)
        try:
            line = read.result(timeout=READY_S)
        except concurrent.futures.TimeoutError:
            p.kill()
            line = ""
    assert line.startswith("manager ready rpc=127.0.0.1:") and line.rstrip().endswith(" rest=None"), (
        line, (cwd / "manager.err").read_text()[-2000:])
    return p, line.split()[2][len("rpc="):]


def _stop(p: subprocess.Popen) -> int:
    p.send_signal(signal.SIGTERM)
    try:
        return p.wait(timeout=10)
    finally:
        if p.poll() is None:
            p.kill()


def test_the_process_serves_keeps_its_registry_and_stops_on_sigterm(run, tmp_path):
    db = str(tmp_path / "m.db")
    p, addr = _start(["--db", db], tmp_path)
    try:
        async def first():
            c = RemoteManagerClient(addr, retries=0)
            try:
                await c.update_scheduler("s1", "127.0.0.1", 9000)
                return await c.publish_model("gnn", "v1", artifact_path="/x")
            finally:
                await c.close()

        row = run(first())
        assert row["state"] == "active"
    finally:
        assert _stop(p) == 0
    p, addr = _start(["--db", db], tmp_path)
    try:
        async def second():
            c = RefRemoteManagerClient(addr, retries=0)
            try:
                return await c.active_model("gnn", 0), await c.list_schedulers()
            finally:
                await c.close()

        active, scheds = run(second())
        assert active["version"] == "v1" and [s["hostname"] for s in scheds] == ["s1"]
    finally:
        assert _stop(p) == 0


_PROBE = """
import runpy, sys
from dragonfly2_tpu_torch.utils import proc

serve = proc.run_until_signalled

async def probed(ready_event=None, on_ready=None):
    def report():
        on_ready()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "torch", "dragonfly2_tpu"))
        print("LOADED " + ",".join(bad), flush=True)
    await serve(ready_event, report)

proc.run_until_signalled = probed
sys.argv = ["manager", *sys.argv[1:]]
runpy.run_module("dragonfly2_tpu_torch.manager.server", run_name="__main__")
"""


def _check_booted(item: str, rest: str, tmp_path: Path, addr: str) -> None:
    """What the flag of ``item`` turned on answers."""
    import json
    import re
    import urllib.request

    if item == "manager/rest.py":
        with urllib.request.urlopen(f"http://127.0.0.1:{int(rest)}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    elif item == "observability/server.py":
        m = re.search(r"manager metrics on [\d.]+:(\d+)", (tmp_path / "manager.err").read_text())
        assert m, (tmp_path / "manager.err").read_text()[-2000:]
        with urllib.request.urlopen(f"http://127.0.0.1:{m.group(1)}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    elif item == "security/":
        async def issue():
            c = RemoteManagerClient(addr, retries=0)
            try:
                with pytest.raises(RpcError) as e:
                    await c.issue_certificate("svc", token="wrong")
                return e.value.code
            finally:
                await c.close()

        # a CA with no token refuses, a token with no CA has none to issue from
        assert asyncio.run(asyncio.wait_for(issue(), READY_S)) in ("permission_denied", "unavailable")


@pytest.mark.parametrize("args,item", [
    (["--rest-port", "0"], "manager/rest.py"),
    (["--config", "rest.yaml"], "manager/rest.py"),
    (["--metrics-port", "0"], "observability/server.py"),
    (["--ca-dir", "ca"], "security/"),
    (["--cert-token", "t"], "security/"),
    (["--auth-secret", "s"], "security/"),
    (["--admin-password", "p"], "manager/oauth.py"),
    (["--object-storage-dir", "o"], "objectstorage/"),
    (["--config", "tracing.yaml"], "tracing exporters"),
])
def test_flags_the_port_has_not_ported_are_refused(args, item, tmp_path):
    """Once refused with exit code 2, now ported: each flag boots a manager
    that answers on what the flag turned on and has loaded no torch."""
    (tmp_path / "rest.yaml").write_text("rest_port: 0\n")
    (tmp_path / "tracing.yaml").write_text(f"tracing:\n  trace_file: {tmp_path / 'spans.jsonl'}\n")
    env = {k: v for k, v in _env().items()
           if k not in ("DRAGONFLY_CERT_TOKEN", "DRAGONFLY_AUTH_SECRET", "DRAGONFLY_ADMIN_PASSWORD")}
    with open(tmp_path / "manager.err", "w") as err:
        p = subprocess.Popen([sys.executable, "-c", _PROBE, "--host", "127.0.0.1", "--port", "0",
                              "--db", str(tmp_path / "m.db"), *args],
                             cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            read = pool.submit(lambda: (p.stdout.readline(), p.stdout.readline()))
            try:
                ready, loaded = read.result(timeout=READY_S)
            except concurrent.futures.TimeoutError:
                p.kill()
                raise
        assert ready.startswith("manager ready rpc=127.0.0.1:"), (ready, (tmp_path / "manager.err").read_text())
        assert loaded == "LOADED \n", loaded
        addr, rest = ready.split()[2][len("rpc="):], ready.split()[3][len("rest="):]
        assert (rest != "None") == (item == "manager/rest.py")
        _check_booted(item, rest, tmp_path, addr)
    finally:
        assert _stop(p) == 0
    if "--admin-password" in args:
        assert [u["role"] for u in Database(str(tmp_path / "m.db")).find("users", name="admin")] == ["admin"]
    if "--ca-dir" in args:
        assert (tmp_path / "ca" / "ca.pem").exists()


def test_a_manager_with_every_flag_on_serves_and_loads_no_torch(tmp_path):
    """REST with auth, the admin user, the CA with its cert token, object
    storage, the debug server and a span file at once: a signed-in admin
    lists the buckets, a leaf is issued over RPC, and no torch is loaded."""
    import json
    import urllib.request

    (tmp_path / "tracing.yaml").write_text(f"tracing:\n  trace_file: {tmp_path / 'spans.jsonl'}\n")
    with open(tmp_path / "manager.err", "w") as err:
        p = subprocess.Popen([sys.executable, "-c", _PROBE, "--host", "127.0.0.1", "--port", "0",
                              "--db", str(tmp_path / "m.db"), "--rest-port", "0", "--metrics-port", "0",
                              "--ca-dir", "ca", "--cert-token", "t0k", "--auth-secret", "s3cret",
                              "--admin-password", "adminpw", "--object-storage-dir", "objects",
                              "--config", "tracing.yaml"],
                             cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            read = pool.submit(lambda: (p.stdout.readline(), p.stdout.readline()))
            try:
                ready, loaded = read.result(timeout=READY_S)
            except concurrent.futures.TimeoutError:
                p.kill()
                raise
        assert loaded == "LOADED \n", (loaded, (tmp_path / "manager.err").read_text()[-2000:])
        addr, rest = ready.split()[2][len("rpc="):], int(ready.split()[3][len("rest="):])
        base = f"http://127.0.0.1:{rest}"
        signin = urllib.request.Request(f"{base}/api/v1/users/signin", method="POST",
                                        data=json.dumps({"name": "admin", "password": "adminpw"}).encode(),
                                        headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(signin, timeout=10) as r:
            token = json.loads(r.read())["token"]
        buckets = urllib.request.Request(f"{base}/api/v1/buckets", headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(buckets, timeout=10) as r:
            assert json.loads(r.read()) == []

        async def issue():
            c = RemoteManagerClient(addr, retries=0)
            try:
                return await c.issue_certificate("svc", sans=["127.0.0.1"], token="t0k")
            finally:
                await c.close()

        assert "BEGIN CERTIFICATE" in asyncio.run(asyncio.wait_for(issue(), READY_S))["cert_pem"]
    finally:
        assert _stop(p) == 0
