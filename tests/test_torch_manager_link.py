"""The port's scheduler ManagerLink against the port's manager and the reference's.

The rollout scenarios of tests/test_rollout.py and the outage scenarios of
tests/test_manager_link.py run through the port's ``ManagerLink`` on a port
``SchedulerService`` with the port's ml evaluator, each against the port's
in-process ``ManagerServer`` and against the reference's (real RPC, the
watch ticked by hand): a gated candidate shadows, promotes and swaps by the
fast path with no second load; a corrupt candidate is refused as
``digest_mismatch``, rejected in the registry and never attached; a corrupt
or missing active artifact is refused and backs the watch off; a
health-regressing promotion rolls back to the warm previous bundle, which
carries its own drift sketch back; keepalive outages freeze the watch and the
rejoin re-registers once. Then one scenario runs through both packages'
links against each manager and must give the same sequence of serving and
candidate versions, swap results, rollbacks and registry states. Last, a
real GNN artifact trained by the port's trainer on the CPU goes through the
link (torch engine): it serves ml-scored rounds, and its retired scorer drops
its tables when its bundle drains.
"""

from __future__ import annotations

import asyncio
import json
import types

import numpy as np
import pytest
import torch

import dragonfly2_tpu.manager.server as ref_manager_server
import dragonfly2_tpu.observability.sketches as ref_sketches
import dragonfly2_tpu.rpc.manager as ref_rpc_manager
import dragonfly2_tpu.scheduler.evaluator as ref_evaluator
import dragonfly2_tpu.scheduler.manager_link as ref_manager_link
import dragonfly2_tpu.scheduler.metrics as ref_metrics
import dragonfly2_tpu.scheduler.resource as ref_resource
import dragonfly2_tpu.scheduler.rollout as ref_rollout
import dragonfly2_tpu.scheduler.service as ref_service
import dragonfly2_tpu.trainer.artifacts as ref_artifacts
import dragonfly2_tpu.utils.idgen as ref_idgen
import dragonfly2_tpu_torch.manager.server as port_manager_server
import dragonfly2_tpu_torch.observability.sketches as port_sketches
import dragonfly2_tpu_torch.rpc.manager as port_rpc_manager
import dragonfly2_tpu_torch.scheduler.evaluator as port_evaluator
import dragonfly2_tpu_torch.scheduler.manager_link as port_manager_link
import dragonfly2_tpu_torch.scheduler.metrics as port_metrics
import dragonfly2_tpu_torch.scheduler.resource as port_resource
import dragonfly2_tpu_torch.scheduler.rollout as port_rollout
import dragonfly2_tpu_torch.scheduler.service as port_service
import dragonfly2_tpu_torch.trainer.artifacts as port_artifacts
import dragonfly2_tpu_torch.utils.idgen as port_idgen
from dragonfly2_tpu_torch.models.scorer import GNNScorer
from dragonfly2_tpu_torch.resilience.breaker import CircuitBreaker
from dragonfly2_tpu_torch.trainer import train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import synth_telemetry_records

torch.set_num_threads(1)


# each test's coroutine runs under this deadline (conftest's runner has
# none), so that a stuck await fails its test instead of holding the suite
DEADLINE_S = 120.0


@pytest.fixture
def run():
    """conftest's runner (a fresh loop in debug mode) under DEADLINE_S."""
    return lambda coro: asyncio.run(asyncio.wait_for(coro, DEADLINE_S), debug=True)


def _pkg(manager_server, rpc_manager, service, evaluator, manager_link, metrics, rollout,
         resource, idgen, artifacts, sketches):
    return types.SimpleNamespace(
        ManagerServer=manager_server.ManagerServer,
        RemoteManagerClient=rpc_manager.RemoteManagerClient,
        SchedulerService=service.SchedulerService,
        new_evaluator=evaluator.new_evaluator,
        ManagerLink=manager_link.ManagerLink,
        metrics=metrics, R=rollout, res=resource, idgen=idgen, artifacts=artifacts,
        FeatureSketch=sketches.FeatureSketch,
    )


PKGS = {
    "port": _pkg(port_manager_server, port_rpc_manager, port_service, port_evaluator, port_manager_link,
                 port_metrics, port_rollout, port_resource, port_idgen, port_artifacts, port_sketches),
    "ref": _pkg(ref_manager_server, ref_rpc_manager, ref_service, ref_evaluator, ref_manager_link,
                ref_metrics, ref_rollout, ref_resource, ref_idgen, ref_artifacts, ref_sketches),
}
PORT = PKGS["port"]

GATED = {
    "enabled": True, "types": ["gnn"], "auto_promote": True,
    "gates": {"min_rounds": 6, "min_topk_overlap": 0.0, "min_rank_corr": -1.0,
              "max_mean_abs_delta": 100.0, "max_error_rate": 1.0},
}


class VersionScorer:
    """tests/test_rollout.py's fake: every score is its version constant, so
    a torn old/new mix inside one round shows as a non-constant vector."""

    ready = True
    feature_dim = 16
    num_nodes = 1_000_000

    def __init__(self, value: float, *, boom: bool = False):
        self.value = float(value)
        self.boom = boom
        self.calls = 0
        self.closed = False

    def score(self, feats, *, child, parent):
        self.calls += 1
        if self.boom:
            raise RuntimeError("injected scorer failure")
        return np.full(len(child), self.value, np.float32)

    def score_rounds(self, feats, *, child, parent):
        self.calls += 1
        if self.boom:
            raise RuntimeError("injected scorer failure")
        return np.full(feats.shape[:2], self.value, np.float32)

    def close(self):
        self.closed = True


def _metric(metric, **labels) -> float:
    return float(metric.labels(**labels).value)


def make_artifact(pkg, tmp_path, version: str, payload: bytes = b"weights") -> tuple[str, str]:
    d = tmp_path / f"gnn-{version}"
    d.mkdir(parents=True)
    (d / "params.msgpack").write_bytes(payload * 32)
    (d / "config.json").write_text(json.dumps({"type": "gnn", "version": version}))
    (d / "graph.npz").write_bytes(b"notagraph" * 8)
    (d / "hosts.json").write_text("{}")
    return str(d), pkg.artifacts.artifact_digest(d)


def make_pool_with_task(pkg, host_ids):
    pool = pkg.res.ResourcePool()
    task = pool.load_or_create_task("t1", "http://origin/f")
    task.set_metadata(100 << 20)
    hosts = [pool.load_or_create_host(hid, f"10.0.0.{i}", f"host{i}", download_port=8000 + i)
             for i, hid in enumerate(host_ids)]
    return pool, task, hosts


def add_running_peer(pkg, pool, task, host, pieces: int = 0):
    peer = pool.create_peer(pkg.idgen.peer_id(host.ip, host.hostname), task, host)
    peer.fsm.fire("register")
    peer.fsm.fire("download")
    for i in range(pieces):
        peer.finished_pieces.set(i)
    return peer


class LinkHarness:
    """A manager of one package (real RPC server), an ml SchedulerService and
    a ManagerLink of another, the watch ticked by hand; the link's disk load
    is replaced by a fake keyed on the artifact path unless ``real_load``."""

    def __init__(self, tmp_path, monkeypatch, *, link="port", manager="port", real_load=False,
                 host_ids=tuple(f"h{i}" for i in range(6)), **link_kw):
        self.tmp_path = tmp_path
        self.monkeypatch = monkeypatch
        self.pkg = PKGS[link]
        self.mpkg = PKGS[manager]
        self.real_load = real_load
        self.host_ids = host_ids
        self.scorers: dict[str, object] = {}
        self.loads: list[str] = []
        self.link_kw = link_kw

    async def __aenter__(self):
        pkg = self.pkg
        self.manager = self.mpkg.ManagerServer(db_path=str(self.tmp_path / "m.db"))
        await self.manager.start()
        self.mc = pkg.RemoteManagerClient(self.manager.address)
        self.svc = pkg.SchedulerService(evaluator=pkg.new_evaluator("ml"))
        pool, task, hosts = make_pool_with_task(pkg, self.host_ids)
        self.svc.pool = pool
        self.child = add_running_peer(pkg, pool, task, hosts[0])
        self.parents = [add_running_peer(pkg, pool, task, h, pieces=2) for h in hosts[1:]]
        for p in self.parents:
            p.host.upload_limit = 1000
        self.node_index = {h.id: i for i, h in enumerate(hosts)}
        self.link = pkg.ManagerLink(self.svc, self.manager.address, hostname="sch-test",
                                    ip="127.0.0.1", port=1, **self.link_kw)
        scorers, loads = self.scorers, self.loads

        def fake_load(path):
            loads.append(path)
            entry = scorers[path]
            if isinstance(entry, Exception):
                raise entry
            return entry

        if self.real_load:
            real = pkg.ManagerLink._load_scorer

            def counted(path):
                loads.append(path)
                return port_manager_link.load_scorer(path, device="cpu")

            assert real is not None
            self.monkeypatch.setattr(pkg.ManagerLink, "_load_scorer", staticmethod(counted))
        else:
            self.monkeypatch.setattr(pkg.ManagerLink, "_load_scorer", staticmethod(fake_load))
        return self

    async def __aexit__(self, *exc):
        await self.link.manager.close()
        await self.mc.close()
        await self.manager.stop()
        self.svc.close()

    async def tick(self):
        await self.link._check_model()

    async def publish(self, version: str, *, scorer=None, corrupt=False, digest=None, path=None) -> dict:
        if path is None:
            path, real_digest = make_artifact(self.pkg, self.tmp_path, version)
            if digest is None:
                digest = real_digest
        if scorer is not None:
            self.scorers[path] = (scorer, self.node_index)
        if corrupt:
            f = self.tmp_path / f"gnn-{version}" / "params.msgpack"
            f.write_bytes(b"CORRUPTED" + f.read_bytes()[9:])
        return await self.mc.publish_model("gnn", version, scheduler_id=0,
                                           artifact_path=path, artifact_digest=digest)

    async def drive_rounds(self, n: int):
        for _ in range(n):
            await self.svc.reschedule(self.child.id)  # dflint: disable=DF025 each call IS one scheduling round under test

    def swaps(self, result: str) -> float:
        return _metric(self.pkg.metrics.MODEL_SWAP_TOTAL, result=result)


MANAGERS = pytest.mark.parametrize("manager", ["port", "ref"])


@MANAGERS
def test_gated_candidate_shadows_then_promotes_and_swaps(run, tmp_path, monkeypatch, manager):
    async def body():
        async with LinkHarness(tmp_path, monkeypatch, manager=manager) as h:
            await h.mc.set_config("model_rollout", GATED)
            row = await h.publish("v1", scorer=VersionScorer(0.5))
            assert row["state"] == "candidate"
            ok_before = h.swaps("ok")
            await h.tick()
            ev = h.svc.evaluator
            assert ev.candidate_version == "v1" and ev.serving_version == ""
            await h.drive_rounds(8)
            await h.tick()  # report → gate passes → promote → fast swap
            assert ev.serving_version == "v1" and ev.candidate_version == ""
            assert h.loads == [row["artifact_path"]]  # the fast path loads nothing
            reg = await h.mc.active_model("gnn", 0)
            assert reg["version"] == "v1" and reg["state"] == "active"
            assert h.swaps("ok") == ok_before + 1
            assert _metric(PORT.metrics.MODEL_SWAP_LAST_ERROR, error="digest_mismatch") == 0.0
            assert _metric(PORT.metrics.MODEL_ROLLOUT_STATE, state="health_watch") == 0.0
            assert _metric(PORT.metrics.MODEL_ROLLOUT_STATE, state="idle") == 1.0
            out = ev.evaluate(h.child, h.parents)
            assert np.all(out == 0.5)

    run(body())


@MANAGERS
def test_corrupt_candidate_rejected_never_attaches_never_wedges(run, tmp_path, monkeypatch, manager):
    async def body():
        async with LinkHarness(tmp_path, monkeypatch, manager=manager) as h:
            await h.mc.set_config("model_rollout", GATED)
            bad = await h.publish("vbad", scorer=VersionScorer(9.9), corrupt=True)
            before = h.swaps("digest_mismatch")
            await h.tick()  # must not raise, must not attach
            ev = h.svc.evaluator
            assert ev.candidate_version == "" and ev.serving_version == ""
            assert h.swaps("digest_mismatch") == before + 1
            assert _metric(PORT.metrics.MODEL_SWAP_LAST_ERROR, error="digest_mismatch") == 1.0
            assert h.loads == []  # refused before any load
            row = (await h.mc.list_models(type="gnn", version="vbad"))[0]
            assert row["state"] == "rejected" and row["id"] == bad["id"]
            assert "digest_mismatch" in row["rollout"]["rejected_reason"]
            await h.publish("vgood", scorer=VersionScorer(0.5))
            await h.tick()
            assert ev.candidate_version == "vgood"
            await h.drive_rounds(6)
            await h.tick()
            assert ev.serving_version == "vgood"

    run(body())


@MANAGERS
def test_active_swap_verifies_digest_and_backs_off(run, tmp_path, monkeypatch, manager):
    async def body():
        async with LinkHarness(tmp_path, monkeypatch, manager=manager) as h:
            await h.publish("vcorrupt", scorer=VersionScorer(1.0), corrupt=True)
            before = h.swaps("digest_mismatch")
            with pytest.raises(PORT.artifacts.ArtifactIntegrityError):
                await h.tick()
            assert h.svc.evaluator.serving_version == ""
            assert h.swaps("digest_mismatch") == before + 1
            await h.mc.publish_model("gnn", "vmissing", artifact_path=str(tmp_path / "nope"),
                                     artifact_digest="00ff")
            before_missing = h.swaps("missing")
            with pytest.raises(FileNotFoundError):
                await h.tick()
            assert h.swaps("missing") == before_missing + 1
            assert _metric(PORT.metrics.MODEL_SWAP_LAST_ERROR, error="missing") == 1.0
            bo = h.link._watch_backoff
            assert bo.base == h.link.model_watch_interval
            assert bo.delay(5) >= bo.base
            assert bo.max_delay == h.link.model_watch_interval * 8

    run(body())


def _health_gates(pkg):
    return pkg.R.HealthGates(window_s=30.0, min_rounds=6,
                             max_error_rate_increase=0.2, max_fallback_rate_increase=0.2)


@MANAGERS
def test_health_regression_auto_rolls_back_to_warm_previous(run, tmp_path, monkeypatch, manager):
    async def body():
        async with LinkHarness(tmp_path, monkeypatch, manager=manager,
                               health_gates=_health_gates(PORT)) as h:
            await h.mc.set_config("model_rollout", GATED)
            ev = h.svc.evaluator
            await h.publish("v1", scorer=VersionScorer(0.5))
            await h.tick()
            await h.drive_rounds(6)
            await h.tick()
            assert ev.serving_version == "v1"
            await h.drive_rounds(10)
            v2 = VersionScorer(0.9)
            await h.publish("v2", scorer=v2)
            await h.tick()
            assert ev.candidate_version == "v2"
            await h.drive_rounds(6)
            await h.tick()
            assert ev.serving_version == "v2"
            assert h.link._warm_prev is not None and h.link._warm_prev.version == "v1"
            assert _metric(PORT.metrics.MODEL_ROLLOUT_STATE, state="health_watch") == 1.0
            v2.boom = True
            rollbacks = PORT.metrics.MODEL_ROLLBACK_TOTAL.value
            await h.drive_rounds(8)
            await h.tick()  # health verdict → auto-rollback
            assert ev.serving_version == "v1"
            assert PORT.metrics.MODEL_ROLLBACK_TOTAL.value == rollbacks + 1
            reg = await h.mc.rollout_status("gnn", 0)
            assert reg["active"]["version"] == "v1"
            bad = (await h.mc.list_models(type="gnn", version="v2"))[0]
            assert bad["state"] == "rejected"
            await h.drive_rounds(4)
            assert np.all(ev.evaluate(h.child, h.parents) == 0.5)
            # the rolled-back bundle drains and its scorer is closed
            h.link._drain_retired()
            assert v2.closed and h.link._draining == []
            rej_before = h.swaps("rejected_version")
            h.link._rejected_versions.add("vstale")
            await h.link._check_active({"version": "vstale", "id": 999})
            assert h.swaps("rejected_version") == rej_before + 1
            assert _metric(PORT.metrics.MODEL_SWAP_LAST_ERROR, error="rejected_version") == 1.0
            await h.tick()
            assert ev.serving_version == "v1"
            post_rb = PORT.R.HealthSample.capture(h.svc.local_metrics)
            assert h.link._last_swap_sample.rounds >= post_rb.rounds - 8

    run(body())


@MANAGERS
def test_hot_swap_under_dispatched_traffic_drops_and_tears_nothing(run, tmp_path, monkeypatch, manager):
    """Continuous dispatched rounds through a promotion, a corrupt candidate,
    a regressing promotion rolled back and a clean one: every round
    completes and none mixes two versions' scores."""

    async def body():
        gates = PORT.R.HealthGates(window_s=30.0, min_rounds=5,
                                   max_error_rate_increase=0.2, max_fallback_rate_increase=0.2)
        async with LinkHarness(tmp_path, monkeypatch, manager=manager, health_gates=gates) as h:
            h.svc.scheduling.config.dispatch_workers = 2
            h.svc.scheduling.attach_dispatcher(2)
            await h.mc.set_config("model_rollout", {**GATED, "gates": {**GATED["gates"], "min_rounds": 5}})
            v1, v2, v3 = VersionScorer(1.0), VersionScorer(2.0), VersionScorer(3.0)
            legal = {1.0, 2.0, 3.0}
            torn: list = []
            ev = h.svc.evaluator
            real_many = ev.evaluate_many

            def checked_many(rounds):
                outs = real_many(rounds)
                for o in outs:
                    if o is None or len(o) == 0:
                        continue
                    vals = set(np.asarray(o).tolist())  # dflint: disable=DF033 per-round torn-mix probe, not a hot path
                    if vals & legal and len(vals) > 1:
                        torn.append(vals)
                return outs

            monkeypatch.setattr(ev, "evaluate_many", checked_many)
            stop = asyncio.Event()
            completed, dropped = [], []

            async def traffic():
                while not stop.is_set():
                    futs = [h.svc.reschedule(h.child.id) for _ in range(3)]
                    for out in await asyncio.gather(*futs, return_exceptions=True):
                        (dropped if isinstance(out, Exception) or not out.parents else completed).append(out)
                    await asyncio.sleep(0)

            async def tick_until(cond):
                for _ in range(150):
                    await asyncio.sleep(0.02)
                    await h.tick()
                    if cond():
                        return
                raise AssertionError("condition never held")

            t = asyncio.ensure_future(traffic())
            try:
                await h.publish("v1", scorer=v1)
                await h.tick()
                await tick_until(lambda: ev.serving_version == "v1")
                await h.publish("vbad", scorer=VersionScorer(7.7), corrupt=True)
                await h.tick()
                assert ev.candidate_version == "" and ev.serving_version == "v1"
                await h.publish("v2", scorer=v2)
                await h.tick()
                await tick_until(lambda: ev.serving_version == "v2")
                v2.boom = True
                await tick_until(lambda: ev.serving_version == "v1")
                assert (await h.mc.list_models(type="gnn", version="v2"))[0]["state"] == "rejected"
                await h.publish("v3", scorer=v3)
                await tick_until(lambda: ev.serving_version == "v3")
            finally:
                stop.set()
                await t
            assert not dropped, f"dropped rounds: {dropped[:3]}"
            assert not torn, f"torn score mixes: {torn[:3]}"
            assert completed
            h.link._drain_retired()
            assert h.link._draining == []

    run(body())


@MANAGERS
def test_rollback_reinstalls_previous_models_drift_sketch(run, tmp_path, monkeypatch, manager):
    def sketched_artifact(version: str, fill: float):
        path, _ = make_artifact(PORT, tmp_path, version)
        sk = PORT.FeatureSketch(2, names=("na", "nb"))
        sk.update(np.full((8, 2), fill))
        PORT.artifacts.save_sketch(path, sk)
        return path, PORT.artifacts.artifact_digest(path), sk

    async def body():
        async with LinkHarness(tmp_path, monkeypatch, manager=manager,
                               health_gates=_health_gates(PORT)) as h:
            await h.mc.set_config("model_rollout", GATED)
            drift = h.svc.drift
            p1, d1, sk1 = sketched_artifact("v1", 0.25)
            await h.publish("v1", scorer=VersionScorer(0.5), path=p1, digest=d1)
            await h.tick()
            await h.drive_rounds(6)
            await h.tick()
            assert drift.reference_version == "v1"
            assert np.array_equal(drift.reference.counts, sk1.counts)
            await h.drive_rounds(10)
            v2 = VersionScorer(0.9)
            p2, d2, sk2 = sketched_artifact("v2", 0.75)
            await h.publish("v2", scorer=v2, path=p2, digest=d2)
            await h.tick()
            await h.drive_rounds(6)
            await h.tick()
            assert drift.reference_version == "v2"
            assert np.array_equal(drift.reference.counts, sk2.counts)
            v2.boom = True
            await h.drive_rounds(8)
            await h.tick()
            assert h.svc.evaluator.serving_version == "v1"
            assert drift.reference_version == "v1"
            assert np.array_equal(drift.reference.counts, sk1.counts)

    run(body())


class _OutageManager:
    """tests/test_manager_link.py's stub: flip ``dark`` and every RPC raises."""

    def __init__(self):
        self.dark = False
        self.registrations = 0
        self.config_pulls = 0

    def _gate(self):
        if self.dark:
            raise ConnectionError("manager dark")

    async def keepalive(self, kind, hostname, cluster_id, stats=None):
        self._gate()

    async def update_scheduler(self, hostname, ip, port, idc="", location=""):
        self._gate()
        self.registrations += 1
        return {"id": 7, "scheduler_cluster_id": 1}

    async def cluster_config(self, cluster_id):
        self._gate()
        self.config_pulls += 1
        return {"seed_peers": [], "schedulers": []}

    async def rollout_status(self, name, scheduler_id):
        self._gate()
        return {"active": None}


def _outage_link(svc, mgr, *, hostname="sch-a"):
    link = PORT.ManagerLink(svc, "127.0.0.1:1", hostname=hostname, ip="127.0.0.1", port=1)
    link.manager = mgr
    link.cluster_id = 1
    link._rejoin_delay = lambda: 0.0
    return link


def test_keepalive_outage_declared_after_two_failures_then_rejoin(run):
    async def body():
        svc = PORT.SchedulerService()
        mgr = _OutageManager()
        link = _outage_link(svc, mgr)
        assert await link.keepalive_once()
        assert not link.manager_unreachable
        mgr.dark = True
        assert not await link.keepalive_once()
        assert not link.manager_unreachable
        assert not await link.keepalive_once()
        assert link.manager_unreachable
        assert PORT.metrics.MANAGER_UNREACHABLE.value == 1.0
        mgr.dark = False
        regs_before = mgr.registrations
        assert await link.keepalive_once()
        assert not link.manager_unreachable
        assert PORT.metrics.MANAGER_UNREACHABLE.value == 0.0
        assert mgr.registrations == regs_before + 1
        assert mgr.config_pulls >= 1
        assert await link.keepalive_once()
        assert mgr.registrations == regs_before + 1

    run(body())


def test_rejoin_delay_is_deterministic_per_host_and_equals_the_references():
    svc, ref_svc = PORT.SchedulerService(), PKGS["ref"].SchedulerService()
    delays = []
    for name in ("sch-%02d" % i for i in range(16)):
        link = PORT.ManagerLink(svc, "127.0.0.1:1", hostname=name, ip="127.0.0.1", port=1)
        ref = PKGS["ref"].ManagerLink(ref_svc, "127.0.0.1:1", hostname=name, ip="127.0.0.1", port=1)
        d = link._rejoin_delay()
        assert 0.0 <= d < link.keepalive_interval
        assert d == link._rejoin_delay() == ref._rejoin_delay()
        delays.append(d)
    assert len({round(d, 6) for d in delays}) >= 12


def test_rollout_watch_freezes_during_registry_outage(run):
    async def body():
        svc = PORT.SchedulerService(evaluator=PORT.new_evaluator("ml"))
        mgr = _OutageManager()
        link = _outage_link(svc, mgr)
        link.scheduler_id = 7
        bundle_before = svc.evaluator.serving_bundle
        mgr.dark = True
        with pytest.raises(ConnectionError):
            await link._check_model()
        assert link.manager_unreachable
        assert svc.evaluator.serving_bundle is bundle_before
        mgr.dark = False
        await link._check_model()
        assert not link.manager_unreachable

    run(body())


@MANAGERS
def test_a_live_manager_outage_freezes_the_watch_and_the_link_rejoins(run, tmp_path, monkeypatch, manager):
    """Against a real manager process-in-loop: stop it, two keepalives fail,
    the watch freezes while ml rounds still score on the serving model;
    restart it on the same port and database and the link rejoins."""

    async def body():
        async with LinkHarness(tmp_path, monkeypatch, manager=manager) as h:
            await h.link.start()
            try:
                await h.publish("v1", scorer=VersionScorer(0.5))
                await h.tick()
                assert h.svc.evaluator.serving_version == "v1"
                h.link._rejoin_delay = lambda: 0.0
                port = int(h.manager.address.rsplit(":", 1)[1])
                # one attempt a beat, and a breaker that half-opens at once
                # (its 10 s default would outlast the test)
                h.link.manager._c.retries = 0
                h.link.manager._c.breaker = CircuitBreaker(reset_timeout=0.0)
                await h.manager.stop()
                assert not await h.link.keepalive_once()
                assert not await h.link.keepalive_once()
                assert h.link.manager_unreachable
                assert PORT.metrics.MANAGER_UNREACHABLE.value == 1.0
                with pytest.raises(Exception):
                    await h.tick()
                await h.drive_rounds(2)
                assert np.all(h.svc.evaluator.evaluate(h.child, h.parents) == 0.5)
                h.manager = h.mpkg.ManagerServer(db_path=str(tmp_path / "m.db"), port=port)
                await h.manager.start()
                assert await h.link.keepalive_once()
                assert not h.link.manager_unreachable
                assert "sch-test" in [s["hostname"] for s in await h.mc.list_schedulers()]
                await h.tick()
                assert h.svc.evaluator.serving_version == "v1"
            finally:
                await h.link.stop()

    run(body())


def test_preheat_job_completes_with_the_references_failure(run, tmp_path, monkeypatch):
    """The port has no seed daemon: a preheat job completes, failed, with the
    reference link's own error."""

    async def body():
        async with LinkHarness(tmp_path, monkeypatch) as h:
            await h.link.start()
            try:
                job = await h.mc.create_job("preheat", {"urls": ["http://origin/a"]},
                                            scheduler_cluster_ids=[h.link.cluster_id])
                for _ in range(200):
                    state = await h.mc.job_state(job["id"])
                    if state["state"] not in ("PENDING", "STARTED"):
                        break
                    await asyncio.sleep(0.02)
                assert state["state"] == "FAILURE", state
                assert "no seed peers available" in json.dumps(state)
            finally:
                await h.link.stop()

    run(body())


async def _scenario(h) -> list:
    """One rollout scenario, recorded step by step: the evaluator's serving
    and candidate versions, swap-count deltas by result, rollback delta and
    the registry's model states."""
    m = h.pkg.metrics
    results = ("ok", "digest_mismatch", "missing", "load_error", "rollback", "rejected_version")
    base = {r: h.swaps(r) for r in results}
    rb0 = m.MODEL_ROLLBACK_TOTAL.value
    trace = []

    async def record(step):
        ev = h.svc.evaluator
        rows = await h.mc.list_models(type="gnn")
        trace.append({
            "step": step, "serving": ev.serving_version, "candidate": ev.candidate_version,
            "swaps": {r: h.swaps(r) - base[r] for r in results},
            "rollbacks": m.MODEL_ROLLBACK_TOTAL.value - rb0,
            "registry": sorted((r["version"], r["state"]) for r in rows),
        })

    await h.publish("v0", scorer=VersionScorer(0.3))
    await h.tick()
    await record("ungated v0")
    await h.mc.set_config("model_rollout", GATED)
    await h.publish("v1", scorer=VersionScorer(0.5))
    await h.tick()
    await record("candidate v1")
    await h.drive_rounds(8)
    await h.tick()
    await record("promote v1")
    await h.publish("vbad", scorer=VersionScorer(9.9), corrupt=True)
    await h.tick()
    await record("corrupt vbad")
    v2 = VersionScorer(0.9)
    await h.publish("v2", scorer=v2)
    await h.tick()
    await h.drive_rounds(8)
    await h.tick()
    await record("promote v2")
    v2.boom = True
    await h.drive_rounds(8)
    await h.tick()
    await record("rollback v2")
    await h.publish("v3", scorer=VersionScorer(0.7))
    await h.publish("v4", scorer=VersionScorer(0.8))
    await h.tick()
    await record("v4 supersedes v3")
    return trace


@MANAGERS
def test_both_links_walk_the_same_rollout(run, tmp_path, monkeypatch, manager):
    traces = {}
    for link in ("ref", "port"):
        async def body(link=link):
            d = tmp_path / link
            d.mkdir()
            async with LinkHarness(d, monkeypatch, link=link, manager=manager,
                                   health_gates=_health_gates(PKGS[link])) as h:
                return await _scenario(h)

        traces[link] = run(body())
    assert traces["port"] == traces["ref"]
    last = traces["port"][-1]
    assert last["serving"] == "v1" and last["candidate"] == "v4"
    assert dict(last["registry"])["v2"] == "rejected"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A GNN artifact written by the port's trainer service on the CPU, over
    the synthetic cluster's hosts host-000000..host-000023."""
    root = tmp_path_factory.mktemp("link")
    cfg = TrainerConfig(
        model_dir=str(root / "models"), device="cpu",
        mlp=train_mlp.MLPTrainConfig(hidden=(32, 16), steps=10, batch_size=64),
        gnn=train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=64, warmup_steps=2),
        gnn_steps=8, gnn_steps_per_call=4,
    )
    d, p = synth_telemetry_records(500, 300, 24, seed=5)

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


def test_a_real_torch_artifact_serves_through_the_link_and_drains(run, tmp_path, monkeypatch, trained):
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")

    async def body():
        async with LinkHarness(tmp_path, monkeypatch, real_load=True,
                               host_ids=[f"host-{i:06d}" for i in range(6)]) as h:
            await h.mc.publish_model("gnn", "t1", artifact_path=trained["artifact"],
                                     artifact_digest=trained["digest"])
            await h.tick()
            ev = h.svc.evaluator
            assert ev.serving_version == "t1"
            scorer = ev.serving_bundle.scorer
            assert isinstance(scorer, GNNScorer) and scorer.engine == "torch"
            assert _metric(PORT.metrics.ML_SERVING_MODE, mode="torch") == 1.0
            fallbacks = h.svc.local_metrics.base_fallback.value
            out = ev.evaluate(h.child, h.parents)
            assert out.shape == (len(h.parents),) and np.all(np.isfinite(out))
            assert h.svc.local_metrics.base_fallback.value == fallbacks
            # a second version from the same artifact: t1 goes warm, then a
            # third retires it to draining and the drain closes its scorer
            for v in ("t2", "t3"):
                await h.mc.publish_model("gnn", v, artifact_path=trained["artifact"],
                                         artifact_digest=trained["digest"])
                await h.tick()
            assert ev.serving_version == "t3" and h.link._warm_prev.version == "t2"
            h.link._drain_retired()
            assert h.link._draining == [] and not scorer.ready
            assert len(h.loads) == 3

    run(body())


@MANAGERS
def test_a_registered_links_rollback_flips_the_cluster_wide_row(run, tmp_path, monkeypatch, manager):
    """A started link has a scheduler id of its own, and the trainer's rows
    are cluster-wide (scheduler id 0): the port's auto-rollback names the
    installed row's id, so the registry flips. The reference's link names its
    own id there, and its registry rollback finds no active row."""

    async def body():
        async with LinkHarness(tmp_path, monkeypatch, manager=manager,
                               health_gates=_health_gates(PORT), model_watch_interval=3600.0,
                               keepalive_interval=3600.0) as h:
            await h.link.start()
            try:
                assert h.link.scheduler_id
                await h.mc.set_config("model_rollout", GATED)
                await h.publish("v1", scorer=VersionScorer(0.5))
                await h.tick()
                await h.drive_rounds(6)
                await h.tick()
                await h.drive_rounds(8)
                v2 = VersionScorer(0.9)
                await h.publish("v2", scorer=v2)
                await h.tick()
                await h.drive_rounds(6)
                await h.tick()
                assert h.svc.evaluator.serving_version == "v2"
                v2.boom = True
                await h.drive_rounds(8)
                await h.tick()
                assert h.svc.evaluator.serving_version == "v1"
                states = {r["version"]: r["state"] for r in await h.mc.list_models(type="gnn")}
                assert states == {"v1": "active", "v2": "rejected"}
            finally:
                await h.link.stop()

    run(body())


def test_a_model_swap_fault_fails_the_swap_as_swap_error(run, tmp_path, monkeypatch):
    """The faultline's ``model.swap`` point fires in the port's link where
    the reference's fires it: the swap fails as ``swap_error``, nothing is
    installed, and the next tick without the fault installs the version."""
    from dragonfly2_tpu_torch.resilience import faultline

    async def body():
        async with LinkHarness(tmp_path, monkeypatch) as h:
            await h.publish("v1", scorer=VersionScorer(0.5))
            before = h.swaps("swap_error")
            faultline.enable("model.swap:error:1.0")
            try:
                with pytest.raises(faultline.FaultError):
                    await h.tick()
                assert faultline.ACTIVE.injected_total("model.swap") == 1
            finally:
                faultline.disable()
            assert h.swaps("swap_error") == before + 1
            assert _metric(PORT.metrics.MODEL_SWAP_LAST_ERROR, error="swap_error") == 1.0
            assert h.svc.evaluator.serving_version == ""
            await h.tick()
            assert h.svc.evaluator.serving_version == "v1"

    run(body())


def _tracker_reports(R, seed: int) -> list[dict]:
    """Three schedulers' shadow windows over one seeded sequence of rounds."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(3):
        t = R.ShadowTracker(f"v{seed}", sample_rate=1.0)
        for r in range(int(rng.integers(5, 40))):
            served = rng.random(12)
            cand = served + rng.normal(0.0, 0.05 * (s + 1), 12)
            t.record(served, cand, slice_key=f"idc{r % 2}")
        for _ in range(int(rng.integers(0, 4))):
            t.record_uncovered()
        for _ in range(int(rng.integers(0, 2))):
            t.record_error()
        out.append(t.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rollout_primitives_are_the_references(seed):
    """ShadowTracker windows, merge_reports, DivergenceGates, RolloutPolicy
    and PostSwapHealth's rates give the reference's answers on the same
    inputs."""
    R, RR = PORT.R, PKGS["ref"].R
    mine, theirs = _tracker_reports(R, seed), _tracker_reports(RR, seed)
    assert mine == theirs
    merged = R.merge_reports(mine)
    assert merged == RR.merge_reports(theirs)
    for gates in ({}, {"min_rounds": 10, "min_topk_overlap": 0.9}, {"min_rounds": 10, "max_error_rate": 1.0,
                                                                    "min_rank_corr": 0.99}):
        assert R.DivergenceGates.from_dict(gates).evaluate(merged) == \
            RR.DivergenceGates.from_dict(gates).evaluate(merged)
    row = {"enabled": True, "types": ["gnn", "mlp"], "auto_promote": seed % 2 == 0,
           "gates": {"min_rounds": 50 + seed}}
    a, b = R.RolloutPolicy.from_config(row), RR.RolloutPolicy.from_config(row)
    assert (a.enabled, a.types, a.auto_promote, a.gates.to_dict(), a.gated("gnn"), a.gated("x")) == \
        (b.enabled, b.types, b.auto_promote, b.gates.to_dict(), b.gated("gnn"), b.gated("x"))
    before = dict(rounds=10.0 * seed, latency_total=0.5 * seed, fallbacks=1.0, errors=0.0)
    after = dict(rounds=10.0 * seed + 40, latency_total=0.5 * seed + 0.8, fallbacks=9.0, errors=3.0)
    assert R.PostSwapHealth.rates_of(R.HealthSample(**before), R.HealthSample(**after)) == \
        RR.PostSwapHealth.rates_of(RR.HealthSample(**before), RR.HealthSample(**after))
    assert R.STATE_CANDIDATE == RR.STATE_CANDIDATE and R.STATE_REJECTED == RR.STATE_REJECTED
