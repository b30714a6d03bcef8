"""The port's metrics plane against the reference's.

- The same counters give the same frames: one seeded sequence of counter,
  gauge and histogram moves over the families a stats frame reads (rounds,
  fallbacks, serving mode, rollout state, federation, brownout ladder,
  manager outage, loop lag, trainer) goes into a port registry and a
  reference one, each sampled by its own package's ``MetricsRecorder`` at the
  same instants. Rates, latest values, windowed histograms, series and
  ``build_stats_frame`` are equal; the only field allowed to differ is the
  frame's ``ts`` (wall time).
- The same alerts fire: the default rule sets are equal, and the port's and
  the reference's ``AlertEngine`` over those recorders activate the same
  rules with the same values, through ``for_s`` and recovery.
- Frames cross packages: the reference's manager aggregates frames built by
  the port's recorder and the port's manager frames built by the
  reference's, into equal ``cluster_stats``.
- The port's scheduler families a frame reads exist under the reference's
  names, and a port ``ManagerLink`` carries its frame on the keepalive.
- Dynconfig: staleness-stamped snapshots written by one package load in the
  other, and a ``Dynconfig`` boots from the other package's disk cache.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import pytest
import torch

import dragonfly2_tpu.observability.alerts as ref_alerts
import dragonfly2_tpu.observability.metrics as ref_obs_metrics
import dragonfly2_tpu.observability.timeseries as ref_ts
import dragonfly2_tpu.scheduler.metrics as ref_sched_metrics
import dragonfly2_tpu.utils.dynconfig as ref_dynconfig
import dragonfly2_tpu_torch.observability.alerts as port_alerts
import dragonfly2_tpu_torch.observability.metrics as port_obs_metrics
import dragonfly2_tpu_torch.observability.timeseries as port_ts
import dragonfly2_tpu_torch.scheduler.metrics as port_sched_metrics
import dragonfly2_tpu_torch.utils.dynconfig as port_dynconfig
from dragonfly2_tpu.manager.service import ManagerService as RefManagerService
from dragonfly2_tpu_torch.manager.server import ManagerServer
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.observability.sketches import PSI_MAJOR
from dragonfly2_tpu_torch.scheduler.manager_link import ManagerLink
from dragonfly2_tpu_torch.scheduler.service import SchedulerService

torch.set_num_threads(1)


# each test's coroutine runs under this deadline (conftest's runner has
# none), so that a stuck await fails its test instead of holding the suite
DEADLINE_S = 120.0


@pytest.fixture
def run():
    """conftest's runner (a fresh loop in debug mode) under DEADLINE_S."""
    return lambda coro: asyncio.run(asyncio.wait_for(coro, DEADLINE_S), debug=True)

BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)


def make_registry(obs_metrics):
    """The families the stats frame and the default rules read, under the
    production names (the registry prefixes ``dragonfly``)."""
    reg = obs_metrics.MetricsRegistry()
    fam = {
        "rounds": reg.histogram("schedule_duration_seconds", subsystem="scheduler", buckets=BUCKETS),
        "fallback": reg.counter("ml_base_fallback_total", subsystem="scheduler", labels=("reason",)),
        "pieces": reg.counter("piece_result_total", subsystem="scheduler", labels=("success",)),
        "mode": reg.gauge("ml_serving_mode", subsystem="scheduler", labels=("mode",)),
        "rollout": reg.gauge("model_rollout_state", subsystem="scheduler", labels=("state",)),
        "syncs": reg.counter("federation_syncs_total", subsystem="scheduler", labels=("result",)),
        "peers": reg.gauge("federation_peers", subsystem="scheduler"),
        "degradation": reg.gauge("degradation_level", subsystem="scheduler"),
        "shed": reg.counter("admission_shed_total", subsystem="scheduler", labels=("priority",)),
        "mgr_down": reg.gauge("manager_unreachable", subsystem="scheduler"),
        "lag": reg.histogram("lag_seconds", subsystem="loop", buckets=BUCKETS),
        "drift": reg.gauge("feature_drift_max"),
        "train_steps": reg.counter("train_steps_total"),
        "train_runs": reg.counter("train_runs_total", labels=("model",)),
    }
    return reg, fam


def drive(obs_metrics, ts, t0: float, ticks: int = 12, seed: int = 3):
    """One seeded sequence of moves, sampled every 2 s from ``t0``."""
    rng = np.random.default_rng(seed)
    reg, f = make_registry(obs_metrics)
    rec = ts.MetricsRecorder(reg, interval=2.0, retention_s=120.0)
    modes = ("native", "torch", "base")
    for i in range(ticks):
        for _ in range(int(rng.integers(5, 40))):
            f["rounds"].observe(float(rng.choice(BUCKETS)) * float(rng.random()))
        f["fallback"].inc(float(rng.integers(0, 6)), reason="scorer_error" if i > 6 else "no_scorer")
        f["pieces"].inc(float(rng.integers(10, 50)), success="true")
        f["pieces"].inc(float(rng.integers(0, 3)), success="false")
        m = modes[min(i // 4, 2)]
        for mode in modes:
            f["mode"].set(1.0 if mode == m else 0.0, mode=mode)
        for st in ("idle", "shadowing", "health_watch"):
            f["rollout"].set(1.0 if st == ("shadowing" if i % 5 == 2 else "idle") else 0.0, state=st)
        f["syncs"].inc(1.0, result="ok")
        if i % 3 == 0:
            f["syncs"].inc(1.0, result="error")
        f["peers"].set(2.0)
        f["degradation"].set(float(i >= 9))
        f["shed"].inc(float(rng.integers(0, 4)), priority="low")
        f["mgr_down"].set(float(5 <= i <= 7))
        for _ in range(8):
            f["lag"].observe(float(rng.random()) * 0.2)
        f["drift"].set(float(rng.random()) * 0.4)
        f["train_steps"].inc(float(rng.integers(0, 30)))
        f["train_runs"].inc(1.0, model="gnn")
        rec.sample_once(now=t0 + 2.0 * i)
    return rec


def _queries(rec, now: float) -> dict:
    return {
        "rate": rec.rate("dragonfly_scheduler_piece_result_total", {"success": "true"}, window_s=20.0, now=now),
        "rate_all": rec.rate("dragonfly_scheduler_ml_base_fallback_total", window_s=60.0, now=now),
        "latest": rec.latest("dragonfly_feature_drift_max"),
        "hist": rec.hist_window("dragonfly_scheduler_schedule_duration_seconds", window_s=10.0, now=now),
        "lag": rec.hist_window("dragonfly_loop_lag_seconds", window_s=30.0, now=now),
        "series": rec.series(),
        "stats": {k: v for k, v in rec.stats().items() if k != "last_sample_cost_us"},
    }


def test_the_recorders_answer_equal_queries():
    t0 = 1000.0
    mine, theirs = drive(port_obs_metrics, port_ts, t0), drive(ref_obs_metrics, ref_ts, t0)
    for now in (t0 + 10.0, t0 + 22.0):
        assert _queries(mine, now) == _queries(theirs, now)
    for q in (0.5, 0.95, 0.99):
        counts = [3.0, 0.0, 7.0, 1.0, 0.0, 2.0, 1.0]
        assert port_ts.bucket_quantile(BUCKETS, counts, sum(counts), q) == \
            ref_ts.bucket_quantile(BUCKETS, counts, sum(counts), q)


@pytest.mark.parametrize("with_alerts", [False, True])
def test_the_same_counters_give_the_same_stats_frame(with_alerts):
    t0 = time.time() - 24.0  # the frame windows against wall time
    mine, theirs = drive(port_obs_metrics, port_ts, t0), drive(ref_obs_metrics, ref_ts, t0)
    if with_alerts:
        eng_p = port_alerts.AlertEngine(mine, port_alerts.default_rules())
        eng_r = ref_alerts.AlertEngine(theirs, ref_alerts.default_rules())
        eng_p.evaluate_once(now=t0 + 22.0)
        eng_r.evaluate_once(now=t0 + 22.0)
    a = port_ts.build_stats_frame(mine, service="scheduler", hostname="s1",
                                  alerts=eng_p if with_alerts else None)
    b = ref_ts.build_stats_frame(theirs, service="scheduler", hostname="s1",
                                 alerts=eng_r if with_alerts else None)
    a.pop("ts"), b.pop("ts")
    assert a == b
    assert a["serving_mode"] == "base" and a["federation_peers"] == 2 and a["rates"]
    assert len(json.dumps(a)) < 4096


def _rule_fields(rule) -> dict:
    return {k: getattr(rule, k) for k in ("name", "metric", "bound", "kind", "op", "labels", "denom",
                                          "window_s", "for_s", "min_denom_rate", "quantile", "description")
            if hasattr(rule, k)}


def test_the_default_rule_sets_are_equal():
    mine, theirs = port_alerts.default_rules(), ref_alerts.default_rules()
    assert [_rule_fields(r) for r in mine] == [_rule_fields(r) for r in theirs]
    assert any(r.bound == PSI_MAJOR for r in mine)


def test_the_same_alerts_fire_through_for_and_recovery():
    t0 = 5000.0
    mine, theirs = drive(port_obs_metrics, port_ts, t0), drive(ref_obs_metrics, ref_ts, t0)
    rules = lambda alerts: alerts.default_rules() + [  # noqa: E731
        alerts.AlertRule(name="err_for", kind="ratio", metric="dragonfly_scheduler_ml_base_fallback_total",
                         labels={"reason": "scorer_error"},
                         denom="dragonfly_scheduler_schedule_duration_seconds",
                         bound=0.01, window_s=30.0, for_s=4.0),
        alerts.AlertRule(name="lag_q", kind="quantile", metric="dragonfly_loop_lag_seconds",
                         bound=0.05, window_s=30.0),
    ]
    eng_p = port_alerts.AlertEngine(mine, rules(port_alerts))
    eng_r = ref_alerts.AlertEngine(theirs, rules(ref_alerts))
    fired = []
    for now in (t0 + 14.0, t0 + 18.0, t0 + 22.0, t0 + 200.0):
        a, b = eng_p.evaluate_once(now=now), eng_r.evaluate_once(now=now)
        assert a == b
        assert eng_p.active() == eng_r.active()
        assert eng_p.status() == eng_r.status()
        fired.append(a)
    assert fired[0] and "err_for" not in fired[0] and "err_for" in fired[2]
    assert fired[-1] == [r for r in fired[-1] if r in ("scheduler_degraded",)] or fired[-1] == []
    assert port_alerts.ALERT_ACTIVE.labels(name="err_for").value == 0.0  # cleared on recovery


def test_frames_cross_packages_into_equal_cluster_stats():
    t0 = time.time() - 24.0
    recs = {"port": drive(port_obs_metrics, port_ts, t0, seed=1), "ref": drive(ref_obs_metrics, ref_ts, t0, seed=2)}
    frames = {
        ("scheduler", "s-port"): port_ts.build_stats_frame(recs["port"], service="scheduler", hostname="s-port"),
        ("scheduler", "s-ref"): ref_ts.build_stats_frame(recs["ref"], service="scheduler", hostname="s-ref"),
        ("trainer", "t1"): port_ts.build_stats_frame(recs["port"], service="trainer", hostname="t1"),
    }
    views = []
    for svc in (ManagerService(), RefManagerService()):
        for (kind, host), fr in frames.items():
            svc.keepalive(kind, host, stats=fr)
        view = svc.cluster_stats(history=1)
        view.pop("ts")
        for m in view["members"]:
            m.pop("age_s")
        views.append(view)
    assert views[0] == views[1]
    assert views[0]["cluster"]["members_live"] == 3


def test_port_families_carry_the_references_names():
    names = ("MODEL_SWAP_TOTAL", "MODEL_SWAP_LAST_ERROR", "MODEL_ROLLBACK_TOTAL", "MODEL_ROLLOUT_STATE",
             "FEDERATION_SYNCS_TOTAL", "FEDERATION_PEERS_GAUGE", "FEDERATION_LAST_SYNC_TIMESTAMP",
             "FEDERATION_DELTAS_SENT_TOTAL", "FEDERATION_DELTAS_APPLIED_TOTAL", "MANAGER_UNREACHABLE",
             "ML_SERVING_MODE", "SCHEDULE_DURATION", "ML_BASE_FALLBACK_TOTAL", "DEGRADATION_LEVEL")
    for n in names:
        mine, theirs = getattr(port_sched_metrics, n), getattr(ref_sched_metrics, n)
        assert (mine.name, mine.label_names, mine.kind) == (theirs.name, theirs.label_names, theirs.kind), n
    reg = port_obs_metrics.default_registry()
    assert reg.get(port_sched_metrics.ML_SERVING_MODE.name) is port_sched_metrics.ML_SERVING_MODE
    assert port_sched_metrics.MODEL_SWAP_TOTAL in reg.families()


def test_a_port_link_carries_its_frame_on_the_keepalive(run, tmp_path):
    async def body():
        manager = ManagerServer(db_path=str(tmp_path / "m.db"))
        await manager.start()
        rec = port_ts.MetricsRecorder(interval=2.0)
        eng = port_alerts.AlertEngine(rec, port_alerts.default_rules())
        svc = SchedulerService()
        link = ManagerLink(svc, manager.address, hostname="sch-frame", ip="127.0.0.1", port=9,
                           recorder=rec, alert_engine=eng)
        modes = ("native", "torch", "jax", "base")
        saved = {m: port_sched_metrics.ML_SERVING_MODE.labels(mode=m).value for m in modes}
        try:
            await link.start()
            for m in modes:
                port_sched_metrics.ML_SERVING_MODE.set(float(m == "torch"), mode=m)
            rec.sample_once()
            assert await link.keepalive_once()
            view = manager.service.cluster_stats()
            member = [m for m in view["members"] if m["hostname"] == "sch-frame"][0]
            assert member["source_type"] == "scheduler" and not member["stale"]
            assert member["frame"]["serving_mode"] == "torch" and member["frame"]["alerts"] == []
        finally:
            for m, v in saved.items():  # the gauge is process-wide
                port_sched_metrics.ML_SERVING_MODE.set(v, mode=m)
            await link.stop()
            svc.close()
            await manager.stop()

    run(body())


@pytest.mark.parametrize("writer,reader", [(port_dynconfig, ref_dynconfig), (ref_dynconfig, port_dynconfig)],
                         ids=["port-to-ref", "ref-to-port"])
def test_dynconfig_snapshots_round_trip_across_packages(writer, reader, tmp_path, run):
    data = {"cluster_id": 1, "schedulers": [{"hostname": "s", "ip": "127.0.0.1", "port": 9000}],
            "seed_peers": [], "config": {"k": [1, 2.5, "x"]}}
    path = tmp_path / "snap.json"
    writer.store_snapshot(path, data)
    snap = reader.load_snapshot(path)
    assert snap.data == data and 0.0 <= snap.staleness_s() < 60.0
    assert reader.load_snapshot(tmp_path / "missing.json") is None

    async def boot_from_cache():
        async def down():
            raise ConnectionError("manager down")

        seen = []
        dc = reader.Dynconfig(down, cache_path=str(path), refresh_interval=60.0)
        dc.register(seen.append)
        await dc.load()
        return dc.data, seen, dc.from_cache

    got, seen, from_cache = run(boot_from_cache())
    assert got == data and seen == [data] and from_cache


def test_the_trainer_pushes_its_frame_on_the_keepalive(run, tmp_path):
    """``run_trainer`` with a manager starts the recorder and sends a stats
    frame on ``keepalive("trainer", ...)`` every ``stats_interval``."""
    from dragonfly2_tpu_torch.trainer.server import run_trainer

    async def body():
        manager = ManagerServer(db_path=str(tmp_path / "m.db"))
        await manager.start()
        ready = asyncio.Event()
        task = asyncio.ensure_future(run_trainer(port=0, manager_addr=manager.address, stats_interval=0.1,
                                                 ready_event=ready, model_dir=str(tmp_path / "models"),
                                                 device="cpu"))
        try:
            await asyncio.wait_for(ready.wait(), 30)
            for _ in range(100):
                members = manager.service.cluster_stats()["members"]
                if any(m["source_type"] == "trainer" for m in members):
                    break
                await asyncio.sleep(0.05)
            frame = [m for m in members if m["source_type"] == "trainer"][0]["frame"]
            assert frame["service"] == "trainer" and "rates" in frame
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await manager.stop()

    run(body())
