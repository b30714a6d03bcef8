"""The port's swarm simulator against the reference's, on the CPU.

- ``sim/clockloop.py``: a sleep costs virtual time, not wall time; timers
  fire in virtual order; a future nothing in the loop resolves raises "would
  block forever", and so does one that a worker thread resolves (the
  selector never reports the self-pipe), in both packages. A pending timer
  is advanced past instead.
- ``sim/topology.py`` and ``sim/workload.py``: every draw equal for three
  seeds.
- ``daemon/engine.py``'s ``InProcessSchedulerClient``: one sequence of
  scheduler calls answered equally through both packages.
- ``sim/engine.py``: ``flash_crowd(peers=400, seed=7)`` with telemetry gives
  the reference's determinism tuple (``tests/test_sim.py``) and its whole
  report, apart from the scheduling-round meter's wall fields, and the
  bridged dataset is bit-equal to the reference's.
- ``sim/metrics.py``: the four ``dragonfly_sim_*`` families under the
  reference's names; two runs in one process each move the events counter
  by exactly their own events and give the same report; the
  ``sim_departed_parent`` rule fires on a violation.

A run's order of events depends on string hashing (set iteration in the
scheduler), as the reference's does: both packages are compared inside one
interpreter, so under one hash seed.
"""

import asyncio
import concurrent.futures
import dataclasses
import random
import threading
import time

import numpy as np
import pytest
import torch

from dragonfly2_tpu.daemon import engine as ref_daemon_engine
from dragonfly2_tpu.scheduler import service as ref_service
from dragonfly2_tpu.scheduler.scheduling import SchedulingConfig as RefSchedulingConfig
from dragonfly2_tpu.sim import clockloop as ref_clockloop
from dragonfly2_tpu.sim import metrics as ref_sim_metrics
from dragonfly2_tpu.sim import scenarios as ref_scenarios
from dragonfly2_tpu.sim import topology as ref_topology
from dragonfly2_tpu.sim import workload as ref_workload
from dragonfly2_tpu.utils.clock import VirtualClock as RefVirtualClock
from dragonfly2_tpu_torch.daemon import engine as port_daemon_engine
from dragonfly2_tpu_torch.observability.alerts import AlertEngine, default_rules
from dragonfly2_tpu_torch.observability.timeseries import MetricsRecorder
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.scheduler.scheduling import SchedulingConfig
from dragonfly2_tpu_torch.sim import clockloop as port_clockloop
from dragonfly2_tpu_torch.sim import metrics as port_sim_metrics
from dragonfly2_tpu_torch.sim import scenarios as port_scenarios
from dragonfly2_tpu_torch.sim import topology as port_topology
from dragonfly2_tpu_torch.sim import workload as port_workload
from dragonfly2_tpu_torch.trainer import dataset as port_dataset
from dragonfly2_tpu_torch.utils.clock import VirtualClock

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools.
torch.set_num_threads(1)

PKGS = {
    "port": (port_clockloop, VirtualClock),
    "ref": (ref_clockloop, RefVirtualClock),
}

# the scheduling-round meter's wall-time fields: the only ones a report may
# differ in across packages (or across two runs)
WALL_FIELDS = frozenset({"wall_s", "events_per_sec", "time_compression", "sched_s", "sched_rounds_per_s"})


# ---------------------------------------------------------------------------
# sim/clockloop.py


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_sleep_advances_virtual_time_not_wall_time(pkg):
    clockloop, Clock = PKGS[pkg]
    clock = Clock()
    order = []

    async def sleeper(delay, tag):
        await asyncio.sleep(delay)
        order.append((tag, asyncio.get_running_loop().time()))

    async def body():
        await asyncio.gather(sleeper(30.0, "b"), sleeper(5.0, "a"), sleeper(3600.0, "c"))
        return asyncio.get_running_loop().time()

    t0 = time.perf_counter()
    end = clockloop.run_virtual(body(), clock)
    assert time.perf_counter() - t0 < 2.0  # an hour of virtual time for nothing
    assert [t for t, _ in order] == ["a", "b", "c"]
    # each timer fires at its own deadline: the selector advances the clock
    # exactly to the next one
    assert [round(at, 6) for _, at in order] == [5.0, 30.0, 3600.0]
    assert end == clock.monotonic() == pytest.approx(3600.0)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_an_unresolvable_future_raises_instead_of_spinning(pkg):
    clockloop, Clock = PKGS[pkg]

    async def body():
        await asyncio.get_running_loop().create_future()

    with pytest.raises(RuntimeError, match="block forever"):
        clockloop.run_virtual(body(), Clock())


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_future_a_worker_thread_resolves_is_never_seen(pkg):
    """The selector never reports the self-pipe ready, so work handed to a
    thread (run_in_executor, call_soon_threadsafe) cannot finish a virtual
    run: with no timer the loop raises; with one (a wait_for deadline) it
    advances virtual time past the thread's work."""
    clockloop, Clock = PKGS[pkg]
    release = threading.Event()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def work():
        release.wait(60.0)
        return 1

    async def unbounded():
        return await asyncio.get_running_loop().run_in_executor(pool, work)

    async def bounded():
        return await asyncio.wait_for(asyncio.get_running_loop().run_in_executor(pool, work), 5.0)

    try:
        with pytest.raises(RuntimeError, match="block forever"):
            clockloop.run_virtual(unbounded(), Clock())
        clock = Clock()
        with pytest.raises(asyncio.TimeoutError):
            clockloop.run_virtual(bounded(), clock)
        assert clock.monotonic() == pytest.approx(5.0)
    finally:
        release.set()
        pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# sim/topology.py and sim/workload.py


def _topology_draws(mod, seed):
    cfg = mod.TopologyConfig(regions=("us-east", "us-west", "eu-west"), region_weights=(3.0, 1.0, 2.0))
    topo = mod.SyntheticTopology(cfg, seed=seed)
    places = [topo.place() for _ in range(200)] + [topo.place("eu-west") for _ in range(20)]
    rtts = [topo.rtt_ms(places[i], places[(i * 7 + 3) % len(places)]) for i in range(len(places))]
    again = [topo.rtt_ms(places[i], places[(i * 7 + 3) % len(places)]) for i in range(len(places))]
    links = [(topo.link_bps(a, b), topo.origin_rate_bps(b)) for a, b in zip(places, places[1:])]
    return [(p.region, p.rack, p.idc, p.location) for p in places], rtts, again, links, cfg.origin_region


def _workload_draws(mod, seed):
    tasks = (mod.TaskSpec("t0", "http://o/0", 256 << 20, 4 << 20), mod.TaskSpec("t1", "http://o/1", 7, 4 << 20))
    cfg = mod.WorkloadConfig(
        poisson_rate_per_s=3.0, poisson_peers=150,
        flash_crowds=(mod.FlashCrowd(10.0, 300, 60.0), mod.FlashCrowd(5.0, 50, 0.0, task_index=1, region="us-west")),
        tasks=tasks, churn_lifetime_mean_s=600.0, churn_crash_fraction=0.25, probe_fraction=0.3,
        gray_fraction=0.1, priority_classes=(1.0, 5.0, 9.0),
    )
    wl = mod.Workload(cfg, seed=seed)
    arrivals = [(a.at_s, a.index, a.task.task_id, a.task.total_pieces, a.region) for a in wl.arrivals()]
    draws = [(wl.lifetime_s(), wl.departure_is_crash(), wl.runs_probes(), wl.is_gray(), wl.draw_priority())
             for _ in range(300)]
    immortal = mod.Workload(mod.WorkloadConfig(), seed=seed)
    return arrivals, draws, immortal.lifetime_s(), [a.at_s for a in immortal.arrivals()]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_topology_and_workload_draws_are_the_references(seed):
    assert _topology_draws(port_topology, seed) == _topology_draws(ref_topology, seed)
    assert _workload_draws(port_workload, seed) == _workload_draws(ref_workload, seed)


def test_topology_config_refusals_are_the_references():
    for mod in (port_topology, ref_topology):
        with pytest.raises(ValueError, match="region_weights"):
            mod.TopologyConfig(regions=("a", "b"), region_weights=(1.0,))


# ---------------------------------------------------------------------------
# daemon/engine.py: InProcessSchedulerClient


def _plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


async def _client_steps(client, svc_mod) -> list:
    """Every verb of the client protocol, in one order; every answer, plain."""
    hosts = [svc_mod.HostInfo(id=f"h{i}", ip=f"10.3.0.{i}", hostname=f"n{i}", download_port=8000 + i,
                              idc=f"idc{i % 2}", location=f"eu|rack{i % 3}") for i in range(10)]
    meta = svc_mod.TaskMeta("t", "http://origin/t")
    out = []
    for h in hosts:
        out.append(await client.announce_host(h, {"cpu_usage": 0.5}))  # dflint: disable=DF025 one call at a time: the answers are compared in order
    for i, h in enumerate(hosts):
        out.append(await client.sync_probes(h.id, [  # dflint: disable=DF025 one call at a time, as above
            {"dst_host_id": f"h{(i + d) % 10}", "rtt_ms": 0.5 * d + i, "success": True} for d in (1, 4)]))
    out.append(await client.register_peer("p0", meta, hosts[0]))
    out.append(await client.report_task_metadata("t", content_length=24 << 20, piece_size=4 << 20))
    out.append(await client.report_pieces("p0", [(k, 3.0, "") for k in range(6)]))
    out.append(await client.report_peer_result("p0", success=True, bandwidth_bps=2e8))
    for j in range(1, 7):
        r = await client.register_peer(f"p{j}", meta, hosts[j])  # dflint: disable=DF025 one round at a time, as above
        out.append(r)
        for k, par in enumerate(r.parents):
            out.append(await client.report_piece_result(  # dflint: disable=DF025 one report at a time, as above
                f"p{j}", k, success=True, cost_ms=2.0 + k, parent_id=par.peer_id))
        out.append(await client.report_batch(  # dflint: disable=DF025 one flush at a time, as above
            f"p{j}", [(k, 2.5, "p0") for k in range(2, 6)], {"success": j % 3 != 0, "bandwidth_bps": 1e8}))
    out.append(await client.announce_task("a", meta, hosts[8], content_length=24 << 20, piece_size=4 << 20,
                                          piece_indices=range(6)))
    out.append(await client.report_piece_result("p3", 1, success=False, parent_id="p0"))
    out.append(await client.reschedule("p3"))
    out.append(await client.leave_peer("p4"))
    out.append(await client.leave_host("h5"))
    out.append(await client.register_peer("p9", meta, hosts[9]))
    return [_plain(x) for x in out]


def test_the_in_process_client_answers_as_the_references():
    def run(svc_mod, engine_mod, Config, Clock):
        svc = svc_mod.SchedulerService(scheduling_config=Config(retry_interval=0.001), clock=Clock(start=50.0),
                                       topology_rng=random.Random(3), decision_sample_rate=1.0)
        svc.scheduling.set_rng_state(random.Random(4).getstate())
        try:
            got = asyncio.run(asyncio.wait_for(_client_steps(engine_mod.InProcessSchedulerClient(svc), svc_mod), 60))
            fed = {k: v for k, v in svc.federation_state().items() if k != "epoch"}
            return got, fed
        finally:
            svc.close()

    port = run(port_service, port_daemon_engine, SchedulingConfig, VirtualClock)
    ref = run(ref_service, ref_daemon_engine, RefSchedulingConfig, RefVirtualClock)
    assert port == ref
    rounds = [x for x in port[0] if isinstance(x, dict) and "parents" in x]
    assert sum(bool(r["parents"]) for r in rounds) >= 4  # rounds handed out parents


# ---------------------------------------------------------------------------
# sim/engine.py


def _report(rep) -> dict:
    d = dataclasses.asdict(rep)
    for k in WALL_FIELDS:
        d.pop(k)
    for member in d["per_scheduler"]:
        member.pop("epoch")  # a random instance id per service
    return d


def _flash_crowd(scenarios, tmp_path, tag):
    sc = scenarios.flash_crowd(peers=400, seed=7, telemetry_dir=str(tmp_path / tag))
    try:
        rep = sc.sim.run()
        ds = sc.sim.build_dataset()
        sc.check(rep)
    finally:
        sc.sim.close()
    return rep, ds


def test_flash_crowd_is_the_references_and_its_dataset_bit_equal(tmp_path):
    port_rep, port_ds = _flash_crowd(port_scenarios, tmp_path, "port")
    ref_rep, ref_ds = _flash_crowd(ref_scenarios, tmp_path, "ref")

    def tuple_of(rep, ds):  # the reference's determinism tuple (tests/test_sim.py)
        return (rep.events, rep.rounds_with_parents, rep.parents_assigned, rep.p2p_bytes, rep.same_region_frac,
                ds["nodes"], ds["edges"], ds["pairs"], ds["probe_rows"])

    assert tuple_of(port_rep, port_ds) == tuple_of(ref_rep, ref_ds)
    assert port_rep.completed >= 380 and port_rep.departed and port_rep.crashed and port_ds["probe_rows"] > 0
    assert _report(port_rep) == _report(ref_rep)
    assert {k: v for k, v in port_ds.items() if k != "dataset"} == {k: v for k, v in ref_ds.items() if k != "dataset"}
    got, want = port_ds["dataset"], ref_ds["dataset"]
    assert isinstance(got, port_dataset.Dataset)
    assert got.host_index == want.host_index
    for part in ("graph", "pairs"):
        for name, a, b in zip(getattr(got, part)._fields, getattr(got, part), getattr(want, part)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), (part, name)
    assert got.feature_sketch.names == want.feature_sketch.names
    np.testing.assert_array_equal(got.feature_sketch.counts, want.feature_sketch.counts)
    # the meter's wall fields are measured, and named here as the only exceptions
    assert port_rep.wall_s > 0 and port_rep.sched_s > 0 and port_rep.sched_rounds == ref_rep.sched_rounds


def test_sim_metric_families_are_the_references():
    for name in ("SIM_EVENTS_TOTAL", "SIM_PEERS", "SIM_ORIGIN_EGRESS_BYTES", "SIM_DEPARTED_PARENT_ROUNDS"):
        mine, theirs = getattr(port_sim_metrics, name), getattr(ref_sim_metrics, name)
        assert (mine.name, mine.label_names, mine.kind) == (theirs.name, theirs.label_names, theirs.kind), name
    assert port_sim_metrics.SIM_DEPARTED_PARENT_ROUNDS.name == "dragonfly_sim_departed_parent_rounds_total"


def test_two_runs_in_one_process_do_not_see_each_others_counts():
    """The families are process-wide; a run reads its own through a fresh
    recorder's windowed rates and its services' own meters, so a second run
    gives the first's report and moves the counters by its own events."""
    out = []
    for _ in range(2):
        ev0 = port_sim_metrics.SIM_EVENTS_TOTAL.value
        eg0 = port_sim_metrics.SIM_ORIGIN_EGRESS_BYTES.value
        sc = port_scenarios.flash_crowd(peers=200, seed=3)
        try:
            rep = sc.sim.run()
            sc.check(rep)  # its mid-crowd windowed rates read this run alone
        finally:
            sc.sim.close()
        assert port_sim_metrics.SIM_EVENTS_TOTAL.value - ev0 == rep.events
        assert port_sim_metrics.SIM_ORIGIN_EGRESS_BYTES.value - eg0 == sum(rep.origin_egress_bytes.values()) > 0
        assert rep.sched_rounds == rep.rounds_with_parents  # this run's services only
        out.append(_report(rep))
    assert out[0] == out[1]


def test_the_departed_parent_alert_fires_on_a_violation():
    rules = [r for r in default_rules() if r.name == "sim_departed_parent"]
    assert rules and rules[0].metric == port_sim_metrics.SIM_DEPARTED_PARENT_ROUNDS.name
    rec = MetricsRecorder(interval=5.0)
    engine = AlertEngine(rec, rules=rules, export=False)
    now = 1_600_000_000.0
    port_sim_metrics.SIM_DEPARTED_PARENT_ROUNDS.inc()
    rec.sample_once(now=now)
    engine.evaluate_once(now=now + 1)
    assert engine.active() == []
    port_sim_metrics.SIM_DEPARTED_PARENT_ROUNDS.inc()
    rec.sample_once(now=now + 5)
    engine.evaluate_once(now=now + 5)
    assert [a["name"] for a in engine.active()] == ["sim_departed_parent"]
