"""The port's scheduler against the reference's: the whole service with the
torch engine, and the host-side pieces it is built from, one by one.

- The seeded scenario of tests/test_torch_scheduler_scenario.py through the port's
  SchedulerService serving the port's GNNScorer (engine torch, on the CPU),
  over one artifact: the
  scores of every round it recorded within 5e-3 of the other package's
  scorer on the same rows (the tolerance of the port's torch engine against
  JAX, tests/test_torch_wiring.py); and the reference's service, serving
  JAX, likewise against the port's torch scorer.
- Unit parity, each over one seeded sequence of operations applied to both
  packages' objects, outcomes and raised exception types compared:
  ``utils/dag.py``, ``utils/fsm.py`` (the peer and task machines of
  ``scheduler/resource.py``), ``utils/bitset.py``, ``utils/pieces.py``,
  ``utils/deltaclock.py``, ``utils/idgen.py``, ``BandwidthHistory``,
  ``NetworkTopology``, ``SchedulerYaml`` (one YAML file gives equal values
  and equal derived configs; a bad one the same ``ConfigError``), the
  brownout ladder under one pressure series on a VirtualClock, and the
  tracer's head-sampling draw.

No assertion reads a host clock.
"""

import asyncio
import dataclasses
import random

import numpy as np
import pytest
import torch

from dragonfly2_tpu.scheduler import config as ref_config
from dragonfly2_tpu.scheduler import degradation as ref_degradation
from dragonfly2_tpu.scheduler import networktopology as ref_topology
from dragonfly2_tpu.scheduler.manager_link import ManagerLink
from dragonfly2_tpu.observability import tracing as ref_tracing
from dragonfly2_tpu.telemetry import bandwidth as ref_bandwidth
from dragonfly2_tpu.utils import bitset as ref_bitset
from dragonfly2_tpu.utils import clock as ref_clock
from dragonfly2_tpu.utils import config as ref_cfgmod
from dragonfly2_tpu.utils import dag as ref_dag
from dragonfly2_tpu.utils import deltaclock as ref_deltaclock
from dragonfly2_tpu.utils import idgen as ref_idgen
from dragonfly2_tpu.utils import pieces as ref_pieces
from dragonfly2_tpu_torch.cli.dfstress import build_scoring_artifact
from dragonfly2_tpu_torch.observability import tracing as port_tracing
from dragonfly2_tpu_torch.scheduler import config as port_config
from dragonfly2_tpu_torch.scheduler import degradation as port_degradation
from dragonfly2_tpu_torch.scheduler import manager_link
from dragonfly2_tpu_torch.scheduler import networktopology as port_topology
from dragonfly2_tpu_torch.telemetry import bandwidth as port_bandwidth
from dragonfly2_tpu_torch.utils import bitset as port_bitset
from dragonfly2_tpu_torch.utils import clock as port_clock
from dragonfly2_tpu_torch.utils import config as port_cfgmod
from dragonfly2_tpu_torch.utils import dag as port_dag
from dragonfly2_tpu_torch.utils import deltaclock as port_deltaclock
from dragonfly2_tpu_torch.utils import idgen as port_idgen
from dragonfly2_tpu_torch.utils import pieces as port_pieces
from tests.test_torch_scheduler_scenario import NODES, PORT, REF, assert_same, make_service, run_scenario

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

SCORE_TOL = 5e-3
DEADLINE_S = 120


def _outcome(fn):
    """A call's result, or the name of the exception it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the exception's type is the outcome
        return ("raise", type(e).__name__)


# ---- the whole service, torch engine vs JAX --------------------------------


@pytest.fixture(scope="module")
def gnn_artifact(tmp_path_factory):
    return build_scoring_artifact(tmp_path_factory.mktemp("gnn") / "a", n_nodes=NODES, seed=11, device="cpu")


def test_torch_engine_serves_the_scenario_within_tolerance_of_jax(gnn_artifact, tmp_path, monkeypatch):
    """Each package's service serves the scenario on its own GNNScorer; every
    round it recorded, rescored by the other package's scorer on the same
    feature rows and node rows, agrees within SCORE_TOL. (The untrained
    model's scores sit within 1e-2 of each other, so the two services' top-k
    picks part at near-ties, and with them the later rounds: each service's
    own rounds are the fair comparison.)"""
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    port_scorer, port_index = manager_link.load_scorer(str(gnn_artifact.path), device="cpu")
    ref_scorer, ref_index = ManagerLink._load_scorer(str(gnn_artifact.path))
    assert port_scorer.engine == "torch" and type(ref_scorer).__module__ == "dragonfly2_tpu.models.scorer"
    assert port_index == ref_index
    for pkg, served, other, index in ((PORT, port_scorer, ref_scorer, port_index),
                                      (REF, ref_scorer, port_scorer, ref_index)):
        svc = make_service(pkg, tmp_path, scorer=served, node_index=index)
        try:
            out = asyncio.run(asyncio.wait_for(run_scenario(svc, pkg), DEADLINE_S))
        finally:
            svc.close()
        records = out["decisions"]
        assert len(records) >= 20 and sum(bool(r["parents"]) for r in out["register"]) >= 20
        for rec in records:
            assert rec["chosen"] == _top(rec)
        worst = max(_rescored_gap(other, rec, index) for rec in records)
        assert worst <= SCORE_TOL, (pkg.name, worst)


def test_torch_engine_under_the_dispatcher_serves_as_it_does_serially(gnn_artifact, tmp_path, monkeypatch):
    """The torch engine has no per-thread handles: under the round dispatcher
    both workers score through the one GNNScorer (bundle.thread_scorer() is
    the primary). score() reads only the cached tables, so the dispatched
    scenario equals the serial one in every observable."""
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    scorer, index = manager_link.load_scorer(str(gnn_artifact.path), device="cpu")
    outs = {}
    for leg in ("serial", "dispatch"):
        svc = make_service(PORT, tmp_path, leg=leg, scorer=scorer, node_index=index)
        try:
            assert svc.evaluator.serving_bundle.thread_scorer() is scorer
            outs[leg] = asyncio.run(asyncio.wait_for(run_scenario(svc, PORT), DEADLINE_S))
        finally:
            svc.close()
    assert_same(outs["serial"], outs["dispatch"])


def test_gnn_scorer_calls_from_many_threads_neither_race_nor_mix(gnn_artifact, monkeypatch):
    """Eight threads (more than the host's cores under the suite's workers)
    score different rounds through one GNNScorer with a short switch
    interval: every answer is its own round's serial answer, bit for bit."""
    import sys
    import threading

    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    scorer, _index = manager_link.load_scorer(str(gnn_artifact.path), device="cpu")
    rng = np.random.default_rng(12)
    rounds = [(rng.random((40, 16), dtype=np.float32), rng.integers(0, NODES, 40, dtype=np.int32),
               rng.integers(0, NODES, 40, dtype=np.int32)) for _ in range(16)]
    want = [scorer.score(f, child=c, parent=p) for f, c, p in rounds]
    bad: list = []

    def work(k: int) -> None:
        for i in range(24):
            r = (k + i) % len(rounds)
            f, c, p = rounds[r]
            if scorer.score(f, child=c, parent=p).tobytes() != want[r].tobytes():
                bad.append((k, r))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def _top(record: dict) -> list:
    """The record's top-k by its own scores, as Scheduling._top_parents picks."""
    order = np.argsort(-np.asarray(record["scores"], np.float32), kind="stable")
    return [record["parents"][k]["peer"] for k in order[: record["topk"]]]


def _rescored_gap(scorer, record: dict, index: dict) -> float:
    """The largest gap between a record's scores and ``scorer``'s on the
    record's own rows and node rows."""
    feats = np.asarray(record["feats"], np.float32)
    child = np.full(len(feats), index[record["child_host"]], np.int32)
    parent = np.array([index[p["host"]] for p in record["parents"]], np.int32)
    return float(np.max(np.abs(np.asarray(scorer.score(feats, child=child, parent=parent)) - record["scores"])))


# ---- utils -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dag_gives_the_references_outcomes(seed):
    rng = np.random.default_rng(seed)
    graphs = (ref_dag.DAG(), port_dag.DAG())
    samplers = (random.Random(seed), random.Random(seed))
    log: list = [[], []]
    for _ in range(400):
        op = int(rng.integers(0, 9))
        a, b = f"v{int(rng.integers(0, 12))}", f"v{int(rng.integers(0, 12))}"
        for g, sampler, out in zip(graphs, samplers, log):
            fn = {
                0: lambda: g.add_vertex(a, a.upper()),
                1: lambda: g.add_edge(a, b),
                2: lambda: g.delete_edge(a, b),
                3: lambda: g.delete_vertex(a),
                4: lambda: sorted(g.lineage(a)),
                5: lambda: (g.can_add_edge(a, b), g.parent_values(a), g.child_values(a)),
                6: lambda: [v.id for v in g.random_vertices(5, sampler)],
                7: lambda: ([v.id for v in g.source_vertices()], [v.id for v in g.sink_vertices()]),
                8: lambda: (g.delete_in_edges(a), list(g.values()), len(g)),
            }[op]
            out.append(_outcome(fn))
    assert log[0] == log[1]
    assert {o[1] for o in log[0] if o[0] == "raise"} >= {"VertexNotFound", "VertexExists"}


def test_peer_and_task_machines_give_the_references_outcomes():
    from dragonfly2_tpu.scheduler import resource as ref_resource
    from dragonfly2_tpu_torch.scheduler import resource as port_resource

    rng = np.random.default_rng(3)
    for events, start in ((ref_resource._PEER_EVENTS, ref_resource.PEER_PENDING),
                          (ref_resource._TASK_EVENTS, ref_resource.TASK_PENDING)):
        port_events = port_resource._PEER_EVENTS if events is ref_resource._PEER_EVENTS else port_resource._TASK_EVENTS
        seen: list = [[], []]
        machines = []
        for mod_events, out, fsm_mod in ((events, seen[0], ref_resource), (port_events, seen[1], port_resource)):
            machines.append(fsm_mod.FSM(start, mod_events, callbacks={"*": lambda f, e, s, d, out=out: out.append((e, s, d))}))
        names = [e.name for e in events]
        for _ in range(300):
            name = names[int(rng.integers(0, len(names)))]
            for m, out in zip(machines, seen):
                out.append((m.can(name), _outcome(lambda: m.fire(name)), m.current))
        assert seen[0] == seen[1]


def test_bitset_and_piece_geometry_give_the_references_values():
    rng = np.random.default_rng(4)
    sets = (ref_bitset.Bitset(), port_bitset.Bitset())
    out: list = [[], []]
    for _ in range(300):
        i = int(rng.integers(0, 90))
        for b, o in zip(sets, out):
            o.append((b.set(i), b.test(i ^ 1), b.count(), list(b.missing_until(64))[:5]))
            if i % 7 == 0:
                b.clear(i)
    assert out[0] == out[1]
    other = [int(x) for x in rng.integers(0, 90, 20)]
    assert [list(getattr(sets[0], op)(ref_bitset.Bitset.from_indices(other)).indices())
            for op in ("difference", "union", "intersection")] == \
        [list(getattr(sets[1], op)(port_bitset.Bitset.from_indices(other)).indices())
         for op in ("difference", "union", "intersection")]
    for n in [0, 1, 5, 4 << 20, (4 << 20) + 1, 300 << 20, 5 << 30, 1 << 40] + [int(x) for x in rng.integers(0, 1 << 36, 20)]:
        size = ref_pieces.compute_piece_size(n)
        assert port_pieces.compute_piece_size(n) == size
        assert port_pieces.piece_count(n, size) == ref_pieces.piece_count(n, size)
        if n:
            k = int(rng.integers(0, ref_pieces.piece_count(n, size)))
            assert dataclasses.astuple(port_pieces.piece_range(k, size, n)) == dataclasses.astuple(
                ref_pieces.piece_range(k, size, n))
    for header in ("bytes=0-99", "bytes=100-", "bytes=-50", "bytes=5-2", "items=0-1", "bytes=0-99999"):
        for total in (1000, 10):
            got, want = (_outcome(lambda mod=mod: dataclasses.astuple(mod.parse_http_range(header, total)))
                         for mod in (port_pieces, ref_pieces))
            assert got == want, header
    for spec in ("0-99", "10-", "x", "5-1"):
        assert _outcome(lambda: dataclasses.astuple(port_pieces.parse_range_spec(spec))) == \
            _outcome(lambda: dataclasses.astuple(ref_pieces.parse_range_spec(spec)))


def test_delta_clock_and_ids_give_the_references_values():
    rng = np.random.default_rng(5)
    clocks = (ref_deltaclock.DeltaClock(tombstone_cap=8), port_deltaclock.DeltaClock(tombstone_cap=8))
    out: list = [[], []]
    for v in range(1, 400):
        key = ("k", int(rng.integers(0, 30)))
        op = int(rng.integers(0, 4))
        w = int(rng.integers(0, v))
        for c, o in zip(clocks, out):
            if op == 0:
                c.stamp(key, v)
            elif op == 1:
                c.stamp_tombstone(key, v)
            elif op == 2:
                c.prune()
            o.append((list(c.since(w)), sorted(c.dead)))
    assert out[0] == out[1]
    for url, filters in (("http://a/b?x=1&sig=2&y=3", ("sig",)), ("http://a/b", ()), ("https://h:8/p?q=1", ("q", "z"))):
        assert port_idgen.filter_query(url, filters) == ref_idgen.filter_query(url, filters)
        assert port_idgen.task_id(url, tag="t", application="a", filters=filters) == \
            ref_idgen.task_id(url, tag="t", application="a", filters=filters)
    assert port_idgen.host_id("host1", 65001) == ref_idgen.host_id("host1", 65001)
    for pid in (port_idgen.peer_id("10.0.0.1", "h", seed=True), ref_idgen.peer_id("10.0.0.1", "h"), "x_seed"):
        assert port_idgen.is_seed_peer_id(pid) == ref_idgen.is_seed_peer_id(pid)


# ---- telemetry and topology -----------------------------------------------


def test_bandwidth_history_gives_the_references_values(tmp_path):
    from dragonfly2_tpu.telemetry import TelemetryStorage as RefStorage

    rng = np.random.default_rng(6)
    hists = (ref_bandwidth.BandwidthHistory(), port_bandwidth.BandwidthHistory())
    out: list = [[], []]
    for _ in range(300):
        p, c = f"h{int(rng.integers(0, 12))}", f"h{int(rng.integers(0, 12))}"
        bps = float(rng.uniform(1e6, 3e9))
        op = int(rng.integers(0, 10))
        for h, o in zip(hists, out):
            if op < 7:
                h.observe(p, c, bps)
            elif op == 7:
                h.forget_host(p)
            o.append((h.query(p, c), h.normalized(p, c), h.parent_version(p), h.version, len(h)))
    assert out[0] == out[1]
    wm, entries = hists[0].local_entries_since(50)
    assert hists[1].local_entries_since(50) == (wm, entries) and entries
    remote = [dict(e, parent=e["parent"] + "r") for e in entries]
    for h in hists:
        assert h.merge_remote(remote, origin="peer") > 0
    live = next(e for e in remote if not e.get("deleted"))
    merged = [(h.remote_entry_count(), h.query(live["parent"], live["child"]),
               h.purge_remote_origin("peer"), h.remote_entry_count()) for h in hists]
    assert merged[0] == merged[1] and merged[0][0] > 0 and merged[0][1] is not None
    store = RefStorage(tmp_path / "t")
    for i in range(40):
        store.downloads.append(parent_host_id=f"h{i % 5}".encode(), child_host_id=f"h{i % 7}".encode(),
                               bandwidth_bps=float(1e7 * (i + 1)), success=bool(i % 4))
    store.flush()
    warm = (ref_bandwidth.BandwidthHistory(), port_bandwidth.BandwidthHistory())
    assert warm[0].load_from(store) == warm[1].load_from(store) > 0
    assert [w.query("h1", "h1") for w in warm][0] == [w.query("h1", "h1") for w in warm][1]


def test_network_topology_gives_the_references_values():
    from dragonfly2_tpu.scheduler import resource as ref_resource
    from dragonfly2_tpu_torch.scheduler import resource as port_resource

    rng = np.random.default_rng(7)
    pools = (ref_resource.ResourcePool(), port_resource.ResourcePool())
    for pool in pools:
        for i in range(300):
            pool.load_or_create_host(f"h{i}", f"10.0.{i // 256}.{i % 256}", f"n{i}", download_port=8000 if i % 9 else 0)
    topos = (
        ref_topology.NetworkTopology(rng=random.Random(1), clock=ref_clock.VirtualClock()),
        port_topology.NetworkTopology(rng=random.Random(1), clock=port_clock.VirtualClock()),
    )
    out: list = [[], []]
    for step in range(120):
        src = f"h{int(rng.integers(0, 300))}"
        results = [{"dst_host_id": f"h{int(j)}", "rtt_ms": float(rng.uniform(0.1, 90)),
                    "success": bool(rng.random() > 0.2)} for j in rng.integers(0, 300, 4)]
        forget = f"h{int(rng.integers(0, 300))}" if step % 17 == 0 else None
        for topo, pool, o in zip(topos, pools, out):
            topo.clock.advance(0.5)
            targets = topo.sync_probes(src, results, pool.hosts, host_list=pool.host_values())
            if forget:
                topo.forget_host(forget)
            o.append(([dataclasses.astuple(t) for t in targets], topo.version, topo.edge_count(),
                      topo.avg_rtt_ms(src, results[0]["dst_host_id"]), topo.pair_version(src, results[0]["dst_host_id"])))
    assert out[0] == out[1]
    wm, edges = topos[0].local_edges_since(30)
    assert topos[1].local_edges_since(30) == (wm, edges) and edges
    remote = [dict(e, src=e["src"] + "r") for e in edges]
    assert topos[0].merge_remote(remote, origin="o") == topos[1].merge_remote(remote, origin="o") > 0
    assert topos[0].remote_edge_count() == topos[1].remote_edge_count()


# ---- config ----------------------------------------------------------------

_YAML = """
host: 0.0.0.0
port: 9100
evaluator: ml
telemetry_dir: /var/lib/df/telemetry
trainer: 10.0.0.9:9090
trainer_interval: 3600
scheduling:
  candidate_parent_limit: 6
  filter_parent_limit: 64
  dispatch_workers: 2
  retry_interval: 0.2
rollout:
  shadow_sample_rate: 0.25
  max_latency_ratio: 3
gc:
  peer_ttl: 120
  interval: 5
degradation:
  lag_budget_ms: 100
tracing:
  sample_rate: 0.5
"""

_BAD = [
    "port: 70000\n",
    "evaluator: gnn\n",
    "scheduling:\n  candidate_parent_limit: 0\n",
    "nope: 1\n",
    "gc:\n  peer_ttl: soon\n",
    "tracing:\n  sample_rate: 2\n",
    "scheduling: 5\n",
    "- a\n- b\n",
]


def test_scheduler_yaml_gives_the_references_values(tmp_path):
    path = tmp_path / "s.yaml"
    path.write_text(_YAML)
    ref = ref_cfgmod.load_config(ref_config.SchedulerYaml, str(path))
    port = port_cfgmod.load_config(port_config.SchedulerYaml, str(path))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.scheduling_config()) == dataclasses.asdict(ref.scheduling_config())
    assert dataclasses.asdict(port.gc_policy()) == dataclasses.asdict(ref.gc_policy())
    assert dataclasses.asdict(port.rollout.health_gates()) == dataclasses.asdict(ref.rollout.health_gates())
    assert port.degradation.controller_kwargs() == ref.degradation.controller_kwargs()
    assert dataclasses.asdict(port_cfgmod.load_config(port_config.SchedulerYaml, None)) == \
        dataclasses.asdict(ref_cfgmod.load_config(ref_config.SchedulerYaml, None))
    for i, text in enumerate(_BAD):
        bad = tmp_path / f"bad{i}.yaml"
        bad.write_text(text)
        errs = []
        for mod, cfg in ((ref_cfgmod, ref_config), (port_cfgmod, port_config)):
            with pytest.raises(mod.ConfigError) as e:
                mod.load_config(cfg.SchedulerYaml, str(bad))
            errs.append((e.value.path, str(e.value)))
        assert errs[0] == errs[1], text


# ---- metric families ---------------------------------------------------------


def test_scheduler_metric_families_are_the_references():
    """The port declares every family of the reference (the ManagerLink's
    swap, rollout and outage families and the federation loop's came with
    the port's link), each with the reference's name, kind, labels and
    buckets (and help, but ML_SERVING_MODE's, which names the port's torch
    label); ServiceMetrics' twins too."""
    from dragonfly2_tpu.scheduler import metrics as ref_metrics
    from dragonfly2_tpu_torch.scheduler import metrics as port_metrics

    names = [k for k in dir(port_metrics) if k.isupper()]
    assert len(names) == 39 and names == [k for k in dir(ref_metrics) if k.isupper()]
    for name in names:
        port, ref = getattr(port_metrics, name), getattr(ref_metrics, name)
        assert (port.name, port.kind, port.label_names, getattr(port, "buckets", None)) == \
            (ref.name, ref.kind, ref.label_names, getattr(ref, "buckets", None)), name
        assert port.help == ref.help or name == "ML_SERVING_MODE", name
    port_local, ref_local = port_metrics.ServiceMetrics(), ref_metrics.ServiceMetrics()
    for twin in ("schedule_duration", "base_fallback"):
        a, b = getattr(port_local, twin), getattr(ref_local, twin)
        assert (a.name, a.kind, a.label_names, a.help) == (b.name, b.kind, b.label_names, b.help)


# ---- the brownout ladder and head sampling ---------------------------------


def test_degradation_ladder_follows_the_references_rungs():
    rng = np.random.default_rng(8)
    # a pressure series: quiet, a sustained climb through every rung, a
    # spike, a slow recovery, with dead probes (None) sprinkled in
    segments = ((40, 50, 0.3, 10), (160, 900, 1.1, 100), (30, 400, 0.9, 60), (600, 40, 0.3, 10))
    lag = list(np.concatenate([rng.uniform(0, hi, n) for n, hi, _u, _q in segments]))
    util = list(np.concatenate([rng.uniform(0, hi, n) for n, _l, hi, _q in segments]))
    queue = [None if i % 11 == 0 else float(q) for i, q in enumerate(
        np.concatenate([rng.uniform(0, hi, n) for n, _l, _u, hi in segments]))]
    runs = []
    for mod, clock_mod in ((ref_degradation, ref_clock), (port_degradation, port_clock)):
        clock = clock_mod.VirtualClock()
        i = [0]
        ctl = mod.DegradationController(
            lag_p95_ms=lambda: lag[i[0]], utilization=lambda: util[i[0]], queue_depth=lambda: queue[i[0]],
            clock=clock,
        )
        seen = []
        for step in range(len(lag)):
            i[0] = step
            clock.advance(0.5)
            level = ctl.evaluate_once()
            admits = [ctl.admit(p) for p in (0.5, 1.0, 2.0)]
            seen.append((level, ctl.last_pressure, ctl.shed_shadow, ctl.shed_obs, ctl.base_only,
                         ctl.admission_control, admits))
        runs.append((seen, ctl.stats()))
    assert runs[0] == runs[1]
    assert max(s[0] for s in runs[0][0]) == 4 and runs[0][0][-1][0] == 0


def test_head_sampling_draws_as_the_reference():
    decisions = []
    for mod in (ref_tracing, port_tracing):
        tracer = mod.Tracer(sample_rate=0.3, rng=random.Random(9).random)
        row = []
        for _ in range(200):
            with tracer.span("root") as root:
                with tracer.span("child") as child:
                    row.append((root.sampled, child.sampled, child.trace_id == root.trace_id))
        decisions.append((row, len(tracer.finished())))
    assert decisions[0] == decisions[1]
    assert 20 < sum(r[0] for r in decisions[0][0]) < 100
    assert port_tracing.DEFAULT_SERVICE_SAMPLE_RATE == ref_tracing.DEFAULT_SERVICE_SAMPLE_RATE
    assert [f.name for f in dataclasses.fields(port_tracing.TracingSection)] == \
        [f.name for f in dataclasses.fields(ref_tracing.TracingSection)]
