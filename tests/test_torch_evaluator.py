"""The port's evaluator (``dragonfly2_tpu_torch.scheduler.evaluator``)
against the reference's, on a reference resource pool.

One pool of 40 peers over 2 tasks, with a reference ``NetworkTopology`` and
``BandwidthHistory`` attached, feeds both packages' feature builds: the
cached build and the rowwise one are bit-equal to the reference's, cold and
warm, and again after a probe and a bandwidth observation bump one edge.
The base scores are bit-equal; ``is_bad_node`` gives the reference's
verdicts on its small-sample and 3-sigma cases; the shadow divergence
reports (``round_divergence``, the ``ShadowTracker`` snapshot) are equal
for one pair of native scorers, and so are the decision records, the
brownout rungs' outcomes and the native driver's gate; ``DriftDetector``
gives the reference's PSI
and class on one seeded stream; and a reference ``MLEvaluator`` and the
port's, serving one model in one process, share the peers' row caches and
still agree. Last, the plugin spec loads the port's evaluator through the
reference's ``new_evaluator``, in base-fallback mode.
"""

import asyncio
import types

import numpy as np
import pytest
import torch

from dragonfly2_tpu.observability import sketches as ref_sketches
from dragonfly2_tpu.scheduler import evaluator as ref_ev
from dragonfly2_tpu.scheduler import metrics as ref_metrics
from dragonfly2_tpu.scheduler import rollout as ref_rollout
from dragonfly2_tpu.scheduler import resource as res
from dragonfly2_tpu.scheduler.networktopology import NetworkTopology
from dragonfly2_tpu.telemetry import BandwidthHistory
from dragonfly2_tpu.utils import clock as ref_clock
from dragonfly2_tpu.utils import idgen
from dragonfly2_tpu_torch.cli.dfstress import build_scoring_artifact
from dragonfly2_tpu_torch.native import MicroBatchScorer
from dragonfly2_tpu_torch.observability import sketches
from dragonfly2_tpu_torch.scheduler import evaluator as port_ev
from dragonfly2_tpu_torch.scheduler import manager_link
from dragonfly2_tpu_torch.scheduler import metrics as port_metrics
from dragonfly2_tpu_torch.scheduler import rollout
from dragonfly2_tpu_torch.utils import clock as port_clock
from dragonfly2_tpu_torch.utils.plugins import PluginError

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

SPEC = "plugin:dragonfly2_tpu_torch.scheduler.evaluator:MLEvaluator"
HOSTS, PEERS_PER_TASK, NODES = 24, 20, 32


def _pool(seed: int = 0):
    """40 running peers over 2 tasks on 24 hosts h0..h23: seed and normal
    hosts, three idcs, nested locations, varied upload slots and counters,
    piece progress and costs, parent edges; a topology with probes and a
    bandwidth history with observations over their pairs."""
    rng = np.random.default_rng(seed)
    pool = res.ResourcePool()
    hosts = []
    for i in range(HOSTS):
        h = pool.load_or_create_host(
            f"h{i}", f"10.0.{i // 256}.{i % 256}", f"host{i}", download_port=8000 + i,
            host_type=res.HostType.SEED if i % 7 == 0 else res.HostType.NORMAL,
            idc=f"idc{i % 3}" if i % 5 else "", location=f"cn|r{i % 2}|z{i % 4}", upload_limit=int(rng.integers(4, 60)),
        )
        h.concurrent_uploads = int(rng.integers(0, 4))
        h.upload_count, h.upload_failed_count = int(rng.integers(0, 50)), int(rng.integers(0, 5))
        hosts.append(h)
    tasks = []
    for t in range(2):
        task = pool.load_or_create_task(f"task{t}", f"http://origin/f{t}")
        task.set_metadata((64 + 32 * t) << 20)
        peers = []
        for j in range(PEERS_PER_TASK):
            host = hosts[(j * 5 + t * 3) % HOSTS]
            peer = pool.create_peer(idgen.peer_id(host.ip, f"{host.hostname}-{t}-{j}"), task, host)
            peer.fsm.fire("register")
            peer.fsm.fire("download")
            for k in range(int(rng.integers(0, task.total_pieces or 1))):
                peer.finished_pieces.set(k)
            for c in rng.uniform(5, 80, int(rng.integers(0, 6))):
                peer.add_piece_cost(float(c))
            peer.schedule_rounds = int(rng.integers(0, 14))
            peers.append(peer)
        for j in range(2, PEERS_PER_TASK, 3):
            task.add_edge(peers[j - 1].id, peers[j].id)
        tasks.append((task, peers))
    topo, bw = NetworkTopology(), BandwidthHistory()
    for _ in range(120):
        a, b = rng.integers(0, HOSTS, 2)
        if a != b:
            topo.enqueue(f"h{a}", f"h{b}", float(rng.uniform(0.5, 1500.0)))
            bw.observe(f"h{a}", f"h{b}", float(rng.uniform(1e6, 2e9)))
    return pool, tasks, topo, bw


def _cold(peers) -> None:
    """Drop every peer's cached rows (both packages' evaluators share them)."""
    for p in peers:
        p._feat_row = ((-1, -1), None)
        p._pair_rows = {}


def _all_peers(tasks):
    return [p for _, peers in tasks for p in peers]


def _builds(fn_port, fn_ref, tasks, topo, bw):
    """Each task's round (peer 0 as the child, the rest as parents) through
    the port's builder and the reference's, each from cold caches, then
    both again on the caches they left warm."""
    peers = _all_peers(tasks)
    out = []
    for _task, ps in tasks:
        child, parents = ps[0], ps[1:]
        _cold(peers)
        port = fn_port(child, parents, topo, bw)
        _cold(peers)
        ref = fn_ref(child, parents, topo, bw)
        warm_port, warm_ref = fn_port(child, parents, topo, bw), fn_ref(child, parents, topo, bw)
        out.append((port, ref, warm_port, warm_ref))
    return out


@pytest.mark.parametrize("builder", ["build_pair_features", "_build_pair_features_rowwise"])
def test_feature_build_is_the_references_bit_for_bit(builder):
    pool, tasks, topo, bw = _pool()
    fn_port, fn_ref = getattr(port_ev, builder), getattr(ref_ev, builder)

    def check():
        for port, ref, warm_port, warm_ref in _builds(fn_port, fn_ref, tasks, topo, bw):
            assert port.dtype == ref.dtype == np.float32 and port.shape == ref.shape == (PEERS_PER_TASK - 1, 16)
            for got in (port, warm_port, warm_ref):
                assert got.tobytes() == ref.tobytes()

    check()
    # the seed-host, idc, location, rtt and bandwidth columns are live
    f = np.concatenate([fn_port(ps[0], ps[1:], topo, bw) for _task, ps in tasks])
    assert all(f[:, col].any() for col in (3, 4, 5, 6, 8))
    # one probe and one bandwidth observation bump one edge of the first
    # round; warm rows cached before the bump must not survive it
    child, parent = tasks[0][1][0], tasks[0][1][3]
    before = fn_port(child, tasks[0][1][1:], topo, bw)
    topo.enqueue(child.host.id, parent.host.id, 3.0)
    bw.observe(parent.host.id, child.host.id, 7.5e8)
    after = fn_port(child, tasks[0][1][1:], topo, bw)
    assert not np.array_equal(before[2], after[2])
    check()


def test_base_scores_are_bit_equal():
    pool, tasks, topo, bw = _pool(1)
    port, ref = port_ev.Evaluator(), ref_ev.Evaluator()
    for e in (port, ref):
        e.topology, e.bandwidth = topo, bw
    peers = _all_peers(tasks)
    for _task, ps in tasks:
        _cold(peers)
        got = port.evaluate(ps[0], ps[1:])
        _cold(peers)
        want = ref.evaluate(ps[0], ps[1:])
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert [a.tobytes() for a in port.evaluate_many([(ps[0], ps[1:])])] == [want.tobytes()]
        assert asyncio.run(port.evaluate_async(ps[0], ps[1:])).tobytes() == want.tobytes()
    assert port.evaluate(tasks[0][1][0], []).shape == (0,)


def _fake_peer(costs, state="running"):
    return types.SimpleNamespace(fsm=types.SimpleNamespace(current=state), _bad_memo=(-1, False),
                                 feat_version=0, piece_costs_ms=list(costs))


def test_is_bad_node_gives_the_references_verdicts():
    pool = res.ResourcePool()
    task = pool.load_or_create_task("t1", "http://origin/f")
    task.set_metadata(100 << 20)
    host = pool.load_or_create_host("h0", "10.0.0.1", "host0")
    rng = np.random.default_rng(0)
    verdicts = []

    def both(peer) -> bool:
        peer._bad_memo = (-1, False)
        want = ref_ev.Evaluator().is_bad_node(peer)
        peer._bad_memo = (-1, False)
        got = port_ev.Evaluator().is_bad_node(peer)
        assert got == want
        verdicts.append(want)
        return got

    # the reference's small-sample cases (tests/test_scheduler.py)
    peer = pool.create_peer("p1", task, host)
    peer.fsm.fire("register")
    peer.fsm.fire("download")
    both(peer)  # no samples
    for _ in range(5):
        peer.add_piece_cost(10.0)
    both(peer)
    peer.add_piece_cost(500.0)  # > 20x the mean of the rest
    both(peer)
    sigma = pool.create_peer("p2", task, host)
    sigma.fsm.fire("register")
    sigma.fsm.fire("download")
    for c in rng.normal(100, 5, size=40):
        sigma.add_piece_cost(float(c))
    both(sigma)
    # the 3-sigma rule needs 30 samples; a Peer keeps 20, so a duck-typed one
    costs = list(rng.normal(100, 5, size=40))
    both(_fake_peer(costs))
    both(_fake_peer(costs[:-1] + [100 + 2.9 * float(np.std(costs[:-1]))]))
    both(_fake_peer(costs[:-1] + [180.0]))
    both(_fake_peer(costs, state="failed"))
    assert verdicts == [False, False, True, False, False, False, True, True]


@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    """Two native scorers over one 32-host graph (hosts h0..h31), from two
    seeds: the serving model and a shadow candidate."""
    out = []
    for seed in (7, 8):
        art = build_scoring_artifact(tmp_path_factory.mktemp(f"ev{seed}") / "a", n_nodes=NODES, seed=seed,
                                     device="cpu")
        scorer, idx = manager_link.load_scorer(str(art.path), device="cpu")
        assert scorer.engine == "native"
        out.append((scorer, idx))
    yield out
    for scorer, _ in out:
        scorer.close()


def test_shadow_divergence_reports_are_the_references(scorers):
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 40):
        s, c = rng.random(n), rng.random(n)
        for cand in (c, s.copy(), np.full(n, 0.5)):
            assert rollout.round_divergence(s, cand, topk=4) == ref_rollout.round_divergence(s, cand, topk=4)
    (serving, idx), (cand, cidx) = scorers
    pool, tasks, topo, bw = _pool(2)
    snaps = []
    for mod in (port_ev, ref_ev):
        ev = mod.MLEvaluator()
        ev.topology, ev.bandwidth = topo, bw
        ev.attach_scorer(serving, idx, version="v1")
        tracker, prev = ev.attach_candidate(cand, cidx, version="v2", sample_rate=0.5)
        assert prev is None and ev.candidate_version == "v2" and ev.candidate_tracker is tracker
        for r in range(24):
            _task, ps = tasks[r % 2]
            child = ps[r % len(ps)]
            ev.evaluate(child, [p for p in ps if p is not child])
        ev.evaluate_many([(ps[0], ps[1:]) for _task, ps in tasks] * 3)
        snaps.append(tracker.snapshot())
        assert ev.detach_candidate().version == "v2" and ev.candidate_tracker is None
    assert snaps[0] == snaps[1] and snaps[0]["rounds"] > 0 and snaps[0]["slices"]


def _fallbacks(metrics_mod) -> dict:
    return {r: float(metrics_mod.ML_BASE_FALLBACK_TOTAL.labels(reason=r).value)
            for r in ("no_scorer", "unknown_hosts", "scorer_error", "degraded")}


def test_decisions_brownout_and_native_entry_as_the_reference(scorers):
    """The sampled decision records, the brownout rungs (shed records and
    shadow, then serve base) and the native round driver's gate, on both
    evaluators over the same rounds: the same records, scores, fallbacks
    and gate answers."""
    (serving, idx), (cand, cidx) = scorers
    pool, tasks, topo, bw = _pool(4)
    out = []
    for mod, clock_mod, metrics_mod in ((port_ev, port_clock, port_metrics), (ref_ev, ref_clock, ref_metrics)):
        ev = mod.MLEvaluator()
        ev.topology, ev.bandwidth = topo, bw
        ev.decisions = mod.DecisionRecorder(sample_rate=0.5, capacity=8, topk=4, clock=clock_mod.VirtualClock())
        before = _fallbacks(metrics_mod)
        gate = [ev.native_round_entry()]
        cold = [ev.evaluate(ps[0], ps[1:]).tobytes() for _task, ps in tasks]  # no model: base, no_scorer
        ev.attach_scorer(serving, idx, version="v1")
        tracker, _ = ev.attach_candidate(cand, cidx, version="v2")
        gate.append(ev.native_round_entry() is ev.serving_bundle)
        served = [ev.evaluate(ps[0], ps[1:]).tobytes() for _ in range(3) for _task, ps in tasks]
        # the native round driver's tail: drift, records and one batched shadow pass
        ev.finish_native_rounds([(ps[0], ps[1:], np.zeros((len(ps) - 1, 16), np.float32),
                                  np.zeros(len(ps) - 1, np.float32)) for _task, ps in tasks], ev.serving_bundle)
        ev.degradation = types.SimpleNamespace(base_only=False, shed_obs=True, shed_shadow=True)
        shed = [ev.evaluate(ps[0], ps[1:]).tobytes() for _task, ps in tasks]
        ev.degradation.base_only = True
        gate.append(ev.native_round_entry())
        base = [ev.evaluate(ps[0], ps[1:]).tobytes() for _task, ps in tasks]
        base += [a.tobytes() for a in ev.evaluate_many([(ps[0], ps[1:]) for _task, ps in tasks])]
        base += [asyncio.run(ev.evaluate_async(ps[0], ps[1:])).tobytes() for _task, ps in tasks]
        after = _fallbacks(metrics_mod)
        out.append((gate, cold, served, shed, base, {r: after[r] - before[r] for r in after},
                    ev.decisions.snapshot(limit=8), ev.decisions.stats(), tracker.snapshot()))
    assert out[0] == out[1]
    gate, cold, served, shed, base, fell, records, stats, shadow = out[0]
    assert gate == [None, True, None] and served[:2] != cold and base == cold * 3 and shed == served[:2]
    assert fell == {"no_scorer": 2.0, "unknown_hosts": 0.0, "scorer_error": 0.0, "degraded": 6.0}
    assert stats["rounds_seen"] == 10 and records and {r["serving_mode"] for r in records} >= {"native"}
    assert shadow["rounds"] == 8  # the shed rounds added none


def test_drift_detector_gives_the_references_psi_and_class():
    rng = np.random.default_rng(11)
    train = rng.random((4000, 16), dtype=np.float32)
    refs = []
    for mod in (sketches, ref_sketches):
        sk = mod.FeatureSketch(16)
        sk.update(train)
        refs.append(sk)
    port = sketches.DriftDetector(sample_stride=2, compute_every=3, live_cap=5000, export=False)
    ref = ref_sketches.DriftDetector(sample_stride=2, compute_every=3, live_cap=5000, export=False)
    port.set_reference(refs[0], version="v1")
    ref.set_reference(refs[1], version="v1")
    for i in range(300):
        # a stream whose first columns drift away from the training range
        f = rng.random((40, 16), dtype=np.float32)
        f[:, :4] = f[:, :4] * 0.5 + min(1.0, i / 150)
        port.observe(f)
        ref.observe(f)
    got, want = port.compute(), ref.compute()
    assert got == want and max(want.values()) > ref_sketches.PSI_MAJOR
    assert [sketches.classify_psi(v) for v in got.values()] == [ref_sketches.classify_psi(v) for v in want.values()]
    assert {sketches.classify_psi(v) for v in (0.05, 0.2, 0.3, float("nan"))} == {
        "stable", "moderate", "major", "invalid"}
    drop = ("computed_at",)
    assert ({k: v for k, v in port.snapshot().items() if k not in drop}
            == {k: v for k, v in ref.snapshot().items() if k not in drop})


def test_a_reference_and_a_port_evaluator_share_the_row_caches(scorers):
    (serving, idx), _ = scorers
    pool, tasks, topo, bw = _pool(3)
    evs = [port_ev.MLEvaluator(), ref_ev.MLEvaluator()]
    for ev in evs:
        ev.topology, ev.bandwidth = topo, bw
        ev.attach_scorer(serving, idx, version="v1")
    rng = np.random.default_rng(4)
    for r in range(30):
        _task, ps = tasks[r % 2]
        child = ps[int(rng.integers(0, len(ps)))]
        parents = [p for p in ps if p is not child]
        first, second = (evs[0], evs[1]) if r % 2 else (evs[1], evs[0])
        a, b = first.evaluate(child, parents), second.evaluate(child, parents)
        assert a.tobytes() == b.tobytes()
        if r % 5 == 4:  # the pool moves under both: a cost sample, a probe
            parents[0].add_piece_cost(float(rng.uniform(5, 90)))
            topo.enqueue(child.host.id, parents[1].host.id, float(rng.uniform(1, 90)))
    # the shared caches hold what a cold build of either package gives
    _task, ps = tasks[0]
    warm = port_ev.build_pair_features(ps[0], ps[1:], topo, bw)
    _cold(_all_peers(tasks))
    assert ref_ev.build_pair_features(ps[0], ps[1:], topo, bw).tobytes() == warm.tobytes()


def _gauges() -> tuple:
    """ML_SERVING_MODE as (native, torch, jax, base)."""
    return tuple(float(port_metrics.ML_SERVING_MODE.labels(mode=m).value) for m in port_ev.SERVING_MODES)


def test_the_plugin_spec_loads_the_port_evaluator_through_the_references_slot(scorers, caplog):
    import logging

    (serving, idx), _ = scorers
    with caplog.at_level(logging.INFO, logger=port_ev.__name__):
        ev = ref_ev.new_evaluator(SPEC)
    assert type(ev) is port_ev.MLEvaluator and ev.serving_bundle is None and ev.serving_version == ""
    assert _gauges() == (0.0, 0.0, 0.0, 1.0)
    (rec,) = [r for r in caplog.records if r.name == port_ev.__name__]
    assert rec.levelname == "WARNING" and rec.getMessage().startswith("ml evaluator serving mode: base")
    assert type(port_ev.new_evaluator(SPEC)) is port_ev.MLEvaluator
    assert type(port_ev.new_evaluator("ml")) is port_ev.MLEvaluator
    assert type(port_ev.new_evaluator("bogus")) is port_ev.Evaluator
    assert type(port_ev.new_evaluator("plugin:dragonfly2_tpu_torch.scheduler.evaluator:Evaluator")) is port_ev.Evaluator
    with pytest.raises(PluginError, match="no attribute 'Nope'"):
        port_ev.new_evaluator("plugin:dragonfly2_tpu_torch.scheduler.evaluator:Nope")

    class _Labelled:  # labels itself as a GNNScorer of either package does
        ready = True

        def __init__(self, engine):
            self.engine = engine

        def score(self, feats, *, child, parent):
            return serving.score(feats, child=child, parent=parent)

    # the port's engines log at info level; the reference's JAX engine (what
    # a reference scheduler's own loader hands over when the native scorer
    # is not active) and an engine no label names log warnings
    for scorer, want, level in ((serving, (1.0, 0.0, 0.0, 0.0), "INFO"),
                                (_Labelled("jax"), (0.0, 0.0, 1.0, 0.0), "WARNING"),
                                (_Labelled("other"), (0.0, 0.0, 0.0, 0.0), "WARNING"),
                                (_Labelled("torch"), (0.0, 1.0, 0.0, 0.0), "INFO")):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=port_ev.__name__):
            ev.attach_scorer(scorer, idx, microbatch=MicroBatchScorer(scorer), version=scorer.engine)
        assert _gauges() == want and ev.serving_version == scorer.engine
        (rec,) = [r for r in caplog.records if r.name == port_ev.__name__]
        assert rec.levelname == level and rec.getMessage().startswith(f"ml evaluator serving mode: {scorer.engine}")
    assert port_ev.MLEvaluator._mode_of(serving) == "native"
    old = ev.swap_bundle(None)
    assert old.version == "torch" and _gauges() == (0.0, 0.0, 0.0, 1.0) and ev.embeddings_age_s() is not None
