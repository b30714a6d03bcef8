"""The multi-step train call as a CUDA graph, on a card.

On one CUDA device ``train_gnn.make_multi_step`` runs its first call
eagerly, captures the second into a CUDA graph and replays it from then on.
These tests hold the graphed calls to a loop of eager ``make_train_step``
calls over the same seed's rows, at ``topo-h256-16k``'s widths (the
serving model: hidden 256, 16384 hosts, 16 probed peers) and batch 4096.

A replay runs the eager step's kernels on the same numbers, so the two part
only where two eager runs part: the head's ``index_select`` of the
embeddings sums its gradient with atomic adds, whose order changes from run
to run (at these widths a parameter element now and then; at the train
cell's batch of 16384, every step's loss). So they are held to the
benchmark's limits for the train cell (``benchmark/checks/train-h512-16k.json``),
the measure ``benchmark/compare.py``'s, and each comparison prints whether
the losses and norms came out bit-equal. Every test is marked ``cuda`` and skips with a
reason on a host without a card; the file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph_cuda.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.drivers.train import _observe_first_call
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

LIMITS = {k: v["limit"] for k, v in json.loads(
    (pathlib.Path(__file__).resolve().parents[1] / "benchmark/checks/train-h512-16k.json").read_text())["limits"].items()}
CFG = train_gnn.GNNTrainConfig(hidden=256, embed_dim=128, num_layers=3, batch_size=4096, warmup_steps=5)
HOSTS, PEERS, PAIRS = 16384, 16, 65536
CALLS, PER_CALL, SEED, BATCH_SEED = 3, 10, 3, 2**40 + 7


class CountingGraph(torch.cuda.CUDAGraph):
    """A CUDAGraph that counts its captures and replays in ``counts``."""

    counts = {"captures": 0, "replays": 0}

    def capture_begin(self, *args, **kwargs):
        type(self).counts["captures"] += 1
        return super().capture_begin(*args, **kwargs)

    def replay(self):
        type(self).counts["replays"] += 1
        return super().replay()


def _graphed_multi(monkeypatch, state, cluster, **kw):
    """make_multi_step with the graphs it makes counted and its batch
    generator recorded in ``made``."""
    made, real = [], torch.Generator

    def recording(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    CountingGraph.counts = {"captures": 0, "replays": 0}
    monkeypatch.setattr(torch.cuda, "CUDAGraph", CountingGraph)
    with monkeypatch.context() as m:
        m.setattr(torch, "Generator", recording)
        multi = train_gnn.make_multi_step(state, cluster.graph, cluster.pairs, with_metrics=True, **kw)
    assert len(made) == 1
    return multi, made[0]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph and the K3/K4 kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cluster(card):
    return synthetic.make_cluster(num_nodes=HOSTS, num_neighbors=PEERS, num_pairs=PAIRS, seed=SEED)


def _eager(card, cluster, cfg, calls, per_call):
    """The loop of make_train_step over the seed's rows, drawn as the
    multi-step draws them: each step's loss and norm, the parameters at the
    start and after each call, the rows of each step and the generator's
    state after every call."""
    state = train_gnn.init_state(cfg, rng_seed=SEED, device=card)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    g = cluster.graph.to(card)
    pool = train_gnn._as_batch(*(torch.as_tensor(a).to(card) for a in cluster.pairs))
    gen = torch.Generator(device=card).manual_seed(BATCH_SEED)
    step = train_gnn.make_train_step(cfg.remat, with_metrics=True)
    out = {"losses": [], "norms": [], "params": [], "rows": [], "gen": [], "start": start}
    for _ in range(calls):
        for _ in range(per_call):
            idx = torch.randint(0, len(pool.child), (cfg.batch_size,), generator=gen, device=card)
            out["rows"].append(idx.cpu())
            state, (loss, gnorm) = step(state, g, synthetic.PairBatch(*(a.index_select(0, idx) for a in pool)))
            out["losses"].append(float(loss))
            out["norms"].append(float(gnorm))
        out["params"].append({n: p.detach().clone() for n, p in state.model.named_parameters()})
        out["gen"].append(gen.get_state())
    return out


def _graphed(card, cluster, cfg, calls, per_call):
    """``calls`` calls of make_multi_step: the eager first, the capture,
    then replays; each call's pulled losses and norms (and the tensors
    returned), parameters and generator state, and the graphs' counts
    after each call."""
    with pytest.MonkeyPatch.context() as mp:
        state = train_gnn.init_state(cfg, rng_seed=SEED, device=card)
        multi, gen = _graphed_multi(mp, state, cluster, batch_size=cfg.batch_size, steps_per_call=per_call,
                                    remat=cfg.remat, seed=BATCH_SEED)
        out = {"losses": [], "norms": [], "params": [], "gen": [], "counts": [], "held": []}
        for _ in range(calls):
            state, (losses, norms) = multi(state)
            out["held"].append((losses, norms))
            out["losses"] += losses.tolist()
            out["norms"] += norms.tolist()
            out["params"].append({n: p.detach().clone() for n, p in state.model.named_parameters()})
            out["gen"].append(gen.get_state())
            out["counts"].append(dict(CountingGraph.counts))
        out["step"] = state.step
    return out


@pytest.fixture(scope="module")
def eager(card, cluster):
    return _eager(card, cluster, CFG, CALLS, PER_CALL)


@pytest.fixture(scope="module")
def graphed(card, cluster):
    return _graphed(card, cluster, CFG, CALLS, PER_CALL)


def _gaps(graphed, eager, call, per_call=PER_CALL):
    """The benchmark's readings of call ``call`` (0-based) against the eager
    loop: the widest relative loss gap of its steps, the same of the
    gradient norms, and each leaf's change since the start."""
    s = slice(call * per_call, (call + 1) * per_call)
    start = eager["start"]
    change = {n: graphed["params"][call][n] - start[n] for n in start}
    want = {n: eager["params"][call][n] - start[n] for n in start}
    unequal = sum(int((graphed["params"][call][n] != eager["params"][call][n]).sum()) for n in start)
    print(f"call {call}: losses bit-equal {graphed['losses'][s] == eager['losses'][s]}, norms bit-equal "
          f"{graphed['norms'][s] == eager['norms'][s]}, parameters unequal at {unequal} of "
          f"{sum(t.numel() for t in start.values())} elements")
    return {"loss_gap": compare.loss_gap(graphed["losses"][s], eager["losses"][s]),
            "norm_gap": compare.loss_gap(graphed["norms"][s], eager["norms"][s]),
            "change_gap": compare.worst_leaf_gap(change, want)}


def _within_limits(gaps):
    print(gaps)
    assert all(np.isfinite(v) for v in gaps.values())
    assert gaps["loss_gap"] <= LIMITS["loss_gap"]
    assert gaps["norm_gap"] <= LIMITS["grad_gap"]
    assert gaps["change_gap"] <= LIMITS["change_gap"]


@pytest.mark.parametrize("call", range(CALLS), ids=["eager", "capture", "replay"])
def test_each_graphed_call_equals_the_eager_steps(graphed, eager, call):
    _within_limits(_gaps(graphed, eager, call))
    assert graphed["step"] == CALLS * PER_CALL


def test_the_call_is_captured_once_and_replayed_after(graphed):
    assert graphed["counts"] == [{"captures": 0, "replays": 0}, {"captures": 1, "replays": 1},
                                 {"captures": 1, "replays": 2}]
    # each call's values are its own: a replay writes none of an earlier call's
    held = [torch.cat(pair).tolist() for pair in graphed["held"]]
    assert held == [graphed["losses"][i * PER_CALL:(i + 1) * PER_CALL] + graphed["norms"][i * PER_CALL:(i + 1) * PER_CALL]
                    for i in range(CALLS)]


def test_a_replayed_call_draws_the_rows_the_eager_steps_draw(graphed, eager, card):
    # the generator stands where the eager loop's stands after each call
    for call in range(CALLS):
        assert torch.equal(graphed["gen"][call], eager["gen"][call]), call
    # and the replayed call's rows are the ones the eager loop drew: from the
    # state before the call, its draws give the loop's rows, in order
    gen = torch.Generator(device=card)
    gen.set_state(graphed["gen"][1])
    drawn = [torch.randint(0, PAIRS, (CFG.batch_size,), generator=gen, device=card).cpu() for _ in range(PER_CALL)]
    assert all(torch.equal(a, b) for a, b in zip(drawn, eager["rows"][2 * PER_CALL:]))
    assert not torch.equal(eager["rows"][2 * PER_CALL], eager["rows"][2 * PER_CALL + 1])


def test_capture_works_after_the_benchmarks_observed_first_call(card, monkeypatch):
    cluster = synthetic.make_cluster(num_nodes=1024, num_neighbors=PEERS, num_pairs=8192, seed=SEED)
    cfg = train_gnn.GNNTrainConfig(hidden=64, embed_dim=32, num_layers=2, batch_size=512, warmup_steps=0)
    state = train_gnn.init_state(cfg, rng_seed=SEED, device=card)
    multi, _ = _graphed_multi(monkeypatch, state, cluster, batch_size=cfg.batch_size, steps_per_call=4,
                              seed=BATCH_SEED)
    state, first, seen = _observe_first_call(state, multi, 3, state.optimizer.b1)
    assert "step" not in vars(state.optimizer)  # the observer's wrapper is gone
    assert len(seen["grad"]) == len(seen["params"]) == len(state.optimizer.params)
    pulled, params = [first], []
    for _ in range(3):
        state, (losses, norms) = multi(state)
        pulled.append(torch.stack([losses, norms]).cpu().numpy())
        params.append([p.detach().clone() for p in state.optimizer.params])
    assert CountingGraph.counts == {"captures": 1, "replays": 3}
    assert state.step == 16 and all(np.isfinite(p).all() for p in pulled)
    assert not all(torch.equal(a, b) for a, b in zip(params[0], params[-1]))  # the replays train


def test_remat_calls_are_captured_and_equal_the_eager_remat_steps(card, cluster):
    cfg = train_gnn.GNNTrainConfig(hidden=64, embed_dim=32, num_layers=2, batch_size=512, warmup_steps=1,
                                   remat=True)
    graphed, eager = _graphed(card, cluster, cfg, 3, 2), _eager(card, cluster, cfg, 3, 2)
    assert graphed["counts"][-1] == {"captures": 1, "replays": 2}
    for call in range(3):
        _within_limits(_gaps(graphed, eager, call, per_call=2))
