"""The port's serving slice against the JAX package's, on the CPU.

GNNScorer(device="cpu") loaded with a flax tree must score as the JAX
GNNScorer does through refresh, score and score_rounds; the port's
MicroBatchScorer must answer concurrent rounds of mixed widths, one bad
round failing alone; and with no card present, the entry points raise
instead of carrying on on the CPU.
"""

import asyncio

import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.scorer import GNNScorer as JaxGNNScorer, LinearScorer as JaxLinearScorer
from dragonfly2_tpu.trainer import synthetic as jax_synthetic, train_gnn
from dragonfly2_tpu_torch.models import GNNScorer, LinearScorer, TopoScorer, features
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax
from dragonfly2_tpu_torch.native import MicroBatchScorer
from dragonfly2_tpu_torch.trainer import synthetic

SCORE_MAX_ABS = 5e-3  # bf16 compute, rounded at different places in the two frameworks
NODES, NEIGHBORS, HIDDEN, EMBED, LAYERS = 128, 8, 32, 16, 2


@pytest.fixture(scope="module")
def setup():
    cluster = synthetic.make_cluster(num_nodes=NODES, num_neighbors=NEIGHBORS, num_pairs=512, seed=1)
    jax_cluster = jax_synthetic.make_cluster(num_nodes=NODES, num_neighbors=NEIGHBORS, num_pairs=512, seed=1)
    cfg = train_gnn.GNNTrainConfig(hidden=HIDDEN, embed_dim=EMBED, num_layers=LAYERS)
    jmodel = train_gnn.make_model(cfg)
    params = [train_gnn.init_state(cfg, jax_cluster.graph, rng_seed=s).params for s in (1, 2)]
    model = TopoScorer(hidden=HIDDEN, embed_dim=EMBED, num_layers=LAYERS, head_hidden=jmodel.head_hidden)
    return cluster, jax_cluster, jmodel, params, model


def _rounds(pairs, m, b, offset=0):
    sl = slice(offset, offset + m * b)
    return (pairs.feats[sl].reshape(m, b, -1), pairs.child[sl].reshape(m, b), pairs.parent[sl].reshape(m, b))


def test_gnn_scorer_matches_jax_scorer(setup):
    cluster, jax_cluster, jmodel, params, model = setup
    want = JaxGNNScorer(jmodel, params[0])
    want.refresh(jax_cluster.graph)
    got = GNNScorer(model, params_from_flax(params[0]), device="cpu")
    assert not got.ready and got.num_nodes == 0
    got.refresh(cluster.graph)
    assert got.ready and got.num_nodes == NODES and got.device == torch.device("cpu")
    assert got.engine == "torch" and got.feature_dim == features.FEATURE_DIM

    p = cluster.pairs
    single = got.score(p.feats[:40], child=p.child[:40], parent=p.parent[:40])
    assert single.shape == (40,) and single.dtype == np.float32
    assert np.all((single > 0) & (single < 1))
    assert np.abs(single - want.score(p.feats[:40], child=p.child[:40], parent=p.parent[:40])).max() <= SCORE_MAX_ABS

    feats, child, parent = _rounds(p, 3, 8, offset=40)
    multi = got.score_rounds(feats, child=child, parent=parent)
    assert multi.shape == (3, 8)
    assert np.abs(multi - want.score_rounds(feats, child=child, parent=parent)).max() <= SCORE_MAX_ABS
    for m in range(3):
        np.testing.assert_allclose(multi[m], got.score(feats[m], child=child[m], parent=parent[m]),
                                   rtol=1e-6, atol=1e-6)


def test_gnn_scorer_update_params_and_guards(setup):
    cluster, _, _, params, model = setup
    scorer = GNNScorer(model, params_from_flax(params[0]), device="cpu")
    p = cluster.pairs
    args = dict(child=p.child[:8], parent=p.parent[:8])
    with pytest.raises(RuntimeError, match="refresh"):
        scorer.score(p.feats[:8], **args)
    scorer.refresh(cluster.graph)
    old = scorer.score(p.feats[:8], **args)
    for bad in ({"child": np.array([0, NODES]), "parent": np.array([1, 2])},
                {"child": np.array([0, 1]), "parent": np.array([-1, 2])}):
        with pytest.raises(ValueError, match="out of range"):
            scorer.score(p.feats[:2], **bad)
    with pytest.raises(ValueError, match="split"):
        scorer.score(p.feats[:8, :5], **args)
    scorer.update_params(params_from_flax(params[1]))
    assert not scorer.ready
    with pytest.raises(RuntimeError):
        scorer.score(p.feats[:8], **args)
    scorer.refresh(cluster.graph)
    assert not np.allclose(old, scorer.score(p.feats[:8], **args))


def test_microbatch_mixed_widths_bad_round_fails_alone(setup, run):
    cluster, _, _, params, model = setup
    scorer = GNNScorer(model, params_from_flax(params[0]), device="cpu")
    scorer.refresh(cluster.graph)
    p = cluster.pairs
    widths = [40, 17, 3, 40, 1, 25]
    rounds, at = [], 0
    for w in widths:
        rounds.append((p.feats[at : at + w], p.child[at : at + w], p.parent[at : at + w]))
        at += w
    bad = 2
    rounds[bad] = (rounds[bad][0], rounds[bad][1].copy(), rounds[bad][2])
    rounds[bad][1][0] = NODES + 3  # a stale node id

    async def drive():
        mb = MicroBatchScorer(scorer, max_rounds_per_flush=4)
        res = await asyncio.gather(
            *(mb.score(f, child=c, parent=pa) for f, c, pa in rounds), return_exceptions=True
        )
        return mb, res

    mb, res = run(drive())
    assert isinstance(res[bad], ValueError)
    assert mb.rounds == len(widths) - 1 and mb.flushes >= 2
    for i, (f, c, pa) in enumerate(rounds):
        if i == bad:
            continue
        assert res[i].shape == (widths[i],)
        np.testing.assert_allclose(res[i], scorer.score(f, child=c, parent=pa), rtol=1e-6, atol=1e-6)


class _FailingOnce:
    """A scorer whose first multi-round call raises, as a broken backend would."""

    engine, feature_dim, num_nodes, ready = "torch", features.FEATURE_DIM, NODES, True

    def __init__(self):
        self.calls = 0

    def score_rounds(self, feats, *, child, parent):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("scorer backend failed")
        return np.full(child.shape, 0.5, np.float32)


def test_microbatch_scorer_error_fails_its_flush_only(run):
    scorer = _FailingOnce()
    feats = np.zeros((3, features.FEATURE_DIM), np.float32)
    idx = np.arange(3, dtype=np.int32)

    async def drive():
        mb = MicroBatchScorer(scorer, max_rounds_per_flush=2)
        res = await asyncio.gather(
            *(mb.score(feats, child=idx, parent=idx) for _ in range(4)), return_exceptions=True
        )
        return mb, res

    mb, res = run(drive())
    assert [type(r) for r in res[:2]] == [RuntimeError, RuntimeError]
    assert "backend failed" in str(res[0])
    for r in res[2:]:
        np.testing.assert_array_equal(r, np.full(3, 0.5, np.float32))
    assert scorer.calls == 2 and mb.flushes == 1 and mb.rounds == 2


def test_linear_scorer_matches_jax():
    feats = np.random.default_rng(0).random((5, features.FEATURE_DIM)).astype(np.float32)
    np.testing.assert_array_equal(LinearScorer().score(feats), JaxLinearScorer().score(feats))


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    model = TopoScorer(hidden=HIDDEN, embed_dim=EMBED, num_layers=LAYERS, head_hidden=32)
    sd = params_from_flax(init_flax_like(model, seed=0))
    for kwargs in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GNNScorer(model, sd, **kwargs)
