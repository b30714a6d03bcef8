"""The plain reference held against the port at a small size on the CPU
(64 hosts, hidden 32), and its optimiser against torch's own AdamW."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, inputs, params  # noqa: E402
from benchmark.reference import topo_scorer as ref  # noqa: E402

SMALL = {"hosts": 64, "hidden": 32, "pair_pool": 256, "batch_size": 64, "embed_dim": 16}


def conf(name: str, **over) -> dict:
    return {**harness.load_json(harness.HERE / "configs" / f"{name}.json"), **SMALL, **over}


@pytest.mark.parametrize("seed", [0, 2**31 + 1])
def test_scores_agree_with_the_port(seed):
    from dragonfly2_tpu_torch.models.graphsage import TopoGraph, TopoScorer
    from dragonfly2_tpu_torch.models.scorer import GNNScorer

    c = conf("topo-h256-16k", head_hidden=32)
    cl = inputs.make_cluster(c, seed, "cpu")
    p = inputs.make_weights(c, seed, "cpu")
    child, parent, feats = inputs.make_rounds(cl, seed, 6, c["candidates"], c["pair_features"])
    model = TopoScorer(hidden=c["hidden"], embed_dim=c["embed_dim"], num_layers=c["num_layers"],
                       head_hidden=c["head_hidden"])
    scorer = GNNScorer(model, params.state_dict(p), device="cpu")
    scorer.refresh(TopoGraph(*(a.numpy() for a in cl.graph)))
    served = scorer.score_rounds(feats.numpy(), child=child.numpy(), parent=parent.numpy())
    with torch.no_grad():
        want = ref.scores(p, cl.graph, child.reshape(-1), parent.reshape(-1), feats.reshape(-1, 16),
                          c["num_layers"]).reshape(child.shape).numpy()
    # the port computes in bfloat16: 8 bits of mantissa through 3 layers
    np.testing.assert_allclose(served, want, atol=4e-3)
    assert np.abs(served - want).max() > 0  # two computations, not one


def test_loss_and_gradient_agree_with_the_port():
    from dragonfly2_tpu_torch.models.graphsage import TopoGraph
    from dragonfly2_tpu_torch.trainer import train_gnn
    from dragonfly2_tpu_torch.trainer.synthetic import PairBatch

    c = conf("topo-h512-16k")
    cl = inputs.make_cluster(c, 3, "cpu")
    p = inputs.make_weights(c, 3, "cpu")
    cfg = train_gnn.GNNTrainConfig(hidden=c["hidden"], embed_dim=c["embed_dim"], batch_size=c["batch_size"])
    state = train_gnn.init_state(cfg, params=params.flax_tree(p), device="cpu")
    rows = torch.arange(c["batch_size"])
    batch = PairBatch(*(a[rows].numpy() for a in cl.pairs))
    value = train_gnn.loss_fn(state.model, TopoGraph(*cl.graph), train_gnn._as_batch(*map(torch.as_tensor, batch)))
    value.backward()
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    want = ref.loss(q, cl.graph, *(a[rows] for a in cl.pairs), c["num_layers"])
    want.backward()
    assert float(value.detach()) == pytest.approx(float(want.detach()), rel=2e-3)
    got = {n: w.grad for n, w in state.model.named_parameters()}
    for k, w in q.items():
        g = got[params.torch_name(k)]
        g = g.t() if k.endswith("/kernel") else g
        assert float(torch.linalg.vector_norm(g - w.grad)) <= 0.05 * float(torch.linalg.vector_norm(w.grad)) + 1e-6, k


def test_optimiser_is_adamw_with_the_global_norm_clip():
    torch.manual_seed(0)
    p0 = {"a": torch.randn(5, 3), "b": torch.randn(4)}
    hp = {"learning_rate": 1e-2, "weight_decay": 1e-2, "warmup_steps": 0, "decay_steps": 10**9,
          "end_lr_ratio": 1.0, "clip_norm": 1e9, "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8}
    xs = [torch.randn(3) for _ in range(4)]

    def loss_of(w, x):
        return ((w["a"] @ x).sum() - w["b"].sum()) ** 2

    # the reference's train loop, its loss swapped for this one
    params_ = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = torch.optim.AdamW(params_.values(), lr=1e-2, weight_decay=1e-2, eps=1e-8)
    for x in xs:
        opt.zero_grad()
        loss_of(params_, x).backward()
        opt.step()
    it = iter(xs)
    orig = ref.loss
    try:
        ref.loss = lambda w, *a, **k: loss_of(w, next(it))
        out = ref.train(p0, None, (torch.zeros(4),) * 4, [torch.tensor([0])] * 4, hp, 0)
    finally:
        ref.loss = orig
    for k in p0:
        torch.testing.assert_close(out["params"][k], params_[k].detach(), rtol=1e-5, atol=1e-6)


def test_clip_scales_the_gradient_to_the_norm():
    p0 = {"a": torch.ones(4)}
    hp = {"learning_rate": 1.0, "weight_decay": 0.0, "warmup_steps": 0, "decay_steps": 10,
          "end_lr_ratio": 1.0, "clip_norm": 1.0, "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8}
    orig = ref.loss
    try:
        ref.loss = lambda w, *a, **k: 10.0 * w["a"].sum()
        out = ref.train(p0, None, (torch.zeros(1),) * 4, [torch.tensor([0])], hp, 0)
    finally:
        ref.loss = orig
    assert float(torch.linalg.vector_norm(out["first_grads"]["a"])) == pytest.approx(1.0, rel=1e-6)


def test_learning_rate_schedule():
    hp = {"learning_rate": 3e-3, "warmup_steps": 100, "decay_steps": 20000, "end_lr_ratio": 0.05}
    assert ref.learning_rate(0, hp) == 0.0
    assert ref.learning_rate(50, hp) == pytest.approx(1.5e-3)
    assert ref.learning_rate(100, hp) == pytest.approx(3e-3)
    assert ref.learning_rate(20000, hp) == pytest.approx(1.5e-4)
    assert ref.learning_rate(10**6, hp) == pytest.approx(1.5e-4)
