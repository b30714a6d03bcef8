"""Parity of the PyTorch port's GNN training with the JAX package's.

The same flax parameters and the same batches go through the JAX trainer
(flax + optax, on the CPU) and the port's (torch, on the CPU): the loss and
its gradients, the optimizer alone on identical gradient trees, a six-step
trajectory, remat, convergence against the linear baseline, and the asyncio
driver. Inputs are numpy arrays from a seed, handed to both packages.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.models.graphsage import TopoGraph as JaxTopoGraph
from dragonfly2_tpu.trainer import synthetic as jax_synthetic
from dragonfly2_tpu.trainer import train_gnn as jax_train
from dragonfly2_tpu_torch.models import GNNScorer, LinearScorer
from dragonfly2_tpu_torch.models.weights import params_from_flax, params_to_flax
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

# bf16 compute in both frameworks rounds at different places: bounds on what
# carried weights may show. Parameters drift about one learning rate in six
# steps, where Adam magnifies bf16 noise in gradients near 0.
GRAD_LEAF_REL, LOSS_ABS, GNORM_REL = 2e-2, 1e-3, 1e-2
TRAJ_LOSS_ABS, TRAJ_PARAM_ABS = 1e-3, 1e-2
# the optimizer alone, on identical f32 gradients: only f32 rounding differs
OPT_REL = 1e-6

SMALL = dict(hidden=64, embed_dim=32, num_layers=2, batch_size=256)


def _cfgs(**kw):
    return jax_train.GNNTrainConfig(**{**SMALL, **kw}), train_gnn.GNNTrainConfig(**{**SMALL, **kw})


@pytest.fixture(scope="module")
def setup():
    """A 256-host cluster (K=8), flax's init for the small config, and the
    same graph in both packages."""
    cluster = jax_synthetic.make_cluster(num_nodes=256, num_neighbors=8, num_pairs=2048, seed=1)
    cfg_j, _ = _cfgs(warmup_steps=2)
    state = jax_train.init_state(cfg_j, cluster.graph)
    params = jax.tree.map(np.asarray, state.params)
    g_jax = JaxTopoGraph(*(jnp.asarray(a) for a in cluster.graph))
    g_port = synthetic.TopoGraph(*cluster.graph).to("cpu")
    return cluster, params, g_jax, g_port


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _step_keeping_raw_grads(state, g, batch, remat=False):
    """One train step; also returns the gradients as the optimizer got them,
    before its clip."""
    grads = {}
    original = state.optimizer.step

    def spy(count):
        grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
        return original(count)

    state.optimizer.step = spy
    state, (loss, gnorm) = train_gnn.make_train_step(remat, with_metrics=True)(state, g, batch)
    return state, loss, gnorm, grads


def test_config_and_model_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(train_gnn.GNNTrainConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jax_train.GNNTrainConfig)]
    cfg_j, cfg_p = _cfgs()
    model = train_gnn.make_model(cfg_p)
    ref = jax_train.make_model(cfg_j)
    assert (model.hidden, model.embed_dim, model.num_layers, model.head_hidden) == \
        (ref.hidden, ref.embed_dim, ref.num_layers, ref.head_hidden)


@pytest.mark.parametrize("warmup", [0, 1, 100])
def test_schedule_matches_optax(warmup):
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, 20_000, 3e-3 * 0.05)
    got = train_gnn.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, 20_000, 3e-3 * 0.05)
    for count in [0, 1, 2, 50, 99, 100, 101, 5000, 19_999, 20_000, 25_000]:
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    assert got(0) == (3e-3 if warmup == 0 else 0.0)


def test_loss_and_gradients_match_flax(setup):
    cluster, params, g_jax, g_port = setup
    batch = jax_synthetic.sample_batch(cluster.pairs, 256, np.random.default_rng(0))
    cfg_j, cfg_p = _cfgs()
    model = jax_train.make_model(cfg_j)
    jb = jax_synthetic.PairBatch(*(jnp.asarray(a) for a in batch))
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jax_train.loss_fn(model.apply, p, g_jax, jb)))(params)

    state = train_gnn.init_state(cfg_p, params=params, device="cpu")
    state, loss_p, gnorm_p, grads_p = _step_keeping_raw_grads(state, g_port, batch)
    assert abs(float(loss_p) - float(loss_j)) <= LOSS_ABS
    gnorm_j = float(optax.global_norm(grads_j))
    assert abs(float(gnorm_p) - gnorm_j) <= GNORM_REL * gnorm_j
    got, want = _leaves(params_to_flax(grads_p)), _leaves(grads_j)
    assert got.keys() == want.keys()
    worst = max(_rel(got[k], want[k]) for k in want)
    assert worst <= GRAD_LEAF_REL, worst


def test_optimizer_matches_optax_on_identical_gradients(setup):
    """30 steps across the warm-up (lr 0 at step 0) into the cosine, with
    gradient trees from numpy, some of them above the clip norm."""
    cluster, params, _, _ = setup
    cfg_j, cfg_p = _cfgs(warmup_steps=5)
    tx = jax_train.init_state(cfg_j, cluster.graph).tx
    p_j = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(p_j)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))

    state = train_gnn.init_state(cfg_p, params=params, device="cpu")
    named = dict(state.model.named_parameters())
    start = params_from_flax(params)
    rng = np.random.default_rng(9)
    clipped = 0
    for step in range(30):
        scale = 0.5 if step % 3 else 0.2  # global norm ~0.5 or ~2 for this tree size
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * scale / np.sqrt(a.size)).astype(np.float32), params
        )
        clipped += float(optax.global_norm(grads)) >= 1.0
        updates, opt_state = update(grads, opt_state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        gsd = params_from_flax(grads)
        for name, p in named.items():
            p.grad = gsd[name]
        state.optimizer.step(step)
        if step == 0:  # lr(0) = 0: nothing moved
            assert all(torch.equal(p.detach(), start[name]) for name, p in named.items())
    assert clipped >= 5
    got, want = _leaves(params_to_flax(state.model)), _leaves(p_j)
    worst = max(_rel(got[k], want[k]) for k in want)
    assert worst <= OPT_REL, worst


def test_six_step_trajectory_matches_jitted_jax_step(setup):
    cluster, params, g_jax, g_port = setup
    cfg_j, cfg_p = _cfgs(warmup_steps=2)
    jstate = jax_train.init_state(cfg_j, cluster.graph)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, params))
    step_j = jax.jit(jax_train.train_step)
    state = train_gnn.init_state(cfg_p, params=params, device="cpu")
    rng = np.random.default_rng(5)
    losses = []
    for _ in range(6):
        batch = jax_synthetic.sample_batch(cluster.pairs, 256, rng)
        jstate, loss_j = step_j(jstate, g_jax, jax_synthetic.PairBatch(*(jnp.asarray(a) for a in batch)))
        state, loss_p = train_gnn.train_step(state, g_port, batch)
        assert abs(float(loss_p) - float(loss_j)) <= TRAJ_LOSS_ABS
        losses.append(float(loss_p))
    assert state.step == 6
    assert losses[-1] < 0.5 * losses[0]  # the six steps trained, so the comparison is not vacuous
    got, want = _leaves(params_to_flax(state.model)), _leaves(jstate.params)
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= TRAJ_PARAM_ABS


def test_remat_gives_the_same_loss_and_gradients_exactly(setup):
    cluster, params, _, g_port = setup
    _, cfg_p = _cfgs(warmup_steps=0)
    batch = jax_synthetic.sample_batch(cluster.pairs, 256, np.random.default_rng(3))
    out = {}
    for remat in (False, True):
        state = train_gnn.init_state(cfg_p, params=params, device="cpu")
        state, loss, gnorm, grads = _step_keeping_raw_grads(state, g_port, batch, remat)
        out[remat] = (loss, gnorm, grads, params_to_flax(state.model))
    (l0, n0, g0, p0), (l1, n1, g1, p1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(n0, n1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    a, b = _leaves(p0), _leaves(p1)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_train_converges_and_beats_linear_baseline():
    """The analogue of tests/test_trainer.py's convergence test, on the port."""
    cluster = synthetic.make_cluster(num_nodes=128, num_neighbors=8, num_pairs=10240, seed=3)
    train_pairs = synthetic.PairBatch(*(a[:8192] for a in cluster.pairs))
    held_out = synthetic.PairBatch(*(a[8192:] for a in cluster.pairs))
    cfg = train_gnn.GNNTrainConfig(hidden=64, embed_dim=32, num_layers=2, batch_size=512,
                                   warmup_steps=10, learning_rate=3e-3)
    logged = []
    state, losses = train_gnn.train(cfg, cluster.graph, train_pairs, steps=120, device="cpu",
                                    log_every=40, log=logged.append)
    assert len(losses) == 4 and len(logged) == 4 and state.step == 120
    assert losses[-1] < losses[0] * 0.5, f"no convergence: {losses}"

    scorer = GNNScorer(state.model, state.model.state_dict(), device="cpu")
    scorer.refresh(cluster.graph)
    pairs = synthetic.sample_batch(held_out, 1024, np.random.default_rng(42))
    gnn_scores = scorer.score(pairs.feats, child=pairs.child, parent=pairs.parent)
    lin_scores = LinearScorer().score(pairs.feats)

    def rank_corr(a, b):
        ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
        ra = ra - ra.mean()
        rb = rb - rb.mean()
        return float((ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum()))

    gnn_corr = rank_corr(gnn_scores, pairs.label)
    lin_corr = rank_corr(lin_scores, pairs.label)
    assert gnn_corr > lin_corr + 0.1, f"GNN {gnn_corr:.3f} vs linear {lin_corr:.3f}"
    assert gnn_corr > 0.6, f"weak ranking: {gnn_corr:.3f}"


class _Telemetry:
    def __init__(self):
        self.steps = []

    def on_step(self, loss, grad_norm, *, examples):
        self.steps.append((loss, grad_norm, examples))


def test_train_async_yields_between_calls_and_feeds_telemetry():
    cluster = synthetic.make_cluster(num_nodes=64, num_neighbors=4, num_pairs=1024, seed=2)
    cfg = train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=64, warmup_steps=2)
    telemetry = _Telemetry()

    async def main():
        ticks = 0
        done = asyncio.Event()

        async def ticker():
            nonlocal ticks
            while not done.is_set():
                ticks += 1
                await asyncio.sleep(0)

        task = asyncio.create_task(ticker())
        try:
            out = await train_gnn.train_async(cfg, cluster.graph, cluster.pairs, steps=12,
                                              device="cpu", steps_per_call=4, telemetry=telemetry)
        finally:
            done.set()
            await task
        return out, ticks

    (state, losses), ticks = asyncio.run(main())
    assert len(losses) == 12 and state.step == 12 and all(np.isfinite(losses))
    assert ticks >= 4  # the loop ran the other coroutine during setup and every call
    assert len(telemetry.steps) == 12
    assert [s[0] for s in telemetry.steps] == pytest.approx(losses)
    assert all(s[1] > 0 and s[2] == 64 for s in telemetry.steps)


def test_multi_step_runs_on_device_pool_and_checks_ids_on_the_host():
    cluster = synthetic.make_cluster(num_nodes=64, num_neighbors=4, num_pairs=1024, seed=2)
    cfg = train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=64, warmup_steps=0)
    state = train_gnn.init_state(cfg, cluster.graph, 1, device="cpu")
    start = params_to_flax(state.model)
    multi = train_gnn.make_multi_step(state, cluster.graph, cluster.pairs, batch_size=64,
                                      steps_per_call=5, with_metrics=True, seed=4)
    state, (losses, norms) = multi(state)
    assert losses.shape == norms.shape == (5,) and losses.dtype == torch.float32
    assert bool(torch.isfinite(losses).all()) and bool((norms > 0).all()) and state.step == 5
    moved = _leaves(params_to_flax(state.model))
    assert any(not np.array_equal(v, _leaves(start)[k]) for k, v in moved.items())

    bad = synthetic.PairBatch(cluster.pairs.child.copy(), *cluster.pairs[1:])
    bad.child[7] = 64
    with pytest.raises(ValueError, match="out of range"):
        train_gnn.make_multi_step(state, cluster.graph, bad, batch_size=8, steps_per_call=1)
    with pytest.raises(ValueError, match="out of range"):
        train_gnn.train_step(state, cluster.graph.to("cpu"), synthetic.PairBatch(*(a[:8] for a in bad)))
    assert state.step == 5


def test_pad_graph_matches_jax():
    cluster = synthetic.make_cluster(num_nodes=50, num_neighbors=4, num_pairs=16, seed=0)
    got = train_gnn.pad_graph(cluster.graph, 64)
    want = jax_train.pad_graph(JaxTopoGraph(*cluster.graph), 64)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert train_gnn.pad_graph(cluster.graph, 50) is cluster.graph


def test_init_state_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gnn.init_state(train_gnn.GNNTrainConfig(**SMALL))
