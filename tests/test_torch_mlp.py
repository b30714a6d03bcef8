"""The port's MLP bandwidth predictor and its trainer against the JAX package's.

The same flax parameters and the same pair pool go through the JAX package
(flax + optax, on the CPU) and the port (torch, on the CPU): the forward,
the optimizer alone on identical gradients, a 30-step training run from the
same seed, and the telemetry cadence. Inputs are numpy arrays from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.models.mlp import BandwidthMLP as JaxBandwidthMLP
from dragonfly2_tpu.trainer import synthetic as jax_synthetic
from dragonfly2_tpu.trainer import train_mlp as jax_train_mlp
from dragonfly2_tpu_torch.models import BandwidthMLP
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax, params_to_flax
from dragonfly2_tpu_torch.trainer import synthetic, train_mlp

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

# bf16 compute in both frameworks rounds at different places: predictions
# lie in (0, 1), as the GNN's scores do (tests/test_torch_models.py)
PRED_MAX_ABS = 5e-3
# 30 Adam steps at lr 1e-3 from the same start and batches
TRAJ_LOSS_ABS, TRAJ_PARAM_ABS = 1e-3, 1e-2
# the optimizer alone, on identical f32 gradients: only f32 rounding differs
OPT_REL = 1e-6


def _jax_init(hidden, seed=0):
    model = JaxBandwidthMLP(hidden=tuple(hidden))
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), jnp.zeros((8, 16))))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def pool():
    cluster = jax_synthetic.make_cluster(num_nodes=128, num_neighbors=8, num_pairs=4096, seed=5)
    return cluster.pairs


def test_config_matches_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(train_mlp.MLPTrainConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jax_train_mlp.MLPTrainConfig)]
    assert train_mlp._TELEMETRY_EVERY == jax_train_mlp._TELEMETRY_EVERY
    assert train_mlp.make_model(train_mlp.MLPTrainConfig()).hidden == (256, 256, 128)


@pytest.mark.parametrize("hidden", [(256, 256, 128), (64, 32), (32,)], ids=["default", "h64_32", "h32"])
def test_flax_tree_carries_over_exactly_and_init_covers_the_mlp(hidden):
    _, params = _jax_init(hidden, seed=1)
    model = BandwidthMLP(hidden=hidden)
    sd = params_from_flax(params)
    model.load_state_dict(sd)
    want, back = _leaves(params), _leaves(params_to_flax(model))
    assert back.keys() == want.keys()
    assert all(back[k].dtype == want[k].dtype and np.array_equal(back[k], want[k]) for k in want)
    # init_flax_like draws the same tree: names, shapes, zero biases, the
    # kernels at lecun_normal's scale
    mine = _leaves(init_flax_like(model, seed=0))
    assert mine.keys() == want.keys() and all(mine[k].shape == want[k].shape for k in want)
    for k, v in mine.items():
        if k.endswith("['bias']"):
            assert not v.any()
        else:
            assert abs(v.std() * np.sqrt(v.shape[0]) - 1.0) < (0.2 if v.size > 100 else 1.0)


@pytest.mark.parametrize("hidden", [(256, 256, 128), (64, 32)], ids=["default", "h64_32"])
def test_forward_matches_flax(hidden, pool):
    jmodel, params = _jax_init(hidden, seed=2)
    model = BandwidthMLP(hidden=hidden)
    model.load_state_dict(params_from_flax(params))
    x = pool.feats[:512]
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (512,) and got.dtype == np.float32
    assert np.all((got > 0) & (got < 1))
    assert np.abs(got - want).max() <= PRED_MAX_ABS


def test_adam_matches_optax_on_identical_gradients():
    rng = np.random.default_rng(3)
    params = {"params": {"Dense_0": {"kernel": rng.normal(size=(16, 8)).astype(np.float32),
                                     "bias": np.zeros(8, np.float32)},
                         "Dense_1": {"kernel": rng.normal(size=(8, 1)).astype(np.float32),
                                     "bias": rng.normal(size=1).astype(np.float32)}}}
    tx = optax.adam(1e-3)
    p_j = jax.tree.map(jnp.asarray, params)
    state = tx.init(p_j)
    update = jax.jit(tx.update)
    model = BandwidthMLP(hidden=(8,))
    model.load_state_dict(params_from_flax(params))
    opt = train_mlp.make_optimizer(train_mlp.MLPTrainConfig(), model.parameters())
    named = dict(model.named_parameters())
    for step in range(30):
        scale = 10.0 if step % 4 == 0 else 0.01  # norms above and below any clip: adam clips nothing
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), params)
        updates, state = update(grads, state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        gsd = params_from_flax(grads)
        for name, p in named.items():
            p.grad = gsd[name].clone()
        gnorm = opt.step(step)
        assert abs(float(gnorm) - float(optax.global_norm(grads))) <= 1e-5 * float(optax.global_norm(grads))
    got, want = _leaves(params_to_flax(model)), _leaves(p_j)
    worst = max(float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])) for k in want)
    assert worst <= OPT_REL, worst


class _Telemetry:
    def __init__(self):
        self.calls = []

    def on_step(self, loss, grad_norm=None, *, steps=1, examples=None):
        self.calls.append((loss, grad_norm, steps, examples))


def test_thirty_steps_match_jax_from_the_same_start(pool):
    """The JAX trainer draws its start from PRNGKey(seed); the port starts
    from that tree through ``params=``. Same seed, same batches."""
    tr, ev = (jax_synthetic.PairBatch(*(a[s] for a in pool)) for s in (slice(0, 3600), slice(3600, None)))
    cfg_j = jax_train_mlp.MLPTrainConfig(steps=30, batch_size=256)
    _, start = _jax_init(cfg_j.hidden, seed=4)
    tel_j, tel_p = _Telemetry(), _Telemetry()
    params_j, eval_j = jax_train_mlp.train(cfg_j, tr, eval_pairs=ev, seed=4, telemetry=tel_j)
    model, eval_p = train_mlp.train(train_mlp.MLPTrainConfig(steps=30, batch_size=256),
                                    synthetic.PairBatch(*tr), eval_pairs=synthetic.PairBatch(*ev),
                                    seed=4, telemetry=tel_p, params=start, device="cpu")
    # the JAX cadence: a report every 10 steps, with the steps and examples since the last
    assert [c[2:] for c in tel_p.calls] == [c[2:] for c in tel_j.calls] == [(10, 2560)] * 3
    for (lp, gp, _, _), (lj, gj, _, _) in zip(tel_p.calls, tel_j.calls):
        assert abs(lp - lj) <= TRAJ_LOSS_ABS and abs(gp - gj) <= 1e-2 * gj
    assert tel_p.calls[-1][0] == eval_p["train_mse"]
    assert eval_p.keys() == eval_j.keys() == {"train_mse", "eval_mse"}
    assert abs(eval_p["eval_mse"] - eval_j["eval_mse"]) <= TRAJ_LOSS_ABS
    assert abs(eval_p["train_mse"] - eval_j["train_mse"]) <= TRAJ_LOSS_ABS
    got, want, first = _leaves(params_to_flax(model)), _leaves(params_j), _leaves(start)
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= TRAJ_PARAM_ABS
    # it trained: the parameters moved well past the tolerance they are held to
    assert max(np.abs(got[k] - first[k]).max() for k in want) > 2 * TRAJ_PARAM_ABS


def test_telemetry_reports_the_last_partial_window_and_eval_covers_the_split(pool):
    tel = _Telemetry()
    pairs = synthetic.PairBatch(*pool)
    model, ev = train_mlp.train(train_mlp.MLPTrainConfig(hidden=(16,), steps=23, batch_size=5000), pairs,
                                eval_pairs=pairs, telemetry=tel, device="cpu")
    # batch capped at the pool's 4096 rows, as the JAX trainer caps it
    assert [c[2:] for c in tel.calls] == [(10, 40960), (10, 40960), (3, 12288)]
    with torch.inference_mode():
        pred = model(torch.from_numpy(pool.feats)).numpy()
    assert ev["eval_mse"] == pytest.approx(float(np.mean((pred - pool.label) ** 2)), rel=1e-6)
    _, no_eval = train_mlp.train(train_mlp.MLPTrainConfig(hidden=(16,), steps=2, batch_size=8), pairs, device="cpu")
    assert no_eval.keys() == {"train_mse"}


def test_mlp_learns_bandwidth():
    """The analogue of tests/test_trainer.py's MLP convergence test, on the port."""
    cluster = synthetic.make_cluster(num_nodes=128, num_neighbors=8, num_pairs=8192, seed=5)
    model = BandwidthMLP(hidden=(64, 32))
    model.load_state_dict(params_from_flax(init_flax_like(model, seed=0)))
    opt = train_mlp.make_optimizer(train_mlp.MLPTrainConfig(learning_rate=1e-2), model.parameters())
    rng = np.random.default_rng(0)
    losses = []
    for i in range(150):
        b = synthetic.sample_batch(cluster.pairs, 256, rng)
        loss, _ = train_mlp.train_step(model, opt, i, torch.from_numpy(b.feats), torch.from_numpy(b.label))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.4, f"MLP no convergence: {losses[0]} -> {losses[-1]}"


def test_train_raises_without_a_card(pool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mlp.train(train_mlp.MLPTrainConfig(steps=1), synthetic.PairBatch(*pool))
