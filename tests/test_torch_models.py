"""Parity of the PyTorch port's models, weights and data with the JAX package.

The same seed must give bit-equal synthetic clusters; a real flax
``TopoScorer.init`` tree must carry over to the port and back exactly; and
the port's TopoScorer loaded with it must give the flax embeddings and
scores within bf16 tolerances. Both frameworks run on the CPU; inputs are
numpy arrays handed to both.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models import features as jax_features
from dragonfly2_tpu.models.graphsage import TopoGraph as JaxTopoGraph, TopoScorer as JaxTopoScorer
from dragonfly2_tpu.trainer import synthetic as jax_synthetic
from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.models import features, graphsage
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax, params_to_flax
from dragonfly2_tpu_torch.trainer import synthetic

# bf16 compute in both frameworks rounds at different places; these bound
# the drift the carried weights may show (embeddings are unit vectors,
# scores lie in (0, 1)).
EMBED_MAX_ABS, EMBED_MIN_COSINE, SCORE_MAX_ABS = 2e-2, 0.999, 5e-3

CONFIGS = {
    "n256_h32_e16_l2": dict(nodes=256, k=16, hidden=32, embed_dim=16, num_layers=2, head_hidden=32),
    "n128_h64_e32_l2_k8": dict(nodes=128, k=8, hidden=64, embed_dim=32, num_layers=2, head_hidden=64),
}


def _flax_setup(cfg, seed=0):
    cluster = jax_synthetic.make_cluster(num_nodes=cfg["nodes"], num_neighbors=cfg["k"], num_pairs=512, seed=1)
    model = JaxTopoScorer(hidden=cfg["hidden"], embed_dim=cfg["embed_dim"],
                          num_layers=cfg["num_layers"], head_hidden=cfg["head_hidden"])
    g = JaxTopoGraph(*(jnp.asarray(a) for a in cluster.graph))
    pairs = cluster.pairs
    params = model.init(jax.random.PRNGKey(seed), g, jnp.asarray(pairs.child[:8]),
                        jnp.asarray(pairs.parent[:8]), jnp.asarray(pairs.feats[:8]))
    return cluster, model, g, jax.tree.map(np.asarray, params)


def _port_model(cfg):
    return graphsage.TopoScorer(hidden=cfg["hidden"], embed_dim=cfg["embed_dim"],
                                num_layers=cfg["num_layers"], head_hidden=cfg["head_hidden"])


@pytest.mark.parametrize("num_nodes,num_neighbors,seed", [(64, 4, 1), (300, 16, 7)])
def test_make_cluster_and_sample_batch_bit_equal(num_nodes, num_neighbors, seed):
    want = jax_synthetic.make_cluster(num_nodes=num_nodes, num_neighbors=num_neighbors, num_pairs=1000, seed=seed)
    got = synthetic.make_cluster(num_nodes=num_nodes, num_neighbors=num_neighbors, num_pairs=1000, seed=seed)
    assert isinstance(got.graph, graphsage.TopoGraph)
    assert got.graph._fields == want.graph._fields and got.pairs._fields == want.pairs._fields
    for a, b in zip([*got.graph, *got.pairs, got.capacity, got.idc], [*want.graph, *want.pairs, want.capacity, want.idc]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    bg = synthetic.sample_batch(got.pairs, 32, np.random.default_rng(5))
    bw = jax_synthetic.sample_batch(want.pairs, 32, np.random.default_rng(5))
    for a, b in zip(bg, bw):
        np.testing.assert_array_equal(a, b)
    assert synthetic.EDGE_FEATURE_DIM == jax_synthetic.EDGE_FEATURE_DIM


def test_feature_schema_equal():
    assert features.NODE_FEATURE_NAMES == jax_features.NODE_FEATURE_NAMES
    assert features.FEATURE_NAMES == jax_features.FEATURE_NAMES
    assert (features.NODE_FEATURE_DIM, features.FEATURE_DIM, features.PAIR_FEATURE_DIM) == (
        jax_features.NODE_FEATURE_DIM, jax_features.FEATURE_DIM, jax_features.PAIR_FEATURE_DIM)
    np.testing.assert_array_equal(features.BASE_WEIGHTS, jax_features.BASE_WEIGHTS)
    assert features.BASE_WEIGHTS.dtype == jax_features.BASE_WEIGHTS.dtype
    for label in ["", "idc-a", "us-east|zone-1", "东京"]:
        assert features.label_hash2(label) == jax_features.label_hash2(label)
    for a, b in [("a|b|c", "a|b|d"), ("a", ""), ("x|y|z|w|v|u", "x|y|z|w|v|u"), ("p", "q")]:
        assert features.location_affinity(a, b) == jax_features.location_affinity(a, b)


def test_params_round_trip_exactly():
    cfg = CONFIGS["n256_h32_e16_l2"]
    _, _, _, params = _flax_setup(cfg)
    sd = params_from_flax(params)
    model = _port_model(cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict: every name and shape agrees
    assert sd["encoder.Dense_0.weight"].shape == (cfg["hidden"], features.NODE_FEATURE_DIM)
    back = params_to_flax(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_init_flax_like_matches_flax_tree_and_scale():
    cfg = CONFIGS["n256_h32_e16_l2"]
    _, _, _, params = _flax_setup(cfg)
    model = _port_model(cfg)
    tree = init_flax_like(model, seed=3)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == np.float32
    enc = tree["params"]["encoder"]
    assert np.all(enc["Dense_0"]["bias"] == 0.0)
    assert np.all(enc["SAGELayer_0"]["LayerNorm_0"]["scale"] == 1.0)
    assert np.all(enc["SAGELayer_0"]["LayerNorm_0"]["bias"] == 0.0)
    kernel = tree["params"]["head"]["layers_0"]["kernel"]  # [3e + Fp, head_hidden]
    fan_in = kernel.shape[0]
    assert abs(kernel.std() * np.sqrt(fan_in) - 1.0) < 0.1  # lecun_normal: variance 1/fan_in
    assert np.abs(kernel).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    again = init_flax_like(model, seed=3)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    model.load_state_dict(params_from_flax(tree))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_toposcorer_matches_flax(name):
    cfg = CONFIGS[name]
    cluster, jmodel, jg, params = _flax_setup(cfg)
    model = _port_model(cfg)
    model.load_state_dict(params_from_flax(params))
    port_cluster = synthetic.make_cluster(num_nodes=cfg["nodes"], num_neighbors=cfg["k"], num_pairs=512, seed=1)
    g = port_cluster.graph.to("cpu")
    pairs = cluster.pairs
    child, parent, feats = pairs.child[:64], pairs.parent[:64], pairs.feats[:64]
    with torch.no_grad():
        z = model.embed(g).numpy()
        s = model(g, torch.from_numpy(child), torch.from_numpy(parent), torch.from_numpy(feats)).numpy()
    zj = np.asarray(jmodel.apply(params, jg, method=jmodel.embed))
    sj = np.asarray(jmodel.apply(params, jg, jnp.asarray(child), jnp.asarray(parent), jnp.asarray(feats)))
    assert z.shape == zj.shape and z.dtype == np.float32
    cos = (z * zj).sum(-1) / (np.linalg.norm(z, axis=-1) * np.linalg.norm(zj, axis=-1))
    assert np.abs(z - zj).max() <= EMBED_MAX_ABS
    assert cos.min() >= EMBED_MIN_COSINE
    np.testing.assert_allclose(np.linalg.norm(z, axis=-1), 1.0, atol=1e-3)
    assert s.shape == (64,) and np.all((s > 0) & (s < 1))
    assert np.abs(s - sj).max() <= SCORE_MAX_ABS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_layernorm_gelu_match_flax(dtype):
    """The three numeric traps, one layer at a time: Dense rounding and
    bias order, LayerNorm eps and f32 statistics, tanh GELU."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(16, 24)) * 3).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    to_np = lambda t: t.float().detach().numpy()  # noqa: E731

    dense = fnn.Dense(8, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    p = dense.init(jax.random.PRNGKey(1), jx)
    p = {"params": {"kernel": p["params"]["kernel"], "bias": jnp.asarray(rng.normal(size=8), jnp.float32)}}
    tdense = graphsage.Dense(24, 8)
    tdense.load_state_dict(params_from_flax(jax.tree.map(np.asarray, p)))
    np.testing.assert_array_equal(to_np(tdense(tx)), np.asarray(dense.apply(p, jx), np.float32))

    ln = fnn.LayerNorm(dtype=jnp.bfloat16, param_dtype=jnp.float32)
    lp = {"params": {"scale": jnp.asarray(rng.normal(size=24), jnp.float32),
                     "bias": jnp.asarray(rng.normal(size=24), jnp.float32)}}
    tln = graphsage.LayerNorm(24)
    tln.load_state_dict(params_from_flax(jax.tree.map(np.asarray, lp)))
    want = np.asarray(ln.apply(lp, jx), np.float32)
    assert tln(tx).dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(tln(tx)), want, rtol=1e-2, atol=1e-2)

    gx = np.linspace(-4, 4, 801, dtype=np.float32)
    np.testing.assert_allclose(graphsage.gelu(torch.from_numpy(gx)).numpy(),
                               np.asarray(fnn.gelu(jnp.asarray(gx))), rtol=1e-6, atol=1e-6)


def test_topograph_to_makes_tensors():
    c = synthetic.make_cluster(num_nodes=16, num_neighbors=4, num_pairs=8, seed=0)
    g = c.graph.to("cpu")
    assert all(isinstance(a, torch.Tensor) for a in g)
    assert g.neighbors.dtype == torch.int32 and g.node_feats.dtype == torch.float32
    np.testing.assert_array_equal(g.edge_feats.numpy(), c.graph.edge_feats)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
