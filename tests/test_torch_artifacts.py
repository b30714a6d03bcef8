"""The port's artifacts against the JAX package's, on the CPU.

The port's msgpack codec must write what ``flax.serialization`` writes for a
parameter tree and read it back; a GNN or MLP artifact written by either
package must load into the other (the GNN scoring the same rounds), and so
must ``sketch.json``; ``scorer.dfsc`` must be byte for byte the JAX export
for the same embeddings; and the directory digest must be the JAX one,
failing on a flipped byte in the parameters or the sketch.
"""

import json

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.mlp import BandwidthMLP as JaxBandwidthMLP
from dragonfly2_tpu.models.scorer import GNNScorer as JaxGNNScorer
from dragonfly2_tpu.observability import sketches as jax_sketches
from dragonfly2_tpu.native import scorer as jax_native
from dragonfly2_tpu.trainer import artifacts as jax_artifacts
from dragonfly2_tpu.trainer import synthetic as jax_synthetic
from dragonfly2_tpu.trainer import train_gnn as jax_train
from dragonfly2_tpu_torch.models import BandwidthMLP, GNNScorer, TopoScorer
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax, params_to_flax
from dragonfly2_tpu_torch.native import export_scorer_artifact
from dragonfly2_tpu_torch.observability import sketches
from dragonfly2_tpu_torch.trainer import _msgpack, artifacts, synthetic

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

SCORE_MAX_ABS = 5e-3  # bf16 compute, rounded at different places in the two frameworks
NODES, NEIGHBORS = 128, 8
CFG = dict(hidden=32, embed_dim=16, num_layers=2)
HOSTS = {b"host-a": 0, b"host-b": 5}


@pytest.fixture(scope="module")
def setup():
    cluster = jax_synthetic.make_cluster(num_nodes=NODES, num_neighbors=NEIGHBORS, num_pairs=512, seed=1)
    cfg = jax_train.GNNTrainConfig(**CFG)
    params = jax.tree.map(np.asarray, jax_train.init_state(cfg, cluster.graph, rng_seed=3).params)
    return cluster, jax_train.make_model(cfg), params


def _rounds(pairs):
    return pairs.feats[:120].reshape(3, 40, -1), pairs.child[:120].reshape(3, 40), pairs.parent[:120].reshape(3, 40)


def test_codec_is_byte_equal_to_flax_on_a_toposcorer_tree(setup):
    _, _, params = setup
    want = flax.serialization.to_bytes(params)
    assert _msgpack.to_bytes(params) == want
    back = _msgpack.from_bytes(want)
    got, ref = jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["sizes", "scalars"])
def test_codec_matches_msgpack_across_size_classes(case):
    """Every length and integer class msgpack has a form for, against the
    msgpack package (use_bin_type, as flax packs)."""
    rng = np.random.default_rng(0)
    if case == "sizes":
        tree = {
            "k" * 31: np.zeros((0,), np.float32), "k" * 32: rng.random((), np.float32),
            "k" * 255: rng.random((3, 5)).astype(np.float32), "k" * 256: np.arange(70_000, dtype=np.int32),
            "many": {f"m{i}": np.full((i,), i, np.int64) for i in range(17)},
            "u8": np.arange(300, dtype=np.uint8).reshape(3, 100), "f64": rng.random(9),
        }
        want = flax.serialization.msgpack_serialize(tree, in_place=True)  # in_place keeps key order
    else:
        tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -1, -32, -33, -128, -129,
                         -32768, -32769, -2**31, -2**31 - 1],
                "bytes": b"\x00" * 300, "list": list(range(16))}
        want = msgpack.packb(tree, use_bin_type=True)
    assert _msgpack.to_bytes(tree) == want
    back = _msgpack.from_bytes(want)
    assert back.keys() == tree.keys()
    if case == "scalars":
        assert back == tree
    else:
        assert all(back["many"][k].tolist() == v.tolist() for k, v in tree["many"].items())
        assert np.array_equal(back["k" * 256], tree["k" * 256]) and back["u8"].dtype == np.uint8


def test_codec_refuses_what_flax_would_not_write():
    with pytest.raises(TypeError, match="str"):
        _msgpack.to_bytes({1: np.zeros(2)})
    with pytest.raises(TypeError, match="cannot encode"):
        _msgpack.to_bytes({"a": 1.5})
    with pytest.raises(TypeError, match="cannot encode"):
        _msgpack.to_bytes({"a": True})
    with pytest.raises(ValueError, match="outside the subset"):
        _msgpack.from_bytes(msgpack.packb({"a": None}))
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.from_bytes(_msgpack.to_bytes({"a": np.zeros(4, np.float32)})[:-1])
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.from_bytes(_msgpack.to_bytes({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="extension type 2"):
        _msgpack.from_bytes(msgpack.packb({"a": msgpack.ExtType(2, b"xx")}))


def test_jax_artifact_loads_into_the_port_and_scores_alike(setup, tmp_path):
    cluster, jmodel, params = setup
    d = tmp_path / "jax"
    jax_artifacts.save_artifact(d, model_type="gnn", version="v1", params=params, config=CFG)
    jax_artifacts.save_graph(d, cluster.graph, HOSTS)
    model, sd = artifacts.load_gnn(d)
    assert isinstance(model, TopoScorer) and (model.hidden, model.embed_dim, model.num_layers) == (32, 16, 2)
    ref = params_from_flax(params)
    assert sd.keys() == ref.keys() and all(np.array_equal(sd[k].numpy(), ref[k].numpy()) for k in ref)
    graph, hosts = artifacts.load_graph(d)
    assert isinstance(graph, synthetic.TopoGraph) and hosts == {"host-a": 0, "host-b": 5}
    for a, b in zip(graph, cluster.graph):
        assert np.array_equal(a, b)

    got = GNNScorer(model, sd, device="cpu")
    got.refresh(graph)
    want = JaxGNNScorer(jmodel, params)
    want.refresh(cluster.graph)
    feats, child, parent = _rounds(cluster.pairs)
    diff = np.abs(got.score_rounds(feats, child=child, parent=parent)
                  - want.score_rounds(feats, child=child, parent=parent)).max()
    assert diff <= SCORE_MAX_ABS


def test_port_artifact_loads_into_jax(setup, tmp_path):
    cluster, _, _ = setup
    model = TopoScorer(**CFG)
    sd = params_from_flax(init_flax_like(model, seed=4))
    d = tmp_path / "port"
    artifacts.save_artifact(d, model_type="gnn", version="v2", params=sd, config=CFG)
    artifacts.save_graph(d, synthetic.TopoGraph(*cluster.graph).to("cpu"), HOSTS)
    cfg = json.loads((d / "config.json").read_text())
    assert cfg == {"type": "gnn", "version": "v2", "format": jax_artifacts.ARTIFACT_FORMAT, **CFG}
    jmodel, jparams = jax_artifacts.load_gnn(d)
    assert jmodel.hidden == 32
    want, got = params_to_flax(sd), jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)))
    jgraph, hosts = jax_artifacts.load_graph(d)
    assert hosts == {"host-a": 0, "host-b": 5}
    assert all(np.array_equal(a, b) for a, b in zip(jgraph, cluster.graph))


def test_native_export_is_byte_equal_to_jax(setup, tmp_path):
    cluster, _, params = setup
    z = np.random.default_rng(5).normal(size=(NODES, CFG["embed_dim"])).astype(np.float32)
    mine = export_scorer_artifact(params, z, tmp_path / "port.dfsc")
    ref = jax_native.export_scorer_artifact(params, z, tmp_path / "jax.dfsc")
    assert mine.read_bytes() == ref.read_bytes()

    model = TopoScorer(**CFG)
    sd = params_from_flax(params)
    path = artifacts.save_native(tmp_path / "art", model, sd, synthetic.TopoGraph(*cluster.graph), device="cpu")
    assert path.name == "scorer.dfsc"
    model.load_state_dict(sd)
    with torch.inference_mode():
        z = model.eval().embed(synthetic.TopoGraph(*cluster.graph).to("cpu")).numpy()
    want = export_scorer_artifact(params_to_flax(sd), z, tmp_path / "again.dfsc")
    assert path.read_bytes() == want.read_bytes()


def test_digest_matches_jax_and_a_flipped_byte_fails(setup, tmp_path):
    cluster, _, params = setup
    d = tmp_path / "art"
    model = TopoScorer(**CFG)
    sd = params_from_flax(params)
    artifacts.save_artifact(d, model_type="gnn", version="v3", params=sd, config=CFG)
    artifacts.save_graph(d, synthetic.TopoGraph(*cluster.graph), HOSTS)
    artifacts.save_native(d, model, sd, synthetic.TopoGraph(*cluster.graph), device="cpu")
    digest = artifacts.artifact_digest(d)
    assert digest == jax_artifacts.artifact_digest(d)
    artifacts.verify_artifact(d, digest)
    artifacts.verify_artifact(d, "")  # an unverified registry row passes
    raw = bytearray((d / "params.msgpack").read_bytes())
    raw[len(raw) // 2] ^= 0x01
    (d / "params.msgpack").write_bytes(bytes(raw))
    with pytest.raises(artifacts.ArtifactIntegrityError, match="digest mismatch"):
        artifacts.verify_artifact(d, digest)
    with pytest.raises(FileNotFoundError):
        artifacts.verify_artifact(tmp_path / "missing", digest)


def test_load_gnn_refuses_other_formats_types_and_shapes(setup, tmp_path):
    _, _, params = setup
    sd = params_from_flax(params)
    for name, config, model_type in [("old", {**CFG, "format": 1}, "gnn"), ("mlp", CFG, "mlp"),
                                     ("wide", {**CFG, "hidden": 64}, "gnn")]:
        d = tmp_path / name
        artifacts.save_artifact(d, model_type=model_type, version="v", params=sd, config=config)
        with pytest.raises(artifacts.IncompatibleArtifact):
            artifacts.load_gnn(d)
    assert artifacts.load_config(tmp_path / "wide")["hidden"] == 64


MLP_HIDDEN = (32, 16)


def _mlp_inputs():
    return np.random.default_rng(6).random((64, 16)).astype(np.float32)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mlp_artifact_loads_across_packages(writer, tmp_path):
    d = tmp_path / writer
    if writer == "port":
        model = BandwidthMLP(hidden=MLP_HIDDEN)
        model.load_state_dict(params_from_flax(init_flax_like(model, seed=7)))
        artifacts.save_artifact(d, model_type="mlp", version="v1", params=model, config={"hidden": list(MLP_HIDDEN)})
        jmodel, jparams = jax_artifacts.load_mlp(d)
        params = params_to_flax(model)
    else:
        jmodel = JaxBandwidthMLP(hidden=MLP_HIDDEN)
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(7), np.zeros((8, 16), np.float32)))
        jax_artifacts.save_artifact(d, model_type="mlp", version="v1", params=params, config={"hidden": list(MLP_HIDDEN)})
        jparams = params
    model, sd = artifacts.load_mlp(d)
    assert isinstance(model, BandwidthMLP) and model.hidden == MLP_HIDDEN and not model.training
    want, got = params_to_flax(sd), jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(want) == jax.tree.structure(got) == jax.tree.structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)))
    x = _mlp_inputs()
    with torch.inference_mode():
        mine = model(torch.from_numpy(x)).numpy()
    assert np.abs(mine - np.asarray(jmodel.apply(jparams, x))).max() <= SCORE_MAX_ABS
    with pytest.raises(artifacts.IncompatibleArtifact):
        artifacts.load_gnn(d)


def test_load_mlp_refuses_other_types_and_shapes(setup, tmp_path):
    _, _, params = setup
    artifacts.save_artifact(tmp_path / "gnn", model_type="gnn", version="v", params=params_from_flax(params),
                            config=CFG)
    with pytest.raises(artifacts.IncompatibleArtifact):
        artifacts.load_mlp(tmp_path / "gnn")
    model = BandwidthMLP(hidden=MLP_HIDDEN)
    artifacts.save_artifact(tmp_path / "wide", model_type="mlp", version="v", params=model, config={"hidden": [64]})
    with pytest.raises(artifacts.IncompatibleArtifact, match="do not fit"):
        artifacts.load_mlp(tmp_path / "wide")


def _sketch(mod, seed):
    sk = mod.FeatureSketch(16, names=[f"f{i}" for i in range(16)])
    x = np.random.default_rng(seed).normal(0.5, 0.4, (300, 16)).astype(np.float32)
    x[0, 0] = np.nan
    sk.update(x)
    return sk


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sketch_json_crosses_packages_and_the_digest_covers_it(writer, tmp_path):
    d = tmp_path / writer
    model = BandwidthMLP(hidden=MLP_HIDDEN)
    artifacts.save_artifact(d, model_type="mlp", version="v2", params=model, config={"hidden": list(MLP_HIDDEN)})
    assert artifacts.load_sketch(d) is None and jax_artifacts.load_sketch(d) is None  # written without one
    if writer == "port":
        sk = _sketch(sketches, 8)
        assert artifacts.save_sketch(d, sk) == d / "sketch.json"
    else:
        sk = _sketch(jax_sketches, 8)
        jax_artifacts.save_sketch(d, sk)
    for loaded in (artifacts.load_sketch(d), jax_artifacts.load_sketch(d)):
        np.testing.assert_array_equal(loaded.counts, sk.counts)
        assert (loaded.rows, loaded.names, loaded.created_at) == (sk.rows, sk.names, sk.created_at)
    assert isinstance(artifacts.load_sketch(d), sketches.FeatureSketch)
    digest = artifacts.artifact_digest(d)
    assert digest == jax_artifacts.artifact_digest(d)
    artifacts.verify_artifact(d, digest)
    raw = (d / "sketch.json").read_text()
    (d / "sketch.json").write_text(raw.replace('"rows": 300', '"rows": 301'))
    with pytest.raises(artifacts.ArtifactIntegrityError, match="digest mismatch"):
        artifacts.verify_artifact(d, digest)
