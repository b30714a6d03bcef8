"""The port's copy of the native C++ scorer against the JAX package's.

Both load one ``scorer.dfsc`` that the port's ``save_native`` wrote from a
small TopoScorer. The port's library is built by ``ops/_build.build_gxx``
from ``csrc/scorer.cc`` (a copy of ``dragonfly2_tpu/native/scorer.cc``,
same flags), so ``score``, ``score_rounds`` and ``drive_rounds`` are held
bit for bit to the reference's, as is a handle forked through
``ScorerHandlePool``; both are within 5e-3 of the port's ``GNNScorer`` on
the CPU. The reference's mirror binds on the port's library, as a
reference scheduler does when it serves the port's scorer.
"""

import threading

import numpy as np
import pytest
import torch

from dragonfly2_tpu.native import scorer as ref_native
from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.models.features import FEATURE_DIM
from dragonfly2_tpu_torch.native import NativeMirror, NativeScorer, ScorerHandlePool
from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.trainer import artifacts
from dragonfly2_tpu_torch.trainer.synthetic import make_cluster

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

SCORE_MAX_ABS = 5e-3
MODEL = dict(hidden=32, embed_dim=16, num_layers=2, head_hidden=32)
N, K, ROUNDS, CANDS = 64, 4, 8, 5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    cluster = make_cluster(num_nodes=N, num_neighbors=K, num_pairs=256, seed=2)
    model = TopoScorer(**MODEL)
    sd = params_from_flax(init_flax_like(model, seed=4))
    artifacts.save_native(d, model, sd, cluster.graph, device="cpu")
    gnn = GNNScorer(model, sd, device="cpu")
    gnn.refresh(cluster.graph)
    rng = np.random.default_rng(9)
    feats = rng.random((ROUNDS, CANDS, FEATURE_DIM), dtype=np.float32)
    child = rng.integers(0, N, (ROUNDS, CANDS), dtype=np.int32)
    parent = rng.integers(0, N, (ROUNDS, CANDS), dtype=np.int32)
    return dict(path=d / "scorer.dfsc", gnn=gnn, feats=feats, child=child, parent=parent)


@pytest.fixture(scope="module")
def scorers(setup):
    port, ref = NativeScorer(setup["path"]), ref_native.NativeScorer(setup["path"])
    yield port, ref
    port.close()
    ref.close()


def test_the_library_builds_from_the_repo_and_is_reused():
    first = _build.build_gxx("scorer")
    again = _build.build_gxx("scorer")
    assert first["path"] == again["path"] == _build.gxx_library_path("scorer")
    assert again["seconds"] == 0.0 and "-O3" in again["flags"] and "-ffast-math" in again["flags"]
    assert first["path"].parent == _build.BUILD_DIR and first["path"].name.startswith("libscorer-")
    assert _build.sources() == ["neighbor_agg"]  # the nvcc list holds .cu sources only
    src = (_build.CSRC_DIR / "scorer.cc").read_text()
    ref = (ref_native._SRC).read_text()
    assert [ln for ln in src.splitlines() if ln not in ref.splitlines()] == [
        "// ── Native mirrored peer table ─────────────────────────────────────────────"]


def test_handle_reports_the_artifact_shapes(scorers):
    port, ref = scorers
    assert (port.num_nodes, port.embed_dim, port.feature_dim) == (ref.num_nodes, ref.embed_dim, ref.feature_dim)
    assert (port.num_nodes, port.embed_dim, port.feature_dim) == (N, MODEL["embed_dim"], FEATURE_DIM)
    assert port.engine == ref.engine == "native" and port.ready


def test_score_is_bit_equal_to_the_reference_and_near_torch(setup, scorers):
    port, ref = scorers
    f, c, p = setup["feats"][0], setup["child"][0], setup["parent"][0]
    got = port.score(f, child=c, parent=p)
    np.testing.assert_array_equal(got, ref.score(f, child=c, parent=p))
    err = float(np.abs(got - setup["gnn"].score(f, child=c, parent=p)).max())
    assert err <= SCORE_MAX_ABS, err
    with pytest.raises(ValueError, match="bad node index"):
        port.score(f, child=c, parent=np.full_like(p, N))


def test_score_rounds_is_bit_equal_to_the_reference_and_near_torch(setup, scorers):
    port, ref = scorers
    args = dict(child=setup["child"], parent=setup["parent"])
    got = port.score_rounds(setup["feats"], **args)
    np.testing.assert_array_equal(got, ref.score_rounds(setup["feats"], **args))
    err = float(np.abs(got - setup["gnn"].score_rounds(setup["feats"], **args)).max())
    assert got.shape == (ROUNDS, CANDS) and err <= SCORE_MAX_ABS, err


def _drive_arena(setup):
    """ROUNDS rounds of CANDS survivors: round 1 has a parent whose filter
    fields fail (re-run on the Python leg), round 2 none (empty)."""
    counts = np.full(ROUNDS, CANDS, np.int32)
    counts[2] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    t = int(offsets[-1])
    keep = np.ones((ROUNDS, CANDS), bool)
    keep[2] = False
    filt = np.tile(np.array([0, 1, 2, 0], np.int32), (t, 1))
    filt[offsets[1] + 3, 2] = 0  # no free upload slot
    rng = np.random.default_rng(11)
    return dict(
        offsets=offsets, child_idx=setup["child"][:, 0].copy(), parent_idx=setup["parent"][keep].astype(np.int32),
        feats=np.ascontiguousarray(setup["feats"][keep]), round_cols=rng.random((ROUNDS, 3), dtype=np.float32),
        filt=filt,
    )


def test_drive_rounds_is_bit_equal_to_the_reference(setup, scorers):
    k = 3
    outs = []
    for scorer in scorers:
        a = _drive_arena(setup)
        t = len(a["parent_idx"])
        out = dict(out_scores=np.empty(t, np.float32), sel=np.empty((ROUNDS, k), np.int32),
                   n_sel=np.empty(ROUNDS, np.int32), status=np.empty(ROUNDS, np.int32))
        scorer.drive_rounds(a["offsets"], a["child_idx"], a["parent_idx"], a["feats"], a["round_cols"], a["filt"],
                            rounds=ROUNDS, k=k, max_depth=4, **out)
        outs.append((out, a["feats"]))
    (got, got_feats), (want, want_feats) = outs
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got_feats, want_feats)  # the round columns, broadcast alike
    assert got["status"].tolist() == [0, 1, 0, 0, 0, 0, 0, 0]
    assert got["n_sel"].tolist() == [3, 0, 0, 3, 3, 3, 3, 3]
    assert scorers[0].drive_calls >= 1


@pytest.mark.parametrize("pool_kind", ["port", "reference"])
def test_a_forked_handle_scores_bit_equal(setup, scorers, pool_kind):
    """A worker thread's handle, forked through either package's pool from
    the port's scorer, scores as the primary and the reference do."""
    port, ref = scorers
    pool = (ScorerHandlePool if pool_kind == "port" else ref_native.ScorerHandlePool)(port)
    args = dict(child=setup["child"], parent=setup["parent"])
    box = {}

    def worker():
        h = pool.get()
        box["forked"] = h is not port
        box["out"] = h.score_rounds(setup["feats"], **args)

    th = threading.Thread(target=worker)
    th.start()
    th.join(60)
    assert box["forked"] and pool.handles() == 2 and pool.get() is port
    np.testing.assert_array_equal(box["out"], ref.score_rounds(setup["feats"], **args))
    pool.close()
    assert pool.handles() == 1


@pytest.mark.parametrize("mirror_kind", ["port", "reference"])
def test_the_mirror_binds_on_the_port_library(scorers, mirror_kind):
    port, _ = scorers
    mirror = (NativeMirror if mirror_kind == "port" else ref_native.NativeMirror)(port)
    try:
        assert mirror.feature_dim == FEATURE_DIM and mirror.handle
        assert mirror.host_upsert_fn(mirror.handle, 0, 7, 1, 0) == 0
        stats = mirror.stats()
        assert set(stats) == set(ref_native.NativeMirror._STAT_KEYS) and stats["hosts"] == 1
    finally:
        mirror.close()


def test_a_corrupt_artifact_is_refused(tmp_path):
    bad = tmp_path / "scorer.dfsc"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(IOError, match="failed to load"):
        NativeScorer(bad)
    assert artifacts.load_native(tmp_path / "nothing-here") is None
