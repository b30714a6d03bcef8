"""The port's telemetry-to-dataset ingest against the JAX package's, on the CPU.

The same records, made from a seed with numpy, go through the JAX package's
``build_dataset`` / ``DatasetAccumulator`` and the port's. Everything must be
bit-equal: node numbering (``host_index``), the padded ``TopoGraph``, the
``PairBatch`` pool and the training-reference sketch's counts. Also the
record dtypes and generator, ``split_pairs``, and ``FeatureSketch`` / ``psi``.
"""

import numpy as np
import pytest
import torch

from dragonfly2_tpu.observability import sketches as jax_sketches
from dragonfly2_tpu.telemetry import records as jax_records
from dragonfly2_tpu.trainer import dataset as jax_dataset
from dragonfly2_tpu.trainer import synthetic as jax_synthetic
from dragonfly2_tpu_torch.models import FEATURE_NAMES
from dragonfly2_tpu_torch.observability import sketches
from dragonfly2_tpu_torch.telemetry import records
from dragonfly2_tpu_torch.trainer import dataset, synthetic

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)


def _records(n_d, n_p, n_hosts, seed=0, **kw):
    kw.setdefault("frac_failed", 0.1)
    kw.setdefault("frac_no_parent", 0.1)
    return jax_synthetic.synth_telemetry_records(n_d, n_p, n_hosts, seed, **kw)


def assert_same_dataset(got: dataset.Dataset, want) -> None:
    """Bit for bit: dtypes, shapes and values of every array, the host
    index, and the sketch."""
    assert got.host_index == want.host_index
    assert isinstance(got.graph, synthetic.TopoGraph)
    for name, a, b in zip(got.graph._fields, got.graph, want.graph):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, a, b in zip(got.pairs._fields, got.pairs, want.pairs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_nodes == want.num_nodes and got.num_pairs == want.num_pairs
    gs, ws = got.feature_sketch, want.feature_sketch
    assert isinstance(gs, sketches.FeatureSketch)
    assert gs.names == ws.names == tuple(FEATURE_NAMES) and gs.rows == ws.rows
    np.testing.assert_array_equal(gs.counts, ws.counts)


def test_record_dtypes_are_the_jax_dtypes():
    for mine, ref in ((records.DOWNLOAD_DTYPE, jax_records.DOWNLOAD_DTYPE),
                      (records.PROBE_DTYPE, jax_records.PROBE_DTYPE)):
        assert mine == ref and mine.descr == ref.descr and mine.itemsize == ref.itemsize


@pytest.mark.parametrize("sizes", [(0, 0, 3), (1, 1, 1), (200, 150, 12), (3000, 2000, 64)],
                         ids=["empty", "one", "small", "wide"])
@pytest.mark.parametrize("kw", [{}, {"rtt_grid": 0.25, "frac_failed": 0.3, "frac_no_parent": 0.0}],
                         ids=["default", "grid"])
def test_synth_telemetry_records_bit_equal(sizes, kw):
    got = synthetic.synth_telemetry_records(*sizes, seed=5, **kw)
    want = jax_synthetic.synth_telemetry_records(*sizes, seed=5, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _over_degree_with_ties():
    """One source probing 3x max_neighbors destinations on a coarse RTT grid:
    exact ties force the top-k cut through the arrival-order tie-break."""
    hosts = np.array([f"h{i:04d}".encode() for i in range(49)], dtype="S64")
    rtt = (np.random.default_rng(5).integers(1, 5, 48) * 0.25).astype(np.float32)
    p = np.zeros(3 * 48, records.PROBE_DTYPE)
    p["src_host_id"] = hosts[0]
    p["dst_host_id"] = np.tile(hosts[1:], 3)
    p["rtt_mean_ms"] = np.tile(rtt, 3)
    p["rtt_std_ms"] = 0.5
    p["rtt_min_ms"] = np.tile(rtt, 3) / 2
    p["probe_count"] = 10
    return np.zeros(0, records.DOWNLOAD_DTYPE), p, {}


def _case(name):
    if name.startswith("seed"):
        return (*_records(800, 500, 40, seed=int(name[4:])), {})
    d, p = _records(400, 300, 25, seed=11)
    if name == "empty_downloads":
        return d[:0], p, {}
    if name == "empty_probes":
        return d, p[:0], {}
    if name == "both_empty":
        return d[:0], p[:0], {}
    if name == "min_nodes_padding":
        return d[:5], p[:3], {"min_nodes": 64}
    if name == "sources_above_max_neighbors":
        return (*_records(300, 2000, 12, seed=12, rtt_grid=0.5), {"max_neighbors": 4})
    if name == "over_degree_exact_ties":
        return _over_degree_with_ties()
    if name == "all_failed":
        return (*_records(300, 100, 10, seed=13, frac_failed=1.0), {})
    if name == "all_parentless":
        return (*_records(300, 100, 10, seed=14, frac_no_parent=1.0), {})
    if name == "failed_and_parentless_rows":
        return (*_records(600, 200, 30, seed=15, frac_failed=0.4, frac_no_parent=0.3), {})
    raise KeyError(name)


BUILD_CASES = ["seed0", "seed1", "seed2", "empty_downloads", "empty_probes", "both_empty",
               "min_nodes_padding", "sources_above_max_neighbors", "over_degree_exact_ties", "all_failed",
               "all_parentless", "failed_and_parentless_rows"]


@pytest.mark.parametrize("name", BUILD_CASES)
def test_build_dataset_is_bit_equal_to_jax(name):
    d, p, kw = _case(name)
    got = dataset.build_dataset(d, p, **kw)
    assert_same_dataset(got, jax_dataset.build_dataset(d, p, **kw))
    if name == "sources_above_max_neighbors":
        assert got.graph.mask.sum(axis=1).max() == 4 and got.graph.neighbors.shape[1] == 4
    if name == "min_nodes_padding":
        assert got.num_nodes == 64 and len(got.host_index) < 64


def _fold(mod, d, p, chunk, sessions, max_pair_rows):
    """Each session folds its slice of the records chunk by chunk (downloads
    first, then probes, as the announcer streams them) and commits into one
    pool with merge_from."""
    pool = mod.DatasetAccumulator(max_pair_rows=max_pair_rows)
    for s in range(sessions):
        acc = mod.DatasetAccumulator()
        ds, ps = d[s::sessions], p[s::sessions]
        for i in range(0, len(ds), chunk):
            acc.add_downloads(ds[i : i + chunk])
        for i in range(0, len(ps), chunk):
            acc.add_probes(ps[i : i + chunk])
        pool.merge_from(acc)
    pool.merge_from(mod.DatasetAccumulator())  # an empty session commits nothing
    return pool


@pytest.mark.parametrize("chunk,sessions,max_pair_rows", [(7, 1, 0), (173, 3, 0), (64, 2, 300), (4096, 2, 500)])
def test_chunked_fold_with_merge_and_eviction_equals_jax(chunk, sessions, max_pair_rows):
    d, p = _records(1500, 700, 50, seed=6)
    got = _fold(dataset, d, p, chunk, sessions, max_pair_rows)
    want = _fold(jax_dataset, d, p, chunk, sessions, max_pair_rows)
    assert (got.pair_rows, got.num_hosts, got.num_edges, got.download_rows, got.probe_rows) == \
        (want.pair_rows, want.num_hosts, want.num_edges, want.download_rows, want.probe_rows)
    if max_pair_rows:
        assert max_pair_rows <= got.pair_rows < len(d)  # oldest whole chunks went
    assert_same_dataset(got.finalize(), want.finalize())


def test_chunked_fold_equals_the_one_shot_build():
    """On an RTT grid the edge means are exact, so one upload folded in
    chunks gives the one-shot dataset bit for bit."""
    d, p = _records(2000, 900, 60, seed=7, rtt_grid=0.25)
    pool = _fold(dataset, d, p, 256, 1, 0)
    assert_same_dataset(pool.finalize(), jax_dataset.build_dataset(d, p))


def test_freeze_is_isolated_from_later_folds():
    d, p = _records(300, 100, 12, seed=10)
    acc = dataset.DatasetAccumulator()
    acc.add_downloads(d)
    acc.add_probes(p)
    frozen = acc.freeze()
    d2, p2 = _records(200, 50, 25, seed=11)
    acc.add_downloads(d2)
    acc.add_probes(p2)
    assert_same_dataset(frozen.finalize(), jax_dataset.build_dataset(d, p))
    assert acc.finalize().num_pairs > frozen.finalize().num_pairs


@pytest.mark.parametrize("n,holdout,seed", [(1, 0.1, 0), (2, 0.1, 0), (537, 0.1, 3), (1000, 0.25, 9)])
def test_split_pairs_equals_jax(n, holdout, seed):
    rng = np.random.default_rng(n)
    pairs = synthetic.PairBatch(rng.integers(0, 50, n).astype(np.int32), rng.integers(0, 50, n).astype(np.int32),
                                rng.random((n, 16)).astype(np.float32), rng.random(n).astype(np.float32))
    got = dataset.split_pairs(pairs, holdout, seed)
    want = jax_dataset.split_pairs(jax_synthetic.PairBatch(*pairs), holdout, seed)
    for g, w in zip(got, want):
        assert isinstance(g, synthetic.PairBatch)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _dirty_feats(seed, rows=500, f=4):
    x = np.random.default_rng(seed).normal(0.5, 0.6, (rows, f)).astype(np.float32)
    x[3, 0], x[4, 1], x[5, 2], x[6, 3] = np.nan, np.inf, -np.inf, 1e30
    x[7] = [-1.0, 0.0, 1.0, 0.999999]
    return x


@pytest.mark.parametrize("bins,lo,hi", [(16, 0.0, 1.0), (5, -2.0, 3.0)])
def test_feature_sketch_and_psi_equal_jax(bins, lo, hi):
    made = {}
    for mod, key in ((sketches, "port"), (jax_sketches, "jax")):
        ref = mod.FeatureSketch(4, names=["a", "b", "c", "d"], bins=bins, lo=lo, hi=hi)
        assert ref.update(_dirty_feats(1)) == 500 and ref.update(np.zeros((0, 4))) == 0
        ref.update(_dirty_feats(2)[0])  # one row as a vector
        live = mod.FeatureSketch(4, names=["a", "b", "c", "d"], bins=bins, lo=lo, hi=hi)
        live.update(_dirty_feats(3) * 1.5)
        other = mod.FeatureSketch(4, names=["a", "b", "c", "d"], bins=bins, lo=lo, hi=hi)
        other.update(_dirty_feats(4))
        live.merge(other)
        made[key] = (ref, live, mod.psi(ref, live), mod.psi(ref, ref))
    (pr, pl, ppsi, pself), (jr, jl, jpsi, jself) = made["port"], made["jax"]
    for a, b in ((pr, jr), (pl, jl)):
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.rows == b.rows and a.names == b.names
        np.testing.assert_array_equal(a.distribution(), b.distribution())
        da, db = a.to_dict(), b.to_dict()
        assert {k: v for k, v in da.items() if k != "created_at"} == \
            {k: v for k, v in db.items() if k != "created_at"}
    np.testing.assert_array_equal(ppsi, jpsi)
    assert (pself == 0).all() and (ppsi > 0).all()
    # dictionaries cross over both ways
    back = sketches.FeatureSketch.from_dict(jr.to_dict())
    np.testing.assert_array_equal(back.counts, jr.counts)
    assert (back.rows, back.created_at, back.names) == (jr.rows, jr.created_at, jr.names)
    there = jax_sketches.FeatureSketch.from_dict(pl.to_dict())
    np.testing.assert_array_equal(there.counts, pl.counts)
    np.testing.assert_array_equal(sketches.psi(back, pl), jax_sketches.psi(jr, there))


def test_feature_sketch_refuses_bad_layouts():
    sk = sketches.FeatureSketch(3)
    with pytest.raises(ValueError):
        sketches.FeatureSketch(3, names=["a"])
    with pytest.raises(ValueError):
        sketches.FeatureSketch(3, lo=1.0, hi=1.0)
    with pytest.raises(ValueError):
        sk.update(np.zeros((2, 4)))
    with pytest.raises(ValueError):
        sk.merge(sketches.FeatureSketch(3, bins=8))
    with pytest.raises(ValueError):
        sketches.psi(sk, sketches.FeatureSketch(3, hi=2.0))
    with pytest.raises(ValueError):
        sketches.FeatureSketch.from_dict({**sk.to_dict(), "counts": [[0] * 5] * 3})
    np.testing.assert_array_equal(sketches.psi(sk, sketches.FeatureSketch(3)), np.zeros(3))  # empty vs empty
