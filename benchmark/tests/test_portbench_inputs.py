"""The benchmark's seeded inputs: shapes, ranges, the latent model's
structure, and that a seed fixes them."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, inputs  # noqa: E402
from benchmark.reference import topo_scorer as ref  # noqa: E402

CPU = torch.device("cpu")


def config(**over) -> dict:
    c = harness.load_json(harness.HERE / "configs" / "topo-h256-16k.json")
    return {**c, "hosts": 2048, "pair_pool": 4096, **over}


def test_cluster_shapes_and_ranges():
    c = config()
    cl = inputs.make_cluster(c, 2**31 + 11, CPU)
    n, k = c["hosts"], c["probe_neighbors"]
    g = cl.graph
    assert g.node_feats.shape == (n, c["node_features"]) and g.node_feats.dtype == torch.float32
    assert g.neighbors.shape == (n, k) and g.neighbors.dtype == torch.int32
    assert g.mask.shape == (n, k) and g.edge_feats.shape == (n, k, c["edge_features"])
    assert int(g.neighbors.min()) >= 0 and int(g.neighbors.max()) < n
    deg = g.mask.sum(1)
    assert int(deg.min()) >= max(4, k // 2) and int(deg.max()) <= k
    # padded slots point at host 0 and carry no probe stats
    assert bool((g.neighbors[g.mask == 0] == 0).all())
    assert float(g.edge_feats[g.mask == 0].abs().max()) == 0.0
    assert bool(((cl.pairs.label >= 0) & (cl.pairs.label <= 1)).all())
    assert cl.pairs.feats.shape == (c["pair_pool"], c["pair_features"])
    assert int(cl.pairs.child.max()) < n and int(cl.pairs.parent.max()) < n


def test_probe_graph_is_mostly_intra_idc_without_self_loops():
    c = config()
    cl = inputs.make_cluster(c, 5, CPU)
    g = cl.graph
    n_intra = int(c["probe_neighbors"] * c["intra_idc_share"])
    intra = g.neighbors[:, :n_intra].long()
    live = g.mask[:, :n_intra] > 0
    same = cl.idc[intra] == cl.idc[:, None]
    assert bool(same[live].all())
    assert not bool((intra == torch.arange(c["hosts"])[:, None])[live].any())
    # the intra slots of a host are distinct hosts
    picked = torch.sort(intra[live.all(1)], dim=1).values
    assert not bool((picked[:, 1:] == picked[:, :-1]).any())


def test_a_seed_fixes_the_inputs_and_another_changes_them():
    c = config(hosts=256, pair_pool=512)
    a, b, other = (inputs.make_cluster(c, s, CPU) for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    for x, y, z in zip(a.graph, b.graph, other.graph):
        assert torch.equal(x, y)
    assert not torch.equal(a.graph.edge_feats, other.graph.edge_feats)
    wa, wb = (inputs.make_weights(c, s, CPU) for s in (7, 7))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_snapshot_ring_remeasures_edges_and_changes_degrees():
    c = config(hosts=512, pair_pool=512)
    cl = inputs.make_cluster(c, 3, CPU)
    ring = inputs.snapshot_ring(cl, 3, 4, 0.1, 0.25)
    assert len(ring) == 4
    for snap in ring:
        assert torch.equal(snap.neighbors, cl.graph.neighbors)
        assert not torch.equal(snap.edge_feats, cl.graph.edge_feats)
        changed = (snap.mask != cl.graph.mask).any(1).float().mean()
        assert 0.05 < float(changed) < 0.25
        assert float(snap.edge_feats[snap.mask == 0].abs().max()) == 0.0
    assert not torch.equal(ring[0].mask, ring[1].mask)


def test_rounds_have_one_child_and_the_config_candidates():
    c = config(hosts=512, pair_pool=512)
    cl = inputs.make_cluster(c, 3, CPU)
    child, parent, feats = inputs.make_rounds(cl, 3, 8, c["candidates"], c["pair_features"])
    assert child.shape == parent.shape == (8, c["candidates"])
    assert feats.shape == (8, c["candidates"], c["pair_features"])
    assert bool((child == child[:, :1]).all())


@pytest.mark.parametrize("name", ["topo-h512-16k", "topo-h256-16k"])
def test_weights_follow_the_init_scale(name):
    c = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    w = inputs.make_weights(c, 2**31 + 3, CPU)
    shapes = ref.param_shapes(c)
    assert {k: tuple(v.shape) for k, v in w.items()} == shapes
    for k, v in w.items():
        assert v.dtype == torch.float32
        if k.endswith("/kernel") and v.numel() >= 4096:
            std = float(v.std()) * v.shape[0] ** 0.5
            assert 0.95 < std < 1.05, (k, std)
            assert float(v.abs().max()) * v.shape[0] ** 0.5 <= 2 / 0.8796 + 1e-4
        elif k.endswith("/scale"):
            assert float((v - 1).abs().max()) < 0.05
        elif k.endswith("/bias"):
            assert 0 < float(v.abs().max()) < 0.05
