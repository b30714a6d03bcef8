"""The matrix-product count: the configurations' totals, and the count
against PyTorch's own FLOP counter over the plain reference."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import flops, harness, inputs  # noqa: E402
from benchmark.reference import topo_scorer as ref  # noqa: E402


def conf(name: str) -> dict:
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_the_configurations_totals():
    assert flops.train_step(conf("topo-h512-16k")) / 1e9 == pytest.approx(261.9, abs=0.05)
    c = conf("topo-h256-16k")
    assert flops.encoder_forward(c) / 1e9 == pytest.approx(22.1, abs=0.05)
    assert (flops.refresh(c) - flops.encoder_forward(c)) / 1e9 == pytest.approx(2.1, abs=0.05)


@pytest.mark.parametrize("hidden,hosts", [(32, 64), (48, 40)])
def test_forward_count_matches_the_counter_over_the_reference(hidden, hosts):
    c = dict(conf("topo-h512-16k"), hidden=hidden, hosts=hosts, pair_pool=128, batch_size=96, embed_dim=16)
    cl = inputs.make_cluster(c, 1, "cpu")
    p = inputs.make_weights(c, 1, "cpu")
    pairs = cl.pairs
    rows = slice(0, c["batch_size"])
    with FlopCounterMode(display=False) as fc:
        ref.scores(p, cl.graph, pairs.child[rows], pairs.parent[rows], pairs.feats[rows], c["num_layers"])
    assert fc.get_total_flops() == flops.encoder_forward(c) + flops.head_forward(c, c["batch_size"])


def test_train_step_counts_the_forward_three_times():
    c = dict(conf("topo-h512-16k"), hidden=32, hosts=64, pair_pool=128, batch_size=96, embed_dim=16)
    assert flops.train_step(c) == 3 * (flops.encoder_forward(c) + flops.head_forward(c, 96))
