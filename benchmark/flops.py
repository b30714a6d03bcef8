"""Matrix-product operations of the topology GNN, from the configuration's
shapes alone (2 operations per multiply-add).

A training step counts its forward three times (the forward, and the
backward's two products for each forward product); the two input
gradients the backward skips (the node and edge features') are counted
all the same, 1.3% of a step at hidden 512. Gathers, activations and
reductions are not matrix products and are not counted.
"""

from __future__ import annotations


def encoder_forward(c: dict) -> int:
    n, k, h = c["hosts"], c["probe_neighbors"], c["hidden"]
    fn, fe, d = c["node_features"], c["edge_features"], c["embed_dim"]
    layer = 3 * 2 * n * h * h + 2 * n * k * fe * h  # msg_nbr, msg_self, Dense_0; msg_edge per edge
    return 2 * n * fn * h + c["num_layers"] * layer + 2 * n * h * d


def head_forward(c: dict, rows: int) -> int:
    d, hh, fp = c["embed_dim"], c["head_hidden"], c["pair_features"]
    return 2 * rows * ((3 * d + fp) * hh + hh * (hh // 2) + (hh // 2))


def train_step(c: dict) -> int:
    """One optimiser step over a ``batch_size`` batch on the whole graph."""
    return 3 * (encoder_forward(c) + head_forward(c, c["batch_size"]))


def refresh(c: dict) -> int:
    """One scorer refresh: the encoder forward and the head's two per-host
    partial products (its first layer's child and parent blocks)."""
    return encoder_forward(c) + 2 * 2 * c["hosts"] * c["embed_dim"] * c["head_hidden"]
