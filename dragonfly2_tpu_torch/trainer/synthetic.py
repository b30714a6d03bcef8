"""Synthetic topology + telemetry generator (north-star config 2).

The reference never finished probe collection (SyncProbes is a stub,
scheduler_server_v2.go:153-156), so a synthetic cluster generator is required
for GNN bring-up regardless of live telemetry (SURVEY.md §7 hard parts).

The generator builds a ground-truth cluster with latent host capacities and
datacenter structure, derives probe RTTs and observed transfer bandwidths from
it (plus noise), and emits the dense TopoGraph + (child, parent) training
pairs. Learnability is by construction: bandwidth is a deterministic-plus-noise
function of latent structure that the features only echo partially (f[8]
carries a noisy history for ~60% of pairs, mirroring the serving-side
BandwidthHistory; the rest is absent), so the GNN must use the graph to rank
the history-less pairs and beat the linear baseline.

The port's own copy of dragonfly2_tpu/trainer/synthetic.py: from the same
seed it gives bit-equal numpy arrays (the tests hold it to that), wrapped in
the port's TopoGraph. ``synth_telemetry_records`` gives the same raw
download and probe records from the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from dragonfly2_tpu_torch.models.features import (  # noqa: F401 EDGE_FEATURE_DIM is re-exported
    EDGE_FEATURE_DIM,
    FEATURE_DIM,
    NODE_FEATURE_DIM,
)
from dragonfly2_tpu_torch.models.graphsage import TopoGraph
from dragonfly2_tpu_torch.telemetry.records import DOWNLOAD_DTYPE, PROBE_DTYPE


class PairBatch(NamedTuple):
    child: np.ndarray  # [B] int32
    parent: np.ndarray  # [B] int32
    feats: np.ndarray  # [B, FEATURE_DIM] float32
    label: np.ndarray  # [B] float32 normalized observed bandwidth


class SyntheticCluster(NamedTuple):
    graph: TopoGraph
    pairs: PairBatch  # full pool; sample minibatches from it
    capacity: np.ndarray  # [N] latent upload capacity (ground truth)
    idc: np.ndarray  # [N] int datacenter assignment


def make_cluster(
    num_nodes: int = 1024,
    num_neighbors: int = 16,
    num_pairs: int = 65536,
    num_idcs: int = 8,
    seed: int = 0,
) -> SyntheticCluster:
    rng = np.random.default_rng(seed)
    n, k = num_nodes, num_neighbors

    # Latent structure: datacenter assignment + per-host upload capacity
    # (log-normal, so a small fraction of hosts are very fast) + seed flag.
    idc = rng.integers(0, num_idcs, size=n)
    capacity = rng.lognormal(mean=0.0, sigma=0.8, size=n).astype(np.float32)
    capacity /= capacity.max()
    is_seed = (rng.random(n) < 0.05).astype(np.float32)
    capacity = np.maximum(capacity, is_seed * 0.9)  # seeds are provisioned fast

    # Probe graph: mostly intra-IDC edges (low RTT), some cross-IDC (high RTT).
    neighbors = np.zeros((n, k), dtype=np.int32)
    mask = np.zeros((n, k), dtype=np.float32)
    edge_feats = np.zeros((n, k, EDGE_FEATURE_DIM), dtype=np.float32)
    rtt_base_intra = 0.002 + 0.004 * rng.random(num_idcs)  # per-IDC 2-6 ms
    for i in range(n):
        same = np.flatnonzero(idc == idc[i])
        same = same[same != i]
        n_intra = min(len(same), int(k * 0.75))
        intra = rng.choice(same, size=n_intra, replace=False) if n_intra else np.empty(0, int)
        others = rng.integers(0, n, size=k - n_intra)
        nbrs = np.concatenate([intra, others]).astype(np.int32)
        deg = rng.integers(max(4, k // 2), k + 1)  # variable degree, padded
        neighbors[i, :deg] = nbrs[:deg]
        mask[i, :deg] = 1.0
        same_idc = idc[nbrs[:deg]] == idc[i]
        rtt_mean = np.where(same_idc, rtt_base_intra[idc[i]], 0.03 + 0.05 * rng.random(deg))
        rtt_mean = rtt_mean * (1 + 0.1 * rng.standard_normal(deg))
        rtt_std = rtt_mean * (0.05 + 0.2 * rng.random(deg))
        probes = rng.integers(3, 30, size=deg)
        edge_feats[i, :deg, 0] = rtt_mean / 0.1  # normalize by 100 ms
        edge_feats[i, :deg, 1] = rtt_std / 0.1
        edge_feats[i, :deg, 2] = np.maximum(rtt_mean - rtt_std, 0) / 0.1
        edge_feats[i, :deg, 3] = probes / 30.0

    # Node features: observable signals only — capacity itself is NOT a
    # feature; the GNN must infer it from upload history + graph structure.
    node_feats = np.zeros((n, NODE_FEATURE_DIM), dtype=np.float32)
    upload_success = np.clip(0.6 + 0.4 * capacity + 0.1 * rng.standard_normal(n), 0, 1)
    node_feats[:, 0] = is_seed
    node_feats[:, 1] = upload_success
    node_feats[:, 2] = np.clip(rng.random(n) * (1.2 - capacity), 0, 1)  # load
    node_feats[:, 3] = np.clip(0.3 + 0.4 * rng.random(n), 0, 1)  # cpu
    node_feats[:, 4] = np.clip(0.2 + 0.5 * rng.random(n), 0, 1)  # mem
    node_feats[:, 5] = np.clip(capacity + 0.2 * rng.standard_normal(n), 0, 1)  # tx
    node_feats[:, 6] = np.clip(0.5 * rng.random(n), 0, 1)  # rx
    node_feats[:, 7] = np.clip(0.3 + 0.3 * rng.random(n), 0, 1)  # disk
    node_feats[:, 8] = (idc % 16) / 16.0  # idc hash embedding
    node_feats[:, 9] = (idc // 16 + idc % 7) / 8.0
    node_feats[:, 10] = node_feats[:, 8]  # location correlates with idc
    node_feats[:, 11] = rng.random(n) * 0.1

    # Training pairs: observed (child, parent) transfers. Ground-truth
    # bandwidth = parent capacity, throttled by cross-IDC RTT and parent load.
    child = rng.integers(0, n, size=num_pairs).astype(np.int32)
    parent = rng.integers(0, n, size=num_pairs).astype(np.int32)
    same_idc = (idc[child] == idc[parent]).astype(np.float32)
    rtt_penalty = np.where(same_idc > 0, 1.0, 0.35 + 0.2 * rng.random(num_pairs))
    load_penalty = 1.0 - 0.5 * node_feats[parent, 2]
    bw = capacity[parent] * rtt_penalty * load_penalty
    bw = np.clip(bw * (1 + 0.08 * rng.standard_normal(num_pairs)), 0, 1).astype(np.float32)

    feats = np.zeros((num_pairs, FEATURE_DIM), dtype=np.float32)
    feats[:, 0] = rng.random(num_pairs)  # finished piece ratio
    feats[:, 1] = upload_success[parent]
    feats[:, 2] = 1.0 - node_feats[parent, 2]  # free upload ratio
    feats[:, 3] = is_seed[parent]
    feats[:, 4] = same_idc
    feats[:, 5] = same_idc * (0.6 + 0.4 * rng.random(num_pairs))  # location
    feats[:, 6] = np.where(same_idc > 0, 0.03, 0.5) * (1 + 0.2 * rng.standard_normal(num_pairs))
    feats[:, 7] = np.clip(0.2 + 0.3 * rng.random(num_pairs), 0, 1)
    # Bandwidth history (serving-side BandwidthHistory EWMA): a noisy,
    # partially-observed echo of the true bandwidth — ~60% of pairs have
    # prior transfer history, the rest score with the 0.0 "no history" prior
    # the feature contract defines (telemetry/bandwidth.py).
    has_history = rng.random(num_pairs) < 0.6
    feats[:, 8] = np.where(
        has_history,
        np.clip(bw * (1 + 0.25 * rng.standard_normal(num_pairs)), 0, 1),
        0.0,
    )
    feats[:, 9] = rng.random(num_pairs) * 0.4
    feats[:, 10] = rng.random(num_pairs)
    feats[:, 11] = 0.3 + 0.4 * rng.random(num_pairs)
    feats[:, 12] = node_feats[parent, 2]
    feats[:, 13] = 0.0
    feats[:, 14] = 1.0
    feats[:, 15] = rng.random(num_pairs)

    graph = TopoGraph(node_feats, neighbors, mask, edge_feats)
    pairs = PairBatch(child, parent, feats, bw)
    return SyntheticCluster(graph, pairs, capacity, idc)


def synth_telemetry_records(
    n_downloads: int,
    n_probes: int,
    n_hosts: int,
    seed: int = 0,
    *,
    frac_failed: float = 0.05,
    frac_no_parent: float = 0.05,
    rtt_grid: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Plausible raw telemetry (DOWNLOAD_DTYPE + PROBE_DTYPE structured
    arrays), generated vectorized. rtt_grid quantizes RTTs to multiples of
    `rtt_grid`, making per-edge means exact in float32 AND float64
    (deterministic sort tie-breaks)."""
    rng = np.random.default_rng(seed)
    hosts = np.array([f"host-{i:06d}".encode() for i in range(n_hosts)], dtype="S64")
    d = np.zeros(n_downloads, DOWNLOAD_DTYPE)
    if n_downloads:
        d["child_host_id"] = hosts[rng.integers(0, n_hosts, n_downloads)]
        d["parent_host_id"] = hosts[rng.integers(0, n_hosts, n_downloads)]
        d["parent_host_id"][rng.random(n_downloads) < frac_no_parent] = b""
        d["success"] = rng.random(n_downloads) > frac_failed
        d["bandwidth_bps"] = rng.lognormal(19.0, 1.5, n_downloads).astype(np.float32)
        d["pair_features"] = rng.random((n_downloads, 16)).astype(np.float32)
    p = np.zeros(n_probes, PROBE_DTYPE)
    if n_probes:
        p["src_host_id"] = hosts[rng.integers(0, n_hosts, n_probes)]
        p["dst_host_id"] = hosts[rng.integers(0, n_hosts, n_probes)]
        rtts = rng.random(n_probes) * 50
        if rtt_grid is not None:
            rtts = np.round(rtts / rtt_grid) * rtt_grid
        p["rtt_mean_ms"] = rtts.astype(np.float32)
        p["rtt_std_ms"] = (rng.random(n_probes) * 5).astype(np.float32)
        p["rtt_min_ms"] = (rng.random(n_probes) * 20).astype(np.float32)
        p["probe_count"] = rng.integers(1, 40, n_probes)
    return d, p


def sample_batch(pairs: PairBatch, batch_size: int, rng: np.random.Generator) -> PairBatch:
    idx = rng.integers(0, len(pairs.child), size=batch_size)
    return PairBatch(pairs.child[idx], pairs.parent[idx], pairs.feats[idx], pairs.label[idx])
