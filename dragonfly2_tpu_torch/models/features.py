"""Canonical feature schema shared by the evaluator, telemetry, and trainers.

The reference's base evaluator scores a (child, parent) pair from six signals
(reference scheduler/scheduling/evaluator/evaluator_base.go:31-49): finished
piece ratio, upload success rate, free upload slots, host type, IDC affinity,
location affinity. The ML plane widens that to a fixed PAIR_FEATURE_DIM vector
so one batched scorer call covers all ~40 candidates of a scheduling round
(the reference's per-pair Evaluate signature runs inside a sort comparator —
SURVEY.md §7 flags the batch API as the fix).

Feature vectors are float32, normalized to roughly [0, 1] at build time so the
same schema feeds the linear base evaluator, the MLP, and the GNN edge head.

This is the port's own copy of dragonfly2_tpu/models/features.py: the
tests hold both to the same names, widths and weights.
"""

from __future__ import annotations

import numpy as np

# Per-node (host) features for the topology GNN.
NODE_FEATURE_NAMES = (
    "host_type_seed",        # 1.0 for seed peers / 0.0 normal (ref host.go Type)
    "upload_success_rate",   # finished / (finished + failed) uploads
    "upload_load",           # concurrent upload count / limit
    "cpu_usage",             # [0,1]
    "mem_usage",             # [0,1]
    "network_tx_norm",       # tx bandwidth / 1 GiB/s
    "network_rx_norm",       # rx bandwidth / 1 GiB/s
    "disk_usage",            # [0,1]
    "idc_hash_a",            # 2-d hash embedding of IDC label
    "idc_hash_b",
    "location_hash_a",       # 2-d hash embedding of location label
    "location_hash_b",
)
NODE_FEATURE_DIM = len(NODE_FEATURE_NAMES)

# Per-probe-edge features of the topology graph: rtt_mean, rtt_std, rtt_min,
# probe_count (normalized). The port's modules are built with explicit input
# widths, so the width lives with the schema rather than in the generator.
EDGE_FEATURE_DIM = 4

# Per-(child, parent) pair features for scoring / MLP bandwidth prediction.
FEATURE_NAMES = (
    "finished_piece_ratio",  # parent finished pieces / total (ref weight 0.2)
    "upload_success_rate",   # ref weight 0.2
    "free_upload_ratio",     # free upload slots / limit (ref weight 0.15)
    "host_type_seed",        # ref weight 0.15
    "idc_match",             # ref weight 0.15
    "location_match",        # ref weight 0.15 (prefix-scored)
    "rtt_norm",              # probe avg RTT / 1s, clipped
    "piece_cost_norm",       # mean historical piece cost / 30s budget
    "bandwidth_norm",        # observed parent->child bandwidth / 1 GiB/s
    "parent_depth_norm",     # DAG depth of parent / 10
    "child_piece_ratio",     # child's own progress
    "task_size_norm",        # log1p(content_length) / log1p(1 TiB)
    "concurrent_children",   # parent's current child count / 40
    "retry_norm",            # child scheduling retries / 10
    "seed_cluster_match",    # same scheduler cluster
    "age_norm",              # peer age / 24h TTL
)
FEATURE_DIM = len(FEATURE_NAMES)
PAIR_FEATURE_DIM = FEATURE_DIM

# Reference base-evaluator weights (evaluator_base.go:31-49), aligned to the
# first six FEATURE_NAMES entries.
BASE_WEIGHTS = np.zeros(FEATURE_DIM, dtype=np.float32)
BASE_WEIGHTS[:6] = [0.2, 0.2, 0.15, 0.15, 0.15, 0.15]


def label_hash2(label: str) -> tuple[float, float]:
    """Cheap stable 2-d embedding of a categorical label (IDC / location).

    crc32, not Python hash(): the trainer and the serving scheduler are
    different processes and must map the same label to the same features.
    """
    if not label:
        return 0.0, 0.0
    import zlib

    h = zlib.crc32(label.encode()) & 0xFFFFFFFF
    return (h & 0xFFFF) / 65535.0, (h >> 16) / 65535.0


def location_affinity(a: str, b: str) -> float:
    """Prefix-depth match of '|'-separated location paths (ref evaluator_base)."""
    if not a or not b:
        return 0.0
    pa, pb = a.split("|"), b.split("|")
    depth = min(len(pa), len(pb), 5)
    same = 0
    for i in range(depth):
        if pa[i] != pb[i]:
            break
        same += 1
    return same / 5.0
