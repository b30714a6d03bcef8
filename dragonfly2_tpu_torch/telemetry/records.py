"""Telemetry record schemas: one row per (child, parent) transfer and one
per (src, dst) probe.

The port's own copy of the two dtypes of dragonfly2_tpu/telemetry/records.py,
byte for byte the same (the tests hold them to that), so that records one
package writes the other reads. Record shapes mirror the reference's Download
and NetworkTopology CSVs (scheduler/storage/types.go:26-235) but normalized:
each transfer and each probe is its own row, the layout that pair batches and
edge lists are built from without unflattening. The rotating columnar store
that writes them lives on the scheduler's side and is not ported yet.
"""

from __future__ import annotations

import numpy as np

_ID_LEN = 64  # sha256 hex task ids; peer/host ids truncated to fit

DOWNLOAD_DTYPE = np.dtype(
    [
        ("task_id", f"S{_ID_LEN}"),
        ("child_peer_id", f"S{_ID_LEN}"),
        ("parent_peer_id", f"S{_ID_LEN}"),
        ("child_host_id", f"S{_ID_LEN}"),
        ("parent_host_id", f"S{_ID_LEN}"),
        ("piece_count", "i4"),
        ("piece_size", "i8"),
        ("content_length", "i8"),
        ("bandwidth_bps", "f4"),  # observed child<-parent throughput
        ("piece_cost_ms_mean", "f4"),
        ("success", "?"),
        ("back_to_source", "?"),
        ("pair_features", "f4", (16,)),  # models.features.FEATURE_NAMES order
        ("created_at", "f8"),
    ]
)

PROBE_DTYPE = np.dtype(
    [
        ("src_host_id", f"S{_ID_LEN}"),
        ("dst_host_id", f"S{_ID_LEN}"),
        ("rtt_mean_ms", "f4"),
        ("rtt_std_ms", "f4"),
        ("rtt_min_ms", "f4"),
        ("probe_count", "i4"),
        ("created_at", "f8"),
    ]
)
