"""Tiny shared statistics helpers (observability consumers).

The port's own copy of dragonfly2_tpu/utils/stats.py.
"""

from __future__ import annotations

from typing import Sequence


def quantile(sorted_vals: Sequence, q: float) -> float:
    """Nearest-rank quantile over an ALREADY-SORTED sequence; 0.0 when
    empty. Shared by loophealth's /debug/loop summaries and dftrace's stage
    table so the p50/p95 figures the two print always agree."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * (len(sorted_vals) - 1))))
    return float(sorted_vals[idx])
