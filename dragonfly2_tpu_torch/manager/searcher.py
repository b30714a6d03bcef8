"""Scheduler-cluster searcher: scores clusters for a joining peer.

The port's own copy of dragonfly2_tpu/manager/searcher.py.

Reference equivalent: manager/searcher/searcher.go:48-155. Linear blend —
0.4·CIDR affinity + 0.35·IDC affinity + 0.24·location affinity +
0.01·cluster-type — over the cluster's declared scopes; clusters with no
active schedulers are filtered out before scoring, ties break toward
is_default clusters via the cluster-type term (searcher.go:246-257 scores
a default cluster 1.0, non-default 0.5).
"""

from __future__ import annotations

import ipaddress
from typing import Any

CIDR_WEIGHT = 0.4
IDC_WEIGHT = 0.35
LOCATION_WEIGHT = 0.24
CLUSTER_TYPE_WEIGHT = 0.01

AFFINITY_SEPARATOR = "|"
MAX_ELEMENTS = 5  # searcher.go maxElementLen


def cidr_affinity(ip: str, cidrs: list[str]) -> float:
    if not ip or not cidrs:
        return 0.0
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return 0.0
    for cidr in cidrs:
        try:
            if addr in ipaddress.ip_network(cidr, strict=False):
                return 1.0
        except ValueError:
            continue
    return 0.0


def idc_affinity(dst: str, src: str) -> float:
    """dst = peer's idc; src = cluster scope idc ('a|b|c' multi-element)."""
    if not dst or not src:
        return 0.0
    if dst == src or dst in src.split(AFFINITY_SEPARATOR):
        return 1.0
    return 0.0


def multi_element_affinity(dst: str, src: str) -> float:
    """Prefix-match score over '|'-separated hierarchy (country|region|zone)."""
    if not dst or not src:
        return 0.0
    if dst == src:
        return 1.0
    dst_el = dst.split(AFFINITY_SEPARATOR)
    src_el = src.split(AFFINITY_SEPARATOR)
    n = min(len(dst_el), len(src_el), MAX_ELEMENTS)
    score = 0
    for i in range(n):
        if dst_el[i] != src_el[i]:
            break
        score += 1
    return score / MAX_ELEMENTS


def cluster_type_score(cluster: dict[str, Any]) -> float:
    return 1.0 if cluster.get("is_default") else 0.5


def evaluate(ip: str, conditions: dict[str, str], cluster: dict[str, Any]) -> float:
    scopes = cluster.get("scopes") or {}
    return (
        CIDR_WEIGHT * cidr_affinity(ip, scopes.get("cidrs") or [])
        + IDC_WEIGHT * idc_affinity(conditions.get("idc", ""), scopes.get("idc", ""))
        + LOCATION_WEIGHT
        * multi_element_affinity(conditions.get("location", ""), scopes.get("location", ""))
        + CLUSTER_TYPE_WEIGHT * cluster_type_score(cluster)
    )


def find_scheduler_clusters(
    clusters: list[dict[str, Any]],
    ip: str,
    conditions: dict[str, str] | None = None,
    *,
    has_active_schedulers: dict[int, bool] | None = None,
) -> list[dict[str, Any]]:
    """Filter clusters with live schedulers, then sort by score descending."""
    conditions = conditions or {}
    if has_active_schedulers is not None:
        clusters = [c for c in clusters if has_active_schedulers.get(c["id"])]
    return sorted(clusters, key=lambda c: evaluate(ip, conditions, c), reverse=True)


def new_searcher(spec: str = "default"):
    """Searcher factory (ref manager/searcher/plugin.go:1-39 LoadPlugin):
    "default" serves this module's linear blend; "plugin:pkg.mod:attr" loads
    an external searcher by import path — the Python-native equivalent of the
    reference's dlopen'd manager plugin — duck-checked at boot so a typo'd
    spec fails at start, not at first peer discovery."""
    import sys

    if spec.startswith("plugin:"):
        from dragonfly2_tpu_torch.utils.plugins import load_object, require_methods

        obj = load_object(spec[len("plugin:"):])
        require_methods(
            obj, ("find_scheduler_clusters",), spec=spec, kind="searcher"
        )
        return obj
    if spec != "default":
        # a typo'd spec ("plug:...", "custom") must fail AT BOOT, not
        # silently rank every discovery with the default blend
        from dragonfly2_tpu_torch.utils.plugins import PluginError

        raise PluginError(
            f"unknown searcher {spec!r}: want 'default' or 'plugin:pkg.mod:attr'"
        )
    return sys.modules[__name__]  # the module itself is the default searcher
