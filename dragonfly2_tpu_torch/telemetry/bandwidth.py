"""Observed-bandwidth history: the serving-side store behind feature f[8].

The port's own copy of dragonfly2_tpu/telemetry/bandwidth.py.

The reference's download records carry per-transfer bandwidth into CSVs that
only the (never-implemented) trainer would read (scheduler/storage/types.go
Download.Bandwidth); nothing fed it back into scheduling. Here the loop is
closed: every successful peer result updates an EWMA keyed by
(parent_host, child_host) with a per-parent-host aggregate fallback, the
feature builder reads it at scoring time (models.features "bandwidth_norm"),
and on boot the history warm-starts from the telemetry store's persisted
download records — so the ML plane scores with the bandwidth eye open.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# 1 GiB/s — the reference's default total download/upload rate limit
# (client/config/constants.go:46-47); bandwidth_norm divides by this.
BANDWIDTH_NORM_BPS = float(1 << 30)


class BandwidthHistory:
    """EWMA bandwidth tracker keyed by host pair, with parent-host fallback.

    alpha: EWMA weight of a new observation. Pair-specific history answers
    "how fast was THIS parent for THIS child's host"; the per-parent aggregate
    answers for children that never downloaded from it before.
    """

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._pair: dict[tuple[str, str], float] = {}
        self._parent: dict[str, float] = {}
        # Coarse change counter (any mutation) kept for cheap staleness
        # checks; the evaluator's pair-row cache keys on parent_version()
        # below — one observation invalidates only that PARENT's rows.
        self.version = 0
        # Per-parent-host change counters: an observe(parent, child) updates
        # the (parent, child) pair EWMA and the parent-aggregate fallback, so
        # it can change normalized() for ANY child of that parent (children
        # with no pair entry read the fallback) — but never for another
        # parent. Monotonic, never deleted (see NetworkTopology._pair_vers
        # for the id-recycling rationale).
        self._parent_vers: dict[str, int] = {}
        # Native-mirror client (scheduler.mirror.MirrorClient): parent bumps
        # forward to the C-side mirror so its cached rows stale correctly
        self._mirror = None
        # Federation delta clock + merged remote view (same contract as
        # NetworkTopology — shared semantics in utils/deltaclock.py): local
        # observes stamp their pair key with the post-bump coarse version;
        # merged entries are never re-stamped (never re-gossiped), carry
        # their origin (so a restarted peer's leftovers can be purged), and
        # are consulted by query() only when no local history exists.
        from dragonfly2_tpu_torch.utils.deltaclock import DeltaClock

        self._clock = DeltaClock()
        self._remote_pair: dict[tuple[str, str], float] = {}
        self._remote_origin: dict[tuple[str, str], str] = {}
        self._remote_parent: dict[str, float] = {}
        # host -> pair keys touching it, and a per-parent count of remote
        # pairs: forget_host ran an O(all pairs) membership scan per departed
        # host, and merge_remote's drop-the-aggregate-with-the-last-pair rule
        # re-scanned every remote pair per tombstone — together the top CPU
        # items under churn at 10^5 peers (swarm-simulator finding)
        self._pairs_by_host: dict[str, set] = {}
        self._remote_pairs_by_host: dict[str, set] = {}
        self._remote_parent_pairs: dict[str, int] = {}

    def parent_version(self, parent_host_id: str) -> int:
        """Change counter covering every pair this parent serves (pair EWMA
        or aggregate fallback) — the evaluator cache key's bandwidth leg."""
        return self._parent_vers.get(parent_host_id, 0)

    def _bump_parent(self, parent_host_id: str) -> None:
        ver = self._parent_vers[parent_host_id] = self._parent_vers.get(parent_host_id, 0) + 1
        m = self._mirror
        if m is not None:
            # native-mirror delta: post-bump version keys the
            # mirror's row staleness check for every pair this parent serves
            m.on_bw_parent(parent_host_id, ver)

    def observe(self, parent_host_id: str, child_host_id: str, bps: float) -> None:
        if not parent_host_id or not np.isfinite(bps) or bps <= 0:
            return
        a = self.alpha
        key = (parent_host_id, child_host_id)
        prev = self._pair.get(key)
        self._pair[key] = bps if prev is None else (1 - a) * prev + a * bps
        if prev is None:
            self._pairs_by_host.setdefault(parent_host_id, set()).add(key)
            self._pairs_by_host.setdefault(child_host_id, set()).add(key)
        prev = self._parent.get(parent_host_id)
        self._parent[parent_host_id] = bps if prev is None else (1 - a) * prev + a * bps
        # Versions bump AFTER the EWMA writes (reader-safe ordering for the
        # dispatcher's lock-free feature assembly): a concurrent reader that
        # observes the new parent_version must also observe the new EWMA —
        # the reverse order could cache the stale value under the new version
        # key, serving it until the NEXT observation. A reader that keyed on
        # the old version but read the new value merely re-assembles one row
        # on its next lookup (the cache converges, never sticks stale).
        self._bump_parent(parent_host_id)
        self.version += 1
        self._clock.stamp(key, self.version)

    def query(self, parent_host_id: str, child_host_id: str) -> Optional[float]:
        """Best available estimate in bytes/s, or None with no history.
        Lookup order: local pair EWMA → federation-merged pair EWMA → local
        per-parent aggregate → merged per-parent aggregate (local data wins
        at equal specificity: it is fresher than a gossip round)."""
        v = self._pair.get((parent_host_id, child_host_id))
        if v is not None:
            return v
        v = self._remote_pair.get((parent_host_id, child_host_id))
        if v is not None:
            return v
        v = self._parent.get(parent_host_id)
        if v is not None:
            return v
        return self._remote_parent.get(parent_host_id)

    def normalized(self, parent_host_id: str, child_host_id: str) -> float:
        """Feature-space value: observed bps / 1 GiB/s, clipped to [0, 1];
        0.0 means "no history" (matches the feature's training-time prior)."""
        v = self.query(parent_host_id, child_host_id)
        if v is None:
            return 0.0
        return float(min(v / BANDWIDTH_NORM_BPS, 1.0))

    def forget_host(self, host_id: str) -> None:
        """Drop all history touching a GC'd host — O(that host's pairs) via
        the per-host index, not O(all pairs)."""
        self._parent.pop(host_id, None)
        self._bump_parent(host_id)
        for key in [k for k in self._pairs_by_host.pop(host_id, ()) if k in self._pair]:
            del self._pair[key]
            other = key[0] if key[1] == host_id else key[1]
            if other != host_id:
                peers = self._pairs_by_host.get(other)
                if peers is not None:
                    peers.discard(key)
            # dropping a (parent, child) pair changes normalized() for that
            # PARENT (its children fall back to the aggregate) even when the
            # forgotten host was the child side
            if key[0] != host_id:
                self._bump_parent(key[0])
            self.version += 1
            self._clock.stamp_tombstone(key, self.version)  # gossiped delete
        self._remote_parent.pop(host_id, None)
        for key in list(self._remote_pairs_by_host.pop(host_id, ())):
            if key not in self._remote_pair:
                continue
            self._drop_remote_pair(key)
            if key[0] != host_id:
                self._bump_parent(key[0])
        self.version += 1
        self._clock.prune()

    def _drop_remote_pair(self, key: tuple[str, str]) -> None:
        """Remove one merged pair, maintaining both indexes and the
        per-parent refcount (aggregate eviction reads it)."""
        if self._remote_pair.pop(key, None) is None:
            return
        self._remote_origin.pop(key, None)
        for h in key:
            peers = self._remote_pairs_by_host.get(h)
            if peers is not None:
                peers.discard(key)
        n = self._remote_parent_pairs.get(key[0], 0) - 1
        if n > 0:
            self._remote_parent_pairs[key[0]] = n
        else:
            self._remote_parent_pairs.pop(key[0], None)

    def _add_remote_pair(self, key: tuple[str, str], origin: str) -> None:
        if key not in self._remote_pair:
            for h in key:
                self._remote_pairs_by_host.setdefault(h, set()).add(key)
            self._remote_parent_pairs[key[0]] = (
                self._remote_parent_pairs.get(key[0], 0) + 1
            )
        self._remote_origin[key] = origin

    # ---- federation delta sync (scheduler/federation.py) ----

    def local_entries_since(self, since: int) -> tuple[int, list[dict]]:
        """(watermark, deltas): locally-observed pair EWMAs stamped above
        `since`, each carrying the parent's aggregate fallback alongside;
        forgotten pairs ship tombstones. O(changed) payload."""
        out = []
        for key in self._clock.since(since):
            bps = self._pair.get(key)
            if bps is None:
                out.append({"parent": key[0], "child": key[1], "deleted": True})
            else:
                out.append({
                    "parent": key[0], "child": key[1], "bps": bps,
                    "parent_agg": self._parent.get(key[0], bps),
                })
        return self.version, out

    def merge_remote(self, entries: list[dict], *, origin: str = "") -> int:
        """Apply a peer's bandwidth deltas into the merged view (idempotent:
        re-delivering the same EWMA value is a no-op). Bumps the parent
        version so cached pair rows reading the fallback re-assemble."""
        applied = 0
        for e in entries:
            key = (e["parent"], e["child"])
            if e.get("deleted"):
                if key in self._remote_pair:
                    self._drop_remote_pair(key)
                    applied += 1
                    self.version += 1
                    self._bump_parent(key[0])
                # drop the merged parent aggregate once its LAST remote pair
                # is gone: a GC'd (possibly id-recycled) parent must not keep
                # serving a stale fallback estimate forever (refcount — the
                # original any()-over-every-pair scan per tombstone was the
                # top churn cost at 10^5 peers)
                if not self._remote_parent_pairs.get(key[0]):
                    if self._remote_parent.pop(key[0], None) is not None:
                        self._bump_parent(key[0])
                        self.version += 1
                continue
            changed = self._remote_pair.get(key) != e["bps"]
            agg = e.get("parent_agg")
            if agg is not None and self._remote_parent.get(key[0]) != agg:
                self._remote_parent[key[0]] = float(agg)
                changed = True
            if not changed:
                continue
            self._add_remote_pair(key, origin)
            self._remote_pair[key] = float(e["bps"])
            applied += 1
            self.version += 1
            self._bump_parent(key[0])
        return applied

    def purge_remote_origin(self, origin: str) -> int:
        """Drop merged entries received from a peer that RESTARTED (its
        successor's empty clock can never tombstone them) — mirror of
        NetworkTopology.purge_remote_origin."""
        dead = [k for k, o in self._remote_origin.items() if o == origin]
        for k in dead:
            self._drop_remote_pair(k)
            self._bump_parent(k[0])
            self.version += 1
            if not self._remote_parent_pairs.get(k[0]):
                if self._remote_parent.pop(k[0], None) is not None:
                    self._bump_parent(k[0])
                    self.version += 1
        return len(dead)

    def remote_entry_count(self) -> int:
        return len(self._remote_pair)

    def load_from(self, telemetry) -> int:
        """Warm-start from persisted download records (oldest first, so the
        EWMA ends weighted toward recent transfers). Returns rows ingested."""
        recs = telemetry.downloads.load_all()
        n = 0
        for r in recs:
            if not r["success"] or r["bandwidth_bps"] <= 0:
                continue
            parent = bytes(r["parent_host_id"]).rstrip(b"\x00").decode(errors="replace")
            child = bytes(r["child_host_id"]).rstrip(b"\x00").decode(errors="replace")
            if not parent:
                continue
            self.observe(parent, child, float(r["bandwidth_bps"]))
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._pair)
