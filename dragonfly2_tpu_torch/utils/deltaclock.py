"""Delta clock for federation gossip: ONE implementation of the
stamp-on-mutate / tombstone-on-delete / cap-and-prune protocol that
NetworkTopology and BandwidthHistory both gossip with — two hand-kept copies
of the same semantics would silently desynchronize the moment one grew a
change (per-origin purge, TTL, ...) the other missed.

The port's own copy of dragonfly2_tpu/utils/deltaclock.py.

The owner stamps every LOCAL mutation with its store's post-bump version
counter; `since(w)` enumerates keys a peer with watermark `w` has not seen
(the owner decides per key whether that is live stats or a tombstone by
looking at its own store); deletes are stamped via `stamp_tombstone`, and
`prune()` bounds retained tombstone stamps at `tombstone_cap`, dropping the
OLDEST — a peer that last synced before a pruned stamp keeps the stale
remote entry until that key churns again (the bounded-memory tradeoff;
regularly-syncing peers are always far past the prune horizon).

Complexity contract (10^5-peer swarm-simulator finding): `stamp` re-inserts
the key so the dict's insertion order IS ascending stamp order, which makes
`since(w)` O(keys changed past w) via reverse iteration — the enumeration
now costs what the payload does. The original scanned EVERY stamp per
gossip exchange and EVERY stamp again per prune, which turned steady-state
gossip ticks and host churn into the cluster's top two CPU items at scale.
"""

from __future__ import annotations

from typing import Callable, Hashable, Iterator

DEFAULT_TOMBSTONE_CAP = 4096


class DeltaClock:
    __slots__ = ("seq", "dead", "tombstone_cap")

    def __init__(self, tombstone_cap: int = DEFAULT_TOMBSTONE_CAP):
        # INVARIANT: iteration order of `seq` is ascending stamp order —
        # stamp() pops before it reinserts, so a re-stamped key moves to the
        # end. since() depends on this to enumerate from the newest side.
        self.seq: dict[Hashable, int] = {}
        # keys whose current stamp is a tombstone (stamped by
        # stamp_tombstone, not yet pruned, not re-stamped live)
        self.dead: set[Hashable] = set()
        self.tombstone_cap = tombstone_cap

    def stamp(self, key: Hashable, version: int) -> None:
        """Stamp a LIVE mutation of `key` (re-creation clears tombstone)."""
        self.seq.pop(key, None)
        self.seq[key] = version
        self.dead.discard(key)

    def stamp_tombstone(self, key: Hashable, version: int) -> None:
        """Stamp a DELETE of `key` — gossiped as a tombstone until pruned."""
        self.seq.pop(key, None)
        self.seq[key] = version
        self.dead.add(key)

    def since(self, watermark: int) -> Iterator[Hashable]:
        """Keys mutated after `watermark`, O(keys changed): walks from the
        newest stamp backward and stops at the first at-or-below the
        watermark (insertion order is ascending stamp order)."""
        out = []
        for key in reversed(self.seq):
            if self.seq[key] <= watermark:
                break
            out.append(key)
        return reversed(out)

    def prune(self, is_live: Callable[[Hashable], bool] | None = None) -> None:
        """Drop the oldest dead-key stamps past the cap (live keys keep
        their stamp for the key's lifetime; tombstones exist only to gossip
        deletes). O(1) under the cap; O(scan to the excess) above it.
        `is_live` is accepted for compatibility and used as a cross-check
        filter when provided (a key it calls live is never pruned).

        Amortization: when the cap trips, prune 25% BELOW it — the scan
        walks live-key stamps older than the tombstones it wants, and
        pruning exactly one tombstone per delete re-paid that walk on every
        subsequent delete (swarm-simulator finding). The retained-tombstone
        bound stays tombstone_cap exactly; the hysteresis only buys the
        next cap//4 deletes scan-free."""
        if len(self.dead) <= self.tombstone_cap:
            return
        excess = len(self.dead) - (self.tombstone_cap - self.tombstone_cap // 4)
        # seq order is ascending stamp order: the first dead keys seen ARE
        # the oldest tombstones
        doomed = []
        for key in self.seq:
            if key in self.dead and (is_live is None or not is_live(key)):
                doomed.append(key)
                if len(doomed) >= excess:
                    break
        for key in doomed:
            del self.seq[key]
            self.dead.discard(key)

    def __len__(self) -> int:
        return len(self.seq)
