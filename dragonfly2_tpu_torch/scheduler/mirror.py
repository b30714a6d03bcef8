"""Python client for the native mirrored peer table.

The port's own copy of dragonfly2_tpu/scheduler/mirror.py.

The C side (native/scorer.cc `DfMirror`) holds a mirror of the scheduler's
per-task candidate state — peers with state/bad/feature-version, hosts with
free upload slots and node indices, the peer DAG adjacency, topology pair
versions and bandwidth parent versions, and the per-(parent, child-host)
feature-row cache. `df_mirror_drive` samples, filters, gathers and scores
whole batches of rounds against that mirror without Python ever walking the
peer pool.

This module owns everything the C side cannot: slot allocation (stable int32
handles for peers/hosts/tasks), the mutation hooks every version bump fires
(resource/networktopology/bandwidth call into here), the full-sync protocol
that (re)builds the mirror from the Python truth, and the poison discipline —
ANY hook failure flips the client to `poisoned`, every subsequent batch takes
the counted Python fallback, and nothing is ever silently wrong.

Slot allocation policy:
  - peer slots are recycled through a free list: a removed peer's slot holds
    no residual state on the C side (adjacency and row caches are detached
    on remove), so reuse is safe — and peers churn at flash-crowd rates, so
    NOT reusing would grow the mirror without bound;
  - host and task slots are monotonic, never reused: a host slot is a KEY in
    other peers' row caches and in the topology pair map, so recycling one
    could alias a dead host's cached rows (same slot, feat_version restarting
    at 0) onto a fresh host — a silent wrong-features hazard no version check
    would catch. Hosts/tasks churn slowly; the leak is bounded and cheap.

Thread safety: hooks fire from service mutators (event loop, under the
scheduler state lock) and from telemetry ingest; the C mirror serializes
internally on its own mutex, and the slot tables here are guarded by a small
client lock. Hook bodies never raise into mutators — they poison instead.
"""

from __future__ import annotations

import logging
import threading
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

# resource.Peer FSM states the filter admits, in the scheduler's canonical
# code order (Scheduling._STATE_CODES); anything else maps to -1 (ineligible,
# including "failed" — which is also what makes skipping bad-flag updates on
# state transitions exact: every state where is_bad_node's fsm check differs
# is already rejected by the state-code check, which runs first).
_STATE_CODES = {"running": 0, "back_to_source": 1, "succeeded": 2}


class MirrorClient:
    """Owner of one native DfMirror: slots, hooks, sync, poison discipline."""

    def __init__(self, scorer: Any):
        from dragonfly2_tpu_torch.native.scorer import NativeMirror

        self.native = NativeMirror(scorer)
        self._lock = threading.Lock()
        self._peer_slots: dict[str, int] = {}
        self._peers_by_slot: dict[int, Any] = {}
        self._peer_free: list[int] = []
        self._next_peer = 0
        self._host_slots: dict[str, int] = {}
        self._next_host = 0
        self._task_slots: dict[str, int] = {}
        self._next_task = 0
        self.poisoned = False
        self.poison_reason = ""
        self.attached = False
        # the serving bundle's node_index this mirror currently reflects —
        # compared by identity in sync_bundle (bundles are immutable; a
        # hot-swap publishes a new object)
        self._node_index: dict[str, int] = {}
        self._node_index_key: int = -1
        self._ev = None
        self._pool = None

    # ---- lifecycle -------------------------------------------------------

    @property
    def ready(self) -> bool:
        return self.attached and not self.poisoned

    def _poison(self, reason: str) -> None:
        if not self.poisoned:
            self.poisoned = True
            self.poison_reason = reason
            logger.warning(
                "native mirror poisoned (%s): batches fall back to the "
                "Python round loop until re-attach", reason,
            )
            from dragonfly2_tpu_torch.scheduler import metrics

            metrics.NATIVE_MIRROR_FALLBACK_TOTAL.inc(0.0, reason="poisoned")

    def peer_slot(self, peer_id: str) -> int:
        return self._peer_slots.get(peer_id, -1)

    def peer_by_slot(self, slot: int):
        return self._peers_by_slot.get(slot)

    def stats(self) -> dict:
        return self.native.stats()

    def close(self) -> None:
        self.detach()
        self.native.close()

    def detach(self) -> None:
        """Unwire every hook reference; the mirror stops receiving deltas."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool._mirror = None
            for h in pool.hosts.values():
                h._mirror = None
            for t in pool.tasks.values():
                t._mirror = None
                for p in t.dag.values():
                    p._mirror = None
        ev = self._ev
        if ev is not None:
            topo = getattr(ev, "topology", None)
            if topo is not None and getattr(topo, "_mirror", None) is self:
                topo._mirror = None
            bw = getattr(ev, "bandwidth", None)
            if bw is not None and getattr(bw, "_mirror", None) is self:
                bw._mirror = None
        self.attached = False

    def attach(self, pool: Any, evaluator: Any) -> None:
        """Full sync: wire hook references and rebuild the mirror from the
        Python truth. Call under the scheduler state lock so no mutator can
        interleave with the walk. Counted as a full sync — the steady-state
        assertion is that this happens once, not per round."""
        self._ev = evaluator
        self._pool = pool
        pool._mirror = self
        topo = getattr(evaluator, "topology", None)
        if topo is not None:
            topo._mirror = self
        bw = getattr(evaluator, "bandwidth", None)
        if bw is not None:
            bw._mirror = self
        for host in pool.hosts.values():
            self._ensure_host(host)
        for task in pool.tasks.values():
            self._ensure_task(task)
            # dag.values() is DAG insertion order == the C vlist order the
            # sampler draws against — this walk must not reorder it
            for peer in task.dag.values():
                self._register_peer(peer)
        for task in pool.tasks.values():
            for peer in task.dag.values():
                self._push_parents(task, peer.id)
        self.native.note_sync()
        self.attached = True

    # ---- slot registration ----------------------------------------------

    def _ensure_host(self, host: Any) -> int:
        slot = self._host_slots.get(host.id)
        if slot is None:
            with self._lock:
                slot = self._next_host
                self._next_host += 1
                self._host_slots[host.id] = slot
            host._mirror = self
            host._mirror_slot = slot
        rc = self.native.host_upsert_fn(
            self.native.handle, slot, host.feat_version,
            host.free_upload_slots, self._node_index.get(host.id, -1),
        )
        if rc != 0:
            raise RuntimeError(f"df_mirror_host_upsert rc={rc}")
        return slot

    def _ensure_task(self, task: Any) -> int:
        slot = self._task_slots.get(task.id)
        if slot is None:
            with self._lock:
                slot = self._next_task
                self._next_task += 1
                self._task_slots[task.id] = slot
            task._mirror = self
            task._mirror_slot = slot
            rc = self.native.task_upsert_fn(self.native.handle, slot)
            if rc != 0:
                raise RuntimeError(f"df_mirror_task_upsert rc={rc}")
        return slot

    def _register_peer(self, peer: Any) -> int:
        hs = self._ensure_host(peer.host)
        ts = self._ensure_task(peer.task)
        with self._lock:
            slot = self._peer_free.pop() if self._peer_free else self._next_peer
            if slot == self._next_peer:
                self._next_peer += 1
            self._peer_slots[peer.id] = slot
            self._peers_by_slot[slot] = peer
        peer._mirror = self
        peer._mirror_slot = slot
        rc = self.native.peer_add_fn(
            self.native.handle, slot, ts, hs,
            _STATE_CODES.get(peer.fsm.current, -1),
            1 if self._ev.is_bad_node(peer) else 0, peer.feat_version,
        )
        if rc != 0:
            raise RuntimeError(f"df_mirror_peer_add rc={rc}")
        return slot

    def _push_parents(self, task: Any, child_id: str) -> None:
        """Replace the child's FULL ordered parent list in the mirror —
        `list(vertex.parents)` order IS what Peer.depth() walks (parents[0]),
        so pushing whole lists keeps the native depth walk bit-exact."""
        try:
            vertex = task.dag.vertex(child_id)
        except Exception:
            return  # vertex gone: peer_remove already detached it natively
        slots = []
        for pid in vertex.parents:
            s = self._peer_slots.get(pid, -1)
            if s < 0:
                raise RuntimeError(f"parent {pid} not mirrored")
            slots.append(s)
        cs = self._peer_slots.get(child_id, -1)
        if cs < 0:
            raise RuntimeError(f"child {child_id} not mirrored")
        rc = self.native.set_parents(cs, slots)
        if rc != 0:
            raise RuntimeError(f"df_mirror_set_parents rc={rc}")

    # ---- mutation hooks (never raise into mutators) ----------------------

    def on_host_feat(self, host: Any) -> None:
        try:
            self._ensure_host(host)
        except Exception:
            logger.exception("mirror host-feat hook failed")
            self._poison("host_feat")

    def on_host_remove(self, host: Any) -> None:
        try:
            with self._lock:
                slot = self._host_slots.pop(host.id, None)
            host._mirror = None
            if slot is not None:
                # slot intentionally NOT recycled (see module docstring)
                self.native.host_remove_fn(self.native.handle, slot)
        except Exception:
            logger.exception("mirror host-remove hook failed")
            self._poison("host_remove")

    def on_task_create(self, task: Any) -> None:
        try:
            self._ensure_task(task)
        except Exception:
            logger.exception("mirror task-create hook failed")
            self._poison("task_create")

    def on_task_remove(self, task: Any) -> None:
        try:
            with self._lock:
                slot = self._task_slots.pop(task.id, None)
            task._mirror = None
            if slot is not None:
                self.native.task_remove_fn(self.native.handle, slot)
        except Exception:
            logger.exception("mirror task-remove hook failed")
            self._poison("task_remove")

    def on_peer_create(self, peer: Any) -> None:
        try:
            self._register_peer(peer)
        except Exception:
            logger.exception("mirror peer-create hook failed")
            self._poison("peer_create")

    def on_peer_delete(self, peer: Any) -> None:
        """After ResourcePool.delete_peer's Python-side detach: the C side
        removes the peer from its parents' child lists and its children's
        parent lists IN PLACE, which preserves surviving-sibling order the
        same way DAG set-discard does."""
        try:
            with self._lock:
                slot = self._peer_slots.pop(peer.id, None)
                if slot is not None:
                    self._peers_by_slot.pop(slot, None)
            peer._mirror = None
            peer._mirror_slot = -1
            if slot is not None:
                rc = self.native.peer_remove_fn(self.native.handle, slot)
                if rc != 0:
                    raise RuntimeError(f"df_mirror_peer_remove rc={rc}")
                with self._lock:
                    self._peer_free.append(slot)
        except Exception:
            logger.exception("mirror peer-delete hook failed")
            self._poison("peer_delete")

    def on_peer_feat(self, peer: Any) -> None:
        try:
            slot = peer._mirror_slot
            if slot < 0:
                return  # create hook hasn't run yet (mid-registration bump)
            rc = self.native.peer_feat_fn(
                self.native.handle, slot, peer.feat_version,
                1 if self._ev.is_bad_node(peer) else 0,
            )
            if rc != 0:
                raise RuntimeError(f"df_mirror_peer_feat rc={rc}")
        except Exception:
            logger.exception("mirror peer-feat hook failed")
            self._poison("peer_feat")

    def on_peer_state(self, peer: Any, dst: str) -> None:
        try:
            slot = peer._mirror_slot
            if slot < 0:
                return
            rc = self.native.peer_state_fn(
                self.native.handle, slot, _STATE_CODES.get(dst, -1)
            )
            if rc != 0:
                raise RuntimeError(f"df_mirror_peer_state rc={rc}")
        except Exception:
            logger.exception("mirror peer-state hook failed")
            self._poison("peer_state")

    def on_edges(self, task: Any, child_id: str) -> None:
        try:
            if self._peer_slots.get(child_id, -1) < 0:
                return  # child already unmirrored (delete in progress)
            self._push_parents(task, child_id)
        except Exception:
            logger.exception("mirror edge hook failed")
            self._poison("edges")

    def on_topo_pair(self, a: str, b: str, version: int) -> None:
        try:
            sa = self._host_slots.get(a, -1)
            sb = self._host_slots.get(b, -1)
            if sa < 0 or sb < 0:
                # pair involves an unmirrored host: nothing cached against it
                # yet — the first row pushed for it ADOPTS the then-current
                # Python pair version (native adoption rule), so skipping
                # here stays lazily exact
                return
            self.native.topo_bump_fn(self.native.handle, sa, sb, version)
        except Exception:
            logger.exception("mirror topology hook failed")
            self._poison("topo")

    def on_bw_parent(self, parent_host_id: str, version: int) -> None:
        try:
            slot = self._host_slots.get(parent_host_id, -1)
            if slot < 0:
                return  # same adoption rule as on_topo_pair
            self.native.bw_bump_fn(self.native.handle, slot, version)
        except Exception:
            logger.exception("mirror bandwidth hook failed")
            self._poison("bw")

    # ---- serving-bundle node indices ------------------------------------

    def sync_bundle(self, bundle: Any) -> bool:
        """Point the mirror's host node indices at `bundle`'s node_index.
        Identity-keyed: a hot-swap publishes a new bundle object, and the
        first drive against it re-pushes every mirrored host's index in one
        bulk FFI call (serialized with drives by the caller's rng lock, so a
        mid-batch swap can never mix two bundles' indices in one drive)."""
        if id(bundle) == self._node_index_key:
            return True
        try:
            node_index = bundle.node_index
            slots = np.empty(len(self._host_slots), np.int32)
            idx = np.empty(len(self._host_slots), np.int32)
            host_ids = list(self._host_slots.items())
            for i, (hid, slot) in enumerate(host_ids):
                slots[i] = slot
                idx[i] = node_index.get(hid, -1)
            rc = self.native.set_node_indices(slots, idx)
            if rc != 0:
                raise RuntimeError(f"df_mirror_set_node_indices rc={rc}")
            self._node_index = node_index
            self._node_index_key = id(bundle)
            return True
        except Exception:
            logger.exception("mirror bundle sync failed")
            self._poison("bundle_sync")
            return False

    # ---- stale-round row refresh ----------------------------------------

    def push_round_rows(self, child: Any, parents: list) -> None:
        """Refresh the mirror's cached pair rows for one stale round: the
        rows come from the SAME version-keyed Python cache the serial leg
        scores from (_export_pair_rows), so this is a key compute + memcpy
        per candidate, and the next drive against unchanged versions goes
        fully native."""
        try:
            from dragonfly2_tpu_torch.scheduler.evaluator import _export_pair_rows
            from dragonfly2_tpu_torch.models.features import FEATURE_DIM

            n = len(parents)
            ch = child.host
            ch_slot = self._host_slots.get(ch.id, -1)
            if n == 0 or ch_slot < 0:
                return
            ev = self._ev
            topology, bandwidth = ev.topology, ev.bandwidth
            rows = np.empty((n, FEATURE_DIM), np.float32)
            _export_pair_rows(child, parents, topology, bandwidth, rows)
            topo_pver = topology.pair_version if topology is not None else None
            bw_pver = bandwidth.parent_version if bandwidth is not None else None
            keys = np.empty((n, 5), np.int64)
            slots = np.empty(n, np.int32)
            ch_id = ch.id
            ch_feat = ch.feat_version
            for i, p in enumerate(parents):
                h = p.host
                slots[i] = p._mirror_slot
                keys[i, 0] = p.feat_version
                keys[i, 1] = h.feat_version
                keys[i, 2] = ch_feat
                keys[i, 3] = topo_pver(ch_id, h.id) if topo_pver is not None else -1
                keys[i, 4] = bw_pver(h.id) if bw_pver is not None else -1
            rc = self.native.push_rows(ch_slot, slots, keys, rows)
            if rc != 0:
                raise RuntimeError(f"df_mirror_push_rows rc={rc}")
        except Exception:
            logger.exception("mirror row push failed")
            self._poison("push_rows")
