"""Generic thread-safe DAG.

The port's own copy of dragonfly2_tpu/utils/dag.py.

Parity with reference pkg/graph/dag/dag.go:48-78: vertices with typed values,
edge add with cycle rejection, and *random vertex sampling* — the scheduler's
candidate-parent filter draws <=40 random peers from the task DAG per round
(reference scheduler/scheduling/scheduling.go candidate filter).
"""

from __future__ import annotations

import random
import threading
from typing import Generic, Iterator, TypeVar

V = TypeVar("V")


class DAGError(Exception):
    pass


class VertexNotFound(DAGError):
    pass


class VertexExists(DAGError):
    pass


class CycleError(DAGError):
    pass


class Vertex(Generic[V]):
    __slots__ = ("id", "value", "parents", "children")

    def __init__(self, vid: str, value: V):
        self.id = vid
        self.value = value
        self.parents: set[str] = set()
        self.children: set[str] = set()

    def in_degree(self) -> int:
        return len(self.parents)

    def out_degree(self) -> int:
        return len(self.children)


class DAG(Generic[V]):
    def __init__(self) -> None:
        self._v: dict[str, Vertex[V]] = {}
        self._lock = threading.RLock()
        # vertex-list snapshot for the per-round random sample: rebuilt only
        # when vertices change, not O(N) per scheduling round
        self._vlist: list[Vertex[V]] | None = None

    def __len__(self) -> int:
        return len(self._v)

    def __contains__(self, vid: str) -> bool:
        return vid in self._v

    def add_vertex(self, vid: str, value: V) -> None:
        with self._lock:
            if vid in self._v:
                raise VertexExists(vid)
            vertex = self._v[vid] = Vertex(vid, value)
            # append-in-place instead of invalidating: a growing swarm adds a
            # vertex per registration, and a None'd snapshot costs an O(N)
            # rebuild inside the NEXT scheduling round's candidate draw —
            # O(N²) across a flash crowd (measured by the swarm simulator at
            # 10^5 peers). Deletes still invalidate (rarer, and removal from
            # a list is O(N) anyway).
            if self._vlist is not None:
                self._vlist.append(vertex)

    def delete_vertex(self, vid: str) -> None:
        with self._lock:
            vertex = self._v.pop(vid, None)
            if vertex is None:
                return
            self._vlist = None
            for p in vertex.parents:
                self._v[p].children.discard(vid)
            for c in vertex.children:
                self._v[c].parents.discard(vid)

    def vertex(self, vid: str) -> Vertex[V]:
        try:
            return self._v[vid]
        except KeyError:
            raise VertexNotFound(vid) from None

    def vertices(self) -> dict[str, Vertex[V]]:
        with self._lock:
            return dict(self._v)

    def values(self) -> Iterator[V]:
        with self._lock:
            vs = list(self._v.values())
        return (v.value for v in vs)

    def first_match(self, pred) -> V | None:
        """First value satisfying pred, scanned under the lock WITHOUT the
        values() snapshot copy — the has-available-peer probe runs on every
        registration and usually matches the first vertex; copying 10^5
        vertices first made it O(N) per register (swarm-simulator finding)."""
        with self._lock:
            for v in self._v.values():
                if pred(v.value):
                    return v.value
        return None

    def add_edge(self, from_id: str, to_id: str) -> None:
        """Add from->to; rejects self-loops and edges that would close a cycle."""
        with self._lock:
            if from_id == to_id:
                raise CycleError(f"self edge {from_id}")
            src, dst = self.vertex(from_id), self.vertex(to_id)
            if to_id in src.children:
                return
            if self._reachable(to_id, from_id):
                raise CycleError(f"{from_id}->{to_id} closes a cycle")
            src.children.add(to_id)
            dst.parents.add(from_id)

    def delete_edge(self, from_id: str, to_id: str) -> None:
        with self._lock:
            if from_id in self._v:
                self._v[from_id].children.discard(to_id)
            if to_id in self._v:
                self._v[to_id].parents.discard(from_id)

    def delete_in_edges(self, vid: str) -> None:
        with self._lock:
            vertex = self.vertex(vid)
            for p in vertex.parents:
                self._v[p].children.discard(vid)
            vertex.parents.clear()

    def can_add_edge(self, from_id: str, to_id: str) -> bool:
        with self._lock:
            if from_id == to_id or from_id not in self._v or to_id not in self._v:
                return False
            if to_id in self._v[from_id].children:
                return False
            return not self._reachable(to_id, from_id)

    def _reachable(self, start: str, target: str) -> bool:
        stack, seen = [start], {start}
        while stack:
            cur = stack.pop()
            if cur == target:
                return True
            for c in self._v[cur].children:
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return False

    def lineage(self, vid: str) -> set[str]:
        """All ancestors + descendants of vid (used by scheduling filters)."""
        out: set[str] = set()
        with self._lock:
            for attr in ("parents", "children"):
                stack = list(getattr(self.vertex(vid), attr))
                while stack:
                    cur = stack.pop()
                    if cur in out:
                        continue
                    out.add(cur)
                    stack.extend(getattr(self._v[cur], attr))
        return out

    def parent_values(self, vid: str) -> list[V]:
        """Values of vid's direct parents, snapshotted under the DAG lock:
        callers on other threads (the scheduler's round-dispatcher workers)
        must never iterate a vertex's live parent set while add_edge /
        delete_vertex mutate it."""
        with self._lock:
            return [self._v[p].value for p in self.vertex(vid).parents]

    def child_values(self, vid: str) -> list[V]:
        """Values of vid's direct children; see parent_values."""
        with self._lock:
            return [self._v[c].value for c in self.vertex(vid).children]

    def random_vertices(self, n: int, rng: random.Random | None = None) -> list[Vertex[V]]:
        """Sample up to n distinct vertices uniformly (scheduler candidate draw)."""
        with self._lock:
            if self._vlist is None:
                self._vlist = list(self._v.values())
            vs = self._vlist
        if n >= len(vs):
            return list(vs)
        return (rng or random).sample(vs, n)

    def source_vertices(self) -> list[Vertex[V]]:
        with self._lock:
            return [v for v in self._v.values() if not v.parents]

    def sink_vertices(self) -> list[Vertex[V]]:
        with self._lock:
            return [v for v in self._v.values() if not v.children]
