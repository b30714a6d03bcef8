"""In-memory cluster resource model: Host, Task (peer DAG), Peer FSMs.

The port's own copy of dragonfly2_tpu/scheduler/resource.py.

Parity with reference scheduler/resource/ (task.go:105-169, peer.go:50-243,
host.go:112-316): a Task owns a DAG of Peers (parents serve pieces to
children), every Peer transition is FSM-gated, Hosts carry capacity stats and
upload accounting, and managers GC by TTL. Redesigned async-native: one
process-wide event loop, plain dicts + the shared GC registry instead of
goroutine-per-stream.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from enum import Enum
from typing import Any

from dragonfly2_tpu_torch.utils import clock as clockmod
from dragonfly2_tpu_torch.utils import idgen
from dragonfly2_tpu_torch.utils.bitset import Bitset
from dragonfly2_tpu_torch.utils.dag import DAG, VertexNotFound
from dragonfly2_tpu_torch.utils.fsm import FSM, Event
from dragonfly2_tpu_torch.utils.pieces import compute_piece_size, piece_count


class HostType(str, Enum):
    NORMAL = "normal"
    SEED = "seed"


class SizeScope(str, Enum):
    """Task size classes driving the scheduling fast paths (ref task.go SizeScope)."""

    EMPTY = "empty"  # 0 bytes: respond inline, no transfer at all
    TINY = "tiny"  # <= 128 B: bytes ride inside the scheduler response
    SMALL = "small"  # single piece: one parent, no DAG fan-out
    NORMAL = "normal"  # multi-piece P2P tree
    UNKNOWN = "unknown"

    @classmethod
    def of(cls, content_length: int | None, piece_size: int) -> "SizeScope":
        if content_length is None or content_length < 0:
            return cls.UNKNOWN
        if content_length == 0:
            return cls.EMPTY
        if content_length <= TINY_FILE_SIZE:
            return cls.TINY
        if content_length <= piece_size:
            return cls.SMALL
        return cls.NORMAL


TINY_FILE_SIZE = 128

# Peer FSM (reference peer.go:50-130 has ten states; the Received* family is
# parameterized here by size scope instead of four distinct states).
PEER_PENDING = "pending"
PEER_RECEIVED = "received"
PEER_RUNNING = "running"
PEER_BACK_TO_SOURCE = "back_to_source"
PEER_SUCCEEDED = "succeeded"
PEER_FAILED = "failed"
PEER_LEAVE = "leave"

_PEER_EVENTS = [
    Event("register", [PEER_PENDING], PEER_RECEIVED),
    Event("download", [PEER_RECEIVED], PEER_RUNNING),
    Event("back_to_source", [PEER_PENDING, PEER_RECEIVED, PEER_RUNNING], PEER_BACK_TO_SOURCE),
    Event("succeed", [PEER_RUNNING, PEER_BACK_TO_SOURCE], PEER_SUCCEEDED),
    Event("fail", [PEER_PENDING, PEER_RECEIVED, PEER_RUNNING, PEER_BACK_TO_SOURCE], PEER_FAILED),
    Event("restart", [PEER_SUCCEEDED, PEER_FAILED], PEER_RECEIVED),
    Event(
        "leave",
        [PEER_PENDING, PEER_RECEIVED, PEER_RUNNING, PEER_BACK_TO_SOURCE, PEER_SUCCEEDED, PEER_FAILED],
        PEER_LEAVE,
    ),
]

TASK_PENDING = "pending"
TASK_RUNNING = "running"
TASK_SUCCEEDED = "succeeded"
TASK_FAILED = "failed"

_TASK_EVENTS = [
    Event("download", [TASK_PENDING, TASK_SUCCEEDED, TASK_FAILED], TASK_RUNNING),
    Event("succeed", [TASK_RUNNING], TASK_SUCCEEDED),
    Event("fail", [TASK_RUNNING], TASK_FAILED),
]


@dataclass
class HostStats:
    """Observable host signals feeding NODE_FEATURE_NAMES (announced by daemons)."""

    cpu_usage: float = 0.0
    mem_usage: float = 0.0
    disk_usage: float = 0.0
    network_tx_bps: float = 0.0
    network_rx_bps: float = 0.0


class Host:
    """A machine running a peer daemon (ref host.go:112-316)."""

    def __init__(
        self,
        host_id: str,
        ip: str,
        hostname: str,
        *,
        port: int = 0,
        download_port: int = 0,
        host_type: HostType = HostType.NORMAL,
        idc: str = "",
        location: str = "",
        upload_limit: int = 40,
        clock: clockmod.Clock | None = None,
    ):
        self._clock = clock or clockmod.SYSTEM
        self.id = host_id
        self.ip = ip
        self.hostname = hostname
        self.port = port
        self.download_port = download_port
        self.type = host_type
        self.idc = idc
        self.location = location
        self.upload_limit = upload_limit
        self.stats = HostStats()
        self.concurrent_uploads = 0
        self.upload_count = 0
        self.upload_failed_count = 0
        self.peer_ids: set[str] = set()
        # Feature-row cache invalidation: every mutation of a host attribute
        # the evaluator features read (upload slots/counters, idc/location)
        # must bump this — the evaluator caches per-parent feature rows keyed
        # by (peer.feat_version, host.feat_version) to hit its 10k-rounds/s
        # serving budget (see evaluator.build_pair_features).
        self.feat_version = 0
        # Native-mirror hook: when a MirrorClient is attached the
        # version bump ALSO pushes this host's filter fields (free slots,
        # feat version) into the C-side mirror as an incremental delta; None
        # keeps the bump a bare int increment
        self._mirror = None
        self._mirror_slot = -1
        self.created_at = self._clock.monotonic()
        self.updated_at = self.created_at

    def bump_feat(self) -> None:
        self.feat_version += 1
        m = self._mirror
        if m is not None:
            m.on_host_feat(self)

    @property
    def free_upload_slots(self) -> int:
        return max(0, self.upload_limit - self.concurrent_uploads)

    @property
    def upload_success_rate(self) -> float:
        total = self.upload_count + self.upload_failed_count
        return self.upload_count / total if total else 1.0

    def touch(self) -> None:
        self.updated_at = self._clock.monotonic()


class Peer:
    """One download attempt of a task by a host (ref peer.go:50-243)."""

    def __init__(self, peer_id: str, task: "Task", host: Host):
        self.id = peer_id
        self.task = task
        self.host = host
        self._clock = host._clock  # one clock per pool; hosts carry it
        # Wildcard callback maintains the task's back-to-source occupancy
        # counter: EVERY transition in or out of
        # PEER_BACK_TO_SOURCE passes through fire(), so the counter is exact
        # without the O(task-peers) scan can_back_to_source() used to run
        # per candidate round (O(N²) across a 10^5-peer flash crowd).
        self.fsm = FSM(PEER_PENDING, _PEER_EVENTS, callbacks={"*": self._on_transition})
        self.finished_pieces = Bitset()
        self.piece_costs_ms: deque[float] = deque(maxlen=20)
        # Rolling mean over piece_costs_ms, published as ONE scalar at append
        # time (EdgeProbes.enqueue idiom): the round dispatcher's worker
        # threads read it during lock-free feature assembly, where iterating
        # the deque itself would race a concurrent append (RuntimeError).
        self.piece_cost_avg_ms = 0.0
        self.block_parents: set[str] = set()
        self.range = None
        self.schedule_rounds = 0
        # see Host.feat_version: bumped on piece progress, cost samples, and
        # DAG edge changes touching this peer; ancestor edge changes are NOT
        # propagated, so the cached depth feature can lag by a round — depth
        # is a soft scoring signal, and the cache is what keeps feature
        # assembly inside the serving budget
        self.feat_version = 0
        # evaluator-owned cached static row, published as ONE (version, row)
        # tuple: worker threads assembling features concurrently must see a
        # version WITH its matching row — two separate attributes could tear
        # between a reader and two racing writers (row from one version,
        # version stamp from another)
        self._feat_row = ((-1, -1), None)
        # evaluator-owned per-child-host FULL pair rows (static + idc/loc/
        # rtt/bw columns), keyed child_host_id -> (version_key, row); the
        # version key spans this peer, both hosts, and the topology/bandwidth
        # sources, so a hit is a pure row gather (evaluator.build_pair_features)
        self._pair_rows: dict[str, tuple[tuple, Any]] = {}
        # per-version memos for the per-round hot checks (depth walk /
        # bad-node statistics) — invalidated by the same bump_feat sweep;
        # the depth memo also carries its timestamp (TTL, see depth())
        self._depth_memo = (-1, 0, 0.0)
        self._bad_memo = (-1, False)
        # see Host._mirror: set by MirrorClient registration; every feature
        # bump and FSM transition then mirrors natively as a delta
        self._mirror = None
        self._mirror_slot = -1
        self.created_at = self._clock.monotonic()
        self.updated_at = self.created_at

    def bump_feat(self) -> None:
        self.feat_version += 1
        m = self._mirror
        if m is not None:
            m.on_peer_feat(self)

    def _on_transition(self, fsm: FSM, event: str, src: str, dst: str) -> None:
        # int bumps under the FSM's own RLock (and the GIL): exact even when
        # dfstress fires arbitrary events from chaos paths
        if dst == PEER_BACK_TO_SOURCE and src != PEER_BACK_TO_SOURCE:
            self.task._back_to_source_active += 1
        elif src == PEER_BACK_TO_SOURCE and dst != PEER_BACK_TO_SOURCE:
            self.task._back_to_source_active = max(
                0, self.task._back_to_source_active - 1
            )
        m = self._mirror
        if m is not None:
            m.on_peer_state(self, dst)

    @property
    def state(self) -> str:
        return self.fsm.current

    @property
    def is_seed(self) -> bool:
        return idgen.is_seed_peer_id(self.id) or self.host.type == HostType.SEED

    def finished_piece_ratio(self) -> float:
        total = self.task.total_pieces or 0
        if total <= 0:
            return 1.0 if self.fsm.is_(PEER_SUCCEEDED) else 0.0
        return self.finished_pieces.count() / total

    def add_piece_cost(self, ms: float) -> None:
        self.piece_costs_ms.append(ms)
        # value first, version bump second: a concurrent reader that observes
        # the new feat_version must also observe the new average (the reverse
        # order could cache a stale mean under the new version key forever)
        self.piece_cost_avg_ms = sum(self.piece_costs_ms) / len(self.piece_costs_ms)
        self.bump_feat()
        self.touch()

    _DEPTH_MEMO_TTL_S = 1.0

    def depth(self) -> int:
        """Distance to a DAG root (seed/back-to-source peer), memoized per
        feature version WITH a 1 s TTL: edge changes bump only the direct
        child's version, so an idle grandchild's ancestry can change without
        a bump — and depth gates the hard max_tree_depth filter, so its
        staleness must be time-bounded, not unbounded."""
        ver, cached, at = self._depth_memo
        if ver == self.feat_version and self._clock.monotonic() - at < self._DEPTH_MEMO_TTL_S:
            return cached
        depth, cur = 1, self
        seen = {self.id}
        while True:
            parents = self.task.parents_of(cur.id)
            if not parents:
                break
            nxt = parents[0]
            if nxt.id in seen or depth > 10:
                break
            seen.add(nxt.id)
            cur = nxt
            depth += 1
        self._depth_memo = (self.feat_version, depth, self._clock.monotonic())
        return depth

    def touch(self) -> None:
        self.updated_at = self._clock.monotonic()


class Task:
    """A content-addressed object being distributed (ref task.go:105-169)."""

    def __init__(
        self,
        task_id: str,
        url: str,
        *,
        digest: str = "",
        tag: str = "",
        application: str = "",
        filters: tuple[str, ...] = (),
        clock: clockmod.Clock | None = None,
    ):
        self._clock = clock or clockmod.SYSTEM
        self.id = task_id
        self.url = url
        self.digest = digest
        self.tag = tag
        self.application = application
        self.filters = filters
        self.fsm = FSM(TASK_PENDING, _TASK_EVENTS)
        self.content_length: int | None = None
        self.piece_size: int = 0
        self.total_pieces: int | None = None
        self.direct_piece: bytes = b""  # TINY scope payload
        self.dag: DAG[Peer] = DAG()
        self.back_to_source_budget = 3  # concurrent back-source peers (ref constants.go:66-70)
        # live count of peers in PEER_BACK_TO_SOURCE, maintained by the peer
        # FSM callback (Peer._on_transition) + delete_peer below — the O(1)
        # read can_back_to_source() takes on the per-candidate hot path
        self._back_to_source_active = 0
        # see Host._mirror: DAG edge mutations push the child's full ordered
        # parent list as a native delta when a MirrorClient is attached
        self._mirror = None
        self._mirror_slot = -1
        self.created_at = self._clock.monotonic()
        self.updated_at = self.created_at

    @property
    def state(self) -> str:
        return self.fsm.current

    def size_scope(self) -> SizeScope:
        return SizeScope.of(self.content_length, self.piece_size or compute_piece_size(self.content_length or 0))

    def set_metadata(self, content_length: int, piece_size: int | None = None) -> None:
        new_piece_size = piece_size or compute_piece_size(content_length)
        new_total = piece_count(content_length, new_piece_size)
        if new_total != self.total_pieces:
            # piece ratios are relative to total_pieces — but only a REAL
            # change invalidates (announce_task re-sets identical metadata on
            # every announce; bumping then would defeat the feature-row cache
            # and cost an O(peers) walk per announce)
            for p in self.dag.values():
                p.bump_feat()
        self.content_length = content_length
        self.piece_size = new_piece_size
        self.total_pieces = new_total
        self.touch()

    # ---- peer DAG (ref task.go AddPeerEdge/DeletePeerInEdges) ----

    def add_peer(self, peer: Peer) -> None:
        self.dag.add_vertex(peer.id, peer)
        peer.host.peer_ids.add(peer.id)

    def delete_peer(self, peer_id: str) -> None:
        try:
            peer = self.dag.vertex(peer_id).value
            peer.host.peer_ids.discard(peer_id)
            # a row deleted WHILE in back_to_source never fires another
            # event, so the FSM callback can't release its budget slot
            if peer.fsm.is_(PEER_BACK_TO_SOURCE):
                self._back_to_source_active = max(0, self._back_to_source_active - 1)
        except VertexNotFound:
            pass
        self.dag.delete_vertex(peer_id)

    def peer(self, peer_id: str) -> Peer | None:
        try:
            return self.dag.vertex(peer_id).value
        except VertexNotFound:
            return None

    def peers(self) -> list[Peer]:
        return list(self.dag.values())

    def peer_count(self) -> int:
        return len(self.dag)

    def add_edge(self, parent_id: str, child_id: str) -> None:
        self.dag.add_edge(parent_id, child_id)
        parent = self.peer(parent_id)
        if parent:
            parent.host.concurrent_uploads += 1
            parent.host.bump_feat()
            parent.bump_feat()  # children count changed
        child = self.peer(child_id)
        if child:
            child.bump_feat()  # depth changed
        m = self._mirror
        if m is not None:
            m.on_edges(self, child_id)

    def can_add_edge(self, parent_id: str, child_id: str) -> bool:
        return self.dag.can_add_edge(parent_id, child_id)

    def delete_parents(self, child_id: str) -> None:
        try:
            for pid in list(self.dag.vertex(child_id).parents):
                parent = self.peer(pid)
                if parent:
                    parent.host.concurrent_uploads = max(0, parent.host.concurrent_uploads - 1)
                    parent.host.bump_feat()
                    parent.bump_feat()  # children count changed
            self.dag.delete_in_edges(child_id)
            child = self.peer(child_id)
            if child:
                child.bump_feat()  # depth changed
            m = self._mirror
            if m is not None:
                m.on_edges(self, child_id)
        except VertexNotFound:
            pass

    def parents_of(self, peer_id: str) -> list[Peer]:
        # snapshotted under the DAG's own lock: dispatcher worker threads
        # walk ancestry (depth(), lineage context) while the event loop
        # commits/retires edges
        try:
            return self.dag.parent_values(peer_id)
        except VertexNotFound:
            return []

    def children_of(self, peer_id: str) -> list[Peer]:
        try:
            return self.dag.child_values(peer_id)
        except VertexNotFound:
            return []

    _AVAILABLE_STATES = (PEER_RUNNING, PEER_BACK_TO_SOURCE, PEER_SUCCEEDED)

    def has_available_peer(self, blocklist: set[str] = frozenset()) -> bool:
        # early-exit scan without copying the vertex list (DAG.first_match):
        # this runs per registration against tasks that hold 10^5 peers in a
        # flash crowd, and the first vertex (the seed) usually answers it
        states = self._AVAILABLE_STATES
        return (
            self.dag.first_match(
                lambda p: p.id not in blocklist and p.fsm.current in states
            )
            is not None
        )

    def can_back_to_source(self) -> bool:
        # O(1): the counter is maintained by the peer FSM callback and
        # delete_peer — this runs per scheduling round at flash-crowd scale,
        # where a full-DAG scan was O(N²) across the crowd
        return self._back_to_source_active < self.back_to_source_budget

    def touch(self) -> None:
        self.updated_at = self._clock.monotonic()


# ---- managers with TTL GC (ref peer_manager.go / task_manager.go / host_manager.go) ----


@dataclass
class GCPolicy:
    """Reference defaults: peer TTL 24h, task 30min idle, host 6h idle
    (scheduler/config/constants.go:81-93)."""

    peer_ttl: float = 24 * 3600
    task_ttl: float = 30 * 60
    host_ttl: float = 6 * 3600


class ResourcePool:
    """Hosts + tasks + peers with shared GC; the scheduler's world state."""

    def __init__(
        self,
        gc_policy: GCPolicy | None = None,
        *,
        clock: clockmod.Clock | None = None,
    ):
        self.hosts: dict[str, Host] = {}
        self.tasks: dict[str, Task] = {}
        self._peer_index: dict[str, Peer] = {}
        # host-list snapshot for bounded random draws (probe-target
        # selection): appended in place on create, invalidated on delete —
        # same idiom as DAG._vlist (rebuilding per read was O(hosts) per
        # probe round at 10^5 hosts)
        self._host_list: list[Host] | None = None
        self.gc_policy = gc_policy or GCPolicy()
        # Injectable time source (utils/clock.py): production = the system
        # clock; the swarm simulator injects a VirtualClock so TTL sweeps
        # and freshness windows run in simulated time. Hosts/tasks created
        # here carry it; peers inherit their host's.
        self.clock = clock or clockmod.SYSTEM
        # Native-mirror client (scheduler.mirror.MirrorClient) — set by
        # MirrorClient.attach; object lifecycle events then mirror natively
        self._mirror = None

    # hosts
    def load_or_create_host(self, host_id: str, ip: str, hostname: str, **kw: Any) -> Host:
        host = self.hosts.get(host_id)
        if host is None:
            host = Host(host_id, ip, hostname, clock=self.clock, **kw)
            self.hosts[host_id] = host
            if self._host_list is not None:
                self._host_list.append(host)
            if self._mirror is not None:
                self._mirror.on_host_feat(host)  # registers + first upsert
        host.touch()
        return host

    def host_values(self) -> list[Host]:
        """Indexable host snapshot (probe-target sampling); O(1) amortized —
        rebuilt only after a host delete."""
        if self._host_list is None or len(self._host_list) != len(self.hosts):
            self._host_list = list(self.hosts.values())
        return self._host_list

    def delete_host(self, host_id: str) -> None:
        host = self.hosts.pop(host_id, None)
        if host is not None:
            self._host_list = None
            if self._mirror is not None:
                self._mirror.on_host_remove(host)

    # tasks
    def load_or_create_task(self, task_id: str, url: str, **kw: Any) -> Task:
        task = self.tasks.get(task_id)
        if task is None:
            task = Task(task_id, url, clock=self.clock, **kw)
            self.tasks[task_id] = task
            if self._mirror is not None:
                self._mirror.on_task_create(task)
        task.touch()
        return task

    # peers
    def create_peer(self, peer_id: str, task: Task, host: Host) -> Peer:
        existing = task.peer(peer_id)
        if existing is not None:
            return existing
        peer = Peer(peer_id, task, host)
        task.add_peer(peer)
        self._peer_index[peer_id] = peer
        if self._mirror is not None:
            self._mirror.on_peer_create(peer)
        return peer

    def peer(self, peer_id: str) -> Peer | None:
        return self._peer_index.get(peer_id)

    def peer_count(self) -> int:
        return len(self._peer_index)

    def delete_peer(self, peer_id: str) -> None:
        peer = self._peer_index.pop(peer_id, None)
        if peer is not None:
            peer.task.delete_parents(peer_id)
            # release upload slots this peer held as a parent
            for child in peer.task.children_of(peer_id):
                peer.host.concurrent_uploads = max(0, peer.host.concurrent_uploads - 1)
                child.bump_feat()  # its depth chain changed
            peer.host.bump_feat()
            peer.task.delete_peer(peer_id)
            # AFTER the DAG detach: the native remove drops the slot from
            # every adjacency list in place (sibling order preserved, same
            # as the DAG's set-discard semantics)
            if self._mirror is not None:
                self._mirror.on_peer_delete(peer)

    def gc(self) -> dict[str, int]:
        """TTL sweep; returns counts removed (wired into utils.gcreg)."""
        now = self.clock.monotonic()
        removed = {"peers": 0, "tasks": 0, "hosts": 0}
        for pid, peer in list(self._peer_index.items()):
            expired = now - peer.updated_at > self.gc_policy.peer_ttl
            if expired or peer.fsm.is_(PEER_LEAVE):
                self.delete_peer(pid)
                removed["peers"] += 1
        for tid, task in list(self.tasks.items()):
            if task.peer_count() == 0 and now - task.updated_at > self.gc_policy.task_ttl:
                del self.tasks[tid]
                if self._mirror is not None:
                    self._mirror.on_task_remove(task)
                removed["tasks"] += 1
        for hid, host in list(self.hosts.items()):
            if not host.peer_ids and now - host.updated_at > self.gc_policy.host_ttl:
                self.delete_host(hid)
                removed["hosts"] += 1
        return removed
