"""Discrete-event engine driving the REAL control plane at 10^5+ peers (the
port's own copy of dragonfly2_tpu/sim/engine.py).

One binary min-heap of (virtual time, seq, kind, payload) events; one
VirtualClock shared by the engine, the asyncio loop (sim.clockloop), and
every SchedulerService under simulation. Events are processed strictly in
heap order and each handler is awaited to completion before the next pops —
a handler that awaits a scheduler-side backoff advances virtual time through
the loop's timer heap, so retry pacing inside `schedule_candidate_parents`
costs simulated (not wall) time.

What is real and what is modeled:

  REAL     SchedulerService, Scheduling (filters, retry/backoff, DAG
           commits), MLEvaluator feature assembly + scoring, ResourcePool
           TTL GC, NetworkTopology probe ingest, FederationSync push-pull
           gossip, telemetry record emission — the exact objects production
           serves with, reached through the existing InProcessSchedulerClient
           over a consistent-hash ring (the balancer's placement semantics).
  MODELED  the data plane: a piece transfer is a completion-time computed
           from the synthetic topology (per-flow link caps, the parent's
           LIVE upload-slot occupancy read off the scheduler's own Host row,
           and the parent's own completion time for streaming children);
           origin fetches ride a per-region origin-rate model.

Known approximation (documented, deliberate): handlers are serialized, so N
peers backing off "concurrently" serialize their virtual backoffs instead of
overlapping them — control-plane latency under deep overload is pessimistic.
Events the clock has passed (a handler advanced time beyond a scheduled
event) execute tardily at the current now; the heap keeps order, time never
runs backward.
"""

from __future__ import annotations

import heapq
import time as _walltime
from dataclasses import dataclass, field
from typing import Any, Callable

from dragonfly2_tpu_torch.scheduler.evaluator import new_evaluator
from dragonfly2_tpu_torch.scheduler.resource import GCPolicy
from dragonfly2_tpu_torch.scheduler.service import HostInfo, SchedulerService, TaskMeta
from dragonfly2_tpu_torch.sim import metrics as sim_metrics
from dragonfly2_tpu_torch.sim.clockloop import run_virtual
from dragonfly2_tpu_torch.sim.topology import Placement, SyntheticTopology, TopologyConfig
from dragonfly2_tpu_torch.sim.workload import TaskSpec, Workload, WorkloadConfig
from dragonfly2_tpu_torch.utils.clock import VirtualClock


@dataclass
class SimConfig:
    schedulers: int = 1
    seed: int = 0
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    evaluator: str = "ml"  # the real MLEvaluator (base-fallback until a model attaches)
    # ---- scoring plane (the native round driver at sim scale) ----
    # "base": no model attached — the evaluator serves its numpy fallback
    #         (HEAD behavior; the placement-quality scenario checks assume it).
    # "ml-serial": a synthetic native scorer attaches and every round scores
    #         through the per-round Python loop.
    # "ml-native": same model, but rounds ride df_round_drive — the A/B twin
    #         proving the driver at 10^5-peer scale: placement is bit-exact vs
    #         ml-serial for the same seed, only sched_rounds_per_s moves.
    # Both ml modes degrade to "base" (with a warning) when the native
    # toolchain is unavailable — the sim never hard-requires g++.
    scoring: str = "base"
    telemetry_dir: str | None = None  # None: no record capture (pure control-plane run)
    telemetry_rotate_rows: int = 16384
    federation_interval_s: float = 2.0
    gc_interval_s: float = 0.0  # 0: no TTL sweeps scheduled
    gc_policy: GCPolicy | None = None
    sample_interval_s: float = 0.0  # timeseries sampling cadence (0: off)
    max_virtual_s: float = 24 * 3600.0
    drain_grace_s: float = 1800.0  # after the last arrival, let transfers finish
    register_retry_limit: int = 3  # sim-peer re-register attempts after empty rounds
    reschedule_limit: int = 2  # mid-transfer parent-loss recoveries per peer
    bucket_s: float = 10.0  # per-interval stats resolution
    stream_lag_s: float = 0.1  # child completes this long after a still-running parent
    # ---- graceful degradation under overload ----
    # modeled scheduler service time per registration (0 = instant): requests
    # queue behind a per-scheduler busy horizon, and that backlog is exactly
    # what the REAL DegradationController's queue-depth probe reads
    register_cost_ms: float = 0.0
    # modeled client deadline: a register whose queue wait exceeds it "times
    # out" (the server still burns the service time on the dead request — the
    # storm amplifier admission control exists to cut) and retries later
    register_timeout_s: float = 0.0
    degradation: bool = False  # attach the real brownout ladder per scheduler
    degradation_queue_budget: float = 64.0
    degradation_sustain_s: float = 3.0
    degradation_cool_s: float = 10.0
    degradation_interval_s: float = 1.0
    overload_retry_limit: int = 20  # overloaded/timeout re-registers before giving up
    gray_uplink_frac: float = 0.03  # a gray parent serves at this uplink fraction
    # modeled manager plane: keepalive agents probing a manager that scenario
    # control events blackout()/restore(); 0 agents = plane off
    keepalive_agents: int = 0
    keepalive_interval_s: float = 20.0
    keepalive_horizon_s: float = 600.0
    # True: every agent's first keepalive fires at the SAME instant (a fleet
    # restarted by one deploy — the worst case for rejoin thundering herds);
    # False: initial phases staggered across one interval
    keepalive_sync_start: bool = False


@dataclass
class SimReport:
    scenario: str = ""
    peers: int = 0
    events: int = 0
    wall_s: float = 0.0
    virtual_s: float = 0.0
    events_per_sec: float = 0.0
    time_compression: float = 0.0
    registered: int = 0
    completed: int = 0
    failed: int = 0
    refused: int = 0
    back_to_source: int = 0
    reschedules: int = 0
    departed: int = 0
    crashed: int = 0
    # placement quality (scheduling-time, against the synthetic ground truth)
    rounds_with_parents: int = 0
    parents_assigned: int = 0
    same_region_frac: float = 0.0
    same_rack_frac: float = 0.0
    mean_parent_rtt_ms: float = 0.0
    # byte accounting
    origin_egress_bytes: dict[str, int] = field(default_factory=dict)
    p2p_bytes: int = 0
    cross_region_bytes: int = 0
    fairness_jain: float = 0.0
    departed_parent_rounds: int = 0
    federation: dict[str, Any] = field(default_factory=dict)
    per_scheduler: list[dict] = field(default_factory=list)
    gc_removed: dict[str, int] = field(default_factory=dict)
    buckets: list[dict] = field(default_factory=list)
    dataset: dict[str, Any] | None = None
    # overload / degradation plane
    overload_refused: int = 0  # typed `overloaded` answers received
    overload_retries: int = 0  # re-registers scheduled after refusal/timeout
    register_timeouts: int = 0  # modeled client-deadline expiries in queue
    admitted_p50_ms: float = 0.0  # arrival -> successful admission latency
    admitted_p99_ms: float = 0.0
    shed_by_class: dict[str, int] = field(default_factory=dict)
    gray_peers: int = 0
    degradation: dict[str, Any] = field(default_factory=dict)
    manager: dict[str, Any] = field(default_factory=dict)
    # scoring plane: which scoring mode actually served (may read
    # "base" after an ml-* request degraded for lack of a toolchain), rounds
    # through schedule_candidate_parents across all schedulers, seconds spent
    # inside them (local schedule_duration histograms), and the quotient —
    # the sim-scale scheduler rounds/s the native driver is accountable to
    scoring: str = "base"
    sched_rounds: int = 0
    sched_s: float = 0.0
    sched_rounds_per_s: float = 0.0
    native_rounds: int = 0
    # rounds the mirrored peer table drove (cached-row fast path /
    # stale-revalidated — both run sample+filter+score in C and count toward
    # native_rounds coverage) and the full-export counter, which must stay at
    # 1 per scheduler (the attach): steady state is deltas or it's a bug
    mirror_rounds: int = 0
    mirror_stale_rounds: int = 0
    mirror_full_syncs: int = 0


class _SimPeer:
    __slots__ = (
        "index", "peer_id", "host_id", "placement", "task", "host_info",
        "state", "parents", "rate_bps", "attempts", "reschedules",
        "alive", "crashed_flag", "probe_targets", "probes_left", "finish_at",
        "priority", "gray", "arrived_at", "overload_attempts",
    )

    def __init__(self, index: int, task: TaskSpec, placement: Placement):
        self.index = index
        self.peer_id = f"sim-p{index:07d}"
        self.host_id = f"sim-h{index:07d}"
        self.placement = placement
        self.task = task
        self.host_info = HostInfo(
            id=self.host_id,
            ip=f"10.{(index >> 16) & 255}.{(index >> 8) & 255}.{index & 255}",
            hostname=f"sim-{index}",
            download_port=18000 + (index % 40000),
            idc=placement.idc,
            location=placement.location,
        )
        self.state = "arriving"
        self.parents: list = []
        self.rate_bps = 0.0
        self.attempts = 0
        self.reschedules = 0
        self.alive = True
        self.crashed_flag = False
        self.probe_targets: list = []
        self.probes_left = 0
        self.finish_at = 0.0
        self.priority = 1.0  # traffic-shaper class (admission sheds lowest first)
        self.gray = False  # gray parent: uplink capped at gray_uplink_frac
        self.arrived_at = 0.0  # set on arrival; -1 once admission latency counted
        self.overload_attempts = 0


class _KeepaliveAgent:
    """One modeled manager-link client (a daemon or scheduler keepalive loop).

    Carries exactly the attributes ManagerLink._rejoin_delay reads (hostname,
    keepalive_interval), so the rejoin spread the blackout scenarios measure
    is the PRODUCTION jitter function, not a sim reimplementation."""

    __slots__ = ("hostname", "keepalive_interval", "failures", "unreachable")

    def __init__(self, index: int, interval: float):
        self.hostname = f"sim-agent-{index:05d}"
        self.keepalive_interval = interval
        self.failures = 0
        self.unreachable = False


class _LoopbackFederationClient:
    """federation_sync straight into a peer SchedulerService — no sockets.
    Partition state lives on the simulation: a severed pair raises the same
    ConnectionError a blackholed wire peer would."""

    def __init__(self, sim: "Simulation", src: str, dst: str):
        self._sim = sim
        self._src = src
        self._dst = dst

    async def federation_sync(self, origin: str, **kw):
        if self._sim.is_partitioned(self._src, self._dst):
            raise ConnectionError(f"simulated partition {self._src} <-> {self._dst}")
        return self._sim.services[self._dst].federation_sync(origin, **kw)

    async def close(self):
        return None


class Simulation:
    """One configured simulation run: cluster + workload + event heap."""

    def __init__(self, config: SimConfig | None = None, *, scenario: str = ""):
        from dragonfly2_tpu_torch.daemon.engine import InProcessSchedulerClient
        from dragonfly2_tpu_torch.rpc.balancer import ConsistentHashRing
        from dragonfly2_tpu_torch.scheduler.federation import FederationSync

        self.config = config or SimConfig()
        self.scenario = scenario
        self.clock = VirtualClock()
        self.topology = SyntheticTopology(self.config.topology, seed=self.config.seed)
        self.workload = Workload(self.config.workload, seed=self.config.seed + 1)

        # ---- the real cluster, in-process ----
        self.names = [f"sim-sch-{i}" for i in range(max(1, self.config.schedulers))]
        self.services: dict[str, SchedulerService] = {}
        self._telemetry = {}
        self._scoring = self.config.scoring
        self._scorers: list[Any] = []  # native handles to close after run()
        self._scorer_artifact: str | None = None
        if self._scoring not in ("base", "ml-serial", "ml-native"):
            raise ValueError(f"unknown scoring mode {self._scoring!r}")
        if self._scoring != "base":
            import tempfile

            self._scorer_artifact = _synthetic_scorer_artifact(
                tempfile.mktemp(prefix="dfsim-scorer-", suffix=".dfsc"),
                seed=self.config.seed,
            )
            # one model load for the whole cluster: each service attaches a
            # fork (shared weights, private handle). A missing toolchain
            # degrades the RUN to base scoring here — before any service is
            # built — so every member sees the same round_driver config.
            try:
                from dragonfly2_tpu_torch.native import NativeScorer

                self._scorers.append(NativeScorer(self._scorer_artifact))
            except Exception as e:  # noqa: BLE001 — no g++: degrade, honestly
                import logging

                logging.getLogger(__name__).warning(
                    "sim scoring %s degraded to base (%r)", self._scoring, e
                )
                self._scoring = "base"
        for i, name in enumerate(self.names):
            telemetry = None
            if self.config.telemetry_dir is not None:
                from dragonfly2_tpu_torch.telemetry import TelemetryStorage

                telemetry = TelemetryStorage(
                    f"{self.config.telemetry_dir}/{name}",
                    rotate_rows=self.config.telemetry_rotate_rows,
                )
                self._telemetry[name] = telemetry
            import random as _random

            svc = SchedulerService(
                evaluator=new_evaluator(self.config.evaluator),
                telemetry=telemetry,
                gc_policy=self.config.gc_policy,
                clock=self.clock,
                scheduling_config=self._scheduling_config(),
                # seeded per member: probe-target draws (and so the probe
                # telemetry and the bridged dataset) replay bit-identically
                # for a given SimConfig.seed
                topology_rng=_random.Random(self.config.seed * 1009 + i),
            )
            # One peer per simulated host and every (parent, child-host) pair
            # is scheduled at most once, so the evaluator's pair-row cache can
            # only cost memory here (O(rounds × candidates) rows at 10^5
            # peers, measured ~1 GB) — disable it; the static-row cache stays.
            svc.evaluator.feature_builder = _uncached_pair_features
            self._attach_sim_scorer(svc)
            self.services[name] = svc
        self.ring = ConsistentHashRing(self.names)
        self.clients = {
            name: InProcessSchedulerClient(svc) for name, svc in self.services.items()
        }
        self.federation: dict[str, Any] = {}
        if len(self.names) > 1:
            for name in self.names:
                self.federation[name] = FederationSync(
                    self.services[name],
                    self_addr=name,
                    name=name,
                    peers=[n for n in self.names if n != name],
                    client_factory=lambda addr, src=name: _LoopbackFederationClient(
                        self, src, addr
                    ),
                )
        self._severed: set[frozenset] = set()

        # ---- overload / degradation plane ----
        import random as _random

        self._rng = _random.Random(self.config.seed + 2)  # retry jitter draws
        self._busy_until: dict[str, float] = {n: 0.0 for n in self.names}
        self._admit_waits: list[float] = []
        self._deg_max = 0
        self.degradation_controllers: dict[str, Any] = {}
        if self.config.degradation:
            from dragonfly2_tpu_torch.scheduler.degradation import DegradationController

            # the REAL ladder, fed by the MODELED register backlog: depth =
            # queued registrations behind this scheduler's busy horizon
            cost_s = max(self.config.register_cost_ms, 0.001) / 1000.0
            for name in self.names:
                ctrl = DegradationController(
                    queue_depth=lambda n=name: max(
                        0.0, (self._busy_until[n] - self.clock.monotonic()) / cost_s
                    ),
                    queue_budget=self.config.degradation_queue_budget,
                    sustain_s=self.config.degradation_sustain_s,
                    cool_s=self.config.degradation_cool_s,
                )
                self.services[name].attach_degradation(ctrl)
                self.degradation_controllers[name] = ctrl
        # modeled manager plane (blackout scenarios)
        self.manager_down = False
        self._agents: list[_KeepaliveAgent] = []
        self._mgr_stats = {"unreachable_declared": 0, "recovered": 0, "rejoined": 0}

        # ---- event heap + run state ----
        self._heap: list[tuple[float, int, str, Any]] = []
        self._seq = 0
        self._pending_work = 0  # non-periodic events in the heap (O(1) drain check)
        self._last_arrival_s = 0.0
        self.report = SimReport(scenario=scenario)
        self._peers: list[_SimPeer] = []
        self._peers_by_pid: dict[str, _SimPeer] = {}
        self._placements: dict[str, Placement] = {}
        self._departed_pids: set[str] = set()
        self._live = 0
        self._rtt_sum = 0.0
        self._same_region = 0
        self._same_rack = 0
        self._buckets: dict[int, dict] = {}
        self._fed_history: list[dict] = []
        self._recorder = None
        if self.config.sample_interval_s > 0:
            from dragonfly2_tpu_torch.observability.timeseries import MetricsRecorder

            # fresh recorder (not the process default): only this run's
            # samples land in it, stamped with VIRTUAL wall time so scenario
            # assertions are windowed-rate queries in simulated time
            self._recorder = MetricsRecorder(interval=self.config.sample_interval_s)

    # ---- public control surface (scenarios schedule through these) ----

    @property
    def recorder(self):
        return self._recorder

    def at(self, t_s: float, fn: Callable[[], Any]) -> None:
        """Run `fn` (sync or async) at virtual time t — scenario control
        events (partition, heal, parameter flips)."""
        self._push(t_s, "control", fn)

    def partition(self, a: str, b: str) -> None:
        self._severed.add(frozenset((a, b)))

    def heal(self, a: str, b: str) -> None:
        self._severed.discard(frozenset((a, b)))

    def blackout(self) -> None:
        """Take the modeled manager down (keepalive agents start failing)."""
        self.manager_down = True

    def restore(self) -> None:
        self.manager_down = False

    def is_partitioned(self, a: str, b: str) -> bool:
        return frozenset((a, b)) in self._severed

    def preseed(self, task: TaskSpec, region: str, count: int = 1) -> None:
        """Announce `count` completed seed holders of `task` in `region`
        (the dfcache-import / crash-rejoin announce path, no transfer)."""
        for _ in range(count):
            sp = self._new_peer(task, region=region)
            sp.state = "seeded"
            client = self._for_task(task.task_id)
            self._run_sync(
                client.announce_task(
                    sp.peer_id,
                    TaskMeta(task.task_id, task.url),
                    sp.host_info,
                    content_length=task.content_length,
                    piece_size=task.piece_size,
                    piece_indices=list(range(task.total_pieces)),
                )
            )

    @staticmethod
    def _run_sync(coro) -> Any:
        """Drive an InProcess-client coroutine that never truly suspends
        (announce/report verbs) without an event loop — preseeding happens
        before run()."""
        try:
            coro.send(None)
        except StopIteration as stop:
            return stop.value
        raise RuntimeError("coroutine suspended outside the simulation loop")

    # ---- internals ----

    def _push(self, t_s: float, kind: str, payload: Any) -> None:
        self._seq += 1
        if kind not in self._PERIODIC:
            self._pending_work += 1
        heapq.heappush(self._heap, (t_s, self._seq, kind, payload))

    def _for_task(self, task_id: str):
        return self.clients[self.ring.pick(task_id)]

    def _scheduling_config(self):
        """round_driver pins the A/B leg: ml-native routes the sim's async
        rounds through df_round_drive one-round batches, ml-serial pins the
        per-round Python loop on the SAME attached model. Everything else
        (filters, rng, retries) is the shared default config."""
        from dragonfly2_tpu_torch.scheduler.scheduling import SchedulingConfig

        if self._scoring == "ml-native":
            return SchedulingConfig(round_driver="native")
        if self._scoring == "ml-serial":
            return SchedulingConfig(round_driver="serial")
        return None

    def _attach_sim_scorer(self, svc: SchedulerService) -> None:
        """Attach a fork of the synthetic native model (ml-* scoring modes):
        shared weights, one handle per service."""
        if self._scoring == "base" or not self._scorers:
            return
        scorer = self._scorers[0].fork()
        self._scorers.append(scorer)
        svc.evaluator.attach_scorer(
            scorer, _ModNodeIndex(scorer.num_nodes), version="sim-synthetic"
        )
        if self._scoring == "ml-native":
            # the native leg rides the mirrored peer table — the
            # sim's registration/departure churn streams deltas through the
            # resource-pool hooks, and rounds sample+filter natively. Row
            # caching stays cold here (each (parent, child-host) pair is
            # scheduled at most once AND the uncached builder is active, so
            # the stale leg's serial scoring is the steady state) — the win
            # is the snapshot/sample/filter leg leaving Python.
            svc.enable_native_mirror()

    def _for_host(self, host_id: str):
        return self.clients[self.ring.pick(host_id)]

    def _new_peer(self, task: TaskSpec, region: str | None = None) -> _SimPeer:
        placement = self.topology.place(region)
        sp = _SimPeer(len(self._peers), task, placement)
        sp.priority = self.workload.draw_priority()
        sp.gray = self.workload.is_gray()
        if sp.gray:
            self.report.gray_peers += 1
        self._peers.append(sp)
        self._peers_by_pid[sp.peer_id] = sp
        self._placements[sp.host_id] = placement
        return sp

    def _bucket(self) -> dict:
        b = int(self.clock.monotonic() // self.config.bucket_s)
        d = self._buckets.get(b)
        if d is None:
            d = self._buckets[b] = {
                "t_s": b * self.config.bucket_s,
                "arrivals": 0, "rounds": 0, "parents": 0, "same_region": 0,
                "completions": 0, "back_to_source": 0,
                "origin_bytes": 0, "p2p_bytes": 0,
                "refused_overload": 0, "keepalives": 0, "rejoins": 0,
            }
        return d

    # ---- event handlers ----

    async def _on_arrival(self, sp: _SimPeer) -> None:
        self._live += 1
        sim_metrics.SIM_PEERS.set(float(self._live))
        self._bucket()["arrivals"] += 1
        sp.arrived_at = self.clock.monotonic()
        # the daemon keepalive's host announce, to the host's ring owner:
        # probe rounds route there (federation shards probe ingest by source
        # host), so that member must know the host to hand out targets
        await self._for_host(sp.host_id).announce_host(sp.host_info)
        await self._register(sp)

    async def _register(self, sp: _SimPeer) -> None:
        rep = self.report
        cfg = self.config
        task = sp.task
        now = self.clock.monotonic()
        name = self.ring.pick(task.task_id)
        client = self.clients[name]
        # modeled service time: registrations queue behind this
        # scheduler's busy horizon; the degradation controller's queue-depth
        # probe reads exactly this backlog
        cost_s = cfg.register_cost_ms / 1000.0
        wait = 0.0
        if cost_s > 0:
            wait = max(0.0, self._busy_until[name] - now)
            if cfg.register_timeout_s > 0 and wait > cfg.register_timeout_s:
                # the client's deadline expired in queue. The server still
                # burns service time on the dead request — UNLESS the ladder's
                # admission rung is up, in which case the request gets the
                # cheap typed shed answer instead of full processing. This is
                # the retry-storm amplifier the brownout ladder exists to cut.
                deg = self.services[name].degradation
                cheap = deg is not None and deg.admission_control
                self._busy_until[name] = now + wait + cost_s * (0.1 if cheap else 1.0)
                rep.register_timeouts += 1
                self._requeue_register(
                    sp, now + cfg.register_timeout_s * (1.0 + self._rng.random())
                )
                return
        res = await client.register_peer(
            sp.peer_id,
            TaskMeta(task.task_id, task.url, priority=sp.priority),
            sp.host_info,
        )
        rep.registered += 1
        if res.error == "overloaded":
            # the typed brownout answer: costs one priority compare server-
            # side; the retry_after_s hint schedules the comeback (jittered
            # UP only, like the real conductor's _register_admitted)
            if cost_s > 0:
                self._busy_until[name] = max(now, self._busy_until[name]) + cost_s * 0.1
            rep.overload_refused += 1
            cls = f"{sp.priority:g}"
            rep.shed_by_class[cls] = rep.shed_by_class.get(cls, 0) + 1
            self._bucket()["refused_overload"] += 1
            retry_after = max(float(getattr(res, "retry_after_s", 0.0)), 0.5)
            self._requeue_register(
                sp, now + retry_after * (1.0 + 0.5 * self._rng.random())
            )
            return
        if cost_s > 0:
            self._busy_until[name] = max(now, self._busy_until[name]) + cost_s
        if res.error:
            rep.refused += 1
            sp.state = "failed"
            return
        if sp.arrived_at >= 0:
            # first successful admission: arrival -> admitted latency, once
            self._admit_waits.append((now - sp.arrived_at) + wait + cost_s)
            sp.arrived_at = -1.0
        if res.back_to_source:
            sp.state = "origin"
            rep.back_to_source += 1
            self._bucket()["back_to_source"] += 1
            # the real daemon learns the length from the origin's first
            # response within ~one RTT; report it now so later registrations
            # see real task metadata (size scope, piece math)
            await client.report_task_metadata(
                task.task_id,
                content_length=task.content_length,
                piece_size=task.piece_size,
            )
            rate = self.topology.origin_rate_bps(sp.placement)
            sp.rate_bps = rate
            sp.finish_at = self.clock.monotonic() + task.content_length / rate
            self._push(sp.finish_at, "origin_done", sp)
            return
        if res.scope in ("empty", "tiny"):
            # content rode the register response itself; no transfer to model
            sp.state = "seeded"
            rep.completed += 1
            self._bucket()["completions"] += 1
            return
        if res.parents:
            self._note_placement(sp, res.parents)
            self._start_transfer(sp, res.parents)
            return
        # empty round (retries exhausted inside the scheduler): the real
        # daemon keeps the task alive and re-registers; cap the attempts
        sp.attempts += 1
        if sp.attempts <= self.config.register_retry_limit:
            self._push(self.clock.monotonic() + 2.0 * sp.attempts, "register", sp)
        else:
            sp.state = "failed"
            rep.failed += 1
            await client.report_peer_result(sp.peer_id, success=False)

    def _requeue_register(self, sp: _SimPeer, at_s: float) -> None:
        """Schedule a re-register after an overloaded answer or a modeled
        client timeout; gives up (peer failed) past overload_retry_limit."""
        sp.overload_attempts += 1
        if sp.overload_attempts > self.config.overload_retry_limit:
            sp.state = "failed"
            self.report.failed += 1
            return
        self.report.overload_retries += 1
        self._push(at_s, "register", sp)

    def _note_placement(self, sp: _SimPeer, parents: list) -> None:
        rep = self.report
        rep.rounds_with_parents += 1
        bucket = self._bucket()
        bucket["rounds"] += 1
        for pi in parents:
            if pi.peer_id in self._departed_pids:
                rep.departed_parent_rounds += 1
                sim_metrics.SIM_DEPARTED_PARENT_ROUNDS.inc()
            placement = self._placements.get(pi.host_id)
            if placement is None:
                continue
            rep.parents_assigned += 1
            bucket["parents"] += 1
            self._rtt_sum += self.topology.rtt_ms(sp.placement, placement)
            if placement.region == sp.placement.region:
                self._same_region += 1
                bucket["same_region"] += 1
                if placement.rack == sp.placement.rack:
                    self._same_rack += 1

    def _transfer_rate_bps(self, sp: _SimPeer, parents: list) -> float:
        """Aggregate child rate: per-parent flows capped by the path link
        and the parent's uplink divided by its LIVE upload-slot occupancy
        (read off the owning scheduler's Host row — the DAG itself models
        the contention), summed, then capped by the child downlink."""
        cfg = self.topology.config
        svc = self.services[self.ring.pick(sp.task.task_id)]
        total = 0.0
        for pi in parents:
            placement = self._placements.get(pi.host_id)
            if placement is None:
                continue
            host = svc.pool.hosts.get(pi.host_id)
            share = max(1, host.concurrent_uploads) if host is not None else 1
            # gray parent: alive and registered, but its uplink
            # serves at a crawl — the degradation the scheduler can only see
            # through bandwidth feedback, never through liveness
            parent_sp = self._peers_by_pid.get(pi.peer_id)
            uplink = cfg.uplink_bps * (
                self.config.gray_uplink_frac
                if parent_sp is not None and parent_sp.gray
                else 1.0
            )
            total += min(
                self.topology.link_bps(placement, sp.placement),
                uplink / share,
            )
        return min(cfg.downlink_bps, total) if total > 0 else cfg.downlink_bps * 0.01

    def _start_transfer(self, sp: _SimPeer, parents: list) -> None:
        sp.state = "downloading"
        sp.parents = list(parents)
        rate = self._transfer_rate_bps(sp, parents)
        sp.rate_bps = rate
        now = self.clock.monotonic()
        setup_s = max(
            (
                self.topology.rtt_ms(sp.placement, self._placements[pi.host_id])
                for pi in parents
                if pi.host_id in self._placements
            ),
            default=0.0,
        ) / 1000.0
        finish = now + setup_s + sp.task.content_length / rate
        # a still-downloading parent streams pieces as it lands them: the
        # child can finish only shortly after the slowest such parent does
        for pi in parents:
            parent_sp = self._peers_by_pid.get(pi.peer_id)
            if parent_sp is not None and parent_sp.state in ("downloading", "origin"):
                finish = max(finish, parent_sp.finish_at + self.config.stream_lag_s)
        sp.finish_at = finish
        self._push(finish, "transfer_done", sp)

    async def _finish_success(self, sp: _SimPeer, parent_ids: list[str]) -> None:
        task = sp.task
        client = self._for_task(task.task_id)
        pieces = task.total_pieces
        cost_ms = max(0.1, (task.content_length / sp.rate_bps) * 1000.0 / pieces)
        np_ = len(parent_ids)
        await client.report_pieces(
            sp.peer_id,
            [
                (i, cost_ms, parent_ids[i % np_] if np_ else "")
                for i in range(pieces)
            ],
        )
        await client.report_peer_result(
            sp.peer_id, success=True, bandwidth_bps=sp.rate_bps
        )
        sp.state = "seeded"
        self.report.completed += 1
        self._bucket()["completions"] += 1
        self._schedule_after_download(sp)

    async def _on_transfer_done(self, sp: _SimPeer) -> None:
        if not sp.alive:
            return
        dead = [
            pi for pi in sp.parents
            if (p := self._peers_by_pid.get(pi.peer_id)) is not None and not p.alive
        ]
        if dead and sp.reschedules < self.config.reschedule_limit:
            # parents died mid-transfer: report the failures (drives
            # block_parents) and run a real reschedule round
            sp.reschedules += 1
            self.report.reschedules += 1
            client = self._for_task(sp.task.task_id)
            for pi in dead:
                await client.report_piece_result(  # dflint: disable=DF025 the REAL conductor reports failures unary+promptly (failures never ride a batch); ≤4 in-process calls
                    sp.peer_id, 0, success=False, parent_id=pi.peer_id
                )
            res = await client.reschedule(sp.peer_id)
            if res.back_to_source:
                self.report.back_to_source += 1
                rate = self.topology.origin_rate_bps(sp.placement)
                sp.rate_bps = rate
                # roughly half the task survived the dead parents
                sp.finish_at = self.clock.monotonic() + 0.5 * sp.task.content_length / rate
                self._push(sp.finish_at, "origin_done", sp)
                sp.state = "origin"
                return
            if res.parents:
                self._note_placement(sp, res.parents)
                self._start_transfer(sp, res.parents)
                return
            sp.state = "failed"
            self.report.failed += 1
            await client.report_peer_result(sp.peer_id, success=False)
            return
        parent_ids = [pi.peer_id for pi in sp.parents if pi.peer_id not in
                      {d.peer_id for d in dead}] or [pi.peer_id for pi in sp.parents]
        nbytes = sp.task.content_length
        self.report.p2p_bytes += nbytes
        bucket = self._bucket()
        bucket["p2p_bytes"] += nbytes
        for pi in sp.parents:
            placement = self._placements.get(pi.host_id)
            if placement is not None and placement.region != sp.placement.region:
                self.report.cross_region_bytes += nbytes // max(1, len(sp.parents))
        await self._finish_success(sp, parent_ids)

    async def _on_origin_done(self, sp: _SimPeer) -> None:
        if not sp.alive:
            return
        nbytes = sp.task.content_length
        region = sp.placement.region
        self.report.origin_egress_bytes[region] = (
            self.report.origin_egress_bytes.get(region, 0) + nbytes
        )
        sim_metrics.SIM_ORIGIN_EGRESS_BYTES.inc(float(nbytes), region=region)
        self._bucket()["origin_bytes"] += nbytes
        await self._finish_success(sp, [])

    def _schedule_after_download(self, sp: _SimPeer) -> None:
        now = self.clock.monotonic()
        if self.workload.runs_probes():
            sp.probes_left = self.config.workload.probe_rounds
            self._push(now + 0.5, "probe", sp)
        lifetime = self.workload.lifetime_s()
        if lifetime is not None:
            self._push(now + lifetime, "depart", sp)

    async def _on_probe(self, sp: _SimPeer) -> None:
        if not sp.alive:
            return
        results = [
            {
                "dst_host_id": host_id,
                "rtt_ms": self.topology.rtt_ms(sp.placement, self._placements[host_id]),
                "success": True,
            }
            for host_id in sp.probe_targets
            if host_id in self._placements
        ]
        if results:
            sp.probes_left -= 1  # the first call only FETCHES targets
        client = self._for_host(sp.host_id)
        targets = await client.sync_probes(sp.host_id, results)
        sp.probe_targets = [t["host_id"] for t in targets]
        if sp.probes_left > 0 and sp.probe_targets:
            self._push(
                self.clock.monotonic() + self.config.workload.probe_interval_s,
                "probe", sp,
            )

    async def _on_depart(self, sp: _SimPeer) -> None:
        if not sp.alive:
            return
        sp.alive = False
        self._live -= 1
        sim_metrics.SIM_PEERS.set(float(self._live))
        if self.workload.departure_is_crash():
            # crash: no goodbye — the scheduler keeps a ghost row until
            # supersede/TTL GC (the restart suite's resurrection semantics)
            sp.crashed_flag = True
            self.report.crashed += 1
            return
        self.report.departed += 1
        self._departed_pids.add(sp.peer_id)
        client = self._for_task(sp.task.task_id)
        await client.leave_peer(sp.peer_id)
        for c in self.clients.values():
            await c.leave_host(sp.host_id)  # dflint: disable=DF025 broadcast to every ring member (each may hold rows for this host); in-process, N≤schedulers

    async def _on_fed_sync(self, _payload) -> None:
        ok = failed = 0
        for fed in self.federation.values():
            await fed.sync_once()
            ok += fed.syncs_ok
            failed += fed.syncs_failed
        self._fed_history.append(
            {
                "t_s": round(self.clock.monotonic(), 3),
                "remote_edges": [
                    self.services[n].topology.remote_edge_count() for n in self.names
                ],
                "syncs_ok": ok,
                "syncs_failed": failed,
            }
        )
        if self._heap_has_work():
            self._push(
                self.clock.monotonic() + self.config.federation_interval_s,
                "fed_sync", None,
            )

    async def _on_gc(self, _payload) -> None:
        for svc in self.services.values():
            removed = svc.pool.gc()
            for k, v in removed.items():
                self.report.gc_removed[k] = self.report.gc_removed.get(k, 0) + v
        if self._heap_has_work():
            self._push(self.clock.monotonic() + self.config.gc_interval_s, "gc", None)

    async def _on_sample(self, _payload) -> None:
        if self._recorder is not None:
            self._recorder.sample_once(now=self.clock.time())
            if self._heap_has_work():
                self._push(
                    self.clock.monotonic() + self.config.sample_interval_s,
                    "sample", None,
                )

    async def _on_degrade(self, _payload) -> None:
        """One hysteresis tick on every attached brownout ladder — keeps
        ticking past heap drain until every ladder is back at level 0, so a
        run never ends with shedding still engaged but unevaluated."""
        lvl = 0
        now = self.clock.monotonic()
        for ctrl in self.degradation_controllers.values():
            lvl = max(lvl, ctrl.evaluate_once(now=now))
        self._deg_max = max(self._deg_max, lvl)
        if self._recorder is not None:
            # the periodic "sample" tick stops when the workload drains, but
            # the ladder may still be stepping down — sample here too so the
            # alert engine sees the gauge reach 0, not its last loaded value
            self._recorder.sample_once(now=self.clock.time())
        if self._heap_has_work() or lvl > 0:
            self._push(now + self.config.degradation_interval_s, "degrade", None)

    async def _on_keepalive(self, agent: _KeepaliveAgent) -> None:
        now = self.clock.monotonic()
        self._bucket()["keepalives"] += 1
        next_at = now + agent.keepalive_interval
        if self.manager_down:
            agent.failures += 1
            # the real threshold (ManagerLink.keepalive_once): one blip is
            # not a blackout, two consecutive failures are
            if agent.failures >= 2 and not agent.unreachable:
                agent.unreachable = True
                self._mgr_stats["unreachable_declared"] += 1
        else:
            if agent.unreachable:
                agent.unreachable = False
                agent.failures = 0
                self._mgr_stats["recovered"] += 1
                # recovery catch-up after the PRODUCTION jitter function —
                # deterministic per-host spread across the keepalive
                # interval. The rejoin replaces this agent's next keepalive
                # slot, exactly like the inline await in keepalive_once.
                from dragonfly2_tpu_torch.scheduler.manager_link import ManagerLink

                delay = ManagerLink._rejoin_delay(agent)
                self._push(now + delay, "rejoin", agent)
                next_at = now + delay + agent.keepalive_interval
            else:
                agent.failures = 0
        if next_at <= self.config.keepalive_horizon_s:
            self._push(next_at, "keepalive", agent)

    async def _on_rejoin(self, agent: _KeepaliveAgent) -> None:
        self._bucket()["rejoins"] += 1
        self._mgr_stats["rejoined"] += 1

    async def _on_control(self, fn: Callable[[], Any]) -> None:
        out = fn()
        if hasattr(out, "__await__"):
            await out

    # ---- the loop ----

    _PERIODIC = ("fed_sync", "gc", "sample", "degrade")

    def _heap_has_work(self) -> bool:
        """True while any non-periodic event remains — periodic ticks
        reschedule themselves only then, so the heap drains when the
        workload does instead of ticking to max_virtual_s forever."""
        return self._pending_work > 0

    async def _run(self) -> None:
        handlers = {
            "arrival": self._on_arrival,
            "register": self._register,
            "transfer_done": self._on_transfer_done,
            "origin_done": self._on_origin_done,
            "probe": self._on_probe,
            "depart": self._on_depart,
            "fed_sync": self._on_fed_sync,
            "gc": self._on_gc,
            "sample": self._on_sample,
            "degrade": self._on_degrade,
            "keepalive": self._on_keepalive,
            "rejoin": self._on_rejoin,
            "control": self._on_control,
        }
        inc = sim_metrics.SIM_EVENTS_TOTAL.inc
        cfg = self.config
        heap = self._heap
        periodic = self._PERIODIC
        while heap:
            t, _seq, kind, payload = heapq.heappop(heap)
            if kind not in periodic:
                self._pending_work -= 1
            if t > cfg.max_virtual_s:
                break
            if t > self._last_arrival_s + cfg.drain_grace_s and not self._heap_has_work():
                break  # straggler churn past the grace window: stop waiting
            self.clock.advance_to(t)
            self.report.events += 1
            inc(kind=kind)
            await handlers[kind](payload)

    def run(self) -> SimReport:
        cfg = self.config
        arrivals = self.workload.arrivals()
        for a in arrivals:
            sp = self._new_peer(a.task, region=a.region)
            self._push(a.at_s, "arrival", sp)
        self._last_arrival_s = arrivals[-1].at_s if arrivals else 0.0
        if self.federation:
            self._push(cfg.federation_interval_s, "fed_sync", None)
        if cfg.gc_interval_s > 0:
            self._push(cfg.gc_interval_s, "gc", None)
        if self._recorder is not None:
            self._push(0.0, "sample", None)
        if self.degradation_controllers:
            self._push(cfg.degradation_interval_s, "degrade", None)
        if cfg.keepalive_agents > 0:
            # initial phases staggered across one interval (daemons start at
            # different times) — steady-state keepalive load is uniform
            self._agents = [
                _KeepaliveAgent(i, cfg.keepalive_interval_s)
                for i in range(cfg.keepalive_agents)
            ]
            for i, agent in enumerate(self._agents):
                first = (
                    cfg.keepalive_interval_s
                    if cfg.keepalive_sync_start
                    else (i + 1) * cfg.keepalive_interval_s / cfg.keepalive_agents
                )
                self._push(first, "keepalive", agent)

        from dragonfly2_tpu_torch.observability.tracing import default_tracer

        # head-sampling OFF for the run (restored after): the in-process
        # default tracer samples at 1.0, and recording a span per simulated
        # scheduling round measurably taxes the event loop at 10^5 peers
        tracer = default_tracer()
        prev_rate = tracer.sample_rate
        tracer.sample_rate = 0.0
        t0 = _walltime.perf_counter()  # dflint: disable=DF029 the honest wall-time events/s meter — never feeds event ordering
        try:
            run_virtual(self._run(), self.clock)
        finally:
            tracer.sample_rate = prev_rate
        wall = _walltime.perf_counter() - t0  # dflint: disable=DF029 same meter

        rep = self.report
        # scoring plane: rounds + seconds off each service's
        # PRIVATE schedule_duration histogram (wall time inside scheduling,
        # this run's services only — the global family would mix in other
        # sims of the process)
        rep.scoring = self._scoring
        sched_child = [
            svc.local_metrics.schedule_duration.labels()
            for svc in self.services.values()
        ]
        rep.sched_rounds = int(sum(c.count for c in sched_child))
        rep.sched_s = round(sum(c.total for c in sched_child), 3)
        if rep.sched_s > 0:
            rep.sched_rounds_per_s = round(rep.sched_rounds / rep.sched_s, 1)
        for svc in self.services.values():
            sched = svc.scheduling
            rep.mirror_rounds += sched.mirror_rounds_served
            rep.mirror_stale_rounds += sched.mirror_stale_rounds
            rep.native_rounds += (
                sched.native_rounds_served
                + sched.mirror_rounds_served
                + sched.mirror_stale_rounds
            )
            client = sched._mirror
            if client is not None and client.ready:
                try:
                    rep.mirror_full_syncs += int(client.stats()["full_syncs"])
                except Exception:  # noqa: BLE001  # dflint: disable=DF031 teardown best-effort: a stats read must not clobber the finished report
                    pass
        for scorer in self._scorers:
            try:
                scorer.close()
            except Exception:  # noqa: BLE001  # dflint: disable=DF031 teardown best-effort: a failed scorer close must not clobber the finished report
                pass
        self._scorers.clear()
        rep.peers = len(self._peers)
        rep.wall_s = round(wall, 3)
        rep.virtual_s = round(self.clock.monotonic(), 3)
        rep.events_per_sec = round(rep.events / wall, 1) if wall > 0 else 0.0
        rep.time_compression = round(rep.virtual_s / wall, 1) if wall > 0 else 0.0
        if rep.parents_assigned:
            rep.same_region_frac = round(self._same_region / rep.parents_assigned, 4)
            rep.same_rack_frac = round(self._same_rack / rep.parents_assigned, 4)
            rep.mean_parent_rtt_ms = round(self._rtt_sum / rep.parents_assigned, 3)
        rep.fairness_jain = round(self._jain_fairness(), 4)
        rep.per_scheduler = [self.services[n].federation_state() for n in self.names]
        if self._fed_history:
            rep.federation = {
                "syncs_ok": self._fed_history[-1]["syncs_ok"],
                "syncs_failed": self._fed_history[-1]["syncs_failed"],
                "first_remote_edge_s": self._first_remote_edge_s(),
                "history": self._fed_history,
            }
        if self._admit_waits:
            ws = sorted(self._admit_waits)
            rep.admitted_p50_ms = round(ws[len(ws) // 2] * 1e3, 2)
            rep.admitted_p99_ms = round(
                ws[min(len(ws) - 1, int(0.99 * len(ws)))] * 1e3, 2
            )
        if self.degradation_controllers:
            rep.degradation = {
                "max_level": self._deg_max,
                "final_level": max(
                    c.level for c in self.degradation_controllers.values()
                ),
                "per_scheduler": {
                    n: c.stats() for n, c in self.degradation_controllers.items()
                },
            }
        if self._agents:
            rep.manager = dict(self._mgr_stats)
            rep.manager["agents"] = len(self._agents)
        rep.buckets = [self._buckets[k] for k in sorted(self._buckets)]
        return rep

    def _jain_fairness(self) -> float:
        """Jain index over per-host upload counts (served parents only):
        1.0 = perfectly even fan-out, 1/n = one parent served everything."""
        counts = [
            h.upload_count
            for svc in self.services.values()
            for h in svc.pool.hosts.values()
            if h.upload_count > 0
        ]
        if not counts:
            return 0.0
        return (sum(counts) ** 2) / (len(counts) * sum(c * c for c in counts))

    def _first_remote_edge_s(self) -> float | None:
        for row in self._fed_history:
            if all(c > 0 for c in row["remote_edges"]):
                return row["t_s"]
        return None

    # ---- telemetry bridge (simulated traffic -> the ML plane) ----

    def build_dataset(self, *, max_neighbors: int = 16) -> dict[str, Any]:
        """Feed every scheduler's captured download/probe records through the
        EXISTING DatasetAccumulator ingest and finalize a Dataset — the same
        path the announcer->trainer pipeline drives with production traffic.
        Returns {nodes, edges, pairs, download_rows, probe_rows}; the Dataset
        itself is under the "dataset" key for callers that train on it."""
        from dragonfly2_tpu_torch.trainer.dataset import DatasetAccumulator

        acc = DatasetAccumulator()
        download_rows = probe_rows = 0
        for name in self.names:
            telemetry = self._telemetry.get(name)
            if telemetry is None:
                continue
            downloads, _files = telemetry.downloads.snapshot()
            probes, _pfiles = telemetry.probes.snapshot()
            if len(downloads):
                download_rows += acc.add_downloads(downloads)
            if len(probes):
                probe_rows += acc.add_probes(probes)
        dataset = acc.finalize(max_neighbors=max_neighbors)
        out = {
            "nodes": dataset.num_nodes,
            "edges": int(acc.num_edges),
            "pairs": dataset.num_pairs,
            "download_rows": download_rows,
            "probe_rows": probe_rows,
            "dataset": dataset,
        }
        self.report.dataset = {k: v for k, v in out.items() if k != "dataset"}
        return out

    def close(self) -> None:
        for svc in self.services.values():
            svc.close()


def _uncached_pair_features(child, parents, topology=None, bandwidth=None):
    """build_pair_features without the per-parent pair-row cache writes —
    identical output (the cache is read-through), zero retained rows. The
    simulator schedules each (parent, child-host) pair at most once, so the
    cache can only cost memory at 10^5-peer scale."""
    from dragonfly2_tpu_torch.scheduler.evaluator import _build_pair_features_rowwise

    return _build_pair_features_rowwise(child, parents, topology, bandwidth)


class _ModNodeIndex(dict):
    """node_index over the open-ended sim host population: any `sim-hNNNNNNN`
    id maps to NNNNNNN mod n_nodes (peer count is not known at service
    construction, and the evaluator only ever calls .get). Non-sim ids miss,
    exercising the unknown-host fallback exactly like production."""

    def __init__(self, n_nodes: int):
        super().__init__()
        self._n = n_nodes

    def __bool__(self):
        # truthy despite holding no materialized entries — ModelBundle
        # normalizes a falsy node_index to a plain empty dict
        return True

    def get(self, key, default=None):
        if isinstance(key, str) and key.startswith("sim-h"):
            try:
                return int(key[5:]) % self._n
            except ValueError:
                return default
        return default


def _synthetic_scorer_artifact(path: str, *, n_nodes: int = 256,
                               seed: int = 0) -> str:
    """A structurally valid scorer artifact with seeded random weights — the
    sim's scoring A/B measures ROUND-LOOP mechanics (serial Python loop vs
    df_round_drive), for which any fixed model serves; no trained model needed."""
    import struct

    import numpy as np

    from dragonfly2_tpu_torch.scheduler.evaluator import FEATURE_DIM

    d, h1, h2 = 32, 64, 32
    rng = np.random.default_rng(seed)
    din = 3 * d + FEATURE_DIM
    with open(path, "wb") as f:
        f.write(struct.pack("<7I", 0x44465343, 1, n_nodes, d, FEATURE_DIM, h1, h2))
        for shape, scale in (((n_nodes, d), 1.0), ((din, h1), 0.2), ((h1,), 0.1),
                             ((h1, h2), 0.2), ((h2,), 0.1), ((h2, 1), 0.2),
                             ((1,), 0.1)):
            f.write((rng.standard_normal(shape) * scale).astype(np.float32).tobytes())
    return path
