"""Scenario packs: configured simulations + their cluster-level assertions.

Each scenario is a builder returning a ready Simulation and a checker that
raises AssertionError (with the offending numbers) against its SimReport —
shared verbatim by the tests, cli/dfsim.py and chip_smoke.py's sim phase,
so "the scenario passes" means the same thing everywhere. The port's own
copy of dragonfly2_tpu/sim/scenarios.py.

  flash_crowd             N peers pull ONE task inside a short window (the
                          deploy-wave image pull). Asserts origin egress is
                          O(1) per region — a bounded number of task-sized
                          fetches, NOT proportional to peers — placement
                          stays region-local, and no scheduling round ever
                          hands out a cleanly-departed peer.
  cross_region_cold_start the task is seeded in one region; a crowd wakes in
                          another. Asserts the cold region bootstraps over a
                          bounded number of cross-region transfers and then
                          fans out locally.
  partition_and_heal      2 federated schedulers; the gossip link is severed
                          mid-run and healed. Asserts sync errors appear
                          during the partition, convergence (remote edges on
                          every member) within bounded virtual time after
                          heal, and the departed-peer invariant throughout.

Chaos packs (graceful degradation under overload):

  overload_flash          arrivals at several times the scheduler's modeled
                          register capacity. The REAL DegradationController
                          rides the modeled queue depth: asserts the ladder
                          climbs to admission control, sheds lowest-priority
                          first with typed overloaded answers, goodput
                          recovers, admitted-round p99 stays bounded, and the
                          ladder steps back to 0 — via the stock
                          scheduler_degraded alert at virtual timestamps.
  manager_blackout        the modeled manager goes dark mid-crowd. Asserts
                          every keepalive agent declares manager_unreachable
                          (2+ consecutive failures, the production
                          threshold), in-flight downloads all complete, and
                          the rejoin wave after restore is spread by the REAL
                          ManagerLink._rejoin_delay jitter (no keepalive
                          bucket above 2x steady-state).
  gray_parents            a fraction of peers serve their uplink at a crawl —
                          alive, registered, invisible to liveness. Asserts
                          the swarm still completes and the origin is not
                          stampeded as a panic fallback.
  thundering_rejoin       keepalive-agents-only fleet (no downloads); a long
                          blackout, then restore. Asserts the rejoin burst
                          stays within 1.5x steady-state keepalive load — a
                          synchronized (unjittered) rejoin wave reads ~2x.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from dragonfly2_tpu_torch.sim.engine import SimConfig, SimReport, Simulation
from dragonfly2_tpu_torch.sim.topology import TopologyConfig
from dragonfly2_tpu_torch.sim.workload import FlashCrowd, TaskSpec, WorkloadConfig


@dataclass
class Scenario:
    name: str
    sim: Simulation
    check: Callable[[SimReport], None]
    # the crowd task's size — origin-egress ratios are in units of it
    content_length: int


def _task(content_mb: int = 256, piece_mb: int = 16) -> TaskSpec:
    return TaskSpec(
        "sim-task-0000", "http://origin/sim-0.bin", content_mb << 20, piece_mb << 20
    )


def _probe_fraction(peers: int) -> float:
    # enough probe traffic to populate topology/dataset edges, bounded so
    # probe rounds stay a small slice of the event budget at 10^5 peers
    return min(0.25, 20_000 / max(peers, 1))


def flash_crowd(
    *,
    peers: int = 2_000,
    schedulers: int = 2,
    seed: int = 0,
    crowd_window_s: float = 60.0,
    telemetry_dir: str | None = None,
    regions: tuple[str, ...] = ("us-east", "us-west", "eu-west"),
    churn_lifetime_mean_s: float = 600.0,
    churn_crash_fraction: float = 0.25,
    sample_interval_s: float = 10.0,
    scoring: str = "base",
) -> Scenario:
    task = _task()
    cfg = SimConfig(
        schedulers=schedulers,
        seed=seed,
        scoring=scoring,
        topology=TopologyConfig(regions=regions),
        workload=WorkloadConfig(
            flash_crowds=(FlashCrowd(1.0, peers, crowd_window_s),),
            tasks=(task,),
            churn_lifetime_mean_s=churn_lifetime_mean_s,
            churn_crash_fraction=churn_crash_fraction,
            probe_fraction=_probe_fraction(peers),
        ),
        telemetry_dir=telemetry_dir,
        sample_interval_s=sample_interval_s,
    )
    sim = Simulation(cfg, scenario="flash_crowd")

    # Cluster properties are read off the metrics PLANE, not ad-hoc
    # counters: a mid-crowd control event queries the recorder's windowed
    # rates at VIRTUAL timestamps (observability/timeseries.py — the same
    # instrument dftop and the SLO engine read in production).
    ts_probe: dict = {}

    def probe_rates() -> None:
        rec = sim.recorder
        now = sim.clock.time()
        ts_probe["events_rate"] = rec.rate(
            "dragonfly_sim_events_total", window_s=30.0, now=now
        )
        ts_probe["egress_rate"] = rec.rate(
            "dragonfly_sim_origin_egress_bytes_total", window_s=30.0, now=now
        )
        ts_probe["peers"] = rec.latest("dragonfly_sim_peers")

    sim.at(1.0 + crowd_window_s * 0.6, probe_rates)

    def check(rep: SimReport) -> None:
        # ---- the timeseries plane saw the crowd: live windowed event rate
        # and population mid-crowd, origin egress RATE bounded in-window ----
        assert ts_probe.get("events_rate"), ts_probe
        assert ts_probe.get("peers"), ts_probe
        assert (ts_probe.get("egress_rate") or 0.0) * 30.0 <= 8.0 * task.content_length, (
            ts_probe
        )
        # ---- origin egress is O(1) per region: a bounded number of
        # task-sized fetches, independent of crowd size ----
        for region, nbytes in rep.origin_egress_bytes.items():
            fetches = nbytes / task.content_length
            assert fetches <= 8.0, (
                f"origin egress in {region} is {fetches:.1f} task-sized fetches "
                f"for {peers} peers — not O(1) per region"
            )
        assert sum(rep.origin_egress_bytes.values()) > 0, "nobody fetched the origin"
        # ---- the crowd actually completed through P2P ----
        assert rep.completed >= 0.95 * peers, (rep.completed, peers)
        assert rep.p2p_bytes >= 0.9 * peers * task.content_length * 0.5
        # ---- placement quality: the evaluator's locality features must beat
        # a uniform random draw (which would land ~1/len(regions) local) ----
        assert rep.same_region_frac >= 1.5 / len(regions), rep.same_region_frac
        # ---- no scheduling round ever observed a cleanly-departed peer ----
        assert rep.departed_parent_rounds == 0, rep.departed_parent_rounds
        # fan-out is shared, not one hero parent
        assert rep.fairness_jain > 0.1, rep.fairness_jain

    return Scenario("flash_crowd", sim, check, task.content_length)


def cross_region_cold_start(
    *,
    peers: int = 1_500,
    seed: int = 0,
    telemetry_dir: str | None = None,
) -> Scenario:
    """Task seeded (announce path) in region A; the crowd wakes in region B."""
    task = _task()
    regions = ("us-east", "eu-west")
    cfg = SimConfig(
        schedulers=2,
        seed=seed,
        topology=TopologyConfig(regions=regions, origin_region="us-east"),
        workload=WorkloadConfig(
            flash_crowds=(FlashCrowd(1.0, peers, 45.0, region="eu-west"),),
            tasks=(task,),
            probe_fraction=_probe_fraction(peers),
        ),
        telemetry_dir=telemetry_dir,
    )
    sim = Simulation(cfg, scenario="cross_region_cold_start")
    sim.preseed(task, "us-east", count=2)

    def check(rep: SimReport) -> None:
        assert rep.completed >= 0.95 * peers, (rep.completed, peers)
        # cold start crosses the WAN a bounded number of times (the seeds
        # and the origin sit in us-east), then fan-out happens locally:
        # cross-region bytes stay a small fraction of total P2P traffic
        frac = rep.cross_region_bytes / max(rep.p2p_bytes, 1)
        assert frac <= 0.25, f"cross-region fraction {frac:.3f} — no local fan-out"
        # origin egress bounded as ever
        total_fetches = sum(rep.origin_egress_bytes.values()) / task.content_length
        assert total_fetches <= 8.0, total_fetches
        assert rep.departed_parent_rounds == 0

    return Scenario("cross_region_cold_start", sim, check, task.content_length)


def partition_and_heal(
    *,
    peers: int = 1_200,
    seed: int = 0,
    partition_at_s: float = 20.0,
    heal_at_s: float = 120.0,
    convergence_budget_s: float = 60.0,
    telemetry_dir: str | None = None,
) -> Scenario:
    """Two federated ring members; gossip severed mid-crowd, then healed."""
    task = _task()
    cfg = SimConfig(
        schedulers=2,
        seed=seed,
        topology=TopologyConfig(regions=("us-east", "us-west")),
        workload=WorkloadConfig(
            flash_crowds=(
                FlashCrowd(1.0, peers // 2, 30.0),
                # a second wave keeps probe/scheduling traffic flowing after
                # the heal so convergence has deltas to carry
                FlashCrowd(heal_at_s + 5.0, peers - peers // 2, 30.0),
            ),
            tasks=(task,),
            probe_fraction=_probe_fraction(peers),
            churn_lifetime_mean_s=400.0,
            churn_crash_fraction=0.2,
        ),
        telemetry_dir=telemetry_dir,
        federation_interval_s=2.0,
        sample_interval_s=5.0,
    )
    sim = Simulation(cfg, scenario="partition_and_heal")
    a, b = sim.names[0], sim.names[1]
    sim.at(partition_at_s, lambda: sim.partition(a, b))
    sim.at(heal_at_s, lambda: sim.heal(a, b))

    # The production paging path, in virtual time: an AlertEngine over the
    # sim's recorder evaluates the stock federation_sync_failures rule
    # DURING the partition (two evaluations, spaced past the rule's for_s)
    # and again after the heal — the scenario asserts the alert fires while
    # severed and resolves once healed.
    from dragonfly2_tpu_torch.observability.alerts import AlertEngine

    engine = AlertEngine(sim.recorder, export=False)
    alert_seen: dict = {}

    def _active() -> set:
        engine.evaluate_once(now=sim.clock.time())
        return {al["name"] for al in engine.active()}

    sim.at(partition_at_s + 45.0, lambda: _active())
    sim.at(
        partition_at_s + 60.0,
        lambda: alert_seen.__setitem__("during", "federation_sync_failures" in _active()),
    )
    sim.at(
        heal_at_s + 120.0,
        lambda: alert_seen.__setitem__("after", "federation_sync_failures" in _active()),
    )

    def check(rep: SimReport) -> None:
        fed = rep.federation
        assert fed, "no federation ticks ran"
        # the partition was real: sync errors accumulated while severed
        assert fed["syncs_failed"] > 0, fed
        # ... and the stock SLO rule saw it through the timeseries plane,
        # then resolved after the heal
        assert alert_seen.get("during") is True, alert_seen
        assert alert_seen.get("after") is False, alert_seen
        # and it healed: convergence (remote edges on EVERY member) within
        # the virtual budget after heal
        converged_at = None
        for row in fed["history"]:
            if row["t_s"] > heal_at_s and all(c > 0 for c in row["remote_edges"]):
                converged_at = row["t_s"]
                break
        assert converged_at is not None, "never converged after heal"
        assert converged_at - heal_at_s <= convergence_budget_s, (
            f"convergence took {converged_at - heal_at_s:.1f}s virtual "
            f"(budget {convergence_budget_s}s)"
        )
        assert rep.departed_parent_rounds == 0
        assert rep.completed >= 0.9 * peers, (rep.completed, peers)

    return Scenario("partition_and_heal", sim, check, task.content_length)


def overload_flash(
    *,
    peers: int = 10_000,
    seed: int = 0,
    overload_factor: float = 4.0,
    burst_s: float = 10.0,
    register_timeout_s: float = 10.0,
    shedding: bool = True,
    telemetry_dir: str | None = None,
    sample_interval_s: float = 2.0,
) -> Scenario:
    """Arrivals at `overload_factor` x the scheduler's modeled register
    capacity. With `shedding` the REAL brownout ladder (fed by the modeled
    queue-depth probe) engages through rung 4 and the typed overloaded
    answers spread the comeback; without it the modeled client timeouts
    amplify into a retry storm (an overload A/B runs both).

    The burst WINDOW is fixed and the per-register service cost derived
    from `peers`, so the backlog-vs-timeout dynamics (what ignites the
    storm and climbs the ladder) are identical at any scale — a 2k-peer
    smoke exercises the same time-shape as the 10^4-peer acceptance run."""
    task = _task(content_mb=64, piece_mb=4)
    register_cost_ms = 1000.0 * burst_s * overload_factor / peers
    capacity_per_s = 1000.0 / register_cost_ms  # one scheduler serves the task
    window_s = burst_s
    cfg = SimConfig(
        schedulers=1,
        seed=seed,
        topology=TopologyConfig(regions=("us-east", "us-west")),
        workload=WorkloadConfig(
            flash_crowds=(FlashCrowd(1.0, peers, window_s),),
            tasks=(task,),
            probe_fraction=0.0,
            # two traffic-shaper classes: admission must shed 1.0 before 5.0
            priority_classes=(1.0, 5.0),
        ),
        telemetry_dir=telemetry_dir,
        sample_interval_s=sample_interval_s,
        register_cost_ms=register_cost_ms,
        register_timeout_s=register_timeout_s,
        degradation=shedding,
        max_virtual_s=900.0,
    )
    sim = Simulation(cfg, scenario="overload_flash")

    # the production paging path at virtual timestamps: the stock
    # scheduler_degraded rule must FIRE mid-overload and RESOLVE by run end
    from dragonfly2_tpu_torch.observability.alerts import AlertEngine

    engine = AlertEngine(sim.recorder, export=False)
    alert_seen: dict = {}

    def _degraded_active() -> bool:
        engine.evaluate_once(now=sim.clock.time())
        return "scheduler_degraded" in {al["name"] for al in engine.active()}

    sim.at(1.0 + window_s + 8.0, lambda: alert_seen.__setitem__(
        "during", _degraded_active()))

    def check(rep: SimReport) -> None:
        if not shedding:
            return  # the unshedded arm exists as the A/B baseline
        deg = rep.degradation
        assert deg, "degradation controller never attached"
        # the ladder climbed all the way to admission control, engaged
        # rung-by-rung under sustained pressure...
        assert deg["max_level"] == 4, deg
        # ...and stepped fully back down once the backlog drained
        assert deg["final_level"] == 0, deg
        # typed overloaded answers went out, lowest priority class first
        assert rep.overload_refused > 0, rep.overload_refused
        low = rep.shed_by_class.get("1", 0)
        high = rep.shed_by_class.get("5", 0)
        assert low > 0 and low >= high, rep.shed_by_class
        # the stock alert saw the brownout mid-overload and resolved
        assert alert_seen.get("during") is True, alert_seen
        assert _degraded_active() is False, "scheduler_degraded still active at end"
        # goodput: the crowd completes despite 4x overload (no collapse)
        assert rep.completed >= 0.9 * peers, (rep.completed, peers)
        assert rep.failed <= 0.05 * peers, rep.failed
        # admitted-round p99 bounded: shed peers come back and get through,
        # they don't queue unboundedly behind a melting scheduler (~120s
        # observed at 4x overload vs the unshedded arm's 1377/2000 failures)
        assert 0 < rep.admitted_p99_ms <= 150_000.0, rep.admitted_p99_ms
        assert rep.departed_parent_rounds == 0

    return Scenario("overload_flash", sim, check, task.content_length)


def manager_blackout(
    *,
    peers: int = 2_000,
    seed: int = 0,
    agents: int = 40,
    keepalive_interval_s: float = 20.0,
    blackout_at_s: float = 35.0,
    restore_at_s: float = 155.0,
    telemetry_dir: str | None = None,
) -> Scenario:
    """The modeled manager goes dark mid-crowd. The download plane never
    touches the manager (last-good scheduler snapshots serve — the autonomy
    contract), so every in-flight download must complete; the keepalive
    agents must declare unreachable on the production 2-consecutive-failures
    threshold and rejoin spread by the production jitter after restore. The
    rollout-watch freeze itself is pinned by tests/test_torch_manager_link.py —
    the sim asserts the swarm-level invariants around it."""
    task = _task(content_mb=64, piece_mb=4)
    cfg = SimConfig(
        schedulers=2,
        seed=seed,
        topology=TopologyConfig(regions=("us-east", "us-west")),
        workload=WorkloadConfig(
            flash_crowds=(FlashCrowd(1.0, peers, 30.0),),
            tasks=(task,),
            probe_fraction=_probe_fraction(peers),
        ),
        telemetry_dir=telemetry_dir,
        keepalive_agents=agents,
        keepalive_interval_s=keepalive_interval_s,
        keepalive_horizon_s=restore_at_s + 6.0 * keepalive_interval_s,
    )
    sim = Simulation(cfg, scenario="manager_blackout")
    sim.at(blackout_at_s, sim.blackout)
    sim.at(restore_at_s, sim.restore)
    bucket_s = cfg.bucket_s

    def check(rep: SimReport) -> None:
        mgr = rep.manager
        assert mgr, "keepalive agents never ran"
        # every agent declared the blackout (>= 2 consecutive failures) and
        # recovered + rejoined after restore
        assert mgr["unreachable_declared"] == agents, mgr
        assert mgr["recovered"] == agents, mgr
        assert mgr["rejoined"] == agents, mgr
        # the rejoin wave is jitter-spread: no bucket's keepalive+rejoin load
        # exceeds 2x the steady-state keepalive rate (the brownout plane's bound)
        steady = agents * bucket_s / keepalive_interval_s
        worst = max(
            (b["keepalives"] + b["rejoins"] for b in rep.buckets), default=0
        )
        assert worst <= 2.0 * steady, (worst, steady)
        # manager loss never lost a download: everything in flight completed
        assert rep.completed >= 0.97 * peers, (rep.completed, peers)
        assert rep.failed == 0, rep.failed
        assert rep.departed_parent_rounds == 0

    return Scenario("manager_blackout", sim, check, task.content_length)


def gray_parents(
    *,
    peers: int = 3_000,
    seed: int = 0,
    gray_fraction: float = 0.3,
    gray_uplink_frac: float = 0.005,
    telemetry_dir: str | None = None,
) -> Scenario:
    """A slice of the swarm serves its uplink at a crawl — alive and
    registered, so liveness never flags it; only bandwidth feedback can.
    The swarm must still complete (children of gray parents just go slow or
    aggregate healthy parents) and must NOT stampede the origin as a panic
    fallback."""
    task = _task(content_mb=64, piece_mb=4)
    cfg = SimConfig(
        schedulers=2,
        seed=seed,
        topology=TopologyConfig(regions=("us-east", "us-west", "eu-west")),
        workload=WorkloadConfig(
            flash_crowds=(FlashCrowd(1.0, peers, 45.0),),
            tasks=(task,),
            probe_fraction=_probe_fraction(peers),
            gray_fraction=gray_fraction,
        ),
        telemetry_dir=telemetry_dir,
        gray_uplink_frac=gray_uplink_frac,
    )
    sim = Simulation(cfg, scenario="gray_parents")

    def check(rep: SimReport) -> None:
        # the draw actually produced a gray population near the target
        assert 0.6 * gray_fraction * peers <= rep.gray_peers <= 1.4 * gray_fraction * peers, (
            rep.gray_peers
        )
        # the swarm drains despite the gray slice
        assert rep.completed >= 0.95 * peers, (rep.completed, peers)
        # ... WITHOUT a panic stampede to the origin: egress stays a bounded
        # number of task-sized fetches per region, same as a healthy swarm
        for region, nbytes in rep.origin_egress_bytes.items():
            fetches = nbytes / task.content_length
            assert fetches <= 10.0, (region, fetches)
        assert rep.departed_parent_rounds == 0

    return Scenario("gray_parents", sim, check, task.content_length)


def thundering_rejoin(
    *,
    peers: int = 4_000,
    seed: int = 0,
    keepalive_interval_s: float = 20.0,
    blackout_at_s: float = 60.0,
    restore_at_s: float = 300.0,
    telemetry_dir: str | None = None,
) -> Scenario:
    """`peers` keepalive agents (no download workload) whose poll phases are
    SYNCHRONIZED (one deploy restarted the fleet — the worst thundering-herd
    shape), a long blackout, then restore. The whole fleet detects recovery
    on the same poll tick; only the production ManagerLink._rejoin_delay
    jitter spreads the catch-up wave. With it, the worst bucket stays within
    1.75x a steady poll tick and rejoins alone within 0.75x the fleet; a
    synchronized (unjittered) wave reads 2x / 1.0x and fails both."""
    agents = peers
    cfg = SimConfig(
        schedulers=1,
        seed=seed,
        workload=WorkloadConfig(),  # no arrivals: pure keepalive plane
        telemetry_dir=telemetry_dir,
        keepalive_agents=agents,
        keepalive_interval_s=keepalive_interval_s,
        keepalive_horizon_s=restore_at_s + 8.0 * keepalive_interval_s,
        keepalive_sync_start=True,
    )
    sim = Simulation(cfg, scenario="thundering_rejoin")
    sim.at(blackout_at_s, sim.blackout)
    sim.at(restore_at_s, sim.restore)

    def check(rep: SimReport) -> None:
        mgr = rep.manager
        assert mgr, "keepalive agents never ran"
        assert mgr["unreachable_declared"] == agents, mgr
        assert mgr["rejoined"] == agents, mgr
        # synchronized fleet: a steady poll tick is the whole fleet in one
        # bucket. The recovery bucket adds the rejoin wave on top — jitter
        # must keep it under 1.75x a tick (unjittered reads 2.0x)...
        worst_total = max(
            (b["keepalives"] + b["rejoins"] for b in rep.buckets), default=0
        )
        assert worst_total <= 1.75 * agents, (
            f"recovery burst {worst_total} events/bucket vs fleet {agents} "
            f"— jitter failed to spread the catch-up wave"
        )
        # ... and the rejoin RPCs themselves (re-register + dynconfig
        # refresh, the expensive leg) must spread across the interval
        worst_rejoins = max((b["rejoins"] for b in rep.buckets), default=0)
        assert worst_rejoins <= 0.75 * agents, (
            f"{worst_rejoins} rejoins in one bucket for a {agents}-agent fleet"
        )

    return Scenario("thundering_rejoin", sim, check, _task().content_length)


SCENARIOS: dict[str, Callable[..., Scenario]] = {
    "flash-crowd": flash_crowd,
    "cross-region-cold-start": cross_region_cold_start,
    "partition-and-heal": partition_and_heal,
    "overload-flash": overload_flash,
    "manager-blackout": manager_blackout,
    "gray-parents": gray_parents,
    "thundering-rejoin": thundering_rejoin,
}
