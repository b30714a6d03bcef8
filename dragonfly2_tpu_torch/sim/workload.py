"""Workload models: peer arrival, flash crowds, churn, task catalog (the
port's own copy of dragonfly2_tpu/sim/workload.py: every draw in the same
order, so a seed gives the same arrivals in both packages).

Arrivals are a Poisson process (exponential inter-arrival gaps) plus zero or
more flash-crowd bursts — N peers arriving over a short window, all pulling
ONE task (the "image pull" shape: a deploy wave hits every node at once).
Churn draws a lifetime per peer; at end-of-life a peer either LEAVES cleanly
(daemon shutdown: leave_peer/leave_host reach the scheduler) or CRASHES
(silent: the scheduler keeps a ghost row until supersede/GC — the resurrection
path the restart suite proves). All draws are seeded: a scenario replays
bit-identically for a given (workload seed, topology seed) pair.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field


@dataclass
class TaskSpec:
    task_id: str
    url: str
    content_length: int
    piece_size: int

    @property
    def total_pieces(self) -> int:
        return max(1, -(-self.content_length // self.piece_size))


@dataclass
class FlashCrowd:
    start_s: float
    peers: int
    duration_s: float  # arrivals spread uniformly across the window
    task_index: int = 0  # index into the task catalog
    region: str | None = None  # None: weighted draw across regions


@dataclass
class WorkloadConfig:
    # steady-state Poisson arrivals (0 = bursts only)
    poisson_rate_per_s: float = 0.0
    poisson_peers: int = 0  # total steady-state arrivals to generate
    flash_crowds: tuple[FlashCrowd, ...] = ()
    tasks: tuple[TaskSpec, ...] = (
        TaskSpec("sim-task-0000", "http://origin/sim-0.bin", 256 << 20, 4 << 20),
    )
    # churn: mean exponential lifetime AFTER download completes; 0 = immortal
    churn_lifetime_mean_s: float = 0.0
    churn_crash_fraction: float = 0.0  # of departures, fraction that crash
    # fraction of peers that run RTT probe rounds (feeds topology + dataset)
    probe_fraction: float = 0.25
    probe_rounds: int = 2
    probe_interval_s: float = 5.0
    # gray parents: fraction of peers whose uplink serves at a
    # crawl after completion (engine caps it at gray_uplink_frac) — degraded
    # but alive, invisible to liveness checks
    gray_fraction: float = 0.0
    # traffic-shaper priority classes, drawn uniformly per peer — feeds the
    # admission-control rung's lowest-first shed order
    priority_classes: tuple[float, ...] = (1.0,)


@dataclass
class PeerArrival:
    at_s: float
    index: int
    task: TaskSpec
    region: str | None  # pin to a region (flash crowd) or None


@dataclass
class Workload:
    config: WorkloadConfig = field(default_factory=WorkloadConfig)
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def arrivals(self) -> list[PeerArrival]:
        """The full seeded arrival schedule, time-ordered."""
        cfg = self.config
        rng = self._rng
        out: list[PeerArrival] = []
        t = 0.0
        for _ in range(cfg.poisson_peers):
            t += rng.expovariate(cfg.poisson_rate_per_s) if cfg.poisson_rate_per_s else 1.0
            out.append(PeerArrival(t, 0, cfg.tasks[0], None))
        for crowd in cfg.flash_crowds:
            task = cfg.tasks[crowd.task_index]
            for _ in range(crowd.peers):
                at = crowd.start_s + rng.uniform(0.0, max(crowd.duration_s, 1e-9))
                out.append(PeerArrival(at, 0, task, crowd.region))
        out.sort(key=lambda a: a.at_s)
        for i, a in enumerate(out):
            a.index = i
        return out

    def lifetime_s(self) -> float | None:
        """Post-download lifetime draw; None = stays for the whole run."""
        mean = self.config.churn_lifetime_mean_s
        if mean <= 0:
            return None
        return self._rng.expovariate(1.0 / mean)

    def departure_is_crash(self) -> bool:
        return self._rng.random() < self.config.churn_crash_fraction

    def runs_probes(self) -> bool:
        return self._rng.random() < self.config.probe_fraction

    def is_gray(self) -> bool:
        return self._rng.random() < self.config.gray_fraction

    def draw_priority(self) -> float:
        classes = self.config.priority_classes
        if not classes:
            return 1.0
        return classes[self._rng.randrange(len(classes))]
