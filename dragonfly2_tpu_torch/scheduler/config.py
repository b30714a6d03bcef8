"""Scheduler YAML config schema (ref scheduler/config/config.go:76-424).

The port's own copy of dragonfly2_tpu/scheduler/config.py.

``python -m dragonfly2_tpu_torch.scheduler.server --config scheduler.yaml`` boots
from this; CLI flags override file values field for field. Defaults mirror
the reference's constants (scheduler/config/constants.go:36-93).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dragonfly2_tpu_torch.observability.tracing import TracingSection
from dragonfly2_tpu_torch.utils.config import cfgfield


@dataclass
class SchedulingSection:
    """Candidate selection budgets (ref constants.go:36-79)."""

    candidate_parent_limit: int = cfgfield(4, minimum=1, maximum=20)
    filter_parent_limit: int = cfgfield(40, minimum=1, maximum=1000)
    retry_limit: int = cfgfield(10, minimum=1, maximum=100)
    retry_back_to_source_limit: int = cfgfield(5, minimum=0, maximum=100)
    retry_interval: float = cfgfield(0.05, minimum=0.001, maximum=60.0)
    max_tree_depth: int = cfgfield(4, minimum=1, maximum=64)
    dispatch_workers: int = cfgfield(
        0, minimum=0, maximum=64,
        help="round-dispatcher worker threads (0 = serial event-loop rounds)",
    )


@dataclass
class RolloutSection:
    """Scheduler-side live-model rollout knobs. The divergence
    GATES are manager-side (`model_rollout` config row); these control this
    scheduler's shadow-leg sampling and its post-swap health window."""

    shadow_sample_rate: float = cfgfield(
        1.0, minimum=0.001, maximum=1.0,
        help="fraction of scheduling rounds the candidate shadow-scores",
    )
    health_window_s: float = cfgfield(60.0, minimum=0.1)
    health_min_rounds: int = cfgfield(50, minimum=1)
    max_fallback_rate_increase: float = cfgfield(0.2, minimum=0.0, maximum=1.0)
    max_error_rate_increase: float = cfgfield(0.05, minimum=0.0, maximum=1.0)
    max_latency_ratio: float = cfgfield(5.0, minimum=1.0)

    def health_gates(self):
        from dragonfly2_tpu_torch.scheduler.rollout import HealthGates

        return HealthGates(
            window_s=self.health_window_s,
            min_rounds=self.health_min_rounds,
            max_fallback_rate_increase=self.max_fallback_rate_increase,
            max_error_rate_increase=self.max_error_rate_increase,
            max_latency_ratio=self.max_latency_ratio,
        )


@dataclass
class DegradationSection:
    """Brownout-ladder pressure budgets (the ladder's budgets, once
    hard-coded constants): pressure = max(lag_p95/lag_budget,
    utilization/utilization_budget, queue_depth/queue_budget); sustained
    pressure above the enter threshold climbs the shedding ladder. Defaults
    are the measured alert boundaries of the 2-core reference box — a wider
    deployment raises queue_budget with its worker count."""

    lag_budget_ms: float = cfgfield(
        250.0, minimum=1.0, maximum=60_000.0,
        help="event-loop lag p95 treated as pressure 1.0",
    )
    utilization_budget: float = cfgfield(
        0.95, minimum=0.05, maximum=1.0,
        help="dispatcher worker occupancy treated as pressure 1.0",
    )
    queue_budget: float = cfgfield(
        64.0, minimum=1.0, maximum=1_000_000.0,
        help="dispatcher queue depth treated as pressure 1.0",
    )

    def controller_kwargs(self) -> dict:
        return {
            "lag_budget_ms": self.lag_budget_ms,
            "utilization_budget": self.utilization_budget,
            "queue_budget": self.queue_budget,
        }


@dataclass
class GCSection:
    """Resource TTLs in seconds (ref constants.go:81-93)."""

    peer_ttl: float = cfgfield(24 * 3600.0, minimum=1.0)
    task_ttl: float = cfgfield(30 * 60.0, minimum=1.0)  # 30 min idle, matches GCPolicy
    host_ttl: float = cfgfield(6 * 3600.0, minimum=1.0)
    interval: float = cfgfield(10.0, minimum=1.0)  # matches run_scheduler default


@dataclass
class SchedulerYaml:
    host: str = cfgfield("127.0.0.1")
    port: int = cfgfield(9000, minimum=0, maximum=65535)
    hostname: str = cfgfield("")
    idc: str = cfgfield("")
    location: str = cfgfield("")
    evaluator: str = cfgfield("base", help='"base", "ml", or "plugin:pkg.mod:attr"')
    telemetry_dir: Optional[str] = cfgfield(None)
    log_dir: Optional[str] = cfgfield(None, help="rotating per-component log dir")
    metrics_port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)
    manager: Optional[str] = cfgfield(None, help="manager address host:port")
    trainer: Optional[str] = cfgfield(None, help="trainer address host:port")
    trainer_interval: Optional[float] = cfgfield(None, minimum=1.0)
    federation_peers: Optional[str] = cfgfield(
        None, help='peer scheduler addresses "host:port,...", or "auto" (manager-fed)'
    )
    federation_interval: Optional[float] = cfgfield(None, minimum=0.1)
    scheduling: SchedulingSection = cfgfield(default_factory=SchedulingSection)
    rollout: RolloutSection = cfgfield(default_factory=RolloutSection)
    gc: GCSection = cfgfield(default_factory=GCSection)
    degradation: DegradationSection = cfgfield(default_factory=DegradationSection)
    tracing: TracingSection = cfgfield(default_factory=TracingSection)

    def validate_extra(self, path: str) -> None:
        from dragonfly2_tpu_torch.utils.config import ConfigError

        if self.evaluator not in ("base", "ml") and not self.evaluator.startswith("plugin:"):
            raise ConfigError(
                f"{path}.evaluator" if path else "evaluator",
                f"{self.evaluator!r} not 'base', 'ml', or 'plugin:pkg.mod:attr'",
            )

    def scheduling_config(self):
        from dragonfly2_tpu_torch.scheduler.scheduling import SchedulingConfig

        s = self.scheduling
        return SchedulingConfig(
            candidate_parent_limit=s.candidate_parent_limit,
            filter_parent_limit=s.filter_parent_limit,
            retry_limit=s.retry_limit,
            retry_back_to_source_limit=s.retry_back_to_source_limit,
            retry_interval=s.retry_interval,
            max_tree_depth=s.max_tree_depth,
            dispatch_workers=s.dispatch_workers,
        )

    def gc_policy(self):
        from dragonfly2_tpu_torch.scheduler.resource import GCPolicy

        return GCPolicy(
            peer_ttl=self.gc.peer_ttl, task_ttl=self.gc.task_ttl, host_ttl=self.gc.host_ttl
        )
