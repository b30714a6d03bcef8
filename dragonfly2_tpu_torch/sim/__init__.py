"""Discrete-event swarm simulator: the port's own copy of dragonfly2_tpu/sim.

Drives the REAL control plane — SchedulerService / Scheduling / MLEvaluator /
FederationSync — in-process at 10^5+ simulated peers: zero sockets, zero wall
sleeps, one injectable VirtualClock (utils/clock.py). Virtual peers speak the
same client protocol daemons do; piece transfers are completion-time models
over a synthetic region/rack topology; the scheduler's telemetry records flow
through the existing DatasetAccumulator ingest so a trainer can consume
simulated traffic.

Layout:
  clockloop   asyncio event loop whose time IS the virtual clock
  topology    synthetic region/rack RTT + bandwidth model
  workload    arrival (Poisson + flash crowd), churn, task catalog
  engine      event heap + virtual peers + the in-process cluster
  scenarios   scenario packs (flash crowd, cross-region cold start,
              partition-and-heal) shared by tests, dfsim and chip_smoke.py
  metrics     dragonfly_sim_* families + the sim alert rule's inputs

Wall-clock discipline: nothing in this package may read the wall clock or
sleep for real (dflint DF029) — a single stray time.time() silently corrupts
event ordering. The one exception is the engine's honest events/s meter,
suppressed with a reason at the site.
"""

from dragonfly2_tpu_torch.sim.engine import SimConfig, SimReport, Simulation  # noqa: F401
from dragonfly2_tpu_torch.sim.topology import SyntheticTopology, TopologyConfig  # noqa: F401
from dragonfly2_tpu_torch.sim.workload import Workload, WorkloadConfig  # noqa: F401
