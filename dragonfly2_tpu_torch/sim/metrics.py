"""Simulator metric families (dragonfly_sim_*), in the port's own registry
(the port's copy of dragonfly2_tpu/sim/metrics.py).

The simulator is instrumented like any other subsystem (ROADMAP note: new
subsystems ship their instrument): event throughput, live peer population,
origin egress by region, and the departed-parent invariant counter. Scenario
packs read these through observability/timeseries.py — a MetricsRecorder
sampled at VIRTUAL timestamps — so cluster-level assertions ("origin egress
rate stays bounded during the crowd") are windowed-rate queries over the same
plane production dashboards read, not ad-hoc snapshot scraping.

DEPARTED_PARENT_ROUNDS backs the `sim_departed_parent` alert rule
(observability/alerts.py): a scheduling round handing out a peer that cleanly
left the cluster is an invariant violation, never noise — any sustained rate
fires.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.observability.metrics import default_registry

_r = default_registry()

SIM_EVENTS_TOTAL = _r.counter(
    "events_total",
    "Simulation events processed, by kind",
    subsystem="sim",
    labels=("kind",),
)
SIM_PEERS = _r.gauge(
    "peers", "Live simulated peers (arrived, not yet departed)", subsystem="sim"
)
SIM_ORIGIN_EGRESS_BYTES = _r.counter(
    "origin_egress_bytes_total",
    "Bytes fetched from the origin by simulated back-to-source peers",
    subsystem="sim",
    labels=("region",),
)
SIM_DEPARTED_PARENT_ROUNDS = _r.counter(
    "departed_parent_rounds_total",
    "Scheduling rounds that handed out a cleanly-departed peer as a parent "
    "(invariant violation; feeds the sim_departed_parent alert)",
    subsystem="sim",
)
