"""Synthetic cluster topology: regions, racks, RTT and link-capacity models
(the port's own copy of dragonfly2_tpu/sim/topology.py: every draw in the
same order, so a seed gives the same cluster in both packages).

The simulator needs ground truth the real wire provides for free: how far
apart two hosts are and how fast bytes move between them. The model is
deliberately simple — a region/rack tree with level-dependent RTT bands and
per-host uplink/downlink caps plus a cross-region bottleneck — because the
properties under test (placement locality, O(1)-per-region origin egress,
federation convergence) depend on the SHAPE of the cost surface, not its
exact values.

Host placement also feeds the REAL evaluator's locality features: hosts get
`idc=<region>` and `location="<region>|<rack>"`, the exact strings
models.features.location_affinity scores, and probe rounds report model RTTs
into the scheduler's NetworkTopology — so the scheduler sees the synthetic
world through the same features it sees production, and "placement quality"
measures the actual serving policy.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field


@dataclass
class TopologyConfig:
    regions: tuple[str, ...] = ("us-east", "us-west", "eu-west")
    # arrival weight per region (normalized); len must match regions
    region_weights: tuple[float, ...] = ()
    racks_per_region: int = 8
    # RTT bands (ms) by relationship, jittered per pair (seeded)
    rtt_same_rack_ms: float = 0.25
    rtt_same_region_ms: float = 1.5
    rtt_cross_region_ms: float = 70.0
    rtt_jitter: float = 0.2  # +/- fraction of the band
    # link capacity (bytes/s)
    uplink_bps: float = 1.25e9  # 10 Gb/s host NIC
    downlink_bps: float = 1.25e9
    cross_region_bps: float = 2.5e8  # per-flow share of the WAN bottleneck
    origin_region: str = ""  # default: regions[0]
    origin_rate_bps: float = 6.25e8  # per-fetch origin share (5 Gb/s)

    def __post_init__(self):
        if not self.region_weights:
            self.region_weights = tuple(1.0 for _ in self.regions)
        if len(self.region_weights) != len(self.regions):
            raise ValueError("region_weights must match regions")
        if not self.origin_region:
            self.origin_region = self.regions[0]


@dataclass(frozen=True)
class Placement:
    region: str
    rack: int

    @property
    def idc(self) -> str:
        return self.region

    @property
    def location(self) -> str:
        # the '|'-separated path models.features.location_affinity scores
        return f"{self.region}|rack{self.rack}"


@dataclass
class SyntheticTopology:
    config: TopologyConfig = field(default_factory=TopologyConfig)
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        # per-(placement, placement) jitter memo keeps RTTs stable per pair
        # across the run (probes for one pair must agree with transfers)
        self._jitter: dict[tuple, float] = {}

    def place(self, region: str | None = None) -> Placement:
        cfg = self.config
        if region is None:
            region = self._rng.choices(cfg.regions, weights=cfg.region_weights)[0]
        return Placement(region, self._rng.randrange(cfg.racks_per_region))

    def _pair_jitter(self, a: Placement, b: Placement) -> float:
        key = (a, b) if (a.region, a.rack) <= (b.region, b.rack) else (b, a)
        j = self._jitter.get(key)
        if j is None:
            j = self._jitter[key] = self._rng.uniform(
                1.0 - self.config.rtt_jitter, 1.0 + self.config.rtt_jitter
            )
        return j

    def rtt_ms(self, a: Placement, b: Placement) -> float:
        cfg = self.config
        if a.region != b.region:
            base = cfg.rtt_cross_region_ms
        elif a.rack != b.rack:
            base = cfg.rtt_same_region_ms
        else:
            base = cfg.rtt_same_rack_ms
        return base * self._pair_jitter(a, b)

    def link_bps(self, parent: Placement, child: Placement) -> float:
        """Per-flow capacity of the parent->child path before host caps."""
        cfg = self.config
        if parent.region != child.region:
            return cfg.cross_region_bps
        return min(cfg.uplink_bps, cfg.downlink_bps)

    def origin_rate_bps(self, child: Placement) -> float:
        """Per-fetch origin rate; cross-region fetches ride the WAN share."""
        cfg = self.config
        rate = cfg.origin_rate_bps
        if child.region != cfg.origin_region:
            rate = min(rate, cfg.cross_region_bps)
        return rate
