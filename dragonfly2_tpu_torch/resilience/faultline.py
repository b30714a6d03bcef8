"""Faultline: deterministic, seeded fault injection, the port's copy of
dragonfly2_tpu/resilience/faultline.py.

Degradation paths (a corrupt artifact, a dropped connection, a slow load)
must be proven, not assumed. This registry injects faults behind named
points on the port's paths, the same points and the same call kinds as the
reference at the same places:

    rpc.read    rpc/core._read_frame (client and server)      latency error drop
    rpc.write   before each frame the port's server or         error drop
                client writes (sync check: latency skipped)
    model.load  scheduler/manager_link.load_scorer_verified,   latency error
                before verification (blocking latency)
                trainer/artifacts.artifact_digest, each file's       truncate corrupt
                bytes before they are hashed
    model.swap  scheduler/manager_link.ManagerLink._install,   latency error
                before the new serving bundle is built
    parent.fetch       daemon/conductor: parent piece HTTP fetch   latency error drop
    parent.piece_body  fetched piece payload                       truncate corrupt
    parent.metadata    parent metadata long-poll                   latency error drop
    source.read        daemon/source: origin chunk reads           latency error drop
    source.body        origin chunk payload                        truncate corrupt
    storage.write      daemon/storage: piece writes                latency error
    storage.meta       metadata (save_metadata) flush              latency error

Fault kinds:
    latency   sleep `param` seconds (default 0.05) before proceeding
    error     raise FaultError (an IOError — looks like a real failed IO)
    drop      raise ConnectionResetError (a dead-socket failure)
    truncate  cut the payload short (drop `param` trailing bytes, default half)
    corrupt   flip one bit at a seeded position

Each rule fires with probability `rate` per traversal, driven by ONE seeded
random.Random — the injection sequence is a pure function of the seed and the
traversal order, so a failing chaos run replays with its seed. (Under
concurrency the traversal order follows the event-loop schedule; tests assert
outcomes, not exact sequences.)

Zero overhead when disabled: call sites guard with

    if faultline.ACTIVE is not None: ...

one module-attribute load + identity check.

This registry and the reference's are two registries: enabling one does
not reach the other package's sites. A run that wants both enables both
with one spec.

Spec grammar (env DF_FAULTS, or enable() directly):

    DF_FAULTS="<point>:<kind>:<rate>[:<param>][,<entry>...][,seed=<n>]"
    DF_FAULTS="model.load:corrupt:1.0,rpc.read:latency:0.5:0.01,seed=7"
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

__all__ = [
    "ACTIVE", "FaultError", "FaultRule", "Faultline",
    "enable", "disable", "parse_spec", "install_from_env",
]

KINDS = ("latency", "error", "drop", "truncate", "corrupt")
_FIRE_KINDS = ("latency", "error", "drop")
_MUTATE_KINDS = ("truncate", "corrupt")


class FaultError(IOError):
    """An injected IO failure; subclasses IOError so every call site treats
    it exactly like the real failure it simulates."""


@dataclass(frozen=True)
class FaultRule:
    point: str
    kind: str
    rate: float
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (want one of {KINDS})")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0,1], got {self.rate}")


@dataclass
class Faultline:
    """A set of fault rules plus the seeded rng that drives them."""

    rules: list[FaultRule]
    seed: int = 0
    _rng: random.Random = field(init=False, repr=False)
    _by_point: dict[str, list[FaultRule]] = field(init=False, repr=False)
    injected: dict[tuple[str, str], int] = field(init=False, default_factory=dict)

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._by_point = {}
        for r in self.rules:
            self._by_point.setdefault(r.point, []).append(r)

    def _hit(self, rule: FaultRule) -> bool:
        if self._rng.random() >= rule.rate:
            return False
        key = (rule.point, rule.kind)
        self.injected[key] = self.injected.get(key, 0) + 1
        return True

    def injected_total(self, point: str | None = None) -> int:
        return sum(
            n for (p, _), n in self.injected.items() if point is None or p == point
        )

    async def fire(self, point: str) -> None:
        """latency/error/drop rules for `point`; may sleep or raise."""
        for rule in self._by_point.get(point, ()):
            if rule.kind not in _FIRE_KINDS or not self._hit(rule):
                continue
            if rule.kind == "latency":
                await asyncio.sleep(rule.param or 0.05)
            elif rule.kind == "error":
                raise FaultError(f"faultline: injected error at {point}")
            else:  # drop
                raise ConnectionResetError(f"faultline: injected drop at {point}")

    def check(self, point: str, *, blocking_latency: bool = False) -> None:
        """Sync variant of fire() for non-async call sites (frame writes):
        error/drop only by default — latency needs the loop, so it is skipped
        unless `blocking_latency` is set, for sync call sites that already
        run off the event loop (an artifact load)."""
        for rule in self._by_point.get(point, ()):
            if rule.kind not in _FIRE_KINDS:
                continue
            if rule.kind == "latency":
                if blocking_latency and self._hit(rule):
                    time.sleep(rule.param or 0.05)
                continue
            if not self._hit(rule):
                continue
            if rule.kind == "error":
                raise FaultError(f"faultline: injected error at {point}")
            raise ConnectionResetError(f"faultline: injected drop at {point}")

    def mutate(self, point: str, data: bytes) -> bytes:
        """truncate/corrupt rules for `point`; returns the (possibly damaged)
        payload. With no matching rule the input object passes through
        untouched — no copy."""
        for rule in self._by_point.get(point, ()):
            if rule.kind not in _MUTATE_KINDS or not data or not self._hit(rule):
                continue
            if rule.kind == "truncate":
                cut = int(rule.param) if rule.param else max(1, len(data) // 2)
                return data[: max(0, len(data) - cut)]
            # corrupt: flip one bit at a seeded position
            buf = bytearray(data)
            i = self._rng.randrange(len(buf))
            buf[i] ^= 1 << self._rng.randrange(8)
            return bytes(buf)
        return data


# The one live Faultline, or None (the production state). Call sites guard on
# `faultline.ACTIVE is not None` — keep this a plain module global so the
# disabled check is a single attribute load.
ACTIVE: Faultline | None = None


def parse_spec(spec: str) -> Faultline:
    """Build a Faultline from the DF_FAULTS grammar (see module docstring)."""
    rules: list[FaultRule] = []
    seed = 0
    for entry in (e.strip() for e in spec.split(",")):
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[len("seed="):])
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad fault entry {entry!r}: want point:kind:rate[:param]"
            )
        point, kind, rate = parts[0], parts[1], float(parts[2])
        param = float(parts[3]) if len(parts) == 4 else 0.0
        rules.append(FaultRule(point=point, kind=kind, rate=rate, param=param))
    return Faultline(rules, seed=seed)


def enable(spec: "str | Faultline") -> Faultline:
    """Install a Faultline as the process-wide ACTIVE one; returns it."""
    global ACTIVE
    fl = parse_spec(spec) if isinstance(spec, str) else spec
    ACTIVE = fl
    logger.warning(
        "faultline ENABLED: %d rule(s), seed=%d — this process now injects faults",
        len(fl.rules), fl.seed,
    )
    return fl


def disable() -> None:
    global ACTIVE
    ACTIVE = None


def install_from_env(env: str = "DF_FAULTS") -> Faultline | None:
    """Enable from the environment (a service's boot path); None when unset.
    A malformed spec fails loudly — a chaos run that silently tested nothing
    is worse than one that refuses to start."""
    raw = os.environ.get(env, "")
    if not raw:
        return None
    return enable(raw)
