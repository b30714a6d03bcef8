"""Declarative SLO alert rules evaluated against the local timeseries rings.

The port's own copy of dragonfly2_tpu/observability/alerts.py.

The reference leaves alerting to an external Prometheus Alertmanager; this
is the in-process equivalent: a small rule engine over MetricsRecorder's
windowed rates/quantiles, so every service can answer "is anything wrong
RIGHT NOW" without any external stack. Active alerts are exported as
`dragonfly_alert_active{name}` (scraped like any metric) and carried in the
stats frame the manager aggregates, which shows them cluster-wide.

A rule is data, not code:

    AlertRule(name="scorer_error_rate", kind="ratio",
              metric="dragonfly_scheduler_ml_base_fallback_total",
              labels={"reason": "scorer_error"},
              denom="dragonfly_scheduler_schedule_duration_seconds",
              op=">", bound=0.05, window_s=60, for_s=0)

kinds:
  rate      per-second counter increase over window_s (histograms: count)
  ratio     rate(metric)/rate(denom), guarded by min_denom_rate — a cluster
            serving no rounds never alerts on a 0/0
  quantile  bucket-interpolated q over window_s (histograms only)
  value     latest sampled value (gauges)

`for_s` is Prometheus `for:`: the bound must stay breached that long before
the alert activates (0 = first breached evaluation activates — the rates are
already windowed, so momentary noise is pre-smoothed).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

from dragonfly2_tpu_torch.observability.metrics import default_registry
from dragonfly2_tpu_torch.observability.sketches import PSI_MAJOR
from dragonfly2_tpu_torch.observability.timeseries import MetricsRecorder

DEFAULT_EVAL_INTERVAL_S = 5.0

ALERT_ACTIVE = default_registry().gauge(
    "alert_active",
    "SLO alert state (1 = firing) per rule name (observability/alerts.py)",
    labels=("name",),
)


@dataclass
class AlertRule:
    name: str
    metric: str
    bound: float
    kind: str = "rate"            # rate | ratio | quantile | value
    op: str = ">"                 # ">" or "<"
    labels: Optional[Mapping[str, str]] = None
    denom: Optional[str] = None   # ratio denominator metric
    denom_labels: Optional[Mapping[str, str]] = None
    q: float = 0.95               # quantile kind
    window_s: float = 60.0
    for_s: float = 0.0
    # ratio guard: below this denominator rate the ratio is statistically
    # meaningless (an idle scheduler must not alert on its first error)
    min_denom_rate: float = 0.05
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("rate", "ratio", "quantile", "value"):
            raise ValueError(f"unknown alert kind {self.kind!r}")
        if self.op not in (">", "<"):
            raise ValueError(f"alert op must be > or <, got {self.op!r}")
        if self.kind == "ratio" and not self.denom:
            raise ValueError(f"ratio rule {self.name!r} needs a denom metric")


@dataclass
class _RuleState:
    rule: AlertRule
    active: bool = False
    breached_since: Optional[float] = None
    since: Optional[float] = None
    value: Optional[float] = None
    extra: dict = field(default_factory=dict)


def default_rules() -> list[AlertRule]:
    """The built-in SLO set. Every rule names a family that exists today;
    rules whose family never shows up in the recorder simply stay inactive,
    so one rule set serves scheduler, daemon, and trainer processes."""
    return [
        AlertRule(
            name="loop_lag_p95",
            kind="quantile", q=0.95,
            metric="dragonfly_loop_lag_seconds",
            bound=0.25, window_s=60.0, for_s=10.0,
            description="event-loop scheduling lag p95 over 250 ms",
        ),
        AlertRule(
            name="scorer_error_rate",
            kind="ratio",
            metric="dragonfly_scheduler_ml_base_fallback_total",
            labels={"reason": "scorer_error"},
            denom="dragonfly_scheduler_schedule_duration_seconds",
            bound=0.05, window_s=60.0,
            description="ml scorer exceptions per scheduling round over 5%",
        ),
        AlertRule(
            name="base_fallback_rate",
            kind="ratio",
            metric="dragonfly_scheduler_ml_base_fallback_total",
            denom="dragonfly_scheduler_schedule_duration_seconds",
            bound=0.5, window_s=60.0,
            description="rounds served by the base fallback over 50% "
                        "(native/jax serving degraded)",
        ),
        AlertRule(
            name="piece_failure_ratio",
            kind="ratio",
            metric="dragonfly_scheduler_piece_result_total",
            labels={"success": "false"},
            denom="dragonfly_scheduler_piece_result_total",
            bound=0.2, window_s=60.0,
            description="failed piece reports over 20% of all piece reports",
        ),
        AlertRule(
            name="federation_sync_failures",
            kind="rate",
            metric="dragonfly_scheduler_federation_syncs_total",
            labels={"result": "error"},
            bound=0.0, window_s=60.0, for_s=10.0,
            description="any federation sync errors sustained in the window",
        ),
        AlertRule(
            name="sim_departed_parent",
            kind="rate",
            metric="dragonfly_sim_departed_parent_rounds_total",
            bound=0.0, window_s=60.0,
            # an INVARIANT alert, not an SLO: a scheduling round handing out
            # a peer that cleanly left the cluster is wrong at any rate. The
            # family only exists in processes that import the simulator
            # (sim/metrics.py), so the rule stays inactive
            # everywhere else — scenario packs assert on it through the same
            # recorder→engine path production would page through.
            description="simulated scheduling rounds handed out a departed "
                        "peer (virtual-clock swarm invariant violation)",
        ),
        AlertRule(
            name="feature_drift",
            kind="value",
            metric="dragonfly_feature_drift_max",
            # ONE decision boundary with classify_psi()/dfml/dfmodel
            bound=PSI_MAJOR,
            window_s=60.0, for_s=0.0,
            # the UNLABELED max gauge, not dragonfly_feature_drift{feature}:
            # value-kind sums matching label sets (PromQL sum-by), and a sum
            # of 16 per-feature PSIs would fire on collective noise; the max
            # is the decision variable (0.25 = conventional "major shift").
            # The per-feature detail stays queryable at /debug/ts.
            description="live scoring-feature distribution drifted past "
                        "PSI 0.25 vs the serving model's training reference "
                        "(population shift — retrain or investigate; "
                        "per-feature detail in dragonfly_feature_drift)",
        ),
        AlertRule(
            name="scheduler_degraded",
            kind="value",
            metric="dragonfly_scheduler_degradation_level",
            bound=0.5, window_s=60.0, for_s=0.0,
            # the brownout ladder (scheduler/degradation.py) already applies
            # sustain/cool hysteresis before moving the gauge, so the rule
            # fires on the first evaluation that sees rung >= 1 — the ladder
            # engaging IS the page-worthy event, the per-rung detail lives in
            # the stats frame / dftop degradation column
            description="scheduler brownout ladder engaged (load shedding "
                        "active; see scheduler_degradation_level rung and "
                        "README 'Overload & degradation')",
        ),
        AlertRule(
            name="piece_tls_handshake_failures",
            kind="rate",
            metric="dragonfly_dfdaemon_piece_tls_handshake_failures_total",
            bound=0.0, window_s=60.0, for_s=15.0,
            # a RATE rule, not a failure/success ratio: when a cert rollover
            # goes wrong every handshake fails and a ratio's denominator
            # (completed handshakes) goes to zero — exactly when the alert
            # must fire. Sustained-for filters the stray flaky parent.
            description="data-plane TLS handshake failures sustained in the "
                        "window (cert rollover / cipher mismatch suspect)",
        ),
    ]


class AlertEngine:
    """Evaluates rules against a MetricsRecorder on a fixed cadence.

    start() rides the event loop (call_later); evaluate_once(now=...) is the
    synchronous entry for tests and the smoke leg. Thread-safe: the stats
    frame builder and /debug endpoints read active() while the loop ticks.
    """

    def __init__(
        self,
        recorder: MetricsRecorder,
        rules: list[AlertRule] | None = None,
        *,
        interval: float = DEFAULT_EVAL_INTERVAL_S,
        export: bool = True,
    ):
        self.recorder = recorder
        self.interval = interval
        # `export`: write dragonfly_alert_active{name} on every evaluation.
        # The PROCESS's serving engine (default_engine) exports; an ad-hoc
        # engine over a private recorder (bench probes, scratch analyses)
        # must pass export=False or it would stomp the serving engine's
        # firing state in the shared gauge — two engines share rule NAMES,
        # not rule STATE.
        self.export = export
        self._states = [_RuleState(r) for r in (rules if rules is not None else default_rules())]
        self._lock = threading.Lock()
        self._handle: Any = None
        self.evaluations = 0
        # export every rule as 0 up front: the gauge answers "is this rule
        # known and quiet" vs "was this rule never evaluated"
        if self.export:
            for st in self._states:
                ALERT_ACTIVE.set(0.0, name=st.rule.name)

    # ---- evaluation ----

    def _rule_value(self, rule: AlertRule, now: float) -> tuple[float | None, dict]:
        r = self.recorder
        if rule.kind == "rate":
            return r.rate(rule.metric, rule.labels, window_s=rule.window_s, now=now), {}
        if rule.kind == "value":
            return r.latest(rule.metric, rule.labels), {}
        if rule.kind == "quantile":
            hw = r.hist_window(
                rule.metric, rule.labels, window_s=rule.window_s, now=now, q=rule.q
            )
            if hw is None:
                return None, {}
            return hw.get("pq"), {}
        # ratio
        num = r.rate(rule.metric, rule.labels, window_s=rule.window_s, now=now)
        den = r.rate(rule.denom, rule.denom_labels, window_s=rule.window_s, now=now)
        if num is None or den is None or den < rule.min_denom_rate:
            return None, {"num_rate": num, "denom_rate": den}
        return num / den, {"num_rate": num, "denom_rate": den}

    def evaluate_once(self, now: float | None = None) -> list[str]:
        """One pass over every rule; returns the names currently firing and
        keeps `dragonfly_alert_active{name}` one-for-one with them."""
        now = now if now is not None else time.time()
        firing: list[str] = []
        with self._lock:
            self.evaluations += 1
            for st in self._states:
                rule = st.rule
                value, extra = self._rule_value(rule, now)
                st.value = value
                st.extra = extra
                breached = value is not None and (
                    value > rule.bound if rule.op == ">" else value < rule.bound
                )
                if breached:
                    if st.breached_since is None:
                        st.breached_since = now
                    if now - st.breached_since >= rule.for_s:
                        if not st.active:
                            st.since = now
                        st.active = True
                else:
                    st.breached_since = None
                    st.active = False
                    st.since = None
                if self.export:
                    ALERT_ACTIVE.set(1.0 if st.active else 0.0, name=rule.name)
                if st.active:
                    firing.append(rule.name)
        return firing

    def active(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "name": st.rule.name,
                    "value": st.value,
                    "bound": st.rule.bound,
                    "op": st.rule.op,
                    "since": st.since,
                    "description": st.rule.description,
                }
                for st in self._states
                if st.active
            ]

    def status(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval,
                "evaluations": self.evaluations,
                "rules": [
                    {
                        "name": st.rule.name,
                        "kind": st.rule.kind,
                        "metric": st.rule.metric,
                        "op": st.rule.op,
                        "bound": st.rule.bound,
                        "window_s": st.rule.window_s,
                        "for_s": st.rule.for_s,
                        "value": st.value,
                        "active": st.active,
                        "since": st.since,
                    }
                    for st in self._states
                ],
            }

    # ---- lifecycle ----

    def start(self) -> None:
        import asyncio

        if self._handle is not None:
            return
        loop = asyncio.get_running_loop()
        self._handle = loop.call_later(self.interval, self._tick, loop)

    def stop(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    @property
    def running(self) -> bool:
        return self._handle is not None

    def _tick(self, loop) -> None:
        try:
            self.evaluate_once()
        except Exception:  # noqa: BLE001 — a bad rule must not kill evaluation
            import logging

            logging.getLogger(__name__).exception("alert evaluation failed")
        self._handle = loop.call_later(self.interval, self._tick, loop)


_default: AlertEngine | None = None


def default_engine() -> AlertEngine:
    """Process-wide engine over the default recorder + built-in rules
    (composition roots start it; /debug/alerts and stats frames read it)."""
    global _default
    if _default is None:
        import os

        from dragonfly2_tpu_torch.observability.timeseries import default_recorder

        interval = float(
            os.environ.get("DRAGONFLY_ALERT_INTERVAL", DEFAULT_EVAL_INTERVAL_S)
        )
        _default = AlertEngine(default_recorder(), interval=interval)
    return _default
