"""The scheduler metric families the port's evaluator and shadow tracker
write: the port of those families of dragonfly2_tpu/scheduler/metrics.py,
in the port's own registry (observability/metrics.py).

The names are the reference's (``dragonfly_scheduler_*``). The port's
registry is not the reference's: a reference scheduler whose evaluator is
the port's (``plugin:dragonfly2_tpu_torch.scheduler.evaluator:MLEvaluator``)
renders only its own registry on /metrics, so these families are read in
process (``ML_SERVING_MODE.labels(mode=...).value``), not scraped.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.observability.metrics import default_registry

_r = default_registry()

# Staleness of the ml evaluator's cached embeddings: age = now() - this
# timestamp at query side. 0 = no model attached yet (base fallback).
ML_EMBEDDINGS_REFRESH_TIMESTAMP = _r.gauge(
    "ml_embeddings_refresh_timestamp_seconds",
    "Unix time the ml evaluator last received fresh scorer embeddings",
    subsystem="scheduler",
)
# Exactly one mode label is 1 at any time. The port's GNNScorer (engine
# "torch") gets a label of its own, deliberately, so an operator serving the
# port's torch engine sees which scorer serves; "jax" is the reference's
# GNNScorer, which a reference scheduler's own loader may hand the port's
# evaluator.
ML_SERVING_MODE = _r.gauge(
    "ml_serving_mode",
    "Active ml scoring implementation (1 = active): native | torch | jax | base "
    "(torch: the port's GNNScorer; jax: the reference's)",
    subsystem="scheduler",
    labels=("mode",),
)
ML_BASE_FALLBACK_TOTAL = _r.counter(
    "ml_base_fallback_total",
    "Scheduling rounds served by the base evaluator while ml was selected",
    subsystem="scheduler",
    labels=("reason",),
)
SHADOW_ROUNDS_TOTAL = _r.counter(
    "shadow_rounds_total",
    "Scheduling rounds scored by both the active and the candidate model",
    subsystem="scheduler",
)
SHADOW_SCORE_DELTA = _r.histogram(
    "shadow_score_delta",
    "Per-round mean |served - candidate| score delta (shadow scoring)",
    subsystem="scheduler",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0),
)
SHADOW_TOPK_OVERLAP = _r.gauge(
    "shadow_topk_overlap",
    "Running mean top-k parent overlap between served and candidate scores "
    "for the current shadow window",
    subsystem="scheduler",
)
SHADOW_RANK_CORR = _r.gauge(
    "shadow_rank_corr",
    "Running mean rank correlation between served and candidate scores for "
    "the current shadow window",
    subsystem="scheduler",
)
