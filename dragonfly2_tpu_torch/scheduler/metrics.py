"""Scheduler metric families: the port of dragonfly2_tpu/scheduler/metrics.py,
in the port's own registry (observability/metrics.py).

The names are the reference's (``dragonfly_scheduler_*``, after the upstream
scheduler/metrics/metrics.go:46-179): peer registrations, piece and peer
results by outcome, scheduling round latency, traffic, live resource gauges,
the round dispatcher, the native round driver and mirror, the ml evaluator's
serving mode and fallbacks, shadow scoring, the federation exchange, the
brownout ladder, and ``ServiceMetrics``, the registry-scoped twins one
``SchedulerService`` owns, the ManagerLink's swap, rollout and
manager-outage families and the federation loop's. ``ML_SERVING_MODE`` has a
``torch`` label of its own beside the reference's (the port's GNNScorer).

The port's scheduler renders them on its debug server's ``/metrics``
(``--metrics-port``); a reference scheduler's /metrics renders only the
reference's registry.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.observability.metrics import default_registry

_r = default_registry()

REGISTER_PEER_TOTAL = _r.counter(
    "register_peer_total", "Peer registrations", subsystem="scheduler", labels=("scope",)
)
SCHEDULE_DURATION = _r.histogram(
    "schedule_duration_seconds",
    "Latency of one candidate-parent scheduling round (filter+score)",
    subsystem="scheduler",
)
PIECE_RESULT_TOTAL = _r.counter(
    "piece_result_total", "Piece results reported", subsystem="scheduler", labels=("success",)
)
PIECE_REPORT_BATCH_TOTAL = _r.counter(
    "piece_report_batch_total",
    "Batched piece-report flushes received (report_pieces RPCs)",
    subsystem="scheduler",
)
PIECE_REPORT_DUPLICATE_TOTAL = _r.counter(
    "piece_report_duplicate_total",
    "Batched piece reports skipped as already applied (idempotent re-apply)",
    subsystem="scheduler",
)
PEER_RESULT_TOTAL = _r.counter(
    "peer_result_total", "Peer download completions", subsystem="scheduler", labels=("success",)
)
BACK_TO_SOURCE_TOTAL = _r.counter(
    "back_to_source_total", "Peers escalated to back-to-source", subsystem="scheduler"
)
# resurrection accounting: ghost peer rows replaced when their host
# re-announced/re-registered after a crash (no leave_host was ever sent)
PEER_SUPERSEDED_TOTAL = _r.counter(
    "peer_superseded_total", "Stale same-host peer rows replaced on rejoin",
    subsystem="scheduler",
)
DOWNLOAD_TRAFFIC_BYTES = _r.counter(
    "download_traffic_bytes_total", "Bytes reported via piece results", subsystem="scheduler"
)
# Sharded round dispatcher: worker-thread count and rounds whose
# find leg ran off-loop — dispatched/total-schedule ratio says whether the
# multi-core path is actually serving.
DISPATCH_WORKERS = _r.gauge(
    "dispatch_workers", "Round-dispatcher worker threads (0 = serial loop)",
    subsystem="scheduler",
)
DISPATCHED_ROUNDS_TOTAL = _r.counter(
    "dispatched_rounds_total",
    "Scheduling find rounds sharded onto dispatcher worker threads",
    subsystem="scheduler",
)
# Native round driver: whole rounds (filter re-validation, feature
# column fill, scoring, stable top-k) resolved by ONE df_round_drive FFI call
# per dispatched batch. native/total-schedule ratio says whether the native
# path is actually serving; the fallback reasons name why a round
# stayed on the serial Python leg.
NATIVE_ROUNDS_TOTAL = _r.counter(
    "native_rounds_total",
    "Scheduling rounds resolved end-to-end by the native round driver",
    subsystem="scheduler",
)
NATIVE_ROUND_FALLBACK_TOTAL = _r.counter(
    "native_round_fallback_total",
    "Rounds routed back to the serial Python leg (no_native = no eligible "
    "native bundle, unknown_hosts = node outside the embedding table, "
    "driver_error = the drive call itself failed)",
    subsystem="scheduler", labels=("reason",),
)
# Native mirrored peer table: rounds where sampling, filtering,
# feature gather, scoring AND top-k all ran against the C-side mirror — no
# snapshot-under-lock, no Python peer-pool walk. mirror/native ratio says how
# often the incremental delta stream kept the mirror current; stale rounds
# are the lazy-revalidation path (serial score once, rows re-pushed, next
# drive native); the fallback reasons name why a round left the mirror.
NATIVE_MIRROR_ROUNDS_TOTAL = _r.counter(
    "native_mirror_rounds_total",
    "Scheduling rounds resolved end-to-end against the native mirrored "
    "peer table (no Python snapshot leg)",
    subsystem="scheduler",
)
NATIVE_MIRROR_STALE_ROUNDS_TOTAL = _r.counter(
    "native_mirror_stale_rounds_total",
    "Mirror rounds whose cached feature rows were version-stale: survivors "
    "scored on the serial leg once, refreshed rows pushed back",
    subsystem="scheduler",
)
NATIVE_MIRROR_FALLBACK_TOTAL = _r.counter(
    "native_mirror_fallback_total",
    "Rounds routed off the mirror (mirror_miss = object not yet mirrored "
    "or deleted mid-drive, driver_error = the mirror drive call failed, "
    "slot_race = survivor slot remapped between drive and commit, "
    "poisoned = a mutation hook failed and the mirror detached itself)",
    subsystem="scheduler", labels=("reason",),
)
PEERS_GAUGE = _r.gauge("peers", "Live peers in the resource pool", subsystem="scheduler")
TASKS_GAUGE = _r.gauge("tasks", "Live tasks in the resource pool", subsystem="scheduler")
HOSTS_GAUGE = _r.gauge("hosts", "Live hosts in the resource pool", subsystem="scheduler")
PROBES_SYNCED_TOTAL = _r.counter(
    "probes_synced_total", "Network-topology probe results ingested", subsystem="scheduler"
)
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
# Live-model safe rollout (the ManagerLink's model watch): hot-swap outcomes, shadow-scoring
# divergence, and rollback accounting. model_swap_total{result} makes the
# previously-silent _check_model failure paths (artifact missing, digest
# mismatch, load error) first-class signals instead of buried warnings.
MODEL_SWAP_TOTAL = _r.counter(
    "model_swap_total",
    "Model hot-swap attempts by outcome (ok|missing|digest_mismatch|"
    "load_error|swap_error|rejected_version|rollback)",
    subsystem="scheduler", labels=("result",),
)
# One-hot over the LAST swap error kind (cleared to all-zero on a successful
# swap) — the "what is currently wrong" companion to the rate counter above.
MODEL_SWAP_LAST_ERROR = _r.gauge(
    "model_swap_last_error",
    "Most recent model-swap failure kind (1 = this was the last error; "
    "all zero after a successful swap)",
    subsystem="scheduler", labels=("error",),
)
MODEL_ROLLBACK_TOTAL = _r.counter(
    "model_rollback_total",
    "Automatic rollbacks to the previous serving model after a post-swap "
    "health regression",
    subsystem="scheduler",
)
MODEL_ROLLOUT_STATE = _r.gauge(
    "model_rollout_state",
    "Scheduler-local rollout activity (1 = active): idle | shadowing | "
    "health_watch",
    subsystem="scheduler", labels=("state",),
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
# Scheduler federation: push-pull topology/bandwidth gossip between ring
# members (scheduler/federation.py). Sent/received counts are DELTA entries (edges +
# bandwidth pairs), so steady-state rates near zero are the health signal
# that watermarking works — O(all edges) payloads every tick would show up
# here immediately.
FEDERATION_SYNCS_TOTAL = _r.counter(
    "federation_syncs_total", "Federation sync rounds by outcome",
    subsystem="scheduler", labels=("result",),
)
FEDERATION_DELTAS_SENT_TOTAL = _r.counter(
    "federation_deltas_sent_total",
    "Topology/bandwidth delta entries pushed or served to peer schedulers",
    subsystem="scheduler",
)
FEDERATION_DELTAS_APPLIED_TOTAL = _r.counter(
    "federation_deltas_applied_total",
    "Peer delta entries merged into the local topology/bandwidth view",
    subsystem="scheduler",
)
FEDERATION_PEERS_GAUGE = _r.gauge(
    "federation_peers", "Peer schedulers currently in the sync set",
    subsystem="scheduler",
)
FEDERATION_LAST_SYNC_TIMESTAMP = _r.gauge(
    "federation_last_sync_timestamp_seconds",
    "Unix time of the last successful federation sync (0 = never)",
    subsystem="scheduler",
)
# Brownout ladder: the current degradation rung, 0 = normal
# through 4 = priority-aware admission control (scheduler/degradation.py
# LEVEL_NAMES). A stock alert rule fires on >= 1; dftop shows the rung
# cluster-wide via the stats frame.
DEGRADATION_LEVEL = _r.gauge(
    "degradation_level",
    "Brownout ladder rung (0 normal, 1 shed shadow, 2 shed observability, "
    "3 base-only serving, 4 admission control)",
    subsystem="scheduler",
)
ADMISSION_SHED_TOTAL = _r.counter(
    "admission_shed_total",
    "Registrations refused with a typed overloaded + retry_after_s answer "
    "by the admission-control rung, by traffic-shaper priority class",
    subsystem="scheduler", labels=("priority",),
)

# Manager-outage autonomy: 1 while the manager link is in
# declared blackout mode — keepalives failing (2+ consecutive) or the
# rollout watch unable to reach the registry. Scheduling and downloads
# continue from cached state; the rollout watch is frozen.
MANAGER_UNREACHABLE = _r.gauge(
    "manager_unreachable",
    "1 while the manager link is in autonomous (blackout) mode: cached "
    "dynconfig serves, rollout watch frozen, keepalives keep probing",
    subsystem="scheduler",
)

class ServiceMetrics:
    """Registry-scoped serving-health twins for ONE SchedulerService.

    The families above are process-global — right for a production process
    (one scheduler per process, one scrape endpoint), wrong for rollout
    HEALTH BASELINES: a test/dfcluster process running several services
    shared one set of counters, so service A's traffic moved service B's
    post-swap baseline. Each service owns this private registry; the hot sites record into BOTH (the
    extra observe is one lock + few adds, noise next to the round), and
    rollout.HealthSample.capture(source=...) windows the private one.
    """

    def __init__(self):
        from dragonfly2_tpu_torch.observability.metrics import MetricsRegistry

        self.registry = MetricsRegistry()
        self.schedule_duration = self.registry.histogram(
            "schedule_duration_seconds",
            "Latency of one scheduling round (this service instance only)",
            subsystem="scheduler",
        )
        self.base_fallback = self.registry.counter(
            "ml_base_fallback_total",
            "Base-fallback rounds (this service instance only)",
            subsystem="scheduler", labels=("reason",),
        )
