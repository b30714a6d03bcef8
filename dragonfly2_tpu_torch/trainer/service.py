"""Trainer service: receives telemetry datasets, trains, registers models.

The port of dragonfly2_tpu/trainer/service.py, running the port's trainers
and writers: ``train_mlp.train`` and ``train_gnn.train_async`` on
``TrainerConfig.device`` (the card unless the config names another), then
``save_artifact``/``save_graph``/``save_sketch``/``save_native``, digest
last. The RPC front (trainer/server.py) and the manager link come with the
wiring slice; ``manager`` is any object with the manager client's
``publish_model`` coroutine, or None.

Completes the reference's unfinished ML loop (SURVEY.md §3.4): the reference
defined the Train client-stream contract (pkg/rpc/trainer/server/server.go:59,
TrainMLPRequest/TrainGNNRequest chunks) and a trainer/ skeleton with config +
metrics but no training loop, and the manager's CreateModel was a TODO stub
(manager/rpcserver/manager_server_v2.go:739-743). Here:

  train_open → train_chunk* → train_close   (the client-stream, unrolled over
  a unary RPC; chunks are npy-serialized columnar telemetry arrays)

Ingest is incremental and the event loop stays free throughout:

  - train_chunk folds each chunk straight into the session's
    DatasetAccumulator (vectorized, sub-ms per announcer chunk) instead of
    retaining raw record arrays; train_close commits the session's
    aggregates into the shared rolling pool via merge_from — exactly-once,
    so a failed-and-retried upload never double-counts. The pool
    (pool_rows) is aggregated state + a bounded columnar pair pool, not a
    list of per-session uploads, and rotates fresh past
    pool_max_hosts/pool_max_edges.
  - train_close never blocks the caller: the session joins a queue and one
    background drainer serializes training runs.
  - Dataset materialization, the MLP train and the artifact writes run on
    worker threads; the GNN runs through train_gnn.train_async, whose
    multi-step calls run on a worker thread each, so the loop answers
    between them.
  - Sessions opened but never closed are evicted past session_ttl; an
    evicted (uncommitted) session contributes nothing to the pool.

then each run trains the MLP bandwidth predictor (config 1) and — when probe
records exist — the GraphSAGE topology scorer (config 2/3, one device),
writes artifacts, and registers + activates versions in the manager's model
registry.
"""

from __future__ import annotations

import asyncio
import collections
import io
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from dragonfly2_tpu_torch.observability.tracing import Tracer, default_tracer
from dragonfly2_tpu_torch.trainer import (
    artifacts,
    dataset as datasetlib,
    metrics as train_metrics,
    train_gnn,
    train_mlp,
)

logger = logging.getLogger(__name__)

# run manifests kept for `train_history` (one per training run, bounded)
RUN_HISTORY_CAP = 64


def pack_records(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def unpack_records(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


@dataclass
class TrainSession:
    token: str
    scheduler_hostname: str = ""
    scheduler_id: int = 0
    # every session folds into its OWN accumulator; train_close commits it
    # into the shared pool (merge_from) — exactly-once, even across retries
    acc: datasetlib.DatasetAccumulator = field(
        default_factory=datasetlib.DatasetAccumulator
    )
    rows: int = 0  # running row count — O(1) per chunk, not a per-call re-sum
    opened_at: float = field(default_factory=time.time)
    last_activity: float = field(default_factory=time.time)
    # trace context captured at train_close: the background train run
    # outlives the RPC that queued it, so its spans parent to this context
    # explicitly (the drainer task's own captured contextvar points at
    # whichever close FIRST started it — wrong for every later run)
    trace_ctx: Any = None
    # multi-source attribution (federation): every scheduler whose session
    # committed into the pool this run trains on — stamped at close time,
    # unioned when the drainer coalesces runs over the same pool
    contributors: set = field(default_factory=set)


@dataclass
class TrainerConfig:
    model_dir: str = "/tmp/dragonfly2_tpu_models"
    mlp: train_mlp.MLPTrainConfig = field(default_factory=train_mlp.MLPTrainConfig)
    gnn: train_gnn.GNNTrainConfig = field(default_factory=train_gnn.GNNTrainConfig)
    gnn_steps: int = 300
    gnn_steps_per_call: int = 10  # steps per multi-step call (the loop answers between calls)
    min_pairs: int = 16        # skip training below this much signal
    min_probe_rows: int = 8
    # Rolling dataset pool: uploads accumulate (newest pairs kept up to the
    # cap) so schedulers on short upload cadences still reach training mass;
    # 0 = train strictly on each upload in isolation.
    pool_rows: int = 500_000
    # Host/edge aggregates can't be evicted row-wise (they're sums), so the
    # pool is ROTATED — swapped for a fresh accumulator — once host churn
    # pushes it past either cap. Bounds memory and per-train graph size on a
    # long-lived trainer in a cluster with ephemeral host ids; queued
    # sessions keep a reference to the pool they folded into, so a rotation
    # never yanks data from an in-flight train. 0 disables.
    pool_max_hosts: int = 65536
    pool_max_edges: int = 1_000_000
    # Sessions opened but never closed are dropped after this many seconds
    # (checked at every open/close); 0 disables eviction.
    session_ttl: float = 3600.0
    # the device both trainers and the scorer export run on: the card (None)
    # unless the config names another; the tests pass "cpu"
    device: str | None = None


class TrainerService:
    def __init__(self, config: TrainerConfig | None = None, *, manager: Any = None):
        """manager: anything with the manager client's ``publish_model``
        coroutine (or None to skip the registry)."""
        self.cfg = config or TrainerConfig()
        self.manager = manager
        self._acc = datasetlib.DatasetAccumulator(max_pair_rows=self.cfg.pool_rows)
        # schedulers that have committed into the CURRENT pool epoch —
        # cleared on rotation with the pool it describes
        self._pool_contributors: set[tuple[int, str]] = set()
        self._sessions: dict[str, TrainSession] = {}
        self._next = 0
        self._queue: collections.deque[TrainSession] = collections.deque()  # dflint: disable=DF034 depth is bounded by one pending close per scheduler (the drainer coalesces same-pool entries); a maxlen would silently DROP a committed training run from the far end
        self._drainer: asyncio.Task | None = None
        self.last_result: dict | None = None
        self.trains_started = 0
        self.trains_succeeded = 0
        self.sessions_evicted = 0
        self.pool_rotations = 0
        self.trains_coalesced = 0
        # per-run manifests, newest last: run id, dataset size,
        # per-model step count / final loss / bounded loss curve, wall,
        # artifact paths — the `train_history` RPC's backing store and what
        # `dfml train` prints. Deliberately NOT persisted: like the manager's
        # stats-frame rings, a restarted trainer rebuilds history by training.
        self.run_history: collections.deque[dict] = collections.deque(
            maxlen=RUN_HISTORY_CAP
        )

    # ---- RPC surface (adapter passes payload dicts straight through) ----

    async def train_open(self, p: dict) -> dict:
        self._evict_stale()
        self._next += 1
        token = f"sess-{self._next}-{int(time.time())}"
        self._sessions[token] = TrainSession(
            token,
            scheduler_hostname=p.get("hostname", ""),
            scheduler_id=p.get("scheduler_id", 0),
        )
        return {"token": token}

    async def train_chunk(self, p: dict) -> dict:
        sess = self._sessions.get(p["token"])
        if sess is None:
            raise KeyError(f"unknown train session {p['token']!r}")
        arr = unpack_records(p["data"])
        if p["kind"] == "downloads":
            sess.acc.add_downloads(arr)
        elif p["kind"] == "probes":
            sess.acc.add_probes(arr)
        else:
            raise ValueError(f"unknown dataset kind {p['kind']!r}")
        sess.rows += len(arr)
        sess.last_activity = time.time()
        return {"rows": sess.rows}

    async def train_close(self, p: dict) -> dict:
        sess = self._sessions.pop(p["token"], None)
        if sess is None:
            raise KeyError(f"unknown train session {p['token']!r}")
        sess.trace_ctx = Tracer.current_context()
        self._evict_stale()
        if self.cfg.pool_rows > 0:
            # commit the session's aggregates into the shared pool — the
            # ONLY point session data becomes visible to training, so an
            # upload that failed mid-stream (and will be retried in full)
            # contributed nothing; the queued train keeps its reference to
            # THIS pool even if a later close rotates in a fresh one
            self._acc.merge_from(sess.acc)
            sess.acc = self._acc
            # federation attribution: a model trained on the pool carries
            # every scheduler that fed THIS pool epoch, not just the closer
            self._pool_contributors.add((sess.scheduler_id, sess.scheduler_hostname))
            sess.contributors = set(self._pool_contributors)
        else:
            sess.contributors = {(sess.scheduler_id, sess.scheduler_hostname)}
        # never await the previous run here: queue the session and let the
        # drainer serialize training (one run at a time) off this RPC's back
        self._queue.append(sess)
        if self._drainer is None or self._drainer.done():
            self._drainer = asyncio.ensure_future(self._drain())
        self._maybe_rotate_pool()
        return {"queued": True, "queue_depth": len(self._queue)}

    async def status(self, p: Any = None) -> dict:
        running = self._drainer is not None and not self._drainer.done()
        return {
            "training": running,
            "queue_depth": len(self._queue),
            "open_sessions": len(self._sessions),
            "pool_pairs": self._acc.pair_rows,
            "pool_hosts": self._acc.num_hosts,
            "pool_edges": self._acc.num_edges,
            "pool_rotations": self.pool_rotations,
            "trains_coalesced": self.trains_coalesced,
            "trains_started": self.trains_started,
            "trains_succeeded": self.trains_succeeded,
            "last_result": self.last_result,
        }

    async def train_history(self, p: dict | None = None) -> dict:
        """Per-run manifests, newest first (bounded at RUN_HISTORY_CAP).
        `limit` trims; `with_curves=False` drops the loss curves for a
        compact listing."""
        p = p or {}
        limit = int(p.get("limit", RUN_HISTORY_CAP))
        with_curves = bool(p.get("with_curves", True))
        runs = list(self.run_history)[-limit:][::-1]
        if not with_curves:
            runs = [
                {
                    **r,
                    "models": {
                        m: {k: v for k, v in info.items() if k != "curve"}
                        for m, info in (r.get("models") or {}).items()
                    },
                }
                for r in runs
            ]
        return {"runs": runs, "total": len(self.run_history)}

    async def wait_idle(self) -> None:
        while self._drainer is not None and not self._drainer.done():
            await self._drainer

    # ---- session lifecycle ----

    def _maybe_rotate_pool(self) -> None:
        """Aggregates (host table, edge sums, node counters) only grow —
        swap in a fresh pool once host churn blows past the caps. Sessions
        already queued hold their own reference to the old pool."""
        cfg = self.cfg
        over_hosts = cfg.pool_max_hosts > 0 and self._acc.num_hosts > cfg.pool_max_hosts
        over_edges = cfg.pool_max_edges > 0 and self._acc.num_edges > cfg.pool_max_edges
        if over_hosts or over_edges:
            logger.warning(
                "rotating dataset pool (%d hosts, %d edges, %d pairs) — aggregate caps hit",
                self._acc.num_hosts, self._acc.num_edges, self._acc.pair_rows,
            )
            self._acc = datasetlib.DatasetAccumulator(max_pair_rows=cfg.pool_rows)
            self._pool_contributors = set()
            self.pool_rotations += 1

    def _evict_stale(self) -> None:
        """Drop sessions with no traffic for session_ttl. Keyed on
        last_activity, not opened_at — an upload legitimately streaming
        chunks for longer than the TTL must not be yanked mid-stream."""
        ttl = self.cfg.session_ttl
        if ttl <= 0:
            return
        now = time.time()
        stale = [t for t, s in self._sessions.items() if now - s.last_activity > ttl]
        for token in stale:
            sess = self._sessions.pop(token)
            self.sessions_evicted += 1
            logger.warning(
                "evicting stale train session %s from %s (idle %.0fs, %d rows)",
                token, sess.scheduler_hostname, now - sess.last_activity, sess.rows,
            )

    # ---- training driver ----

    async def _drain(self) -> None:
        """Single background consumer: one training run at a time, in close
        order. train_close re-creates the task if it ever finds it done.

        Consecutive queued sessions that committed into the SAME pool are
        coalesced into one run (the pool already aggregates all of them —
        k closes landing during one slow train would otherwise trigger k
        near-identical back-to-back trains); the surviving session's
        scheduler identity is the one the registry rows carry."""
        while self._queue:
            sess = self._queue.popleft()
            while self._queue and self._queue[0].acc is sess.acc:
                nxt = self._queue.popleft()
                nxt.contributors |= sess.contributors
                sess = nxt
                self.trains_coalesced += 1
            self.trains_started += 1
            await self._train(sess)

    async def _train(self, sess: TrainSession) -> None:
        # parent = the trace of the train_close that queued this run: the
        # announcer's upload root continues through ingest into the train
        # and model publish, even though the RPC returned long ago
        t_run = time.perf_counter()
        started_at = time.time()
        try:
            with default_tracer().span(
                "trainer.train_run", parent=sess.trace_ctx,
                scheduler=sess.scheduler_hostname,
            ) as sp:
                result = await self._run_training(sess)
                self.last_result = result
                self.trains_succeeded += 1
                sp.set_attr("version", result.get("version", ""))
                sp.set_attr("num_pairs", result.get("num_pairs", 0))
                if self.manager is not None:
                    with default_tracer().span("trainer.publish"):
                        await self._register_models(sess, result)
            self._note_run(sess, result, started_at, time.perf_counter() - t_run)
        except Exception:
            logger.exception("training run failed")
            self.last_result = {"error": "training failed"}
            # same manifest shape as success/skip — ONE append path, so the
            # schema can never drift between outcomes
            self._note_run(
                sess, {"version": f"run-{self.trains_started}"},
                started_at, time.perf_counter() - t_run, status="error",
            )

    def _note_run(
        self,
        sess: TrainSession,
        result: dict,
        started_at: float,
        wall: float,
        *,
        status: str | None = None,
    ) -> None:
        """Append the run manifest + move the run-level families. A run that
        built a dataset but trained nothing (below min_pairs) is 'skipped' —
        visible in history, never conflated with a trained run; a failed run
        passes status='error' through the SAME shape."""
        models = {
            m: {
                "artifact": info.get("artifact"),
                "digest": (info.get("digest") or "")[:16],
                "evaluation": {
                    k: v for k, v in (info.get("evaluation") or {}).items()
                    if k != "contributors"
                },
                **(info.get("telemetry") or {}),
            }
            for m in ("mlp", "gnn")
            if (info := result.get(m))
        }
        if status is None:
            status = "ok" if models else "skipped"
        train_metrics.TRAIN_RUNS_TOTAL.inc(result=status)
        final = None
        if "gnn" in models:
            final = models["gnn"].get("final_loss")
        elif "mlp" in models:
            final = models["mlp"].get("final_loss")
        if final is not None and np.isfinite(final):
            train_metrics.TRAIN_LAST_RUN_LOSS.set(float(final))
        self.run_history.append({
            "run_id": result.get("version", f"run-{self.trains_started}"),
            "started_at": round(started_at, 3),
            "wall_s": round(wall, 3),
            "status": status,
            "scheduler": sess.scheduler_hostname,
            "dataset": {
                "pairs": result.get("num_pairs", 0),
                "nodes": result.get("num_nodes", 0),
                "build_seconds": result.get("build_seconds", 0.0),
            },
            "models": models,
        })

    async def _run_training(self, sess: TrainSession) -> dict:
        acc = sess.acc  # the pool it merged into at close; rotation-safe
        t_build = time.perf_counter()
        # freeze() is a cheap loop-side snapshot; the O(nodes+edges+pairs)
        # materialization runs on a worker thread while chunks keep folding
        with default_tracer().span("trainer.dataset_build"):
            frozen = acc.freeze()
            ds = await asyncio.to_thread(frozen.finalize)
        build_seconds = time.perf_counter() - t_build
        # monotonic suffix: the drainer starts queued runs back-to-back, so
        # two runs inside the same wall-clock second are the normal case and
        # a bare timestamp would collide artifact dirs + registry versions
        version = f"v{int(time.time())}-{self.trains_started}"
        out: dict[str, Any] = {
            "version": version,
            "num_pairs": ds.num_pairs,
            "num_nodes": ds.num_nodes,
            "build_seconds": round(build_seconds, 4),
        }

        if ds.num_pairs >= self.cfg.min_pairs:
            tr, ev = datasetlib.split_pairs(ds.pairs)
            mlp_tel = train_metrics.TrainRunTelemetry(
                "mlp", batch_size=min(self.cfg.mlp.batch_size, len(tr.child))
            )
            t0 = time.perf_counter()
            with default_tracer().span("trainer.train_mlp", pairs=ds.num_pairs):
                model, evaluation = await asyncio.to_thread(
                    train_mlp.train, self.cfg.mlp, tr, eval_pairs=ev,
                    log=logger.info, telemetry=mlp_tel, device=self.cfg.device,
                )
            evaluation["train_seconds"] = round(time.perf_counter() - t0, 2)
            def _save_mlp() -> tuple[Path, str]:
                path = artifacts.save_artifact(
                    Path(self.cfg.model_dir) / f"mlp-{version}",
                    model_type="mlp", version=version, params=model,
                    config={"hidden": list(self.cfg.mlp.hidden)},
                )
                if ds.feature_sketch is not None:
                    # the training-reference feature sketch rides the
                    # artifact — written BEFORE the digest, so it is
                    # integrity-covered like every other file
                    artifacts.save_sketch(path, ds.feature_sketch)
                return path, artifacts.artifact_digest(path)

            path, digest = await asyncio.to_thread(_save_mlp)
            out["mlp"] = {
                "artifact": str(path), "digest": digest,
                "evaluation": evaluation, "telemetry": mlp_tel.summary(),
            }

        if ds.num_pairs >= self.cfg.min_pairs and acc.probe_rows >= self.cfg.min_probe_rows:
            cfg = self.cfg.gnn
            gnn_tel = train_metrics.TrainRunTelemetry(
                "gnn", batch_size=cfg.batch_size
            )
            t0 = time.perf_counter()
            with default_tracer().span("trainer.train_gnn", nodes=ds.num_nodes):
                state, losses = await train_gnn.train_async(
                    cfg, ds.graph, ds.pairs,
                    steps=self.cfg.gnn_steps,
                    steps_per_call=self.cfg.gnn_steps_per_call,
                    device=self.cfg.device,
                    log=logger.info,
                    telemetry=gnn_tel,
                )
            train_seconds = time.perf_counter() - t0
            evaluation = {
                "final_loss": losses[-1] if losses else float("nan"),
                "steps": len(losses),
                "train_seconds": round(train_seconds, 2),
                "steps_per_sec": round(len(losses) / max(1e-9, train_seconds), 2),
            }

            def _save_gnn() -> tuple[Path, str]:
                path = artifacts.save_artifact(
                    Path(self.cfg.model_dir) / f"gnn-{version}",
                    model_type="gnn", version=version, params=state.model,
                    config={
                        "hidden": cfg.hidden, "embed_dim": cfg.embed_dim,
                        "num_layers": cfg.num_layers,
                    },
                )
                artifacts.save_graph(path, ds.graph, ds.host_index)
                if ds.feature_sketch is not None:
                    # training-reference sketch, digest-covered: the serving
                    # scheduler compares live scoring features against THIS
                    # distribution (feature drift)
                    artifacts.save_sketch(path, ds.feature_sketch)
                try:
                    artifacts.save_native(
                        path, train_gnn.make_model(cfg), state.model.state_dict(), ds.graph,
                        device=self.cfg.device,
                    )
                except Exception:
                    # native serving is an optimization; the params artifact always works
                    logger.exception("native scorer export failed; params artifact only")
                # digest LAST: it must cover every file the loader will read
                return path, artifacts.artifact_digest(path)

            path, digest = await asyncio.to_thread(_save_gnn)
            out["gnn"] = {
                "artifact": str(path), "digest": digest,
                "evaluation": evaluation, "telemetry": gnn_tel.summary(),
            }
        return out

    async def _register_models(self, sess: TrainSession, result: dict) -> None:
        """Finish the reference's CreateModel stub: version rows + activation.

        Models register CLUSTER-WIDE (scheduler_id 0): ONE trainer ingests
        telemetry from every federation member and each member's model watch
        falls back to the scheduler_id-0 row, so a single activation fans the
        version out to all of them. The evaluation dict carries the
        contributing schedulers — the attribution proof the cross-scheduler
        cluster test pins."""
        contributors = sorted(
            name or f"scheduler-{sid}" for sid, name in sess.contributors
        )
        for mtype in ("mlp", "gnn"):
            info = result.get(mtype)
            if not info:
                continue
            try:
                # publish_model routes through the manager's rollout policy:
                # gated types land as CANDIDATE and earn activation through
                # the shadow window; ungated types activate immediately (the
                # default with no policy).
                # The artifact digest rides the row so schedulers verify
                # integrity before attach.
                row = await self.manager.publish_model(
                    mtype, result["version"],
                    scheduler_id=0,
                    evaluation={**info["evaluation"], "contributors": contributors},
                    artifact_path=info["artifact"],
                    artifact_digest=info.get("digest", ""),
                )
                logger.info(
                    "model %s %s registered (state=%s)",
                    mtype, result["version"], row.get("state"),
                )
            except Exception:
                logger.exception("model registry update failed for %s", mtype)
