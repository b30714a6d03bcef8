"""Manager business logic: cluster CRUD, instance registry, models, configs.

The port's own copy of dragonfly2_tpu/manager/service.py, whole: the users and
OAuth methods serve the REST front (``manager/rest.py``).

Reference equivalent: manager/rpcserver/manager_server_v2.go:95-746 (the gRPC
surface schedulers/daemons use: GetScheduler, ListSchedulers, UpdateScheduler,
UpdateSeedPeer, KeepAlive, ListApplications, CreateModel — the last a TODO
stub at :739-743 that this implementation completes) + manager/service/ (REST
business logic). The KeepAlive stream becomes periodic `keepalive` RPCs with
a TTL reaper marking instances inactive (ref relies on stream close).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Optional

from dragonfly2_tpu_torch.manager import searcher
from dragonfly2_tpu_torch.manager.db import Database

logger = logging.getLogger(__name__)

STATE_ACTIVE = "active"
STATE_INACTIVE = "inactive"

MODEL_GNN = "gnn"
MODEL_MLP = "mlp"

DEFAULT_KEEPALIVE_TTL = 60.0  # reference reaps on stream close; we reap on TTL

# cluster metrics plane: frames kept per member ring. At the 20 s
# scheduler keepalive default this is ~20 min of history per member; frames
# are a few hundred bytes each, so the whole plane is bounded at
# members * STATS_FRAMES_KEPT * frame size. Members silent past
# STATS_EVICT_TTL_FACTOR x keepalive_ttl are EVICTED from the ring entirely
# (between 2x and that they show as "stale" so dftop names who went dark) —
# without the eviction horizon, hostname churn (k8s pod names, chaos tests)
# would grow _member_stats and every cluster_stats response forever.
STATS_FRAMES_KEPT = 64
STATS_EVICT_TTL_FACTOR = 10.0


class ManagerService:
    def __init__(
        self,
        db: Database | None = None,
        *,
        keepalive_ttl: float = DEFAULT_KEEPALIVE_TTL,
        searcher_spec: str = "default",
    ):
        self.db = db or Database()
        self.keepalive_ttl = keepalive_ttl
        # cluster-scoring is plugin-overridable (ref searcher/plugin.go)
        self.searcher = searcher.new_searcher(searcher_spec)
        self._reaper_task: asyncio.Task | None = None
        # cluster metrics plane: per-member stats-frame rings,
        # keyed (source_type, hostname). Deliberately NOT in the DB: frames
        # are ephemeral telemetry — a restarted manager rebuilds the view
        # within one keepalive tick, exactly like the reference's in-memory
        # KeepAlive stream state.
        self._member_stats: dict[tuple[str, str], dict] = {}

    # ---------- scheduler clusters ----------

    def create_scheduler_cluster(
        self,
        name: str,
        *,
        bio: str = "",
        config: dict | None = None,
        client_config: dict | None = None,
        scopes: dict | None = None,
        is_default: bool = False,
    ) -> dict:
        row_id = self.db.insert(
            "scheduler_clusters",
            name=name,
            bio=bio,
            config=config or {},
            client_config=client_config or {},
            scopes=scopes or {},
            is_default=is_default,
        )
        return self.db.get("scheduler_clusters", row_id)

    def get_or_create_default_cluster(self) -> dict:
        row = self.db.find_one("scheduler_clusters", is_default=True)
        if row is None:
            row = self.create_scheduler_cluster("default", is_default=True)
        return row

    # ---------- instance registry (schedulers / seed peers) ----------

    def update_scheduler(
        self,
        hostname: str,
        ip: str,
        port: int,
        *,
        scheduler_cluster_id: int | None = None,
        idc: str = "",
        location: str = "",
        features: list[str] | None = None,
    ) -> dict:
        """Register or refresh a scheduler instance (ref UpdateScheduler)."""
        if scheduler_cluster_id is None:
            scheduler_cluster_id = self.get_or_create_default_cluster()["id"]
        return self.db.upsert(
            "schedulers",
            {"hostname": hostname, "scheduler_cluster_id": scheduler_cluster_id},
            ip=ip,
            port=port,
            idc=idc,
            location=location,
            features=features or ["schedule", "preheat"],
            state=STATE_ACTIVE,
            last_keepalive=time.time(),
        )

    def update_seed_peer(
        self,
        hostname: str,
        ip: str,
        port: int,
        *,
        download_port: int = 0,
        object_storage_port: int = 0,
        seed_peer_cluster_id: int | None = None,
        peer_type: str = "super",
        idc: str = "",
        location: str = "",
    ) -> dict:
        if seed_peer_cluster_id is None:
            row = self.db.find_one("seed_peer_clusters", name="default")
            if row is None:
                cid = self.db.insert("seed_peer_clusters", name="default", config={})
                default_sched = self.get_or_create_default_cluster()
                self.db.link_clusters(cid, default_sched["id"])
                row = self.db.get("seed_peer_clusters", cid)
            seed_peer_cluster_id = row["id"]
        return self.db.upsert(
            "seed_peers",
            {"hostname": hostname, "seed_peer_cluster_id": seed_peer_cluster_id},
            ip=ip,
            port=port,
            download_port=download_port,
            object_storage_port=object_storage_port,
            type=peer_type,
            idc=idc,
            location=location,
            state=STATE_ACTIVE,
            last_keepalive=time.time(),
        )

    def keepalive(
        self,
        source_type: str,
        hostname: str,
        cluster_id: int | None = None,
        stats: dict | None = None,
    ) -> bool:
        """Refresh liveness (ref KeepAlive stream, manager_server_v2.go:746).

        `stats` is the optional compact stats frame services
        piggyback on their existing keepalive tick — recorded into the
        member ring, zero extra RPCs. Daemons and the trainer have no
        registry table; their keepalive is stats-only and liveness lives in
        the member ring's last_seen."""
        if stats is not None:
            self.report_stats(source_type, hostname, stats)
        if source_type not in ("scheduler", "seed_peer"):
            return stats is not None
        table = "schedulers" if source_type == "scheduler" else "seed_peers"
        key = "scheduler_cluster_id" if source_type == "scheduler" else "seed_peer_cluster_id"
        where: dict[str, Any] = {"hostname": hostname}
        if cluster_id is not None:
            where[key] = cluster_id
        n = self.db.update_where(
            table, where, state=STATE_ACTIVE, last_keepalive=time.time()
        )
        return n > 0

    # ---------- cluster metrics plane ----------

    def report_stats(self, source_type: str, hostname: str, frame: dict) -> bool:
        """Record one member's stats frame (rides keepalive, or stands alone
        via the report_stats RPC)."""
        from collections import deque

        if not isinstance(frame, dict):
            raise ValueError("stats frame must be a dict")
        self._evict_silent_members(time.time())
        key = (str(source_type), str(hostname or "unknown"))
        entry = self._member_stats.get(key)
        if entry is None:
            entry = self._member_stats[key] = {
                "frames": deque(maxlen=STATS_FRAMES_KEPT),
            }
        entry["frames"].append(frame)
        entry["last_seen"] = time.time()
        return True

    def _evict_silent_members(self, now: float) -> None:
        """Drop members silent past the eviction horizon — runs on both the
        report path and the read path so a manager nobody queries still
        doesn't accumulate churned hostnames forever. O(members) per call,
        noise at control-plane rates."""
        evict_after = max(
            self.keepalive_ttl * STATS_EVICT_TTL_FACTOR, self.keepalive_ttl * 2
        )
        for key in [
            k for k, e in self._member_stats.items()
            if now - e.get("last_seen", 0.0) > evict_after
        ]:
            del self._member_stats[key]

    def cluster_stats(self, *, history: int = 0) -> dict:
        """The whole cluster as one view: per-member latest frames plus
        cluster rollups (summed rates, alert union). Members silent past
        2x the keepalive TTL are marked stale and excluded from rollups —
        their last frame stays visible so dftop shows WHO went dark, not
        just a shorter table. `history` > 0 additionally returns the last N
        frames per member (sparklines / debugging)."""
        now = time.time()
        stale_after = self.keepalive_ttl * 2
        self._evict_silent_members(now)
        members: list[dict] = []
        rollup_rates: dict[str, float] = {}
        alerts: list[dict] = []
        live = 0
        for (source_type, hostname), entry in sorted(self._member_stats.items()):
            frames = entry["frames"]
            if not frames:
                continue
            latest = frames[-1]
            age = now - entry["last_seen"]
            stale = age > stale_after
            m: dict[str, Any] = {
                "source_type": source_type,
                "hostname": hostname,
                "age_s": round(age, 1),
                "stale": stale,
                "frame": latest,
            }
            if history > 0:
                m["history"] = list(frames)[-history:]
            members.append(m)
            if stale:
                continue
            live += 1
            for k, v in (latest.get("rates") or {}).items():
                if isinstance(v, (int, float)):
                    rollup_rates[k] = rollup_rates.get(k, 0.0) + float(v)
            for name in latest.get("alerts") or ():
                alerts.append({"name": name, "member": hostname, "source_type": source_type})
        return {
            "ts": now,
            "members": members,
            "cluster": {
                "members_live": live,
                "members_stale": len(members) - live,
                "rates": {k: round(v, 3) for k, v in sorted(rollup_rates.items())},
                "alerts": alerts,
            },
        }

    def reap_stale(self) -> int:
        """Mark instances inactive when keepalives stop."""
        cutoff = time.time() - self.keepalive_ttl
        n = 0
        for table in ("schedulers", "seed_peers"):
            for row in self.db.find(table, state=STATE_ACTIVE):
                if row["last_keepalive"] < cutoff:
                    self.db.update(table, row["id"], state=STATE_INACTIVE)
                    n += 1
        return n

    async def run_reaper(self, interval: float | None = None) -> None:
        interval = interval or max(self.keepalive_ttl / 3, 1.0)
        while True:
            await asyncio.sleep(interval)
            try:
                self.reap_stale()
            except Exception:
                logger.exception("reaper pass failed")

    # ---------- peer-facing discovery (ref ListSchedulers + searcher) ----------

    def list_schedulers(
        self, ip: str = "", conditions: dict[str, str] | None = None
    ) -> list[dict]:
        """Active schedulers of the best-matching clusters, best first."""
        clusters = self.db.find("scheduler_clusters")
        active: dict[int, list[dict]] = {}
        for s in self.db.find("schedulers", state=STATE_ACTIVE):
            active.setdefault(s["scheduler_cluster_id"], []).append(s)
        ranked = self.searcher.find_scheduler_clusters(
            clusters, ip, conditions,
            has_active_schedulers={cid: True for cid in active},
        )
        out: list[dict] = []
        for c in ranked:
            out.extend(active.get(c["id"], []))
        return out

    def get_scheduler(self, hostname: str, scheduler_cluster_id: int) -> Optional[dict]:
        return self.db.find_one(
            "schedulers", hostname=hostname, scheduler_cluster_id=scheduler_cluster_id
        )

    def list_seed_peers(self, scheduler_cluster_id: int | None = None) -> list[dict]:
        """Seed peers serving a scheduler cluster (via the many2many link)."""
        if scheduler_cluster_id is None:
            return self.db.find("seed_peers", state=STATE_ACTIVE)
        out = []
        for spc_id in self.db.linked_seed_peer_clusters(scheduler_cluster_id):
            out.extend(
                self.db.find("seed_peers", seed_peer_cluster_id=spc_id, state=STATE_ACTIVE)
            )
        return out

    # ---------- cluster config for dynconfig consumers ----------

    def cluster_config(self, scheduler_cluster_id: int) -> dict:
        """What a scheduler/daemon pulls via dynconfig: cluster config blobs +
        current scheduler and seed-peer address books."""
        cluster = self.db.get("scheduler_clusters", scheduler_cluster_id)
        if cluster is None:
            return {}
        return {
            "cluster_id": cluster["id"],
            "config": cluster["config"],
            "client_config": cluster["client_config"],
            "schedulers": [
                {"hostname": s["hostname"], "ip": s["ip"], "port": s["port"]}
                for s in self.db.find(
                    "schedulers",
                    scheduler_cluster_id=scheduler_cluster_id,
                    state=STATE_ACTIVE,
                )
            ],
            "seed_peers": [
                {
                    "hostname": s["hostname"], "ip": s["ip"], "port": s["port"],
                    "download_port": s["download_port"], "type": s["type"],
                }
                for s in self.list_seed_peers(scheduler_cluster_id)
            ],
        }

    # ---------- model registry + rollout state machine ----------
    #
    # Completes ref CreateModel TODO, then adds the safe-rollout lifecycle:
    #
    #     candidate → shadowing → active | rejected       (shadow gate)
    #     active → rejected, previous → active            (rollback)
    #
    # The policy (which types are gated, the divergence bounds, whether a
    # passing window auto-promotes) lives in the `model_rollout` config row;
    # with no policy configured publish_model() activates directly — the
    # behavior before the rollout gate existed.

    def rollout_policy(self):
        from dragonfly2_tpu_torch.scheduler.rollout import RolloutPolicy

        row = self.get_config("model_rollout")
        return RolloutPolicy.from_config(row["value"] if row else None)

    def create_model(
        self,
        model_type: str,
        version: str,
        *,
        scheduler_id: int = 0,
        bio: str = "",
        evaluation: dict | None = None,
        artifact_path: str = "",
        artifact_digest: str = "",
    ) -> dict:
        if model_type not in (MODEL_GNN, MODEL_MLP):
            raise ValueError(f"unknown model type {model_type!r}")
        return self.db.upsert(
            "models",
            {"type": model_type, "version": version, "scheduler_id": scheduler_id},
            bio=bio,
            evaluation=evaluation or {},
            artifact_path=artifact_path,
            artifact_digest=artifact_digest,
        )

    def publish_model(
        self,
        model_type: str,
        version: str,
        *,
        scheduler_id: int = 0,
        bio: str = "",
        evaluation: dict | None = None,
        artifact_path: str = "",
        artifact_digest: str = "",
    ) -> dict:
        """The trainer's registration entry: create the version row and route
        it through the rollout policy — gated types start as CANDIDATE (the
        schedulers' shadow reports drive promotion), ungated types activate
        immediately (the pre-rollout behavior, and the default)."""
        from dragonfly2_tpu_torch.scheduler.rollout import STATE_CANDIDATE

        row = self.create_model(
            model_type, version, scheduler_id=scheduler_id, bio=bio,
            evaluation=evaluation, artifact_path=artifact_path,
            artifact_digest=artifact_digest,
        )
        policy = self.rollout_policy()
        if not policy.gated(model_type):
            return self.activate_model(row["id"])
        from dragonfly2_tpu_torch.scheduler.rollout import STATE_SHADOWING

        # continual training: a NEWER candidate supersedes any still-pending
        # one of the same (type, scheduler) — schedulers already shadow only
        # the newest, so the displaced row would otherwise sit "shadowing"
        # forever and the candidate list would grow with every train run
        # (observed live under a 3 s upload cadence)
        for state in (STATE_CANDIDATE, STATE_SHADOWING):
            for stale in self.db.find(
                "models", type=model_type, scheduler_id=scheduler_id, state=state
            ):
                if stale["id"] != row["id"]:
                    self.reject_model(stale["id"], f"superseded by {version}")
        rollout = dict(row.get("rollout") or {})
        rollout.update(
            gates=policy.gates.to_dict(),
            auto_promote=policy.auto_promote,
            schedulers={},
        )
        self._model_event(rollout, "published as candidate")
        self.db.update("models", row["id"], state=STATE_CANDIDATE, rollout=rollout)
        logger.info(
            "model %s %s registered as rollout candidate (gate: >=%d shadow rounds)",
            model_type, version, policy.gates.min_rounds,
        )
        return self.db.get("models", row["id"])

    @staticmethod
    def _model_event(rollout: dict, event: str) -> None:
        history = rollout.setdefault("history", [])
        history.append({"at": time.time(), "event": event})
        del history[:-20]  # bounded operator breadcrumb trail

    def activate_model(self, model_id: int) -> dict:
        """Make this version active; deactivate siblings of the same
        (type, scheduler) — the reference's per-scheduler unique active
        version semantics (models/model.go:19-27). Records the version it
        displaced in the row's rollout state so rollback_model knows where
        to return to."""
        from dragonfly2_tpu_torch.observability.tracing import default_tracer

        row = self.db.get("models", model_id)
        if row is None:
            raise KeyError(model_id)
        # the activation is the ML loop's terminal hop: when the trainer's
        # publish carried trace context over the RPC, the trace now runs
        # announcer.upload → trainer.train_run → here, end to end
        with default_tracer().span(
            "manager.activate_model",
            model_id=model_id, model_type=row["type"], version=row["version"],
        ):
            previous = self.active_model(row["type"], row["scheduler_id"])
            rollout = dict(row.get("rollout") or {})
            if previous is not None and previous["id"] != model_id:
                rollout["previous_active_id"] = previous["id"]
                rollout["previous_active_version"] = previous["version"]
            self._model_event(rollout, "activated")
            self.db.update_where(
                "models",
                {"type": row["type"], "scheduler_id": row["scheduler_id"], "state": STATE_ACTIVE},
                state=STATE_INACTIVE,
            )
            self.db.update("models", model_id, state=STATE_ACTIVE, rollout=rollout)
        return self.db.get("models", model_id)

    def promote_model(self, model_id: int) -> dict:
        """candidate | shadowing → active (operator `dfmodel promote`, or the
        auto-promotion path when a shadow window passes its gates). Also
        accepts an inactive row — the manual re-pin an operator needs after
        a bad rollback. Rejected rows stay rejected: re-promoting a version
        the gate (or a rollback) refused requires re-publishing it."""
        from dragonfly2_tpu_torch.scheduler.rollout import (
            STATE_CANDIDATE, STATE_REJECTED, STATE_SHADOWING,
        )

        row = self.db.get("models", model_id)
        if row is None:
            raise KeyError(model_id)
        if row["state"] == STATE_ACTIVE:
            return row  # idempotent
        if row["state"] == STATE_REJECTED:
            raise ValueError(
                f"model {row['version']} is rejected; republish it instead of promoting"
            )
        if row["state"] not in (STATE_CANDIDATE, STATE_SHADOWING, STATE_INACTIVE):
            raise ValueError(f"cannot promote model in state {row['state']!r}")
        return self.activate_model(model_id)

    def reject_model(self, model_id: int, reason: str = "") -> dict:
        """candidate | shadowing → rejected (failed gates, corrupt artifact,
        or operator veto). Terminal: the version never serves."""
        from dragonfly2_tpu_torch.scheduler.rollout import (
            STATE_CANDIDATE, STATE_REJECTED, STATE_SHADOWING,
        )

        row = self.db.get("models", model_id)
        if row is None:
            raise KeyError(model_id)
        if row["state"] == STATE_REJECTED:
            return row  # idempotent
        if row["state"] not in (STATE_CANDIDATE, STATE_SHADOWING):
            raise ValueError(f"cannot reject model in state {row['state']!r}")
        rollout = dict(row.get("rollout") or {})
        rollout["rejected_reason"] = reason
        self._model_event(rollout, f"rejected: {reason}" if reason else "rejected")
        self.db.update("models", model_id, state=STATE_REJECTED, rollout=rollout)
        logger.warning("model %s %s REJECTED: %s", row["type"], row["version"], reason)
        return self.db.get("models", model_id)

    def rollback_model(
        self, model_type: str, scheduler_id: int = 0, *, reason: str = ""
    ) -> dict:
        """active → rejected, previous active → active. The registry half of
        the auto-rollback (the scheduler has already re-attached its warm
        previous bundle when it calls this; operators reach it via `dfmodel
        rollback`). The restored row's own previous-pointer is left
        untouched so a second rollback keeps walking BACK, never bounces
        onto the row just rejected."""
        from dragonfly2_tpu_torch.scheduler.rollout import STATE_REJECTED

        bad = self.active_model(model_type, scheduler_id)
        if bad is None:
            raise ValueError(f"no active {model_type} model to roll back")
        rollout = dict(bad.get("rollout") or {})
        prev_id = rollout.get("previous_active_id")
        if prev_id is None:
            # fall back to the newest inactive sibling — a registry that
            # predates rollout bookkeeping still has the displaced rows
            siblings = [
                r for r in self.db.find(
                    "models", type=model_type, scheduler_id=scheduler_id,
                    state=STATE_INACTIVE,
                )
                if r["id"] != bad["id"]
            ]
            if not siblings:
                raise ValueError(
                    f"active {model_type} model {bad['version']} has no previous "
                    "version to roll back to"
                )
            prev_id = max(siblings, key=lambda r: r["updated_at"])["id"]
        prev = self.db.get("models", prev_id)
        if prev is None:
            raise ValueError(f"previous model row {prev_id} is gone")
        rollout["rejected_reason"] = reason or "rolled back"
        self._model_event(rollout, f"rolled back: {reason}" if reason else "rolled back")
        self.db.update("models", bad["id"], state=STATE_REJECTED, rollout=rollout)
        prev_rollout = dict(prev.get("rollout") or {})
        self._model_event(prev_rollout, f"re-activated by rollback of {bad['version']}")
        self.db.update("models", prev["id"], state=STATE_ACTIVE, rollout=prev_rollout)
        logger.warning(
            "model %s ROLLED BACK: %s -> %s (%s)",
            model_type, bad["version"], prev["version"], reason or "health regression",
        )
        return {
            "rolled_back": self.db.get("models", bad["id"]),
            "active": self.db.get("models", prev["id"]),
        }

    def report_shadow(self, model_id: int, hostname: str, report: dict) -> dict:
        """One scheduler's shadow-window report for a candidate. Merges it
        into the row (per-scheduler, cluster-wide aggregate recomputed),
        drives candidate → shadowing on first contact, and — when the
        aggregate window closes — promotes or rejects per the stored gates.
        Returns {"state", "verdict", "reasons", "aggregate"} so the reporter
        learns the decision on the same RPC.

        A report carrying "error" (corrupt artifact, load failure) rejects
        the candidate immediately: an artifact that cannot attach anywhere
        must not keep the rollout pending forever."""
        from dragonfly2_tpu_torch.scheduler.rollout import (
            DivergenceGates, STATE_CANDIDATE, STATE_SHADOWING, merge_reports,
        )

        row = self.db.get("models", model_id)
        if row is None:
            raise KeyError(model_id)
        state = row["state"]
        if state not in (STATE_CANDIDATE, STATE_SHADOWING):
            # promotion/rejection raced this report — answer with the truth
            return {"state": state, "verdict": None, "reasons": [], "aggregate": {}}
        rollout = dict(row.get("rollout") or {})
        if report.get("error"):
            rejected = self.reject_model(
                model_id, f"{hostname}: {report['error']}"
            )
            return {
                "state": rejected["state"], "verdict": False,
                "reasons": [report["error"]], "aggregate": {},
            }
        per_sched = dict(rollout.get("schedulers") or {})
        per_sched[hostname or "scheduler"] = report
        rollout["schedulers"] = per_sched
        aggregate = merge_reports(list(per_sched.values()))
        rollout["aggregate"] = aggregate
        if state == STATE_CANDIDATE:
            state = STATE_SHADOWING
            self._model_event(rollout, f"shadowing started ({hostname})")
        gates = DivergenceGates.from_dict(rollout.get("gates"))
        verdict, reasons = gates.evaluate(aggregate)
        if verdict is None or not rollout.get("auto_promote", True):
            self.db.update("models", model_id, state=state, rollout=rollout)
            if verdict is not None:
                # window closed but promotion is manual — surface the verdict
                rollout["gate_verdict"] = {"passed": verdict, "reasons": reasons}
                self.db.update("models", model_id, rollout=rollout)
            return {
                "state": state, "verdict": verdict,
                "reasons": reasons, "aggregate": aggregate,
            }
        self.db.update("models", model_id, state=state, rollout=rollout)
        if verdict:
            promoted = self.promote_model(model_id)
            logger.info(
                "model %s %s PROMOTED by shadow gate (%d rounds)",
                row["type"], row["version"], aggregate.get("rounds", 0),
            )
            return {
                "state": promoted["state"], "verdict": True,
                "reasons": [], "aggregate": aggregate,
            }
        rejected = self.reject_model(model_id, "; ".join(reasons))
        return {
            "state": rejected["state"], "verdict": False,
            "reasons": reasons, "aggregate": aggregate,
        }

    def rollout_status(self, model_type: str, scheduler_id: int = 0) -> dict:
        """Everything the scheduler watch loop and `dfmodel status` need in
        one call: the active row, candidate/shadowing rows (cluster-wide
        scheduler_id-0 rows included, federation semantics), recent rejects,
        and the effective policy."""
        from dragonfly2_tpu_torch.scheduler.rollout import (
            STATE_CANDIDATE, STATE_REJECTED, STATE_SHADOWING,
        )

        active = self.active_model(model_type, scheduler_id)
        if active is None and scheduler_id:
            active = self.active_model(model_type, 0)
        sids = {scheduler_id, 0}
        candidates = [
            r
            for state in (STATE_CANDIDATE, STATE_SHADOWING)
            for r in self.db.find("models", type=model_type, state=state)
            if r["scheduler_id"] in sids
        ]
        candidates.sort(key=lambda r: r["id"])
        rejected = [
            r for r in self.db.find("models", type=model_type, state=STATE_REJECTED)
            if r["scheduler_id"] in sids
        ]
        policy = self.rollout_policy()
        return {
            "type": model_type,
            "active": active,
            "candidates": candidates,
            "rejected": rejected[-3:],
            "policy": {
                "enabled": policy.enabled,
                "gated": policy.gated(model_type),
                "auto_promote": policy.auto_promote,
                "gates": policy.gates.to_dict(),
            },
        }

    def active_model(self, model_type: str, scheduler_id: int = 0) -> Optional[dict]:
        return self.db.find_one(
            "models", type=model_type, scheduler_id=scheduler_id, state=STATE_ACTIVE
        )

    def list_models(self, **where: Any) -> list[dict]:
        return self.db.find("models", **where)

    def delete_model(self, model_id: int) -> bool:
        return self.db.delete("models", model_id)

    # ---------- applications / configs ----------

    def upsert_application(self, name: str, *, url: str = "", bio: str = "", priority: dict | None = None) -> dict:
        return self.db.upsert(
            "applications", {"name": name}, url=url, bio=bio, priority=priority or {}
        )

    def list_applications(self) -> list[dict]:
        return self.db.find("applications")

    def set_config(self, name: str, value: dict, *, bio: str = "") -> dict:
        return self.db.upsert("configs", {"name": name}, value=value, bio=bio)

    def get_config(self, name: str) -> Optional[dict]:
        return self.db.find_one("configs", name=name)

    # ---- users + auth (ref manager/handlers/user.go + middlewares/jwt.go) ----

    @staticmethod
    def _hash_password(password: str, salt: bytes | None = None) -> str:
        import hashlib
        import os as _os

        salt = salt or _os.urandom(16)
        digest = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8, p=1)
        return salt.hex() + "$" + digest.hex()

    @classmethod
    def _check_password(cls, password: str, stored: str) -> bool:
        import hmac as _hmac

        try:
            salt_hex, _ = stored.split("$", 1)
        except ValueError:
            return False
        return _hmac.compare_digest(
            cls._hash_password(password, bytes.fromhex(salt_hex)), stored
        )

    def create_user(
        self, name: str, password: str, *, role: str = "guest", email: str = ""
    ) -> dict:
        if self.db.find_one("users", name=name) is not None:
            raise ValueError(f"user {name!r} exists")
        row_id = self.db.insert(
            "users", name=name, email=email,
            password_hash=self._hash_password(password), role=role,
        )
        return self._public_user(self.db.get("users", row_id))

    def verify_user(self, name: str, password: str) -> Optional[dict]:
        row = self.db.find_one("users", name=name)
        if row is None or row.get("state") != "enable":
            return None
        if not self._check_password(password, row.get("password_hash", "")):
            return None
        return self._public_user(row)

    def list_users(self) -> list[dict]:
        return [self._public_user(r) for r in self.db.find("users")]

    def update_user_role(self, name: str, role: str) -> bool:
        return self.db.update_where("users", {"name": name}, role=role) > 0

    def delete_user(self, name: str) -> bool:
        row = self.db.find_one("users", name=name)
        return row is not None and self.db.delete("users", row["id"])

    @staticmethod
    def _public_user(row: dict) -> dict:
        return {k: v for k, v in row.items() if k != "password_hash"}

    def upsert_oauth_user(self, provider: str, login: str, *, email: str = "") -> dict:
        """Provision/refresh a user signed in via an OAuth provider (ref
        handlers/oauth.go callback path).

        The stored name is NAMESPACED as "<provider>/<login>": a provider
        login can therefore never collide with (or take over) a local
        account — an attacker owning the IdP login "admin" gets the fresh
        guest account "github/admin", not the bootstrapped admin. Roles are
        preserved per namespaced account; disabled accounts are refused the
        same way password sign-in refuses them."""
        name = f"{provider}/{login}"
        row = self.db.find_one("users", name=name)
        if row is None:
            row_id = self.db.insert("users", name=name, email=email, role="guest")
            row = self.db.get("users", row_id)
        else:
            if row.get("state") != "enable":
                raise ValueError(f"user {name!r} is disabled")
            if email and row.get("email") != email:
                self.db.update("users", row["id"], email=email)
                row = self.db.get("users", row["id"])
        return self._public_user(row)

    # ---- oauth provider registry (ref manager/models/oauth.go) ----

    _OAUTH_FIELDS = ("bio", "client_id", "client_secret", "auth_url", "token_url",
                     "user_info_url", "scopes", "redirect_url")

    _OAUTH_REQUIRED = ("client_id", "client_secret", "auth_url", "token_url")

    @classmethod
    def _validate_oauth_fields(cls, fields: dict[str, Any]) -> None:
        unknown = set(fields) - set(cls._OAUTH_FIELDS)
        if unknown:
            raise ValueError(f"unknown oauth fields: {sorted(unknown)}")
        for req in cls._OAUTH_REQUIRED:
            if req in fields and not fields[req]:
                raise ValueError(f"oauth field {req} must not be empty")
        scopes = fields.get("scopes")
        if scopes is not None and (
            not isinstance(scopes, list) or not all(isinstance(s, str) for s in scopes)
        ):
            raise ValueError("scopes must be a list of strings")

    def create_oauth(self, name: str, **fields: Any) -> dict:
        if self.db.find_one("oauth", name=name) is not None:
            raise ValueError(f"oauth provider {name!r} exists")
        self._validate_oauth_fields(fields)
        for req in self._OAUTH_REQUIRED:
            if not fields.get(req):
                raise ValueError(f"oauth provider requires {req}")
        row_id = self.db.insert("oauth", name=name, **fields)
        return self._public_oauth(self.db.get("oauth", row_id))

    def get_oauth(self, oauth_id: int, *, with_secret: bool = False) -> Optional[dict]:
        row = self.db.get("oauth", oauth_id)
        if row is None:
            return None
        return dict(row) if with_secret else self._public_oauth(row)

    def get_oauth_by_name(self, name: str, *, with_secret: bool = False) -> Optional[dict]:
        row = self.db.find_one("oauth", name=name)
        if row is None:
            return None
        return dict(row) if with_secret else self._public_oauth(row)

    def list_oauth(self) -> list[dict]:
        return [self._public_oauth(r) for r in self.db.find("oauth")]

    def update_oauth(self, oauth_id: int, **fields: Any) -> Optional[dict]:
        self._validate_oauth_fields(fields)
        existing = self.db.get("oauth", oauth_id)
        if existing is None:
            return None
        if fields:
            self.db.update("oauth", oauth_id, **fields)
        return self._public_oauth(self.db.get("oauth", oauth_id))

    def delete_oauth(self, oauth_id: int) -> bool:
        return self.db.delete("oauth", oauth_id)

    @staticmethod
    def _public_oauth(row: dict) -> dict:
        return {k: v for k, v in row.items() if k != "client_secret"}
