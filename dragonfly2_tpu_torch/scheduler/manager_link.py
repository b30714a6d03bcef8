"""Scheduler ↔ manager integration: registration, keepalive, dynconfig, jobs,
the seed-peer trigger client, the model watch, and the scheduler's model
loader.

The port's own copy of dragonfly2_tpu/scheduler/manager_link.py:

- ``SeedPeerConnector`` and ``ManagerLink`` whole: registration, keepalive
  carrying the stats frame, outage detection (two failed keepalives), the
  frozen rollout watch and the jittered rejoin, dynconfig and the address
  book (the federation's membership), the preheat job loop, and the model
  watch (active swap, candidate attach and shadow report, the promotion fast
  path, locally rejected versions, post-swap health and rollback to the warm
  previous bundle, the drift reference carried on the bundle, draining).
  The faultline ``model.swap`` point fires where the reference fires it.
  A preheat job triggers the seed peers the manager lists (the port's seed
  daemon answers ``trigger_seed``) and completes once they hold the task;
  with no seed peer registered it fails with the reference's ``no seed peers
  available``.
- The loader, as plain functions with the reference's signatures, so that a
  test can put them in place of the reference link's static methods (the
  link's own static methods call them):

  - ``load_scorer_verified(path, digest)``: the faultline ``model.load``
    point first, then the registry digest recomputed over the artifact's
    files; only a bit-exact artifact is loaded.
  - ``load_scorer(path)``: ``(scorer, host_index)``. The native C++ scorer
    when the artifact has a ``scorer.dfsc`` and ``DRAGONFLY_NATIVE_SCORER`` is
    not ``0`` (engine ``"native"``, on the host's CPU); otherwise the port's
    ``GNNScorer`` refreshed on the artifact's graph, on the card unless a
    ``device`` is named (engine ``"torch"``). A native load that raises is
    logged with its traceback and falls back to torch, as the reference's
    falls back to JAX. The engine returned is logged either way.
  - ``classify_swap_error(exc)``: the reference's swap-error kinds.
  - ``load_drift_reference(path)``: the artifact's training-reference
    ``FeatureSketch``, or None.

torch and the artifact loaders are imported at first load, so a scheduler
with a manager link and no model loads no torch.

Reference equivalents:
- registration/keepalive: scheduler/scheduler.go:148 (GetScheduler +
  KeepAlive stream to manager) — here periodic `keepalive` RPCs.
- dynconfig: scheduler/config/dynconfig.go (manager-backed address book).
- preheat worker: scheduler/job/job.go:105-160 (machinery consumer; here a
  long-poll pull loop on the manager's per-cluster queue, 20 min task
  timeout kept).
- seed trigger: scheduler/resource/seed_peer.go:53-115 TriggerTask via the
  cdnsystem client — here a `trigger_seed` RPC to a seed daemon, chosen from
  scheduler-announced seed hosts first, manager address book as fallback.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket

from dragonfly2_tpu_torch.resilience import faultline
from dragonfly2_tpu_torch.rpc.core import RpcClient
from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient
from dragonfly2_tpu_torch.scheduler.resource import HostType, Task
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.utils.dynconfig import Dynconfig

logger = logging.getLogger(__name__)

PREHEAT_TIMEOUT = 20 * 60.0  # ref scheduler/job/job.go:44


class SeedPeerConnector:
    """Picks a live seed daemon and asks it to seed a task from origin."""

    def __init__(self, service: SchedulerService, *, address_book: list[dict] | None = None):
        self.service = service
        self.address_book = address_book or []  # manager-fed fallback
        self._clients: dict[str, RpcClient] = {}

    def update_address_book(self, seed_peers: list[dict]) -> None:
        self.address_book = seed_peers

    def _candidates(self) -> list[str]:
        """Seed RPC addresses: scheduler-announced seed hosts first (they are
        fresher — direct announce beats manager round trip), then manager's."""
        out = []
        for host in self.service.pool.hosts.values():
            if host.type == HostType.SEED and host.port:
                out.append(f"{host.ip}:{host.port}")
        for sp in self.address_book:
            addr = f"{sp['ip']}:{sp['port']}"
            if addr not in out and sp.get("port"):
                out.append(addr)
        return out

    def _client(self, addr: str) -> RpcClient:
        c = self._clients.get(addr)
        if c is None:
            c = self._clients[addr] = RpcClient(addr, retries=0)
        return c

    async def trigger(
        self, url: str, *, tag: str = "", application: str = "",
        digest: str = "", filters: tuple = (), headers: dict | None = None,
        timeout: float = PREHEAT_TIMEOUT,
    ) -> dict:
        """Trigger a seed download; tries each candidate until one accepts.

        `timeout` is the TOTAL budget: it is split across candidates so a
        hung first seed still leaves time to fail over to a healthy one."""
        candidates = self._candidates()
        if not candidates:
            raise RuntimeError("no seed peers available")
        per_candidate = max(5.0, timeout / len(candidates))
        last_err: Exception | None = None
        for addr in candidates:
            try:
                return await self._client(addr).call(  # dflint: disable=DF025 failover walk: returns on the first healthy candidate, not per-item fan-out
                    "trigger_seed",
                    {"url": url, "tag": tag, "application": application,
                     "digest": digest, "filters": list(filters),
                     "headers": headers or {}},
                    timeout=per_candidate,
                )
            except Exception as e:
                logger.warning("seed trigger via %s failed: %s", addr, e)
                last_err = e
        raise last_err or RuntimeError("no seed peers available")

    async def trigger_task(self, task: Task) -> None:
        """SchedulerService.seed_trigger hook (ref TriggerTask)."""
        await self.trigger(
            task.url, tag=task.tag, application=task.application,
            digest=task.digest, filters=task.filters,
        )

    async def close(self) -> None:
        for c in self._clients.values():
            await c.close()
        self._clients.clear()


class ManagerLink:
    """Everything a scheduler does with the manager, in one lifecycle."""

    def __init__(
        self,
        service: SchedulerService,
        manager_addr: str,
        *,
        hostname: str = "",
        ip: str = "127.0.0.1",
        port: int = 0,
        idc: str = "",
        location: str = "",
        cache_path: str | None = None,
        keepalive_interval: float = 20.0,
        dynconfig_interval: float = 60.0,
        model_watch_interval: float = 60.0,
        shadow_sample_rate: float = 1.0,
        health_gates=None,
        recorder=None,
        alert_engine=None,
    ):
        from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy
        from dragonfly2_tpu_torch.scheduler.rollout import HealthGates, HealthSample

        self.service = service
        # manager RPCs share the process-wide "manager" retry budget:
        # during an outage every loop here retries against the same
        # dead address — beyond the budget they fail fast instead of
        # multiplying the reconnect storm
        self.manager = RemoteManagerClient(manager_addr, target_class="manager")
        self.hostname = hostname or socket.gethostname()
        self.ip = ip
        self.port = port
        self.idc = idc
        self.location = location
        self.keepalive_interval = keepalive_interval
        self.model_watch_interval = model_watch_interval
        self._active_model_version: str | None = None
        # the scheduler id of the registry row the serving model came from:
        # a trainer publishes cluster-wide rows (scheduler_id 0), which
        # rollout_status falls back to, so the auto-rollback names that row's
        # id, not this scheduler's (the reference's link passes its own id,
        # for which a registered scheduler's registry rollback finds no
        # active row and fails)
        self._active_row_scheduler_id = 0
        # ---- cluster metrics plane ----
        # stats frames ride the keepalive tick when a recorder is wired
        # (scheduler/server.py boots the default one); the alert engine's
        # active set travels inside the frame
        self.recorder = recorder
        self.alert_engine = alert_engine
        # ---- live-model rollout state ----
        self.shadow_sample_rate = shadow_sample_rate
        self.health_gates = health_gates if health_gates is not None else HealthGates()
        self._warm_prev = None           # previous serving ModelBundle, kept WARM
        self._draining: list = []        # replaced bundles awaiting quiesce+free
        self._health = None              # PostSwapHealth after a rollback-able swap
        self._shadow_row_id: int | None = None
        self._rejected_versions: set[str] = set()
        # health baselines read the SERVICE's registry-scoped serving
        # counters (scheduler/metrics.ServiceMetrics), not the process-global
        # families, so services sharing a process keep their own baselines
        self._health_source = getattr(service, "local_metrics", None)
        self._last_swap_sample = HealthSample.capture(self._health_source)
        # persistent watch failure (manager down, active artifact corrupt)
        # backs off exponentially instead of hammering every tick (DF024)
        self._watch_failures = 0
        self._watch_backoff = BackoffPolicy(
            base=model_watch_interval, multiplier=2.0,
            max_delay=model_watch_interval * 8, jitter=0.3,
        )
        # ---- manager-outage autonomy ----
        # declared blackout state: keepalives failing or the rollout watch
        # unable to reach the registry. While set, the scheduler keeps
        # serving from cached dynconfig and the rollout watch is FROZEN (no
        # promotion/attach/swap is decided on a partial view).
        self.manager_unreachable = False
        self._keepalive_failures = 0
        self.scheduler_id: int | None = None
        self.cluster_id: int | None = None
        # live scheduler address book from dynconfig — the federation layer's
        # membership source (same list the daemons' balancer resolver polls)
        self.scheduler_addresses: list[str] = []
        self.seed_connector = SeedPeerConnector(service)
        self.dynconfig = Dynconfig(
            self._fetch_cluster_config,
            cache_path=cache_path,
            refresh_interval=dynconfig_interval,
        )
        self.dynconfig.register(self._on_config)
        self._tasks: list[asyncio.Task] = []

    async def _fetch_cluster_config(self) -> dict:
        assert self.cluster_id is not None
        return await self.manager.cluster_config(self.cluster_id)

    def _on_config(self, cfg: dict) -> None:
        self.seed_connector.update_address_book(cfg.get("seed_peers") or [])
        self.scheduler_addresses = [
            f"{s['ip']}:{s['port']}"
            for s in (cfg.get("schedulers") or [])
            if s.get("ip") and s.get("port")
        ]

    def federation_peers(self) -> list[str]:
        """Live ring members excluding this scheduler — FederationSync's
        peers_fn when membership is manager-fed."""
        me = f"{self.ip}:{self.port}"
        return [a for a in self.scheduler_addresses if a != me]

    async def start(self) -> None:
        """Register with the manager, start keepalive + dynconfig + job loops,
        and install the seed trigger on the service."""
        row = await self.manager.update_scheduler(
            self.hostname, self.ip, self.port, idc=self.idc, location=self.location,
        )
        self.scheduler_id = row["id"]
        self.cluster_id = row["scheduler_cluster_id"]
        try:
            await self.dynconfig.load()
        except Exception as e:
            logger.warning("initial dynconfig load failed: %s", e)
        self.dynconfig.start()
        self.service.seed_trigger = self.seed_connector.trigger_task
        self._tasks = [
            asyncio.ensure_future(self._keepalive_loop()),
            asyncio.ensure_future(self._job_loop()),
        ]
        if hasattr(self.service.evaluator, "attach_scorer"):
            try:
                await self._check_model()  # pick up an existing model at boot
            except Exception as e:
                # best-effort: a bad artifact or RPC blip must not fail start()
                # after the background loops are already running
                logger.warning("boot-time model check failed: %s", e)
            self._tasks.append(asyncio.ensure_future(self._model_watch_loop()))
        logger.info(
            "manager link up: scheduler_id=%s cluster_id=%s", self.scheduler_id, self.cluster_id
        )

    async def _keepalive_loop(self) -> None:
        while True:
            await asyncio.sleep(self.keepalive_interval)
            await self.keepalive_once()

    async def keepalive_once(self) -> bool:
        """One keepalive beat (tick body split out so tests and the sim can
        drive it without the sleep loop). Tracks the outage state: two
        consecutive failures declare `manager_unreachable`; the success that
        ends an outage runs the jitter-smoothed rejoin catch-up."""
        try:
            await self.manager.keepalive(
                "scheduler", self.hostname, self.cluster_id,
                stats=self._stats_frame(),
            )
        except Exception as e:
            self._keepalive_failures += 1
            if self._keepalive_failures >= 2:  # one blip is not a blackout
                self._set_manager_unreachable(True)
            logger.warning(
                "manager keepalive failed (%d consecutive): %s",
                self._keepalive_failures, e,
            )
            return False
        recovered = self.manager_unreachable
        self._keepalive_failures = 0
        self._set_manager_unreachable(False)
        if recovered:
            await self._rejoin()
        return True

    def _set_manager_unreachable(self, down: bool) -> None:
        if down == self.manager_unreachable:
            return
        from dragonfly2_tpu_torch.scheduler import metrics

        self.manager_unreachable = down
        metrics.MANAGER_UNREACHABLE.set(1.0 if down else 0.0)
        if down:
            logger.warning(
                "manager unreachable: autonomous mode (cached dynconfig "
                "serves, rollout watch frozen, keepalives keep probing)"
            )

    def _rejoin_delay(self) -> float:
        """Deterministic per-host fraction of one keepalive interval: a
        fleet whose blackout just ended spreads its re-registration burst
        across the interval instead of stampeding the manager on its first
        healthy tick (and re-killing it)."""
        import zlib

        spread = max(1.0, self.keepalive_interval)
        return (zlib.crc32(self.hostname.encode()) % 997) / 997.0 * spread

    async def _rejoin(self) -> None:
        """Catch-up after an outage: re-register (the manager may have
        expired this scheduler's row) and refresh dynconfig, after the
        per-host jitter delay."""
        delay = self._rejoin_delay()
        logger.info("manager reachable again; rejoin catch-up in %.1fs", delay)
        await asyncio.sleep(delay)
        try:
            row = await self.manager.update_scheduler(
                self.hostname, self.ip, self.port,
                idc=self.idc, location=self.location,
            )
            self.scheduler_id = row["id"]
            self.cluster_id = row["scheduler_cluster_id"]
            await self.dynconfig.refresh()
        except Exception as e:
            logger.warning("rejoin catch-up failed: %s", e)

    def _stats_frame(self) -> dict | None:
        """The compact windowed-health frame riding each keepalive. None (frameless keepalive, the pre-metrics-plane wire shape)
        when no recorder is wired."""
        if self.recorder is None:
            return None
        from dragonfly2_tpu_torch.observability.timeseries import build_stats_frame

        try:
            return build_stats_frame(
                self.recorder, service="scheduler", hostname=self.hostname,
                alerts=self.alert_engine,
            )
        except Exception:
            logger.exception("stats frame build failed")
            return None

    async def _job_loop(self) -> None:
        """Preheat consumer (ref scheduler/job preheat handler)."""
        from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy

        queue = f"scheduler_cluster_{self.cluster_id}"
        # a down manager backs off exponentially (5 s → 30 s cap) instead of
        # the old flat 5 s hammering; any successful pull resets the ladder
        backoff = BackoffPolicy(base=5.0, multiplier=2.0, max_delay=30.0, jitter=0.3)
        failures = 0
        while True:
            try:
                item = await self.manager.pull_job(queue, timeout=30.0)
            except Exception as e:
                logger.warning("job pull failed: %s", e)
                await backoff.sleep(failures)
                failures += 1
                continue
            failures = 0
            if item is None:
                continue
            await self._run_job(item)

    async def _run_job(self, item: dict) -> None:
        args = item.get("args") or {}
        ok, detail = True, {}
        if item.get("type") == "preheat":
            urls = args.get("urls") or []
            done, failed = 0, []
            # PREHEAT_TIMEOUT covers the WHOLE job (ref 20 min per preheat
            # handler) and must finish inside the manager's job lease, or the
            # lease reaper requeues it and every layer re-seeds from origin.
            deadline = asyncio.get_running_loop().time() + PREHEAT_TIMEOUT
            for url in urls:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    failed.append({"url": url, "error": "preheat job budget exhausted"})
                    continue
                try:
                    await self.seed_connector.trigger(
                        url, tag=args.get("tag", ""),
                        filters=tuple(args.get("filters", ())),
                        headers=args.get("headers") or None,
                        timeout=remaining,
                    )
                    done += 1
                except Exception as e:
                    logger.warning("preheat of %s failed: %s", url, e)
                    failed.append({"url": url, "error": str(e)})
            ok = bool(urls) and not failed  # zero URLs is a bad job, not a success
            detail = {"preheated": done, "failed": failed}
            if not urls:
                detail["error"] = "preheat job has no urls"
        else:
            ok = False
            detail = {"error": f"unknown job type {item.get('type')!r}"}
        try:
            await self.manager.complete_job(
                item["job_id"], success=ok, result=detail, cluster_id=item.get("cluster_id")
            )
        except Exception as e:
            logger.warning("job completion report failed: %s", e)

    async def _model_watch_loop(self) -> None:
        """Drive the serving-model rollout: verified hot-swap of
        activated versions, candidate shadow scoring + divergence reporting,
        and post-swap health with auto-rollback: the
        telemetry→train→register→infer loop at production semantics. Persistent failure (manager down, corrupt
        active artifact) backs off exponentially instead of retrying at the
        fixed watch interval."""
        while True:
            if self._watch_failures:
                await self._watch_backoff.sleep(self._watch_failures - 1)
            else:
                await asyncio.sleep(self.model_watch_interval)
            try:
                await self._check_model()
                self._watch_failures = 0
            except Exception as e:
                self._watch_failures += 1
                logger.warning(
                    "model watch failed (%d consecutive): %s", self._watch_failures, e
                )

    # ---- rollout watch: swap / shadow / health ----

    _SWAP_ERROR_KINDS = (
        "missing", "digest_mismatch", "load_error", "swap_error", "rpc_error",
        "rejected_version",
    )

    @classmethod
    def _note_swap(cls, result: str) -> None:
        """Count the swap outcome and keep model_swap_last_error one-hot on
        the latest failure kind (all-zero after a success)."""
        from dragonfly2_tpu_torch.scheduler import metrics

        metrics.MODEL_SWAP_TOTAL.inc(result=result)
        err = result if result in cls._SWAP_ERROR_KINDS else None
        for kind in cls._SWAP_ERROR_KINDS:
            metrics.MODEL_SWAP_LAST_ERROR.set(1.0 if kind == err else 0.0, error=kind)

    def _note_rollout_state(self) -> None:
        from dragonfly2_tpu_torch.scheduler import metrics

        shadowing = bool(getattr(self.service.evaluator, "candidate_version", ""))
        watching = self._health is not None
        metrics.MODEL_ROLLOUT_STATE.set(float(shadowing), state="shadowing")
        metrics.MODEL_ROLLOUT_STATE.set(float(watching), state="health_watch")
        metrics.MODEL_ROLLOUT_STATE.set(
            float(not (shadowing or watching)), state="idle"
        )

    @staticmethod
    def _classify_swap_error(e: Exception) -> str:
        return classify_swap_error(e)

    async def _check_model(self) -> None:
        """One rollout tick: free drained bundles, decide post-swap health
        (may auto-rollback), pick up candidates + report shadow windows, and
        hot-swap to the registry's active version. Every per-leg failure is
        classified into model_swap_total{result}; only persistent conditions
        (RPC down, corrupt ACTIVE artifact) propagate so the loop backs off —
        a corrupt CANDIDATE is terminal (reported + rejected), never a wedge."""
        self._drain_retired()
        await self._maybe_rollback()  # local decision: runs through a blackout
        try:
            status = await self.manager.rollout_status("gnn", self.scheduler_id or 0)
        except Exception:
            # FREEZE: with the manager unreachable no promotion,
            # attach, or swap is decided — the serving bundle, warm previous,
            # and candidate stay exactly as they are until the registry
            # answers again (never half-apply a promotion from a stale view)
            self._set_manager_unreachable(True)
            raise
        self._set_manager_unreachable(False)
        ev = self.service.evaluator
        if hasattr(ev, "attach_candidate"):
            promoted = await self._check_candidate(status)
            if promoted:
                status = await self.manager.rollout_status("gnn", self.scheduler_id or 0)
        await self._check_active(status.get("active"))
        self._note_rollout_state()

    async def _check_active(self, row: dict | None) -> None:
        if row is None or row["version"] == self._active_model_version:
            return
        version = row["version"]
        if version in self._rejected_versions:
            # we rolled this version back (or refused its artifact) — never
            # re-attach it, even while the registry still names it active
            # (the rollback RPC may have failed; it retries via rollback or
            # an operator promote of something else). Counted every tick:
            # the per-tick rate IS the scheduler-vs-registry divergence
            # heartbeat dashboards alert on.
            self._note_swap("rejected_version")
            logger.warning("registry active model %s is locally rejected; ignoring", version)
            return
        ev = self.service.evaluator
        # Promotion fast path: the candidate we are ALREADY shadow-scoring
        # just went active — swap to its loaded scorer in place, no disk.
        if getattr(ev, "candidate_version", "") == version:
            cand = ev.detach_candidate()
            self._shadow_row_id = None
            if cand is not None:
                # the candidate bundle shares scorer+handles with the serving
                # bundle built below — drop it without closing
                self._install(
                    cand.scorer, cand.node_index, row, handle_pool=cand.handle_pool
                )
                return
        path = row.get("artifact_path", "")
        try:
            scorer, node_index = await asyncio.to_thread(
                self._load_scorer_verified, path, row.get("artifact_digest", "")
            )
        except Exception as e:
            kind = self._classify_swap_error(e)
            self._note_swap(kind)
            logger.warning("active model %s refused (%s): %s", version, kind, e)
            # persistent: the registry keeps naming this version — back off
            raise
        self._install(scorer, node_index, row)

    def _install(self, scorer, node_index, row: dict, *, handle_pool=None) -> None:
        """Publish a verified scorer as the serving model: build the serving
        facades, swap the evaluator's bundle in one store (zero-drop: rounds
        in flight finish on the old bundle, which is kept WARM for instant
        rollback), and open the post-swap health window."""
        from dragonfly2_tpu_torch.scheduler.rollout import HealthSample, PostSwapHealth

        version = row["version"]
        try:
            if faultline.ACTIVE is not None:
                faultline.ACTIVE.check("model.swap")
            # Native scorers get the micro-batching facade: concurrent
            # scheduling rounds on the service loop coalesce into one
            # multi-round FFI call (native/microbatch.py) instead of crossing
            # ctypes per round. When the sharded round dispatcher is serving,
            # they ALSO get a handle pool: dispatcher workers score on
            # per-thread forked handles (scorer.cc's one-handle-per-thread
            # rule; a shared handle would serialize the workers on its
            # internal mutex).
            microbatch = None
            if hasattr(scorer, "score_rounds"):
                from dragonfly2_tpu_torch.native import MicroBatchScorer, ScorerHandlePool

                microbatch = MicroBatchScorer(scorer)
                if handle_pool is None \
                        and getattr(self.service.scheduling, "dispatcher", None) is not None \
                        and hasattr(scorer, "fork"):
                    handle_pool = ScorerHandlePool(scorer)
        except Exception as e:
            self._note_swap("swap_error")
            logger.warning("model %s swap failed: %s", version, e)
            raise
        ev = self.service.evaluator
        if hasattr(ev, "swap_bundle"):
            prev = ev.attach_scorer(
                scorer, node_index,
                microbatch=microbatch, handle_pool=handle_pool, version=version,
            )
            # previous serving bundle stays WARM (instant rollback target);
            # whatever was warm before now drains and frees
            if self._warm_prev is not None and self._warm_prev is not prev:
                self._draining.append(self._warm_prev)
            self._warm_prev = prev
            now = HealthSample.capture(self._health_source)
            baseline = PostSwapHealth.rates_of(self._last_swap_sample, now)
            self._last_swap_sample = now
            if prev is not None:
                self._health = PostSwapHealth(
                    self.health_gates, baseline_rates=baseline, at_swap=now,
                    source=self._health_source,
                )
        else:
            # plugin evaluators keep the legacy attach (no bundle protocol —
            # no warm previous, no auto-rollback)
            ev.attach_scorer(
                scorer, node_index, microbatch=microbatch, handle_pool=handle_pool
            )
        self._active_model_version = version
        self._active_row_scheduler_id = row.get("scheduler_id", self.scheduler_id or 0)
        self._note_swap("ok")
        sketch = self._install_drift_reference(ev, row)
        # the sketch rides the serving bundle so a rollback restores the
        # previous model's baseline
        bundle = getattr(ev, "serving_bundle", None)
        if bundle is not None and hasattr(bundle, "drift_sketch"):
            bundle.drift_sketch = sketch
            bundle.drift_sketch_version = version
        logger.info(
            "ml evaluator upgraded to model %s (%d hosts, microbatch=%s, "
            "handle_pool=%s, warm_prev=%s)",
            version, len(node_index), microbatch is not None,
            handle_pool is not None,
            self._warm_prev.version if self._warm_prev is not None else None,
        )

    @staticmethod
    def _install_drift_reference(ev, row: dict):
        """Feature-drift baseline: load the artifact's training-reference
        sketch (digest-covered: verify_artifact already passed for this path)
        into the evaluator's drift detector. A pre-sketch artifact clears the
        reference: drift must never compare live traffic against a PREVIOUS
        model's training distribution. Returns the loaded sketch (or None) so
        the caller can carry it on the serving bundle for rollback."""
        drift = getattr(ev, "drift", None)
        if drift is None:
            return None
        sketch = load_drift_reference(row.get("artifact_path", ""))
        drift.set_reference(sketch, version=row.get("version", ""))
        return sketch

    async def _check_candidate(self, status: dict) -> bool:
        """Shadow-scoring leg: attach the newest candidate (digest-verified;
        a corrupt one is reported and rejected, never attached), and push
        this scheduler's divergence window to the manager's rollout state
        machine. Returns True when the manager's answer says the candidate
        was PROMOTED (the caller refreshes and swaps in the same tick)."""
        ev = self.service.evaluator
        rows = status.get("candidates") or []
        cand = None
        for r in reversed(rows):  # newest first
            if r["version"] not in self._rejected_versions \
                    and r["version"] != self._active_model_version:
                cand = r
                break
        current = ev.candidate_version
        if cand is None:
            if current:
                # candidate vanished (rejected/promoted elsewhere, or the
                # registry moved on) — stop shadowing and drain the bundle
                logger.info("candidate %s no longer in rollout; detaching", current)
                self._retire_candidate()
            return False
        if cand["version"] != current:
            if current:
                self._retire_candidate()
            await self._attach_candidate(cand)
            return False
        # same candidate still shadowing: ship the divergence window
        tracker = ev.candidate_tracker
        if tracker is None or self._shadow_row_id is None:
            return False
        resp = await self.manager.report_shadow(
            self._shadow_row_id, self.hostname, tracker.snapshot()
        )
        state = resp.get("state")
        from dragonfly2_tpu_torch.scheduler import rollout as R

        if state == R.STATE_ACTIVE:
            logger.info(
                "candidate %s promoted by shadow gate (%s)",
                cand["version"], resp.get("aggregate", {}).get("rounds"),
            )
            return True  # active leg swaps to it (fast path, already loaded)
        if state == R.STATE_REJECTED:
            logger.warning(
                "candidate %s rejected by shadow gate: %s",
                cand["version"], "; ".join(resp.get("reasons") or []),
            )
            self._rejected_versions.add(cand["version"])
            self._retire_candidate()
        return False

    async def _attach_candidate(self, cand: dict) -> None:
        ev = self.service.evaluator
        version = cand["version"]
        try:
            scorer, node_index = await asyncio.to_thread(
                self._load_scorer_verified,
                cand.get("artifact_path", ""), cand.get("artifact_digest", ""),
            )
        except Exception as e:
            # terminal for THIS candidate: report so the manager rejects it
            # (the rollout must not hang on an artifact no scheduler can
            # read) and never retry it locally — the watch loop stays live
            kind = self._classify_swap_error(e)
            self._note_swap(kind)
            self._rejected_versions.add(version)
            logger.warning("candidate %s refused (%s): %s", version, kind, e)
            try:
                await self.manager.report_shadow(
                    cand["id"], self.hostname, {"error": f"{kind}: {e}"}
                )
            except Exception as rpc_err:
                logger.warning("candidate rejection report failed: %s", rpc_err)
            return
        handle_pool = None
        if getattr(self.service.scheduling, "dispatcher", None) is not None \
                and hasattr(scorer, "fork"):
            from dragonfly2_tpu_torch.native import ScorerHandlePool

            handle_pool = ScorerHandlePool(scorer)
        ev.attach_candidate(
            scorer, node_index, version=version,
            sample_rate=self.shadow_sample_rate, handle_pool=handle_pool,
        )
        self._shadow_row_id = cand["id"]
        logger.info(
            "shadow-scoring candidate %s (sample_rate=%.2f, dispatcher=%s)",
            version, self.shadow_sample_rate, handle_pool is not None,
        )

    def _retire_candidate(self) -> None:
        bundle = self.service.evaluator.detach_candidate()
        self._shadow_row_id = None
        if bundle is not None:
            self._draining.append(bundle)

    async def _maybe_rollback(self) -> None:
        """Post-swap health verdict; a regression swaps the WARM previous
        bundle back instantly, then tells the registry."""
        h = self._health
        if h is None:
            return
        verdict = h.check()
        if verdict is None:
            return
        ok, reasons = verdict
        self._health = None
        if ok:
            logger.info(
                "post-swap health clean for model %s", self._active_model_version
            )
            return
        await self._rollback(reasons)

    async def _rollback(self, reasons: list[str]) -> None:
        from dragonfly2_tpu_torch.scheduler import metrics

        prev = self._warm_prev
        ev = self.service.evaluator
        if prev is None or not hasattr(ev, "swap_bundle"):
            logger.error(
                "health regression (%s) but no warm previous model to roll back to",
                "; ".join(reasons),
            )
            return
        bad = ev.swap_bundle(prev)  # instant: prev's handles are still warm
        self._warm_prev = None
        # drift baseline follows the bundle: the restored model serves
        # against ITS OWN training-reference sketch, carried warm on the
        # bundle since its install — never baseline-less, never the bad
        # model's distribution (a pre-sketch artifact restores a cleared
        # reference, same as its original install)
        drift = getattr(ev, "drift", None)
        if drift is not None:
            drift.set_reference(
                getattr(prev, "drift_sketch", None),
                version=getattr(prev, "drift_sketch_version", "")
                or (prev.version or ""),
            )
        bad_version = self._active_model_version
        if bad is not None:
            if bad.version:
                self._rejected_versions.add(bad.version)
            self._draining.append(bad)
        self._active_model_version = prev.version or None
        # reset the baseline window anchor: the NEXT swap's baseline must
        # measure the restored model's serving rates, not a window spanning
        # the rolled-back model's regression (which would inflate the
        # baseline and let an equally-bad successor pass the health gate)
        from dragonfly2_tpu_torch.scheduler.rollout import HealthSample

        self._last_swap_sample = HealthSample.capture(self._health_source)
        metrics.MODEL_ROLLBACK_TOTAL.inc()
        self._note_swap("rollback")
        logger.warning(
            "AUTO-ROLLBACK: model %s -> %s (%s)",
            bad_version, prev.version, "; ".join(reasons),
        )
        try:
            await self.manager.rollback_model(
                "gnn", self._active_row_scheduler_id,
                reason="; ".join(reasons) or "post-swap health regression",
            )
        except Exception as e:
            # registry still names the bad version active; the local
            # rejected-set stops us re-attaching it, and operators see the
            # divergence via dfmodel status / model_rollback_total
            logger.warning("registry rollback failed: %s", e)

    def _drain_retired(self) -> None:
        """Free bundles whose in-flight rounds have drained (ModelBundle
        refuses to close while rounds are inside it — old forked handles on
        the refcounted native model are only freed at quiesce)."""
        self._draining = [b for b in self._draining if not b.close()]

    @staticmethod
    def _load_scorer_verified(path: str, digest: str = ""):
        """Integrity-checked artifact load: the faultline ``model.load``
        point first, then the registry digest over the artifact's files;
        only a bit-exact artifact reaches ``_load_scorer``."""
        _verify(path, digest)
        return ManagerLink._load_scorer(path)

    @staticmethod
    def _load_scorer(path: str):
        return load_scorer(path)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        # best-effort: free quiesced retired bundles now; anything still
        # mid-round (or the warm previous) is left to GC, same as before
        # rollout existed — the service teardown follows right behind
        self._drain_retired()
        await self.dynconfig.stop()
        await self.seed_connector.close()
        await self.manager.close()


def _verify(path: str, digest: str) -> None:
    from dragonfly2_tpu_torch.trainer import artifacts

    if faultline.ACTIVE is not None:
        faultline.ACTIVE.check("model.load", blocking_latency=True)
    artifacts.verify_artifact(path, digest)


def load_scorer_verified(path: str, digest: str = "", *, device=None):
    """Verify the artifact against the registry row's digest, then load it.
    An injected ``model.load`` fault fires before verification (a latency
    rule blocks: a load runs off the event loop); a ``corrupt`` or
    ``truncate`` rule damages the bytes the digest reads."""
    _verify(path, digest)
    return load_scorer(path, device=device)


def load_scorer(path: str, *, device=None):
    """The artifact's scorer and its host-id → graph-row index."""
    from dragonfly2_tpu_torch.models.scorer import GNNScorer
    from dragonfly2_tpu_torch.trainer import artifacts

    graph, host_index = artifacts.load_graph(path)
    if os.environ.get("DRAGONFLY_NATIVE_SCORER", "1") != "0":
        try:
            native = artifacts.load_native(path)
        except Exception:
            logger.exception("native scorer unavailable for %s; falling back to torch", path)
        else:
            if native is not None:
                logger.info("serving model %s via engine %s (host CPU)", path, native.engine)
                return native, host_index
    model, state_dict = artifacts.load_gnn(path)
    scorer = GNNScorer(model, state_dict, device=device)
    scorer.refresh(graph)
    logger.info("serving model %s via engine %s on %s", path, scorer.engine, scorer.device)
    return scorer, host_index


def classify_swap_error(exc: Exception) -> str:
    """The swap-error kind of a failed load: ``digest_mismatch``, ``missing``
    or ``load_error``."""
    from dragonfly2_tpu_torch.trainer import artifacts

    if isinstance(exc, artifacts.ArtifactIntegrityError):
        return "digest_mismatch"
    if isinstance(exc, FileNotFoundError):
        return "missing"
    return "load_error"


def load_drift_reference(path: str):
    """The artifact's training-reference ``FeatureSketch``; None for an
    artifact written without one, or (logged) for one that fails to load."""
    from dragonfly2_tpu_torch.trainer import artifacts

    try:
        return artifacts.load_sketch(path)
    except Exception:
        logger.exception("reference sketch load failed for %s", path)
        return None
