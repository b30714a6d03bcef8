"""Scheduler process entry point: the port of dragonfly2_tpu/scheduler/server.py.

Reference equivalent: scheduler/scheduler.go composition root + cmd/scheduler.
Wires config → telemetry storage → service → RPC server → GC loop, and runs
until signalled:

    python -m dragonfly2_tpu_torch.scheduler.server --port 9000 --evaluator ml

It takes the reference's flags and ``--config`` YAML layering (the file's
values become the flag defaults; explicit flags override them) and prints
``SCHEDULER_READY <addr>`` once it serves, after its SIGINT/SIGTERM handlers
are in place. It serves ``--evaluator base|ml|plugin:pkg.mod:attr`` (an ml
evaluator boots in base-fallback mode and loads no torch until a model is
attached), writes download and probe records under ``--telemetry-dir``,
uploads them to ``--trainer`` through the port's announcer, sweeps the
resource pool every ``gc.interval`` seconds, and runs the loop-health
monitor and the brownout ladder, as the reference does at every boot.

With ``--manager`` it runs the port's ManagerLink (registration,
keepalives carrying the stats frame, dynconfig, the preheat job loop and the
model watch with shadow scoring, promotion and health rollback);
``--federation-peers`` takes a static list, or ``auto`` to follow the
manager's address book (refreshed every 60 s, as the reference does). The
time-series recorder and the alert engine always start: the stats frames
read them. ``--metrics-port`` serves the debug server (``/metrics`` renders
the port's registry, ``/debug/decisions`` this scheduler's decision
records), and a ``tracing:`` section exports spans to a JSON-lines file, an
OTLP file or an OTLP endpoint.
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from dragonfly2_tpu_torch.rpc.scheduler import serve_scheduler
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.telemetry import TelemetryStorage
from dragonfly2_tpu_torch.utils.gcreg import GC
from dragonfly2_tpu_torch.utils.proc import run_until_signalled

logger = logging.getLogger("scheduler")


async def run_scheduler(
    *,
    host: str = "127.0.0.1",
    port: int = 9000,
    telemetry_dir: str | None = None,
    evaluator: str = "base",
    metrics_port: int | None = None,
    gc_interval: float = 10.0,
    manager_addr: str | None = None,
    keepalive_interval: float | None = None,
    trainer_addr: str | None = None,
    trainer_interval: float | None = None,
    model_watch_interval: float | None = None,
    shadow_sample_rate: float | None = None,
    health_gates=None,
    federation_peers: str | None = None,
    federation_interval: float | None = None,
    hostname: str = "",
    idc: str = "",
    location: str = "",
    scheduling_config=None,
    gc_policy=None,
    degradation_budgets: dict | None = None,
    ready_event: asyncio.Event | None = None,
) -> None:
    from dragonfly2_tpu_torch.scheduler.evaluator import new_evaluator

    telemetry = TelemetryStorage(telemetry_dir) if telemetry_dir else None
    service = SchedulerService(
        evaluator=new_evaluator(evaluator),
        telemetry=telemetry,
        scheduling_config=scheduling_config,
        gc_policy=gc_policy,
    )
    server = serve_scheduler(service, host=host, port=port)
    await server.start()
    logger.info("scheduler listening on %s", server.address)

    # loop-health sampling always on; with a round dispatcher configured the
    # monitor also samples worker occupancy, so "loop starved, workers idle"
    # (glue-bound) reads apart from "everything pegged" (out of cores)
    from dragonfly2_tpu_torch.observability.loophealth import default_monitor

    loop_monitor = default_monitor()
    if service.scheduling.dispatcher is not None:
        loop_monitor.attach_dispatcher(service.scheduling.dispatcher)
    loop_monitor.start()
    # brownout ladder: driven by the SAME instruments — loop lag p95 and
    # dispatcher occupancy/queue depth — stepping through explicit shedding
    # modes under sustained pressure instead of timing out opaquely; its
    # budgets come from the `degradation:` YAML section (None = defaults)
    from dragonfly2_tpu_torch.scheduler.degradation import DegradationController

    degradation = DegradationController(**(degradation_budgets or {}))
    degradation.attach_loop_monitor(loop_monitor)
    if service.scheduling.dispatcher is not None:
        degradation.attach_dispatcher(service.scheduling.dispatcher)
    service.attach_degradation(degradation)
    degradation.start()
    # metrics plane: the time-series recorder and the alert engine are always
    # on (one registry walk per ~2 s), so the history the stats frames and the
    # rollout health read covers an incident from its start
    from dragonfly2_tpu_torch.observability.alerts import default_engine
    from dragonfly2_tpu_torch.observability.timeseries import default_recorder

    recorder = default_recorder()
    recorder.start()
    alert_engine = default_engine()
    alert_engine.start()
    debug = None
    if metrics_port is not None:
        from dragonfly2_tpu_torch.observability.server import start_debug_server

        debug = await start_debug_server(host=host, port=metrics_port, decisions=service)
        logger.info("scheduler metrics on %s:%d", host, debug.port)

    link = None
    if manager_addr:
        from dragonfly2_tpu_torch.scheduler.manager_link import ManagerLink

        link_kw = {}
        if keepalive_interval is not None:
            link_kw["keepalive_interval"] = keepalive_interval
        if model_watch_interval is not None:
            link_kw["model_watch_interval"] = model_watch_interval
        if shadow_sample_rate is not None:
            link_kw["shadow_sample_rate"] = shadow_sample_rate
        if health_gates is not None:
            link_kw["health_gates"] = health_gates
        link = ManagerLink(
            service, manager_addr,
            hostname=hostname, ip=host, port=server.port,
            idc=idc, location=location,
            recorder=recorder, alert_engine=alert_engine, **link_kw,
        )
        try:
            await link.start()
        except Exception:
            # the scheduler still serves its cluster when the manager is
            # down; the half-started link is torn down so no loop leaks
            logger.exception("manager link failed to start; continuing standalone")
            try:
                await link.stop()
            except Exception as stop_err:
                logger.debug("half-started link teardown failed: %s", stop_err)
            link = None
    # federation: a static peer list, or "auto" to follow the manager's
    # address book (a ring member joining or leaving starts or stops syncing
    # within one dynconfig refresh)
    federation = None
    if federation_peers:
        from dragonfly2_tpu_torch.scheduler.federation import (
            DEFAULT_SYNC_INTERVAL,
            FederationSync,
        )

        auto = federation_peers.strip() == "auto"
        static = [] if auto else [a.strip() for a in federation_peers.split(",") if a.strip()]
        if auto and link is None:
            logger.warning("--federation-peers auto needs a manager link; federation disabled")
        else:
            federation = FederationSync(
                service,
                self_addr=f"{host}:{server.port}",
                name=hostname or f"{host}:{server.port}",
                peers=static,
                peers_fn=link.federation_peers if link is not None else None,
                interval=federation_interval or DEFAULT_SYNC_INTERVAL,
            )
            federation.start()
            logger.info(
                "federation sync up (interval %.1fs, peers %s)",
                federation.interval, static or "manager-fed",
            )
    announcer = None
    if trainer_addr and telemetry is not None:
        from dragonfly2_tpu_torch.scheduler.announcer import DEFAULT_INTERVAL, TrainerAnnouncer

        announcer = TrainerAnnouncer(
            telemetry, trainer_addr,
            hostname=hostname,
            scheduler_id=(link.scheduler_id or 0) if link else 0,
            interval=trainer_interval or DEFAULT_INTERVAL,
        )
        announcer.start()

    gc = GC()
    gc.add("resource", gc_interval, lambda: _sweep(service))
    gc.start()
    try:
        await run_until_signalled(
            ready_event,
            on_ready=lambda: print(f"SCHEDULER_READY {server.address}", flush=True),
        )
    finally:
        gc.stop()
        degradation.stop()
        loop_monitor.stop()
        alert_engine.stop()
        recorder.stop()
        if debug is not None:
            await debug.stop()
        if federation is not None:
            await federation.stop()
        if announcer is not None:
            await announcer.stop()
        if link is not None:
            await link.stop()
        if telemetry:
            telemetry.flush()
        await server.stop()
        service.close()  # dispatcher worker threads (no-op in serial mode)


def _sweep(service: SchedulerService) -> None:
    from dragonfly2_tpu_torch.scheduler import metrics

    # under the scheduler state lock: the TTL sweep deletes peers/edges the
    # round dispatcher's workers may be sampling/filtering right now
    with service.state_lock:
        removed = service.pool.gc()
    metrics.PEERS_GAUGE.set(service.pool.peer_count())
    metrics.TASKS_GAUGE.set(len(service.pool.tasks))
    metrics.HOSTS_GAUGE.set(len(service.pool.hosts))
    if any(removed.values()):
        logger.info("gc removed %s", removed)


def main() -> None:
    import sys

    from dragonfly2_tpu_torch.scheduler.config import SchedulerYaml
    from dragonfly2_tpu_torch.utils.config import ConfigError, load_config

    # Two-stage parse (the reference's cobra/viper layering): --config loads
    # the validated YAML, whose values become the flag DEFAULTS — so explicit
    # flags override the file, and the file overrides built-in defaults.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None, help="YAML config file (flags override)")
    cargs, _ = pre.parse_known_args()
    try:
        cfg = load_config(SchedulerYaml, cargs.config)
    except (ConfigError, OSError) as e:
        print(f"scheduler: {e}", file=sys.stderr)
        raise SystemExit(2)

    ap = argparse.ArgumentParser(description="dragonfly2_tpu_torch scheduler", parents=[pre])
    ap.add_argument("--host", default=cfg.host)
    ap.add_argument("--port", type=int, default=cfg.port)
    ap.add_argument("--telemetry-dir", default=cfg.telemetry_dir)
    ap.add_argument("--metrics-port", type=int, default=cfg.metrics_port)
    ap.add_argument("--evaluator", default=cfg.evaluator,
                    help='"base", "ml", or "plugin:pkg.mod:attr"')
    ap.add_argument("--manager", default=cfg.manager, help="manager address host:port")
    ap.add_argument("--keepalive-interval", type=float, default=None,
                    help="seconds between manager keepalives (stats frames "
                         "ride this tick; default 20)")
    ap.add_argument("--trainer", default=cfg.trainer, help="trainer address host:port")
    ap.add_argument("--model-watch-interval", type=float, default=None,
                    help="seconds between active-model registry polls (default 60)")
    ap.add_argument("--shadow-sample-rate", type=float,
                    default=cfg.rollout.shadow_sample_rate,
                    help="fraction of rounds a rollout candidate shadow-scores")
    ap.add_argument("--trainer-interval", type=float, default=cfg.trainer_interval,
                    help="telemetry upload cadence in seconds (default 7 days)")
    ap.add_argument("--federation-peers", default=cfg.federation_peers,
                    help='peer scheduler addresses "host:port,host:port", or '
                         '"auto" to follow the manager address book')
    ap.add_argument("--federation-interval", type=float, default=cfg.federation_interval,
                    help="seconds between federation gossip rounds (default 5)")
    ap.add_argument("--hostname", default=cfg.hostname)
    ap.add_argument("--idc", default=cfg.idc)
    ap.add_argument("--location", default=cfg.location)
    ap.add_argument("--log-dir", default=cfg.log_dir,
                    help="per-component rotating log files (console only when unset)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if args.evaluator not in ("base", "ml") and not args.evaluator.startswith("plugin:"):
        ap.error(f"--evaluator {args.evaluator!r}: want 'base', 'ml', or 'plugin:pkg.mod:attr'")
    from dragonfly2_tpu_torch.observability.tracing import configure_default_tracer
    from dragonfly2_tpu_torch.utils.dflog import setup_logging

    setup_logging(args.log_dir, level=logging.DEBUG if args.verbose else logging.INFO)
    configure_default_tracer(
        "dragonfly-scheduler",
        otlp_file=cfg.tracing.otlp_file, otlp_endpoint=cfg.tracing.otlp_endpoint,
        trace_file=cfg.tracing.trace_file, sample_rate=cfg.tracing.sample_rate,
    )
    asyncio.run(
        run_scheduler(
            host=args.host,
            port=args.port,
            telemetry_dir=args.telemetry_dir,
            evaluator=args.evaluator,
            metrics_port=args.metrics_port,
            gc_interval=cfg.gc.interval,
            manager_addr=args.manager,
            keepalive_interval=args.keepalive_interval,
            trainer_addr=args.trainer,
            trainer_interval=args.trainer_interval,
            model_watch_interval=args.model_watch_interval,
            shadow_sample_rate=args.shadow_sample_rate,
            health_gates=cfg.rollout.health_gates(),
            federation_peers=args.federation_peers,
            federation_interval=args.federation_interval,
            hostname=args.hostname,
            idc=args.idc,
            location=args.location,
            scheduling_config=cfg.scheduling_config(),
            gc_policy=cfg.gc_policy(),
            degradation_budgets=cfg.degradation.controller_kwargs(),
        )
    )


if __name__ == "__main__":
    main()
