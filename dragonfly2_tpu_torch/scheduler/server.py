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

Refused, never ignored (exit 2, naming the ROADMAP.md item that ports
them): ``--manager`` and the flags only a ManagerLink reads
(``--keepalive-interval``, ``--model-watch-interval``,
``--shadow-sample-rate``, ``--idc``, ``--location``, a non-default
``rollout:`` section), ``--federation-peers`` and ``--federation-interval``,
``--metrics-port`` (the debug server), and a ``tracing:`` section that names
an exporter. The reference's timeseries recorder and alert engine are not
started: they feed only the ManagerLink's stats frames, the debug server and
dftop, and come with the slice that ports those.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from dragonfly2_tpu_torch.rpc.scheduler import serve_scheduler
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.telemetry import TelemetryStorage
from dragonfly2_tpu_torch.utils.gcreg import GC
from dragonfly2_tpu_torch.utils.proc import run_until_signalled

logger = logging.getLogger("scheduler")

_STILL_TO_PORT = "ROADMAP.md §1, 'Still to port'"


async def run_scheduler(
    *,
    host: str = "127.0.0.1",
    port: int = 9000,
    telemetry_dir: str | None = None,
    evaluator: str = "base",
    gc_interval: float = 10.0,
    trainer_addr: str | None = None,
    trainer_interval: float | None = None,
    hostname: str = "",
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

    announcer = None
    if trainer_addr and telemetry is not None:
        from dragonfly2_tpu_torch.scheduler.announcer import DEFAULT_INTERVAL, TrainerAnnouncer

        announcer = TrainerAnnouncer(
            telemetry, trainer_addr,
            hostname=hostname,
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
        if announcer is not None:
            await announcer.stop()
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


def _refusals(args: argparse.Namespace, cfg) -> list[str]:
    """What this boot asks for that the port does not run yet, one message
    each; the caller refuses the boot when any is set."""
    from dragonfly2_tpu_torch.scheduler.config import RolloutSection

    link = f"needs the scheduler's ManagerLink, not ported yet ({_STILL_TO_PORT}: ManagerLink)"
    fed = f"needs scheduler federation, not ported yet ({_STILL_TO_PORT}: federation)"
    out = [
        f"{flag}: {why}"
        for flag, value, why in (
            ("--manager", args.manager, link),
            ("--keepalive-interval", args.keepalive_interval, link),
            ("--model-watch-interval", args.model_watch_interval, link),
            ("--shadow-sample-rate", args.shadow_sample_rate, link),
            ("--idc", args.idc or None, link),
            ("--location", args.location or None, link),
            ("--federation-peers", args.federation_peers, fed),
            ("--federation-interval", args.federation_interval, fed),
            ("--metrics-port", args.metrics_port,
             f"needs the debug and metrics server, not ported yet ({_STILL_TO_PORT}: observability/server.py)"),
        )
        if value is not None
    ]
    if cfg.rollout != RolloutSection():
        out.append(f"rollout: {link}")
    for name in ("otlp_file", "otlp_endpoint", "trace_file"):
        if getattr(cfg.tracing, name):
            out.append(
                f"tracing.{name}: the span exporters are not ported yet "
                f"({_STILL_TO_PORT}: tracing exporters); the port records spans in process only"
            )
    return out


def main() -> None:
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
    ap.add_argument("--metrics-port", type=int, default=cfg.metrics_port,
                    help="refused: the debug server is not ported yet")
    ap.add_argument("--evaluator", default=cfg.evaluator,
                    help='"base", "ml", or "plugin:pkg.mod:attr"')
    ap.add_argument("--manager", default=cfg.manager,
                    help="refused: the ManagerLink is not ported yet")
    ap.add_argument("--keepalive-interval", type=float, default=None,
                    help="refused: a ManagerLink setting")
    ap.add_argument("--trainer", default=cfg.trainer, help="trainer address host:port")
    ap.add_argument("--model-watch-interval", type=float, default=None,
                    help="refused: a ManagerLink setting")
    ap.add_argument("--shadow-sample-rate", type=float, default=None,
                    help="refused: a ManagerLink setting")
    ap.add_argument("--trainer-interval", type=float, default=cfg.trainer_interval,
                    help="telemetry upload cadence in seconds (default 7 days)")
    ap.add_argument("--federation-peers", default=cfg.federation_peers,
                    help="refused: federation is not ported yet")
    ap.add_argument("--federation-interval", type=float, default=cfg.federation_interval,
                    help="refused: federation is not ported yet")
    ap.add_argument("--hostname", default=cfg.hostname)
    ap.add_argument("--idc", default=cfg.idc, help="refused: a ManagerLink setting")
    ap.add_argument("--location", default=cfg.location, help="refused: a ManagerLink setting")
    ap.add_argument("--log-dir", default=cfg.log_dir,
                    help="per-component rotating log files (console only when unset)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if args.evaluator not in ("base", "ml") and not args.evaluator.startswith("plugin:"):
        ap.error(f"--evaluator {args.evaluator!r}: want 'base', 'ml', or 'plugin:pkg.mod:attr'")
    refused = _refusals(args, cfg)
    if refused:
        for msg in refused:
            print(f"scheduler: {msg}", file=sys.stderr)
        raise SystemExit(2)
    from dragonfly2_tpu_torch.observability.tracing import configure_default_tracer
    from dragonfly2_tpu_torch.utils.dflog import setup_logging

    setup_logging(args.log_dir, level=logging.DEBUG if args.verbose else logging.INFO)
    configure_default_tracer("dragonfly-scheduler", sample_rate=cfg.tracing.sample_rate)
    asyncio.run(
        run_scheduler(
            host=args.host,
            port=args.port,
            telemetry_dir=args.telemetry_dir,
            evaluator=args.evaluator,
            gc_interval=cfg.gc.interval,
            trainer_addr=args.trainer,
            trainer_interval=args.trainer_interval,
            hostname=args.hostname,
            scheduling_config=cfg.scheduling_config(),
            gc_policy=cfg.gc_policy(),
            degradation_budgets=cfg.degradation.controller_kwargs(),
        )
    )


if __name__ == "__main__":
    main()
