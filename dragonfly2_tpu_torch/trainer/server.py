"""Trainer process entry, the port of dragonfly2_tpu/trainer/server.py.

    python -m dragonfly2_tpu_torch.trainer.server --port 9300 \
        --manager 127.0.0.1:9200 --model-dir /var/lib/df/models [--device cpu]

Serves the port's ``TrainerService`` over the JAX package's wire protocol
(``rpc/core.py``): a scheduler's announcer, from either package, uploads
telemetry to it, and it publishes each trained model to the manager. It
trains on the card unless ``--device`` names another. Prints
``TRAINER_READY <addr>`` once it listens, and stops on SIGINT or SIGTERM.
The process runs the time-series recorder, and with a manager a stats frame
rides ``keepalive("trainer", ..., stats=frame)`` every ``stats_interval``
seconds (20 by default), as the reference's does.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import socket

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.rpc.core import RpcServer
from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient
from dragonfly2_tpu_torch.rpc.trainer import register_trainer
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService
from dragonfly2_tpu_torch.utils.proc import run_until_signalled

logger = logging.getLogger("trainer")


def trainer_config(
    *, model_dir: str = "/tmp/dragonfly2_tpu_models", gnn_steps: int = 300, gnn_hidden: int | None = None,
    mlp_steps: int | None = None, min_pairs: int | None = None, min_probe_rows: int | None = None,
    device: str | None = None,
) -> TrainerConfig:
    """The service's config: production defaults, each override replacing
    only the hyperparameter it names."""
    cfg = TrainerConfig(model_dir=model_dir, gnn_steps=gnn_steps, device=device)
    if gnn_hidden is not None:
        cfg.gnn = dataclasses.replace(
            cfg.gnn, hidden=gnn_hidden, embed_dim=max(16, gnn_hidden // 2),
            batch_size=min(cfg.gnn.batch_size, gnn_hidden * 4),
        )
    if mlp_steps is not None:
        cfg.mlp = dataclasses.replace(cfg.mlp, steps=mlp_steps)
    if min_pairs is not None:
        cfg.min_pairs = min_pairs
    if min_probe_rows is not None:
        cfg.min_probe_rows = min_probe_rows
    return cfg


async def start_trainer(
    config: TrainerConfig, *, host: str = "127.0.0.1", port: int = 9300, manager_addr: str | None = None,
) -> tuple[RpcServer, TrainerService]:
    """The listening trainer server and its service, publishing to the
    manager at ``manager_addr`` (or to none). Raises at once when the
    config's device (the card unless it names another) is absent."""
    device = resolve_device(config.device)
    manager = RemoteManagerClient(manager_addr) if manager_addr else None
    service = TrainerService(config, manager=manager)
    server = RpcServer(host=host, port=port)
    register_trainer(server, service)
    await server.start()
    logger.info("trainer listening on %s, training on %s", server.address, device)
    return server, service


async def stop_trainer(server: RpcServer, service: TrainerService) -> None:
    await server.stop()
    if service.manager is not None:
        await service.manager.close()


async def run_trainer(
    *, host: str = "127.0.0.1", port: int = 9300, manager_addr: str | None = None,
    stats_interval: float = 20.0, ready_event: asyncio.Event | None = None, **config,
) -> None:
    """Serve until SIGINT/SIGTERM (or until the task is cancelled).
    ``config`` takes ``trainer_config``'s keywords."""
    from dragonfly2_tpu_torch.observability.timeseries import build_stats_frame, default_recorder

    server, service = await start_trainer(trainer_config(**config), host=host, port=port,
                                          manager_addr=manager_addr)
    # cluster metrics plane: the trainer is a member of the cluster view
    # too; its frame (loop lag and whatever trainer families exist) rides a
    # keepalive tick like every other service's
    recorder = default_recorder()
    recorder.start()
    stats_task = None
    if service.manager is not None:
        manager = service.manager
        trainer_host = socket.gethostname()

        async def stats_loop() -> None:
            while True:
                await asyncio.sleep(stats_interval)
                try:
                    frame = build_stats_frame(recorder, service="trainer", hostname=trainer_host)
                    await manager.keepalive("trainer", trainer_host, stats=frame)
                except Exception:
                    logger.debug("stats frame push failed", exc_info=True)

        stats_task = asyncio.ensure_future(stats_loop())
    try:
        await run_until_signalled(ready_event, lambda: print(f"TRAINER_READY {server.address}", flush=True))
    finally:
        recorder.stop()
        if stats_task is not None:
            stats_task.cancel()
        await stop_trainer(server, service)


def main() -> None:
    ap = argparse.ArgumentParser(description="dragonfly2_tpu_torch trainer")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9300)
    ap.add_argument("--model-dir", default="/tmp/dragonfly2_tpu_models")
    ap.add_argument("--manager", default=None)
    ap.add_argument("--gnn-steps", type=int, default=300)
    ap.add_argument("--gnn-hidden", type=int, default=None,
                    help="override GNN width (small clusters / tests)")
    ap.add_argument("--mlp-steps", type=int, default=None,
                    help="override MLP training steps")
    ap.add_argument("--min-pairs", type=int, default=None,
                    help="minimum (parent,child) rows before training")
    ap.add_argument("--min-probe-rows", type=int, default=None,
                    help="minimum probe rows before GNN training")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card; 'cpu' to run without one)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    asyncio.run(
        run_trainer(
            host=args.host, port=args.port, manager_addr=args.manager, model_dir=args.model_dir,
            gnn_steps=args.gnn_steps, gnn_hidden=args.gnn_hidden, mlp_steps=args.mlp_steps,
            min_pairs=args.min_pairs, min_probe_rows=args.min_probe_rows, device=args.device,
        )
    )


if __name__ == "__main__":
    main()
