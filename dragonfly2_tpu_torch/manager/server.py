"""Manager process entry: RPC + keepalive reaper + job-lease reaper in one
asyncio loop. The port of dragonfly2_tpu/manager/server.py:

    python -m dragonfly2_tpu_torch.manager.server --port 9200 --db /var/lib/df/manager.db

It takes the reference's flags and ``--config`` YAML layering and prints the
reference's ready line, ``manager ready rpc=<addr> rest=None``: the REST
front is not ported, so REST is off. Refused with exit 2, naming the
ROADMAP.md item that ports them: an explicit ``--rest-port`` (flag or
YAML), ``--metrics-port``, ``--ca-dir``, ``--cert-token``, ``--auth-secret``,
``--admin-password`` and ``--object-storage-dir``.

Reference equivalent: manager/manager.go:101 (gin REST + gRPC v1/v2 + GC on
one composition root).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys

from dragonfly2_tpu_torch.manager.db import Database
from dragonfly2_tpu_torch.manager.jobs import JobQueue
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.rpc.core import RpcServer
from dragonfly2_tpu_torch.rpc.manager import ManagerRpcAdapter, register_manager
from dragonfly2_tpu_torch.utils.proc import run_until_signalled

logger = logging.getLogger("manager")


_STILL_TO_PORT = "ROADMAP.md §1, 'Still to do' item 4"


class ManagerServer:
    def __init__(
        self,
        *,
        db_path: str = ":memory:",
        host: str = "127.0.0.1",
        port: int = 0,
        keepalive_ttl: float = 60.0,
        searcher: str = "default",
    ):
        self.db = Database(db_path)
        self.service = ManagerService(
            self.db, keepalive_ttl=keepalive_ttl, searcher_spec=searcher
        )
        self.jobs = JobQueue(self.db)
        self.rpc = RpcServer(host=host, port=port)
        register_manager(self.rpc, ManagerRpcAdapter(self.service, self.jobs))
        self.rest_port = None  # the REST front is not ported
        self._reaper: asyncio.Task | None = None
        self._lease_reaper: asyncio.Task | None = None

    @property
    def address(self) -> str:
        return self.rpc.address

    async def start(self) -> None:
        self.jobs.requeue_pending()
        await self.rpc.start()
        self._reaper = asyncio.ensure_future(self.service.run_reaper())
        self._lease_reaper = asyncio.ensure_future(self._run_lease_reaper())
        logger.info("manager rpc on %s", self.rpc.address)

    async def _run_lease_reaper(self) -> None:
        while True:
            await asyncio.sleep(30.0)
            try:
                n = self.jobs.reap_leases()
                if n:
                    logger.warning("requeued %d expired job leases", n)
            except Exception:
                logger.exception("lease reaper pass failed")

    async def stop(self) -> None:
        for t in (self._reaper, self._lease_reaper):
            if t is not None:
                t.cancel()
        await self.rpc.stop()
        self.db.close()


async def amain(args: argparse.Namespace) -> None:
    server = ManagerServer(
        db_path=args.db, host=args.host, port=args.port,
        keepalive_ttl=args.keepalive_ttl, searcher=args.searcher,
    )
    await server.start()
    try:
        await run_until_signalled(
            on_ready=lambda: print(
                f"manager ready rpc={server.address} rest={server.rest_port}", flush=True
            ),
        )
    finally:
        await server.stop()


def _refusals(args: argparse.Namespace) -> list[str]:
    """What this boot asks for that the port does not run yet, one message
    each; the caller refuses the boot when any is set."""
    why = {
        "--rest-port": "the REST front (manager/rest.py)",
        "--metrics-port": "the debug and metrics server (observability/server.py)",
        "--ca-dir": "the cluster CA (security/)",
        "--cert-token": "certificate issuance (security/)",
        "--auth-secret": "REST auth (manager/rest.py, security/)",
        "--admin-password": "users and OAuth (manager/oauth.py)",
        "--object-storage-dir": "object storage (objectstorage/)",
    }
    return [
        f"{flag}: needs {what}, not ported yet ({_STILL_TO_PORT})"
        for flag, what in why.items()
        if getattr(args, flag[2:].replace("-", "_")) is not None
    ]


def main() -> None:
    from dragonfly2_tpu_torch.manager.config import ManagerYaml
    from dragonfly2_tpu_torch.utils.config import ConfigError, load_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None, help="YAML config file (flags override)")
    cargs, _ = pre.parse_known_args()
    try:
        cfg = load_config(ManagerYaml, cargs.config)
    except (ConfigError, OSError) as e:
        print(f"manager: {e}", file=sys.stderr)
        raise SystemExit(2)

    p = argparse.ArgumentParser(description="dragonfly2_tpu_torch manager", parents=[pre])
    p.add_argument("--db", default=cfg.db)
    p.add_argument("--host", default=cfg.host)
    p.add_argument("--port", type=int, default=cfg.port)
    p.add_argument("--rest-port", type=int, default=cfg.rest_port,
                   help="refused: the REST front is not ported yet")
    p.add_argument("--metrics-port", type=int, default=cfg.metrics_port,
                   help="refused: the debug server is not ported yet")
    p.add_argument("--ca-dir", default=cfg.security.ca_dir,
                   help="refused: the cluster CA is not ported yet")
    p.add_argument("--cert-token",
                   default=cfg.security.cert_token or os.environ.get("DRAGONFLY_CERT_TOKEN"),
                   help="bootstrap token gating RPC certificate issuance")
    p.add_argument("--auth-secret",
                   default=cfg.security.auth_secret or os.environ.get("DRAGONFLY_AUTH_SECRET"),
                   help="enable REST auth: HMAC secret for bearer tokens")
    p.add_argument("--admin-password",
                   default=cfg.security.admin_password or os.environ.get("DRAGONFLY_ADMIN_PASSWORD"),
                   help="bootstrap the admin user on first start")
    p.add_argument("--object-storage-dir", default=cfg.object_storage_dir,
                   help="enable buckets CRUD backed by this fs dir")
    p.add_argument("--searcher", default=cfg.searcher,
                   help='cluster searcher: "default" or "plugin:pkg.mod:attr"')
    p.add_argument("--keepalive-ttl", type=float, default=cfg.keepalive_ttl)
    p.add_argument("--log-dir", default=cfg.log_dir,
                   help="per-component rotating log files (console only when unset)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args()
    refused = _refusals(args)
    for name in ("otlp_file", "otlp_endpoint", "trace_file"):
        if getattr(cfg.tracing, name):
            refused.append(
                f"tracing.{name}: the span exporters are not ported yet "
                "(ROADMAP.md §1, 'Left out': tracing exporters)"
            )
    if refused:
        for msg in refused:
            print(f"manager: {msg}", file=sys.stderr)
        raise SystemExit(2)
    from dragonfly2_tpu_torch.observability.tracing import configure_default_tracer
    from dragonfly2_tpu_torch.utils.dflog import setup_logging

    setup_logging(args.log_dir, level=logging.DEBUG if args.verbose else logging.INFO)
    configure_default_tracer("dragonfly-manager", sample_rate=cfg.tracing.sample_rate)
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
