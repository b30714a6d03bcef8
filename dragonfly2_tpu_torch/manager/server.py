"""Manager process entry: RPC + REST + reaper in one asyncio loop. The port
of dragonfly2_tpu/manager/server.py:

    python -m dragonfly2_tpu_torch.manager.server --port 9200 --rest-port 9201 \
        --db /var/lib/df/manager.db

It takes the reference's flags and ``--config`` YAML layering and prints the
reference's ready line, ``manager ready rpc=<addr> rest=<port>``. The REST
front (``manager/rest.py``: the registry, users and RBAC, OAuth, buckets,
preheat jobs and the console) is off unless ``--rest-port`` (or the YAML's
``rest_port``) asks for it, and open unless ``--auth-secret`` is set, as in
the reference's dev mode. ``--ca-dir`` turns on the cluster CA, whose
``issue_certificate`` RPC the bootstrap ``--cert-token`` gates;
``--metrics-port`` serves the debug server.

Reference equivalent: manager/manager.go:101 (gin REST + gRPC v1/v2 + GC on
one composition root).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os

from dragonfly2_tpu_torch.manager.db import Database
from dragonfly2_tpu_torch.manager.jobs import JobQueue
from dragonfly2_tpu_torch.manager.rest import start_rest
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.rpc.core import RpcServer
from dragonfly2_tpu_torch.rpc.manager import ManagerRpcAdapter, register_manager
from dragonfly2_tpu_torch.utils.proc import run_until_signalled

logger = logging.getLogger("manager")


class ManagerServer:
    def __init__(
        self,
        *,
        db_path: str = ":memory:",
        host: str = "127.0.0.1",
        port: int = 0,
        rest_port: int | None = None,
        metrics_port: int | None = None,
        keepalive_ttl: float = 60.0,
        ca_dir: str | None = None,
        cert_token: str | None = None,
        auth_secret: str | None = None,
        admin_password: str | None = None,
        object_storage_dir: str | None = None,
        object_storage=None,
        searcher: str = "default",
        ssl=None,
    ):
        self.db = Database(db_path)
        self.service = ManagerService(
            self.db, keepalive_ttl=keepalive_ttl, searcher_spec=searcher
        )
        self.jobs = JobQueue(self.db)
        self.ca = None
        if ca_dir:
            from dragonfly2_tpu_torch.security.ca import CertificateAuthority

            self.ca = CertificateAuthority(ca_dir)
        self.auth_secret = auth_secret
        # any registry backend instance (fs/s3/oss/obs) may be injected;
        # object_storage_dir remains the fs convenience path
        self.object_storage = object_storage
        if self.object_storage is None and object_storage_dir:
            from dragonfly2_tpu_torch.objectstorage.backend import LocalFSBackend

            self.object_storage = LocalFSBackend(object_storage_dir)
        if admin_password and not self.db.find("users", name="admin"):
            self.service.create_user("admin", admin_password, role="admin")
            logger.info("bootstrapped admin user")
        # `ssl`: an ssl.SSLContext (security.ca.server_ssl_context) puts the
        # manager's control RPC on TLS too. Bootstrap order: construct the
        # CertificateAuthority on ca_dir first, self-issue the manager's leaf,
        # build the context, then pass BOTH ca_dir and ssl here — the CA class
        # reloads the same ca.pem/ca.key, so issuance and serving share one
        # trust root.
        self.rpc = RpcServer(host=host, port=port, ssl=ssl)
        adapter = ManagerRpcAdapter(self.service, self.jobs)
        adapter.ca = self.ca  # enables issue_certificate over RPC...
        adapter.cert_token = cert_token  # ...gated by the bootstrap token
        register_manager(self.rpc, adapter)
        self.rest_port = rest_port
        self.metrics_port = metrics_port
        self._debug = None
        self._rest_runner = None
        self._reaper: asyncio.Task | None = None
        self._lease_reaper: asyncio.Task | None = None

    @property
    def address(self) -> str:
        return self.rpc.address

    async def start(self) -> None:
        self.jobs.requeue_pending()
        await self.rpc.start()
        if self.rest_port is not None:
            self._rest_runner, self.rest_port = await start_rest(
                self.service, self.jobs, host=self.rpc.host, port=self.rest_port,
                auth_secret=self.auth_secret, ca=self.ca,
                object_storage=self.object_storage,
            )
        if self.metrics_port is not None:
            from dragonfly2_tpu_torch.observability.server import start_debug_server

            self._debug = await start_debug_server(host=self.rpc.host, port=self.metrics_port)
            self.metrics_port = self._debug.port
            logger.info("manager metrics on %s:%d", self.rpc.host, self.metrics_port)
        self._reaper = asyncio.ensure_future(self.service.run_reaper())
        self._lease_reaper = asyncio.ensure_future(self._run_lease_reaper())
        logger.info("manager rpc on %s rest on :%s", self.rpc.address, self.rest_port)

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
        if self._debug is not None:
            await self._debug.stop()
        if self._rest_runner is not None:
            await self._rest_runner.cleanup()
        await self.rpc.stop()
        self.db.close()


async def amain(args: argparse.Namespace) -> None:
    server = ManagerServer(
        db_path=args.db, host=args.host, port=args.port, rest_port=args.rest_port,
        metrics_port=args.metrics_port, keepalive_ttl=args.keepalive_ttl,
        ca_dir=args.ca_dir, cert_token=args.cert_token,
        auth_secret=args.auth_secret, admin_password=args.admin_password,
        object_storage_dir=args.object_storage_dir,
        searcher=args.searcher,
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


def main() -> None:
    import sys

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
    p.add_argument("--rest-port", type=int, default=cfg.rest_port)
    p.add_argument("--metrics-port", type=int, default=cfg.metrics_port)
    p.add_argument("--ca-dir", default=cfg.security.ca_dir,
                   help="enable the cluster CA (cert issuance)")
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
    from dragonfly2_tpu_torch.observability.tracing import configure_default_tracer
    from dragonfly2_tpu_torch.utils.dflog import setup_logging

    setup_logging(args.log_dir, level=logging.DEBUG if args.verbose else logging.INFO)
    configure_default_tracer(
        "dragonfly-manager",
        otlp_file=cfg.tracing.otlp_file, otlp_endpoint=cfg.tracing.otlp_endpoint,
        trace_file=cfg.tracing.trace_file, sample_rate=cfg.tracing.sample_rate,
    )
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
