"""Peer-daemon process entry point + its RPC surface for thin CLIs: the port
of dragonfly2_tpu/daemon/server.py.

Reference equivalent: client/daemon (daemon boot) + client/daemon/rpcserver
(rpcserver.go:72-151 — the unix-socket download API dfget/dfcache talk to,
and the peer API served to other daemons; our peer API is the HTTP piece
server in daemon.upload). `python -m dragonfly2_tpu_torch.daemon.server
--scheduler 127.0.0.1:9000 --sock /tmp/df.sock` prints
``DAEMON_READY <sock> <upload port>`` once it serves. The RPC methods, the
piece server's HTTP API and the on-disk task layout are the reference's, so
either package's dfget drives this daemon and either package's conductor
fetches pieces from it. A booted daemon imports no torch.

The image-acceleration front runs as the reference's does: ``--proxy-port``
(the HTTP proxy, ``--proxy-rule``), ``--registry-mirror``,
``--hijack-ca-dir`` with ``--hijack-host`` (HTTPS interception on the proxy
and the SNI proxy), ``--sni-proxy-port`` and the YAML ``proxy:`` section;
``--object-storage-port``, ``--object-storage-root`` and
``--object-storage-backend`` (fs, s3, oss, obs; the remote ones read their
endpoint and credentials from the environment) and ``object_storage:``
serve the object gateway behind dfstore. An HTTPS origin behind a private CA
is trusted through the environment (``SSL_CERT_FILE``), as the process's
default TLS context reads it.

The secure, observable daemon is the reference's too: ``--data-tls-dir``
(``tls.crt``, ``tls.key`` and ``ca.pem``, as ``security.ca.write_issued``
writes them) puts the piece plane on mTLS with the cipher the one-shot
probe picks, or ``--piece-cipher``; ``--vsock-port`` serves the daemon RPC
over AF_VSOCK; ``--metrics-port`` serves the debug server (``/metrics``,
``/debug/*``); a ``tracing:`` section exports spans to a JSON-lines file,
an OTLP file or an OTLP endpoint.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os

from dragonfly2_tpu_torch.daemon.engine import PeerEngine, RangeOutOfBounds
from dragonfly2_tpu_torch.rpc.core import RpcError, RpcServer
from dragonfly2_tpu_torch.utils.proc import run_until_signalled

logger = logging.getLogger("daemon")

DAEMON_METHODS = [
    "download", "stat_task", "delete_task", "export_task", "host_info",
    "trigger_seed", "import_file", "publish_checkpoint", "fetch_checkpoint",
]


class DaemonRpcAdapter:
    """Download API for the thin CLIs (ref dfdaemon Download/Stat/Delete)."""

    def __init__(self, engine: PeerEngine):
        self.engine = engine

    async def download(self, p: dict) -> dict:
        rng_s = p.get("range", "")
        rng = None
        if rng_s:
            # "start-end" inclusive bytes, HTTP Range semantics (ref dfget
            # ranged download); bounds are validated against the downloaded
            # content length inside download_task, under its operation pin
            start_s, _, end_s = rng_s.partition("-")
            try:
                rng = (int(start_s), int(end_s))
            except ValueError:
                raise RpcError(f"bad range {rng_s!r}: want START-END", code="bad_request")
        import math

        try:
            # tenant priority: the task's weight in the host traffic
            # shaper (dfget/dfstress mixed-tenant load) — client-supplied,
            # so a non-numeric value is the CLIENT's error, not an internal
            # fault the caller should retry. Finite and positive only: an
            # inf/nan weight poisons the shaper's weighted-share math for
            # EVERY tenant, and a zero/negative one would be silently
            # clamped to near-starvation instead of doing what the client
            # plausibly meant.
            priority = float(p.get("priority", 1.0))
            if not math.isfinite(priority) or priority <= 0:
                raise ValueError
        except (TypeError, ValueError):
            raise RpcError(
                f"bad priority {p.get('priority')!r}: want a finite number > 0",
                code="bad_request",
            )
        try:
            ts = await self.engine.download_task(
                p["url"],
                output=p.get("output"),
                output_range=rng if p.get("output") else None,
                tag=p.get("tag", ""),
                application=p.get("application", ""),
                digest=p.get("digest", ""),
                filters=tuple(p.get("filters", ())),
                headers=p.get("headers") or None,
                priority=priority,
            )
        except RangeOutOfBounds as e:
            # ONLY the bounds check maps to bad_request — an internal
            # ValueError from the download pipeline must stay a server error
            # (retryable), not be blamed on the client's request
            raise RpcError(str(e), code="bad_request")
        if rng and p.get("output"):
            exported = rng[1] - rng[0] + 1
        else:
            exported = ts.meta.content_length
        return {
            "task_id": ts.meta.task_id,
            "content_length": ts.meta.content_length,
            "exported_bytes": exported,
            "pieces": ts.finished_count(),
            "done": ts.meta.done,
        }

    async def stat_task(self, p: dict) -> dict | None:
        ts = self.engine.storage.get(p["task_id"])
        if ts is None:
            return None
        return {
            "task_id": ts.meta.task_id,
            "content_length": ts.meta.content_length,
            "pieces": ts.finished_count(),
            "total_pieces": ts.meta.total_pieces,
            "done": ts.meta.done,
        }

    async def delete_task(self, p: dict) -> None:
        self.engine.storage.delete_task(p["task_id"])

    async def export_task(self, p: dict) -> None:
        ts = self.engine.storage.get(p["task_id"])
        if ts is None or not ts.meta.done:
            # Not held locally: pull the cache task from the CLUSTER, exactly
            # like the reference's dfcache Export (client/dfcache/dfcache.go
            # exportTask runs a download through the daemon) — any peer that
            # imported or fetched it serves the pieces.
            try:
                await self.engine.download_task(
                    f"d7y://cache/{p['task_id']}", output=p["output"]
                )
                return
            except IOError as e:
                if "registration refused" in str(e) or "unavailable" in str(e):
                    # the scheduler's "no peer holds this" refusal — the only
                    # failure that truly means the content is gone; disk/path/
                    # network faults propagate as internal errors instead of
                    # lying that the cache content vanished
                    raise RpcError(
                        f"task {p['task_id']} not cached locally or on any peer: {e}",
                        code="not_found",
                    )
                raise
        # pin across the whole local export: closes the window between this
        # done-check and export_to's own pin where the threaded reclaim could
        # evict the task
        ts.pin()
        try:
            await ts.export_to(p["output"])
        finally:
            ts.unpin()

    async def host_info(self, p: dict | None) -> dict:
        hi = self.engine.host_info()
        return {"id": hi.id, "ip": hi.ip, "download_port": hi.download_port}

    async def trigger_seed(self, p: dict) -> dict:
        """Seed this task from origin (ref cdnsystemv1 ObtainSeeds served by
        dfdaemon's seeder facade, client/daemon/rpcserver/seeder.go:49-53).
        Called by the scheduler over TCP RPC; synchronous — returns when the
        seed copy is complete so preheat jobs can report success."""
        ts = await self.engine.download_task(
            p["url"],
            seed=True,
            tag=p.get("tag", ""),
            application=p.get("application", ""),
            digest=p.get("digest", ""),
            filters=tuple(p.get("filters", ())),
            headers=p.get("headers") or None,
        )
        return {
            "task_id": ts.meta.task_id,
            "content_length": ts.meta.content_length,
            "pieces": ts.finished_count(),
            "done": ts.meta.done,
        }

    async def import_file(self, p: dict) -> dict:
        """Import a local file into the P2P cache (ref dfcache Import,
        client/dfcache/dfcache.go:105)."""
        ts = await self.engine.import_file(
            p["path"], tag=p.get("tag", ""), application=p.get("application", "")
        )
        return {"task_id": ts.meta.task_id, "pieces": ts.finished_count()}

    async def publish_checkpoint(self, p: dict) -> dict:
        """Import a checkpoint dir into the P2P cache (tpuvm fan-out,
        north-star config 4)."""
        from dragonfly2_tpu_torch.tpuvm.checkpoint import publish_checkpoint

        manifest = await publish_checkpoint(
            self.engine, p["directory"], name=p.get("name", "")
        )
        return {
            "name": manifest.name,
            "files": len(manifest.files),
            "total_bytes": manifest.total_bytes,
            "manifest": str(p["directory"]).rstrip("/") + "/dragonfly-checkpoint.json",
        }

    async def fetch_checkpoint(self, p: dict) -> dict:
        from dragonfly2_tpu_torch.tpuvm.checkpoint import fetch_checkpoint, fetch_manifest

        manifest = await fetch_manifest(self.engine, p["manifest"])
        dest = await fetch_checkpoint(
            self.engine, manifest, p["dest"], concurrency=int(p.get("concurrency", 4))
        )
        return {
            "name": manifest.name,
            "files": len(manifest.files),
            "total_bytes": manifest.total_bytes,
            "dest": str(dest),
        }


def make_address_book_resolver(manager_client, cache_path, *, ip: str | None = None):
    """Scheduler address book with a last-good disk snapshot (manager-outage
    autonomy): while the manager answers, every successful
    list is staleness-stamped to `cache_path`; when it stops answering, the
    resolver serves the snapshot instead of failing — downloads keep
    scheduling through a full manager blackout, including a daemon that
    (re)boots mid-blackout. Raises only when the manager is dark AND no
    snapshot was ever written (a first boot with nothing to fall back on)."""
    from dragonfly2_tpu_torch.utils.dynconfig import load_snapshot, store_snapshot

    async def resolve() -> list[str]:
        try:
            rows = await manager_client.list_schedulers(ip=ip)
        except Exception as e:
            snap = load_snapshot(cache_path)
            if snap is None:
                raise
            logging.getLogger(__name__).warning(
                "manager unreachable; scheduler address book from disk "
                "snapshot (age %.0fs): %s", snap.staleness_s(), e,
            )
            return [a for a in snap.data.get("schedulers", []) if a]
        addrs = [f"{r['ip']}:{r['port']}" for r in rows if r.get("ip") and r.get("port")]
        if addrs:
            store_snapshot(cache_path, {"schedulers": addrs})
        return addrs

    return resolve


async def run_daemon(
    *,
    scheduler_addr: str,
    storage_root: str,
    sock_path: str,
    ip: str = "127.0.0.1",
    hostname: str = "",
    host_type: str = "normal",
    idc: str = "",
    location: str = "",
    upload_port: int = 0,
    rpc_port: int | None = None,
    vsock_port: int | None = None,
    metrics_port: int | None = None,
    proxy_port: int | None = None,
    proxy_rules: list | None = None,
    registry_mirror: str | None = None,
    hijack_ca_dir: str | None = None,
    hijack_hosts: list | None = None,
    sni_proxy_port: int | None = None,
    object_storage_port: int | None = None,
    object_storage_root: str | None = None,
    object_storage_backend: str = "fs",
    manager_addr: str | None = None,
    announce_interval: float = 30.0,
    probe_interval: float | None = None,
    storage_ttl: float = 24 * 3600,
    storage_capacity_bytes: int | None = None,
    disk_gc_threshold: float | None = None,
    total_download_rate_bps: float | None = None,
    per_task_rate_bps: float | None = None,
    data_tls_dir: str | None = None,
    piece_cipher: str | None = None,
    ready_event: asyncio.Event | None = None,
) -> None:
    from dragonfly2_tpu_torch.resilience import faultline
    from dragonfly2_tpu_torch.rpc.balancer import make_scheduler_client

    # chaos runs opt in via DF_FAULTS="point:kind:rate[,...],seed=N" (see
    # README "Resilience"); unset means faultline stays a no-op None check
    faultline.install_from_env()

    # one address → plain client; "a:1,b:2" (or a manager address book) →
    # consistent-hash balanced with live membership (ref pkg/resolver fed by
    # dynconfig: the manager's scheduler list is the source of truth)
    resolve = None
    resolver_manager = None
    if manager_addr:
        from pathlib import Path as _Path

        from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient

        # manager RPCs consult the shared per-process "manager" retry budget
        # too: a blackout makes every daemon loop retry the same dead
        # address — beyond the budget, fail fast to the cached snapshot below
        resolver_manager = RemoteManagerClient(manager_addr, target_class="manager")
        resolve = make_address_book_resolver(
            resolver_manager,
            _Path(storage_root) / "scheduler_address_book.json",
            ip=ip,
        )

    # wire clients consult the process-wide "scheduler" retry budget: an
    # unreachable scheduler fails RPC retries fast past the budget instead
    # of every conductor loop retrying it independently
    scheduler = make_scheduler_client(scheduler_addr, resolve=resolve, target_class="scheduler")
    if hasattr(scheduler, "start_resolver"):
        scheduler.start_resolver()
    from dragonfly2_tpu_torch.daemon.conductor import ConductorConfig

    conductor_config = None
    if per_task_rate_bps is not None:
        conductor_config = ConductorConfig(download_rate_bps=per_task_rate_bps)
    # secure-by-default piece plane: --data-tls-dir names a directory holding
    # tls.crt/tls.key/ca.pem (the cache layout security.ca.write_issued
    # produces from the manager's issuance RPC); the bundle's one-shot probe
    # picks the cipher unless --piece-cipher pins it
    data_tls = None
    if data_tls_dir:
        from pathlib import Path

        from dragonfly2_tpu_torch.security.transport import DataPlaneTls

        d = Path(data_tls_dir)
        data_tls = DataPlaneTls.from_paths(
            str(d / "tls.crt"), str(d / "tls.key"), str(d / "ca.pem"),
            policy=piece_cipher or None,
        )
        logging.getLogger(__name__).info(
            "data-plane mTLS on: cipher=%s ktls=%s", data_tls.policy,
            data_tls.ktls["reason"],
        )
    engine = PeerEngine(
        storage_root=storage_root,
        scheduler=scheduler,
        ip=ip,
        hostname=hostname,
        host_type=host_type,
        idc=idc,
        location=location,
        upload_port=upload_port,
        conductor_config=conductor_config,
        total_download_rate_bps=total_download_rate_bps,
        storage_ttl=storage_ttl,
        storage_capacity_bytes=storage_capacity_bytes,
        disk_gc_threshold=disk_gc_threshold,
        data_tls=data_tls,
    )
    await engine.start()

    server = RpcServer(unix_path=sock_path)
    server.register_service(DaemonRpcAdapter(engine), DAEMON_METHODS)
    await server.start()

    # Seed peers also listen on TCP so the scheduler can trigger_seed them
    # (the reference's cdnsystem gRPC port, seed_peer.go:115). Normal peers
    # may opt in with --rpc-port.
    tcp_server = None
    if rpc_port is not None or host_type == "seed":
        tcp_server = RpcServer(host=ip, port=rpc_port or 0)
        tcp_server.register_service(DaemonRpcAdapter(engine), DAEMON_METHODS)
        await tcp_server.start()
        engine.rpc_port = tcp_server.port
    # AF_VSOCK listener for VM-isolated clients — e.g. dfget inside a Kata
    # container reaching the host daemon (ref pkg/rpc/vsock.go transport)
    vsock_server = None
    if vsock_port is not None:
        vsock_server = RpcServer(vsock_port=vsock_port)
        vsock_server.register_service(DaemonRpcAdapter(engine), DAEMON_METHODS)
        await vsock_server.start()
        logger.info("daemon vsock rpc on %s", vsock_server.address)
    proxy = None
    sni_proxy = None
    if proxy_port is not None or sni_proxy_port is not None:
        from dragonfly2_tpu_torch.daemon.proxy import (
            HttpsHijack,
            ProxyConfig,
            ProxyRule,
            ProxyServer,
            RegistryMirrorConfig,
            SniProxy,
        )

        hijack = None
        if hijack_ca_dir:
            from dragonfly2_tpu_torch.security.ca import CertificateAuthority
            from dragonfly2_tpu_torch.security.mitm import CertForger

            hijack = HttpsHijack(
                forger=CertForger(CertificateAuthority(hijack_ca_dir)),
                hosts=tuple(hijack_hosts) if hijack_hosts else (r".*",),
            )
        pcfg = ProxyConfig(
            rules=[r if isinstance(r, ProxyRule) else ProxyRule(regex=r) for r in (proxy_rules or [])],
            registry_mirror=RegistryMirrorConfig(base_url=registry_mirror) if registry_mirror else None,
            https_hijack=hijack,
        )
        proxy = ProxyServer(engine, host=ip, port=proxy_port or 0, config=pcfg)
        if proxy_port is not None:
            await proxy.start()
            logger.info("proxy on %s:%d", ip, proxy.port)
        if sni_proxy_port is not None:
            sni_proxy = SniProxy(proxy, host=ip, port=sni_proxy_port, hijack=hijack)
            await sni_proxy.start()
            logger.info("sni proxy on %s:%d", ip, sni_proxy.port)

    objgw = None
    if object_storage_port is not None:
        from dragonfly2_tpu_torch.daemon.objectgw import ObjectGateway
        from dragonfly2_tpu_torch.objectstorage import new_backend

        if object_storage_backend == "s3":
            # endpoint/credentials from the environment, the S3 convention
            from dragonfly2_tpu_torch.objectstorage.s3client import S3Config

            s3cfg = S3Config.from_env()
            backend = new_backend(
                "s3", endpoint=s3cfg.endpoint, access_key=s3cfg.access_key,
                secret_key=s3cfg.secret_key, region=s3cfg.region,
            )
        elif object_storage_backend in ("oss", "obs"):
            # the vendors' env conventions (ALIBABA/HUAWEI cloud CLIs)
            p = object_storage_backend.upper()
            backend = new_backend(
                object_storage_backend,
                endpoint=os.environ.get(f"{p}_ENDPOINT", ""),
                access_key=os.environ.get(f"{p}_ACCESS_KEY_ID", ""),
                secret_key=os.environ.get(
                    f"{p}_ACCESS_KEY_SECRET", os.environ.get(f"{p}_SECRET_ACCESS_KEY", "")
                ),
            )
        else:
            backend = new_backend(
                "fs", root=object_storage_root or (str(storage_root) + "-objects")
            )
        objgw = ObjectGateway(engine, backend, host=ip, port=object_storage_port)
        await objgw.start()

    # loop-health sampling is always on (4 clock reads/s): lag histograms
    # must cover the incident, not start after it — /debug/loop serves them
    from dragonfly2_tpu_torch.observability.loophealth import default_monitor

    loop_monitor = default_monitor()
    loop_monitor.start()
    # metrics plane: timeseries rings + SLO alerts, always on —
    # the announce loop below ships a windowed stats frame to the manager
    # when one is configured
    from dragonfly2_tpu_torch.observability.alerts import default_engine
    from dragonfly2_tpu_torch.observability.timeseries import default_recorder

    recorder = default_recorder()
    recorder.start()
    alert_engine = default_engine()
    alert_engine.start()
    debug = None
    if metrics_port is not None:
        from dragonfly2_tpu_torch.observability.server import start_debug_server

        debug = await start_debug_server(host=ip, port=metrics_port)
        logger.info("daemon metrics on %s:%d", ip, debug.port)
    logger.info(
        "daemon rpc on %s (tcp %s), piece server on :%d",
        sock_path, engine.rpc_port or "-", engine.upload.port,
    )

    manager = None
    if manager_addr and host_type == "seed":
        # only seed peers register with the manager (normal peers are known to
        # their scheduler via announce; ref client keepalive is daemon→manager
        # only for seed address books); shares the resolver's connection
        manager = resolver_manager

    async def announce_loop() -> None:
        """Keepalive + host stats to the scheduler (ref client/daemon/announcer:
        AnnounceHost to scheduler + keepalive to manager)."""
        while True:
            try:
                await scheduler.announce_host(engine.host_info(), _host_stats())  # dflint: disable=DF025 periodic keepalive schedule (one announce per interval), not per-item fan-out
                # possession keepalive: a restarted scheduler has an empty
                # resource pool — re-announcing held tasks every interval is
                # what lets it rebuild its parent view from announces alone
                await engine.announce_tasks()
            except Exception:
                logger.warning("announce failed", exc_info=True)
            if manager is not None:
                try:
                    if host_type == "seed":
                        await manager.update_seed_peer(
                            engine.hostname, ip, engine.rpc_port,
                            download_port=engine.upload.port,
                            idc=idc, location=location,
                        )
                except Exception:
                    logger.warning("manager keepalive failed", exc_info=True)
            if resolver_manager is not None:
                # cluster metrics plane: every daemon that knows
                # the manager ships its windowed stats frame on the same
                # announce tick — the manager aggregates, dftop renders
                try:
                    from dragonfly2_tpu_torch.observability.timeseries import (
                        build_stats_frame,
                    )

                    frame = build_stats_frame(
                        recorder, service="daemon", hostname=engine.hostname,
                        alerts=alert_engine,
                    )
                    await resolver_manager.keepalive(
                        "daemon", engine.hostname, stats=frame
                    )
                except Exception:
                    logger.debug("stats frame push failed", exc_info=True)
            await asyncio.sleep(announce_interval)

    from dragonfly2_tpu_torch.daemon.prober import DEFAULT_PROBE_INTERVAL, Prober

    prober = Prober(
        scheduler, engine.host_id, interval=probe_interval or DEFAULT_PROBE_INTERVAL
    )
    prober.start()
    announcer = asyncio.ensure_future(announce_loop())
    try:
        # the ready line comes once the signal handlers are in place, so a
        # SIGTERM sent as soon as a caller reads it stops the daemon cleanly
        await run_until_signalled(
            ready_event,
            on_ready=lambda: print(
                f"DAEMON_READY {sock_path} {engine.upload.port}", flush=True
            ),
        )
    finally:
        loop_monitor.stop()
        alert_engine.stop()
        recorder.stop()
        announcer.cancel()
        await prober.stop()
        if sni_proxy is not None:
            await sni_proxy.stop()
        if proxy is not None:
            await proxy.stop()
        if objgw is not None:
            await objgw.stop()  # also closes the backend's HTTP session
        if debug is not None:
            await debug.stop()
        await server.stop()
        if tcp_server is not None:
            await tcp_server.stop()
        if vsock_server is not None:
            await vsock_server.stop()
        # graceful departure (ref scheduler v2 LeaveHost): tell the scheduler
        # this host's peers are gone NOW so swarms re-parent immediately
        # instead of burning retries against a dead peer until keepalive GC
        try:
            await scheduler.leave_host(engine.host_id)
        except Exception:
            logger.debug("leave_host on shutdown failed", exc_info=True)
        await engine.stop()
        await scheduler.close()
        if resolver_manager is not None:
            await resolver_manager.close()
        if os.path.exists(sock_path):
            os.unlink(sock_path)


def _host_stats() -> dict:
    """Best-effort host stats (the reference uses gopsutil; stdlib here)."""
    stats: dict[str, float] = {}
    try:
        load1, _, _ = os.getloadavg()
        stats["cpu_usage"] = min(1.0, load1 / max(1, os.cpu_count() or 1))
    except OSError:
        pass
    try:
        import shutil

        du = shutil.disk_usage("/")
        stats["disk_usage"] = du.used / du.total
    except OSError:
        pass
    return stats


def main() -> None:
    import sys

    from dragonfly2_tpu_torch.daemon.config import DaemonYaml
    from dragonfly2_tpu_torch.utils.config import ConfigError, load_config

    # Two-stage parse (the reference's cobra/viper layering): --config loads
    # the validated YAML, whose values become the flag DEFAULTS.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None, help="YAML config file (flags override)")
    cargs, _ = pre.parse_known_args()
    try:
        cfg = load_config(DaemonYaml, cargs.config)
    except (ConfigError, OSError) as e:
        print(f"daemon: {e}", file=sys.stderr)
        raise SystemExit(2)

    ap = argparse.ArgumentParser(description="dragonfly2_tpu_torch peer daemon", parents=[pre])
    ap.add_argument("--scheduler", required=not cfg.scheduler, default=cfg.scheduler or None,
                    help="scheduler address host:port")
    ap.add_argument("--storage", default=os.path.expanduser(cfg.storage.root))
    ap.add_argument("--sock", default=cfg.sock)
    ap.add_argument("--ip", default=cfg.ip)
    ap.add_argument("--hostname", default=cfg.hostname)
    ap.add_argument("--seed", action=argparse.BooleanOptionalAction, default=cfg.seed,
                    help="run as seed peer (--no-seed overrides a config-file true)")
    ap.add_argument("--idc", default=cfg.idc)
    ap.add_argument("--location", default=cfg.location)
    ap.add_argument("--upload-port", type=int, default=cfg.upload_port)
    ap.add_argument("--metrics-port", type=int, default=cfg.metrics_port,
                    help="dedicated debug/metrics port (off by default)")
    ap.add_argument("--proxy-port", type=int, default=cfg.proxy.port,
                    help="HTTP proxy / registry-mirror port (off by default)")
    ap.add_argument("--proxy-rule", action="append", default=None,
                    help="URL regex routed through P2P (repeatable; REPLACES config-file rules)")
    ap.add_argument("--registry-mirror", default=cfg.proxy.registry_mirror,
                    help="upstream registry base URL for mirror mode")
    ap.add_argument("--hijack-ca-dir", default=cfg.proxy.hijack_ca_dir,
                    help="CA dir enabling HTTPS MITM on the proxy (forged leaf certs)")
    ap.add_argument("--hijack-host", action="append", default=None,
                    help="host regex to MITM (repeatable; REPLACES config-file hosts; default all when CA set)")
    ap.add_argument("--sni-proxy-port", type=int, default=cfg.proxy.sni_port,
                    help="raw-TLS SNI proxy port (off by default)")
    ap.add_argument("--object-storage-port", type=int, default=cfg.object_storage.port,
                    help="dfstore object gateway port (off by default)")
    ap.add_argument("--object-storage-root", default=cfg.object_storage.root,
                    help="fs backend root (default: <storage>-objects)")
    ap.add_argument("--object-storage-backend", default=cfg.object_storage.backend,
                    choices=["fs", "s3", "oss", "obs"],
                    help="object store behind the gateway; s3 reads AWS_* env "
                         "vars, oss reads OSS_*, obs reads OBS_*")
    ap.add_argument("--rpc-port", type=int, default=cfg.rpc_port,
                    help="TCP RPC port (seed peers always listen; 0 = ephemeral)")
    ap.add_argument("--vsock-port", type=int, default=cfg.vsock_port,
                    help="AF_VSOCK RPC port for VM-isolated clients (Kata)")
    ap.add_argument("--manager", default=cfg.manager, help="manager address host:port")
    ap.add_argument("--announce-interval", type=float, default=30.0,
                    help="scheduler announce / manager stats-frame cadence "
                         "in seconds (default 30)")
    ap.add_argument("--probe-interval", type=float, default=cfg.probe_interval,
                    help="RTT probe cadence in seconds (default 20 min)")
    ap.add_argument("--storage-ttl-hours", type=float, default=cfg.storage.ttl_hours,
                    help="reclaim tasks idle past this many hours")
    ap.add_argument("--storage-capacity-gb", type=float, default=cfg.storage.capacity_gb,
                    help="evict LRU complete tasks when the store exceeds this size")
    ap.add_argument("--disk-gc-threshold-pct", type=float,
                    default=cfg.storage.disk_gc_threshold_pct,
                    help="evict LRU complete tasks when disk usage passes this percent")
    ap.add_argument("--log-dir", default=cfg.log_dir,
                    help="per-component rotating log files (console only when unset)")
    ap.add_argument("--data-tls-dir", default=cfg.data_tls_dir,
                    help="directory with tls.crt/tls.key/ca.pem: piece plane "
                         "(upload server + fetches) runs mTLS with cipher "
                         "autoselection")
    ap.add_argument("--piece-cipher", default=cfg.piece_cipher,
                    choices=["aes-gcm", "chacha20"],
                    help="pin the data-plane cipher (default: one-shot probe)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    if args.object_storage_backend != "fs":
        if args.object_storage_root:
            ap.error("--object-storage-root applies to the fs backend only")
        required = {
            "s3": ("AWS_ENDPOINT_URL", "DF_S3_ENDPOINT"),
            "oss": ("OSS_ENDPOINT",),
            "obs": ("OBS_ENDPOINT",),
        }[args.object_storage_backend]
        if not any(os.environ.get(v) for v in required):
            ap.error(
                f"--object-storage-backend {args.object_storage_backend} "
                f"requires {required[0]} in the environment"
            )
    from dragonfly2_tpu_torch.observability.tracing import configure_default_tracer
    from dragonfly2_tpu_torch.utils.dflog import setup_logging

    setup_logging(args.log_dir, level=logging.DEBUG if args.verbose else logging.INFO)
    configure_default_tracer(
        "dragonfly-daemon",
        otlp_file=cfg.tracing.otlp_file, otlp_endpoint=cfg.tracing.otlp_endpoint,
        trace_file=cfg.tracing.trace_file, sample_rate=cfg.tracing.sample_rate,
    )
    asyncio.run(
        run_daemon(
            scheduler_addr=args.scheduler,
            storage_root=args.storage,
            sock_path=args.sock,
            ip=args.ip,
            hostname=args.hostname,
            host_type="seed" if args.seed else "normal",
            idc=args.idc,
            location=args.location,
            upload_port=args.upload_port,
            rpc_port=args.rpc_port,
            vsock_port=args.vsock_port,
            metrics_port=args.metrics_port,
            proxy_port=args.proxy_port,
            proxy_rules=args.proxy_rule if args.proxy_rule is not None else list(cfg.proxy.rules),
            registry_mirror=args.registry_mirror,
            hijack_ca_dir=args.hijack_ca_dir,
            hijack_hosts=(
                args.hijack_host if args.hijack_host is not None else list(cfg.proxy.hijack_hosts)
            ),
            sni_proxy_port=args.sni_proxy_port,
            object_storage_port=args.object_storage_port,
            object_storage_root=args.object_storage_root,
            object_storage_backend=args.object_storage_backend,
            manager_addr=args.manager,
            announce_interval=args.announce_interval,
            probe_interval=args.probe_interval,
            storage_ttl=args.storage_ttl_hours * 3600,
            storage_capacity_bytes=(
                int(args.storage_capacity_gb * (1 << 30))
                if args.storage_capacity_gb is not None
                else None
            ),
            disk_gc_threshold=(
                args.disk_gc_threshold_pct / 100.0
                if args.disk_gc_threshold_pct is not None
                else None
            ),
            total_download_rate_bps=cfg.rate_limit.total_download_mib_per_s * (1 << 20),
            per_task_rate_bps=cfg.rate_limit.per_task_mib_per_s * (1 << 20),
            data_tls_dir=args.data_tls_dir,
            piece_cipher=args.piece_cipher,
        )
    )


if __name__ == "__main__":
    main()
