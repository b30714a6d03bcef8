"""Manager RPC adapters: wire client + server over rpc.core.

The port's own copy of dragonfly2_tpu/rpc/manager.py, whole: with a CA
(``--ca-dir``) ``issue_certificate`` issues a leaf to a caller that presents
the bootstrap token (``--cert-token``); with none it answers ``unavailable``.

Reference equivalent: pkg/rpc/manager/{client,server} (client_v1/v2: the
GetScheduler/ListSchedulers/UpdateScheduler/KeepAlive surface schedulers and
daemons call, manager/rpcserver/manager_server_v2.go:95-746).
"""

from __future__ import annotations

from typing import Any, Optional

from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.rpc.core import RpcClient, RpcServer

MANAGER_METHODS = [
    "list_schedulers",
    "get_scheduler",
    "update_scheduler",
    "update_seed_peer",
    "keepalive",
    "cluster_config",
    "report_stats",
    "cluster_stats",
    "create_model",
    "activate_model",
    "active_model",
    "list_models",
    "publish_model",
    "promote_model",
    "reject_model",
    "rollback_model",
    "report_shadow",
    "rollout_status",
    "list_applications",
    "get_config",
    "set_config",
    "create_job",
    "job_state",
    "pull_job",
    "complete_job",
    "issue_certificate",
]


class ManagerRpcAdapter:
    """Server side: wire payloads -> ManagerService calls."""

    def __init__(self, service: ManagerService, jobs: Any = None):
        self.svc = service
        self.jobs = jobs  # manager.jobs.JobQueue, wired by server

    async def list_schedulers(self, p: dict) -> list[dict]:
        return self.svc.list_schedulers(p.get("ip", ""), p.get("conditions"))

    async def get_scheduler(self, p: dict) -> Optional[dict]:
        return self.svc.get_scheduler(p["hostname"], p["scheduler_cluster_id"])

    async def update_scheduler(self, p: dict) -> dict:
        return self.svc.update_scheduler(
            p["hostname"], p["ip"], p["port"],
            scheduler_cluster_id=p.get("scheduler_cluster_id"),
            idc=p.get("idc", ""), location=p.get("location", ""),
            features=p.get("features"),
        )

    async def update_seed_peer(self, p: dict) -> dict:
        return self.svc.update_seed_peer(
            p["hostname"], p["ip"], p["port"],
            download_port=p.get("download_port", 0),
            object_storage_port=p.get("object_storage_port", 0),
            seed_peer_cluster_id=p.get("seed_peer_cluster_id"),
            peer_type=p.get("type", "super"),
            idc=p.get("idc", ""), location=p.get("location", ""),
        )

    async def keepalive(self, p: dict) -> bool:
        return self.svc.keepalive(
            p["source_type"], p["hostname"], p.get("cluster_id"),
            stats=p.get("stats"),
        )

    async def cluster_config(self, p: dict) -> dict:
        return self.svc.cluster_config(p["scheduler_cluster_id"])

    # ---- cluster metrics plane ----

    async def report_stats(self, p: dict) -> bool:
        return self.svc.report_stats(
            p.get("source_type", ""), p.get("hostname", ""), p.get("frame") or {}
        )

    async def cluster_stats(self, p: dict | None) -> dict:
        history = int((p or {}).get("history", 0))
        return self.svc.cluster_stats(history=min(history, 64))

    async def create_model(self, p: dict) -> dict:
        return self.svc.create_model(
            p["type"], p["version"],
            scheduler_id=p.get("scheduler_id", 0),
            bio=p.get("bio", ""),
            evaluation=p.get("evaluation"),
            artifact_path=p.get("artifact_path", ""),
        )

    async def activate_model(self, p: dict) -> dict:
        return self.svc.activate_model(p["model_id"])

    async def active_model(self, p: dict) -> Optional[dict]:
        return self.svc.active_model(p["type"], p.get("scheduler_id", 0))

    # ---- rollout state machine ----

    async def publish_model(self, p: dict) -> dict:
        return self.svc.publish_model(
            p["type"], p["version"],
            scheduler_id=p.get("scheduler_id", 0),
            bio=p.get("bio", ""),
            evaluation=p.get("evaluation"),
            artifact_path=p.get("artifact_path", ""),
            artifact_digest=p.get("artifact_digest", ""),
        )

    async def promote_model(self, p: dict) -> dict:
        return self.svc.promote_model(p["model_id"])

    async def reject_model(self, p: dict) -> dict:
        return self.svc.reject_model(p["model_id"], p.get("reason", ""))

    async def rollback_model(self, p: dict) -> dict:
        return self.svc.rollback_model(
            p["type"], p.get("scheduler_id", 0), reason=p.get("reason", "")
        )

    async def report_shadow(self, p: dict) -> dict:
        return self.svc.report_shadow(
            p["model_id"], p.get("hostname", ""), p.get("report") or {}
        )

    async def rollout_status(self, p: dict) -> dict:
        return self.svc.rollout_status(p["type"], p.get("scheduler_id", 0))

    async def list_models(self, p: dict) -> list[dict]:
        # allowlist filter keys: db.find interpolates keys as SQL identifiers
        where = {k: v for k, v in (p or {}).items() if k in ("type", "state", "scheduler_id", "version")}
        return self.svc.list_models(**where)

    async def list_applications(self, p: Any) -> list[dict]:
        return self.svc.list_applications()

    async def get_config(self, p: dict) -> Optional[dict]:
        return self.svc.get_config(p["name"])

    async def set_config(self, p: dict) -> dict:
        return self.svc.set_config(p["name"], p["value"], bio=p.get("bio", ""))

    # ---- jobs (preheat): producer + worker pull/complete ----

    async def create_job(self, p: dict) -> dict:
        return await self.jobs.create(
            p["type"], p.get("args") or {},
            scheduler_cluster_ids=p.get("scheduler_cluster_ids") or [],
        )

    async def job_state(self, p: dict) -> Optional[dict]:
        return self.jobs.state(p["job_id"])

    async def pull_job(self, p: dict) -> Optional[dict]:
        return await self.jobs.pull(p["queue"], timeout=p.get("timeout", 30.0))

    async def complete_job(self, p: dict) -> None:
        self.jobs.complete(
            p["job_id"], success=p["success"], result=p.get("result") or {},
            cluster_id=p.get("cluster_id"),
        )

    async def issue_certificate(self, p: dict) -> dict:
        """Issue a leaf cert for a cluster service (ref pkg/rpc/security).
        `ca` + `cert_token` are wired by the server when --ca-dir is set;
        callers must present the cluster bootstrap token — the RPC plane has
        no user auth, and an open issuance endpoint would hand the mTLS trust
        root to any network peer."""
        import hmac as _hmac

        from dragonfly2_tpu_torch.rpc.core import RpcError

        ca = getattr(self, "ca", None)
        if ca is None:
            raise RpcError("manager has no CA configured", code="unavailable")
        token = getattr(self, "cert_token", None)
        if not token:
            raise RpcError(
                "certificate issuance over RPC requires --cert-token on the manager",
                code="permission_denied",
            )
        if not _hmac.compare_digest(str(p.get("token", "")), token):
            raise RpcError("bad bootstrap token", code="permission_denied")
        issued = ca.issue(p.get("name", "service"), sans=tuple(p.get("sans", ())))
        return issued.to_dict()


def register_manager(server: RpcServer, adapter: ManagerRpcAdapter) -> None:
    server.register_service(adapter, MANAGER_METHODS)


class RemoteManagerClient:
    """Client side; method-per-RPC mirror of ManagerService."""

    def __init__(self, address: str, **kw: Any):
        self._c = RpcClient(address, **kw)

    async def close(self) -> None:
        await self._c.close()

    async def healthy(self) -> bool:
        return await self._c.healthy()

    async def list_schedulers(self, ip: str = "", conditions: dict | None = None) -> list[dict]:
        return await self._c.call("list_schedulers", {"ip": ip, "conditions": conditions})

    async def update_scheduler(self, hostname: str, ip: str, port: int, **kw: Any) -> dict:
        return await self._c.call(
            "update_scheduler", {"hostname": hostname, "ip": ip, "port": port, **kw}
        )

    async def update_seed_peer(self, hostname: str, ip: str, port: int, **kw: Any) -> dict:
        return await self._c.call(
            "update_seed_peer", {"hostname": hostname, "ip": ip, "port": port, **kw}
        )

    async def keepalive(
        self,
        source_type: str,
        hostname: str,
        cluster_id: int | None = None,
        *,
        stats: dict | None = None,
    ) -> bool:
        payload: dict[str, Any] = {
            "source_type": source_type, "hostname": hostname, "cluster_id": cluster_id,
        }
        if stats is not None:
            payload["stats"] = stats
        return await self._c.call("keepalive", payload)

    async def report_stats(self, source_type: str, hostname: str, frame: dict) -> bool:
        return await self._c.call(
            "report_stats",
            {"source_type": source_type, "hostname": hostname, "frame": frame},
        )

    async def cluster_stats(self, *, history: int = 0) -> dict:
        return await self._c.call("cluster_stats", {"history": history})

    async def cluster_config(self, scheduler_cluster_id: int) -> dict:
        return await self._c.call("cluster_config", {"scheduler_cluster_id": scheduler_cluster_id})

    async def create_model(self, model_type: str, version: str, **kw: Any) -> dict:
        return await self._c.call("create_model", {"type": model_type, "version": version, **kw})

    async def activate_model(self, model_id: int) -> dict:
        return await self._c.call("activate_model", {"model_id": model_id})

    async def active_model(self, model_type: str, scheduler_id: int = 0) -> Optional[dict]:
        return await self._c.call("active_model", {"type": model_type, "scheduler_id": scheduler_id})

    async def publish_model(self, model_type: str, version: str, **kw: Any) -> dict:
        return await self._c.call("publish_model", {"type": model_type, "version": version, **kw})

    async def promote_model(self, model_id: int) -> dict:
        return await self._c.call("promote_model", {"model_id": model_id})

    async def reject_model(self, model_id: int, reason: str = "") -> dict:
        return await self._c.call("reject_model", {"model_id": model_id, "reason": reason})

    async def rollback_model(
        self, model_type: str, scheduler_id: int = 0, *, reason: str = ""
    ) -> dict:
        return await self._c.call(
            "rollback_model",
            {"type": model_type, "scheduler_id": scheduler_id, "reason": reason},
        )

    async def report_shadow(self, model_id: int, hostname: str, report: dict) -> dict:
        return await self._c.call(
            "report_shadow",
            {"model_id": model_id, "hostname": hostname, "report": report},
        )

    async def rollout_status(self, model_type: str, scheduler_id: int = 0) -> dict:
        return await self._c.call(
            "rollout_status", {"type": model_type, "scheduler_id": scheduler_id}
        )

    async def list_models(self, **where: Any) -> list[dict]:
        return await self._c.call("list_models", where)

    async def list_applications(self) -> list[dict]:
        return await self._c.call("list_applications")

    async def get_config(self, name: str) -> Optional[dict]:
        return await self._c.call("get_config", {"name": name})

    async def set_config(self, name: str, value: dict, bio: str = "") -> dict:
        return await self._c.call("set_config", {"name": name, "value": value, "bio": bio})

    async def create_job(self, job_type: str, args: dict, scheduler_cluster_ids: list[int] | None = None) -> dict:
        return await self._c.call(
            "create_job",
            {"type": job_type, "args": args, "scheduler_cluster_ids": scheduler_cluster_ids or []},
        )

    async def job_state(self, job_id: int) -> Optional[dict]:
        return await self._c.call("job_state", {"job_id": job_id})

    async def pull_job(self, queue: str, timeout: float = 30.0) -> Optional[dict]:
        # server long-polls up to `timeout`; allow transport slack on top
        return await self._c.call(
            "pull_job", {"queue": queue, "timeout": timeout}, timeout=timeout + 10.0
        )

    async def complete_job(
        self, job_id: int, *, success: bool, result: dict | None = None,
        cluster_id: int | None = None,
    ) -> None:
        await self._c.call(
            "complete_job",
            {"job_id": job_id, "success": success, "result": result or {}, "cluster_id": cluster_id},
        )

    async def issue_certificate(
        self, name: str, sans: list[str] | None = None, *, token: str = ""
    ) -> dict:
        """Obtain a leaf cert + key + CA bundle from the manager's CA
        (ref certify's Obtain via pkg/rpc/security). `token` is the cluster
        bootstrap token configured on the manager."""
        return await self._c.call(
            "issue_certificate", {"name": name, "sans": sans or [], "token": token}
        )
