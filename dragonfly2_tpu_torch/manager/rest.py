"""Manager REST API (the console/ops surface).

Reference equivalent: manager/handlers/*.go (gin routes under /api/v1:
scheduler-clusters, schedulers, seed-peer-clusters, seed-peers, applications,
configs, models, jobs, users, healthz — api/manager swagger). JSON in/out;
route shape kept 1:1 so ops tooling ports directly.

The port of dragonfly2_tpu/manager/rest.py: the same routes, statuses and
JSON bodies, so one sequence of requests gets equal answers from either
package's manager.
"""

from __future__ import annotations

import logging
from typing import Any

from aiohttp import web

from dragonfly2_tpu_torch.manager.jobs import JobQueue
from dragonfly2_tpu_torch.manager.preheat import PreheatProducer
from dragonfly2_tpu_torch.manager.service import ManagerService

logger = logging.getLogger(__name__)


def _json(data: Any, status: int = 200) -> web.Response:
    return web.json_response(data, status=status)


class ManagerRest:
    def __init__(
        self,
        service: ManagerService,
        jobs: JobQueue,
        *,
        auth_secret: str | None = None,
        ca=None,
        object_storage=None,
    ):
        self.svc = service
        self.jobs = jobs
        self.preheat = PreheatProducer(jobs)
        self.auth_secret = auth_secret  # None → open (dev mode), like ref --disable-auth
        self.ca = ca  # security.ca.CertificateAuthority | None
        self.object_storage = object_storage  # objectstorage.ObjectStorageBackend | None
        self._oauth_state_store = None
        from dragonfly2_tpu_torch.security.rbac import Rbac

        self.rbac = Rbac()

    # ---- auth middleware (ref manager/middlewares/jwt.go + permission) ----

    # "/" is the console shell itself — it holds the token box, so it must
    # load pre-auth; every API call it makes is still auth-gated
    _OPEN_PATHS = ("/", "/healthz", "/api/v1/users/signin")
    # the oauth redirect/callback legs are browser-driven and pre-auth
    _OPEN_PREFIXES = ("/api/v1/users/signin/oauth/",)

    @web.middleware
    async def _auth_middleware(self, req: web.Request, handler):
        if (
            self.auth_secret is None
            or req.path in self._OPEN_PATHS
            or req.path.startswith(self._OPEN_PREFIXES)
        ):
            return await handler(req)
        from dragonfly2_tpu_torch.security.tokens import TokenError, verify_token

        authz = req.headers.get("Authorization", "")
        if not authz.startswith("Bearer "):
            return _json({"error": "missing bearer token"}, status=401)
        try:
            claims = verify_token(authz[7:], self.auth_secret)
        except TokenError as e:
            return _json({"error": str(e)}, status=401)
        parts = req.path.split("/")  # /api/v1/<resource>/...
        resource = parts[3] if len(parts) > 3 else ""
        action = self.rbac.action_for_method(req.method)
        if not self.rbac.allowed(claims.get("role", "guest"), resource, action):
            return _json({"error": f"role {claims.get('role')!r} may not {action} {resource}"}, status=403)
        req["user"] = claims
        return await handler(req)

    def app(self) -> web.Application:
        app = web.Application(middlewares=[self._auth_middleware])
        r = app.router
        r.add_get("/", self.console)  # embedded ops console (ref manager dist SPA)
        r.add_get("/healthz", self.healthz)
        # users + auth
        r.add_post("/api/v1/users/signin", self.signin)
        r.add_get("/api/v1/users", self.list_users)
        r.add_post("/api/v1/users", self.create_user)
        r.add_patch("/api/v1/users/{name}", self.update_user)
        r.add_delete("/api/v1/users/{name}", self.delete_user)
        # certificates (ref pkg/rpc/security issuance)
        r.add_post("/api/v1/certificates", self.issue_certificate)
        # scheduler clusters
        r.add_get("/api/v1/scheduler-clusters", self.list_scheduler_clusters)
        r.add_post("/api/v1/scheduler-clusters", self.create_scheduler_cluster)
        r.add_get(r"/api/v1/scheduler-clusters/{id:\d+}", self.get_scheduler_cluster)
        r.add_patch(r"/api/v1/scheduler-clusters/{id:\d+}", self.update_scheduler_cluster)
        r.add_delete(r"/api/v1/scheduler-clusters/{id:\d+}", self.delete_scheduler_cluster)
        # schedulers / seed peers (instance registry, read-mostly)
        r.add_get("/api/v1/schedulers", self.list_schedulers)
        r.add_get("/api/v1/seed-peers", self.list_seed_peers)
        # cluster metrics plane: REST mirror of the cluster_stats
        # RPC — same JSON dftop renders, curl-able for dashboards
        r.add_get("/api/v1/cluster/stats", self.cluster_stats)
        # applications
        r.add_get("/api/v1/applications", self.list_applications)
        r.add_post("/api/v1/applications", self.upsert_application)
        # configs
        r.add_get("/api/v1/configs/{name}", self.get_config)
        r.add_post("/api/v1/configs", self.set_config)
        # model registry
        r.add_get("/api/v1/models", self.list_models)
        r.add_post("/api/v1/models", self.create_model)
        r.add_post(r"/api/v1/models/{id:\d+}/activate", self.activate_model)
        r.add_delete(r"/api/v1/models/{id:\d+}", self.delete_model)
        # rollout state machine: status / promote / rollback
        r.add_get("/api/v1/models/rollout/{type}", self.rollout_status)
        r.add_post(r"/api/v1/models/{id:\d+}/promote", self.promote_model)
        r.add_post(r"/api/v1/models/{id:\d+}/reject", self.reject_model)
        r.add_post("/api/v1/models/rollout/{type}/rollback", self.rollback_model)
        # jobs (preheat)
        r.add_post("/api/v1/jobs", self.create_job)
        r.add_get(r"/api/v1/jobs/{id:\d+}", self.get_job)
        # oauth providers + code-flow sign-in (ref handlers/oauth.go)
        r.add_get("/api/v1/oauth", self.list_oauth)
        r.add_post("/api/v1/oauth", self.create_oauth)
        r.add_get(r"/api/v1/oauth/{id:\d+}", self.get_oauth)
        r.add_patch(r"/api/v1/oauth/{id:\d+}", self.update_oauth)
        r.add_delete(r"/api/v1/oauth/{id:\d+}", self.delete_oauth)
        r.add_get("/api/v1/users/signin/oauth/{name}", self.oauth_signin)
        r.add_get("/api/v1/users/signin/oauth/{name}/callback", self.oauth_callback)
        # buckets fronting the object storage backend (ref handlers/bucket.go)
        r.add_get("/api/v1/buckets", self.list_buckets)
        r.add_post("/api/v1/buckets", self.create_bucket)
        r.add_get("/api/v1/buckets/{name}", self.get_bucket)
        r.add_delete("/api/v1/buckets/{name}", self.delete_bucket)
        return app

    async def console(self, req: web.Request) -> web.Response:
        from dragonfly2_tpu_torch.manager.console import CONSOLE_HTML

        return web.Response(text=CONSOLE_HTML, content_type="text/html")

    # ---- users + certificates ----

    async def signin(self, req: web.Request) -> web.Response:
        body = await req.json()
        user = self.svc.verify_user(body.get("name", ""), body.get("password", ""))
        if user is None:
            return _json({"error": "invalid credentials"}, status=401)
        if self.auth_secret is None:
            return _json({"user": user, "token": ""})
        from dragonfly2_tpu_torch.security.tokens import sign_token

        token = sign_token({"sub": user["name"], "role": user["role"]}, self.auth_secret)
        return _json({"user": user, "token": token})

    async def list_users(self, req: web.Request) -> web.Response:
        return _json({"users": self.svc.list_users()})

    async def create_user(self, req: web.Request) -> web.Response:
        body = await req.json()
        try:
            user = self.svc.create_user(
                body["name"], body["password"],
                role=body.get("role", "guest"), email=body.get("email", ""),
            )
        except (KeyError, ValueError) as e:
            return _json({"error": str(e)}, status=400)
        return _json(user, status=201)

    async def update_user(self, req: web.Request) -> web.Response:
        name = req.match_info["name"]
        if not any(u["name"] == name for u in self.svc.list_users()):
            return _json({"error": "no such user"}, status=404)
        body = await req.json()
        unknown = set(body) - {"role"}
        if unknown:
            return _json({"error": f"unsupported fields: {sorted(unknown)}"}, status=400)
        if "role" in body:
            self.svc.update_user_role(name, body["role"])
        return _json({"ok": True})

    async def delete_user(self, req: web.Request) -> web.Response:
        if not self.svc.delete_user(req.match_info["name"]):
            return _json({"error": "no such user"}, status=404)
        return _json({"ok": True})

    async def issue_certificate(self, req: web.Request) -> web.Response:
        if self.ca is None:
            return _json({"error": "manager has no CA configured"}, status=400)
        body = await req.json()
        issued = self.ca.issue(
            body.get("name", "service"), sans=tuple(body.get("sans", ()))
        )
        return _json(issued.to_dict(), status=201)

    async def healthz(self, req: web.Request) -> web.Response:
        return _json({"status": "ok"})

    # ---- scheduler clusters ----

    async def list_scheduler_clusters(self, req: web.Request) -> web.Response:
        return _json(self.svc.db.find("scheduler_clusters"))

    async def create_scheduler_cluster(self, req: web.Request) -> web.Response:
        body = await req.json()
        try:
            row = self.svc.create_scheduler_cluster(
                body["name"],
                bio=body.get("bio", ""),
                config=body.get("config"),
                client_config=body.get("client_config"),
                scopes=body.get("scopes"),
                is_default=body.get("is_default", False),
            )
        except Exception as e:
            return _json({"error": str(e)}, status=400)
        return _json(row, status=201)

    async def get_scheduler_cluster(self, req: web.Request) -> web.Response:
        row = self.svc.db.get("scheduler_clusters", int(req.match_info["id"]))
        return _json(row) if row else _json({"error": "not found"}, status=404)

    async def update_scheduler_cluster(self, req: web.Request) -> web.Response:
        body = await req.json()
        row_id = int(req.match_info["id"])
        row = self.svc.db.get("scheduler_clusters", row_id)
        if row is None:
            return _json({"error": "not found"}, status=404)
        allowed = {k: body[k] for k in ("bio", "config", "client_config", "scopes", "is_default") if k in body}
        if allowed:
            self.svc.db.update("scheduler_clusters", row_id, **allowed)
        return _json(self.svc.db.get("scheduler_clusters", row_id))

    async def delete_scheduler_cluster(self, req: web.Request) -> web.Response:
        ok = self.svc.db.delete("scheduler_clusters", int(req.match_info["id"]))
        return _json({"deleted": ok}, status=200 if ok else 404)

    # ---- instances ----

    async def list_schedulers(self, req: web.Request) -> web.Response:
        return _json(self.svc.db.find("schedulers"))

    async def list_seed_peers(self, req: web.Request) -> web.Response:
        return _json(self.svc.db.find("seed_peers"))

    async def cluster_stats(self, req: web.Request) -> web.Response:
        try:
            history = min(64, int(req.query.get("history", "0")))
        except ValueError:
            return _json({"error": "history must be an integer"}, status=400)
        return _json(self.svc.cluster_stats(history=history))

    # ---- applications / configs ----

    async def list_applications(self, req: web.Request) -> web.Response:
        return _json(self.svc.list_applications())

    async def upsert_application(self, req: web.Request) -> web.Response:
        body = await req.json()
        return _json(
            self.svc.upsert_application(
                body["name"], url=body.get("url", ""),
                bio=body.get("bio", ""), priority=body.get("priority"),
            ),
            status=201,
        )

    async def get_config(self, req: web.Request) -> web.Response:
        row = self.svc.get_config(req.match_info["name"])
        return _json(row) if row else _json({"error": "not found"}, status=404)

    async def set_config(self, req: web.Request) -> web.Response:
        body = await req.json()
        return _json(self.svc.set_config(body["name"], body["value"], bio=body.get("bio", "")), status=201)

    # ---- models ----

    async def list_models(self, req: web.Request) -> web.Response:
        where = {k: v for k, v in req.query.items() if k in ("type", "state", "scheduler_id")}
        if "scheduler_id" in where:
            where["scheduler_id"] = int(where["scheduler_id"])
        return _json(self.svc.list_models(**where))

    async def create_model(self, req: web.Request) -> web.Response:
        body = await req.json()
        try:
            row = self.svc.create_model(
                body["type"], body["version"],
                scheduler_id=body.get("scheduler_id", 0),
                bio=body.get("bio", ""),
                evaluation=body.get("evaluation"),
                artifact_path=body.get("artifact_path", ""),
            )
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        return _json(row, status=201)

    async def activate_model(self, req: web.Request) -> web.Response:
        try:
            return _json(self.svc.activate_model(int(req.match_info["id"])))
        except KeyError:
            return _json({"error": "not found"}, status=404)

    async def delete_model(self, req: web.Request) -> web.Response:
        ok = self.svc.delete_model(int(req.match_info["id"]))
        return _json({"deleted": ok}, status=200 if ok else 404)

    async def rollout_status(self, req: web.Request) -> web.Response:
        sid = int(req.query.get("scheduler_id", 0))
        return _json(self.svc.rollout_status(req.match_info["type"], sid))

    async def promote_model(self, req: web.Request) -> web.Response:
        try:
            return _json(self.svc.promote_model(int(req.match_info["id"])))
        except KeyError:
            return _json({"error": "not found"}, status=404)
        except ValueError as e:
            return _json({"error": str(e)}, status=409)

    async def reject_model(self, req: web.Request) -> web.Response:
        body = await req.json() if req.can_read_body else {}
        try:
            return _json(
                self.svc.reject_model(int(req.match_info["id"]), body.get("reason", ""))
            )
        except KeyError:
            return _json({"error": "not found"}, status=404)
        except ValueError as e:
            return _json({"error": str(e)}, status=409)

    async def rollback_model(self, req: web.Request) -> web.Response:
        body = await req.json() if req.can_read_body else {}
        try:
            return _json(
                self.svc.rollback_model(
                    req.match_info["type"],
                    int(body.get("scheduler_id", 0)),
                    reason=body.get("reason", ""),
                )
            )
        except ValueError as e:
            return _json({"error": str(e)}, status=409)

    # ---- jobs ----

    async def create_job(self, req: web.Request) -> web.Response:
        body = await req.json()
        if body.get("type") != "preheat":
            return _json({"error": f"unknown job type {body.get('type')!r}"}, status=400)
        args = body.get("args") or {}
        cluster_ids = body.get("scheduler_cluster_ids") or [
            self.svc.get_or_create_default_cluster()["id"]
        ]
        try:
            job = await self.preheat.create_preheat(
                args.get("type", "file"),
                args["url"],
                scheduler_cluster_ids=cluster_ids,
                tag=args.get("tag", ""),
                filters=args.get("filters"),
                headers=args.get("headers"),
            )
        except Exception as e:
            return _json({"error": str(e)}, status=400)
        return _json(job, status=201)

    # ---- oauth providers + code-flow sign-in (ref handlers/oauth.go) ----

    async def list_oauth(self, req: web.Request) -> web.Response:
        return _json(self.svc.list_oauth())

    async def create_oauth(self, req: web.Request) -> web.Response:
        body = await req.json()
        name = body.pop("name", "")
        if not name:
            return _json({"error": "name required"}, status=400)
        try:
            return _json(self.svc.create_oauth(name, **body), status=201)
        except ValueError as e:
            return _json({"error": str(e)}, status=400)

    async def get_oauth(self, req: web.Request) -> web.Response:
        row = self.svc.get_oauth(int(req.match_info["id"]))
        return _json(row) if row else _json({"error": "not found"}, status=404)

    async def update_oauth(self, req: web.Request) -> web.Response:
        body = await req.json()
        try:
            row = self.svc.update_oauth(int(req.match_info["id"]), **body)
        except ValueError as e:
            return _json({"error": str(e)}, status=400)
        return _json(row) if row else _json({"error": "not found"}, status=404)

    async def delete_oauth(self, req: web.Request) -> web.Response:
        ok = self.svc.delete_oauth(int(req.match_info["id"]))
        return _json({"ok": ok}, status=200 if ok else 404)

    @property
    def _oauth_states(self):
        if getattr(self, "_oauth_state_store", None) is None:
            import os as _os

            from dragonfly2_tpu_torch.manager.oauth import StateStore

            # random per-process secret when auth is off: states stay
            # unforgeable either way, and they are single-use in-memory
            self._oauth_state_store = StateStore(self.auth_secret or _os.urandom(16).hex())
        return self._oauth_state_store

    async def oauth_signin(self, req: web.Request) -> web.Response:
        from dragonfly2_tpu_torch.manager import oauth as oauthlib

        name = req.match_info["name"]
        provider = self.svc.get_oauth_by_name(name, with_secret=True)
        if provider is None:
            return _json({"error": "unknown oauth provider"}, status=404)
        state = self._oauth_states.mint(name)
        raise web.HTTPFound(oauthlib.authorize_url(provider, state))

    async def oauth_callback(self, req: web.Request) -> web.Response:
        from dragonfly2_tpu_torch.manager import oauth as oauthlib

        name = req.match_info["name"]
        provider = self.svc.get_oauth_by_name(name, with_secret=True)
        if provider is None:
            return _json({"error": "unknown oauth provider"}, status=404)
        code = req.query.get("code", "")
        state = req.query.get("state", "")
        if not code:
            return _json({"error": "missing code"}, status=400)
        if not self._oauth_states.consume(state, name):
            return _json({"error": "bad, expired, or replayed state"}, status=401)
        try:
            token = await oauthlib.exchange_code(provider, code)
            ident = await oauthlib.fetch_identity(provider, token)
        except oauthlib.OauthError as e:
            return _json({"error": str(e)}, status=502)
        try:
            user = self.svc.upsert_oauth_user(name, ident["name"], email=ident["email"])
        except ValueError as e:
            return _json({"error": str(e)}, status=403)
        if self.auth_secret is None:
            return _json({"user": user, "token": ""})
        from dragonfly2_tpu_torch.security.tokens import sign_token

        jwt = sign_token({"sub": user["name"], "role": user["role"]}, self.auth_secret)
        return _json({"user": user, "token": jwt})

    # ---- buckets fronting object storage (ref handlers/bucket.go) ----

    def _buckets_backend(self):
        if self.object_storage is None:
            raise web.HTTPServiceUnavailable(
                text='{"error": "object storage not configured"}',
                content_type="application/json",
            )
        return self.object_storage

    async def list_buckets(self, req: web.Request) -> web.Response:
        backend = self._buckets_backend()
        rows = await backend.list_buckets()
        return _json([{"name": b.name, "created_at": b.created_at} for b in rows])

    async def create_bucket(self, req: web.Request) -> web.Response:
        from dragonfly2_tpu_torch.objectstorage.backend import ObjectStorageError

        backend = self._buckets_backend()
        body = await req.json()
        name = body.get("name", "")
        if not name:
            return _json({"error": "name required"}, status=400)
        try:
            await backend.create_bucket(name)
        except ObjectStorageError as e:
            status = 400 if e.code == "invalid" else 409
            return _json({"error": str(e)}, status=status)
        return _json({"name": name}, status=201)

    async def get_bucket(self, req: web.Request) -> web.Response:
        backend = self._buckets_backend()
        name = req.match_info["name"]
        if not await backend.bucket_exists(name):
            return _json({"error": "not found"}, status=404)
        return _json({"name": name})

    async def delete_bucket(self, req: web.Request) -> web.Response:
        from dragonfly2_tpu_torch.objectstorage.backend import ObjectStorageError

        backend = self._buckets_backend()
        try:
            await backend.delete_bucket(req.match_info["name"])
        except ObjectStorageError as e:
            status = {"not_found": 404, "invalid": 400}.get(e.code, 409)
            return _json({"error": str(e)}, status=status)
        return _json({"ok": True})

    async def get_job(self, req: web.Request) -> web.Response:
        row = self.jobs.state(int(req.match_info["id"]))
        return _json(row) if row else _json({"error": "not found"}, status=404)


async def start_rest(
    service: ManagerService,
    jobs: JobQueue,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    auth_secret: str | None = None,
    ca=None,
    object_storage=None,
) -> tuple[web.AppRunner, int]:
    runner = web.AppRunner(
        ManagerRest(
            service, jobs, auth_secret=auth_secret, ca=ca, object_storage=object_storage
        ).app(),
        access_log=None,
    )
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, port
