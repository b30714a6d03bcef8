"""The port's manager REST front (manager/rest.py, preheat.py, oauth.py,
console.py, and the users and OAuth methods of ManagerService) against the
reference's.

- One sequence of requests, sent to a fresh manager of each package (REST
  with auth, the CA, an admin user and object storage), gets equal statuses
  and JSON bodies, with times, tokens and key material masked: sign-in,
  users, certificates, clusters, instances, cluster stats, applications,
  configs, models and the rollout state machine, preheat jobs, OAuth
  providers, buckets, and a guest refused every write.
- The auth and RBAC flow, with bearer tokens signed by either package.
- The OAuth code flow against a local fake provider: the redirect's signed
  state, the code exchange, the namespaced user, a replayed or forged state
  refused, a provider error answered 502.
- Bucket CRUD over the fs backend, and 503 when no bucket store is set.
- The console at ``/``, open while the API stays gated.
- File and image preheat against ``tests/fakeregistry.py``: an image URL
  resolves to its layers' blob URLs, equal in both packages.
- A preheat job through the port's REST front, the port's scheduler (its
  ManagerLink's job loop) and the port's seed daemon (its ``trigger_seed``
  over TCP) reaches SUCCESS, the seed holding the file.

Every coroutine runs under a deadline of 120 s.
"""

from __future__ import annotations

import asyncio
import hashlib
from urllib.parse import parse_qs, urlsplit

import aiohttp
import pytest
import torch
from aiohttp import web

from fakeregistry import FakeRegistry
from test_e2e import Origin

from dragonfly2_tpu.manager import rest as ref_rest
from dragonfly2_tpu.manager.db import Database as RefDatabase
from dragonfly2_tpu.manager.jobs import JobQueue as RefJobQueue
from dragonfly2_tpu.manager.server import ManagerServer as RefManagerServer
from dragonfly2_tpu.manager.service import ManagerService as RefManagerService
from dragonfly2_tpu.security import tokens as ref_tokens
from dragonfly2_tpu_torch.manager import rest as port_rest
from dragonfly2_tpu_torch.manager.db import Database
from dragonfly2_tpu_torch.manager.jobs import JobQueue
from dragonfly2_tpu_torch.manager.server import ManagerServer
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.security import tokens as port_tokens
from dragonfly2_tpu_torch.security.ca import CertificateAuthority

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

DEADLINE_S = 120.0
SERVER = {"port": ManagerServer, "ref": RefManagerServer}
TOKENS = {"port": port_tokens, "ref": ref_tokens}
# fields whose values differ by run (clocks, signatures, key material)
MASKED = frozenset({"created_at", "updated_at", "last_keepalive", "at", "ts", "age_s", "token",
                    "cert_pem", "key_pem", "ca_pem"})


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def mask(x):
    if isinstance(x, dict):
        return {k: ("<masked>" if k in MASKED else mask(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [mask(v) for v in x]
    return x


async def _sequence(base: str, origin_url: str) -> list:
    """The requests, in order; each answer as (status, JSON body or None)."""
    out: list = []
    async with aiohttp.ClientSession() as s:
        async def call(method: str, path: str, token: str | None = None, **kw):
            headers = {"Authorization": f"Bearer {token}"} if token else {}
            async with s.request(method, base + path, headers=headers, allow_redirects=False, **kw) as r:
                body = await r.json(content_type=None) if "json" in r.headers.get("Content-Type", "") else None
                out.append((method, path, r.status, mask(body)))
                return body

        await call("GET", "/healthz")
        await call("GET", "/api/v1/schedulers")  # no token
        await call("POST", "/api/v1/users/signin", json={"name": "admin", "password": "wrong"})
        admin = (await call("POST", "/api/v1/users/signin", json={"name": "admin", "password": "adminpw"}))["token"]
        for user in ({"name": "op", "password": "op-pw", "role": "operator"},
                     {"name": "viewer", "password": "view-pw"}, {"name": "viewer", "password": "x"}, {"name": "x"}):
            await call("POST", "/api/v1/users", admin, json=user)
        await call("GET", "/api/v1/users", admin)
        await call("PATCH", "/api/v1/users/op", admin, json={"role": "guest"})
        await call("PATCH", "/api/v1/users/op", admin, json={"email": "x@y"})
        await call("PATCH", "/api/v1/users/nobody", admin, json={"role": "guest"})
        await call("DELETE", "/api/v1/users/op", admin)
        await call("DELETE", "/api/v1/users/op", admin)
        await call("POST", "/api/v1/certificates", admin, json={"name": "svc", "sans": ["127.0.0.1"]})
        await call("POST", "/api/v1/scheduler-clusters", admin, json={"name": "c1", "bio": "first", "is_default": True})
        await call("POST", "/api/v1/scheduler-clusters", admin, json={"bio": "no name"})
        await call("GET", "/api/v1/scheduler-clusters", admin)
        await call("GET", "/api/v1/scheduler-clusters/1", admin)
        await call("PATCH", "/api/v1/scheduler-clusters/1", admin, json={"bio": "renamed", "ignored": 1})
        await call("GET", "/api/v1/scheduler-clusters/99", admin)
        await call("GET", "/api/v1/schedulers", admin)
        await call("GET", "/api/v1/seed-peers", admin)
        await call("GET", "/api/v1/cluster/stats?history=2", admin)
        await call("GET", "/api/v1/cluster/stats?history=x", admin)
        await call("POST", "/api/v1/applications", admin, json={"name": "app", "url": "http://a", "priority": {"value": 3}})
        await call("GET", "/api/v1/applications", admin)
        await call("POST", "/api/v1/configs", admin, json={"name": "model_rollout", "value": {"enabled": False}})
        await call("GET", "/api/v1/configs/model_rollout", admin)
        await call("GET", "/api/v1/configs/nope", admin)
        await call("POST", "/api/v1/models", admin, json={"type": "gnn", "version": "v1", "evaluation": {"auc": 0.7}})
        await call("POST", "/api/v1/models", admin, json={"type": "gnn", "version": "v2"})
        await call("POST", "/api/v1/models", admin, json={"type": "bogus", "version": "v1"})
        await call("GET", "/api/v1/models?type=gnn", admin)
        await call("POST", "/api/v1/models/1/activate", admin)
        await call("POST", "/api/v1/models/99/activate", admin)
        await call("GET", "/api/v1/models/rollout/gnn", admin)
        await call("POST", "/api/v1/models/2/promote", admin)
        await call("POST", "/api/v1/models/2/reject", admin, json={"reason": "test"})
        await call("POST", "/api/v1/models/rollout/gnn/rollback", admin, json={"reason": "test"})
        await call("GET", "/api/v1/models/rollout/gnn", admin)
        await call("DELETE", "/api/v1/models/2", admin)
        await call("DELETE", "/api/v1/models/2", admin)
        await call("POST", "/api/v1/jobs", admin, json={"type": "preheat", "args": {"type": "file", "url": origin_url}})
        await call("POST", "/api/v1/jobs", admin, json={"type": "sync", "args": {}})
        await call("POST", "/api/v1/jobs", admin, json={"type": "preheat", "args": {"type": "weird", "url": "x"}})
        await call("GET", "/api/v1/jobs/1", admin)
        await call("GET", "/api/v1/jobs/99", admin)
        provider = {"name": "hub", "client_id": "cid", "client_secret": "s", "auth_url": "http://i/a",
                    "token_url": "http://i/t", "scopes": ["read"]}
        await call("POST", "/api/v1/oauth", admin, json=provider)
        await call("POST", "/api/v1/oauth", admin, json={**provider, "name": ""})
        await call("POST", "/api/v1/oauth", admin, json={**provider, "name": "x", "scopes": "read"})
        await call("GET", "/api/v1/oauth", admin)
        await call("PATCH", "/api/v1/oauth/1", admin, json={"scopes": ["read", "write"]})
        await call("GET", "/api/v1/oauth/1", admin)
        await call("GET", "/api/v1/users/signin/oauth/hub")
        await call("GET", "/api/v1/users/signin/oauth/nope")
        await call("GET", "/api/v1/users/signin/oauth/hub/callback?code=c&state=bad")
        await call("DELETE", "/api/v1/oauth/1", admin)
        await call("GET", "/api/v1/buckets", admin)
        await call("POST", "/api/v1/buckets", admin, json={"name": "models"})
        await call("POST", "/api/v1/buckets", admin, json={"name": "models"})
        await call("GET", "/api/v1/buckets/models", admin)
        await call("DELETE", "/api/v1/buckets/models", admin)
        await call("DELETE", "/api/v1/buckets/models", admin)
        viewer = (await call("POST", "/api/v1/users/signin", json={"name": "viewer", "password": "view-pw"}))["token"]
        await call("GET", "/api/v1/schedulers", viewer)
        for path in ("/api/v1/applications", "/api/v1/certificates", "/api/v1/users", "/api/v1/jobs"):
            await call("POST", path, viewer, json={"name": "evil"})
        await call("GET", "/api/v1/users", viewer)
        await call("GET", "/api/v1/models", "not.a.token")
    return out


def test_one_sequence_gets_equal_answers_from_both_rest_fronts(tmp_path):
    got = {}
    for pkg, server_cls in SERVER.items():
        async def body():
            server = server_cls(db_path=str(tmp_path / f"{pkg}.db"), rest_port=0, auth_secret="top-secret",
                                admin_password="adminpw", ca_dir=str(tmp_path / f"{pkg}-ca"),
                                object_storage_dir=str(tmp_path / f"{pkg}-objects"))
            await server.start()
            try:
                return await _sequence(f"http://127.0.0.1:{server.rest_port}", "http://127.0.0.1:9/f.bin")
            finally:
                await server.stop()

        got[pkg] = run(body())
    assert got["port"] == got["ref"]
    statuses = [s for _m, _p, s, _b in got["port"]]
    assert statuses.count(401) >= 4 and statuses.count(403) >= 5 and 201 in statuses and 503 not in statuses


# ---------------------------------------------------------------------------
# auth and RBAC


@pytest.mark.parametrize("signer", ["port", "ref"])
def test_auth_and_rbac_flow(tmp_path, signer):
    async def body():
        db = Database(":memory:")
        svc = ManagerService(db)
        svc.create_user("admin", "hunter2", role="admin")
        svc.create_user("viewer", "viewpass", role="guest")
        runner, port = await port_rest.start_rest(svc, JobQueue(db), auth_secret="top-secret",
                                                  ca=CertificateAuthority(tmp_path / "ca"))
        base = f"http://127.0.0.1:{port}"
        seen = []
        try:
            async with aiohttp.ClientSession() as s:
                async def status(method, path, token=None, **kw):
                    headers = {"Authorization": f"Bearer {token}"} if token else {}
                    async with s.request(method, base + path, headers=headers, **kw) as r:
                        seen.append(r.status)
                        return await r.json(content_type=None)

                await status("GET", "/healthz")
                await status("GET", "/api/v1/schedulers")
                await status("POST", "/api/v1/users/signin", json={"name": "admin", "password": "wrong"})
                token = (await status("POST", "/api/v1/users/signin",
                                      json={"name": "admin", "password": "hunter2"}))["token"]
                claims = TOKENS["ref"].verify_token(token, "top-secret")  # the reference reads the port's
                assert claims["sub"] == "admin" and claims["role"] == "admin"
                admin = TOKENS[signer].sign_token({"sub": "admin", "role": "admin"}, "top-secret")
                guest = TOKENS[signer].sign_token({"sub": "viewer", "role": "guest"}, "top-secret")
                forged = TOKENS[signer].sign_token({"sub": "admin", "role": "admin"}, "other-secret")
                await status("GET", "/api/v1/schedulers", admin)
                cert = await status("POST", "/api/v1/certificates", admin, json={"name": "svc", "sans": ["127.0.0.1"]})
                assert "BEGIN CERTIFICATE" in cert["cert_pem"]
                await status("GET", "/api/v1/schedulers", guest)
                await status("POST", "/api/v1/applications", guest, json={"name": "x"})
                await status("POST", "/api/v1/certificates", guest, json={"name": "evil"})
                await status("GET", "/api/v1/schedulers", forged)
        finally:
            await runner.cleanup()
        return seen

    assert run(body()) == [200, 401, 401, 200, 200, 201, 200, 403, 403, 401]


# ---------------------------------------------------------------------------
# OAuth


class FakeOauthProvider:
    """An OAuth2 authorization server in process: token and userinfo."""

    def __init__(self):
        self.codes = {"good-code": {"login": "octo", "email": "octo@example.com"}}
        self.token_requests: list = []
        self.port = 0
        self._runner = None

    async def __aenter__(self):
        app = web.Application()
        app.router.add_post("/token", self._token)
        app.router.add_get("/user", self._user)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        await self._runner.cleanup()

    async def _token(self, req):
        form = await req.post()
        self.token_requests.append(dict(form))
        if form.get("code") not in self.codes or form.get("client_secret") != "s3kr1t":
            return web.json_response({"error": "invalid_grant"}, status=400)
        return web.json_response({"access_token": "at-" + form["code"], "token_type": "bearer"})

    async def _user(self, req):
        code = req.headers.get("Authorization", "").removeprefix("Bearer at-")
        if code not in self.codes:
            return web.json_response({"error": "bad token"}, status=401)
        return web.json_response(self.codes[code])


def test_oauth_code_flow(tmp_path):
    async def body():
        server = ManagerServer(db_path=str(tmp_path / "m.db"), rest_port=0, auth_secret="secret",
                               admin_password="adminpw")
        await server.start()
        try:
            async with FakeOauthProvider() as idp, aiohttp.ClientSession() as s:
                base = f"http://127.0.0.1:{server.rest_port}"
                async with s.post(f"{base}/api/v1/users/signin", json={"name": "admin", "password": "adminpw"}) as r:
                    auth = {"Authorization": f"Bearer {(await r.json())['token']}"}
                provider = {"name": "fakehub", "client_id": "cid", "client_secret": "s3kr1t",
                            "auth_url": f"http://127.0.0.1:{idp.port}/authorize",
                            "token_url": f"http://127.0.0.1:{idp.port}/token",
                            "user_info_url": f"http://127.0.0.1:{idp.port}/user", "scopes": ["read:user"]}
                async with s.post(f"{base}/api/v1/oauth", json=provider, headers=auth) as r:
                    assert r.status == 201
                    assert "client_secret" not in await r.json()
                async with s.get(f"{base}/api/v1/oauth") as r:
                    assert r.status == 401

                async def fresh_state() -> str:
                    async with s.get(f"{base}/api/v1/users/signin/oauth/fakehub", allow_redirects=False) as r:
                        assert r.status == 302
                        loc = r.headers["Location"]
                        assert loc.startswith(f"http://127.0.0.1:{idp.port}/authorize?") and "client_id=cid" in loc
                        return parse_qs(urlsplit(loc).query)["state"][0]

                async def callback(code: str, state: str):
                    async with s.get(f"{base}/api/v1/users/signin/oauth/fakehub/callback",
                                     params={"code": code, "state": state}) as r:
                        return r.status, await r.json()

                state = await fresh_state()
                status, out = await callback("good-code", state)
                assert status == 200 and out["user"]["name"] == "fakehub/octo"
                claims = port_tokens.verify_token(out["token"], "secret")
                assert claims == {**claims, "sub": "fakehub/octo", "role": "guest"}
                assert idp.token_requests[0]["grant_type"] == "authorization_code"
                assert (await callback("good-code", state))[0] == 401  # single use
                assert (await callback("good-code", "bad.0.bad"))[0] == 401  # forged
                assert (await callback("wrong", await fresh_state()))[0] == 502  # the provider refuses
        finally:
            await server.stop()

    run(body())


# ---------------------------------------------------------------------------
# buckets and the console


@pytest.mark.parametrize("configured", [True, False])
def test_bucket_crud_and_503_without_a_store(tmp_path, configured):
    async def body():
        kw = {"object_storage_dir": str(tmp_path / "objects")} if configured else {}
        server = ManagerServer(db_path=str(tmp_path / "m.db"), rest_port=0, **kw)
        await server.start()
        seen = []
        try:
            async with aiohttp.ClientSession() as s:
                base = f"http://127.0.0.1:{server.rest_port}"
                for method, path, body_ in (("GET", "/api/v1/buckets", None),
                                            ("POST", "/api/v1/buckets", {"name": "models"}),
                                            ("POST", "/api/v1/buckets", {"name": "models"}),
                                            ("POST", "/api/v1/buckets", {}),
                                            ("GET", "/api/v1/buckets", None),
                                            ("GET", "/api/v1/buckets/models", None),
                                            ("GET", "/api/v1/buckets/nope", None),
                                            ("DELETE", "/api/v1/buckets/models", None),
                                            ("DELETE", "/api/v1/buckets/models", None)):
                    async with s.request(method, base + path, json=body_) as r:
                        seen.append((r.status, await r.json()))
        finally:
            await server.stop()
        return seen

    seen = run(body())
    if not configured:
        assert {s for s, _ in seen} == {503}
        return
    assert [s for s, _ in seen] == [200, 201, 409, 400, 200, 200, 404, 200, 404]
    assert seen[0][1] == [] and [b["name"] for b in seen[4][1]] == ["models"]


def test_the_console_is_served_at_root(tmp_path):
    async def body():
        server = ManagerServer(db_path=str(tmp_path / "m.db"), rest_port=0, auth_secret="s")
        await server.start()
        try:
            async with aiohttp.ClientSession() as s:
                base = f"http://127.0.0.1:{server.rest_port}"
                async with s.get(f"{base}/") as r:
                    page = (r.status, r.content_type, await r.text())
                async with s.get(f"{base}/api/v1/schedulers") as r:
                    gated = r.status
        finally:
            await server.stop()
        return page, gated

    (status, ctype, page), gated = run(body())
    from dragonfly2_tpu.manager.console import CONSOLE_HTML

    assert (status, ctype, gated) == (200, "text/html", 401)
    assert page == CONSOLE_HTML and "/api/v1/schedulers" in page


# ---------------------------------------------------------------------------
# preheat


@pytest.mark.parametrize("kind", ["file", "image", "image-index"])
def test_preheat_resolves_what_the_reference_resolves(kind):
    """A preheat job's URLs through each package's REST front, against the
    fake registry (an image manifest's layers; an index recursed once)."""
    async def body():
        registry = FakeRegistry(require_auth=False)
        registry.push("library/app", "v1", b"layer-one" * 100)
        registry.push("library/app", "v2", b"layer-two" * 100)
        if kind == "image-index":
            registry.manifests[("library/app", "multi")] = {
                "mediaType": "application/vnd.oci.image.index.v1+json",
                "manifests": [{"digest": "v1"}, {"digest": "v2"}]}
        await registry.start()
        base = f"http://127.0.0.1:{registry.port}"
        url = {"file": f"{base}/f.bin", "image": f"{base}/v2/library/app/manifests/v1",
               "image-index": f"{base}/v2/library/app/manifests/multi"}[kind]
        jobs = {}
        try:
            for pkg, (mod, db_cls, svc_cls, queue_cls) in {
                "port": (port_rest, Database, ManagerService, JobQueue),
                "ref": (ref_rest, RefDatabase, RefManagerService, RefJobQueue),
            }.items():
                db = db_cls(":memory:")
                runner, port = await mod.start_rest(svc_cls(db), queue_cls(db))
                try:
                    async with aiohttp.ClientSession() as s:
                        async with s.post(f"http://127.0.0.1:{port}/api/v1/jobs", json={
                                "type": "preheat", "args": {"type": kind.split("-")[0], "url": url}}) as r:
                            assert r.status == 201, await r.text()
                            jobs[pkg] = mask(await r.json())
                finally:
                    await runner.cleanup()
        finally:
            await registry.stop()
        return jobs, base

    jobs, base = run(body())
    assert jobs["port"] == jobs["ref"]
    urls = jobs["port"]["args"]["urls"]
    if kind == "file":
        assert urls == [f"{base}/f.bin"]
    else:
        digests = [hashlib.sha256(p * 100).hexdigest() for p in (b"layer-one", b"layer-two")]
        want = [f"{base}/v2/library/app/blobs/sha256:{d}" for d in digests]
        assert urls == (want if kind == "image-index" else want[:1])


def test_a_preheat_job_through_the_ports_rest_scheduler_and_seed_daemon(tmp_path):
    from dragonfly2_tpu_torch.daemon.engine import InProcessSchedulerClient, PeerEngine
    from dragonfly2_tpu_torch.daemon.server import DAEMON_METHODS, DaemonRpcAdapter
    from dragonfly2_tpu_torch.rpc.core import RpcServer
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient
    from dragonfly2_tpu_torch.scheduler.manager_link import ManagerLink
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService

    payload = b"preheat-me" * 50_000

    async def body():
        async with Origin({"layer.bin": payload}) as origin:
            manager = ManagerServer(db_path=str(tmp_path / "m.db"), rest_port=0)
            await manager.start()
            svc = SchedulerService()
            seed = PeerEngine(storage_root=tmp_path / "seed", scheduler=InProcessSchedulerClient(svc),
                              hostname="seed1", host_type="seed")
            await seed.start()
            seed_rpc = RpcServer(host="127.0.0.1", port=0)
            seed_rpc.register_service(DaemonRpcAdapter(seed), DAEMON_METHODS)
            await seed_rpc.start()
            seed.rpc_port = seed_rpc.port
            mc = RemoteManagerClient(manager.address)
            await mc.update_seed_peer("seed1", "127.0.0.1", seed.rpc_port, download_port=seed.upload.port)
            link = ManagerLink(svc, manager.address, hostname="sch1", ip="127.0.0.1", port=9000,
                               keepalive_interval=0.2)
            await link.start()
            try:
                assert link.seed_connector.address_book[0]["hostname"] == "seed1"
                async with aiohttp.ClientSession() as s:
                    base = f"http://127.0.0.1:{manager.rest_port}"
                    async with s.post(f"{base}/api/v1/jobs", json={
                            "type": "preheat", "args": {"type": "file", "url": origin.url("layer.bin")},
                            "scheduler_cluster_ids": [link.cluster_id]}) as r:
                        assert r.status == 201
                        job = await r.json()
                    for _ in range(600):
                        async with s.get(f"{base}/api/v1/jobs/{job['id']}") as r:
                            st = await r.json()
                        if st["state"] in ("SUCCESS", "FAILURE"):
                            break
                        await asyncio.sleep(0.1)
                (ts,) = seed.storage.tasks()
                return st, ts.meta.done, ts.read_all() if hasattr(ts, "read_all") else None, origin.bytes_sent
            finally:
                await mc.close()
                await link.stop()
                await seed_rpc.stop()
                await seed.stop()
                await manager.stop()

    st, done, _data, sent = run(body())
    assert st["state"] == "SUCCESS", st
    assert st["result"]["items"][0]["preheated"] == 1
    assert done and sent == len(payload)
