"""oras:// (OCI registry) source client: the port of
dragonfly2_tpu/daemon/oras_source.py.

Parity with reference pkg/source/clients/orasprotocol/oras_source_client.go
(362 LoC): resolve ``oras://host[:port]/repo[:tag]`` through the OCI
distribution API — manifest fetch with the bearer-token dance → first layer
digest → ranged blob download. This completes image acceleration end-to-end:
the proxy's registry mirror accelerates image pulls, the preheat job warms
layers, and this client gives back-to-source peers a direct OCI origin for
oras-pushed artifacts (models, configs) without an HTTP gateway in front.

Protocol notes (OCI distribution spec):
  * GET /v2/<repo>/manifests/<tag>  with OCI/Docker manifest Accept headers;
    401 responses carry ``WWW-Authenticate: Bearer realm=…,service=…,scope=…``
    → fetch a token from the realm (anonymous, or Basic from
    DF_ORAS_USERNAME / DF_ORAS_PASSWORD), retry once with it.
  * blobs are content-addressed: GET /v2/<repo>/blobs/<digest> supports
    Range, so the piece engine's concurrent ranged download works unchanged.

Registries default to https; DF_ORAS_PLAIN_HTTP lists hosts (comma-separated,
or "*" for all) reachable over plain http — test fixtures and in-cluster
registries.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass
from typing import AsyncIterator, Optional
from urllib.parse import urlsplit

import aiohttp

from dragonfly2_tpu_torch.daemon.source import ResourceClient, SourceError, SourceInfo
from dragonfly2_tpu_torch.utils.pieces import Range

_MANIFEST_ACCEPT = ", ".join(
    (
        "application/vnd.oci.image.manifest.v1+json",
        "application/vnd.docker.distribution.manifest.v2+json",
    )
)
_RESOLVE_TTL_S = 300.0  # tags move; content-addressed blobs don't


def parse_auth_challenge(fields_s: str) -> dict[str, str]:
    """Quote-aware WWW-Authenticate auth-param parse (RFC 7235 grammar): a
    naive comma split mangles quoted values containing commas — Docker Hub
    and Harbor emit scope="repository:a:pull,push"."""
    return {
        (m.group(1) or m.group(3)).lower(): (m.group(2) if m.group(1) else m.group(4))
        for m in re.finditer(r'(\w+)="([^"]*)"|(\w+)=([^",\s]+)', fields_s)
    }


@dataclass
class _Resolved:
    digest: str
    size: int
    at: float


class ORASSourceClient(ResourceClient):
    scheme = "oras"

    def __init__(self, *, timeout: float = 300.0, chunk_size: int = 1 << 20):
        self.chunk_size = chunk_size
        self._timeout = aiohttp.ClientTimeout(total=timeout)
        self._session: Optional[aiohttp.ClientSession] = None
        self._tokens: dict[tuple[str, str], str] = {}  # (host, repo) -> bearer
        self._resolved: dict[str, _Resolved] = {}

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(timeout=self._timeout)
        return self._session

    # ---- url handling ----

    @staticmethod
    def parse(url: str) -> tuple[str, str, str]:
        """oras://host[:port]/repo[/sub…][:tag] → (host, repo, tag)."""
        parts = urlsplit(url)
        host = parts.netloc
        path = parts.path.strip("/")
        if not host or not path:
            raise SourceError(f"bad oras url (need host/repo): {url}")
        tag = "latest"
        head, sep, last = path.rpartition("/")
        if ":" in last:
            last, _, tag = last.partition(":")
            if not tag:
                raise SourceError(f"bad oras url (empty tag): {url}")
        repo = f"{head}/{last}" if sep else last
        return host, repo, tag

    @staticmethod
    def _base(host: str) -> str:
        plain = os.environ.get("DF_ORAS_PLAIN_HTTP", "")
        hosts = {h.strip() for h in plain.split(",") if h.strip()}
        if "*" in hosts or host in hosts or host.split(":")[0] in hosts:
            return f"http://{host}"
        return f"https://{host}"

    # ---- auth (bearer-token dance) ----

    async def _fetch_token(self, www_auth: str, repo: str) -> str:
        kind, _, fields_s = www_auth.partition(" ")
        if kind.lower() != "bearer":
            raise SourceError(f"unsupported registry auth scheme: {kind}")
        fields = parse_auth_challenge(fields_s)
        realm = fields.get("realm")
        if not realm:
            raise SourceError(f"registry auth challenge missing realm: {www_auth}")
        params = {}
        if fields.get("service"):
            params["service"] = fields["service"]
        params["scope"] = fields.get("scope") or f"repository:{repo}:pull"
        auth = None
        user = os.environ.get("DF_ORAS_USERNAME", "")
        if user:
            auth = aiohttp.BasicAuth(user, os.environ.get("DF_ORAS_PASSWORD", ""))
        async with self._sess().get(realm, params=params, auth=auth) as resp:
            if resp.status >= 400:
                raise SourceError(f"registry token fetch failed: HTTP {resp.status}")
            body = await resp.json(content_type=None)
        token = body.get("token") or body.get("access_token") or ""
        if not token:
            raise SourceError("registry token response had no token")
        return token

    async def _get(self, host: str, repo: str, path: str, headers: dict) -> aiohttp.ClientResponse:
        """GET with one 401-driven token retry. Caller closes the response."""
        url = f"{self._base(host)}{path}"
        h = dict(headers)
        token = self._tokens.get((host, repo))
        if token:
            h["Authorization"] = f"Bearer {token}"
        resp = await self._sess().get(url, headers=h)
        if resp.status == 401:
            challenge = resp.headers.get("WWW-Authenticate", "")
            resp.close()
            token = await self._fetch_token(challenge, repo)
            self._tokens[(host, repo)] = token
            h["Authorization"] = f"Bearer {token}"
            resp = await self._sess().get(url, headers=h)
        if resp.status >= 400:
            status = resp.status
            resp.close()
            raise SourceError(f"oras {host}/{repo}{path}: HTTP {status}")
        return resp

    # ---- manifest resolution ----

    async def _resolve(self, url: str, headers: dict | None) -> _Resolved:
        cached = self._resolved.get(url)
        if cached is not None and time.monotonic() - cached.at < _RESOLVE_TTL_S:
            return cached
        host, repo, tag = self.parse(url)
        resp = await self._get(
            host, repo, f"/v2/{repo}/manifests/{tag}",
            {**(headers or {}), "Accept": _MANIFEST_ACCEPT},
        )
        try:
            manifest = json.loads(await resp.read())
        finally:
            resp.close()
        layers = manifest.get("layers") or []
        if not layers:
            raise SourceError(f"oras manifest for {url} has no layers")
        # oras artifacts are single-layer; for multi-layer manifests the
        # FIRST layer is the artifact payload (ref oras_source_client.go
        # fetches layers[0] the same way)
        layer = layers[0]
        digest = layer.get("digest", "")
        if not digest.startswith("sha256:"):
            raise SourceError(f"oras layer digest unsupported: {digest!r}")
        res = _Resolved(digest=digest, size=int(layer.get("size", -1)), at=time.monotonic())
        if len(self._resolved) > 256:
            self._resolved.clear()  # tiny cache; drop instead of LRU bookkeeping
        self._resolved[url] = res
        return res

    # ---- ResourceClient surface ----

    async def info(self, url: str, headers: dict | None = None) -> SourceInfo:
        res = await self._resolve(url, headers)
        return SourceInfo(content_length=res.size, supports_range=True, etag=res.digest)

    async def download(
        self, url: str, rng: Range | None = None, headers: dict | None = None
    ) -> AsyncIterator[bytes]:
        res = await self._resolve(url, headers)
        host, repo, _tag = self.parse(url)
        h = dict(headers or {})
        if rng is not None:
            h["Range"] = rng.header()
        resp = await self._get(host, repo, f"/v2/{repo}/blobs/{res.digest}", h)
        try:
            if rng is not None and resp.status != 206:
                raise SourceError(f"oras blob {res.digest[:19]}: no range support (HTTP {resp.status})")
            async for chunk in resp.content.iter_chunked(self.chunk_size):
                yield chunk
        finally:
            resp.close()

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
