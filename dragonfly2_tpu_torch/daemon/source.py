"""Back-to-source clients, registered per URL scheme: the port of
dragonfly2_tpu/daemon/source.py.

Parity with reference pkg/source (source_client.go:102-137 ResourceClient:
GetContentLength / IsSupportRange / Download / GetLastModified, plus the
scheme registry and clients/{http,s3,oss,hdfs,oras}). Here: http(s) via
aiohttp, file:// for local staging + tests, and s3:// over the SigV4 client
(any S3-dialect endpoint — which is how OSS/OBS are reached too, via their
S3-compatibility modes). All clients support URL-entry listing where the
protocol can enumerate (HTML auto-index, directory scan, ListObjectsV2),
feeding dfget --recursive.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import AsyncIterator
from urllib.parse import urlsplit

import aiohttp

from dragonfly2_tpu_torch.resilience import faultline
from dragonfly2_tpu_torch.utils.pieces import Range


class SourceError(Exception):
    pass


@dataclass
class SourceInfo:
    content_length: int  # -1 when unknown
    supports_range: bool
    last_modified: str = ""
    etag: str = ""


@dataclass
class URLEntry:
    """One child of a listable URL (ref pkg/source source_client.go:129-137
    URLEntry): used by recursive download. `name` is the final path element
    only; `is_dir` entries are re-listed, files are downloaded."""

    url: str
    name: str
    is_dir: bool


class ResourceClient:
    scheme: str = ""

    async def info(self, url: str, headers: dict | None = None) -> SourceInfo:
        raise NotImplementedError

    async def download(
        self, url: str, rng: Range | None = None, headers: dict | None = None
    ) -> AsyncIterator[bytes]:
        raise NotImplementedError
        yield b""  # pragma: no cover

    async def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        """Children of a directory-like URL (ref source.List). Clients that
        cannot enumerate raise SourceError."""
        raise SourceError(f"scheme does not support listing: {url}")

    async def close(self) -> None:
        pass


class HTTPSourceClient(ResourceClient):
    scheme = "http"

    def __init__(
        self, *, chunk_size: int = 1 << 20, timeout: float = 300.0, ssl_context=None
    ):
        self.chunk_size = chunk_size
        self._timeout = aiohttp.ClientTimeout(total=timeout)
        self._ssl = ssl_context  # e.g. cluster-CA trust for private https origins
        self._session: aiohttp.ClientSession | None = None

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            connector = aiohttp.TCPConnector(ssl=self._ssl) if self._ssl is not None else None
            self._session = aiohttp.ClientSession(timeout=self._timeout, connector=connector)
        return self._session

    async def info(self, url: str, headers: dict | None = None) -> SourceInfo:
        async with self._sess().head(url, headers=headers or {}, allow_redirects=True) as resp:
            if resp.status >= 400:
                # some origins reject HEAD; probe with a 1-byte range GET
                return await self._info_via_get(url, headers)
            length = int(resp.headers.get("Content-Length", -1))
            return SourceInfo(
                content_length=length,
                supports_range=resp.headers.get("Accept-Ranges", "").lower() == "bytes",
                last_modified=resp.headers.get("Last-Modified", ""),
                etag=resp.headers.get("ETag", ""),
            )

    async def _info_via_get(self, url: str, headers: dict | None) -> SourceInfo:
        h = dict(headers or {})
        h["Range"] = "bytes=0-0"
        async with self._sess().get(url, headers=h, allow_redirects=True) as resp:
            if resp.status == 206:
                cr = resp.headers.get("Content-Range", "")  # bytes 0-0/N
                total = int(cr.rsplit("/", 1)[1]) if "/" in cr else -1
                return SourceInfo(content_length=total, supports_range=True)
            if resp.status < 400:
                return SourceInfo(
                    content_length=int(resp.headers.get("Content-Length", -1)),
                    supports_range=False,
                )
            raise SourceError(f"origin {url}: HTTP {resp.status}")

    async def download(
        self, url: str, rng: Range | None = None, headers: dict | None = None
    ) -> AsyncIterator[bytes]:
        h = dict(headers or {})
        if rng is not None:
            h["Range"] = rng.header()
        async with self._sess().get(url, headers=h, allow_redirects=True) as resp:
            if resp.status >= 400:
                raise SourceError(f"origin {url}: HTTP {resp.status}")
            if rng is not None and resp.status != 206:
                raise SourceError(f"origin {url}: range not honored (HTTP {resp.status})")
            async for chunk in resp.content.iter_chunked(self.chunk_size):
                yield chunk

    async def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        """Parse an HTML auto-index page (nginx autoindex / python http.server
        style): every <a href> that resolves to a strict child of this URL is
        an entry; a trailing slash marks a directory."""
        import html as _html
        import re as _re
        from urllib.parse import unquote, urljoin

        req_base = url if url.endswith("/") else url + "/"
        async with self._sess().get(
            req_base, headers=headers or {}, allow_redirects=True
        ) as resp:
            if resp.status >= 400:
                raise SourceError(f"listing {url}: HTTP {resp.status}")
            ctype = resp.headers.get("Content-Type", "")
            if "html" not in ctype:
                raise SourceError(f"listing {url}: not an index page ({ctype})")
            # resolve hrefs against where the index actually lives (the
            # request may have been redirected, e.g. /dir -> /dir/ or a
            # versioned path)
            base = str(resp.url)
            if not base.endswith("/"):
                base += "/"
            page = await resp.text()
        entries: list[URLEntry] = []
        seen: set[str] = set()
        for href in _re.findall(r'<a\s[^>]*href="([^"]+)"', page, _re.IGNORECASE):
            href = _html.unescape(href)
            child = urljoin(base, href)
            if not child.startswith(base) or child == base:
                continue  # parent links, absolute escapes, sort links
            rel = child[len(base):]
            if "?" in rel or "#" in rel:
                continue
            is_dir = rel.endswith("/")
            rel = rel.rstrip("/")
            if "/" in rel or not rel:
                continue  # only immediate children; deeper levels via recursion
            name = unquote(rel)
            # a hostile index can smuggle separators/.. through percent
            # encoding (..%2F..) — the decoded NAME joins local paths, so it
            # must be a single clean path element or the mirror writes
            # outside --output
            if not name or name in (".", "..") or "/" in name or "\\" in name:
                continue
            if name in seen:
                continue
            seen.add(name)
            entries.append(URLEntry(url=child, name=name, is_dir=is_dir))
        return entries

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()


class FileSourceClient(ResourceClient):
    """file:// origin — local staging for checkpoint fan-out and tests."""

    scheme = "file"

    def __init__(self, *, chunk_size: int = 1 << 20):
        self.chunk_size = chunk_size

    @staticmethod
    def _path(url: str) -> Path:
        parts = urlsplit(url)
        return Path(parts.path)

    async def info(self, url: str, headers: dict | None = None) -> SourceInfo:
        p = self._path(url)
        if not p.is_file():
            raise SourceError(f"no such file: {p}")
        return SourceInfo(content_length=p.stat().st_size, supports_range=True)

    async def download(
        self, url: str, rng: Range | None = None, headers: dict | None = None
    ) -> AsyncIterator[bytes]:
        p = self._path(url)
        if not p.is_file():
            raise SourceError(f"no such file: {p}")
        with open(p, "rb") as f:
            if rng is not None:
                f.seek(rng.start)
                remaining = rng.length
            else:
                remaining = p.stat().st_size
            while remaining > 0:
                chunk = f.read(min(self.chunk_size, remaining))
                if not chunk:
                    raise SourceError(f"short read from {p}")
                remaining -= len(chunk)
                yield chunk

    async def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        p = self._path(url)
        if not p.is_dir():
            raise SourceError(f"not a directory: {p}")
        entries = []
        for child in sorted(p.iterdir()):
            is_dir = child.is_dir()
            entries.append(
                URLEntry(
                    url=f"file://{child}" + ("/" if is_dir else ""),
                    name=child.name,
                    is_dir=is_dir,
                )
            )
        return entries


class S3SourceClient(ResourceClient):
    """s3://bucket/key origins (ref pkg/source/clients/s3protocol): signed
    HeadObject/ranged GetObject against any S3-dialect endpoint, plus
    delimiter-based listing so s3:// trees work with recursive download.
    Credentials/endpoint come from the environment (AWS_ENDPOINT_URL,
    AWS_ACCESS_KEY_ID, AWS_SECRET_ACCESS_KEY, AWS_REGION) unless a
    pre-built client is injected."""

    scheme = "s3"

    def __init__(self, client=None):
        self._client = client  # lazily built from env on first use

    def _c(self):
        if self._client is None:
            from dragonfly2_tpu_torch.objectstorage.s3client import S3Client, S3Config

            self._client = S3Client(S3Config.from_env())
        return self._client

    def _split(self, url: str) -> tuple[str, str]:
        parts = urlsplit(url)
        bucket, key = parts.netloc, parts.path.lstrip("/")
        if not bucket:
            raise SourceError(f"bad {self.scheme} url (no bucket): {url}")
        return bucket, key

    async def info(self, url: str, headers: dict | None = None) -> SourceInfo:
        from dragonfly2_tpu_torch.objectstorage.s3client import S3Error

        bucket, key = self._split(url)
        try:
            obj = await self._c().head_object(bucket, key)
        except S3Error as e:
            raise SourceError(f"{self.scheme} head {url}: {e}") from e
        return SourceInfo(
            content_length=obj.size, supports_range=True,
            last_modified=obj.last_modified, etag=obj.etag,
        )

    async def download(
        self, url: str, rng: Range | None = None, headers: dict | None = None
    ) -> AsyncIterator[bytes]:
        from dragonfly2_tpu_torch.objectstorage.s3client import S3Error

        bucket, key = self._split(url)
        try:
            async for chunk in self._c().get_object(
                bucket, key, range_header=rng.header() if rng is not None else ""
            ):
                yield chunk
        except S3Error as e:
            raise SourceError(f"{self.scheme} get {url}: {e}") from e

    async def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        from dragonfly2_tpu_torch.objectstorage.s3client import S3Error

        bucket, prefix = self._split(url)
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        try:
            res = await self._c().list_objects(bucket, prefix=prefix, delimiter="/")
        except S3Error as e:
            raise SourceError(f"{self.scheme} list {url}: {e}") from e
        entries: list[URLEntry] = []
        for o in res.objects:
            name = o.key[len(prefix):]
            if not name or name in (".", "..") or "/" in name or "\\" in name:
                continue
            entries.append(
                URLEntry(url=f"{self.scheme}://{bucket}/{o.key}", name=name, is_dir=False)
            )
        for p in res.common_prefixes:
            name = p[len(prefix):].rstrip("/")
            if not name or name in (".", "..") or "/" in name or "\\" in name:
                continue
            entries.append(
                URLEntry(url=f"{self.scheme}://{bucket}/{p}", name=name, is_dir=True)
            )
        return entries

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()


class OSSSourceClient(S3SourceClient):
    """oss://bucket/key origins (ref pkg/source/clients/ossprotocol, 389 LoC).

    Aliyun OSS speaks an S3-compatible dialect; the hand-rolled SigV4 client
    covers it, so this is the s3 client bound to OSS_* credentials
    (OSS_ENDPOINT, OSS_ACCESS_KEY_ID, OSS_ACCESS_KEY_SECRET, OSS_REGION) —
    the same dialect-reuse the reference gets from aws-sdk-go pointed at an
    OSS endpoint. URLs keep their oss:// scheme in task ids and rewrites."""

    scheme = "oss"

    def _c(self):
        if self._client is None:
            from dragonfly2_tpu_torch.objectstorage.s3client import S3Client, S3Config

            e = os.environ
            endpoint = e.get("OSS_ENDPOINT", "")
            if not endpoint:
                raise SourceError("no OSS endpoint configured (OSS_ENDPOINT)")
            self._client = S3Client(
                S3Config(
                    endpoint=endpoint,
                    access_key=e.get("OSS_ACCESS_KEY_ID", ""),
                    secret_key=e.get("OSS_ACCESS_KEY_SECRET", ""),
                    region=e.get("OSS_REGION", "us-east-1"),
                )
            )
        return self._client


class SourceRegistry:
    """Scheme -> client registry (ref pkg/source register/loader)."""

    def __init__(self, *, http_ssl=None) -> None:
        from dragonfly2_tpu_torch.daemon.hdfs_source import HDFSSourceClient
        from dragonfly2_tpu_torch.daemon.oras_source import ORASSourceClient

        self._clients: dict[str, ResourceClient] = {}
        http = HTTPSourceClient(ssl_context=http_ssl)
        self.register("http", http)
        self.register("https", http)
        self.register("file", FileSourceClient())
        self.register("s3", S3SourceClient())
        self.register("oss", OSSSourceClient())
        self.register("oras", ORASSourceClient())
        self.register("hdfs", HDFSSourceClient())
        self._register_plugins()

    def _register_plugins(self) -> None:
        """External protocol clients by import path (ref pkg/source/loader +
        internal/dfplugin): DRAGONFLY_SOURCE_PLUGINS="scheme=pkg.mod:factory,…"
        — each factory yields a ResourceClient for its scheme. A bad spec
        fails the daemon at boot, not on first download."""
        raw = os.environ.get("DRAGONFLY_SOURCE_PLUGINS", "")
        if not raw:
            return
        from dragonfly2_tpu_torch.utils.plugins import load_object, parse_plugin_map, require_methods

        for scheme, spec in parse_plugin_map(raw).items():
            client = load_object(spec)
            require_methods(client, ("info", "download", "close"), spec=spec, kind="source")
            # urlsplit lowercases schemes, so the registry key must match
            self.register(scheme.lower(), client)

    def register(self, scheme: str, client: ResourceClient) -> None:
        self._clients[scheme] = client

    def client_for(self, url: str) -> ResourceClient:
        scheme = urlsplit(url).scheme or "file"
        client = self._clients.get(scheme)
        if client is None:
            raise SourceError(f"unsupported url scheme: {scheme!r} ({url})")
        return client

    async def info(self, url: str, headers: dict | None = None) -> SourceInfo:
        return await self.client_for(url).info(url, headers)

    async def download(
        self, url: str, rng: Range | None = None, headers: dict | None = None
    ) -> AsyncIterator[bytes]:
        # Faultline rides the registry (one seam covers every scheme client).
        # Exactly TWO rng decisions per stream — `source.read` (latency/error/
        # drop) at open, `source.body` (truncate/corrupt) on the first chunk —
        # so injection probability is per-READ, independent of how the
        # transport happens to chunk the body (per-chunk draws would compound
        # a small rate into near-certain failure on a 64-chunk piece).
        # Disabled cost: one module-global is-None check.
        if faultline.ACTIVE is None:
            async for chunk in self.client_for(url).download(url, rng, headers):
                yield chunk
            return
        await faultline.ACTIVE.fire("source.read")
        first = True
        async for chunk in self.client_for(url).download(url, rng, headers):
            if first:
                first = False
                mutated = faultline.ACTIVE.mutate("source.body", chunk)
                if len(mutated) != len(chunk):  # truncated: short body, then EOF
                    if mutated:
                        yield mutated
                    return
                chunk = mutated
            yield chunk

    async def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        client = self.client_for(url)
        lister = getattr(client, "list_entries", None)
        if lister is None:  # duck-typed plugin without listing support
            raise SourceError(f"scheme does not support listing: {url}")
        return await lister(url, headers)

    async def close(self) -> None:
        seen = set()
        for c in self._clients.values():
            if id(c) not in seen:
                seen.add(id(c))
                await c.close()
