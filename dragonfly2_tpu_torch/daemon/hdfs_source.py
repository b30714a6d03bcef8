"""hdfs:// source client over the WebHDFS REST API: the port of
dragonfly2_tpu/daemon/hdfs_source.py.

Parity with reference pkg/source/clients/hdfsprotocol/hdfs_source_client.go
(243 LoC — native HDFS wire protocol via colinmarc/hdfs): GetContentLength /
range Download / GetLastModified / directory listing. This client speaks
WebHDFS (the namenode's HTTP gateway, on by default since Hadoop 2) instead
of the native protocol — same capabilities, no wire-protocol reimplementation,
and the OPEN op takes offset/length so the piece engine's concurrent ranged
download works unchanged.

URL form: ``hdfs://namenode:port/path`` — port is the WebHDFS HTTP port
(dfs.http.address, default 9870). Ops used: GETFILESTATUS (info), OPEN with
offset/length (ranged read; follows the datanode redirect), LISTSTATUS
(recursive-download listing). DF_HDFS_USER sets the user.name query param.

URL-encoding convention matches the http(s) client: the hdfs:// URL's path
is taken VERBATIM (already URL-encoded by the caller — ``%20`` stays
``%20``), and listing builds child URLs by percent-encoding the raw
pathSuffix, so names containing ``?``/``#``/``%`` survive the round trip.
"""

from __future__ import annotations

import os
from typing import AsyncIterator, Optional
from urllib.parse import quote, urlsplit  # noqa: F401 (quote used for listing URLs)

import aiohttp

from dragonfly2_tpu_torch.daemon.source import (
    ResourceClient,
    SourceError,
    SourceInfo,
    URLEntry,
)
from dragonfly2_tpu_torch.utils.pieces import Range


class HDFSSourceClient(ResourceClient):
    scheme = "hdfs"

    def __init__(self, *, timeout: float = 300.0, chunk_size: int = 1 << 20):
        self.chunk_size = chunk_size
        self._timeout = aiohttp.ClientTimeout(total=timeout)
        self._session: Optional[aiohttp.ClientSession] = None

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(timeout=self._timeout)
        return self._session

    @staticmethod
    def _endpoint(url: str) -> tuple[str, str]:
        """hdfs://host:port/path → (http://host:port/webhdfs/v1, /path)."""
        parts = urlsplit(url)
        if not parts.netloc or not parts.path:
            raise SourceError(f"bad hdfs url (need namenode and path): {url}")
        return f"http://{parts.netloc}/webhdfs/v1", parts.path

    def _params(self, op: str, **extra) -> dict[str, str]:
        params = {"op": op}
        user = os.environ.get("DF_HDFS_USER", "")
        if user:
            params["user.name"] = user
        params.update({k: str(v) for k, v in extra.items()})
        return params

    async def info(self, url: str, headers: dict | None = None) -> SourceInfo:
        base, path = self._endpoint(url)
        async with self._sess().get(
            base + path, params=self._params("GETFILESTATUS"), headers=headers or {}
        ) as resp:
            if resp.status == 404:
                raise SourceError(f"hdfs {url}: file not found")
            if resp.status >= 400:
                raise SourceError(f"hdfs {url}: HTTP {resp.status}")
            body = await resp.json(content_type=None)
        st = body.get("FileStatus", {})
        if st.get("type") == "DIRECTORY":
            raise SourceError(f"hdfs {url}: is a directory (use recursive download)")
        return SourceInfo(
            content_length=int(st.get("length", -1)),
            supports_range=True,  # OPEN takes offset/length
            last_modified=str(st.get("modificationTime", "")),
        )

    async def download(
        self, url: str, rng: Range | None = None, headers: dict | None = None
    ) -> AsyncIterator[bytes]:
        base, path = self._endpoint(url)
        extra = {}
        if rng is not None:
            extra = {"offset": rng.start, "length": rng.length}
        # allow_redirects follows the namenode's 307 to the datanode
        async with self._sess().get(
            base + path,
            params=self._params("OPEN", **extra),
            headers=headers or {},
            allow_redirects=True,
        ) as resp:
            if resp.status >= 400:
                raise SourceError(f"hdfs open {url}: HTTP {resp.status}")
            async for chunk in resp.content.iter_chunked(self.chunk_size):
                yield chunk

    async def list_entries(self, url: str, headers: dict | None = None) -> list[URLEntry]:
        base, path = self._endpoint(url)
        async with self._sess().get(
            base + path, params=self._params("LISTSTATUS"), headers=headers or {}
        ) as resp:
            if resp.status >= 400:
                raise SourceError(f"hdfs list {url}: HTTP {resp.status}")
            body = await resp.json(content_type=None)
        statuses = body.get("FileStatuses", {}).get("FileStatus", [])
        parts = urlsplit(url)
        dir_path = parts.path.rstrip("/")
        entries: list[URLEntry] = []
        for st in statuses:
            name = st.get("pathSuffix", "")
            # same traversal guard as the s3/http listers: the name joins
            # local paths during recursive mirroring
            if not name or name in (".", "..") or "/" in name or "\\" in name:
                continue
            is_dir = st.get("type") == "DIRECTORY"
            # pathSuffix is a RAW name: percent-encode it into the child URL
            # so '?', '#', '%', spaces survive the urlsplit round trip
            entries.append(
                URLEntry(
                    url=f"hdfs://{parts.netloc}{dir_path}/{quote(name, safe='')}"
                    + ("/" if is_dir else ""),
                    name=name,
                    is_dir=is_dir,
                )
            )
        return entries

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
