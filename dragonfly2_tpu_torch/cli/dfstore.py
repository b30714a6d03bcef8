"""dfstore: object storage through the daemon's P2P object gateway; the port
of dragonfly2_tpu/cli/dfstore.py (either package's dfstore drives either
package's gateway).

Parity with reference client/dfstore/dfstore.go:41-71 (Dfstore SDK:
Get/Put/Delete/IsExist + request builders) and cmd/dfstore. SDK class
`Dfstore` + argparse CLI:

  python -m dragonfly2_tpu_torch.cli.dfstore put  local.bin  df://bucket/key
  python -m dragonfly2_tpu_torch.cli.dfstore get  df://bucket/key  local.bin
  python -m dragonfly2_tpu_torch.cli.dfstore stat df://bucket/key
  python -m dragonfly2_tpu_torch.cli.dfstore rm   df://bucket/key
  python -m dragonfly2_tpu_torch.cli.dfstore ls   df://bucket[/prefix]
  python -m dragonfly2_tpu_torch.cli.dfstore make-bucket df://bucket
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from urllib.parse import quote

import aiohttp

DEFAULT_ENDPOINT = "http://127.0.0.1:65004"


class DfstoreError(Exception):
    pass


@dataclass
class DfUrl:
    """df://bucket/key/with/slashes"""

    bucket: str
    key: str = ""

    @classmethod
    def parse(cls, s: str) -> "DfUrl":
        if not s.startswith("df://"):
            raise DfstoreError(f"expected df://bucket/key url, got {s!r}")
        rest = s[len("df://"):]
        bucket, _, key = rest.partition("/")
        if not bucket:
            raise DfstoreError(f"missing bucket in {s!r}")
        return cls(bucket=bucket, key=key)


class Dfstore:
    """SDK over the daemon object gateway (ref Dfstore interface)."""

    def __init__(self, endpoint: str = DEFAULT_ENDPOINT, *, timeout: float = 300.0):
        self.endpoint = endpoint.rstrip("/")
        # stall-based, not total: a total cap would abort exactly the
        # multi-GB streaming transfers put_file/get_object_to_file exist for
        self._timeout = aiohttp.ClientTimeout(
            total=None, connect=30.0, sock_read=timeout
        )
        self._session: aiohttp.ClientSession | None = None

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(timeout=self._timeout)
        return self._session

    def _obj_url(self, bucket: str, key: str) -> str:
        return f"{self.endpoint}/buckets/{quote(bucket)}/objects/{quote(key)}"

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    @staticmethod
    async def _raise_for(resp: aiohttp.ClientResponse) -> None:
        if resp.status >= 400:
            try:
                detail = (await resp.json()).get("error", "")
            except Exception:
                detail = await resp.text()
            raise DfstoreError(f"HTTP {resp.status}: {detail}")

    async def create_bucket(self, bucket: str) -> None:
        async with self._sess().put(f"{self.endpoint}/buckets/{quote(bucket)}") as r:
            await self._raise_for(r)

    async def list_buckets(self) -> list[dict]:
        async with self._sess().get(f"{self.endpoint}/buckets") as r:
            await self._raise_for(r)
            return (await r.json())["buckets"]

    async def put_object(
        self, bucket: str, key: str, data: bytes, *, seed: bool = False
    ) -> dict:
        url = self._obj_url(bucket, key) + ("?seed=1" if seed else "")
        async with self._sess().put(url, data=data) as r:
            await self._raise_for(r)
            return await r.json()

    async def put_file(
        self, bucket: str, key: str, path: str | Path, *, seed: bool = False,
        chunk_size: int = 1 << 20,
    ) -> dict:
        """Stream a file up without holding it in RAM (the gateway streams
        the body straight into the backend's multipart path)."""
        url = self._obj_url(bucket, key) + ("?seed=1" if seed else "")

        async def chunks():
            with open(path, "rb") as f:
                while True:
                    b = await asyncio.to_thread(f.read, chunk_size)
                    if not b:
                        return
                    yield b

        async with self._sess().put(url, data=chunks()) as r:
            await self._raise_for(r)
            return await r.json()

    async def get_object(self, bucket: str, key: str, *, direct: bool = False) -> bytes:
        url = self._obj_url(bucket, key) + ("?mode=direct" if direct else "")
        async with self._sess().get(url) as r:
            await self._raise_for(r)
            return await r.read()

    async def get_object_to_file(
        self, bucket: str, key: str, dest: str | Path, *, direct: bool = False,
        chunk_size: int = 1 << 20,
    ) -> int:
        """Stream an object to disk without holding it in RAM; returns bytes
        written. Writes a temp file and renames on success so a mid-stream
        failure never leaves a silently-truncated dest behind."""
        url = self._obj_url(bucket, key) + ("?mode=direct" if direct else "")
        dest = Path(dest)
        tmp = dest.with_name(dest.name + ".dfstore-partial")
        n = 0
        try:
            async with self._sess().get(url) as r:
                await self._raise_for(r)
                with open(tmp, "wb") as f:
                    async for chunk in r.content.iter_chunked(chunk_size):
                        await asyncio.to_thread(f.write, chunk)
                        n += len(chunk)
            tmp.replace(dest)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        return n

    async def stat_object(self, bucket: str, key: str) -> dict:
        async with self._sess().head(self._obj_url(bucket, key)) as r:
            if r.status == 404:
                raise DfstoreError(f"object {bucket}/{key} not found")
            await self._raise_for(r)
            return {
                "content_length": int(r.headers.get("Content-Length", -1)),
                "content_type": r.headers.get("Content-Type", ""),
                "etag": r.headers.get("ETag", ""),
                "digest": r.headers.get("X-Dragonfly-Digest", ""),
            }

    async def is_object_exist(self, bucket: str, key: str) -> bool:
        try:
            await self.stat_object(bucket, key)
            return True
        except DfstoreError:
            return False

    async def delete_object(self, bucket: str, key: str) -> None:
        async with self._sess().delete(self._obj_url(bucket, key)) as r:
            await self._raise_for(r)

    async def list_objects(self, bucket: str, prefix: str = "") -> list[dict]:
        url = f"{self.endpoint}/buckets/{quote(bucket)}/objects"
        async with self._sess().get(url, params={"prefix": prefix}) as r:
            await self._raise_for(r)
            return (await r.json())["objects"]


async def _amain(args: argparse.Namespace) -> int:
    store = Dfstore(args.endpoint)
    try:
        if args.cmd == "make-bucket":
            await store.create_bucket(DfUrl.parse(args.url).bucket)
            print("created")
        elif args.cmd == "put":
            u = DfUrl.parse(args.dest)
            out = await store.put_file(
                u.bucket, u.key or Path(args.src).name, args.src, seed=args.seed
            )
            print(json.dumps(out))
        elif args.cmd == "get":
            u = DfUrl.parse(args.src)
            n = await store.get_object_to_file(
                u.bucket, u.key, args.dest, direct=args.direct
            )
            print(f"{n} bytes -> {args.dest}")
        elif args.cmd == "stat":
            u = DfUrl.parse(args.url)
            print(json.dumps(await store.stat_object(u.bucket, u.key)))
        elif args.cmd == "rm":
            u = DfUrl.parse(args.url)
            await store.delete_object(u.bucket, u.key)
            print("deleted")
        elif args.cmd == "ls":
            u = DfUrl.parse(args.url)
            for o in await store.list_objects(u.bucket, prefix=u.key):
                print(f"{o['content_length']:>12} {o['key']}")
        return 0
    except DfstoreError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await store.close()


def main() -> None:
    ap = argparse.ArgumentParser(prog="dfstore", description="P2P object storage CLI")
    ap.add_argument("--endpoint", default=DEFAULT_ENDPOINT, help="daemon object gateway")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("put")
    p.add_argument("src")
    p.add_argument("dest", help="df://bucket/key")
    p.add_argument("--seed", action="store_true", help="pre-populate the P2P cache")
    p = sub.add_parser("get")
    p.add_argument("src", help="df://bucket/key")
    p.add_argument("dest")
    p.add_argument("--direct", action="store_true", help="bypass P2P")
    for name in ("stat", "rm", "make-bucket"):
        p = sub.add_parser(name)
        p.add_argument("url", help="df://bucket[/key]")
    p = sub.add_parser("ls")
    p.add_argument("url", help="df://bucket[/prefix]")
    args = ap.parse_args()
    sys.exit(asyncio.run(_amain(args)))


if __name__ == "__main__":
    main()
