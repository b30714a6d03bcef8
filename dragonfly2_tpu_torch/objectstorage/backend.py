"""Object-storage backends: the port of dragonfly2_tpu/objectstorage/backend.py,
the same LocalFS layout on disk, so a root written by either package is
read by the other.

Interface parity with reference pkg/objectstorage/objectstorage.go:65-105
(GetBucketMetadata/CreateBucket/ListBucketMetadatas, GetObject/PutObject/
DeleteObject/IsObjectExist/GetObjectMetadatas, GetSignURL) re-shaped async.
Backends: `fs` (local filesystem, always available) and `s3` (backed by the
in-repo hand-rolled SigV4 client, `objectstorage/s3client.py` — no SDK
dependency).

The filesystem layout is `root/<bucket>/<key>` with a sidecar
`root/.meta/<bucket>/<key>.json` carrying digest/content-type/custom
metadata, so `presign_get` can hand the P2P engine a plain `file://` URL
(the gateway's GetObject rides the engine with the backend as origin, the
way the reference signs an S3 URL and StartStreamTasks it,
client/daemon/objectstorage/objectstorage.go).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import shutil
import time
import uuid
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import AsyncIterator, Union

logger = logging.getLogger(__name__)


class ObjectStorageError(Exception):
    def __init__(self, message: str, *, code: str = "internal"):
        super().__init__(message)
        self.code = code


@dataclass
class ObjectMetadata:
    key: str
    content_length: int
    digest: str = ""  # "sha256:<hex>"
    etag: str = ""
    content_type: str = "application/octet-stream"
    last_modified: float = 0.0
    user_metadata: dict = field(default_factory=dict)


@dataclass
class Bucket:
    name: str
    created_at: float = 0.0


# streamed puts on remote backends buffer at most one part of this size;
# objects at or under one part go up as a single simple PUT
MULTIPART_PART_BYTES = 8 << 20


class ObjectStorageBackend:
    """Async object-store interface; all methods raise ObjectStorageError
    with code in {not_found, already_exists, invalid} on expected failures."""

    name = ""
    MULTIPART_PART_BYTES = MULTIPART_PART_BYTES  # instance-overridable

    # buckets
    async def create_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    async def delete_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    async def list_buckets(self) -> list[Bucket]:
        raise NotImplementedError

    async def bucket_exists(self, bucket: str) -> bool:
        raise NotImplementedError

    # objects
    async def put_object(
        self,
        bucket: str,
        key: str,
        data: Union[bytes, AsyncIterator[bytes]],
        *,
        content_type: str = "application/octet-stream",
        user_metadata: dict | None = None,
    ) -> ObjectMetadata:
        raise NotImplementedError

    async def get_object(self, bucket: str, key: str) -> bytes:
        raise NotImplementedError

    async def get_object_stream(self, bucket: str, key: str) -> AsyncIterator[bytes]:
        """Chunked read; base fallback buffers (subclasses stream — the
        gateway's direct path must not hold a 16 GB shard in RAM)."""
        yield await self.get_object(bucket, key)

    async def stat_object(self, bucket: str, key: str) -> ObjectMetadata:
        raise NotImplementedError

    async def delete_object(self, bucket: str, key: str) -> None:
        raise NotImplementedError

    async def object_exists(self, bucket: str, key: str) -> bool:
        try:
            await self.stat_object(bucket, key)
            return True
        except ObjectStorageError:
            return False

    async def list_objects(
        self, bucket: str, prefix: str = "", limit: int | None = None
    ) -> list[ObjectMetadata]:
        """List objects under `prefix`; `limit` caps the result count."""
        raise NotImplementedError

    def presign_get(self, bucket: str, key: str) -> str:
        """A URL the daemon's source registry can fetch (back-to-source
        origin for P2P object distribution)."""
        raise NotImplementedError

    async def close(self) -> None:
        """Release network resources (no-op for local backends); every
        gateway/embedder calls this on shutdown via ObjectGateway.stop()."""


async def stream_multipart_put(
    client,
    bucket: str,
    key: str,
    data: AsyncIterator[bytes],
    *,
    part_size: int = MULTIPART_PART_BYTES,
    content_type: str = "application/octet-stream",
    user_metadata: dict | None = None,
) -> tuple[str, int, str]:
    """Stream an object of unknown size through a multipart upload: one part
    (never the whole object) in RAM, incremental sha256, abort on failure.
    `client` is any of the dialect clients exposing put_object /
    initiate_multipart / upload_part / complete_multipart / abort_multipart
    (s3client.S3Client and ossobs.OssObsClient both do). Returns
    (etag, total_bytes, sha256_hex); the etag is the COMPLETED object's."""
    h = hashlib.sha256()
    buf = bytearray()
    length = 0
    upload_id: str | None = None
    parts: list[tuple[int, str]] = []

    async def flush_part() -> None:
        nonlocal upload_id
        if upload_id is None:
            upload_id = await client.initiate_multipart(
                bucket, key, content_type=content_type, user_metadata=user_metadata
            )
        etag = await client.upload_part(
            bucket, key, upload_id=upload_id,
            part_number=len(parts) + 1, data=bytes(buf),
        )
        parts.append((len(parts) + 1, etag))
        buf.clear()

    try:
        async for chunk in data:
            h.update(chunk)
            length += len(chunk)
            buf.extend(chunk)
            if len(buf) >= part_size:
                await flush_part()
                if len(parts) % 1000 == 0 and part_size < (1 << 32):
                    # the stores cap uploads at 10k parts: double the part
                    # size each 1000 parts so unknown-size streams never run
                    # into the cap (8 MiB start reaches the multi-TB range)
                    part_size *= 2
        if upload_id is None:
            # small object after all: one simple PUT, no multipart
            etag = await client.put_object(
                bucket, key, bytes(buf),
                content_type=content_type, user_metadata=user_metadata,
            )
            return etag, length, h.hexdigest()
        if buf:
            await flush_part()
        etag = await client.complete_multipart(
            bucket, key, upload_id=upload_id, parts=parts
        )
    except BaseException:
        if upload_id is not None:
            try:
                await client.abort_multipart(bucket, key, upload_id=upload_id)
            except Exception as abort_err:
                # best-effort: the store reaps stale uploads
                logger.debug("multipart abort for %s/%s failed: %s", bucket, key, abort_err)
        raise
    return etag, length, h.hexdigest()


def _safe_key(key: str) -> str:
    # forbid traversal and degenerate segments; keys may contain slashes
    # (pseudo-dirs) but every segment must be a real path component
    segments = key.split("/")
    if not key or key.startswith("/") or any(s in ("", ".", "..") for s in segments):
        raise ObjectStorageError(f"invalid key: {key!r}", code="invalid")
    return key


class LocalFSBackend(ObjectStorageBackend):
    name = "fs"

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._meta_root = self.root / ".meta"

    # ---- helpers ----

    def _bucket_dir(self, bucket: str) -> Path:
        if not bucket or "/" in bucket or bucket.startswith("."):
            raise ObjectStorageError(f"invalid bucket name: {bucket!r}", code="invalid")
        return self.root / bucket

    def _obj_path(self, bucket: str, key: str) -> Path:
        return self._bucket_dir(bucket) / _safe_key(key)

    def _meta_path(self, bucket: str, key: str) -> Path:
        return self._meta_root / bucket / (_safe_key(key) + ".json")

    def _require_bucket(self, bucket: str) -> Path:
        d = self._bucket_dir(bucket)
        if not d.is_dir():
            raise ObjectStorageError(f"bucket {bucket} not found", code="not_found")
        return d

    # ---- buckets ----

    async def create_bucket(self, bucket: str) -> None:
        d = self._bucket_dir(bucket)
        if d.exists():
            raise ObjectStorageError(f"bucket {bucket} exists", code="already_exists")
        d.mkdir(parents=True)

    async def delete_bucket(self, bucket: str) -> None:
        d = self._require_bucket(bucket)
        if any(d.iterdir()):
            raise ObjectStorageError(f"bucket {bucket} not empty", code="invalid")
        d.rmdir()
        shutil.rmtree(self._meta_root / bucket, ignore_errors=True)

    async def list_buckets(self) -> list[Bucket]:
        out = []
        for d in sorted(self.root.iterdir()):
            if d.is_dir() and not d.name.startswith("."):
                out.append(Bucket(name=d.name, created_at=d.stat().st_mtime))
        return out

    async def bucket_exists(self, bucket: str) -> bool:
        try:
            return self._bucket_dir(bucket).is_dir()
        except ObjectStorageError:
            return False

    # ---- objects ----

    async def put_object(
        self,
        bucket: str,
        key: str,
        data: Union[bytes, AsyncIterator[bytes]],
        *,
        content_type: str = "application/octet-stream",
        user_metadata: dict | None = None,
    ) -> ObjectMetadata:
        """Store an object from bytes or an async byte-chunk iterator (large
        payloads stream to disk with incremental hashing — never fully
        buffered in RAM)."""
        self._require_bucket(bucket)
        path = self._obj_path(bucket, key)
        # temp files live in a dedicated dir outside any bucket so they can
        # never collide with (or shadow) real object keys
        tmp_dir = self.root / ".tmp"
        tmp_dir.mkdir(exist_ok=True)
        tmp = tmp_dir / uuid.uuid4().hex

        h = hashlib.sha256()
        length = 0
        fh = await asyncio.to_thread(open, tmp, "wb")
        try:
            if isinstance(data, (bytes, bytearray)):
                h.update(data)
                length = len(data)
                await asyncio.to_thread(fh.write, data)
            else:
                async for chunk in data:
                    h.update(chunk)
                    length += len(chunk)
                    await asyncio.to_thread(fh.write, chunk)
        finally:
            fh.close()

        hexdigest = h.hexdigest()
        meta = ObjectMetadata(
            key=key,
            content_length=length,
            digest=f"sha256:{hexdigest}",
            etag=hexdigest[:32],
            content_type=content_type,
            last_modified=time.time(),
            user_metadata=dict(user_metadata or {}),
        )

        def _publish() -> None:
            # data first, then meta sidecar: both renames are atomic; the
            # tiny data-new/meta-old overwrite window only mis-reports the
            # digest, which the P2P path detects and falls back on
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp.replace(path)
            mp = self._meta_path(bucket, key)
            mp.parent.mkdir(parents=True, exist_ok=True)
            mtmp = tmp_dir / (uuid.uuid4().hex + ".json")
            mtmp.write_text(json.dumps(asdict(meta)))
            mtmp.replace(mp)

        try:
            await asyncio.to_thread(_publish)
        except OSError as e:
            tmp.unlink(missing_ok=True)
            raise ObjectStorageError(f"store {bucket}/{key} failed: {e}", code="invalid")
        return meta

    async def get_object(self, bucket: str, key: str) -> bytes:
        path = self._obj_path(bucket, key)
        if not path.is_file():
            raise ObjectStorageError(f"object {bucket}/{key} not found", code="not_found")
        return await asyncio.to_thread(path.read_bytes)

    async def get_object_stream(self, bucket: str, key: str) -> AsyncIterator[bytes]:
        path = self._obj_path(bucket, key)
        if not path.is_file():
            raise ObjectStorageError(f"object {bucket}/{key} not found", code="not_found")
        with open(path, "rb") as f:
            while True:
                chunk = await asyncio.to_thread(f.read, 1 << 20)
                if not chunk:
                    return
                yield chunk

    async def stat_object(self, bucket: str, key: str) -> ObjectMetadata:
        path = self._obj_path(bucket, key)
        if not path.is_file():
            raise ObjectStorageError(f"object {bucket}/{key} not found", code="not_found")
        mp = self._meta_path(bucket, key)
        text = await asyncio.to_thread(lambda: mp.read_text() if mp.is_file() else "")
        if text:
            return ObjectMetadata(**json.loads(text))
        st = path.stat()
        return ObjectMetadata(key=key, content_length=st.st_size, last_modified=st.st_mtime)

    async def delete_object(self, bucket: str, key: str) -> None:
        path = self._obj_path(bucket, key)
        # idempotent like S3 DeleteObject
        path.unlink(missing_ok=True)
        self._meta_path(bucket, key).unlink(missing_ok=True)

    async def list_objects(
        self, bucket: str, prefix: str = "", limit: int | None = None
    ) -> list[ObjectMetadata]:
        d = self._require_bucket(bucket)
        out = []
        for p in sorted(d.rglob("*")):
            if not p.is_file():
                continue
            key = p.relative_to(d).as_posix()
            if key.startswith(prefix):
                out.append(await self.stat_object(bucket, key))
                if limit is not None and len(out) >= limit:
                    break
        return out

    def presign_get(self, bucket: str, key: str) -> str:
        return self._obj_path(bucket, key).resolve().as_uri()


class S3Backend(ObjectStorageBackend):
    """S3/OSS/OBS-compatible backend (ref pkg/objectstorage/s3.go) over the
    dependency-free SigV4 client — works against any S3 dialect endpoint
    (minio, ceph-rgw, OSS/OBS in S3 mode)."""

    name = "s3"

    def __init__(
        self,
        *,
        endpoint: str,
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
    ):
        from dragonfly2_tpu_torch.objectstorage.s3client import S3Client, S3Config

        self._client = S3Client(
            S3Config(
                endpoint=endpoint, access_key=access_key,
                secret_key=secret_key, region=region,
            )
        )

    @staticmethod
    def _wrap(e: Exception) -> ObjectStorageError:
        from dragonfly2_tpu_torch.objectstorage.s3client import S3Error

        if isinstance(e, S3Error):
            if e.status == 404:
                return ObjectStorageError(str(e), code="not_found")
            if e.status == 409 or e.code in ("BucketAlreadyOwnedByYou", "BucketAlreadyExists"):
                return ObjectStorageError(str(e), code="already_exists")
            return ObjectStorageError(str(e), code="invalid" if e.status < 500 else "internal")
        return ObjectStorageError(str(e))

    async def create_bucket(self, bucket: str) -> None:
        try:
            await self._client.create_bucket(bucket)
        except Exception as e:
            raise self._wrap(e) from e

    async def delete_bucket(self, bucket: str) -> None:
        try:
            await self._client.delete_bucket(bucket)
        except Exception as e:
            raise self._wrap(e) from e

    async def list_buckets(self) -> list[Bucket]:
        try:
            return [Bucket(name=n) for n in await self._client.list_buckets()]
        except Exception as e:
            raise self._wrap(e) from e

    async def bucket_exists(self, bucket: str) -> bool:
        try:
            return await self._client.bucket_exists(bucket)
        except Exception as e:
            raise self._wrap(e) from e

    async def put_object(
        self,
        bucket: str,
        key: str,
        data: Union[bytes, AsyncIterator[bytes]],
        *,
        content_type: str = "application/octet-stream",
        user_metadata: dict | None = None,
    ) -> ObjectMetadata:
        _safe_key(key)
        try:
            if isinstance(data, (bytes, bytearray)):
                digest = hashlib.sha256(data).hexdigest()
                length = len(data)
                etag = await self._client.put_object(
                    bucket, key, bytes(data),
                    content_type=content_type, user_metadata=user_metadata,
                )
            else:
                # streamed: multipart upload (required for >5 GB on real S3);
                # one part in RAM, incremental hashing. (put_object_stream —
                # the single UNSIGNED-PAYLOAD PUT — remains on the client for
                # callers that know the object is small.)
                etag, length, digest = await stream_multipart_put(
                    self._client, bucket, key, data,
                    part_size=self.MULTIPART_PART_BYTES,
                    content_type=content_type, user_metadata=user_metadata,
                )
        except Exception as e:
            raise self._wrap(e) from e
        return ObjectMetadata(
            key=key,
            content_length=length,
            digest=f"sha256:{digest}",
            etag=etag,
            content_type=content_type,
            last_modified=time.time(),
            user_metadata=dict(user_metadata or {}),
        )

    async def get_object(self, bucket: str, key: str) -> bytes:
        buf = bytearray()
        try:
            async for chunk in self._client.get_object(bucket, key):
                buf.extend(chunk)
        except Exception as e:
            raise self._wrap(e) from e
        return bytes(buf)

    async def get_object_stream(self, bucket: str, key: str) -> AsyncIterator[bytes]:
        try:
            async for chunk in self._client.get_object(bucket, key):
                yield chunk
        except Exception as e:
            raise self._wrap(e) from e

    async def stat_object(self, bucket: str, key: str) -> ObjectMetadata:
        try:
            obj = await self._client.head_object(bucket, key)
        except Exception as e:
            raise self._wrap(e) from e
        return ObjectMetadata(
            key=key,
            content_length=obj.size,
            etag=obj.etag,
            content_type=obj.content_type or "application/octet-stream",
            user_metadata=dict(obj.user_metadata),
        )

    async def delete_object(self, bucket: str, key: str) -> None:
        try:
            await self._client.delete_object(bucket, key)
        except Exception as e:
            raise self._wrap(e) from e

    async def list_objects(
        self, bucket: str, prefix: str = "", limit: int | None = None
    ) -> list[ObjectMetadata]:
        try:
            res = await self._client.list_objects(bucket, prefix=prefix, limit=limit)
        except Exception as e:
            raise self._wrap(e) from e
        return [
            ObjectMetadata(key=o.key, content_length=o.size, etag=o.etag)
            for o in res.objects
        ]

    def presign_get(self, bucket: str, key: str) -> str:
        return self._client.presign_get(bucket, key)

    async def close(self) -> None:
        await self._client.close()


class _OssObsBackend(ObjectStorageBackend):
    """Shared OSS/OBS adapter over the in-repo legacy header-signing client
    (objectstorage/ossobs.py) — the bucket-management path the reference
    serves via the vendor SDKs (pkg/objectstorage/oss.go:1-219,
    obs.go:1-227). Subclasses pin the dialect."""

    def __init__(self, *, endpoint: str, access_key: str, secret_key: str):
        from dragonfly2_tpu_torch.objectstorage.ossobs import (
            OBS_DIALECT,
            OSS_DIALECT,
            DialectConfig,
            OssObsClient,
        )

        self._client = OssObsClient(
            DialectConfig(endpoint=endpoint, access_key=access_key, secret_key=secret_key),
            OSS_DIALECT if self.name == "oss" else OBS_DIALECT,
        )

    @staticmethod
    def _wrap(e: Exception) -> ObjectStorageError:
        from dragonfly2_tpu_torch.objectstorage.ossobs import DialectError

        if isinstance(e, DialectError):
            if e.status == 404:
                return ObjectStorageError(str(e), code="not_found")
            if e.status == 409 or "Exist" in e.code:
                return ObjectStorageError(str(e), code="already_exists")
            return ObjectStorageError(str(e), code="invalid" if e.status < 500 else "internal")
        return ObjectStorageError(str(e))

    async def create_bucket(self, bucket: str) -> None:
        try:
            await self._client.create_bucket(bucket)
        except Exception as e:
            raise self._wrap(e) from e

    async def delete_bucket(self, bucket: str) -> None:
        try:
            await self._client.delete_bucket(bucket)
        except Exception as e:
            raise self._wrap(e) from e

    async def list_buckets(self) -> list[Bucket]:
        try:
            return [Bucket(name=n) for n in await self._client.list_buckets()]
        except Exception as e:
            raise self._wrap(e) from e

    async def bucket_exists(self, bucket: str) -> bool:
        try:
            return await self._client.bucket_exists(bucket)
        except Exception as e:
            raise self._wrap(e) from e

    async def put_object(
        self,
        bucket: str,
        key: str,
        data: Union[bytes, AsyncIterator[bytes]],
        *,
        content_type: str = "application/octet-stream",
        user_metadata: dict | None = None,
    ) -> ObjectMetadata:
        _safe_key(key)
        try:
            if isinstance(data, (bytes, bytearray)):
                data = bytes(data)
                digest = hashlib.sha256(data).hexdigest()
                length = len(data)
                etag = await self._client.put_object(
                    bucket, key, data,
                    content_type=content_type, user_metadata=user_metadata,
                )
            else:
                # streamed: multipart upload — one part (not the whole
                # object) in RAM, incremental hashing (multi-GB artifacts
                # through the gateway stay out of memory)
                etag, length, digest = await stream_multipart_put(
                    self._client, bucket, key, data,
                    part_size=self.MULTIPART_PART_BYTES,
                    content_type=content_type, user_metadata=user_metadata,
                )
        except Exception as e:
            raise self._wrap(e) from e
        return ObjectMetadata(
            key=key,
            content_length=length,
            digest=f"sha256:{digest}",
            etag=etag,
            content_type=content_type,
            last_modified=time.time(),
            user_metadata=dict(user_metadata or {}),
        )

    async def get_object(self, bucket: str, key: str) -> bytes:
        try:
            return await self._client.get_object(bucket, key)
        except Exception as e:
            raise self._wrap(e) from e

    async def get_object_stream(self, bucket: str, key: str) -> AsyncIterator[bytes]:
        try:
            async for chunk in self._client.get_object_stream(bucket, key):
                yield chunk
        except Exception as e:
            raise self._wrap(e) from e

    async def stat_object(self, bucket: str, key: str) -> ObjectMetadata:
        try:
            obj = await self._client.head_object(bucket, key)
        except Exception as e:
            raise self._wrap(e) from e
        return ObjectMetadata(
            key=key,
            content_length=obj.size,
            etag=obj.etag,
            content_type=obj.content_type or "application/octet-stream",
            user_metadata=dict(obj.user_metadata),
        )

    async def delete_object(self, bucket: str, key: str) -> None:
        try:
            await self._client.delete_object(bucket, key)
        except Exception as e:
            raise self._wrap(e) from e

    async def list_objects(
        self, bucket: str, prefix: str = "", limit: int | None = None
    ) -> list[ObjectMetadata]:
        try:
            res = await self._client.list_objects(bucket, prefix=prefix, limit=limit)
        except Exception as e:
            raise self._wrap(e) from e
        return [ObjectMetadata(key=o.key, content_length=o.size, etag=o.etag) for o in res]

    def presign_get(self, bucket: str, key: str) -> str:
        return self._client.presign_get(bucket, key)

    async def close(self) -> None:
        await self._client.close()


class OSSBackend(_OssObsBackend):
    name = "oss"


class OBSBackend(_OssObsBackend):
    name = "obs"


_BACKENDS = {"fs": LocalFSBackend, "s3": S3Backend, "oss": OSSBackend, "obs": OBSBackend}


def new_backend(name: str, **kwargs) -> ObjectStorageBackend:
    cls = _BACKENDS.get(name)
    if cls is None:
        raise ObjectStorageError(f"unknown object-storage backend {name!r}", code="invalid")
    return cls(**kwargs)
