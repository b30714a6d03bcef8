"""Aliyun OSS / Huawei OBS object-storage client — one dialect, two labels;
the port of dragonfly2_tpu/objectstorage/ossobs.py, its signatures
byte-equal to the reference's.

Parity with reference pkg/objectstorage/oss.go:1-219 and obs.go:1-227, which
wrap the vendors' SDKs. Both services speak the same legacy header-signing
wire protocol (S3 v2 style): the request is authenticated by

    Authorization: <LABEL> <AccessKeyId>:base64(hmac-sha1(secret, sts))
    sts = VERB \n Content-MD5 \n Content-Type \n Date \n
          <canonicalized provider headers> <canonicalized resource>

with provider metadata/header prefixes ``x-oss-`` / ``x-obs-`` and presigned
URLs carrying (``OSSAccessKeyId``|``AccessKeyId``, ``Expires``,
``Signature``) query params. The XML bodies (ListAllMyBucketsResult,
ListBucketResult) are S3-shaped. So instead of two vendor SDKs this is ONE
dependency-free client parameterized by the dialect constants; the backends
in ``objectstorage.backend`` select the dialect by name.

Path-style addressing (endpoint/bucket/key) is used throughout — both
services accept it and it keeps fixtures/minio-style gateways addressable
without wildcard DNS.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from email.utils import formatdate
from typing import AsyncIterator, Optional
from urllib.parse import quote

import aiohttp


class DialectError(Exception):
    def __init__(self, message: str, *, status: int = 0, code: str = ""):
        super().__init__(message)
        self.status = status
        self.code = code


@dataclass(frozen=True)
class Dialect:
    label: str          # Authorization scheme label: "OSS" | "OBS"
    header_prefix: str  # canonicalized-header/meta prefix: "x-oss-" | "x-obs-"
    presign_key_param: str  # "OSSAccessKeyId" | "AccessKeyId"


OSS_DIALECT = Dialect(label="OSS", header_prefix="x-oss-", presign_key_param="OSSAccessKeyId")
OBS_DIALECT = Dialect(label="OBS", header_prefix="x-obs-", presign_key_param="AccessKeyId")


@dataclass
class DialectConfig:
    endpoint: str  # http(s)://host[:port]
    access_key: str
    secret_key: str


@dataclass
class ObjectInfo:
    key: str
    size: int = 0
    etag: str = ""
    content_type: str = ""
    user_metadata: dict = field(default_factory=dict)


def canonicalized_headers(headers: dict[str, str], prefix: str) -> str:
    """Lower-cased provider headers, sorted, as ``k:v\\n`` lines."""
    rows = sorted(
        (k.lower(), v.strip()) for k, v in headers.items() if k.lower().startswith(prefix)
    )
    return "".join(f"{k}:{v}\n" for k, v in rows)


def string_to_sign(
    verb: str,
    resource: str,
    *,
    date: str,
    dialect: Dialect,
    content_md5: str = "",
    content_type: str = "",
    headers: dict[str, str] | None = None,
) -> str:
    return (
        f"{verb}\n{content_md5}\n{content_type}\n{date}\n"
        f"{canonicalized_headers(headers or {}, dialect.header_prefix)}{resource}"
    )


def sign(secret_key: str, sts: str) -> str:
    mac = hmac.new(secret_key.encode(), sts.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


class OssObsClient:
    """Minimal bucket/object surface for the manager CRUD + dfstore gateway
    (the same surface the reference maps through the vendor SDKs)."""

    def __init__(self, cfg: DialectConfig, dialect: Dialect, *, timeout: float = 300.0):
        self.cfg = cfg
        self.dialect = dialect
        # stall-based: a total cap would abort long streaming transfers
        self._timeout = aiohttp.ClientTimeout(
            total=None, connect=30.0, sock_read=timeout
        )
        self._session: Optional[aiohttp.ClientSession] = None

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(timeout=self._timeout)
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    # ---- request plumbing ----

    def _url(self, bucket: str = "", key: str = "") -> str:
        url = self.cfg.endpoint.rstrip("/")
        if bucket:
            url += "/" + quote(bucket)
        if key:
            url += "/" + quote(key, safe="/")
        return url

    @staticmethod
    def _resource(bucket: str = "", key: str = "") -> str:
        r = "/"
        if bucket:
            r += bucket + "/"
            if key:
                r += key
        return r

    async def _request(
        self,
        verb: str,
        bucket: str = "",
        key: str = "",
        *,
        params: dict[str, str] | None = None,
        subresource: list[tuple[str, str | None]] | None = None,
        data: bytes | None = None,
        content_type: str = "",
        extra_headers: dict[str, str] | None = None,
        ok: tuple[int, ...] = (200, 204),
    ) -> tuple[int, bytes, dict]:
        """subresource: ordered signed query params — [("uploads", None)],
        [("partNumber", "5"), ("uploadId", id)], ... Values are RAW: the
        canonicalized resource signs them unencoded per the dialect's rules,
        and aiohttp URL-encodes them exactly once on the wire (quoting them
        here would double-encode and break both lookup and signature for ids
        containing '+', '/', '=')."""
        date = formatdate(usegmt=True)
        headers = dict(extra_headers or {})
        headers["Date"] = date
        if content_type:
            headers["Content-Type"] = content_type
        resource = self._resource(bucket, key)
        if subresource:
            resource += "?" + "&".join(
                k if v is None else f"{k}={v}" for k, v in subresource
            )
            params = dict(params or {})
            for k, v in subresource:
                params[k] = "" if v is None else v
        sts = string_to_sign(
            verb,
            resource,
            date=date,
            dialect=self.dialect,
            content_type=content_type,
            headers=headers,
        )
        headers["Authorization"] = (
            f"{self.dialect.label} {self.cfg.access_key}:{sign(self.cfg.secret_key, sts)}"
        )
        async with self._sess().request(
            verb,
            self._url(bucket, key),
            params=params,
            data=data,
            headers=headers,
            # aiohttp would inject Content-Type: application/octet-stream on
            # bodyless PUTs — a header the signature didn't cover
            skip_auto_headers=() if content_type else ("Content-Type",),
        ) as resp:
            body = await resp.read()
            if resp.status not in ok:
                raise self._http_error(verb, bucket, key, resp.status, body)
            return resp.status, body, dict(resp.headers)

    def _http_error(
        self, verb: str, bucket: str, key: str, status: int, body: bytes
    ) -> DialectError:
        code = ""
        try:
            # errors="replace": a non-UTF-8 error body must not mask the
            # real HTTP failure with a UnicodeDecodeError
            code = ET.fromstring(body.decode(errors="replace")).findtext("Code") or ""
        except ET.ParseError:
            pass
        return DialectError(
            f"{self.dialect.label} {verb} {bucket}/{key}: HTTP {status} {code}",
            status=status,
            code=code,
        )

    # ---- buckets ----

    async def create_bucket(self, bucket: str) -> None:
        await self._request("PUT", bucket)

    async def delete_bucket(self, bucket: str) -> None:
        await self._request("DELETE", bucket)

    async def bucket_exists(self, bucket: str) -> bool:
        try:
            await self._request("HEAD", bucket)
            return True
        except DialectError as e:
            if e.status == 404:
                return False
            raise

    async def list_buckets(self) -> list[str]:
        _, body, _ = await self._request("GET")
        root = ET.fromstring(body.decode())
        return [
            el.findtext("Name") or ""
            for el in root.iter()
            if el.tag.endswith("Bucket") and el.findtext("Name")
        ]

    # ---- objects ----

    def _meta_headers(self, user_metadata: dict | None) -> dict[str, str]:
        return {
            f"{self.dialect.header_prefix}meta-{k}": str(v)
            for k, v in (user_metadata or {}).items()
        }

    async def put_object(
        self,
        bucket: str,
        key: str,
        data: bytes,
        *,
        content_type: str = "application/octet-stream",
        user_metadata: dict | None = None,
    ) -> str:
        _, _, headers = await self._request(
            "PUT", bucket, key,
            data=data, content_type=content_type,
            extra_headers=self._meta_headers(user_metadata),
        )
        return headers.get("ETag", "").strip('"')

    async def get_object(self, bucket: str, key: str) -> bytes:
        _, body, _ = await self._request("GET", bucket, key)
        return body

    async def get_object_stream(
        self, bucket: str, key: str, *, chunk_size: int = 1 << 20
    ) -> AsyncIterator[bytes]:
        """Signed GET yielding chunks — large objects never buffer whole.
        Shares _request's signing plumbing; only the body read differs."""
        date = formatdate(usegmt=True)
        headers = {"Date": date}
        sts = string_to_sign(
            "GET", self._resource(bucket, key), date=date, dialect=self.dialect,
            headers=headers,
        )
        headers["Authorization"] = (
            f"{self.dialect.label} {self.cfg.access_key}:{sign(self.cfg.secret_key, sts)}"
        )
        resp = await self._sess().get(self._url(bucket, key), headers=headers)
        try:
            if resp.status != 200:
                raise self._http_error("GET", bucket, key, resp.status, await resp.read())
            async for chunk in resp.content.iter_chunked(chunk_size):
                yield chunk
        finally:
            resp.release()

    async def head_object(self, bucket: str, key: str) -> ObjectInfo:
        _, _, headers = await self._request("HEAD", bucket, key)
        meta_prefix = f"{self.dialect.header_prefix}meta-"
        return ObjectInfo(
            key=key,
            size=int(headers.get("Content-Length", "0")),
            etag=headers.get("ETag", "").strip('"'),
            content_type=headers.get("Content-Type", ""),
            user_metadata={
                k[len(meta_prefix):]: v
                for k, v in headers.items()
                if k.lower().startswith(meta_prefix)
            },
        )

    async def delete_object(self, bucket: str, key: str) -> None:
        await self._request("DELETE", bucket, key, ok=(200, 204))

    async def list_objects(
        self, bucket: str, *, prefix: str = "", limit: int | None = None
    ) -> list[ObjectInfo]:
        params = {"prefix": prefix}
        if limit is not None:
            params["max-keys"] = str(limit)
        _, body, _ = await self._request("GET", bucket, params=params)
        root = ET.fromstring(body.decode())
        out = []
        for el in root.iter():
            if el.tag.endswith("Contents"):
                out.append(
                    ObjectInfo(
                        key=el.findtext("Key") or "",
                        size=int(el.findtext("Size") or 0),
                        etag=(el.findtext("ETag") or "").strip('"'),
                    )
                )
        return out

    # ---- multipart upload (the dialect's large-object path) ----

    async def initiate_multipart(
        self,
        bucket: str,
        key: str,
        *,
        content_type: str = "",
        user_metadata: dict | None = None,
    ) -> str:
        """x-*-meta- headers on the initiate apply to the completed object
        (both dialects), so streamed puts keep their user metadata."""
        _, body, _ = await self._request(
            "POST", bucket, key, subresource=[("uploads", None)],
            content_type=content_type,
            extra_headers=self._meta_headers(user_metadata),
        )
        upload_id = ET.fromstring(body.decode()).findtext("UploadId") or ""
        if not upload_id:
            raise DialectError("initiate multipart: no UploadId in response")
        return upload_id

    async def upload_part(
        self, bucket: str, key: str, *, upload_id: str, part_number: int, data: bytes
    ) -> str:
        _, _, headers = await self._request(
            "PUT", bucket, key,
            subresource=[("partNumber", str(part_number)), ("uploadId", upload_id)],
            data=data,
        )
        return headers.get("ETag", "").strip('"')

    async def complete_multipart(
        self, bucket: str, key: str, *, upload_id: str, parts: list[tuple[int, str]]
    ) -> str:
        """Returns the COMPLETED object's ETag (the '<hash>-N' form) from the
        CompleteMultipartUploadResult body."""
        body = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>&quot;{etag}&quot;</ETag></Part>"
            for n, etag in parts
        ) + "</CompleteMultipartUpload>"
        _, resp_body, _ = await self._request(
            "POST", bucket, key,
            subresource=[("uploadId", upload_id)],
            data=body.encode(), content_type="application/xml",
        )
        # a 200 carrying an <Error> document (or garbage) is a FAILURE
        try:
            root = ET.fromstring(resp_body.decode())
        except ET.ParseError:
            raise DialectError(
                f"complete multipart: unparseable response {resp_body[:200]!r}"
            )
        if root.tag.endswith("Error"):
            code = root.findtext("Code") or ""
            raise DialectError(f"complete multipart failed: {code}", code=code)
        etag = (root.findtext("ETag") or "").strip('"')
        if not etag:
            raise DialectError(
                f"complete multipart: no ETag in response {resp_body[:200]!r}"
            )
        return etag

    async def abort_multipart(self, bucket: str, key: str, *, upload_id: str) -> None:
        await self._request(
            "DELETE", bucket, key, subresource=[("uploadId", upload_id)]
        )

    def presign_get(self, bucket: str, key: str, *, expires: int = 3600) -> str:
        """Query-signed GET URL (the dialect's legacy presign shape): the
        Expires timestamp replaces the Date line in the string-to-sign."""
        exp = str(int(time.time()) + expires)
        sts = string_to_sign(
            "GET", self._resource(bucket, key), date=exp, dialect=self.dialect
        )
        sig = sign(self.cfg.secret_key, sts)
        return (
            f"{self._url(bucket, key)}?{self.dialect.presign_key_param}="
            f"{quote(self.cfg.access_key, safe='')}&Expires={exp}"
            f"&Signature={quote(sig, safe='')}"
        )
