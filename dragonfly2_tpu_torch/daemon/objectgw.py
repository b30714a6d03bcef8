"""Object-storage HTTP gateway on the peer daemon, backing dfstore: the port
of dragonfly2_tpu/daemon/objectgw.py, the same routes, so either package's
dfstore drives either package's gateway.

Parity with reference client/daemon/objectstorage/objectstorage.go (gin
gateway: GetObject streams through the peer engine with the signed backend
URL as origin; PutObject writes to the backend and fans the content out via
the P2P seed path) — re-shaped on aiohttp with the pluggable
`objectstorage.backend` instead of S3-only.

Routes (dfstore's wire API):
  GET    /healthz
  GET    /buckets                                  list buckets
  PUT    /buckets/{bucket}                         create bucket
  DELETE /buckets/{bucket}                         delete bucket
  GET    /buckets/{b}/objects                      list objects (?prefix=)
  GET    /buckets/{b}/objects/{key:.+}             get (P2P by default, ?mode=direct to bypass)
  HEAD   /buckets/{b}/objects/{key:.+}             metadata
  PUT    /buckets/{b}/objects/{key:.+}             put (?seed=1 to pre-populate P2P cache)
  DELETE /buckets/{b}/objects/{key:.+}             delete
"""

from __future__ import annotations

import logging
from typing import Optional

from aiohttp import web

from dragonfly2_tpu_torch.objectstorage import ObjectStorageBackend, ObjectStorageError

logger = logging.getLogger(__name__)

_STATUS = {"not_found": 404, "already_exists": 409, "invalid": 400, "internal": 500}


class ObjectGateway:
    def __init__(
        self,
        engine,
        backend: ObjectStorageBackend,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.engine = engine
        self.backend = backend
        self.host = host
        self.port = port
        self._runner: Optional[web.AppRunner] = None

    def app(self) -> web.Application:
        app = web.Application(client_max_size=1 << 30)
        r = app.router
        r.add_get("/healthz", self._healthz)
        r.add_get("/buckets", self._list_buckets)
        r.add_put("/buckets/{bucket}", self._create_bucket)
        r.add_delete("/buckets/{bucket}", self._delete_bucket)
        r.add_get("/buckets/{bucket}/objects", self._list_objects)
        r.add_get("/buckets/{bucket}/objects/{key:.+}", self._get_object, allow_head=False)
        r.add_head("/buckets/{bucket}/objects/{key:.+}", self._head_object)
        r.add_put("/buckets/{bucket}/objects/{key:.+}", self._put_object)
        r.add_delete("/buckets/{bucket}/objects/{key:.+}", self._delete_object)
        return app

    async def start(self) -> None:
        self._runner = web.AppRunner(self.app(), access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            self.port = site._server.sockets[0].getsockname()[1]  # type: ignore[union-attr]
        logger.info("object gateway on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        await self.backend.close()  # s3/oss/obs hold an aiohttp session

    # ---- handlers ----

    @staticmethod
    def _err(e: ObjectStorageError) -> web.Response:
        return web.json_response(
            {"error": str(e), "code": e.code}, status=_STATUS.get(e.code, 500)
        )

    async def _healthz(self, _req: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def _list_buckets(self, _req: web.Request) -> web.Response:
        buckets = await self.backend.list_buckets()
        return web.json_response(
            {"buckets": [{"name": b.name, "created_at": b.created_at} for b in buckets]}
        )

    async def _create_bucket(self, req: web.Request) -> web.Response:
        try:
            await self.backend.create_bucket(req.match_info["bucket"])
        except ObjectStorageError as e:
            return self._err(e)
        return web.json_response({"ok": True}, status=201)

    async def _delete_bucket(self, req: web.Request) -> web.Response:
        try:
            await self.backend.delete_bucket(req.match_info["bucket"])
        except ObjectStorageError as e:
            return self._err(e)
        return web.json_response({"ok": True})

    async def _list_objects(self, req: web.Request) -> web.Response:
        try:
            limit_s = req.query.get("limit", "")
            limit = max(1, int(limit_s)) if limit_s else None
        except ValueError:
            return web.json_response({"error": "limit must be an integer"}, status=400)
        try:
            objs = await self.backend.list_objects(
                req.match_info["bucket"], prefix=req.query.get("prefix", ""), limit=limit
            )
        except ObjectStorageError as e:
            return self._err(e)
        return web.json_response(
            {
                "objects": [
                    {
                        "key": o.key,
                        "content_length": o.content_length,
                        "digest": o.digest,
                        "etag": o.etag,
                    }
                    for o in objs
                ]
            }
        )

    async def _head_object(self, req: web.Request) -> web.Response:
        try:
            meta = await self.backend.stat_object(
                req.match_info["bucket"], req.match_info["key"]
            )
        except ObjectStorageError as e:
            return web.Response(status=_STATUS.get(e.code, 500))
        return web.Response(
            headers={
                "Content-Length": str(meta.content_length),
                "Content-Type": meta.content_type,
                "ETag": meta.etag,
                "X-Dragonfly-Digest": meta.digest,
            }
        )

    async def _stream_direct(
        self, req: web.Request, bucket: str, key: str, meta
    ) -> web.StreamResponse:
        """Stream straight from the backend — the direct mode and the
        p2p-failure fallback must not hold a multi-GB object in RAM. The
        first chunk is pulled BEFORE headers go out so backend errors still
        map to JSON error responses."""
        agen = self.backend.get_object_stream(bucket, key)
        try:
            try:
                first = await anext(agen, b"")
            except ObjectStorageError as e:
                return self._err(e)
            # chunked, no Content-Length: the length came from an earlier
            # stat and a concurrent overwrite would desynchronize the framing
            resp = web.StreamResponse(
                headers={"Content-Type": meta.content_type, "ETag": meta.etag}
            )
            resp.enable_chunked_encoding()
            await resp.prepare(req)
            if first:
                await resp.write(first)
            async for chunk in agen:
                await resp.write(chunk)
            await resp.write_eof()
            return resp
        finally:
            # early return, backend error, or client disconnect must not
            # leave the backend's HTTP response open until GC
            await agen.aclose()

    async def _get_object(self, req: web.Request) -> web.StreamResponse:
        bucket, key = req.match_info["bucket"], req.match_info["key"]
        try:
            meta = await self.backend.stat_object(bucket, key)
        except ObjectStorageError as e:
            return self._err(e)
        if req.query.get("mode") == "direct":
            return await self._stream_direct(req, bucket, key, meta)
        # P2P path: the backend's presigned URL is the back-to-source origin,
        # so every daemon in the cluster dedupes this object as one task
        # (ref objectstorage.go GetObject → StartStreamTask with signed URL)
        try:
            origin = self.backend.presign_get(bucket, key)
            length, body = await self.engine.stream_task(origin, digest=meta.digest)
        except Exception as e:
            logger.warning("p2p object get %s/%s failed (%s); direct read", bucket, key, e)
            return await self._stream_direct(req, bucket, key, meta)
        resp = web.StreamResponse(
            headers={
                "Content-Length": str(length),
                "Content-Type": meta.content_type,
                "ETag": meta.etag,
                "X-Dragonfly-Via": "p2p",
            }
        )
        await resp.prepare(req)
        async for chunk in body:
            await resp.write(chunk)
        await resp.write_eof()
        return resp

    async def _put_object(self, req: web.Request) -> web.Response:
        bucket, key = req.match_info["bucket"], req.match_info["key"]
        try:
            # stream the body: multi-GB artifacts never sit fully in RAM
            meta = await self.backend.put_object(
                bucket,
                key,
                req.content.iter_chunked(1 << 20),
                content_type=req.content_type or "application/octet-stream",
            )
        except ObjectStorageError as e:
            return self._err(e)
        seeded = False
        if req.query.get("seed") in ("1", "true"):
            # pre-populate the P2P cache so first readers hit peers, not the
            # backend (ref PutObject's seed fan-out)
            try:
                origin = self.backend.presign_get(bucket, key)
                await self.engine.download_task(origin, seed=True, digest=meta.digest)
                seeded = True
            except Exception:
                logger.exception("seeding object %s/%s failed", bucket, key)
        return web.json_response(
            {
                "key": key,
                "content_length": meta.content_length,
                "digest": meta.digest,
                "etag": meta.etag,
                "seeded": seeded,
            },
            status=201,
        )

    async def _delete_object(self, req: web.Request) -> web.Response:
        try:
            await self.backend.delete_object(req.match_info["bucket"], req.match_info["key"])
        except ObjectStorageError as e:
            return self._err(e)
        return web.json_response({"ok": True})
