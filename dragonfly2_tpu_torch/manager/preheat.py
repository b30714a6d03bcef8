"""Preheat producer: resolve a preheat request into origin URLs, dispatch a job.

Reference equivalent: manager/job/preheat.go:54-107 — `file` type preheats one
URL; `image` type fetches the registry manifest, extracts layer digests, and
preheats every layer blob URL (preheat.go:105-165 getLayers/parseManifests).
OCI/Docker v2 manifest schema only; manifest lists recurse one level.

The port of dragonfly2_tpu/manager/preheat.py.
"""

from __future__ import annotations

import logging
import re

import aiohttp

from dragonfly2_tpu_torch.manager.jobs import JOB_TYPE_PREHEAT, JobQueue

logger = logging.getLogger(__name__)

# registry image URL: https://registry/v2/<name>/manifests/<tag>
_IMAGE_URL = re.compile(r"^(?P<base>https?://[^/]+)/v2/(?P<name>.+)/manifests/(?P<tag>[^/]+)$")

MANIFEST_MEDIA_TYPES = (
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
)


async def resolve_image_layers(
    url: str, *, headers: dict[str, str] | None = None, timeout: float = 60.0
) -> list[str]:
    """Manifest URL -> layer blob URLs (ref preheat.go getLayers)."""
    m = _IMAGE_URL.match(url)
    if not m:
        raise ValueError(f"not an image manifest URL: {url}")
    base, name = m.group("base"), m.group("name")
    req_headers = {"Accept": ", ".join(MANIFEST_MEDIA_TYPES), **(headers or {})}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=timeout)) as sess:
        async with sess.get(url, headers=req_headers) as resp:
            resp.raise_for_status()
            manifest = await resp.json(content_type=None)
        manifests = [manifest]
        if "manifests" in manifest:  # manifest list / OCI index: recurse once
            manifests = []
            for entry in manifest["manifests"]:
                sub = f"{base}/v2/{name}/manifests/{entry['digest']}"
                async with sess.get(sub, headers=req_headers) as resp:
                    resp.raise_for_status()
                    manifests.append(await resp.json(content_type=None))
    urls = []
    for mf in manifests:
        for layer in mf.get("layers", []):
            urls.append(f"{base}/v2/{name}/blobs/{layer['digest']}")
    return urls


class PreheatProducer:
    def __init__(self, jobs: JobQueue):
        self.jobs = jobs

    async def create_preheat(
        self,
        preheat_type: str,
        url: str,
        *,
        scheduler_cluster_ids: list[int],
        tag: str = "",
        filters: list[str] | None = None,
        headers: dict[str, str] | None = None,
    ) -> dict:
        """ref CreatePreheat (preheat.go:54): file → [url]; image → layer urls."""
        if preheat_type == "image":
            urls = await resolve_image_layers(url, headers=headers)
            if not urls:
                raise ValueError(f"image manifest at {url} has no layers")
        elif preheat_type == "file":
            urls = [url]
        else:
            raise ValueError(f"unknown preheat type {preheat_type!r}")
        return await self.jobs.create(
            JOB_TYPE_PREHEAT,
            {"urls": urls, "tag": tag, "filters": filters or [], "headers": headers or {}},
            scheduler_cluster_ids=scheduler_cluster_ids,
        )
