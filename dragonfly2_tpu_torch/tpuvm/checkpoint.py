"""Checkpoint fan-out over the P2P piece engine (north-star config 4): the
port of dragonfly2_tpu/tpuvm/checkpoint.py; the manifest format is the
reference's, so either package's daemon publishes what the other fetches.

Publisher: import every checkpoint file into the local P2P cache (one
digest-keyed task per file, ref dfcache-import shape) and write a manifest
listing (relative path, size, digest, task id). Fetcher: resolve the manifest
(local file or any URL the source registry handles), pull every file through
the engine — so each host downloads pieces from already-warm peers instead
of the origin — verify digests, and stage into a local directory ready for
`tpuvm.staging.stage_checkpoint_dir` to put on the card.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path

logger = logging.getLogger(__name__)

MANIFEST_NAME = "dragonfly-checkpoint.json"


@dataclass
class ManifestEntry:
    path: str  # relative path inside the checkpoint dir
    size: int
    digest: str  # sha256:<hex>
    task_id: str


@dataclass
class Manifest:
    name: str
    created_at: float
    files: list[ManifestEntry] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "created_at": self.created_at,
                "files": [e.__dict__ for e in self.files],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        d = json.loads(text)
        return cls(
            name=d["name"],
            created_at=d["created_at"],
            files=[ManifestEntry(**e) for e in d["files"]],
        )

    @property
    def total_bytes(self) -> int:
        return sum(e.size for e in self.files)


# Checkpoint-tuned piece size: model shards are large sequential reads, so
# 16 MiB pieces (vs the generic 4 MiB ladder start) quarter the per-piece
# round-trips/digests/announcements on the fan-out path. The generic ladder
# only reaches 16 MiB at 4 GiB files; checkpoints benefit from it immediately.
CHECKPOINT_PIECE_SIZE = 16 << 20


async def publish_checkpoint(
    engine,
    directory: str | Path,
    *,
    name: str = "",
    patterns: tuple[str, ...] = ("*.safetensors", "*.json", "*.model", "*.txt"),
    piece_size: int = CHECKPOINT_PIECE_SIZE,
) -> Manifest:
    """Import a checkpoint directory into the P2P cache; returns the manifest
    (also written into the directory as dragonfly-checkpoint.json)."""
    directory = Path(directory)
    name = name or directory.name
    files: list[Path] = []
    for pat in patterns:
        files.extend(p for p in directory.rglob(pat) if p.is_file() and p.name != MANIFEST_NAME)
    if not files:
        raise FileNotFoundError(f"no checkpoint files under {directory} matching {patterns}")

    manifest = Manifest(name=name, created_at=time.time())
    for p in sorted(set(files)):
        ts = await engine.import_file(p, tag=f"ckpt:{name}", piece_size=piece_size)
        manifest.files.append(
            ManifestEntry(
                path=p.relative_to(directory).as_posix(),
                size=ts.meta.content_length,
                digest=ts.meta.digest,
                task_id=ts.meta.task_id,
            )
        )
        logger.info("published %s (%d bytes) as task %s", p.name, ts.meta.content_length, ts.meta.task_id[:12])
    (directory / MANIFEST_NAME).write_text(manifest.to_json())
    return manifest


async def fetch_checkpoint(
    engine,
    manifest: Manifest,
    dest: str | Path,
    *,
    concurrency: int = 4,
) -> Path:
    """Pull every manifest file through the P2P engine into dest.

    Files already present with matching digests are skipped (piece-level
    resume below that is the engine's own partial-task reuse)."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    dest_resolved = dest.resolve()
    sem = asyncio.Semaphore(concurrency)

    async def fetch_one(entry: ManifestEntry) -> None:
        out = dest / entry.path
        # manifests can come from any URL: refuse traversal outside dest
        if not out.resolve().is_relative_to(dest_resolved):
            raise ValueError(f"manifest entry escapes destination: {entry.path!r}")
        if out.exists() and out.stat().st_size == entry.size:
            from dragonfly2_tpu_torch.utils import digest as digestlib

            def _ok() -> bool:
                with open(out, "rb") as f:
                    return str(digestlib.compute_file("sha256", f)) == entry.digest

            if await asyncio.to_thread(_ok):
                logger.info("%s: already staged", entry.path)
                return
        async with sem:
            # cache-content URL: the task is keyed by digest, any holder serves
            await engine.download_task(
                f"d7y://cache/{entry.task_id}",
                output=out,
                tag="ckpt",
                digest=entry.digest,
            )
            logger.info("%s: fetched %d bytes via p2p", entry.path, entry.size)

    # first failure cancels the remaining fetches instead of leaving multi-GB
    # downloads running detached after the error returns (TaskGroup semantics;
    # utils.aio provides them before Python 3.11)
    from dragonfly2_tpu_torch.utils.aio import gather_all_cancel_on_error

    await gather_all_cancel_on_error(fetch_one(e) for e in manifest.files)
    (dest / MANIFEST_NAME).write_text(manifest.to_json())
    return dest


async def fetch_manifest(engine, url_or_path: str) -> Manifest:
    """Load a manifest from a local path or any URL the source registry
    supports (http(s)/file)."""
    p = Path(url_or_path)
    if p.exists():
        return Manifest.from_json(p.read_text())
    chunks = []
    async for chunk in engine.sources.download(url_or_path):
        chunks.append(chunk)
    return Manifest.from_json(b"".join(chunks).decode())
