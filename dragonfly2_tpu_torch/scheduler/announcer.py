"""Scheduler announcer: periodic telemetry upload to the trainer.

The port of dragonfly2_tpu/scheduler/announcer.py. Reference equivalent:
scheduler/announcer/announcer.go:124-259 — a ticker (default every 7 days,
1 h timeout, config/constants.go:183-190) opens one Train stream and
uploads the download CSV as TrainMLPRequest chunks and the topology CSV as
TrainGNNRequest chunks. Here: one train_open session per cycle, columnar
arrays chunked by row count, then train_close kicks training. It speaks the
JAX package's wire protocol, so it uploads to either package's trainer.
"""

from __future__ import annotations

import asyncio
import logging

from dragonfly2_tpu_torch.observability.tracing import default_tracer
from dragonfly2_tpu_torch.rpc.trainer import RemoteTrainerClient
from dragonfly2_tpu_torch.telemetry import TelemetryStorage

logger = logging.getLogger(__name__)

DEFAULT_INTERVAL = 7 * 24 * 3600.0  # ref DefaultTrainerInterval
UPLOAD_TIMEOUT = 3600.0             # ref DefaultTrainerUploadTimeout
CHUNK_ROWS = 4096


class TrainerAnnouncer:
    def __init__(
        self,
        telemetry: TelemetryStorage,
        trainer_addr: str,
        *,
        hostname: str = "",
        scheduler_id: int = 0,
        interval: float = DEFAULT_INTERVAL,
        clear_after_upload: bool = True,
    ):
        self.telemetry = telemetry
        self.trainer = RemoteTrainerClient(trainer_addr)
        self.hostname = hostname
        self.scheduler_id = scheduler_id
        self.interval = interval
        self.clear_after_upload = clear_after_upload
        self._task: asyncio.Task | None = None
        self.uploads = 0

    async def upload_once(self) -> dict:
        """One full cycle: open session, chunk both stores, close.

        The stores are cut with snapshot() before the first RPC: the upload
        awaits many round trips, and telemetry appended meanwhile must NOT be
        dropped by the post-upload clear — only the files actually uploaded
        are discarded."""
        # the trace root of the ML plane: the upload starts a chain (trainer
        # ingest → train run → model activation) that no download trace covers
        with default_tracer().span("announcer.upload", scheduler=self.hostname or "scheduler") as sp:
            downloads, dl_cut = self.telemetry.downloads.snapshot()
            probes, pr_cut = self.telemetry.probes.snapshot()
            token = await self.trainer.train_open(self.hostname, self.scheduler_id)
            rows = 0
            for kind, arr in (("downloads", downloads), ("probes", probes)):
                for start in range(0, len(arr), CHUNK_ROWS):
                    rows = await self.trainer.train_chunk(  # dflint: disable=DF025 already batched: each call ships CHUNK_ROWS rows (one frame-budget-sized chunk per trip)
                        token, kind, arr[start : start + CHUNK_ROWS]
                    )
            await self.trainer.train_close(token)
            if self.clear_after_upload:
                # dataset handed off; drop exactly the snapshot — rows that
                # arrived mid-upload stay for the next cycle
                self.telemetry.downloads.discard(dl_cut)
                self.telemetry.probes.discard(pr_cut)
            self.uploads += 1
            sp.set_attr("rows", rows)
            sp.set_attr("downloads", len(downloads))
            sp.set_attr("probes", len(probes))
        logger.info("uploaded %d telemetry rows to trainer", rows)
        return {"rows": rows, "downloads": len(downloads), "probes": len(probes)}

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await asyncio.wait_for(self.upload_once(), UPLOAD_TIMEOUT)
            except Exception as e:
                logger.warning("trainer upload failed: %s", e)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.trainer.close()
