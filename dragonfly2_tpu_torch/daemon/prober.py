"""Daemon-side RTT prober feeding the scheduler's network topology (the port
of dragonfly2_tpu/daemon/prober.py).

Reference equivalent: the probe collection protocol the reference left
unfinished (SyncProbes stub, scheduler_server_v2.go:153-156; the daemon side
was never written). Each round: report last results via sync_probes, receive
the next target list, measure RTT to each target by timing a TCP connect to
its piece server (the reference planned ICMP ping; TCP connect needs no
privileges and measures the path peers actually use for transfers).
"""

from __future__ import annotations

import asyncio
import logging
import time

logger = logging.getLogger(__name__)

DEFAULT_PROBE_INTERVAL = 20 * 60.0  # ref networktopology probe interval
CONNECT_TIMEOUT = 3.0
SAMPLES_PER_TARGET = 3


async def measure_rtt_ms(ip: str, port: int, *, samples: int = SAMPLES_PER_TARGET) -> float | None:
    """Median TCP-connect time in ms, or None if unreachable."""
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        try:
            _, writer = await asyncio.wait_for(
                asyncio.open_connection(ip, port), CONNECT_TIMEOUT
            )
        except (OSError, asyncio.TimeoutError):
            continue
        times.append((time.perf_counter() - t0) * 1000.0)
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, OSError):
            pass
    if not times:
        return None
    times.sort()
    return times[len(times) // 2]


class Prober:
    def __init__(
        self,
        scheduler,  # SchedulerClient with sync_probes
        host_id: str,
        *,
        interval: float = DEFAULT_PROBE_INTERVAL,
    ):
        self.scheduler = scheduler
        self.host_id = host_id
        self.interval = interval
        self.rounds = 0
        self._task: asyncio.Task | None = None
        self._pending: list[dict] = []  # results to report next round

    async def probe_once(self) -> int:
        """One sync round; returns number of successful measurements."""
        targets = await self.scheduler.sync_probes(self.host_id, self._pending)
        self._pending = []
        ok = 0
        for t in targets or []:
            rtt = await measure_rtt_ms(t["ip"], t["port"])
            if rtt is None:
                self._pending.append(
                    {"dst_host_id": t["host_id"], "rtt_ms": 0.0, "success": False}
                )
            else:
                self._pending.append(
                    {"dst_host_id": t["host_id"], "rtt_ms": rtt, "success": True}
                )
                ok += 1
        # report this round immediately so the topology is fresh even if the
        # process dies before the next tick
        if self._pending:
            await self.scheduler.sync_probes(self.host_id, self._pending)
            self._pending = []
        self.rounds += 1
        return ok

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while True:
            try:
                await self.probe_once()
            except Exception as e:
                logger.warning("probe round failed: %s", e)
            await asyncio.sleep(self.interval)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
