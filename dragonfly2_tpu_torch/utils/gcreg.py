"""Generic GC task registry.

The port's own copy of dragonfly2_tpu/utils/gcreg.py.

Parity with reference pkg/gc/gc.go:28-70,144: named GC tasks with a per-task
interval and timeout; run-all / run-one; used by the scheduler's resource
managers (peer/task/host TTL sweeps) and the daemon's storage reclaimer.
Async-native here: the runner is an asyncio task per registration.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

logger = logging.getLogger(__name__)


@dataclass
class GCTask:
    id: str
    interval: float
    runner: Callable[[], Awaitable[None] | None]
    timeout: float | None = None
    last_run: float | None = None
    runs: int = 0
    failures: int = 0
    _handle: asyncio.Task | None = field(default=None, repr=False)


class GC:
    def __init__(self) -> None:
        self._tasks: dict[str, GCTask] = {}
        self._started = False

    def add(
        self,
        task_id: str,
        interval: float,
        runner: Callable[[], Awaitable[None] | None],
        *,
        timeout: float | None = None,
    ) -> GCTask:
        if task_id in self._tasks:
            raise ValueError(f"gc task exists: {task_id}")
        if interval <= 0:
            raise ValueError("interval must be > 0")
        t = GCTask(task_id, interval, runner, timeout)
        self._tasks[task_id] = t
        if self._started:
            t._handle = asyncio.ensure_future(self._loop(t))
        return t

    def tasks(self) -> list[GCTask]:
        return list(self._tasks.values())

    async def run(self, task_id: str) -> None:
        await self._run_once(self._tasks[task_id])

    async def run_all(self) -> None:
        await asyncio.gather(*(self._run_once(t) for t in self._tasks.values()))

    async def _run_once(self, t: GCTask) -> None:
        t.last_run = time.monotonic()
        t.runs += 1
        try:
            result = t.runner()
            if inspect.isawaitable(result):
                if t.timeout:
                    await asyncio.wait_for(result, t.timeout)
                else:
                    await result
        except Exception:
            t.failures += 1
            logger.exception("gc task %s failed", t.id)

    async def _loop(self, t: GCTask) -> None:
        while True:
            await asyncio.sleep(t.interval)
            await self._run_once(t)

    def start(self) -> None:
        self._started = True
        for t in self._tasks.values():
            if t._handle is None:
                t._handle = asyncio.ensure_future(self._loop(t))

    def stop(self) -> None:
        self._started = False
        for t in self._tasks.values():
            if t._handle is not None:
                t._handle.cancel()
                t._handle = None
