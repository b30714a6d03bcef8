"""Dynconfig: cached remote config with disk cache, TTL refresh, observers.

The port's own copy of dragonfly2_tpu/utils/dynconfig.py.

Reference equivalent: internal/dynconfig/dynconfig.go:44-78 (generic cached
manager-sourced config; specialized by scheduler/config/dynconfig.go and
client/config/dynconfig_manager.go). Fetch from the manager, persist a disk
cache so services boot while the manager is down, refresh on a TTL, and
notify registered observers on change.

Manager-outage autonomy: the disk cache is STALENESS-STAMPED —
`{"data": ..., "saved_at": unix_time}` — so a consumer serving through a
manager blackout can say (and export) exactly how old its last-good snapshot
is, instead of presenting cached config as fresh. `staleness_s()` answers
the age; `from_cache` says whether the current data ever confirmed against
the manager this process lifetime. The module-level `store_snapshot` /
`load_snapshot` helpers share the same stamped format with other last-good
caches (the daemon's scheduler address book).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Awaitable, Callable

logger = logging.getLogger(__name__)

Fetcher = Callable[[], Awaitable[dict]]
Observer = Callable[[dict], None]


@dataclass
class Snapshot:
    """One staleness-stamped last-good cache entry."""

    data: dict
    saved_at: float  # unix time the data was last confirmed fresh

    def staleness_s(self, now: float | None = None) -> float:
        now = now if now is not None else time.time()
        return max(0.0, now - self.saved_at)


def store_snapshot(path: str | Path, data: dict) -> None:
    """Atomically persist `data` with a freshness stamp (tmp + rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"data": data, "saved_at": time.time()}))
    tmp.replace(path)


def load_snapshot(path: str | Path) -> Snapshot | None:
    """Read a stamped snapshot; a legacy plain-dict cache (pre-stamp format)
    still loads, aged by its file mtime. None on missing/corrupt."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        raw = json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if not isinstance(raw, dict):
        return None
    if "data" in raw and "saved_at" in raw:
        data = raw["data"]
        if not isinstance(data, dict):
            return None
        try:
            return Snapshot(data, float(raw["saved_at"]))
        except (TypeError, ValueError):
            return None
    try:
        mtime = path.stat().st_mtime
    except OSError:
        mtime = 0.0
    return Snapshot(raw, mtime)


class Dynconfig:
    def __init__(
        self,
        fetch: Fetcher,
        *,
        cache_path: str | Path | None = None,
        refresh_interval: float = 60.0,
    ):
        self._fetch = fetch
        self.cache_path = Path(cache_path) if cache_path else None
        self.refresh_interval = refresh_interval
        self._data: dict = {}
        self._observers: list[Observer] = []
        self._task: asyncio.Task | None = None
        self._loaded_at = 0.0  # when _data was last confirmed fresh
        # True while _data came from the disk cache and has NOT been
        # confirmed against the manager this process lifetime
        self.from_cache = False

    @property
    def data(self) -> dict:
        return self._data

    def staleness_s(self, now: float | None = None) -> float | None:
        """Age of the current config: seconds since the last successful
        manager fetch, or — when serving from the disk cache — since that
        cache was written. None before any load succeeded at all."""
        if not self._loaded_at:
            return None
        now = now if now is not None else time.time()
        return max(0.0, now - self._loaded_at)

    def register(self, observer: Observer) -> None:
        """Observer fires on every successful refresh that changes the data."""
        self._observers.append(observer)

    async def load(self) -> dict:
        """Initial load: remote first, disk cache fallback (ref Get path).

        Observers always fire once here — refresh() only notifies on change,
        and consumers wired purely via register() must still see the boot
        config even when it came from the disk cache."""
        notified = False
        try:
            notified = await self.refresh()
        except Exception as e:
            if not self._load_cache():
                raise
            logger.warning(
                "dynconfig: using disk cache (age %.0fs), fetch failed: %s",
                self.staleness_s() or 0.0, e,
            )
        if not notified:
            self._notify()
        return self._data

    async def refresh(self) -> bool:
        """Fetch; returns True when the config changed."""
        data = await self._fetch()
        self._loaded_at = time.time()
        self.from_cache = False
        if data == self._data:
            return False
        self._data = data
        self._store_cache()
        self._notify()
        return True

    def _notify(self) -> None:
        for obs in self._observers:
            try:
                obs(self._data)
            except Exception:
                logger.exception("dynconfig observer failed")

    def _load_cache(self) -> bool:
        if self.cache_path is None:
            return False
        snap = load_snapshot(self.cache_path)
        if snap is None:
            return False
        self._data = snap.data
        self._loaded_at = snap.saved_at
        self.from_cache = True
        return True

    def _store_cache(self) -> None:
        if self.cache_path is None:
            return
        store_snapshot(self.cache_path, self._data)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.refresh_interval)
            try:
                await self.refresh()
            except Exception as e:
                logger.warning("dynconfig refresh failed: %s", e)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
