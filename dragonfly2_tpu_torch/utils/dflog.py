"""Rotating per-component structured logging.

The port's own copy of dragonfly2_tpu/utils/dflog.py.

Parity with reference internal/dflog (logcore.go:25-64, logger.go:33-79):
zap SugaredLoggers per component (core / gc / storage-gc / grpc / job …)
with lumberjack rotation and WithPeer/WithTask context. Python-native here:
stdlib logging with per-component RotatingFileHandlers under one log dir, a
key=value context formatter, and `with_context` adapters that stamp
peer/task/host ids onto every line a subsystem emits.

Services call setup_logging() at boot (--log-dir / YAML); without a log dir
everything stays on the console exactly as before — file logging is opt-in,
matching the reference's console+file default.
"""

from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path
from typing import Any, Mapping

# component -> logger-name prefixes routed to its file (ref logcore.go's
# CoreLogger / GrpcLogger / GCLogger split); the reference's storage, daemon
# and manager components have no module in the port yet
COMPONENT_PREFIXES: dict[str, tuple[str, ...]] = {
    "core": (),  # fallback for everything unmatched
    "rpc": ("dragonfly2_tpu_torch.rpc",),
    "gc": ("dragonfly2_tpu_torch.utils.gcreg",),
    "scheduler": ("dragonfly2_tpu_torch.scheduler", "scheduler"),
    "trainer": ("dragonfly2_tpu_torch.trainer",),
}

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


class _ComponentFilter(logging.Filter):
    """Route records to exactly one component file: the longest matching
    prefix wins; `core` takes what nothing else claimed."""

    def __init__(self, component: str):
        super().__init__()
        self.component = component

    def filter(self, record: logging.LogRecord) -> bool:
        best = "core"
        best_len = -1
        for comp, prefixes in COMPONENT_PREFIXES.items():
            for p in prefixes:
                if record.name.startswith(p) and len(p) > best_len:
                    best, best_len = comp, len(p)
        return best == self.component


def setup_logging(
    log_dir: str | Path | None = None,
    *,
    level: int = logging.INFO,
    max_bytes: int = 4 << 20,
    backups: int = 5,
    console: bool = True,
) -> list[logging.Handler]:
    """Install console + per-component rotating file handlers on the root
    logger (idempotent: previously-installed dflog handlers are replaced)."""
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        if getattr(h, "_dflog", False):
            root.removeHandler(h)
            h.close()
    installed: list[logging.Handler] = []
    if console and not any(
        isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
        for h in root.handlers
    ):
        ch = logging.StreamHandler()
        ch.setFormatter(logging.Formatter(_FORMAT))
        ch._dflog = True
        root.addHandler(ch)
        installed.append(ch)
    if log_dir is not None:
        d = Path(log_dir)
        d.mkdir(parents=True, exist_ok=True)
        for component in COMPONENT_PREFIXES:
            fh = logging.handlers.RotatingFileHandler(
                d / f"{component}.log", maxBytes=max_bytes, backupCount=backups
            )
            fh.setFormatter(logging.Formatter(_FORMAT))
            fh.addFilter(_ComponentFilter(component))
            fh._dflog = True
            root.addHandler(fh)
            installed.append(fh)
    return installed


class ContextAdapter(logging.LoggerAdapter):
    """Stamps key=value context onto every line (ref dflog WithPeer /
    WithTask / WithHost: structured peer/task context on each record)."""

    def process(self, msg: Any, kwargs: Mapping[str, Any]):
        ctx = " ".join(f"{k}={v}" for k, v in (self.extra or {}).items())
        return (f"[{ctx}] {msg}", kwargs) if ctx else (msg, kwargs)


def with_context(logger: logging.Logger, **ctx: Any) -> ContextAdapter:
    """`log = with_context(logger, task_id=tid[:12], peer_id=pid)` — every
    later log line carries the ids without repeating them at call sites."""
    short = {
        k: (v[:16] if isinstance(v, str) and len(v) > 16 else v) for k, v in ctx.items()
    }
    return ContextAdapter(logger, short)
