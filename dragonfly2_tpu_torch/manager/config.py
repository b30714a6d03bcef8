"""Manager YAML config schema (ref manager/config/config.go): the port's own
copy of dragonfly2_tpu/manager/config.py.

``python -m dragonfly2_tpu_torch.manager.server --config manager.yaml``; flags
override file values. Secrets fall back to DRAGONFLY_* env vars when absent
from both file and flags. The schema is the reference's, so one file serves
either package; ``rest_port`` defaults to off here (the reference binds 9201
when the file names none): the port's manager serves REST only when asked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dragonfly2_tpu_torch.observability.tracing import TracingSection
from dragonfly2_tpu_torch.utils.config import cfgfield


@dataclass
class SecuritySection:
    ca_dir: Optional[str] = cfgfield(None, help="enable the cluster CA (cert issuance)")
    cert_token: Optional[str] = cfgfield(None, help="bootstrap token for cert issuance")
    auth_secret: Optional[str] = cfgfield(None, help="HMAC secret for REST bearer tokens")
    admin_password: Optional[str] = cfgfield(None, help="bootstrap admin user")


@dataclass
class ManagerYaml:
    db: str = cfgfield(":memory:")
    host: str = cfgfield("127.0.0.1")
    port: int = cfgfield(9200, minimum=0, maximum=65535)
    rest_port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)
    metrics_port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)
    keepalive_ttl: float = cfgfield(60.0, minimum=1.0)
    log_dir: Optional[str] = cfgfield(None, help="rotating per-component log dir")
    object_storage_dir: Optional[str] = cfgfield(
        None, help="enable buckets CRUD backed by this fs dir"
    )
    searcher: str = cfgfield(
        "default", help='cluster searcher: "default" or "plugin:pkg.mod:attr"'
    )
    security: SecuritySection = cfgfield(default_factory=SecuritySection)
    tracing: TracingSection = cfgfield(default_factory=TracingSection)
