"""Peer-daemon YAML config schema (ref client/config/peerhost.go:176-476), the
port's copy of dragonfly2_tpu/daemon/config.py: one file configures either
package's daemon.

``python -m dragonfly2_tpu_torch.daemon.server --config daemon.yaml``; flags
override file values. Defaults mirror the reference's peerhost defaults
(rate limits at client/config/constants.go:45-47).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from dragonfly2_tpu_torch.observability.tracing import TracingSection
from dragonfly2_tpu_torch.utils.config import cfgfield


@dataclass
class ProxySection:
    port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)
    rules: list[str] = field(default_factory=list)  # regex patterns routed via P2P
    registry_mirror: Optional[str] = cfgfield(None, help="upstream registry URL")
    hijack_ca_dir: Optional[str] = cfgfield(None, help="MITM CA dir for https hijack")
    hijack_hosts: list[str] = field(default_factory=list)
    sni_port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)


@dataclass
class ObjectStorageSection:
    port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)
    root: Optional[str] = cfgfield(None, help="fs backend root dir")
    backend: str = cfgfield("fs", choices=("fs", "s3"))


@dataclass
class StorageSection:
    root: str = cfgfield("~/.dragonfly2_tpu_torch/storage")
    ttl_hours: float = cfgfield(24.0, minimum=0.01)
    capacity_gb: Optional[float] = cfgfield(None, minimum=0.001)
    disk_gc_threshold_pct: Optional[float] = cfgfield(None, minimum=1.0, maximum=100.0)


@dataclass
class RateLimitSection:
    """ref client/config/constants.go:45-47."""

    total_download_mib_per_s: float = cfgfield(1024.0, minimum=0.1, help="host budget, MiB/s")
    per_task_mib_per_s: float = cfgfield(512.0, minimum=0.1, help="per-task cap, MiB/s")


@dataclass
class DaemonYaml:
    scheduler: str = cfgfield("", help="scheduler address host:port (or list a,b)")
    manager: Optional[str] = cfgfield(None)
    sock: str = cfgfield("/tmp/dragonfly2_tpu_daemon.sock")
    ip: str = cfgfield("127.0.0.1")
    hostname: str = cfgfield("")
    seed: bool = cfgfield(False)
    idc: str = cfgfield("")
    location: str = cfgfield("")
    upload_port: int = cfgfield(0, minimum=0, maximum=65535)
    rpc_port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)
    vsock_port: Optional[int] = cfgfield(
        None, minimum=0, maximum=4294967295,
        help="AF_VSOCK RPC port for VM-isolated clients",
    )
    metrics_port: Optional[int] = cfgfield(None, minimum=0, maximum=65535)
    probe_interval: Optional[float] = cfgfield(None, minimum=0.1)
    log_dir: Optional[str] = cfgfield(None, help="rotating per-component log dir")
    data_tls_dir: Optional[str] = cfgfield(
        None, help="tls.crt/tls.key/ca.pem dir: piece plane runs mTLS"
    )
    piece_cipher: Optional[str] = cfgfield(
        None, choices=("aes-gcm", "chacha20"),
        help="pin the data-plane cipher (default: one-shot host probe)",
    )
    storage: StorageSection = cfgfield(default_factory=StorageSection)
    proxy: ProxySection = cfgfield(default_factory=ProxySection)
    object_storage: ObjectStorageSection = cfgfield(default_factory=ObjectStorageSection)
    rate_limit: RateLimitSection = cfgfield(default_factory=RateLimitSection)
    tracing: TracingSection = cfgfield(default_factory=TracingSection)

    def validate_extra(self, path: str) -> None:
        from dragonfly2_tpu_torch.utils.config import ConfigError

        if self.rate_limit.per_task_mib_per_s > self.rate_limit.total_download_mib_per_s:
            raise ConfigError(
                f"{path}.rate_limit.per_task_mib_per_s" if path else "rate_limit.per_task_mib_per_s",
                f"per-task cap {self.rate_limit.per_task_mib_per_s} exceeds host total "
                f"{self.rate_limit.total_download_mib_per_s}",
            )
