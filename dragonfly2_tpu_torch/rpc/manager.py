"""The manager client's trainer-side subset, from dragonfly2_tpu/rpc/manager.py.

``RemoteManagerClient`` here carries what the port's trainer calls:
``publish_model`` (the trainer service registers each trained model),
``keepalive`` (without the stats frame; the port has no time-series
recorder), ``healthy`` and ``close``. The registry and rollout methods a
scheduler calls wait for the port's scheduler.
"""

from __future__ import annotations

from typing import Any

from dragonfly2_tpu_torch.rpc.core import RpcClient


class RemoteManagerClient:
    def __init__(self, address: str, **kw: Any):
        self._c = RpcClient(address, **kw)

    async def close(self) -> None:
        await self._c.close()

    async def healthy(self) -> bool:
        return await self._c.healthy()

    async def keepalive(self, source_type: str, hostname: str, cluster_id: int | None = None) -> bool:
        return await self._c.call(
            "keepalive", {"source_type": source_type, "hostname": hostname, "cluster_id": cluster_id}
        )

    async def publish_model(self, model_type: str, version: str, **kw: Any) -> dict:
        return await self._c.call("publish_model", {"type": model_type, "version": version, **kw})
