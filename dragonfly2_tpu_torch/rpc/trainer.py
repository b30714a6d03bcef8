"""Trainer RPC adapters, the port of dragonfly2_tpu/rpc/trainer.py (ref
pkg/rpc/trainer client/server: the Train client-stream contract,
server.go:41-90, unrolled as open/chunk/close), over the port's
TrainerService."""

from __future__ import annotations

from typing import Any

import numpy as np

from dragonfly2_tpu_torch.rpc.core import RpcClient, RpcServer
from dragonfly2_tpu_torch.trainer.service import TrainerService, pack_records

TRAINER_METHODS = [
    "train_open", "train_chunk", "train_close", "status", "train_history",
]


def register_trainer(server: RpcServer, service: TrainerService) -> None:
    server.register_service(service, TRAINER_METHODS)


class RemoteTrainerClient:
    def __init__(self, address: str, **kw: Any):
        self._c = RpcClient(address, **kw)

    async def close(self) -> None:
        await self._c.close()

    async def healthy(self) -> bool:
        return await self._c.healthy()

    async def train_open(self, hostname: str = "", scheduler_id: int = 0) -> str:
        out = await self._c.call("train_open", {"hostname": hostname, "scheduler_id": scheduler_id})
        return out["token"]

    async def train_chunk(self, token: str, kind: str, records: np.ndarray) -> int:
        out = await self._c.call(
            "train_chunk", {"token": token, "kind": kind, "data": pack_records(records)}
        )
        return out["rows"]

    async def train_close(self, token: str) -> None:
        await self._c.call("train_close", {"token": token})

    async def status(self) -> dict:
        return await self._c.call("status")

    async def train_history(self, *, limit: int = 64, with_curves: bool = True) -> dict:
        """Per-run manifests: run id, dataset size, per-model steps / final
        loss / bounded loss curve, wall seconds."""
        return await self._c.call("train_history", {"limit": limit, "with_curves": with_curves})
