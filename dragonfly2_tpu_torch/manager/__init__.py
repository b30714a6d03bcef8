"""Management plane: config hub, cluster CRUD, model registry, searcher, jobs.

The port of dragonfly2_tpu/manager/, whole: the registry and RPC front
(``db``, ``searcher``, ``jobs``, ``service``, ``config``, ``server``) and the
REST front (``rest``, with ``preheat``, ``oauth`` and ``console``).

Reference equivalent: manager/ (manager.go:101, rpcserver/manager_server_v2.go,
searcher/, job/, models/). Persistence is sqlite3 (stdlib) instead of
MySQL+GORM; RPC rides rpc.core.
"""

from dragonfly2_tpu_torch.manager.db import Database
from dragonfly2_tpu_torch.manager.service import ManagerService

__all__ = ["Database", "ManagerService"]
