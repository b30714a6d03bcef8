"""Management plane: config hub, cluster CRUD, model registry, searcher, jobs.

The port of dragonfly2_tpu/manager/'s registry and RPC front (``db``,
``searcher``, ``jobs``, ``service``, ``config``, ``server``). Its REST front,
CA, object storage, users/OAuth and console are not ported yet.

Reference equivalent: manager/ (manager.go:101, rpcserver/manager_server_v2.go,
searcher/, job/, models/). Persistence is sqlite3 (stdlib) instead of
MySQL+GORM; RPC rides rpc.core.
"""

from dragonfly2_tpu_torch.manager.db import Database
from dragonfly2_tpu_torch.manager.service import ManagerService

__all__ = ["Database", "ManagerService"]
