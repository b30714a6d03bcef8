"""Manager persistence on sqlite3.

The port's own copy of dragonfly2_tpu/manager/db.py.

Reference equivalent: manager/models/*.go (GORM on MySQL/MariaDB) +
manager/database/database.go. Schema parity: scheduler_clusters
(scheduler_cluster.go:19-30: name, config, client_config, scopes,
is_default), schedulers (scheduler.go:27-40: hostname/idc/location/ip/port,
active|inactive state, features, cluster fk), seed_peer_clusters +
seed_peers, applications, configs, models (model.go:28-45: GNN|MLP type,
version, active|inactive state, evaluation JSON, unique per
(scheduler_id, type, version)), users, jobs.

sqlite is plenty for a config hub (the reference's MySQL holds hundreds of
rows); one writer lock serializes mutations, reads are lock-free snapshots.
JSON maps live in TEXT columns, (de)serialized at the DAO boundary.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, Optional

SCHEMA = """
CREATE TABLE IF NOT EXISTS scheduler_clusters (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    bio TEXT NOT NULL DEFAULT '',
    config TEXT NOT NULL DEFAULT '{}',
    client_config TEXT NOT NULL DEFAULT '{}',
    scopes TEXT NOT NULL DEFAULT '{}',
    is_default INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS schedulers (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    hostname TEXT NOT NULL,
    idc TEXT NOT NULL DEFAULT '',
    location TEXT NOT NULL DEFAULT '',
    ip TEXT NOT NULL,
    port INTEGER NOT NULL,
    state TEXT NOT NULL DEFAULT 'inactive',
    features TEXT NOT NULL DEFAULT '[]',
    scheduler_cluster_id INTEGER NOT NULL REFERENCES scheduler_clusters(id),
    last_keepalive REAL NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE (hostname, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS seed_peer_clusters (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    bio TEXT NOT NULL DEFAULT '',
    config TEXT NOT NULL DEFAULT '{}',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS seed_peer_cluster_links (
    seed_peer_cluster_id INTEGER NOT NULL REFERENCES seed_peer_clusters(id),
    scheduler_cluster_id INTEGER NOT NULL REFERENCES scheduler_clusters(id),
    PRIMARY KEY (seed_peer_cluster_id, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS seed_peers (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    hostname TEXT NOT NULL,
    type TEXT NOT NULL DEFAULT 'super',
    idc TEXT NOT NULL DEFAULT '',
    location TEXT NOT NULL DEFAULT '',
    ip TEXT NOT NULL,
    port INTEGER NOT NULL,
    download_port INTEGER NOT NULL DEFAULT 0,
    object_storage_port INTEGER NOT NULL DEFAULT 0,
    state TEXT NOT NULL DEFAULT 'inactive',
    seed_peer_cluster_id INTEGER NOT NULL REFERENCES seed_peer_clusters(id),
    last_keepalive REAL NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE (hostname, seed_peer_cluster_id)
);
CREATE TABLE IF NOT EXISTS applications (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    url TEXT NOT NULL DEFAULT '',
    bio TEXT NOT NULL DEFAULT '',
    priority TEXT NOT NULL DEFAULT '{}',
    user_id INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS configs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    value TEXT NOT NULL DEFAULT '{}',
    bio TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS models (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    type TEXT NOT NULL,
    bio TEXT NOT NULL DEFAULT '',
    version TEXT NOT NULL,
    state TEXT NOT NULL DEFAULT 'inactive',
    evaluation TEXT NOT NULL DEFAULT '{}',
    artifact_path TEXT NOT NULL DEFAULT '',
    artifact_digest TEXT NOT NULL DEFAULT '',
    rollout TEXT NOT NULL DEFAULT '{}',
    scheduler_id INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE (type, version, scheduler_id)
);
CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    email TEXT NOT NULL DEFAULT '',
    password_hash TEXT NOT NULL DEFAULT '',
    role TEXT NOT NULL DEFAULT 'guest',
    state TEXT NOT NULL DEFAULT 'enable',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS oauth (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    bio TEXT NOT NULL DEFAULT '',
    client_id TEXT NOT NULL,
    client_secret TEXT NOT NULL,
    auth_url TEXT NOT NULL,
    token_url TEXT NOT NULL,
    user_info_url TEXT NOT NULL DEFAULT '',
    scopes TEXT NOT NULL DEFAULT '[]',
    redirect_url TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS jobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    task_id TEXT NOT NULL DEFAULT '',
    type TEXT NOT NULL,
    state TEXT NOT NULL DEFAULT 'PENDING',
    args TEXT NOT NULL DEFAULT '{}',
    result TEXT NOT NULL DEFAULT '{}',
    user_id INTEGER NOT NULL DEFAULT 0,
    scheduler_cluster_ids TEXT NOT NULL DEFAULT '[]',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
"""

_JSON_COLS = {
    "config", "client_config", "scopes", "priority", "value", "evaluation",
    "features", "args", "result", "scheduler_cluster_ids", "rollout",
}

# Columns added after a table first shipped: CREATE TABLE IF NOT EXISTS
# won't touch an existing on-disk DB, so boot applies these additively
# (ALTER TABLE ADD COLUMN is a no-op failure when the column exists).
_MIGRATIONS = (
    "ALTER TABLE models ADD COLUMN artifact_digest TEXT NOT NULL DEFAULT ''",
    "ALTER TABLE models ADD COLUMN rollout TEXT NOT NULL DEFAULT '{}'",
)


def _encode(fields: dict[str, Any]) -> dict[str, Any]:
    out = {}
    for k, v in fields.items():
        if k in _JSON_COLS and not isinstance(v, str):
            v = json.dumps(v)
        elif isinstance(v, bool):
            v = int(v)
        out[k] = v
    return out


def _decode(row: sqlite3.Row) -> dict[str, Any]:
    out = dict(row)
    for k in out:
        if k in _JSON_COLS and isinstance(out[k], str):
            try:
                out[k] = json.loads(out[k])
            except json.JSONDecodeError:
                pass
    if "is_default" in out:
        out["is_default"] = bool(out["is_default"])
    return out


class Database:
    """One connection, check_same_thread off, writer lock; WAL for readers."""

    def __init__(self, path: str | Path = ":memory:"):
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        with self._lock:
            if self.path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.executescript(SCHEMA)
            for mig in _MIGRATIONS:
                try:
                    self._conn.execute(mig)
                except sqlite3.OperationalError:
                    pass  # column already there (fresh schema or prior boot)
            self._conn.commit()

    def close(self) -> None:
        self._conn.close()

    # ---- generic CRUD ----

    def insert(self, table: str, **fields: Any) -> int:
        now = time.time()
        fields = _encode({**fields, "created_at": now, "updated_at": now})
        cols = ", ".join(fields)
        ph = ", ".join("?" * len(fields))
        with self._lock:
            cur = self._conn.execute(
                f"INSERT INTO {table} ({cols}) VALUES ({ph})", tuple(fields.values())
            )
            self._conn.commit()
            return int(cur.lastrowid)

    def update(self, table: str, row_id: int, **fields: Any) -> bool:
        if not fields:
            return False
        fields = _encode({**fields, "updated_at": time.time()})
        sets = ", ".join(f"{k} = ?" for k in fields)
        with self._lock:
            cur = self._conn.execute(
                f"UPDATE {table} SET {sets} WHERE id = ?", (*fields.values(), row_id)
            )
            self._conn.commit()
            return cur.rowcount > 0

    def update_where(self, table: str, where: dict[str, Any], **fields: Any) -> int:
        fields = _encode({**fields, "updated_at": time.time()})
        sets = ", ".join(f"{k} = ?" for k in fields)
        cond = " AND ".join(f"{k} = ?" for k in where)
        with self._lock:
            cur = self._conn.execute(
                f"UPDATE {table} SET {sets} WHERE {cond}",
                (*fields.values(), *where.values()),
            )
            self._conn.commit()
            return cur.rowcount

    def delete(self, table: str, row_id: int) -> bool:
        with self._lock:
            cur = self._conn.execute(f"DELETE FROM {table} WHERE id = ?", (row_id,))
            self._conn.commit()
            return cur.rowcount > 0

    def get(self, table: str, row_id: int) -> Optional[dict[str, Any]]:
        row = self._conn.execute(
            f"SELECT * FROM {table} WHERE id = ?", (row_id,)
        ).fetchone()
        return _decode(row) if row else None

    def find(self, table: str, **where: Any) -> list[dict[str, Any]]:
        if where:
            cond = " AND ".join(f"{k} = ?" for k in where)
            rows = self._conn.execute(
                f"SELECT * FROM {table} WHERE {cond} ORDER BY id",
                tuple(int(v) if isinstance(v, bool) else v for v in where.values()),
            ).fetchall()
        else:
            rows = self._conn.execute(f"SELECT * FROM {table} ORDER BY id").fetchall()
        return [_decode(r) for r in rows]

    def find_one(self, table: str, **where: Any) -> Optional[dict[str, Any]]:
        rows = self.find(table, **where)
        return rows[0] if rows else None

    def upsert(self, table: str, keys: dict[str, Any], **fields: Any) -> dict[str, Any]:
        """Insert or update the row matching `keys`; returns the final row."""
        existing = self.find_one(table, **keys)
        if existing is None:
            row_id = self.insert(table, **keys, **fields)
        else:
            row_id = existing["id"]
            if fields:
                self.update(table, row_id, **fields)
        row = self.get(table, row_id)
        assert row is not None
        return row

    # ---- link table (seed-peer-cluster <-> scheduler-cluster many2many) ----

    def link_clusters(self, seed_peer_cluster_id: int, scheduler_cluster_id: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR IGNORE INTO seed_peer_cluster_links VALUES (?, ?)",
                (seed_peer_cluster_id, scheduler_cluster_id),
            )
            self._conn.commit()

    def linked_seed_peer_clusters(self, scheduler_cluster_id: int) -> list[int]:
        rows = self._conn.execute(
            "SELECT seed_peer_cluster_id FROM seed_peer_cluster_links WHERE scheduler_cluster_id = ?",
            (scheduler_cluster_id,),
        ).fetchall()
        return [r[0] for r in rows]
