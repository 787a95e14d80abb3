"""Durable control-plane storage: SQLite-backed write-through tables.

Reference parity: src/ray/gcs/gcs_server/gcs_table_storage.h:213 +
store_client/redis_store_client.h:111 — the reference persists GCS tables
(actors, named actors, KV, placement groups) in Redis so the GCS survives
restart. Here a single SQLite file per session plays that role: every
mutation is written through synchronously (SQLite WAL keeps this cheap on
the control-plane's mutation rates), and a restarting controller reloads
the full state before serving.
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

_TABLES = ("actors", "actor_specs", "named_actors", "kv",
           "placement_groups", "meta")


class GcsStore:
    """Thread-safe write-through persistence for controller tables."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        for table in _TABLES:
            self._db.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                f"(key TEXT PRIMARY KEY, value BLOB)")
        self._db.commit()

    # ------------------------------------------------------------- generic

    def put(self, table: str, key: str, value: Any) -> None:
        blob = pickle.dumps(value)
        with self._lock:
            self._db.execute(
                f"INSERT OR REPLACE INTO {table} (key, value) VALUES (?, ?)",
                (key, blob))
            self._db.commit()

    def get(self, table: str, key: str) -> Optional[Any]:
        with self._lock:
            row = self._db.execute(
                f"SELECT value FROM {table} WHERE key = ?", (key,)).fetchone()
        return pickle.loads(row[0]) if row else None

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            self._db.execute(f"DELETE FROM {table} WHERE key = ?", (key,))
            self._db.commit()

    def items(self, table: str) -> List[Tuple[str, Any]]:
        with self._lock:
            rows = self._db.execute(
                f"SELECT key, value FROM {table}").fetchall()
        return [(k, pickle.loads(v)) for k, v in rows]

    def close(self) -> None:
        with self._lock:
            try:
                self._db.commit()
                self._db.close()
            except Exception:
                pass
