"""Postmortem black-box bundles: a bounded on-disk crash spool.

A copy of ``ray_tpu/llm/_internal/blackbox.py``. When an engine
invariant breaks (guard violation, mid-tick
crash, watchdog page) the evidence — flight recorder, recent tick
times, metric exposition, in-flight request states — lives in process
memory and dies with the replica. This module snapshots that state to
a bounded on-disk spool the instant the trigger fires, so a postmortem
has the replica's last moments even after a restart; the fleet ingress
lists and fetches bundles at `GET /fleet/debug/bundles`, and
`POST /debug/dump` snapshots on demand.

Bounded twice (count and bytes) so a crash loop can never fill a disk:
oldest bundles are pruned first. Writes are atomic (tmp + rename) so a
reader never sees a half-written bundle, and every write path is
best-effort — postmortem capture must never turn a failing tick into a
differently-failing tick.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from ...util import tracing

_DEFAULT_CAPACITY = 16                  # bundles kept per spool
_DEFAULT_MAX_BYTES = 64 * 1024 * 1024   # spool size bound


def default_spool_dir(model: str = "default", replica: str = "") -> str:
    """Stable per-engine spool location under the system tempdir —
    survives the process (that is the point of a black box) while
    staying per-identity so fleet replicas never clobber each other."""
    leaf = f"{model}-{replica}" if replica else f"{model}-{os.getpid()}"
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in leaf)
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch_blackbox",
                        safe)


class BlackboxSpool:
    """Bounded directory of JSON bundles, newest-wins retention."""

    def __init__(self, root: str,
                 capacity: int = _DEFAULT_CAPACITY,
                 max_bytes: int = _DEFAULT_MAX_BYTES):
        self.root = root
        self.capacity = max(1, int(capacity))
        self.max_bytes = int(max_bytes)
        self._seq = 0
        self._lock = threading.Lock()

    # -- write ---------------------------------------------------------
    def dump(self, cause: str, bundle: Dict[str, Any]) -> Optional[str]:
        """Write one bundle; returns its id (None if the write failed —
        the caller is always on a failure path already and must not
        raise over it)."""
        try:
            with self._lock:
                self._seq += 1
                seq = self._seq
            # 0o700: bundles carry in-flight request states and the
            # full metrics exposition — on a shared host the spool
            # must not be world-readable (mode applies only to dirs
            # created here; a pre-existing spool keeps its mode)
            os.makedirs(self.root, mode=0o700, exist_ok=True)
            ts = tracing.mono_to_epoch(time.monotonic())
            safe_cause = "".join(c if c.isalnum() or c in "-_" else "_"
                                 for c in cause)[:48]
            bundle_id = f"{ts:.3f}-{os.getpid()}-{seq:04d}-{safe_cause}"
            doc = {"id": bundle_id, "cause": cause, "ts": ts, **bundle}
            blob = json.dumps(doc, default=repr).encode()
            path = os.path.join(self.root, bundle_id + ".json")
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
            self._prune()
            return bundle_id
        except Exception:
            return None

    def _prune(self) -> None:
        """Oldest-first eviction past the count/byte bounds. Bundle
        ids sort lexicographically by epoch timestamp prefix. The
        NEWEST bundle is exempt from its own prune — a single
        oversized bundle may transiently exceed the byte bound, but
        dump() never returns an id a follow-up fetch 404s."""
        entries = self._entries()
        total = sum(e["bytes"] for e in entries)
        while len(entries) > 1 and (len(entries) > self.capacity
                                    or total > self.max_bytes):
            victim = entries.pop(0)
            total -= victim["bytes"]
            try:
                os.unlink(os.path.join(self.root,
                                       victim["id"] + ".json"))
            except OSError:
                pass

    # -- read ----------------------------------------------------------
    def _entries(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.root, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            bid = name[:-len(".json")]
            parts = bid.split("-", 3)
            out.append({
                "id": bid,
                "ts": float(parts[0]) if parts and
                parts[0].replace(".", "").isdigit() else 0.0,
                "cause": parts[3] if len(parts) > 3 else "",
                "bytes": size,
            })
        return out

    def list(self) -> List[Dict[str, Any]]:
        """Bundle metadata, oldest first."""
        return self._entries()

    def read(self, bundle_id: str) -> Optional[Dict[str, Any]]:
        """Load one bundle by id (None when missing/corrupt). The id
        is path-sanitized — a traversal attempt reads nothing."""
        if os.sep in bundle_id or bundle_id.startswith("."):
            return None
        path = os.path.join(self.root, bundle_id + ".json")
        try:
            with open(path, "rb") as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None


__all__ = ["BlackboxSpool", "default_spool_dir"]
