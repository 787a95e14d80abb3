"""Usage stats: anonymized cluster/library usage collection.

Reference parity: python/ray/_private/usage/usage_lib.py:95-390 —
library-usage recording (record_library_usage), extra usage tags,
cluster metadata snapshot, and a periodic reporter. Deltas, by design:

- **Opt-in, not opt-out** (RAY_TPU_USAGE_STATS=1 enables; the reference
  enables by default with RAY_USAGE_STATS_ENABLED=0 to disable). This
  build targets zero-egress environments, so there is no default
  network report.
- The "report" sink is a JSON file in the session dir
  (usage_stats.json) plus the cluster KV (namespace "usage"), where the
  reference POSTs to a usage server. A custom sink can read either.

Recording is always allowed and never raises: library imports call
record_library_usage() unconditionally (matching the reference, which
records locally regardless of the enabled flag and only *reports* when
enabled); the reporter is only started when enabled.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import threading
import time
from typing import Dict, Optional, Set

_lock = threading.Lock()
_library_usages: Set[str] = set()
_extra_tags: Dict[str, str] = {}

KV_NAMESPACE = "usage"


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS", "0") == "1"


def record_library_usage(name: str) -> None:
    """Record that a library (train/tune/serve/…) was imported in this
    process. Cheap, idempotent, and never raises — this runs inside
    library __init__ imports."""
    with _lock:
        if name in _library_usages:
            return
        _library_usages.add(name)
    _try_push_kv(f"lib:{name}", "1")


def record_extra_usage_tag(key: str, value: str) -> None:
    """Record a free-form usage tag (reference:
    usage_lib.record_extra_usage_tag)."""
    with _lock:
        _extra_tags[key] = str(value)
    _try_push_kv(f"tag:{key}", str(value))


def get_library_usages() -> Set[str]:
    with _lock:
        return set(_library_usages)


def _try_push_kv(key: str, value: str) -> None:
    """Best-effort mirror into the cluster KV so the head's reporter
    sees usages recorded in any connected process. Silent no-op when
    not connected (pre-init imports) — the reporter re-flushes local
    state periodically."""
    try:
        from . import state as _state
        client = _state.current_client_or_none()
        if client is None:
            return
        kv_key = f"__usage__:{key}"
        lr = getattr(client, "loop_runner", None)
        if (lr is not None and lr.on_loop_thread()
                and hasattr(client, "_controller")):
            # worker RPC handlers run ON the loop: fire-and-forget the
            # put (the sync kv_put would deadlock-guard and raise) —
            # same pattern as util/tracing's flush
            lr.call_soon(client._controller().call(
                "kv_put", key=kv_key, value=value.encode(),
                overwrite=True))
        else:
            client.kv_put(kv_key, value.encode(), overwrite=True)
    except Exception:
        pass


def cluster_metadata() -> dict:
    """One anonymized snapshot of what this cluster is (reference:
    usage_lib.put_cluster_metadata fields)."""
    meta = {
        "schema_version": "0.1",
        "source": "ray_tpu_torch",
        "python_version": sys.version.split()[0],
        "os": sys.platform,
        "platform_machine": platform.machine(),
        "session_start_unix_s": int(time.time()),
    }
    try:
        import torch
        meta["torch_version"] = torch.__version__
        meta["torch_cuda_version"] = torch.version.cuda
    except Exception:
        pass
    try:
        from .. import __version__ as v
        meta["ray_tpu_version"] = v
    except Exception:
        meta["ray_tpu_version"] = "dev"
    return meta


def usage_snapshot(client=None) -> dict:
    """The full report payload: metadata + library usages + tags +
    cluster shape (total resources / node count, if connected)."""
    snap = dict(cluster_metadata())
    libs = get_library_usages()
    tags = dict(_extra_tags)
    if client is not None:
        try:
            for k in client.kv_keys("__usage__:"):
                key = k.decode() if isinstance(k, bytes) else k
                rest = key[len("__usage__:"):]
                kind, _, name = rest.partition(":")
                if kind == "lib":
                    libs.add(name)
                elif kind == "tag":
                    raw = client.kv_get(key)
                    if raw is not None:
                        tags[name] = (raw.decode()
                                      if isinstance(raw, bytes) else raw)
        except Exception:
            pass
        try:
            nodes = client.controller_rpc("list_nodes")
            alive = [n for n in nodes if n.get("alive", True)]
            snap["num_nodes"] = len(alive)
            totals: Dict[str, float] = {}
            for n in alive:
                for r, v in (n.get("resources_total")
                             or n.get("resources") or {}).items():
                    totals[r] = totals.get(r, 0.0) + float(v)
            snap["total_resources"] = totals
        except Exception:
            pass
    snap["library_usages"] = sorted(libs)
    snap["extra_usage_tags"] = tags
    return snap


class UsageReporter:
    """Head-side periodic reporter: writes usage_stats.json under the
    session dir every interval (reference: usage_stats_head.py loop).
    Started from ray_tpu_torch.init() only when usage_stats_enabled()."""

    def __init__(self, client, session_name: str,
                 interval_s: Optional[float] = None):
        from .config import session_dir
        self._client = client
        self._path = os.path.join(session_dir(session_name),
                                  "usage_stats.json")
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    "RAY_TPU_USAGE_REPORT_INTERVAL_S", "300"))
            except ValueError:
                interval_s = 300.0   # never fail init() over a bad env var
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def report_once(self) -> dict:
        snap = usage_snapshot(self._client)
        snap["reported_at_unix_s"] = int(time.time())
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1, sort_keys=True)
            os.replace(tmp, self._path)
        except OSError:
            pass
        return snap

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="usage-reporter", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.report_once()
            except Exception:
                pass
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
