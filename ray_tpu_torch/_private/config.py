"""RayTpuConfig: the one place runtime knobs live.

Reference parity: src/ray/common/ray_config_def.h:18-224 (RayConfig) —
every tunable is declared once with its default and env override, rather
than scattered os.environ reads. Values are read at import (matching the
reference's process-start semantics); tests monkeypatch the instance.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional


def _env(name: str, default, cast=None):
    raw = os.environ.get(name)
    if raw is None:
        return default
    cast = cast or type(default)
    try:
        return cast(raw)
    except (TypeError, ValueError):
        return default


def _f(name, default, cast=None):
    """Deferred env read: evaluated when the config is INSTANTIATED (at
    first get_config(), i.e. first real use — typically ray_tpu_torch.init),
    not at import. Preserves the set-env-after-import pattern."""
    return dataclasses.field(
        default_factory=lambda: _env(name, default, cast))


def runtime_root() -> str:
    """``<tmp>/ray_tpu``, where ``<tmp>`` is ``tempfile.gettempdir()``
    (``TMPDIR`` when set, else ``/tmp``)."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu")


def session_dir(session_name: str) -> str:
    """The session's on-disk root (logs, spill, runtime envs, metrics
    configs) — the ONE place the <tmp>/ray_tpu/<session> convention
    lives."""
    return os.path.join(runtime_root(), session_name)


@dataclasses.dataclass
class RayTpuConfig:
    # -- object plane --------------------------------------------------
    #: cross-node fetch chunk size (bytes); RAY_TPU_FETCH_CHUNK
    fetch_chunk_bytes: int = _f("RAY_TPU_FETCH_CHUNK", 32 << 20)
    #: chunks in flight per fetch; RAY_TPU_FETCH_WINDOW
    fetch_chunk_window: int = _f("RAY_TPU_FETCH_WINDOW", 4)
    #: arena spill high/low water marks (fractions)
    arena_spill_high: float = _f("RAY_TPU_ARENA_SPILL_HIGH", 0.85)
    arena_spill_low: float = _f("RAY_TPU_ARENA_SPILL_LOW", 0.65)

    # -- lineage / recovery -------------------------------------------
    #: max producing-task specs retained for object reconstruction
    lineage_cap: int = _f("RAY_TPU_LINEAGE_CAP", 10000)
    #: byte bound on retained lineage specs
    lineage_max_bytes: int = _f("RAY_TPU_LINEAGE_MAX_BYTES", 512 << 20)

    # -- node daemon ---------------------------------------------------
    #: fork workers from a preloaded zygote (interpreter+imports paid
    #: once per node; ~10ms/worker instead of 1-2s); 0 = cold Popen
    worker_forkserver: int = _f("RAY_TPU_FORKSERVER", 1)
    #: node memory fraction that triggers the OOM killer (<=0 disables)
    memory_usage_threshold: float = _f(
        "RAY_TPU_MEMORY_USAGE_THRESHOLD", 0.95)
    #: pip runtime_env local wheel index (offline installs)
    pip_find_links: Optional[str] = _f(
        "RAY_TPU_PIP_FIND_LINKS", None, str)
    #: command prefix (space-separated) wrapping worker spawns for
    #: image_uri runtime envs, e.g. "podman run --rm -v /tmp:/tmp
    #: {image}" — "{image}" substitutes the env's image_uri. Empty =
    #: no container runtime on this node (image_uri envs fail to spawn).
    container_run_prefix: Optional[str] = _f(
        "RAY_TPU_CONTAINER_RUN_PREFIX", None, str)

    # -- distributed dispatch (daemon-local lease granting) --------------
    #: clients lease plain-CPU workers from their LOCAL daemon, which
    #: grants from a controller-delegated resource block (reference
    #: parity: raylet-local dispatch). "auto" enables it only when the
    #: controller lives on a DIFFERENT host than the daemon — the
    #: optimization removes a cross-host round-trip, and measurably
    #: LOSES on loopback (delegation churn, no hop saved: see
    #: BENCH_CORE round-4 A/B). "1"/"0" force it on/off.
    local_lease_enabled: str = _f("RAY_TPU_LOCAL_LEASE", "auto", str)
    #: slots per delegation request (block growth quantum)
    lease_block_size: int = _f("RAY_TPU_LEASE_BLOCK", 4)
    #: idle seconds before unused delegated slots return to the controller
    lease_block_idle_s: float = _f("RAY_TPU_LEASE_BLOCK_IDLE_S", 10.0)

    # -- function store --------------------------------------------------
    #: code blobs larger than this are exported once to the controller KV
    #: and referenced by content hash in task specs (function manager
    #: parity); smaller blobs ride inline in the spec
    fn_inline_limit: int = _f("RAY_TPU_FN_INLINE_LIMIT", 2048)
    #: warn when controller-resident exported code blobs exceed this
    #: (blobs are never evicted mid-session — queued specs may reference
    #: any of them; growth past this means a driver re-captures fresh
    #: state in a decorator loop)
    fn_store_max_bytes: int = _f("RAY_TPU_FN_STORE_MAX_BYTES", 1 << 30)

    # -- control plane ---------------------------------------------------
    #: GCS persistence path ("" disables); RAY_TPU_GCS_PERSIST
    gcs_persist_path: Optional[str] = _f("RAY_TPU_GCS_PERSIST", None, str)
    #: bind host for every server in the process tree
    bind_host: str = _f("RAY_TPU_BIND_HOST", "127.0.0.1")
    #: advertised host when binding a wildcard address
    advertise_host: Optional[str] = _f("RAY_TPU_ADVERTISE_HOST", None, str)

    # -- workflows -------------------------------------------------------
    #: durable workflow storage root
    workflow_storage: str = dataclasses.field(
        default_factory=lambda: _env(
            "RAY_TPU_WORKFLOW_STORAGE",
            os.path.join(runtime_root(), "workflows")))


# KV key prefix for content-addressed exported code blobs (function
# store). Lives here so client, worker, and controller share it without
# import cycles.
FN_STORE_PREFIX = "__fn__:"

_config: Optional[RayTpuConfig] = None


def get_config() -> RayTpuConfig:
    global _config
    if _config is None:
        _config = RayTpuConfig()
    return _config
