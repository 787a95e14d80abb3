"""Node daemon: per-node worker pool + local object store host.

Reference parity: src/ray/raylet/node_manager.h (worker leases, worker pool
worker_pool.h:224, local object management). Differences by design: task
placement is done by the controller; the daemon's job is worker lifecycle
(spawn/reuse/kill/monitor), pushing tasks into workers, hosting the node's
shared-memory object registry, and serving cross-node object fetches.

Can run in-process (head node: inside the driver's event loop) or as a
standalone process (`python -m ray_tpu_torch._private.daemon`) for multi-node
clusters / fake-multi-node tests (cluster_utils).
"""

from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .ids import NodeID, WorkerID
from .object_store import NodeObjectStore
from .protocol import ClientPool, RpcServer

logger = logging.getLogger(__name__)


def system_memory_usage() -> Tuple[int, int]:
    """(used_bytes, total_bytes) from /proc/meminfo — the reference's
    memory_monitor.h reads the same counters (MemAvailable-based, so page
    cache doesn't count as pressure)."""
    total = avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
            if total and avail:
                break
    return total - avail, total


def pick_worker_to_kill(workers) -> Optional["WorkerHandle"]:
    """Worker-killing policy under memory pressure (reference parity:
    src/ray/raylet/worker_killing_policy.h:39 GroupByOwner /
    retriable-first): prefer killing retriable work, newest first, and
    only fall back to actors (whose state dies with them) when no plain
    task worker exists."""
    tasks = [w for w in workers
             if w.state in ("busy", "leased")
             and (w.current_task is not None
                  or getattr(w, "current_batch", None))]

    def _retriable(w) -> bool:
        specs = getattr(w, "current_batch", None) or [w.current_task]
        # a batch is cheap to kill only if EVERY member reruns
        return all((s.get("max_retries") or 0) > 0 for s in specs)

    if tasks:
        retriable = [w for w in tasks if _retriable(w)]
        pool = retriable or tasks      # retriable victims are cheap: they rerun
        return max(pool, key=lambda w: w.spawn_time)     # newest first
    actors = [w for w in workers if w.state == "actor"]
    if actors:
        return max(actors, key=lambda w: w.spawn_time)
    return None


def runtime_env_key(runtime_env: Optional[dict]) -> str:
    """Stable identity of a runtime env for worker reuse. Workers are only
    shared between tasks with the SAME key (reference parity:
    src/ray/raylet/worker_pool.h:224 — env-keyed idle pools)."""
    if not runtime_env:
        return ""
    import json
    return json.dumps(runtime_env, sort_keys=True, default=str)


class _ForkedProc:
    """Popen-like shim for zygote-forked workers. They are the ZYGOTE's
    children (it reaps them), so poll() re-verifies process identity and
    the exact exit code is unknowable (-1 once gone). kill() targets the
    process group — the child setsid()s, so pgid == pid.

    Identity: the zygote is spawned with a unique RAY_TPU_ZYGOTE_TAG env
    var. fork() inherits the exec-time environment, so every forked
    worker's /proc/<pid>/environ carries the tag while a recycled pid
    from an unrelated process does not — kill()/poll() check it before
    acting on the raw pid (an exit notice can be lost if the zygote dies
    before emitting it, and killing a reused pid would kill an innocent
    process group)."""

    def __init__(self, pid: int, tag: str = ""):
        self.pid = pid
        self.tag = tag
        self.returncode: Optional[int] = None

    def _identity(self) -> str:
        """'ours' | 'not_ours' | 'unknown' for the current owner of
        self.pid. 'unknown' covers zombies (environ reads empty — still
        our child, awaiting the zygote's exit notice) and platforms
        without /proc — never treat those as definitive either way."""
        if not self.tag:
            return "ours"     # no tag (legacy): trust the exit notices
        try:
            with open(f"/proc/{self.pid}/environ", "rb") as f:
                data = f.read()
        except OSError:
            return "unknown"
        if not data:
            return "unknown"  # zombie: environ is empty but pid is ours
        return "ours" if self.tag.encode() in data else "not_ours"

    def kill(self) -> None:
        if self.returncode is not None:
            return   # already reaped: the pid may belong to someone else
        if self._identity() == "not_ours":
            self.returncode = -1
            return   # recycled pid: killing it would hit an innocent pg
        import signal as _signal
        for target in (lambda: os.killpg(self.pid, _signal.SIGKILL),
                       lambda: os.kill(self.pid, _signal.SIGKILL)):
            try:
                target()
                return
            except Exception:
                continue

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        # Liveness comes from a signal-0 probe (works everywhere); the
        # environ tag is only an identity guard on top — a recycled pid
        # that probes alive but provably is not ours counts as dead.
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            self.returncode = -1
            return -1
        except OSError:
            pass              # EPERM etc.: pid exists
        if self._identity() == "not_ours":
            self.returncode = -1
            return -1
        return None


class WorkerHandle:
    __slots__ = ("worker_id", "addr", "pid", "proc", "state", "current_task",
                 "current_batch", "batch_progress", "actor_id", "spawn_time",
                 "env_key", "oom_reason", "last_settled_tasks",
                 "last_unstarted_tasks", "gpu_pin")

    def __init__(self, worker_id: str, proc, env_key: str = ""):
        self.worker_id = worker_id
        self.addr: Optional[Tuple[str, int]] = None
        self.proc = proc
        self.pid = proc.pid
        self.state = "starting"  # starting|idle|busy|leased|lease_draining|actor|dead
        self.current_task: Optional[dict] = None
        self.actor_id: Optional[str] = None
        self.spawn_time = time.monotonic()
        self.env_key = env_key
        # set when the memory monitor kills this worker: the normal
        # crash-report path then reports OutOfMemoryError ONCE instead of
        # a second generic crash
        self.oom_reason: Optional[str] = None
        # slim specs of the lease-dispatched batch currently executing
        # (client->worker direct; the worker self-reports per batch) and
        # the index of the member currently running (members past it
        # have not started)
        self.current_batch: list = []
        self.batch_progress: int = 0
        # task_ids whose failures _settle_leased_death already reported
        # to their owners — the fate RPC answers reported=True for them
        # so the lease pump never resubmits an already-settled task —
        # and task_ids it classified as never-started (the pump
        # resubmits those without consuming retries)
        self.last_settled_tasks: set = set()
        self.last_unstarted_tasks: set = set()
        # the GPUs (_pin_of) of the first GPU task or lease this worker
        # ran: CUDA_VISIBLE_DEVICES acts once, at the process's first
        # CUDA call, so a worker that may hold a CUDA context for these
        # devices serves only CPU work and work pinned to the same ones
        self.gpu_pin: Optional[str] = None


def _pin_of(gpus) -> Optional[str]:
    return ",".join(str(g) for g in gpus) if gpus else None


def _pin_fits(handle: "WorkerHandle", gpu_pin: Optional[str]) -> bool:
    return gpu_pin is None or handle.gpu_pin in (None, gpu_pin)


class NodeDaemon:
    def __init__(self, controller_addr: Tuple[str, int], session_name: str,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 node_id: Optional[str] = None,
                 temp_dir: Optional[str] = None,
                 worker_env: Optional[Dict[str, str]] = None):
        self.node_id = node_id or NodeID.generate().hex()
        self.controller_addr = tuple(controller_addr)
        self.session_name = session_name
        self.resources = dict(resources or {})
        self.labels = labels or {}
        from .config import session_dir
        self.temp_dir = temp_dir or session_dir(session_name)
        self.worker_env = worker_env or {}
        self.server = RpcServer()
        self.server.register_object(self)
        self.pool = ClientPool()
        self.address: Optional[Tuple[str, int]] = None
        self.object_store = NodeObjectStore(session_name)
        self.workers: Dict[str, WorkerHandle] = {}
        # Idle pools and waiter queues are keyed by runtime-env identity:
        # a task only reuses a worker whose env matches (reference parity:
        # worker_pool.h:224 env-keyed reuse).
        self.idle: Dict[str, List[str]] = {}
        # Tasks waiting for a worker take WHICHEVER same-env worker frees
        # first (released or freshly registered) — never block on one
        # specific spawn: a worker boot costs seconds (interpreter + jax
        # import) while a release is sub-millisecond. Spawns are capped so
        # a burst can't fork-bomb a small host (reference parity:
        # worker_pool.h maximum_startup_concurrency).
        self._worker_waiters: Dict[str, "deque[asyncio.Future]"] = {}
        self._spawning: Dict[str, int] = {}
        self._runtime_envs: Dict[str, Optional[dict]] = {"": None}
        self._env_manager = None   # lazy RuntimeEnvPluginManager
        # dependency prefetch bookkeeping (_stage_remote_object)
        self._staging_inflight: Dict[str, asyncio.Future] = {}
        from collections import OrderedDict as _OD
        self._staged_lru: "_OD[str, Tuple[int, float]]" = _OD()
        self._max_concurrent_spawns = max(2, (os.cpu_count() or 1) // 2)
        self._register_events: Dict[str, asyncio.Event] = {}
        self._monitor_task: Optional[asyncio.Task] = None
        self._closed = False
        if "CPU" not in self.resources:
            self.resources["CPU"] = float(os.cpu_count() or 1)
        # GPU pool for device isolation (the counterpart of the
        # reference's TPU chip pool; python/ray/_private/accelerators/
        # nvidia_gpu.py CUDA_VISIBLE_DEVICES). Ids are positions in the
        # node's view; a worker maps them through the node's own
        # CUDA_VISIBLE_DEVICES (accelerators/gpu.py).
        self._free_gpus: List[int] = list(
            range(int(self.resources.get("GPU", 0))))
        self._task_gpus: Dict[str, List[int]] = {}
        # Memory monitor (reference parity: memory_monitor.h:52): kill a
        # worker when node memory passes the threshold. usage fn is
        # injectable for tests. Threshold <= 0 disables.
        from .config import get_config
        self.memory_usage_fn = system_memory_usage
        self.memory_threshold = get_config().memory_usage_threshold
        self.oom_kills = 0
        # Log monitor (reference parity: _private/log_monitor.py): tail
        # each worker's log file and publish new lines on the controller
        # pubsub so drivers can print them (`(worker pid=...) ...`).
        self._log_offsets: Dict[str, int] = {}
        # Resource/stats gossip (reference parity: ray_syncer.h:39-83):
        # a versioned local view piggybacks on heartbeats only when it
        # changed since the controller's last ack.
        self._sync_version = 1
        self._sync_acked = 0
        self._last_view: Optional[dict] = None
        self._cmd_applied = 0    # highest command seq applied (acked back)
        self.draining = False
        # Daemon-local lease granting (distributed dispatch — reference
        # parity: LocalTaskManager dispatch, local_task_manager.h:102):
        # free slots per CPU size from controller-delegated blocks, plus
        # the locally-granted leases themselves. The controller stays
        # out of the per-lease critical path; it only sees block-sized
        # delegate/return calls.
        # delegated-block free slots, keyed by the canonical resource
        # tuple (e.g. (("CPU", 1.0),) or (("CPU", 1.0), ("GPU", 1.0)))
        self._lease_blocks: Dict[tuple, int] = {}
        self._local_leases: Dict[str, dict] = {}
        # actor_id -> delegated-block key claimed by a daemon-local
        # actor creation; credited back on actor death
        self._local_actor_slots: Dict[str, tuple] = {}
        # actor slots not re-acquired after a controller restart: their
        # death returns no block slot (controller's fresh view already
        # owns that capacity)
        self._unbacked_actor_slots: set = set()
        # Placement-group bundle ledger (two-phase reservation —
        # reference parity: the raylet's PrepareBundleResources /
        # CommitBundleResources, driven by the GCS scheduler). The
        # COMMITTED map is this daemon's authoritative statement of
        # which bundles it hosts; controller-restart reconciliation
        # audits it via the register_node payload.
        self._pg_prepared: Dict[str, tuple] = {}   # pg_id -> (bundles, ts)
        self._pg_bundles: Dict[str, list] = {}     # pg_id -> bundles
        self._lease_activity = 0.0       # last local grant/release
        self._lease_probe_at = 0.0       # next owner-liveness sweep
        self.local_leases_granted = 0    # counters for tests/stats
        self.local_leases_spilled = 0
        # Worker forkserver (zygote.py): interpreter+imports paid once,
        # workers fork in ~10ms. RAY_TPU_FORKSERVER=0 falls back to cold
        # Popen per worker. Replies route by worker_id; child exits are
        # pushed by the zygote's reaper (no pid-probe races).
        self._zygote = None
        self._zygote_tag = ""
        self._zygote_lock = asyncio.Lock()
        self._zygote_reader_task: Optional[asyncio.Task] = None
        self._zygote_replies: Dict[str, asyncio.Future] = {}
        self._forked_procs: Dict[int, _ForkedProc] = {}
        self._early_exits: Dict[int, int] = {}

    # ------------------------------------------------------------ lifecycle

    async def start(self, host=None, port: int = 0):
        os.makedirs(os.path.join(self.temp_dir, "logs"), exist_ok=True)
        self.address = await self.server.start(host, port)
        await self.pool.get(self.controller_addr).call(
            "register_node", node_id=self.node_id, addr=self.address,
            resources=self.resources, labels=self.labels,
            pg_bundles=self._pg_bundles)
        self._monitor_task = asyncio.ensure_future(self._monitor_loop())
        # warm the same-host check now (off-loop DNS): by the first
        # local-lease RPC the tri-state is usually already resolved
        self._controller_same_host_tristate()
        return self.address

    async def stop(self):
        self._closed = True
        for queue in self._worker_waiters.values():
            while queue:
                fut = queue.popleft()
                if not fut.done():
                    fut.set_exception(
                        RuntimeError("node daemon shut down while task "
                                     "waited for a worker"))
        if self._monitor_task:
            self._monitor_task.cancel()
        for w in self.workers.values():
            self._kill_proc(w)
        if self._zygote is not None and self._zygote.returncode is None:
            try:
                self._zygote.kill()
            except Exception:
                pass
        self.object_store.free_all()
        await self.server.stop()
        await self.pool.close_all()

    def _kill_proc(self, w: WorkerHandle) -> None:
        try:
            w.proc.kill()
        except Exception:
            pass
        w.state = "dead"

    # --------------------------------------------------------- worker pool

    async def _prepare_runtime_env(self, runtime_env: Optional[dict]):
        """Materialize a runtime env through the plugin manager
        (reference parity: python/ray/_private/runtime_env/plugin.py:118
        RuntimeEnvPluginManager; built-ins env_vars/working_dir/
        py_modules/pip/conda/uv/image_uri + externally registered
        plugins). Returns a RuntimeEnvContext."""
        from .runtime_env import RuntimeEnvPluginManager
        if self._env_manager is None:
            self._env_manager = RuntimeEnvPluginManager(self.temp_dir)
        return await self._env_manager.build(runtime_env)

    def _worker_pythonpath(self, extra_path,
                           existing: Optional[str] = None) -> str:
        """Workers must import ray_tpu_torch (and the driver's user modules)
        even when the package isn't installed: propagate the package
        parent dir plus the driver's sys.path entries. Runtime-env paths
        go FIRST so they shadow driver-side modules; a user-supplied
        PYTHONPATH (worker_env / runtime_env env_vars) is preserved via
        `existing`."""
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        extra = list(extra_path) + [pkg_parent] + [
            p for p in sys.path if p and os.path.isdir(p)]
        if existing is None:
            existing = os.environ.get("PYTHONPATH", "")
        seen, parts = set(), []
        for p in extra + existing.split(os.pathsep):
            if p and p not in seen:
                seen.add(p)
                parts.append(p)
        return os.pathsep.join(parts)

    def _worker_argv(self, worker_id: str) -> list:
        return ["--controller",
                f"{self.controller_addr[0]}:{self.controller_addr[1]}",
                "--daemon", f"{self.address[0]}:{self.address[1]}",
                "--worker-id", worker_id,
                "--node-id", self.node_id,
                "--session", self.session_name]

    async def _ensure_zygote(self):
        async with self._zygote_lock:    # one zygote, even under a burst
            if self._zygote is not None and self._zygote.returncode is None:
                return self._zygote
            if self._zygote_reader_task is not None:
                self._zygote_reader_task.cancel()
            env = dict(os.environ)
            env.update(self.worker_env)
            env["RAY_TPU_SESSION"] = self.session_name
            # identity tag inherited (in /proc/<pid>/environ) by every
            # forked worker — see _ForkedProc._is_ours
            import uuid as _uuid
            self._zygote_tag = f"RAY_TPU_ZYGOTE_TAG={_uuid.uuid4().hex}"
            env["RAY_TPU_ZYGOTE_TAG"] = self._zygote_tag.split("=", 1)[1]
            env["PYTHONPATH"] = self._worker_pythonpath(
                [], env.get("PYTHONPATH"))
            zlog = open(os.path.join(self.temp_dir, "logs",
                                     f"zygote-{self.node_id[:8]}.log"),
                        "ab")
            self._zygote = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "ray_tpu_torch._private.zygote",
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=zlog, env=env, start_new_session=True)
            zlog.close()
            self._zygote_reader_task = asyncio.ensure_future(
                self._zygote_reader(self._zygote))
            return self._zygote

    async def _zygote_reader(self, zygote) -> None:
        """Route zygote stdout lines: fork replies to their waiting
        spawn (by worker_id), exit notices onto the forked proc."""
        import json as _json
        try:
            while True:
                line = await zygote.stdout.readline()
                if not line:
                    break
                try:
                    msg = _json.loads(line)
                except Exception:
                    continue
                if "exited" in msg:
                    pid = int(msg["exited"])
                    proc = self._forked_procs.pop(pid, None)
                    if proc is not None:
                        proc.returncode = msg.get("code", -1)
                    else:   # exit raced ahead of the fork reply
                        if len(self._early_exits) > 4096:
                            self._early_exits.clear()
                        self._early_exits[pid] = msg.get("code", -1)
                else:
                    fut = self._zygote_replies.pop(
                        msg.get("worker_id"), None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
        except asyncio.CancelledError:
            pass
        finally:
            # zygote gone: anything still waiting must fall back
            for fut in self._zygote_replies.values():
                if not fut.done():
                    fut.set_exception(RuntimeError("zygote died"))
            self._zygote_replies.clear()

    async def _fork_worker(self, worker_id: str, env_vars, extra_path,
                           cwd, log_path: str) -> _ForkedProc:
        import json as _json
        zygote = await self._ensure_zygote()
        # PYTHONPATH handed via env_vars cannot affect an already-running
        # interpreter — translate it into sys.path prepends for the child
        prepend = list(extra_path)
        for src in (env_vars.get("PYTHONPATH", ""),
                    self.worker_env.get("PYTHONPATH", "")):
            prepend += [p for p in src.split(os.pathsep) if p]
        req = {"worker_id": worker_id,
               "argv": self._worker_argv(worker_id),
               "env": dict(env_vars),
               "path_prepend": prepend,
               "log_path": log_path, "cwd": cwd}
        fut = asyncio.get_running_loop().create_future()
        self._zygote_replies[worker_id] = fut
        try:
            async with self._zygote_lock:
                zygote.stdin.write((_json.dumps(req) + "\n").encode())
                await zygote.stdin.drain()
            # first fork pays the zygote's one-time import cost
            reply = await asyncio.wait_for(fut, 90.0)
        finally:
            self._zygote_replies.pop(worker_id, None)
        proc = _ForkedProc(int(reply["pid"]),
                           tag=getattr(self, "_zygote_tag", ""))
        early = self._early_exits.pop(proc.pid, None)
        if early is not None:
            proc.returncode = early
        else:
            self._forked_procs[proc.pid] = proc
        return proc

    async def _spawn_worker(self, env_key: str = "") -> WorkerHandle:
        worker_id = WorkerID.generate().hex()
        log_path = self._worker_log_path(worker_id)
        runtime_env = self._runtime_envs.get(env_key)
        ctx = await self._prepare_runtime_env(runtime_env)
        env_vars, extra_path, cwd = ctx.env_vars, ctx.extra_paths, ctx.cwd
        from .config import get_config
        proc = None
        # Env vars that act at interpreter/import time cannot take effect
        # in a fork of the pre-warmed zygote — those workers must
        # cold-spawn: TORCH_ and PYTORCH_ (read by torch's import and
        # its allocator config), OMP_ and MKL_ (the CPU thread pools,
        # sized when torch loads them), NCCL_ (read once per process),
        # PYTHON and LD_ (interpreter startup, the loader). So must
        # conda/uv envs (different interpreter) and containerized
        # workers. CUDA_VISIBLE_DEVICES is not among them: the zygote
        # never initializes CUDA, which reads it at its first call.
        import_sensitive = any(
            k.startswith(("TORCH_", "PYTORCH_", "OMP_", "MKL_", "NCCL_",
                          "PYTHON", "LD_"))
            for k in env_vars)
        if (get_config().worker_forkserver and not import_sensitive
                and ctx.py_executable is None and ctx.container is None):
            try:
                proc = await self._fork_worker(
                    worker_id, env_vars, extra_path, cwd, log_path)
            except Exception:
                logger.exception("zygote fork failed; cold-spawning")
                proc = None
        if proc is None:
            argv = ([ctx.py_executable or sys.executable, "-m",
                     "ray_tpu_torch._private.worker_main"]
                    + self._worker_argv(worker_id))
            if ctx.container is not None:
                if ctx.container.get("run_prefix"):
                    # sandbox:// image: the plugin built the native
                    # namespace-chroot launcher (sandbox_run.py)
                    argv = list(ctx.container["run_prefix"]) + argv
                else:
                    # external image: a configured container runtime
                    # wraps the spawn; bare nodes fail loudly (the
                    # GKE/KubeRay integration supplies the prefix)
                    prefix = get_config().container_run_prefix
                    if not prefix:
                        raise RuntimeError(
                            "runtime_env image_uri requires a container "
                            "runtime (set RAY_TPU_CONTAINER_RUN_PREFIX, "
                            "use image_uri='sandbox://<rootfs>', or run "
                            "under the KubeRay/GKE integration)")
                    argv = [p.replace("{image}",
                                      ctx.container["image_uri"])
                            for p in prefix.split()] + argv
            env = dict(os.environ)
            env.update(self.worker_env)
            env.update(env_vars)
            env["RAY_TPU_SESSION"] = self.session_name
            env["PYTHONPATH"] = self._worker_pythonpath(
                extra_path, env.get("PYTHONPATH"))
            with open(log_path, "ab") as log_file:
                proc = subprocess.Popen(
                    argv,
                    stdout=log_file, stderr=subprocess.STDOUT, env=env,
                    cwd=cwd, start_new_session=True)
        handle = WorkerHandle(worker_id, proc, env_key)
        self.workers[worker_id] = handle
        ev = asyncio.Event()
        self._register_events[worker_id] = ev
        try:
            deadline = time.monotonic() + 60.0
            while True:
                try:
                    await asyncio.wait_for(
                        ev.wait(),
                        timeout=min(1.0, max(
                            deadline - time.monotonic(), 0.05)))
                    break
                except asyncio.TimeoutError:
                    # a worker that DIED before registering (bad
                    # container prefix, sandbox mount failure, import
                    # crash) fails the spawn immediately instead of
                    # burning the full registration timeout
                    rc = proc.poll()
                    if rc is not None:
                        raise RuntimeError(
                            f"worker exited (code {rc}) before "
                            f"registering; see {log_path}")
                    if time.monotonic() >= deadline:
                        self._kill_proc(handle)
                        raise RuntimeError(
                            f"worker failed to start within 60s; "
                            f"see {log_path}")
        finally:
            self._register_events.pop(worker_id, None)
        return handle

    async def rpc_register_worker(self, worker_id: str, addr) -> dict:
        handle = self.workers.get(worker_id)
        if handle is None:
            return {"status": "unknown"}
        handle.addr = tuple(addr)
        handle.state = "idle"
        ev = self._register_events.get(worker_id)
        if ev:
            ev.set()
        return {"status": "ok"}

    async def _acquire_worker(self, env_key: str = "",
                              runtime_env: Optional[dict] = None,
                              gpu_pin: Optional[str] = None
                              ) -> WorkerHandle:
        self._runtime_envs.setdefault(env_key, runtime_env)
        pool = self.idle.setdefault(env_key, [])
        waiters = self._worker_waiters.setdefault(env_key, deque())
        while True:
            for i in range(len(pool) - 1, -1, -1):
                handle = self.workers.get(pool[i])
                if handle is None or handle.state != "idle":
                    del pool[i]
                elif _pin_fits(handle, gpu_pin):
                    del pool[i]
                    if gpu_pin is not None:
                        handle.gpu_pin = gpu_pin
                    return handle
            fut = asyncio.get_running_loop().create_future()
            fut.gpu_pin = gpu_pin
            waiters.append(fut)
            self._maybe_spawn(env_key)
            handle = await fut
            if handle.state == "idle":
                if gpu_pin is not None:
                    handle.gpu_pin = gpu_pin
                return handle
            # handed a worker that died in the window; go around again

    def _maybe_spawn(self, env_key: str = "") -> None:
        if self._closed:
            return
        spawning_here = self._spawning.get(env_key, 0)
        spawning_total = sum(self._spawning.values())
        deficit = (len(self._worker_waiters.get(env_key, ()))
                   - spawning_here)
        room = self._max_concurrent_spawns - spawning_total
        for _ in range(max(0, min(deficit, room))):
            self._spawning[env_key] = self._spawning.get(env_key, 0) + 1
            asyncio.ensure_future(self._spawn_into_pool(env_key))

    async def _spawn_into_pool(self, env_key: str = "") -> None:
        waiters = self._worker_waiters.setdefault(env_key, deque())
        try:
            handle = await self._spawn_worker(env_key)
            self._offer_worker(handle)
        except Exception as e:
            # surface the failure on one waiter instead of hanging it
            while waiters:
                fut = waiters.popleft()
                if not fut.done():
                    fut.set_exception(e)
                    break
        finally:
            self._spawning[env_key] = self._spawning.get(env_key, 1) - 1
            # waiters taken by actors never release a worker; keep
            # spawning while a deficit remains. Re-evaluate EVERY env's
            # queue, not just ours: another env's waiters may have been
            # blocked purely by the global spawn cap we just vacated.
            for key in list(self._worker_waiters):
                if self._worker_waiters.get(key):
                    self._maybe_spawn(key)

    def _offer_worker(self, handle: WorkerHandle) -> None:
        """Hand an idle worker to the longest-waiting same-env task, else
        pool it under its env key."""
        if handle.state == "dead" or handle.proc.poll() is not None:
            # e.g. a lease released right after its worker died, before
            # the monitor sweep noticed: never offer a corpse — a task
            # dispatched to it burns a retry on ConnectionRefused. The
            # sweep settles the death and removes the handle.
            return
        waiters = self._worker_waiters.setdefault(handle.env_key, deque())
        for fut in list(waiters):
            if fut.done():
                waiters.remove(fut)
            elif _pin_fits(handle, fut.gpu_pin):
                waiters.remove(fut)
                fut.set_result(handle)
                return
        self.idle.setdefault(handle.env_key, []).append(handle.worker_id)

    def _release_worker(self, handle: WorkerHandle) -> None:
        if handle.state == "busy":
            handle.state = "idle"
            handle.current_task = None
            self._offer_worker(handle)

    async def rpc_reserve_worker(self, runtime_env: Optional[dict] = None,
                                 gpu_pin: Optional[str] = None) -> dict:
        """Lease a worker to a client for direct task submission
        (reference parity: worker leases, normal_task_submitter.h:72-140
        — the task fast path bypasses the control plane per-task)."""
        key = runtime_env_key(runtime_env)
        try:
            handle = await self._acquire_worker(key, runtime_env, gpu_pin)
        except Exception as e:
            return {"status": "error", "error": repr(e)}
        handle.state = "leased"
        handle.current_task = None
        handle.current_batch = []
        return {"status": "ok", "worker_id": handle.worker_id,
                "addr": handle.addr}

    async def rpc_destroy_worker(self, worker_id: str) -> None:
        """Kill a worker outright (controller-initiated lease reclaim:
        the owner vanished, so the worker must not be re-pooled where a
        zombie pump could still reach it). The monitor sweep settles any
        in-flight task and removes the handle."""
        handle = self.workers.get(worker_id)
        if handle is None:
            return
        try:
            handle.proc.kill()
        except Exception:
            pass

    async def rpc_release_worker(self, worker_id: str) -> None:
        handle = self.workers.get(worker_id)
        if handle is None or handle.state != "leased":
            return
        if handle.current_task is not None or handle.current_batch:
            # lease released mid-task (client->worker blip): drain —
            # the worker returns to the pool when the batch finishes
            handle.state = "lease_draining"
            return
        handle.state = "idle"
        self._offer_worker(handle)

    # Leased workers self-report their current task so the OOM killer /
    # failure attribution work exactly like daemon-dispatched tasks
    # (reference parity: the raylet always knows its workers' tasks).
    async def rpc_leased_task_started(self, worker_id: str,
                                      spec: dict) -> None:
        handle = self.workers.get(worker_id)
        if handle is not None:
            handle.current_task = spec

    async def rpc_leased_task_done(self, worker_id: str) -> None:
        handle = self.workers.get(worker_id)
        if handle is None:
            return
        if handle.state == "leased":
            handle.current_task = None
        elif handle.state == "lease_draining":
            handle.current_task = None
            handle.state = "idle"
            self._offer_worker(handle)

    async def rpc_leased_batch_started(self, worker_id: str,
                                       specs: list) -> None:
        """One self-report per dispatched BATCH (the lease fast path
        amortizes per-task wire cost; reference parity intent unchanged:
        the raylet always knows its workers' work)."""
        handle = self.workers.get(worker_id)
        if handle is not None:
            handle.current_batch = list(specs)
            handle.batch_progress = 0
            handle.current_task = None

    async def rpc_leased_batch_progress(self, worker_id: str,
                                        index: int) -> None:
        handle = self.workers.get(worker_id)
        if handle is not None:
            handle.batch_progress = max(handle.batch_progress, int(index))

    async def rpc_leased_batch_done(self, worker_id: str) -> None:
        handle = self.workers.get(worker_id)
        if handle is None:
            return
        handle.current_batch = []
        handle.batch_progress = 0
        if handle.state == "lease_draining":
            handle.state = "idle"
            self._offer_worker(handle)

    async def _settle_leased_death(self, handle: WorkerHandle) -> bool:
        """Report a dead leased worker's in-flight task(s) to their
        owners EXACTLY once (fate RPC and the monitor sweep both funnel
        here; check-and-clear on the daemon loop makes it atomic).

        Batch nuance: only members the worker STARTED (index <=
        batch_progress) are reported — the running one genuinely failed;
        earlier ones completed, and their owners drop the report
        (core.py rpc_object_ready late-failure guard) unless the result
        push itself was lost, which the report then covers. Never-
        started members are recorded in last_unstarted_tasks and handed
        back to the pump via the fate RPC for clean resubmission with no
        retry consumed."""
        if handle.current_batch:
            cut = handle.batch_progress + 1
            started = [s for s in handle.current_batch[:cut]
                       if s and s.get("_leased")]
            # Members past the last DELIVERED marker are ambiguous: the
            # worker sends a marker before every member, but the final
            # oneway frame can die with the worker. Resubmission is only
            # safe when re-execution is permitted — retriable members go
            # back to the pump as unstarted (no retry consumed), while
            # max_retries=0 members are failed like started ones:
            # re-executing a possibly-started at-most-once task would
            # break its guarantee.
            ambiguous = [s for s in handle.current_batch[cut:]
                         if s and s.get("_leased")]
            unstarted = [s for s in ambiguous
                         if (s.get("max_retries") or 0) > 0]
            started += [s for s in ambiguous
                        if (s.get("max_retries") or 0) <= 0]
        elif (handle.current_task is not None
              and handle.current_task.get("_leased")):
            started, unstarted = [handle.current_task], []
        else:
            return False
        handle.current_task = None
        handle.current_batch = []
        handle.batch_progress = 0
        handle.last_unstarted_tasks |= {
            s.get("task_id") for s in unstarted}
        from ..exceptions import OutOfMemoryError
        err = (OutOfMemoryError(handle.oom_reason)
               if handle.oom_reason else None)
        for spec in started:
            handle.last_settled_tasks.add(spec.get("task_id"))
            await self._report_failure(
                spec, "leased worker died while running task", error=err)
        return True

    async def rpc_leased_worker_fate(self, worker_id: str,
                                     task_id: str = None,
                                     task_ids: list = None) -> dict:
        """The client's lease pump asks after a connection failure:
        'did/will you report these tasks?' — settles on the spot so the
        pump never double-submits and owners never hang. A worker that
        is still ALIVE is a transient client->worker blip: the batch
        keeps executing and its results reach the owner directly, so
        nothing is settled and the pump must not resubmit."""
        ids = set(task_ids or ([task_id] if task_id else []))
        handle = self.workers.get(worker_id)
        if handle is None:
            return {"reported": False, "alive": False, "unstarted": []}
        dead = handle.state == "dead" or handle.proc.poll() is not None
        if not dead:
            return {"reported": False, "alive": True, "unstarted": []}
        current = {s.get("task_id") for s in handle.current_batch}
        if handle.current_task is not None:
            current.add(handle.current_task.get("task_id"))
        if ids & current:
            await self._settle_leased_death(handle)
        # either settled just now or by the sweep (reported=True for the
        # started members — resubmitting those would break at-most-once
        # and race the owner-side retry) or the worker died before
        # leased_batch_started landed (reported=False: pump resubmits
        # everything). "unstarted" members never executed: the pump
        # resubmits them through the scheduler, no retry consumed.
        return {"reported": bool(ids & handle.last_settled_tasks),
                "alive": False,
                "unstarted": sorted(ids & handle.last_unstarted_tasks)}

    # ------------------------------------------------ local lease granting

    LOCAL_LEASE_PROBE_AGE_S = 10.0     # lease age before owner probing
    LOCAL_LEASE_PROBE_PERIOD_S = 5.0   # sweep cadence

    async def _claim_local_slot(self, resources: dict):
        """Shared gate + slot claim for daemon-local grants (worker
        leases AND actor creations). Returns (cpu, None) with one
        delegated-block slot claimed, or (None, refusal_reply).

        Only plain-CPU requests are served locally (everything else
        needs global placement state)."""
        from .config import get_config
        cfg = get_config()
        res = dict(resources or {})
        mode = str(cfg.local_lease_enabled).lower()
        if mode in ("0", "false"):
            return None, {"status": "unsupported"}
        # CPU and GPU serve locally (GPUs are node-local hardware
        # this daemon already owns the assignment of); anything else
        # needs global placement state
        if any(k not in ("CPU", "GPU") for k in res):
            return None, {"status": "unsupported"}
        if mode not in ("1", "true"):
            # auto: only worth it when the controller hop crosses hosts
            # (loopback grants measurably lose to the controller path —
            # delegation churn with no latency saved). Hosts are
            # resolved so hostname-vs-IP spellings of the same machine
            # still compare equal.
            same = self._controller_same_host_tristate()
            if same is None:
                # resolution still in flight (off-loop DNS): 'spill'
                # routes this one call to the controller WITHOUT the
                # client latching local-lease-unsupported for good
                return None, {"status": "spill"}
            if same:
                return None, {"status": "unsupported"}
        # zero entries normalize OUT of the block key: an explicit
        # "CPU: 0" request used to produce a {"CPU": 0.0} key and a
        # zero-CPU delegation block — a grant the controller's ledger
        # can't meaningfully meter. Zero-cpu requests take the
        # scheduled path via 'spill' (a per-key 5 s skip on the
        # client); 'unsupported' would latch the client's process-wide
        # local-lease-off flag and kill the fast path for every later
        # CPU>0 task too.
        req = {k: float(v) for k, v in res.items() if float(v) > 0}
        if "CPU" not in res:
            req["CPU"] = 1.0             # unspecified -> default 1
        if "CPU" not in req:
            return None, {"status": "spill"}
        key = tuple(sorted(req.items()))
        if self.draining:
            return None, {"status": "spill"}
        while self._lease_blocks.get(key, 0) <= 0:
            # grow the block; re-check after the await (a concurrent
            # grant may have consumed what this call delegated)
            try:
                reply = await self.pool.get(self.controller_addr).call(
                    "delegate_resources", node_id=self.node_id,
                    resources=dict(key),
                    count=max(1, cfg.lease_block_size))
            except Exception:
                reply = None
            if not reply or reply.get("granted", 0) <= 0:
                self.local_leases_spilled += 1
                return None, {"status": "spill"}
            self._lease_blocks[key] = (self._lease_blocks.get(key, 0)
                                       + reply["granted"])
        # slot claimed before any worker-acquire await (no double-grant)
        self._lease_blocks[key] -= 1
        return key, None

    async def rpc_create_actor_local(self, spec: dict) -> dict:
        """Create an actor WITHOUT the controller on the critical path
        (distributed dispatch for actors — reference parity: the GCS
        actor scheduler leases workers through raylets and learns the
        result afterwards, gcs_actor_scheduler.h; here the daemon
        grants from its controller-delegated block and the controller's
        directory is updated by the actor_started report, which carries
        the creation spec so registration is ASYNC).

        Serves plain-CPU, unnamed, non-detached, default-scheduled
        creations; everything else replies 'unsupported' and takes the
        scheduled path. The claimed slot is held until actor death
        (credited back by the worker monitor)."""
        if (spec.get("scheduling") or spec.get("runtime_env")
                or spec.get("actor_name")
                or spec.get("lifetime") == "detached"):
            return {"status": "unsupported"}
        claimed, refusal = await self._claim_local_slot(
            spec.get("resources"))
        if refusal is not None:
            return refusal
        cpu = claimed
        actor_id = spec["actor_id"]
        gpu_n = int((spec.get("resources") or {}).get("GPU", 0))
        if gpu_n and len(self._free_gpus) < gpu_n:
            self._lease_blocks[cpu] = self._lease_blocks.get(cpu, 0) + 1
            self.local_leases_spilled += 1
            return {"status": "spill", "error": "gpus busy"}
        self._assign_gpus(spec)   # GPUs held until actor death
        try:
            handle = await self._acquire_worker(
                gpu_pin=_pin_of(spec.get("_gpu_ids")))
        except Exception as e:
            self._release_gpus(spec["task_id"])
            self._lease_blocks[cpu] = self._lease_blocks.get(cpu, 0) + 1
            self.local_leases_spilled += 1
            return {"status": "spill", "error": repr(e)}
        handle.state = "actor"
        handle.actor_id = actor_id
        handle.current_task = spec
        self._local_actor_slots[actor_id] = cpu
        try:
            reply = await self.pool.get(handle.addr).call(
                "create_actor", spec=spec)
        except Exception as e:
            self._local_actor_slots.pop(actor_id, None)
            self._lease_blocks[cpu] = self._lease_blocks.get(cpu, 0) + 1
            self._release_gpus(spec["task_id"])
            # transport error mid-create: __init__ MAY have succeeded
            # in a still-alive worker — kill it, or the client's
            # scheduled-path resubmission could start a SECOND live
            # incarnation of this actor_id (the monitor reaps the proc;
            # its actor_died for a never-registered actor is a no-op)
            self._kill_proc(handle)
            return {"status": "error", "error": repr(e)}
        if reply.get("status") != "ok":
            # __init__ raised: worker already pushed the owner the
            # error; reusable worker goes back to the pool
            self._local_actor_slots.pop(actor_id, None)
            self._lease_blocks[cpu] = self._lease_blocks.get(cpu, 0) + 1
            self._release_gpus(spec["task_id"])
            handle.state = "busy"
            handle.actor_id = None
            handle.current_task = None
            self._release_worker(handle)
            return {"status": "created_failed"}
        self.local_leases_granted += 1
        self._lease_activity = time.monotonic()
        # async directory registration: the spec rides actor_started so
        # the controller can build the ActorEntry it never saw; retried
        # off the grant path — an actor the controller never learns is
        # unkillable/unrestartable, so after the retries fail the actor
        # is destroyed rather than left as a ghost
        asyncio.ensure_future(
            self._announce_local_actor(actor_id, handle, spec))
        return {"status": "ok", "addr": list(handle.addr),
                "worker_id": handle.worker_id}

    async def _announce_local_actor(self, actor_id: str, handle,
                                    spec: dict) -> None:
        for attempt in range(5):
            try:
                await asyncio.wait_for(
                    self.pool.get(self.controller_addr).call(
                        "actor_started", actor_id=actor_id,
                        addr=handle.addr, worker_id=handle.worker_id,
                        spec=spec, node_id=self.node_id),
                    timeout=10.0)
                return
            except Exception:
                await asyncio.sleep(min(2.0 ** attempt, 10.0))
        logger.warning(
            "local actor %s could not be registered with the "
            "controller after 5 attempts; destroying it (an "
            "unregistered actor cannot be killed or restarted)",
            actor_id[:12])
        await self.rpc_kill_actor_worker(actor_id)

    async def rpc_lease_worker_local(self, resources: dict = None,
                                     owner_addr=None) -> dict:
        """Grant a worker lease WITHOUT a controller round-trip, from a
        controller-delegated resource block (distributed dispatch —
        reference parity: the raylet grants leases locally,
        node_manager.cc HandleRequestWorkerLease; spillback here is the
        'spill' reply, which sends the client to the controller's
        global scheduler instead of a peer raylet — the controller is
        this design's spill target).

        CPU and CPU+GPU requests are served locally (GPUs are pinned
        to the lease); everything else needs global placement state and
        replies 'unsupported'."""
        claimed, refusal = await self._claim_local_slot(resources)
        if refusal is not None:
            return refusal
        cpu = claimed
        # GPU leases pin specific devices for the lease lifetime; tasks
        # dispatched through the lease inherit them (the scheduled path
        # assigns per-task instead, _assign_gpus)
        gpu_n = int(dict(cpu).get("GPU", 0))
        gpus = None
        if gpu_n:
            if len(self._free_gpus) < gpu_n:
                self._lease_blocks[cpu] += 1
                self.local_leases_spilled += 1
                return {"status": "spill", "error": "gpus busy"}
            gpus = self._free_gpus[:gpu_n]
            self._free_gpus = self._free_gpus[gpu_n:]
        reply = await self.rpc_reserve_worker(gpu_pin=_pin_of(gpus))
        if reply.get("status") != "ok":
            self._lease_blocks[cpu] += 1
            if gpus:
                self._free_gpus.extend(gpus)
            self.local_leases_spilled += 1
            return {"status": "spill", "error": reply.get("error")}
        import uuid as _uuid
        lease_id = "ll-" + _uuid.uuid4().hex
        self._local_leases[lease_id] = {
            "cpu": cpu, "worker_id": reply["worker_id"],
            "owner_addr": tuple(owner_addr) if owner_addr else None,
            "granted_at": time.monotonic(), "score": 0,
            "gpus": gpus,
        }
        self._lease_activity = time.monotonic()
        self.local_leases_granted += 1
        return {"status": "ok", "lease_id": lease_id, "local": True,
                "worker_addr": list(reply["addr"]),
                "worker_id": reply["worker_id"],
                "daemon_addr": list(self.address),
                "node_id": self.node_id,
                "gpus": gpus}

    def _controller_same_host_tristate(self):
        """True/False once known, None while resolving.

        True when the controller runs on this daemon's machine (so a
        'local' grant would save no network hop). DNS resolution runs
        OFF the event loop (a slow resolver must not stall daemon RPCs
        — heartbeats ride this loop). Loopback literals, equal strings,
        and hostname-vs-IP aliases all count as same-host; resolution
        failure conservatively reports same-host."""
        cached = getattr(self, "_same_host_cache", None)
        if cached is not None:
            return cached
        chost, dhost = self.controller_addr[0], self.address[0]
        loop_names = {"127.0.0.1", "localhost", "::1", "0.0.0.0"}
        if chost in loop_names or chost == dhost:
            self._same_host_cache = True
            return True
        if getattr(self, "_same_host_resolving", False):
            return None   # resolution in flight
        self._same_host_resolving = True

        def _resolve() -> bool:
            import socket
            try:
                cip = socket.gethostbyname(chost)
                dip = socket.gethostbyname(dhost)
                return (cip == dip or cip in loop_names
                        or dip in loop_names)
            except OSError:
                return True

        import asyncio

        def _store(fut):
            try:
                self._same_host_cache = bool(fut.result())
            except Exception:
                self._same_host_cache = True

        try:
            task = asyncio.get_running_loop().run_in_executor(
                None, _resolve)
            task.add_done_callback(_store)
        except RuntimeError:     # no running loop (unit-test direct call)
            self._same_host_cache = _resolve()
            return self._same_host_cache
        return None

    async def rpc_release_lease_local(self, lease_id: str,
                                      terminate: bool = False) -> None:
        ent = self._local_leases.pop(lease_id, None)
        if ent is None:
            return
        if terminate:
            await self.rpc_destroy_worker(ent["worker_id"])
        else:
            await self.rpc_release_worker(ent["worker_id"])
        if ent.get("gpus"):
            self._free_gpus.extend(ent["gpus"])
        if not ent.get("unbacked"):
            # unbacked = granted before a controller restart and not
            # re-acquired since (_reconcile_delegations): its slot no
            # longer exists controller-side, so nothing returns
            self._lease_blocks[ent["cpu"]] = (
                self._lease_blocks.get(ent["cpu"], 0) + 1)
        self._lease_activity = time.monotonic()

    async def _reconcile_delegations(self) -> None:
        """After a controller restart (or dead-mark + re-register) the
        fresh NodeEntry has no record of our delegated slots — neither
        the free block nor the ones backing live local leases. Holding
        them anyway would let the scheduled path double-book this node
        forever. Re-acquire everything; what cannot be re-acquired is
        shed: free slots are dropped, and uncovered live leases are
        marked 'unbacked' (they run to completion but return no slot —
        transient oversubscription bounded by the lease lifetime)."""
        # Snapshot BOTH sides before any await: a lease granted while
        # this coroutine awaits the controller is already backed by a
        # fresh-controller delegation and must be neither covered here
        # nor have its block slots clobbered (+= below, not =).
        stale_free: Dict[float, int] = {
            cpu: max(0, n) for cpu, n in self._lease_blocks.items()}
        stale = list(self._local_leases.items())
        stale_actors = list(self._local_actor_slots.items())
        self._lease_blocks = {}
        # Pessimistic until re-acquired: a stale lease released DURING
        # the awaits below must not credit a block slot from the dead
        # controller epoch.
        for _, ent in stale:
            ent["unbacked"] = True
        self._unbacked_actor_slots.update(a for a, _ in stale_actors)
        need: Dict[float, int] = dict(stale_free)
        for _, ent in stale:
            need[ent["cpu"]] = need.get(ent["cpu"], 0) + 1
        for _, cpu in stale_actors:
            need[cpu] = need.get(cpu, 0) + 1
        controller = self.pool.get(self.controller_addr)
        for cpu, count in need.items():
            if count <= 0:
                continue
            granted = 0
            try:
                reply = await controller.call(
                    "delegate_resources", node_id=self.node_id,
                    resources=dict(cpu), count=count)
                granted = int((reply or {}).get("granted", 0))
            except Exception:
                granted = 0
            # cover stale leases that are STILL live (a released one is
            # skipped — its would-be slot flows into the block instead);
            # leftovers join anything delegated concurrently (+=)
            for lid, ent in stale:
                if (ent["cpu"] != cpu or granted <= 0
                        or self._local_leases.get(lid) is not ent):
                    continue
                ent["unbacked"] = False
                granted -= 1
            for aid, acpu in stale_actors:
                if (acpu != cpu or granted <= 0
                        or aid not in self._local_actor_slots):
                    continue
                self._unbacked_actor_slots.discard(aid)
                granted -= 1
            if granted > 0:
                self._lease_blocks[cpu] = (
                    self._lease_blocks.get(cpu, 0) + granted)

    async def _local_lease_sweep(self) -> None:
        """Monitor-loop duties for local leases: (a) reap leases whose
        owner died (same refused/slow scoring as the controller's
        reaper — a GIL-busy driver is 'slow', not dead), (b) return
        idle delegated slots so the scheduled path can use them."""
        from .config import get_config
        cfg = get_config()
        now = time.monotonic()
        if self._local_leases and now >= self._lease_probe_at:
            self._lease_probe_at = now + self.LOCAL_LEASE_PROBE_PERIOD_S
            mature = [(lid, l) for lid, l in self._local_leases.items()
                      if l["owner_addr"] is not None
                      and (now - l["granted_at"]
                           > self.LOCAL_LEASE_PROBE_AGE_S)]
            owners = {l["owner_addr"] for _, l in mature}
            verdict: Dict[tuple, int] = {}

            async def _probe(addr: tuple) -> None:
                # same classification as the controller's reaper
                # (controller.py _reap_dead_client_leases): refused is
                # definitive (+2); timeouts/odd errors are ambiguous
                # (+1) — a GIL-starved driver must not lose its worker
                try:
                    await asyncio.wait_for(
                        self.pool.get(addr).call("ping"), timeout=5.0)
                    verdict[addr] = 0
                except (asyncio.TimeoutError, TimeoutError):
                    verdict[addr] = 1
                except (ConnectionError, OSError):
                    verdict[addr] = 2
                except Exception:
                    verdict[addr] = 1

            await asyncio.gather(*(_probe(a) for a in owners))
            for lid, lease in mature:
                score = verdict.get(lease["owner_addr"], 0)
                lease["score"] = (0 if score == 0
                                  else lease["score"] + score)
                if lease["score"] >= 4:
                    # kill, don't re-pool: a zombie pump must never
                    # share a worker with a daemon dispatch
                    await self.rpc_release_lease_local(
                        lid, terminate=True)
        if (self._lease_blocks
                and now - self._lease_activity > cfg.lease_block_idle_s):
            for cpu, free in list(self._lease_blocks.items()):
                if free > 0:
                    # claim BEFORE the await: a grant racing this return
                    # must see 0 and grow a fresh block, not consume a
                    # slot the controller is about to release
                    self._lease_blocks[cpu] -= free
                    try:
                        await self.pool.get(self.controller_addr).call(
                            "return_delegation", node_id=self.node_id,
                            resources=dict(cpu), count=free)
                    except Exception:
                        self._lease_blocks[cpu] = (
                            self._lease_blocks.get(cpu, 0) + free)
                        continue
                if self._lease_blocks.get(cpu) == 0:
                    del self._lease_blocks[cpu]

    async def rpc_prestart_workers(self, count: int) -> int:
        started = 0
        for _ in range(count):
            try:
                h = await self._spawn_worker("")
                self._offer_worker(h)
                started += 1
            except Exception:
                break
        return started

    # ----------------------------------------------------------- execution

    async def rpc_execute_task(self, spec: dict) -> dict:
        asyncio.ensure_future(self._run_task(spec))
        return {"status": "accepted"}

    def _assign_gpus(self, spec: dict) -> None:
        n = int((spec.get("resources") or {}).get("GPU", 0))
        if n > 0 and self._free_gpus:
            gpus = self._free_gpus[:n]
            self._free_gpus = self._free_gpus[n:]
            self._task_gpus[spec["task_id"]] = gpus
            spec["_gpu_ids"] = gpus

    def _release_gpus(self, task_id: str) -> None:
        gpus = self._task_gpus.pop(task_id, None)
        if gpus:
            self._free_gpus.extend(gpus)

    PREFETCH_DISPATCH_GRACE_S = 5.0    # max dispatch delay for staging
    STAGED_CACHE_BYTES = 256 << 20     # staged foreign copies kept around

    async def _prefetch_args(self, spec: dict) -> Dict[str, Any]:
        """Stage the task's arg objects while it waits for a worker
        (reference parity: raylet/dependency_manager.h pulls args to
        local plasma before dispatch). Returns {object_id: ShmLocation}
        or {object_id: ('payload', flat_bytes)} handed to the worker via
        the spec, so arg resolution skips the owner round trip. Cross-
        host objects are copied into this node's arena (deduped against
        concurrent prefetches of the same object); same-host shm is
        attachable directly, so only the location is recorded. Best
        effort: any failure just leaves the worker on its normal path."""
        arg_refs = dict(spec.get("arg_refs") or [])   # dedup repeat args
        if not arg_refs:
            return {}

        async def one(oid: str, owner):
            entry = self.object_store.get(oid)
            if (entry is not None and entry.sealed
                    and not entry.shm_name.startswith("spill:")):
                # "spill:" names are daemon-internal — a worker cannot
                # shm_open them; let it fetch through rpc_fetch_object
                from .object_store import ShmLocation
                return oid, ShmLocation(self.address, entry.shm_name,
                                        entry.size)
            if owner is None or tuple(owner) == self.address:
                return oid, None
            try:
                reply = await asyncio.wait_for(
                    self.pool.get(tuple(owner)).call(
                        "get_object", object_id=oid, timeout=60.0),
                    timeout=65.0)
            except Exception:
                return oid, None
            status = reply.get("status")
            if status == "location":
                loc = reply["location"]
                if loc.node_addr[0] == self.address[0]:
                    return oid, loc   # same host: shm attaches directly
                staged = await self._stage_remote_object(oid, loc)
                return oid, staged or loc
            if status == "inline" and reply.get("payload") is not None:
                # small/inline object: forward the bytes — the daemon
                # already paid the owner round trip, the worker must not
                # pay it again
                return oid, ("payload", reply["payload"])
            return oid, None

        results = await asyncio.gather(
            *(one(oid, owner) for oid, owner in arg_refs.items()),
            return_exceptions=True)
        return {oid: loc for r in results
                if not isinstance(r, BaseException)
                for oid, loc in [r] if loc is not None}

    async def _stage_remote_object(self, object_id: str, loc):
        """Chunk-fetch a cross-host object into THIS node's arena and
        register it; returns the local ShmLocation (None on failure).
        Concurrent stagings of one object share a single pull, and
        staged foreign copies are LRU-capped — the owner's free_object
        never reaches this unsolicited copy, so the daemon bounds it."""
        fut = self._staging_inflight.get(object_id)
        if fut is not None:
            try:
                return await asyncio.shield(fut)
            except Exception:
                return None
        fut = asyncio.get_running_loop().create_future()
        self._staging_inflight[object_id] = fut
        try:
            result = await self._stage_remote_object_inner(object_id, loc)
            fut.set_result(result)
            return result
        except BaseException as e:
            fut.set_exception(e)
            fut.exception()   # consumed
            return None
        finally:
            self._staging_inflight.pop(object_id, None)

    STAGED_PIN_S = 60.0     # staged copies safe from eviction this long
    STAGED_HARD_CAP = 2      # x STAGED_CACHE_BYTES: pin yields to this

    async def _stage_remote_object_inner(self, object_id: str, loc):
        from .object_store import ShmLocation, write_to_shm
        from .serialization import SerializedObject
        from .transfer import fetch_flat
        try:
            flat = await fetch_flat(
                self.pool.get(loc.node_addr), object_id, loc.size,
                per_call_timeout=30.0)
            # arena_room=None: a discardable cache copy must never force
            # PRIMARY objects to spill (write_to_shm falls back to a
            # per-object segment when the arena is full)
            shm_name, size = await asyncio.get_running_loop().run_in_executor(
                None, write_to_shm, object_id,
                SerializedObject.from_flat(flat), self.session_name,
                None)
            self.object_store.register(object_id, shm_name, size)
            self._staged_lru[object_id] = (size, time.monotonic())
            self._staged_lru.move_to_end(object_id)
            # SOFT cap: entries younger than STAGED_PIN_S may hold
            # ShmLocations already handed to dispatched-but-unresolved
            # tasks — freeing those would fail the task (the owner can't
            # 'reconstruct' a live put() object), so the cap first
            # evicts only aged entries. But the pin must not let a storm
            # of young copies fill /dev/shm: past the HARD cap the
            # oldest entries go regardless (a rare spurious task retry
            # beats a node out of shm).
            now = time.monotonic()
            total = sum(s for s, _ in self._staged_lru.values())
            hard = total > self.STAGED_CACHE_BYTES * self.STAGED_HARD_CAP
            for old_oid in list(self._staged_lru):
                if total <= self.STAGED_CACHE_BYTES:
                    break
                old_size, staged_at = self._staged_lru[old_oid]
                if old_oid == object_id or (
                        not hard
                        and now - staged_at < self.STAGED_PIN_S):
                    continue
                del self._staged_lru[old_oid]
                self.object_store.free(old_oid)
                total -= old_size
                hard = (total
                        > self.STAGED_CACHE_BYTES * self.STAGED_HARD_CAP)
            return ShmLocation(self.address, shm_name, size)
        except Exception:
            return None

    async def _run_task(self, spec: dict) -> None:
        controller = self.pool.get(self.controller_addr)
        self._assign_gpus(spec)
        renv = spec.get("runtime_env")
        prefetch = asyncio.ensure_future(self._prefetch_args(spec))
        try:
            handle = await self._acquire_worker(
                runtime_env_key(renv), renv,
                gpu_pin=_pin_of(spec.get("_gpu_ids")))
        except Exception as e:
            prefetch.cancel()
            await self._report_failure(spec, f"worker spawn failed: {e!r}")
            self._release_gpus(spec["task_id"])
            await controller.oneway("task_finished", task_id=spec["task_id"],
                                    node_id=self.node_id)
            return
        handle.state = "busy"
        handle.current_task = spec
        try:
            # Staging overlapped worker acquisition. A short grace keeps
            # a warm-pool dispatch from waiting on a wedged peer or a
            # multi-GiB pull — past it the worker fetches its own args,
            # while the staging keeps running DETACHED (deduped via
            # _staging_inflight): cancelling would throw away the bytes
            # already pulled AND could abandon a mid-write arena object
            # with no owner; letting it land serves the next task.
            locs = await asyncio.wait_for(
                asyncio.shield(prefetch),
                timeout=self.PREFETCH_DISPATCH_GRACE_S)
            if locs:
                spec["_arg_locations"] = locs
        except asyncio.CancelledError:
            prefetch.cancel()
            raise            # _run_task itself was cancelled: unwind
        except Exception:    # TimeoutError included: leave it running
            pass
        if spec.get("is_actor_creation"):
            handle.state = "actor"
            handle.actor_id = spec["actor_id"]
            try:
                reply = await self.pool.get(handle.addr).call(
                    "create_actor", spec=spec)
            except Exception as e:
                self._release_gpus(spec["task_id"])
                if handle.oom_reason:
                    # The memory monitor killed this worker and already
                    # sent actor_died (restart-eligible); reporting
                    # creation-failed too would mark the actor DEAD and
                    # burn the restart the first report queued.
                    return
                await controller.oneway(
                    "actor_creation_failed", actor_id=spec["actor_id"],
                    reason=f"worker died during actor creation: {e!r}")
                await self._report_failure(
                    spec, f"actor creation crashed: {e!r}")
                return
            if reply.get("status") == "ok":
                await controller.oneway(
                    "actor_started", actor_id=spec["actor_id"],
                    addr=handle.addr, worker_id=handle.worker_id)
                # Creation-task resources stay held until actor death;
                # do NOT send task_finished here.
            else:
                handle.state = "busy"
                handle.actor_id = None
                self._release_worker(handle)
                self._release_gpus(spec["task_id"])
                await controller.oneway(
                    "actor_creation_failed", actor_id=spec["actor_id"],
                    reason=reply.get("error_tb", "init failed"))
                await controller.oneway(
                    "task_finished", task_id=spec["task_id"],
                    node_id=self.node_id)
        else:
            try:
                await self.pool.get(handle.addr).call(
                    "run_task", spec=spec)
            except Exception as e:
                if self._closed:
                    return  # our own shutdown cancelled the call
                from ..exceptions import OutOfMemoryError
                err = (OutOfMemoryError(handle.oom_reason)
                       if handle.oom_reason else None)
                await self._report_failure(
                    spec, f"worker crashed while running task: {e!r}",
                    error=err)
                if handle.state != "dead":
                    self._kill_proc(handle)
            else:
                self._release_worker(handle)
            self._release_gpus(spec["task_id"])
            await controller.oneway("task_finished", task_id=spec["task_id"],
                                    node_id=self.node_id)

    async def _report_failure(self, spec: dict, reason: str,
                              error: Optional[Exception] = None) -> None:
        from ..exceptions import WorkerCrashedError
        try:
            await self.pool.get(spec["owner_addr"]).oneway(
                "object_ready", error=error or WorkerCrashedError(reason),
                task_id=spec["task_id"],
                object_ids=spec.get("return_ids") or [spec["return_id"]])
        except Exception:
            pass

    def _worker_log_path(self, worker_id: str) -> str:
        return os.path.join(self.temp_dir, "logs",
                            f"worker-{worker_id[:12]}.log")

    async def _pump_worker_logs(self, controller) -> None:
        """Publish new worker-log lines (bounded per tick) to the driver
        log topic (reference parity: _private/log_monitor.py tailing)."""
        for handle in list(self.workers.values()):
            await self._pump_one_log(controller, handle)

    async def _pump_one_log(self, controller, handle,
                            final: bool = False) -> None:
        """Tail one worker's log. `final` (worker died) drains to EOF
        including an unterminated last line — the crash output matters
        most; otherwise partial lines are held for the next tick."""
        path = self._worker_log_path(handle.worker_id)
        for _ in range(64 if final else 4):      # chunks per tick, bounded
            offset = self._log_offsets.get(handle.worker_id, 0)
            try:
                if os.path.getsize(path) <= offset:
                    return
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read(64 << 10)
            except OSError:
                return
            full = len(chunk) == (64 << 10)
            cut = chunk.rfind(b"\n")
            if cut < 0:
                if not (final or full):
                    return                       # hold the partial line
                cut = len(chunk) - 1
            elif final and cut < len(chunk) - 1:
                cut = len(chunk) - 1             # flush the tail too
            self._log_offsets[handle.worker_id] = offset + cut + 1
            text = chunk[:cut + 1].decode("utf-8", errors="replace")
            try:
                await controller.oneway(
                    "publish", topic="__worker_logs__",
                    message={"node_id": self.node_id, "pid": handle.pid,
                             "worker_id": handle.worker_id, "data": text})
            except Exception:
                return
            if not full:
                return

    async def _check_memory_pressure(self) -> None:
        """Kill one worker per tick while above the threshold (reference
        parity: memory_monitor.h:52 + worker_killing_policy.h:39)."""
        if self.memory_threshold <= 0:
            return
        try:
            used, total = self.memory_usage_fn()
        except Exception:
            return
        if total <= 0 or used / total < self.memory_threshold:
            return
        victim = pick_worker_to_kill(list(self.workers.values()))
        if victim is None:
            return
        reason = (f"node memory pressure: {used / total:.0%} of "
                  f"{total >> 20} MiB used (threshold "
                  f"{self.memory_threshold:.0%}); killed "
                  f"{'actor' if victim.state == 'actor' else 'task'} "
                  f"worker {victim.pid} per the newest-retriable-first "
                  f"policy")
        logger.warning("OOM kill: %s", reason)
        self.oom_kills += 1
        spec = victim.current_task
        is_actor = victim.state == "actor"
        # Busy-task reporting happens exactly once, in _run_task's except
        # branch when the killed worker's run_task RPC aborts — oom_reason
        # upgrades that report to OutOfMemoryError. Reporting here too
        # would double-consume retries and double-submit the task.
        victim.oom_reason = reason
        self._kill_proc(victim)
        if is_actor and victim.actor_id:
            if spec is not None:
                self._release_gpus(spec["task_id"])
            try:
                await self.pool.get(self.controller_addr).oneway(
                    "actor_died", actor_id=victim.actor_id, reason=reason)
            except Exception:
                pass

    # ------------------------------------------------- placement bundles

    PG_PREPARE_TTL_S = 30.0

    async def rpc_prepare_bundles(self, pg_id: str, bundles: list) -> dict:
        """Phase 1 of the bundle 2PC: tentatively hold the bundles.
        Expires after PG_PREPARE_TTL_S if no commit arrives (controller
        died mid-2PC)."""
        if self.draining or self._closed:
            return {"ok": False}
        self._pg_prepared[pg_id] = (list(bundles), time.monotonic())
        return {"ok": True}

    async def rpc_commit_bundles(self, pg_id: str) -> dict:
        ent = self._pg_prepared.pop(pg_id, None)
        if ent is None:
            return {"ok": False}
        self._pg_bundles.setdefault(pg_id, []).extend(ent[0])
        return {"ok": True}

    async def rpc_release_bundles(self, pg_id: str) -> dict:
        self._pg_prepared.pop(pg_id, None)
        self._pg_bundles.pop(pg_id, None)
        return {"ok": True}

    def _sweep_prepared_bundles(self) -> None:
        now = time.monotonic()
        for pg_id, (_, ts) in list(self._pg_prepared.items()):
            if now - ts > self.PG_PREPARE_TTL_S:
                self._pg_prepared.pop(pg_id, None)

    def _credit_actor_slot(self, actor_id: str) -> None:
        """Return a locally-created actor's delegated-block slot on its
        death (no-op for scheduled actors; unbacked slots — shed by a
        controller-restart reconciliation — credit nothing)."""
        slot_cpu = self._local_actor_slots.pop(actor_id, None)
        unbacked = actor_id in self._unbacked_actor_slots
        self._unbacked_actor_slots.discard(actor_id)
        if slot_cpu is not None and not unbacked:
            self._lease_blocks[slot_cpu] = (
                self._lease_blocks.get(slot_cpu, 0) + 1)
            self._lease_activity = time.monotonic()

    async def rpc_kill_actor_worker(self, actor_id: str) -> bool:
        for handle in self.workers.values():
            if handle.actor_id == actor_id and handle.state == "actor":
                if handle.current_task is not None:
                    self._release_gpus(handle.current_task["task_id"])
                self._kill_proc(handle)
                self._credit_actor_slot(actor_id)
                return True
        return False

    # -------------------------------------------------------------- objects

    async def rpc_register_object(self, object_id: str, shm_name: str,
                                  size: int) -> None:
        self.object_store.register(object_id, shm_name, size)

    async def rpc_fetch_object(self, object_id: str) -> Optional[bytes]:
        return await asyncio.get_running_loop().run_in_executor(
            None, self.object_store.read_bytes, object_id)

    async def rpc_fetch_object_meta(self, object_id: str) -> Optional[dict]:
        size = self.object_store.size_of(object_id)
        return None if size is None else {"size": size}

    async def rpc_fetch_object_chunk(self, object_id: str, offset: int,
                                     length: int) -> Optional[bytes]:
        """One chunk of a large object (reference parity: chunked
        ObjectManager::Push/Pull, src/ray/object_manager/object_manager.h
        :208-216 + object_buffer_pool.h)."""
        return await asyncio.get_running_loop().run_in_executor(
            None, self.object_store.read_range, object_id, offset, length)

    async def rpc_ensure_arena_room(self, nbytes: int) -> int:
        """Spill until ~nbytes of arena space are free. Returns bytes
        spilled (0 = nothing to spill; caller falls back to a segment)."""
        pressure = self.object_store.arena_pressure()
        if pressure is None:
            return 0
        allocated, capacity = pressure
        deficit = nbytes - max(0, capacity - allocated)
        if deficit <= 0:
            return 0
        return await asyncio.get_running_loop().run_in_executor(
            None, self.object_store.spill_until, deficit)

    async def rpc_free_object(self, object_id: str) -> None:
        self.object_store.free(object_id)

    async def rpc_list_objects(self) -> List[dict]:
        """State-API view of this node's sealed shm objects."""
        return [{"object_id": oid, "size": e.size,
                 "node_id": self.node_id,
                 "backend": ("arena" if e.shm_name.startswith("arena:")
                             else "segment")}
                for oid, e in self.object_store._entries.items()]

    async def rpc_node_stacks(self) -> str:
        """Thread stacks of this daemon's process and every live worker
        (py-spy-equivalent; reference: reporter profile_manager)."""
        from ..util.profiling import dump_stacks
        parts = [f"=== daemon {self.node_id[:12]} (pid {os.getpid()}) ===",
                 dump_stacks()]
        for handle in list(self.workers.values()):
            if handle.state == "dead" or handle.addr is None:
                continue
            parts.append(f"=== worker pid {handle.pid} "
                         f"({handle.state}) ===")
            try:
                parts.append(await asyncio.wait_for(
                    self.pool.get(handle.addr).call("dump_stacks"), 5.0))
            except Exception as e:
                parts.append(f"<unreachable: {e!r}>")
        return "\n".join(parts)

    def _stats(self) -> dict:
        """One stats block for both the node-stats RPC and the gossiped
        view — a single source so the two can't drift."""
        return {
            "num_workers": len([w for w in self.workers.values()
                                if w.state != "dead"]),
            "num_idle": sum(len(v) for v in self.idle.values()),
            "object_store_objects": self.object_store.num_objects,
            "object_store_bytes": self.object_store.bytes_used,
            "bytes_spilled": self.object_store.bytes_spilled,
            "objects_spilled": self.object_store.objects_spilled,
            "oom_kills": self.oom_kills,
            # distributed dispatch: leases granted without a controller
            # round-trip, spills to it, and currently-free block slots
            "local_leases_granted": self.local_leases_granted,
            "local_leases_spilled": self.local_leases_spilled,
            "lease_block_free": sum(self._lease_blocks.values()),
            # one native snapshot (one arena-mutex acquisition) feeds
            # both the pressure fraction and the flat arena_* counters
            # that ride gossip into the /metrics node gauges — the
            # native stats pipeline (reference role:
            # src/ray/stats/metric_defs.h)
            **self._arena_stat_block(),
        }

    def _arena_stat_block(self) -> dict:
        ns = self.object_store.native_stats()
        cap = ns.get("heap_capacity", 0)
        return {
            "arena_pressure": (ns.get("bytes_allocated", 0) / cap
                               if cap else 0.0),
            **{f"arena_{k}": v for k, v in ns.items()
               if k in ("allocs", "alloc_fails", "frees", "coalesces",
                        "crash_sweeps")},
        }

    async def rpc_node_stats(self) -> dict:
        return {"node_id": self.node_id, **self._stats()}

    # ------------------------------------------------------------- monitor

    def _build_view(self) -> dict:
        """Local state snapshot for the gossip channel. Versioned: the
        monitor loop only ships it when it differs from the last one."""
        return {"stats": self._stats(),
                "resources_total": dict(self.resources),
                "draining": self.draining}

    def _apply_commands(self, commands) -> None:
        """Heartbeat-reply command channel (reference parity: ray_syncer
        COMMANDS + raylet DrainRaylet)."""
        for cmd in commands or []:
            if cmd.get("seq", 0) <= self._cmd_applied:
                continue          # redelivered duplicate
            kind = cmd.get("type")
            if kind == "drain":
                self.draining = True
            elif kind == "set_resource":
                name, cap = cmd["name"], cmd["capacity"]
                if cap <= 0:
                    self.resources.pop(name, None)
                else:
                    self.resources[name] = cap
            elif kind == "reclaim_lease_blocks":
                # scheduled work is pending cluster-side: force the next
                # sweep tick (<=0.5s) to return all free delegated slots
                self._lease_activity = 0.0
            else:
                logger.warning("unknown syncer command %r", kind)
            self._cmd_applied = cmd["seq"]

    async def _monitor_loop(self) -> None:
        controller = self.pool.get(self.controller_addr)
        from .config import get_config
        high = get_config().arena_spill_high
        low = get_config().arena_spill_low
        while not self._closed:
            await asyncio.sleep(0.5)
            try:
                view = self._build_view()
                if view != self._last_view:
                    self._sync_version += 1
                    self._last_view = view
                hb_kw = {"cmd_ack": self._cmd_applied}
                if self._sync_version > self._sync_acked:
                    hb_kw.update(sync_version=self._sync_version,
                                 view=view)
                reply = await controller.call(
                    "heartbeat", node_id=self.node_id, **hb_kw)
                if (reply or {}).get("status") == "ok":
                    self._sync_acked = reply.get(
                        "sync_ack", self._sync_acked)
                    self._apply_commands(reply.get("commands"))
                if (reply or {}).get("status") == "unknown":
                    # Controller restarted and lost volatile node state:
                    # re-register, re-announce hosted actors so its
                    # persisted actor table gets fresh addresses, and
                    # report actors it expects here that died during the
                    # outage (their actor_died was lost).
                    reg = await controller.call(
                        "register_node", node_id=self.node_id,
                        addr=self.address, resources=self.resources,
                        labels=self.labels,
                        # committed-bundle ledger: the fresh controller
                        # audits it against its persisted PG table
                        pg_bundles=self._pg_bundles)
                    for pg_id in (reg or {}).get("release_pgs", []):
                        self._pg_bundles.pop(pg_id, None)
                    # fresh controller: resync view, restart command seqs
                    # (its new NodeEntry numbers commands from 1 again)
                    self._sync_acked = 0
                    self._cmd_applied = 0
                    hosted = set()
                    for h in list(self.workers.values()):
                        if h.state == "actor" and h.actor_id:
                            hosted.add(h.actor_id)
                            ack = await controller.call(
                                "actor_started", actor_id=h.actor_id,
                                addr=h.addr, worker_id=h.worker_id,
                                # spec rides along so a controller that
                                # never saw this (locally-created) actor
                                # can still rebuild the directory entry
                                spec=h.current_task,
                                node_id=self.node_id)
                            if (ack or {}).get("status") == "superseded":
                                # a replacement is already queued/running;
                                # two live incarnations must never coexist
                                if h.current_task is not None:
                                    self._release_gpus(
                                        h.current_task["task_id"])
                                self._kill_proc(h)
                    for aid in (reg or {}).get("expected_actors", []):
                        if aid not in hosted:
                            await controller.oneway(
                                "actor_died", actor_id=aid,
                                reason="worker died while the controller "
                                       "was down")
                    # the fresh NodeEntry knows nothing of our delegated
                    # lease slots: re-acquire or shed them
                    await self._reconcile_delegations()
            except Exception:
                pass
            # arena pressure: spill LRU sealed objects down to the low
            # water mark so allocations keep landing in shared memory.
            # Bounded per tick (256 MB) so a huge arena drain can't pause
            # this loop's heartbeats past the controller's node timeout.
            pressure = self.object_store.arena_pressure()
            if pressure is not None:
                allocated, capacity = pressure
                if capacity > 0 and allocated / capacity > high:
                    target = min(int(allocated - low * capacity), 256 << 20)
                    await asyncio.get_running_loop().run_in_executor(
                        None, self.object_store.spill_until, target)
            await self._check_memory_pressure()
            try:
                await self._local_lease_sweep()
                self._sweep_prepared_bundles()
            except Exception:
                pass
            await self._pump_worker_logs(controller)
            for handle in list(self.workers.values()):
                if handle.state == "dead":
                    await self._settle_leased_death(handle)
                    await self._pump_one_log(controller, handle,
                                             final=True)
                    self._log_offsets.pop(handle.worker_id, None)
                    self.workers.pop(handle.worker_id, None)
                    continue
                if handle.proc.poll() is not None:
                    await self._pump_one_log(controller, handle,
                                             final=True)
                    self._log_offsets.pop(handle.worker_id, None)
                    prev_state = handle.state
                    handle.state = "dead"
                    pool = self.idle.get(handle.env_key, [])
                    if handle.worker_id in pool:
                        pool.remove(handle.worker_id)
                    spec = handle.current_task
                    if spec is not None:
                        self._release_gpus(spec["task_id"])
                    if prev_state == "actor" and handle.actor_id:
                        # locally-created actor: its delegated-block
                        # slot frees with the worker (unless shed by a
                        # controller-restart reconciliation)
                        self._credit_actor_slot(handle.actor_id)
                        try:
                            await controller.oneway(
                                "actor_died", actor_id=handle.actor_id,
                                reason=f"worker process {handle.pid} exited "
                                       f"with code {handle.proc.returncode}")
                        except Exception:
                            pass
                    elif prev_state == "busy" and spec is not None:
                        await self._report_failure(
                            spec, f"worker process {handle.pid} died "
                                  f"(exit code {handle.proc.returncode})")
                        try:
                            await controller.oneway(
                                "task_finished", task_id=spec["task_id"],
                                node_id=self.node_id)
                        except Exception:
                            pass
                    self.workers.pop(handle.worker_id, None)


async def _standalone_main(args) -> None:
    host, port = args.controller.rsplit(":", 1)
    daemon = NodeDaemon(
        controller_addr=(host, int(port)),
        session_name=args.session,
        resources=dict(eval(args.resources)) if args.resources else None,
        node_id=args.node_id or None)
    await daemon.start()
    print(f"ray_tpu_torch daemon {daemon.node_id} at {daemon.address}", flush=True)
    while True:
        await asyncio.sleep(3600)


def main() -> None:
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller", required=True)
    parser.add_argument("--session", required=True)
    parser.add_argument("--resources", default="")
    parser.add_argument("--node-id", default="")
    args = parser.parse_args()
    asyncio.run(_standalone_main(args))


if __name__ == "__main__":
    main()
