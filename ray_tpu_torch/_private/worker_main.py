"""Worker process: executes tasks and hosts actors.

Reference parity: python/ray/_private/workers/default_worker.py + the
execution side of _raylet.pyx (task_execution_handler :2283) and
src/ray/core_worker/transport/task_receiver.h / actor_scheduling_queue.h:
- normal tasks run on a thread-pool executor (the RPC loop stays live);
- sync actors execute methods FIFO on a dedicated executor whose width is
  max_concurrency;
- async actors schedule coroutine methods directly on the event loop
  (bounded by a semaphore), like the reference's fiber-based async actors.

Workers embed a full CoreClient, so user code can submit nested tasks,
create actors, and call ray_tpu_torch.get/put from inside tasks.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import inspect
import logging
import os
import signal
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from . import state
from .core import CoreClient, FN_STORE_PREFIX, LoopRunner
from .object_ref import ObjectRef
from .object_store import ShmLocation, write_to_shm
from .serialization import (INLINE_OBJECT_LIMIT, SerializedObject,
                            deserialize_code, serialize)

logger = logging.getLogger(__name__)


class ActorState:
    def __init__(self, actor_id: str, instance: Any,
                 max_concurrency: Optional[int],
                 concurrency_groups: Optional[Dict[str, int]] = None):
        self.actor_id = actor_id
        self.instance = instance
        # Defaults mirror the reference: sync actors 1, async actors 1000 —
        # but an explicit user value is always honored.
        if max_concurrency is None:
            max_concurrency = 1000 if _is_async_actor(instance) else 1
        self.max_concurrency = max(1, max_concurrency)
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.max_concurrency,
            thread_name_prefix=f"actor-{actor_id[:8]}")
        self.async_semaphore = asyncio.Semaphore(self.max_concurrency)
        # Concurrency groups (reference parity: core_worker concurrency
        # groups / task_receiver.h ExecuteConcurrencyGroup): each named
        # group gets its own executor of the declared width, so e.g. an
        # "io" group keeps serving while the default group is saturated.
        self.group_executors: Dict[str, concurrent.futures.ThreadPoolExecutor] = {}
        self.group_semaphores: Dict[str, asyncio.Semaphore] = {}
        for name, width in (concurrency_groups or {}).items():
            width = max(1, int(width))
            self.group_executors[name] = \
                concurrent.futures.ThreadPoolExecutor(
                    max_workers=width,
                    thread_name_prefix=f"actor-{actor_id[:8]}-{name}")
            self.group_semaphores[name] = asyncio.Semaphore(width)
        # Per-caller admission ordering (reference parity:
        # src/ray/core_worker/transport/actor_scheduling_queue.h): calls are
        # admitted to the executor strictly in the caller's submission order.
        self.next_seq: Dict[str, int] = {}
        self.seq_cond = asyncio.Condition()

    def executor_for(self, group: Optional[str]):
        if group:
            ex = self.group_executors.get(group)
            if ex is None:
                raise ValueError(f"unknown concurrency group {group!r}")
            return ex
        return self.executor

    def semaphore_for(self, group: Optional[str]):
        if group:
            sem = self.group_semaphores.get(group)
            if sem is None:
                raise ValueError(f"unknown concurrency group {group!r}")
            return sem
        return self.async_semaphore

    async def admit(self, caller: str, seq) -> None:
        if seq is None or caller is None:
            return
        async with self.seq_cond:
            while self.next_seq.get(caller, 0) < seq:
                await self.seq_cond.wait()

    async def admitted(self, caller: str, seq) -> None:
        if seq is None or caller is None:
            return
        async with self.seq_cond:
            expected = self.next_seq.get(caller, 0)
            if seq >= expected:
                self.next_seq[caller] = seq + 1
            self.seq_cond.notify_all()


def _is_async_actor(instance: Any) -> bool:
    for name in dir(type(instance)):
        if name.startswith("__"):
            continue
        fn = getattr(type(instance), name, None)
        if fn is not None and inspect.iscoroutinefunction(fn):
            return True
    return False


class WorkerRuntime:
    def __init__(self, client: CoreClient, daemon_addr: Tuple[str, int],
                 worker_id: str, node_id: str):
        self.client = client
        self.daemon_addr = daemon_addr
        self.worker_id = worker_id
        self.node_id = node_id
        self.actors: Dict[str, ActorState] = {}
        self.current_actor_id: Optional[str] = None
        # set once a task or an actor pinned this process to its GPUs
        self._gpu_pinned = False
        self.task_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="task")
        client.server.register("run_task", self.rpc_run_task)
        client.server.register("run_task_batch", self.rpc_run_task_batch)
        client.server.register("create_actor", self.rpc_create_actor)
        client.server.register("call_actor", self.rpc_call_actor)
        client.server.register("shutdown_worker", self.rpc_shutdown_worker)
        client.server.register("skip_actor_seq", self.rpc_skip_actor_seq)
        client.server.register("stream_ack", self.rpc_stream_ack)
        client.server.register("stream_cancel", self.rpc_stream_cancel)
        client.server.register("dump_stacks", self.rpc_dump_stacks)
        client.server.register("memory_summary", self.rpc_memory_summary)
        # Function cache (reference parity: function manager / fn export
        # via GCS KV): the same task function is deserialized once per
        # worker, not once per invocation — cloudpickle.loads of a big
        # closure dominates small-task latency otherwise.
        self._fn_cache: Dict[bytes, Any] = {}
        # Function-store fetch plumbing: in-flight dedup (N concurrent
        # tasks of one new fn -> one kv_get) and a small raw-blob LRU so
        # actor creations can re-deserialize without re-fetching.
        self._fn_fetches: Dict[str, asyncio.Future] = {}
        self._code_blobs: Dict[str, bytes] = {}
        # generator_id -> [acked_count, waiter_event, cancelled]
        self._stream_acks: Dict[str, list] = {}

    def _deserialize_fn(self, blob: bytes):
        import hashlib
        key = hashlib.sha1(blob).digest()
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = deserialize_code(blob)
            if len(self._fn_cache) >= 256:
                self._fn_cache.pop(next(iter(self._fn_cache)))
            self._fn_cache[key] = fn
        return fn

    async def _fetch_blob(self, fn_hash: str) -> bytes:
        """Fetch a content-addressed code blob from the controller's
        function store, deduping concurrent fetches of the same hash."""
        blob = self._code_blobs.get(fn_hash)
        if blob is not None:
            return blob
        fut = self._fn_fetches.get(fn_hash)
        if fut is None:
            fut = asyncio.ensure_future(self.client.pool.get(
                self.client.controller_addr).call(
                "kv_get", key=FN_STORE_PREFIX + fn_hash))
            self._fn_fetches[fn_hash] = fut
        try:
            blob = await asyncio.shield(fut)
        finally:
            self._fn_fetches.pop(fn_hash, None)
        if blob is None:
            raise RuntimeError(
                f"function {fn_hash} missing from the function store "
                "(controller restarted without persistence?)")
        if len(self._code_blobs) >= 16:
            self._code_blobs.pop(next(iter(self._code_blobs)))
        self._code_blobs[fn_hash] = blob
        return blob

    @staticmethod
    def _resolve_descriptor(desc: dict):
        """Cross-language function descriptor -> python callable
        (reference parity: ray.cross_language / FunctionDescriptor —
        non-Python drivers, e.g. the C++ API, name functions as
        module + qualname instead of shipping pickled code)."""
        import importlib
        obj = importlib.import_module(desc["module"])
        for part in desc["name"].split("."):
            obj = getattr(obj, part)
        return obj

    async def _load_fn(self, spec: dict):
        """Resolve the task code object for a spec.

        Small blobs ride inline (fn_blob); large ones arrive as a content
        hash and are fetched once from the controller's function store,
        then cached (reference parity: function_manager.py lazy import).
        Cross-language callers send a descriptor instead (fn_desc).
        """
        desc = spec.get("fn_desc")
        if desc is not None:
            return self._resolve_descriptor(desc)
        blob = spec.get("fn_blob")
        if blob is not None:
            return self._deserialize_fn(blob)
        fn_hash = spec["fn_hash"]
        fn = self._fn_cache.get(bytes.fromhex(fn_hash))
        if fn is not None:
            return fn
        return self._deserialize_fn(await self._fetch_blob(fn_hash))

    # ------------------------------------------------------------- helpers

    async def _resolve_args(self, args_blob: bytes,
                            arg_locations: Optional[dict] = None):
        args, kwargs = SerializedObject.from_flat(args_blob).deserialize()
        # Top-level ObjectRefs are resolved to values (reference semantics:
        # python/ray/_raylet.pyx argument unwrapping); nested refs stay
        # refs. Daemon-prefetched locations (dependency_manager.h parity)
        # are primed first so the gets skip the owner round trip, and all
        # fetches run CONCURRENTLY — a k-arg task pays one fetch latency,
        # not k.
        for oid, loc in (arg_locations or {}).items():
            if self.client.memory_store.get_entry(oid) is not None:
                continue
            if isinstance(loc, tuple) and loc[0] == "payload":
                # small object forwarded by the daemon's prefetch
                self.client.memory_store.put_serialized(
                    oid, SerializedObject.from_flat(loc[1]))
            else:
                self.client.memory_store.put_location(oid, loc)
        args = list(args)
        kwargs = dict(kwargs)
        coros, slots = [], []
        for i, a in enumerate(args):
            if isinstance(a, ObjectRef):
                coros.append(self.client.aio_get(a))
                slots.append(("a", i))
        for k, v in kwargs.items():
            if isinstance(v, ObjectRef):
                coros.append(self.client.aio_get(v))
                slots.append(("k", k))
        if coros:
            values = await asyncio.gather(*coros)
            for (kind, key), val in zip(slots, values):
                if kind == "a":
                    args[key] = val
                else:
                    kwargs[key] = val
        return tuple(args), kwargs

    def _grace_pin_result_refs(self, value: Any) -> None:
        """ObjectRefs embedded in a result must survive the window
        between this worker dropping ITS references (the task frame dies
        right after the push) and the consumer registering on
        deserialize — otherwise the object is freed underneath and a
        later get hangs/fails (the classic borrowed-refs-in-return race;
        the reference threads borrow metadata through the task reply,
        reference_count.h). Holding the ObjectRef OBJECTS for a 120s
        grace covers both owned refs (local count delays the free) and
        borrowed pass-through refs (the -1 borrower event to the true
        owner is deferred until these are dropped)."""
        held = []

        def walk(obj, depth=0):
            if isinstance(obj, ObjectRef):
                held.append(obj)
            elif depth < 2 and isinstance(obj, (list, tuple)):
                for x in obj:
                    walk(x, depth + 1)
            elif depth < 2 and isinstance(obj, dict):
                for x in obj.values():
                    walk(x, depth + 1)

        walk(value)
        if held:
            asyncio.get_running_loop().call_later(120.0, held.clear)

    async def _push_result(self, owner_addr, object_id: str, value: Any,
                           task_id: Optional[str] = None,
                           **stream_kw) -> None:
        self._grace_pin_result_refs(value)
        serialized = serialize(value)
        owner = self.client.pool.get(tuple(owner_addr))
        if serialized.total_size <= INLINE_OBJECT_LIMIT:
            await owner.oneway("object_ready", object_id=object_id,
                               payload=serialized.to_flat(), task_id=task_id,
                               **stream_kw)
        else:
            loop = asyncio.get_running_loop()
            shm_name, size = await loop.run_in_executor(
                None, lambda: write_to_shm(
                    object_id, serialized, self.client.session_name,
                    arena_room=self.client.arena_room))
            await self.client.pool.get(self.daemon_addr).call(
                "register_object", object_id=object_id,
                shm_name=shm_name, size=size)
            location = ShmLocation(self.daemon_addr, shm_name, size)
            await owner.oneway("object_ready", object_id=object_id,
                               location=location, task_id=task_id,
                               **stream_kw)

    async def _push_error(self, owner_addr, object_id: str, error: Exception,
                          task_id: Optional[str] = None,
                          object_ids=None, **stream_kw) -> None:
        import pickle
        try:
            pickle.loads(pickle.dumps(error))
        except Exception:
            from ..exceptions import RayTpuError
            error = RayTpuError(f"{type(error).__name__}: {error}")
        try:
            await self.client.pool.get(tuple(owner_addr)).oneway(
                "object_ready", object_id=object_id, error=error,
                task_id=task_id, object_ids=object_ids, **stream_kw)
        except Exception:
            logger.exception("failed to push error to owner")

    # ------------------------------------------------------------- tasks

    def _apply_gpu_isolation(self, spec: dict) -> None:
        """Pin this process to the task's GPUs (CUDA_VISIBLE_DEVICES).
        CUDA reads the variable once, at the process's first CUDA call,
        so once CUDA is up a pin to other devices cannot take effect:
        the daemon never hands such a worker a differently pinned task
        (WorkerHandle.gpu_pin), and this refuses one loudly rather than
        run it on the wrong device."""
        gpus = spec.get("_gpu_ids")
        if gpus is None:
            return
        from ..accelerators.gpu import (GPUAcceleratorManager,
                                        cuda_initialized)
        want = GPUAcceleratorManager.visible_value(gpus)
        have = os.environ.get("CUDA_VISIBLE_DEVICES")
        if cuda_initialized() and have != want:
            raise RuntimeError(
                f"this worker initialized CUDA with CUDA_VISIBLE_DEVICES="
                f"{have!r}; it cannot run a task pinned to {want!r}")
        GPUAcceleratorManager.set_current_process_visible_accelerators(
            gpus)
        self._gpu_pinned = True

    def _cuda_unpinned(self) -> bool:
        """Whether unpinned work (a CPU task or actor) initialized CUDA
        here: such a process holds a context over every device of the
        node, so the daemon must never offer it a GPU pin after
        (``WorkerHandle.gpu_pin``)."""
        from ..accelerators.gpu import cuda_initialized
        return not self._gpu_pinned and cuda_initialized()

    async def rpc_run_task(self, spec: dict) -> dict:
        if spec.get("_leased"):
            return await self.rpc_run_task_batch([spec])
        reply = await self._execute_task(spec)
        if self._cuda_unpinned():
            reply = dict(reply, cuda_unpinned=True)
        return reply

    async def rpc_run_task_batch(self, specs: list) -> dict:
        """Lease-path batch dispatch: ONE wire frame carries K tasks and
        the daemon/controller notifications are per-batch, so tiny tasks
        cost ~1 frame each (the result push) instead of ~6. Results
        still stream to the owner per task as they finish.

        Reference parity intent: the raylet always knows its workers'
        work (self-report) and workers feed the GCS task-event buffer
        (task_event_buffer.h) — both preserved, amortized per batch."""
        daemon = self.client.pool.get(self.daemon_addr)
        controller = self.client.pool.get(self.client.controller_addr)
        try:
            # slim specs: just what the daemon's _report_failure needs
            await daemon.oneway(
                "leased_batch_started", worker_id=self.worker_id,
                specs=[{k: s.get(k) for k in
                        ("task_id", "name", "owner_addr", "return_id",
                         "return_ids", "max_retries", "_leased")}
                       for s in specs])
            await controller.oneway(
                "task_event_push_batch", node_id=self.node_id,
                events=[{"task_id": s["task_id"],
                         "name": s.get("name", ""), "state": "RUNNING"}
                        for s in specs])
        except Exception:
            pass
        states = []
        # Markers tell the daemon how far the batch got if this worker
        # dies. For an all-retriable batch the daemon may safely resubmit
        # ambiguous members, so a 50ms throttle keeps the tiny-task storm
        # at ~zero marker frames; one max_retries=0 member forces a
        # marker before EVERY member — a completed at-most-once member
        # misclassified as unstarted would be re-executed. The final
        # marker can still die with the worker; the daemon gates
        # resubmission of ambiguous members on max_retries > 0.
        has_amo = any((s.get("max_retries") or 0) <= 0 for s in specs)
        last_progress = time.monotonic()
        for i, spec in enumerate(specs):
            if i > 0 and (has_amo
                          or time.monotonic() - last_progress >= 0.05):
                try:
                    await daemon.oneway(
                        "leased_batch_progress",
                        worker_id=self.worker_id, index=i)
                    last_progress = time.monotonic()
                except Exception:
                    pass
            try:
                reply = await self._execute_task(spec)
                st = ("FAILED" if reply.get("status") == "error"
                      else "FINISHED")
            except Exception:
                # e.g. result push raced a connection blip: confine the
                # damage to THIS task (fail its refs if the owner is
                # still reachable) and keep draining the batch — an
                # escaping exception would strand every later member
                from ..exceptions import TaskError
                tb = traceback.format_exc()
                try:
                    await self._push_error(
                        spec["owner_addr"], spec["return_id"],
                        TaskError(spec.get("name", "task"), tb),
                        task_id=spec["task_id"],
                        object_ids=(spec.get("return_ids")
                                    or [spec["return_id"]]))
                except Exception:
                    pass
                st = "FAILED"
            states.append(st)
        try:
            await daemon.oneway(
                "leased_batch_done", worker_id=self.worker_id,
                cuda_unpinned=self._cuda_unpinned())
            await controller.oneway(
                "task_event_push_batch", node_id=self.node_id,
                events=[{"task_id": s["task_id"],
                         "name": s.get("name", ""), "state": st}
                        for s, st in zip(specs, states)])
        except Exception:
            pass
        return {"status": "ok"}

    async def _execute_task(self, spec: dict) -> dict:
        from ..exceptions import TaskError
        loop = asyncio.get_running_loop()
        streaming = spec.get("num_returns") == "streaming"
        try:
            self._apply_gpu_isolation(spec)
            fn = await self._load_fn(spec)
            args, kwargs = await self._resolve_args(
                spec["args_blob"], spec.get("_arg_locations"))
            from ..util import tracing
            if spec.get("_trace_ctx") and not tracing.is_enabled():
                # the submitter traces: join without requiring every
                # worker env to set RAY_TPU_TRACE independently
                tracing.enable()
            with tracing.span(spec.get("name", "task"), "task::execute",
                              parent=spec.get("_trace_ctx"),
                              task_id=spec.get("task_id", "")[:16]):
                if streaming:
                    # The call itself must not block (generators return
                    # instantly); iteration happens below, item by item.
                    result = fn(*args, **kwargs)
                elif inspect.iscoroutinefunction(fn):
                    result = await fn(*args, **kwargs)
                else:
                    # copy_context: the ambient trace span (and any other
                    # contextvars) must be visible inside the user fn
                    # even though it runs on the executor thread
                    import contextvars
                    cctx = contextvars.copy_context()
                    result = await loop.run_in_executor(
                        self.task_executor,
                        lambda: cctx.run(fn, *args, **kwargs))
        except Exception:
            tb = traceback.format_exc()
            await self._push_error(
                spec["owner_addr"], spec["return_id"],
                TaskError(spec.get("name", "task"), tb),
                task_id=spec["task_id"],
                object_ids=spec.get("return_ids") or [spec["return_id"]])
            return {"status": "error"}
        if tracing.is_enabled():
            # cluster-trace assembly: rate-limited incremental flush,
            # plus a trailing flush so a burst's tail isn't stranded
            # until the next traced task
            tracing.flush_to_kv()
            loop.call_later(1.5, tracing.flush_to_kv, 0.0)
        if streaming:
            return await self._stream_results(spec, result)
        num_returns = spec.get("num_returns", 1)
        if num_returns > 1:
            return_ids = spec["return_ids"]
            if not isinstance(result, (tuple, list)) \
                    or len(result) != num_returns:
                err = TaskError(
                    spec.get("name", "task"),
                    f"task declared num_returns={num_returns} but returned "
                    f"{type(result).__name__} of length "
                    f"{len(result) if hasattr(result, '__len__') else 'n/a'}")
                await self._push_error(
                    spec["owner_addr"], spec["return_id"], err,
                    task_id=spec["task_id"], object_ids=return_ids)
                return {"status": "error"}
            for i, (rid, part) in enumerate(zip(return_ids, result)):
                await self._push_result(
                    spec["owner_addr"], rid, part,
                    task_id=spec["task_id"] if i == len(return_ids) - 1
                    else None)
        else:
            await self._push_result(spec["owner_addr"], spec["return_id"],
                                    result, task_id=spec["task_id"])
        return {"status": "ok"}

    # ---------------------------------------------------------- streaming

    async def rpc_stream_ack(self, generator_id: str, index: int) -> None:
        entry = self._stream_acks.get(generator_id)
        if entry is not None:
            entry[0] = max(entry[0], index + 1)
            entry[1].set()

    async def rpc_stream_cancel(self, generator_id: str) -> None:
        """Consumer abandoned the stream: stop producing and unblock any
        backpressure wait."""
        entry = self._stream_acks.get(generator_id)
        if entry is not None:
            entry[2] = True
            entry[1].set()

    async def _stream_results(self, spec: dict, result,
                              executor=None) -> dict:
        """Drive a streaming task: push each yielded item to the owner,
        then an end-of-stream marker. Reference parity:
        task_manager.h:364 (HandleReportGeneratorItemReturns) +
        _raylet.pyx execute_streaming_generator.

        Backpressure: with spec['backpressure'] = N, pause whenever more
        than N pushed items are unconsumed; the owner acks each item its
        consumer takes (rpc_stream_ack). For actor methods `executor` is
        the actor's own executor, preserving the sync-actor serial
        execution guarantee for the generator body.
        """
        from ..exceptions import TaskError
        loop = asyncio.get_running_loop()
        gen_id = spec["return_id"]
        owner_addr = spec["owner_addr"]
        backpressure = spec.get("backpressure")
        # [acked_count, wake_event, cancelled]
        self._stream_acks[gen_id] = [0, asyncio.Event(), False]
        executor = executor or self.task_executor
        name = spec.get("name", "task")

        def _bad_type_err():
            return TaskError(
                name,
                f'num_returns="streaming" requires the function to '
                f"return a generator/iterable, got "
                f"{type(result).__name__}")

        async def wait_capacity(count: int) -> bool:
            """True = produce the next item; False = consumer cancelled."""
            entry = self._stream_acks[gen_id]
            if backpressure:
                while count - entry[0] >= backpressure and not entry[2]:
                    entry[1].clear()
                    await entry[1].wait()
            return not entry[2]

        async def push_item(count: int, item) -> None:
            await self._push_result(
                owner_addr, f"{gen_id}_{count}", item,
                stream_of=gen_id, stream_index=count,
                worker_addr=self.client.address)

        async def push_err(count: int, err) -> None:
            await self._push_error(
                owner_addr, f"{gen_id}_{count}", err,
                stream_of=gen_id, stream_index=count,
                worker_addr=self.client.address)

        def drive_sync() -> int:
            """Drive a SYNC generator as ONE executor job: iteration,
            pushes and backpressure waits all happen while holding the
            executor slot, so a sync actor's streaming method occupies
            the actor for the stream's whole life (reference semantics —
            no other method interleaves between yields)."""
            count = 0

            def run(coro):
                return asyncio.run_coroutine_threadsafe(coro, loop).result()

            try:
                it = iter(result)
            except TypeError:
                run(push_err(0, _bad_type_err()))
                return 1
            while True:
                if not run(wait_capacity(count)):
                    if hasattr(result, "close"):
                        result.close()
                    return count
                try:
                    item = next(it)
                except StopIteration:
                    return count
                except Exception:
                    run(push_err(count, TaskError(
                        name, traceback.format_exc())))
                    return count + 1
                run(push_item(count, item))
                count += 1

        async def drive_async() -> int:
            count = 0
            while True:
                if not await wait_capacity(count):
                    await result.aclose()
                    return count
                try:
                    item = await result.__anext__()
                except StopAsyncIteration:
                    return count
                except Exception:
                    await push_err(count, TaskError(
                        name, traceback.format_exc()))
                    return count + 1
                await push_item(count, item)
                count += 1

        count = 0
        try:
            if hasattr(result, "__anext__"):
                count = await drive_async()
            else:
                count = await loop.run_in_executor(executor, drive_sync)
        finally:
            self._stream_acks.pop(gen_id, None)
            try:
                await self.client.pool.get(tuple(owner_addr)).oneway(
                    "stream_end", generator_id=gen_id, count=count,
                    task_id=spec["task_id"])
            except Exception:
                logger.exception("failed to push stream end")
        return {"status": "ok"}

    # ------------------------------------------------------------- actors

    async def rpc_create_actor(self, spec: dict) -> dict:
        loop = asyncio.get_running_loop()
        actor_id = spec["actor_id"]
        try:
            self._apply_gpu_isolation(spec)
            # Deserialize a FRESH class object per actor creation (not via
            # _fn_cache): class-attribute state must stay per-actor when
            # several actors of one class share this worker process.
            # (Descriptor-named classes are imported, not deserialized —
            # cross-language actors share the imported class object.)
            desc = spec.get("fn_desc")
            if desc is not None:
                cls = self._resolve_descriptor(desc)
            else:
                blob = spec.get("fn_blob")
                if blob is None:
                    blob = await self._fetch_blob(spec["fn_hash"])
                cls = deserialize_code(blob)
            args, kwargs = await self._resolve_args(
                spec["args_blob"], spec.get("_arg_locations"))
            self.current_actor_id = actor_id
            from ..util import tracing
            if spec.get("_trace_ctx") and not tracing.is_enabled():
                tracing.enable()
            with tracing.span(spec.get("name", "actor"),
                              "actor::create",
                              parent=spec.get("_trace_ctx"),
                              actor_id=actor_id[:16]):
                instance = await loop.run_in_executor(
                    None, lambda: cls(*args, **kwargs))
            if tracing.is_enabled():
                tracing.flush_to_kv()
                loop.call_later(1.5, tracing.flush_to_kv, 0.0)
        except Exception:
            tb = traceback.format_exc()
            from ..exceptions import ActorDiedError
            await self._push_error(
                spec["owner_addr"], spec["return_id"],
                ActorDiedError(actor_id,
                               f"__init__ failed:\n{tb}"),
                task_id=spec["task_id"])
            # the daemon pools this worker again: say if it now holds
            # an unpinned CUDA context
            return {"status": "error", "error_tb": tb,
                    "cuda_unpinned": self._cuda_unpinned()}
        self.actors[actor_id] = ActorState(
            actor_id, instance, spec.get("max_concurrency"),
            spec.get("concurrency_groups"))
        if not spec.get("is_restart"):
            await self._push_result(spec["owner_addr"], spec["return_id"],
                                    None, task_id=spec["task_id"])
        return {"status": "ok"}

    async def rpc_call_actor(self, actor_id: str, method: str,
                             args_blob: bytes, caller=None,
                             seq=None, return_id=None, streaming=False,
                             owner_addr=None, backpressure=None,
                             concurrency_group=None) -> dict:
        actor = self.actors.get(actor_id)
        if actor is None:
            return {"status": "error",
                    "error_tb": f"actor {actor_id[:12]} not hosted here"}
        loop = asyncio.get_running_loop()
        try:
            args, kwargs = await self._resolve_args(args_blob)
            if streaming:
                # Call returns a generator immediately; items are pushed to
                # the caller in a background task so the RPC (and the
                # actor's admission queue) don't block for the stream's
                # lifetime.
                fn = getattr(actor.instance, method)
                await actor.admit(caller, seq)
                gen = fn(*args, **kwargs)
                spec = {"return_id": return_id, "owner_addr": owner_addr,
                        "task_id": None, "backpressure": backpressure,
                        "name": method}
                # Drive the generator body on the ACTOR's executor so a
                # sync actor's serial-execution guarantee holds for
                # streaming methods too. The sleep(0) lets the stream
                # task run to its run_in_executor submission BEFORE we
                # mark this seq admitted (ready-queue order is FIFO) —
                # otherwise the next call's executor job could be queued
                # ahead of the generator body.
                asyncio.ensure_future(
                    self._stream_results(
                        spec, gen,
                        executor=actor.executor_for(concurrency_group)))
                await asyncio.sleep(0)
                await actor.admitted(caller, seq)
                return {"status": "streaming"}
            if method == "__rtpu_compiled_loop__":
                # the compiled-graph (ADAG) execution loop of the
                # reference (ray_tpu/dag/compiled_dag.py) is not ported
                # yet: it comes with the port's dag/ package
                raise NotImplementedError(
                    "compiled graphs are not ported to ray_tpu_torch yet "
                    "(ROADMAP.md section A8: dag/compiled_dag)")
            else:
                fn = getattr(actor.instance, method)
                await actor.admit(caller, seq)
                if inspect.iscoroutinefunction(fn):
                    sem = actor.semaphore_for(concurrency_group)

                    async def _run():
                        async with sem:
                            return await fn(*args, **kwargs)
                    work = asyncio.ensure_future(_run())
                else:
                    work = loop.run_in_executor(
                        actor.executor_for(concurrency_group),
                        lambda: fn(*args, **kwargs))
                await actor.admitted(caller, seq)
                result = await work
        except Exception:
            await actor.admitted(caller, seq)
            return {"status": "error", "error_tb": traceback.format_exc()}
        self._grace_pin_result_refs(result)
        serialized = serialize(result)
        if serialized.total_size <= INLINE_OBJECT_LIMIT:
            return {"status": "ok", "payload": serialized.to_flat()}
        # Register under the caller's return_id so the owner's free_object
        # (by return_id) reaches the right segment.
        object_id = return_id or os.urandom(16).hex()
        shm_name, size = await loop.run_in_executor(
            None, lambda: write_to_shm(
                object_id, serialized, self.client.session_name,
                arena_room=self.client.arena_room))
        await self.client.pool.get(self.daemon_addr).call(
            "register_object", object_id=object_id, shm_name=shm_name,
            size=size)
        return {"status": "location",
                "location": ShmLocation(self.daemon_addr, shm_name, size)}

    async def rpc_skip_actor_seq(self, actor_id: str, caller: str,
                                 seq) -> None:
        actor = self.actors.get(actor_id)
        if actor is not None:
            await actor.admitted(caller, seq)

    async def rpc_dump_stacks(self) -> str:
        from ..util.profiling import dump_stacks
        return dump_stacks()

    async def rpc_memory_summary(self) -> dict:
        from ..util.profiling import memory_summary
        return memory_summary()

    async def rpc_shutdown_worker(self) -> dict:
        from ..util import tracing
        if tracing.is_enabled():
            tracing.flush_to_kv(0.0)   # the ring's tail must not die here
        asyncio.get_running_loop().call_later(0.05, sys.exit, 0)
        return {"status": "ok"}


async def async_main(args) -> None:
    chost, cport = args.controller.rsplit(":", 1)
    dhost, dport = args.daemon.rsplit(":", 1)
    controller_addr = (chost, int(cport))
    daemon_addr = (dhost, int(dport))
    loop_runner = LoopRunner(loop=asyncio.get_running_loop())
    client = CoreClient(controller_addr, daemon_addr, args.session,
                        loop_runner=loop_runner, worker_id=args.worker_id)
    await client.async_start()
    state.set_client(client)
    runtime = WorkerRuntime(client, daemon_addr, args.worker_id, args.node_id)
    client.runtime_context = {
        "worker_id": args.worker_id, "node_id": args.node_id,
        "runtime": runtime,
    }
    daemon = client.pool.get(daemon_addr)
    await daemon.call("register_worker", worker_id=args.worker_id,
                      addr=client.address)
    # Exit if the daemon goes away (parent supervision).
    while True:
        await asyncio.sleep(2.0)
        try:
            await daemon.call("node_stats")
        except Exception:
            logger.warning("daemon unreachable; worker exiting")
            os._exit(1)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller", required=True)
    parser.add_argument("--daemon", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--session", required=True)
    args = parser.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker {args.worker_id[:8]}] %(levelname)s %(message)s")
    signal.signal(signal.SIGTERM, lambda *a: os._exit(0))
    try:
        asyncio.run(async_main(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
