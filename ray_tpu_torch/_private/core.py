"""CoreClient: the per-process runtime used by drivers AND workers.

Reference parity: src/ray/core_worker/core_worker.h (SubmitTask/CreateActor/
SubmitActorTask/Get/Put/Wait) + reference_count.h, collapsed into one
asyncio-native Python class. Key design choices (deliberately different from
the reference's C++ lease-based dispatch):

- Ownership: the submitting process owns task results. Workers push results
  directly to the owner's RPC server (small inline, large as a shm location),
  so `get` never touches the control plane.
- Actor calls go direct caller->actor-worker over a cached connection (one
  RTT, result inline in the response) — the controller is only consulted to
  resolve the actor's address. This is the reference's ActorTaskSubmitter
  fast path (transport/actor_task_submitter.h).
- Normal tasks go through the controller's scheduler (centralized for now;
  the lease-reuse optimization lives in the daemon's worker pool).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import state
from .ids import ActorID, ObjectID, TaskID, WorkerID
from .object_ref import ObjectRef
from .object_store import (MemoryStore, ShmLocation, read_from_shm,
                           write_to_shm)
from .protocol import ClientPool, ConnectionLost, RpcServer
from .serialization import (INLINE_OBJECT_LIMIT, SerializedObject,
                            serialize, serialize_code)
from .streaming import ObjectRefGenerator, StreamState
from ..exceptions import (ActorDiedError, ActorError, GetTimeoutError,
                          ObjectLostError, RayTpuError, TaskCancelledError,
                          TaskError, WorkerCrashedError)

logger = logging.getLogger(__name__)

from .config import FN_STORE_PREFIX, get_config

NUM_TPUS_REFUSED = ("ray_tpu_torch schedules GPUs: use num_gpus "
                    "(pinned with CUDA_VISIBLE_DEVICES), not num_tpus")


class LoopRunner:
    """An asyncio loop, either owned (background thread) or external."""

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        if loop is not None:
            self.loop = loop
            self._thread = None
        else:
            self.loop = asyncio.new_event_loop()
            started = threading.Event()

            def _run():
                asyncio.set_event_loop(self.loop)
                self.loop.call_soon(started.set)
                self.loop.run_forever()

            self._thread = threading.Thread(target=_run, daemon=True,
                                            name="ray_tpu_torch-io")
            self._thread.start()
            started.wait()

    def run_sync(self, coro, timeout: Optional[float] = None):
        if self.on_loop_thread():
            raise RuntimeError(
                "blocking ray_tpu_torch API called from the event-loop thread; "
                "inside async actors use `await ref` / the aio_* APIs.")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise GetTimeoutError("operation timed out")

    def call_soon(self, coro) -> None:
        try:
            asyncio.run_coroutine_threadsafe(coro, self.loop)
        except RuntimeError:
            pass  # loop already closed (interpreter shutdown)

    def on_loop_thread(self) -> bool:
        try:
            return asyncio.get_running_loop() is self.loop
        except RuntimeError:
            return False

    def stop(self) -> None:
        """Stop an OWNED loop thread (no-op for external loops)."""
        if self._thread is not None:
            try:
                self.loop.call_soon_threadsafe(self.loop.stop)
            except RuntimeError:
                return   # loop already closed (interpreter shutdown)
            self._thread.join(timeout=5)


class ReferenceCounter:
    """Distributed ref counting (owner-side authoritative).

    Reference parity: src/ray/core_worker/reference_count.h — simplified to
    local counts + a borrower count maintained at the owner.
    """

    def __init__(self, client: "CoreClient"):
        self._client = client
        self._local: Dict[str, int] = {}
        self._owner_of: Dict[str, Optional[Tuple[str, int]]] = {}
        self._borrowers: Dict[str, int] = {}   # owner side: remote holders
        self._owned: Dict[str, bool] = {}      # ids this process owns
        self._lock = threading.Lock()

    def register_owned(self, object_id: str) -> None:
        with self._lock:
            self._owned[object_id] = True
            self._borrowers.setdefault(object_id, 0)

    def add_local_ref(self, object_id: str, owner_addr, borrowed: bool) -> None:
        notify = False
        with self._lock:
            n = self._local.get(object_id, 0)
            self._local[object_id] = n + 1
            self._owner_of[object_id] = owner_addr
            if borrowed and n == 0 and not self._owned.get(object_id):
                notify = True
        if notify and owner_addr and not self._client.is_shutdown:
            self._client.loop_runner.call_soon(
                self._client._send_ref_event(owner_addr, object_id, +1))

    def remove_local_ref(self, object_id: str) -> None:
        if self._client is None or self._client.is_shutdown:
            return
        free = notify = False
        owner_addr = None
        with self._lock:
            n = self._local.get(object_id, 0) - 1
            if n <= 0:
                self._local.pop(object_id, None)
                owner_addr = self._owner_of.pop(object_id, None)
                if self._owned.get(object_id):
                    if self._borrowers.get(object_id, 0) <= 0:
                        free = True
                else:
                    notify = True
            else:
                self._local[object_id] = n
        if notify and owner_addr:
            self._client.loop_runner.call_soon(
                self._client._send_ref_event(owner_addr, object_id, -1))
        if free:
            self._client._free_owned(object_id)

    def on_borrower_event(self, object_id: str, delta: int) -> None:
        free = False
        with self._lock:
            n = self._borrowers.get(object_id, 0) + delta
            self._borrowers[object_id] = n
            if (n <= 0 and self._owned.get(object_id)
                    and self._local.get(object_id, 0) == 0):
                free = True
        if free:
            self._client._free_owned(object_id)

    def pin(self, object_id: str) -> None:
        """Prevent freeing while e.g. a task holding this arg is in flight."""
        with self._lock:
            self._borrowers[object_id] = self._borrowers.get(object_id, 0) + 1

    def unpin(self, object_id: str) -> None:
        self.on_borrower_event(object_id, -1)


class PendingTask:
    __slots__ = ("spec", "retries_left", "arg_ids")

    def __init__(self, spec: dict, retries_left: int, arg_ids=()):
        self.spec = spec
        self.retries_left = retries_left
        self.arg_ids = tuple(arg_ids)


class CoreClient:
    """Per-process runtime: submission, ownership, object access."""

    def __init__(self, controller_addr: Tuple[str, int],
                 node_addr: Optional[Tuple[str, int]],
                 session_name: str,
                 loop_runner: Optional[LoopRunner] = None,
                 worker_id: Optional[str] = None,
                 job_id: Optional[str] = None,
                 namespace: str = "default"):
        self.controller_addr = tuple(controller_addr)
        self.node_addr = tuple(node_addr) if node_addr else None
        self.session_name = session_name
        self.namespace = namespace
        self.worker_id = worker_id or WorkerID.generate().hex()
        self.job_id = job_id
        self.loop_runner = loop_runner or LoopRunner()
        self.memory_store = MemoryStore()
        self.ref_counter = ReferenceCounter(self)
        self.pool = ClientPool()
        self.server = RpcServer()
        self.server.register_object(self)
        self.address: Optional[Tuple[str, int]] = None
        self.is_shutdown = False
        self._pending_tasks: Dict[str, PendingTask] = {}
        # actor_id -> (addr or None, generation); cached resolution
        self._actor_addrs: Dict[str, Tuple[str, int]] = {}
        # actor_id -> its creation's submission, done once the actor is
        # created locally or registered with the controller: a method
        # call made meanwhile waits for it, since the controller learns
        # of a daemon-local actor only after its __init__ (the
        # reference asks at once and gives up after 4 s, less than a
        # cold worker's torch import takes)
        self._local_creations: Dict[str, asyncio.Future] = {}
        # Per-actor submission sequence numbers (ordering guarantee like the
        # reference's SequentialActorSubmitQueue).
        self._actor_seq: Dict[str, int] = {}
        self._actor_seq_lock = threading.Lock()
        self._actor_resolve_locks: Dict[str, asyncio.Lock] = {}
        self._shm_keepalive: Dict[str, Any] = {}
        # Pull dedup: object_id -> future resolved when the pull lands.
        self._inflight_pulls: Dict[str, asyncio.Future] = {}
        # Lineage (reference parity: task_manager.h:278 ResubmitTask):
        # return object_id -> producing task spec, kept after completion so
        # a lost object can be recomputed. Bounded FIFO.
        self._lineage: "OrderedDict[str, dict]" = OrderedDict()
        self._lineage_cap = get_config().lineage_cap
        # byte bound too: specs retain args/fn blobs (reference parity:
        # RayConfig max_lineage_bytes)
        self._lineage_max_bytes = get_config().lineage_max_bytes
        self._lineage_bytes = 0
        self._reconstructing: Dict[str, asyncio.Future] = {}
        # Streaming generators we own: generator_id -> StreamState.
        self._streams: Dict[str, "StreamState"] = {}
        # pubsub topic -> callbacks (messages arrive via rpc_pubsub_message)
        self._subscriptions: Dict[str, list] = {}
        # Function store (reference parity: _private/function_manager.py —
        # fn/class defs exported once to GCS KV, workers lazy-import):
        # fn_hash -> asyncio.Future resolved when the KV export landed.
        self._exported_fns: Dict[str, asyncio.Future] = {}
        # Submit batching (reference parity: the lease/fast-path goal of
        # normal_task_submitter.h — amortize control-plane RPCs): specs
        # issued in the same loop tick ride one controller call.
        self._submit_batch: List[Tuple[dict, asyncio.Future]] = []
        self._submit_flush_scheduled = False
        # Worker-lease fast path (reference parity:
        # normal_task_submitter.h:72-140 lease caching): plain CPU tasks
        # go client->worker directly on leased workers; leases scale
        # with backlog and idle out. key -> _LeaseGroup.
        self._lease_groups: Dict[tuple, "_LeaseGroup"] = {}
        self._lease_pump_tasks: set = set()
        # key -> monotonic time before which lease requests are skipped
        # (set on an 'unavailable' miss; survives group teardown)
        self._lease_cooldown_until: Dict[tuple, float] = {}
        # local-daemon grant path (distributed dispatch): after a
        # 'spill' (or local-daemon connection failure), skip the local
        # attempt for that lease key for a while so saturated nodes
        # don't pay a wasted hop per pump; 'unsupported' (local leasing
        # disabled by config) turns the path off for good
        self._local_lease_skip_until: Dict[tuple, float] = {}
        self._local_lease_unsupported = False

    # ------------------------------------------------------------- lifecycle

    async def async_start(self) -> None:
        self.address = await self.server.start()

    def start(self) -> None:
        self.loop_runner.run_sync(self.async_start(), timeout=10)

    def shutdown(self) -> None:
        self.is_shutdown = True
        try:
            self.loop_runner.run_sync(self._async_shutdown(), timeout=5)
        except Exception:
            pass

    async def _async_shutdown(self) -> None:
        task = getattr(self, "_subscription_task", None)
        if task is not None:
            task.cancel()
        pumps = list(self._lease_pump_tasks)
        for pump in pumps:
            pump.cancel()
        if pumps:
            # Reap them: a cancelled-but-unawaited task logs
            # "Task was destroyed but it is pending" at loop close.
            await asyncio.gather(*pumps, return_exceptions=True)
        await self.server.stop()
        await self.pool.close_all()

    def _controller(self):
        return self.pool.get(self.controller_addr)

    def _daemon(self):
        return self.pool.get(self.node_addr)

    def arena_room(self, nbytes: int) -> None:
        """Ask our node daemon to spill until ~nbytes of arena space are
        free. Callable from any non-loop thread (write_to_shm hook)."""
        self.loop_runner.run_sync(self._daemon().call(
            "ensure_arena_room", nbytes=nbytes), timeout=60)

    # ----------------------------------------------------------- server rpcs

    async def rpc_object_ready(self, object_id: str = None, payload=None,
                               location=None, error=None,
                               task_id: Optional[str] = None,
                               object_ids=None, stream_of: str = None,
                               stream_index: int = None,
                               worker_addr=None) -> None:
        """A worker pushed a task result to us (we are the owner).

        Errors may carry `object_ids` (all return ids of a failed task) so a
        multi-return task fails every ref atomically — and a retry decision
        is made once, before anything is stored.

        Streaming items carry `stream_of` (generator id) + `stream_index`;
        they are stored like any owned object and indexed into the
        generator's StreamState.
        """
        if stream_of is not None:
            stream = self._streams.get(stream_of)
            if stream is None or stream.cancelled:
                # Abandoned stream: nothing will ever consume this item.
                # Drop it immediately and (re)send the producer cancel —
                # this is also how a producer whose first push raced the
                # consumer's close() learns to stop.
                self.memory_store.delete(object_id)
                if stream is not None:
                    if worker_addr is not None:
                        stream.worker_addr = tuple(worker_addr)
                    await self._send_stream_cancel(stream)
                return
            if error is not None:
                err = (error if isinstance(error, Exception)
                       else RayTpuError(str(error)))
                self.memory_store.put_error(object_id, err)
            elif location is not None:
                self.memory_store.put_location(object_id, location)
            else:
                self.memory_store.put_serialized(
                    object_id, SerializedObject.from_flat(payload))
            self.ref_counter.register_owned(object_id)
            stream.put(stream_index, object_id, worker_addr)
            return
        pending = self._pending_tasks.pop(task_id, None) if task_id else None
        if error is not None:
            err = error if isinstance(error, Exception) else RayTpuError(str(error))
            # Streaming tasks are NOT retried wholesale: items 0..k may
            # already be consumed and replaying them would double-register
            # the same object ids. The stream fails instead.
            retriable = (isinstance(err, WorkerCrashedError)
                         and not (pending is not None and pending.spec.get(
                             "num_returns") == "streaming"))
            if retriable and pending is not None and pending.retries_left > 0:
                pending.retries_left -= 1
                self._pending_tasks[task_id] = pending
                logger.warning("retrying task %s (%d retries left)",
                               pending.spec.get("name"), pending.retries_left)
                await self._controller().call("submit_task", spec=pending.spec)
                return
            for oid in (object_ids or [object_id]):
                if pending is None and self.memory_store.contains(oid):
                    # Late failure report for a task whose result already
                    # arrived (e.g. a daemon shutting down cancels its
                    # long-completed run_task RPC and reports a spurious
                    # crash) — never clobber a completed object.
                    continue
                self.memory_store.put_error(oid, err)
                stream = self._streams.get(oid)
                if stream is not None:
                    # a streaming task failed wholesale (e.g. worker crash
                    # before/while generating): wake its consumers
                    stream.fail(err)
            self._unpin_args(pending)
            return
        if location is not None:
            self.memory_store.put_location(object_id, location)
        else:
            self.memory_store.put_serialized(
                object_id, SerializedObject.from_flat(payload))
        if pending is not None:
            self._record_lineage(pending.spec)
        self._unpin_args(pending)

    def _unpin_args(self, pending: Optional[PendingTask]) -> None:
        if pending is None:
            return
        for arg_id in pending.arg_ids:
            self.ref_counter.unpin(arg_id)

    # ------------------------------------------------------------- lineage

    @staticmethod
    def _spec_bytes(spec: dict) -> int:
        return (len(spec.get("args_blob") or b"")
                + len(spec.get("fn_blob") or b""))

    def _record_lineage(self, spec: dict) -> None:
        """Remember which task produced each return object, so a lost copy
        can be recomputed (reference: task_manager.h:278 ResubmitTask)."""
        if spec.get("is_actor_creation"):
            return
        for rid in spec.get("return_ids") or [spec["return_id"]]:
            if rid not in self._lineage:
                self._lineage_bytes += self._spec_bytes(spec)
            self._lineage[rid] = spec
            self._lineage.move_to_end(rid)
        while self._lineage and (
                len(self._lineage) > self._lineage_cap
                or self._lineage_bytes > self._lineage_max_bytes):
            _, old = self._lineage.popitem(last=False)
            self._lineage_bytes -= self._spec_bytes(old)

    async def _reconstruct_object(self, object_id: str) -> bool:
        """Re-execute the producing task of a lost owned object. Returns
        True when the object is available again. Concurrent calls for the
        same producing task share one resubmission."""
        spec = self._lineage.get(object_id)
        if spec is None:
            return False
        task_id = spec["task_id"]
        fut = self._reconstructing.get(task_id)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._reconstructing[task_id] = fut

            async def _run():
                try:
                    for rid in spec.get("return_ids") or [spec["return_id"]]:
                        self.memory_store.delete(rid)
                    # A hard node pin is meaningless on reconstruction —
                    # the pinned node is typically the one that died.
                    resubmit = spec
                    sched = spec.get("scheduling") or {}
                    if sched.get("type") == "node_affinity" \
                            and not sched.get("soft"):
                        resubmit = dict(spec)
                        resubmit["scheduling"] = dict(sched, soft=True)
                    self._pending_tasks[task_id] = PendingTask(resubmit, 1, ())
                    logger.warning(
                        "reconstructing lost object %s by re-executing %s",
                        object_id[:12], spec.get("name"))
                    try:
                        await self._controller().call(
                            "submit_task", spec=resubmit)
                    except Exception:
                        self._pending_tasks.pop(task_id, None)
                        raise
                    fut.set_result(True)
                except Exception as e:
                    fut.set_exception(e)
                finally:
                    self._reconstructing.pop(task_id, None)

            asyncio.ensure_future(_run())
        try:
            await fut
        except Exception:
            return False
        return await self.memory_store.wait_available(object_id, 120.0)

    async def rpc_reconstruct_object(self, object_id: str) -> dict:
        """A borrower observed our object's copy is gone; recompute it."""
        try:
            ok = await self._reconstruct_object(object_id)
        except Exception as e:
            return {"status": "failed", "error": repr(e)}
        return {"status": "ok" if ok else "unavailable"}

    async def rpc_get_object(self, object_id: str, timeout: Optional[float] = None):
        """Serve one of our owned objects to a borrower."""
        ok = await self.memory_store.wait_available(object_id, timeout or 120.0)
        if not ok:
            return {"status": "timeout"}
        entry = self.memory_store.get_entry(object_id)
        if entry is None:
            return {"status": "lost"}
        if entry.location is not None:
            return {"status": "location", "location": entry.location}
        if entry.serialized is not None:
            return {"status": "inline", "payload": entry.serialized.to_flat()}
        if entry.has_value:
            if isinstance(entry.value, Exception):
                return {"status": "error", "error": entry.value}
            return {"status": "inline", "payload": serialize(entry.value).to_flat()}
        return {"status": "lost"}

    async def rpc_stream_end(self, generator_id: str, count: int,
                             task_id: Optional[str] = None) -> None:
        """End-of-stream from the executing worker (a generator that
        raised delivers the error as its final item first)."""
        pending = self._pending_tasks.pop(task_id, None) if task_id else None
        stream = self._streams.get(generator_id)
        if stream is not None:
            stream.finish(count)
            if stream.cancelled:
                self._streams.pop(generator_id, None)
        self._unpin_args(pending)

    # --------------------------------------------------------------- pubsub

    async def rpc_pubsub_message(self, topic: str, message) -> None:
        for cb in self._subscriptions.get(topic, []):
            try:
                cb(message)
            except Exception:
                logger.exception("pubsub callback for %r failed", topic)

    def subscribe(self, topic: str, callback) -> None:
        """Register a callback for a pubsub topic (controller-brokered).
        Registration is refreshed periodically: a transient controller
        outage or a controller RESTART (whose subscriber table is
        volatile) must not silently end the stream. The controller
        dedupes, so refreshes are idempotent."""
        first = not self._subscriptions
        self._subscriptions.setdefault(topic, []).append(callback)
        if first:
            async def _spawn():
                self._subscription_task = asyncio.ensure_future(
                    self._subscription_keeper())

            self.loop_runner.call_soon(_spawn())

    async def _subscription_keeper(self) -> None:
        try:
            while not self.is_shutdown:
                for topic in list(self._subscriptions):
                    try:
                        await self._controller().call(
                            "subscribe", topic=topic, addr=self.address)
                    except Exception:
                        pass
                await asyncio.sleep(5.0)
        except asyncio.CancelledError:
            pass

    async def rpc_ref_event(self, object_id: str, delta: int) -> None:
        self.ref_counter.on_borrower_event(object_id, delta)

    async def rpc_ping(self) -> str:
        return "pong"

    async def _send_ref_event(self, owner_addr, object_id: str, delta: int):
        try:
            await self.pool.get(owner_addr).oneway(
                "ref_event", object_id=object_id, delta=delta)
        except Exception:
            pass

    # ------------------------------------------------------------------ put

    def put(self, value: Any) -> ObjectRef:
        object_id = ObjectID.generate().hex()
        self.ref_counter.register_owned(object_id)
        serialized = serialize(value)
        if serialized.holds_tensors and (
                serialized.total_size <= INLINE_OBJECT_LIMIT
                or self.node_addr is None):
            # a tensor is a copy at put and at every get (torch has no
            # read-only tensors): keep only a copy of its bytes, which
            # serialize() left as views of the caller's tensor
            self.memory_store.put_serialized(object_id, SerializedObject(
                serialized.data, [bytes(b) for b in serialized.buffers]))
        elif serialized.total_size <= INLINE_OBJECT_LIMIT or self.node_addr is None:
            self.memory_store.put_value(object_id, value, serialized)
        else:
            shm_name, size = write_to_shm(
                object_id, serialized, self.session_name,
                arena_room=self.arena_room)
            location = ShmLocation(self.node_addr, shm_name, size)
            self.loop_runner.run_sync(self._daemon().call(
                "register_object", object_id=object_id,
                shm_name=shm_name, size=size))
            self.memory_store.put_location(object_id, location)
        return ObjectRef(object_id, self.address, _client=self)

    # ------------------------------------------------------------------ get

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout

        async def _gather():
            return await asyncio.gather(
                *[self.aio_get(r, deadline=deadline) for r in ref_list])

        outer = None if timeout is None else timeout + 5.0
        values = self.loop_runner.run_sync(_gather(), timeout=outer)
        return values[0] if single else values

    async def aio_get(self, ref: ObjectRef, deadline: Optional[float] = None):
        object_id = ref.id
        lost_attempts = 0
        while True:
            entry = self.memory_store.get_entry(object_id)
            is_owner = ref.owner_addr == self.address or ref.owner_addr is None
            if entry is not None:
                try:
                    return await self._materialize(object_id, entry)
                except ObjectLostError:
                    # A copy existed but is gone (node death, spill race,
                    # freed shm). Try lineage reconstruction, ours or the
                    # owner's, then loop to re-fetch.
                    lost_attempts += 1
                    if lost_attempts > 2:
                        raise
                    self.memory_store.delete(object_id)
                    if is_owner:
                        if not await self._reconstruct_object(object_id):
                            raise
                    else:
                        try:
                            reply = await self.pool.get(ref.owner_addr).call(
                                "reconstruct_object", object_id=object_id)
                        except (ConnectionLost, OSError):
                            raise ObjectLostError(
                                f"owner of {object_id[:12]} is gone")
                        if reply.get("status") != "ok":
                            raise
                    continue
            if is_owner:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"get timed out on {object_id[:12]}")
                ok = await self.memory_store.wait_available(object_id, remaining)
                if not ok:
                    raise GetTimeoutError(f"get timed out on {object_id[:12]}")
                continue
            # Borrowed ref: fetch from owner.
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise GetTimeoutError(f"get timed out on {object_id[:12]}")
            try:
                reply = await self.pool.get(ref.owner_addr).call(
                    "get_object", object_id=object_id, timeout=remaining)
            except ConnectionLost:
                raise ObjectLostError(
                    f"owner of {object_id[:12]} at {ref.owner_addr} is gone")
            status = reply["status"]
            if status == "timeout":
                continue  # loop re-checks deadline
            if status == "lost":
                raise ObjectLostError(f"object {object_id[:12]} was freed")
            if status == "error":
                raise reply["error"]
            if status == "location":
                if self.memory_store.get_entry(object_id) is None:
                    self.memory_store.put_location(object_id, reply["location"])
                continue  # loop: materialize via the reconstruction-guarded path
            serialized = SerializedObject.from_flat(reply["payload"])
            value = serialized.deserialize()
            if serialized.holds_tensors:
                self.memory_store.put_serialized(object_id, serialized)
            else:
                self.memory_store.put_value(object_id, value)
            return value

    async def _materialize(self, object_id: str, entry):
        if entry.has_value:
            if entry.is_error:
                raise entry.value
            return entry.value
        if entry.serialized is not None:
            value = entry.serialized.deserialize()
            if not entry.serialized.holds_tensors:
                entry.value = value
                entry.has_value = True
            return value
        if entry.location is not None:
            # Dedup concurrent pulls of the same object: one puller, the
            # rest await its result (reference parity: pull_manager.h).
            fut = self._inflight_pulls.get(object_id)
            if fut is not None:
                await fut
                return await self._materialize(
                    object_id, self.memory_store.get_entry(object_id) or entry)
            fut = asyncio.get_running_loop().create_future()
            self._inflight_pulls[object_id] = fut
            try:
                value, holds_tensors = await self._pull_location(
                    object_id, entry)
                if not holds_tensors:
                    # a tensor read is a copy every time: never cached
                    entry.value = value
                    entry.has_value = True
                fut.set_result(None)
                return value
            except BaseException as e:
                fut.set_exception(e)
                fut.exception()  # consumed; don't warn on GC
                raise
            finally:
                self._inflight_pulls.pop(object_id, None)
        raise ObjectLostError(f"object {object_id[:12]} has no data")

    async def _pull_location(self, object_id: str, entry):
        """(value, whether it holds tensors) of a stored object."""
        loc: ShmLocation = entry.location
        if self._shm_is_local(loc):
            try:
                value, shm, holds_tensors = \
                    await asyncio.get_running_loop().run_in_executor(
                        None, read_from_shm, loc.shm_name, loc.size)
                entry.shm_keepalive = shm
                return value, holds_tensors
            except FileNotFoundError:
                # shm copy gone (e.g. spilled to disk); the owning daemon
                # can still serve the bytes
                pass
        return await self._fetch_from_node(object_id, loc)

    async def _fetch_from_node(self, object_id: str, loc: ShmLocation):
        """Pull an object's bytes from its node daemon — chunked above the
        threshold so a multi-GiB object is never one RPC frame (reference
        parity: ObjectManager chunked push/pull, object_manager.h:208-216)."""
        from .transfer import fetch_flat
        try:
            flat = await fetch_flat(self.pool.get(loc.node_addr),
                                    object_id, loc.size)
            # from_flat wraps a memoryview: no second multi-GiB copy
            serialized = SerializedObject.from_flat(flat)
            return serialized.deserialize(), serialized.holds_tensors
        except ConnectionError as e:
            raise ObjectLostError(str(e))
        except (ConnectionLost, OSError):
            raise ObjectLostError(
                f"node holding object {object_id[:12]} is gone")

    def _shm_is_local(self, loc: ShmLocation) -> bool:
        # Single-machine sessions: every daemon's shm is attachable. Probe by
        # host equality; cross-host transfer goes through fetch_object.
        return loc.node_addr[0] in ("127.0.0.1", "localhost") or (
            self.node_addr is not None and loc.node_addr[0] == self.node_addr[0])

    def as_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(
            self.aio_get(ref), self.loop_runner.loop)

    # ----------------------------------------------------------------- wait

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        coro = self._aio_wait(list(refs), num_returns, timeout)
        outer = None if timeout is None else timeout + 5.0
        return self.loop_runner.run_sync(coro, timeout=outer)

    async def _aio_wait(self, refs, num_returns, timeout):
        done_ids: set = set()

        async def _one(ref):
            try:
                await self.aio_get(ref)
            except GetTimeoutError:
                raise
            except Exception:
                pass  # errored objects count as ready
            done_ids.add(ref.id)

        tasks = {asyncio.ensure_future(_one(r)): r for r in refs}
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while len(done_ids) < num_returns:
                remaining = None if deadline is None else max(
                    0, deadline - time.monotonic())
                pending = [t for t in tasks if not t.done()]
                if not pending:
                    break
                finished, _ = await asyncio.wait(
                    pending, timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED)
                if not finished:
                    break
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
        ready = [r for r in refs if r.id in done_ids][:max(num_returns, 0)]
        ready_set = {r.id for r in ready}
        not_ready = [r for r in refs if r.id not in ready_set]
        return ready, not_ready

    # -------------------------------------------------------- streaming

    async def aio_next_stream_item(self, generator_id: str, index: int,
                                   timeout: float = 300.0):
        stream = self._streams.get(generator_id)
        if stream is None:
            raise ValueError(f"unknown stream {generator_id[:12]}")
        try:
            oid = await asyncio.wait_for(stream.wait_for(index), timeout)
        except asyncio.TimeoutError:
            raise GetTimeoutError(
                f"stream item {index} of {generator_id[:12]} timed out")
        if oid is None:
            self._streams.pop(generator_id, None)    # fully consumed
            return None
        if stream.wants_ack and stream.worker_addr is not None:
            # ack for producer backpressure (fire-and-forget; only sent
            # when the task was submitted with a backpressure bound)
            addr = stream.worker_addr
            try:
                await self.pool.get(addr).oneway(
                    "stream_ack", generator_id=generator_id, index=index)
            except Exception:
                pass
        return ObjectRef(oid, self.address, _client=self)

    def next_stream_item(self, generator_id: str, index: int,
                         timeout: float = 300.0):
        return self.loop_runner.run_sync(
            self.aio_next_stream_item(generator_id, index, timeout))

    def release_stream(self, generator_id: str, consumed: int) -> None:
        """Drop an abandoned/finished generator: tell the producer to stop
        (it may be blocked on backpressure or producing unboundedly) and
        free unconsumed item objects this process owns.

        The StreamState stays registered (marked cancelled) until the
        producer's stream_end arrives: items still in flight are freed on
        arrival, and a producer whose address we don't know yet (nothing
        pushed so far) gets the cancel as soon as its first push lands."""
        stream = self._streams.get(generator_id)
        if stream is None:
            return
        stream.cancelled = True
        if stream.total is not None:
            self._streams.pop(generator_id, None)   # already ended

        async def _release():
            await self._send_stream_cancel(stream)
            for idx, oid in stream.items.items():
                if idx >= consumed:
                    self.memory_store.delete(oid)

        self.loop_runner.call_soon(_release())

    async def _send_stream_cancel(self, stream) -> None:
        if (stream.cancel_sent or stream.worker_addr is None
                or stream.total is not None):
            return
        stream.cancel_sent = True
        try:
            await self.pool.get(stream.worker_addr).oneway(
                "stream_cancel", generator_id=stream.generator_id)
        except Exception:
            pass

    # ----------------------------------------------------- function store

    def _fn_ref(self, blob: bytes, fn_hash: Optional[str] = None):
        """Split a code blob into task-spec fields.

        Small blobs ride inline; large ones are referenced by content hash
        and exported once to the controller KV (reference parity:
        python/ray/_private/function_manager.py export + lazy import —
        keeps hot-loop task specs and retained lineage small). Callers on
        hot loops (RemoteFunction/ActorClass) pass the hash they computed
        once at serialization time.
        Returns (spec_fields, hash_to_export_or_None).
        """
        if len(blob) <= get_config().fn_inline_limit:
            return {"fn_blob": blob}, None
        if fn_hash is None:
            import hashlib
            fn_hash = hashlib.sha1(blob).hexdigest()
        return {"fn_blob": None, "fn_hash": fn_hash}, fn_hash

    async def _ensure_fn_exported(self, fn_hash: str, blob: bytes) -> None:
        fut = self._exported_fns.get(fn_hash)
        if fut is None:
            fut = asyncio.get_running_loop().create_future()
            self._exported_fns[fn_hash] = fut
            try:
                await self._controller().call(
                    "kv_put", key=FN_STORE_PREFIX + fn_hash, value=blob,
                    overwrite=False)
            except Exception as e:
                # Drop the memo so a later submit retries the export.
                self._exported_fns.pop(fn_hash, None)
                fut.set_exception(e)
                fut.exception()      # mark retrieved for lone submitter
                raise
            else:
                fut.set_result(None)
                if len(self._exported_fns) > 4096:
                    # Drop an old resolved memo: worst case a later submit
                    # re-exports, and kv_put(overwrite=False) is idempotent.
                    for k, f in self._exported_fns.items():
                        if f.done():
                            del self._exported_fns[k]
                            break
        else:
            await asyncio.shield(fut)

    # --------------------------------------------------- lease fast path

    MAX_LEASES_PER_KEY = 8
    LEASE_IDLE_S = 2.0
    LEASE_DISPATCH_BATCH = 16    # specs per run_task_batch frame

    def _lease_key(self, spec: dict) -> Optional[tuple]:
        """Fast-path eligibility: CPU-only or CPU+GPU tasks with
        default scheduling (GPU leases are granted by the local daemon
        with devices pinned to the lease). Everything else (placement,
        custom resources, runtime envs, streaming, actors) takes the
        scheduled path."""
        if (spec.get("num_returns") == "streaming"
                or spec.get("is_actor_creation")
                or spec.get("scheduling")
                or spec.get("runtime_env")):
            return None
        res = spec.get("resources") or {}
        # CPU-only and CPU+GPU qualify: GPU leases are granted by the
        # LOCAL daemon with specific devices pinned to the lease (the
        # daemon owns device assignment); other custom resources need
        # global placement.
        if any(k not in ("CPU", "GPU") for k in res):
            return None
        return ("cpu", float(res.get("CPU", 1.0)),
                float(res.get("GPU", 0.0)))

    async def _submit_via_lease(self, key: tuple, spec: dict) -> None:
        if time.monotonic() < self._lease_cooldown_until.get(key, 0.0):
            await self._submit_spec(spec)      # capacity miss: back off
            return
        group = self._lease_groups.get(key)
        if group is None:
            group = self._lease_groups[key] = _LeaseGroup(key)
        # flag a COPY for the wire: pending.spec (used by retries) must
        # stay clean or a retried task would double-report through the
        # leased-death sweep
        wire = dict(spec)
        wire["_leased"] = True
        group.queue.append(wire)
        # scale pumps with backlog, one new pump per enqueue at most
        if (len(group.queue) > group.num_pumps
                and group.num_pumps < self.MAX_LEASES_PER_KEY):
            group.num_pumps += 1
            task = asyncio.ensure_future(self._lease_pump(key, group))
            self._lease_pump_tasks.add(task)
            task.add_done_callback(self._lease_pump_tasks.discard)

    async def _resubmit_scheduled(self, spec: dict) -> None:
        """Send a (possibly lease-flagged) spec through the scheduled path.
        On failure the owners' refs are failed rather than stranded."""
        spec.pop("_leased", None)
        try:
            await self._submit_spec(spec)
        except Exception as e:
            err = TaskError(spec.get("name", "task"),
                            f"submission failed: {e!r}")
            for rid in spec.get("return_ids") or [spec["return_id"]]:
                self.memory_store.put_error(rid, err)
                stream = self._streams.get(rid)
                if stream is not None:
                    stream.fail(err)
            self._unpin_args(self._pending_tasks.pop(spec["task_id"], None))

    async def _drain_lease_queue(self, group: "_LeaseGroup") -> None:
        while group.queue:
            await self._resubmit_scheduled(group.queue.popleft())

    async def _lease_pump(self, key: tuple, group: "_LeaseGroup") -> None:
        """One pump = one lease: acquire a worker, drain the shared queue
        serially, idle out after LEASE_IDLE_S, release."""
        lease_id = None
        lease_local = False
        lease_daemon = None
        worker = None
        try:
            reply = None
            # Local-daemon grant first (distributed dispatch — reference
            # parity: lease requests go to the LOCAL raylet,
            # normal_task_submitter.h:189; its 'spill' sends us to the
            # controller's global scheduler).
            if (self.node_addr is not None
                    and not self._local_lease_unsupported
                    and time.monotonic()
                    >= self._local_lease_skip_until.get(key, 0.0)):
                try:
                    req = {"CPU": key[1]}
                    if key[2]:
                        req["GPU"] = key[2]
                    reply = await self.pool.get(self.node_addr).call(
                        "lease_worker_local", resources=req,
                        owner_addr=list(self.address))
                except Exception:
                    reply = None
                    self._local_lease_skip_until[key] = (
                        time.monotonic() + 5.0)
                if reply is not None and reply.get("status") != "ok":
                    if reply.get("status") == "unsupported":
                        self._local_lease_unsupported = True
                    elif reply.get("status") == "spill":
                        self._local_lease_skip_until[key] = (
                            time.monotonic() + 5.0)
                    reply = None
            if reply is None:
                if key[2]:
                    # GPU leases are local-daemon only (device pinning);
                    # without a local grant the tasks take the scheduled
                    # path, where the daemon assigns devices per task
                    self._lease_cooldown_until[key] = (
                        time.monotonic() + 5.0)
                    await self._drain_lease_queue(group)
                    return
                reply = await self._controller().call(
                    "lease_worker", resources={"CPU": key[1]},
                    owner_addr=list(self.address))
            if reply.get("status") != "ok":
                # no capacity for MORE leases: existing pumps (if any)
                # keep draining; without any, fall back to the scheduler
                if group.num_pumps == 1:
                    self._lease_cooldown_until[key] = (
                        time.monotonic() + 5.0)
                    await self._drain_lease_queue(group)
                return
            lease_id = reply["lease_id"]
            lease_local = bool(reply.get("local"))
            lease_gpus = reply.get("gpus")
            worker = self.pool.get(tuple(reply["worker_addr"]))
            daemon_addr = tuple(reply["daemon_addr"])
            lease_daemon = daemon_addr
            worker_id = reply["worker_id"]
            idle_since = None
            while True:
                if not group.queue:
                    now = time.monotonic()
                    if idle_since is None:
                        idle_since = now
                    elif now - idle_since >= self.LEASE_IDLE_S:
                        return
                    await asyncio.sleep(0.05)
                    continue
                idle_since = None
                batch = [group.queue.popleft()]
                # Batch only what this pump's fair share of the backlog
                # is: deep queues amortize to LEASE_DISPATCH_BATCH per
                # frame, while a 2-task burst with 2 pumps still runs in
                # parallel (no head-of-line blocking behind a slow task).
                target = min(
                    self.LEASE_DISPATCH_BATCH,
                    max(1, (len(group.queue) + 1)
                        // max(group.num_pumps, 1)))
                while group.queue and len(batch) < target:
                    batch.append(group.queue.popleft())
                if lease_gpus:
                    for s in batch:      # lease-pinned GPU isolation
                        s["_gpu_ids"] = lease_gpus
                try:
                    # one frame for the whole batch: tiny tasks are wire
                    # (syscall) bound, not compute bound
                    await worker.call("run_task_batch", specs=batch)
                except Exception:
                    # worker/conn gone. The daemon settles the STARTED
                    # members' failures (incl. OOM attribution) exactly
                    # once; never-started members come back as
                    # "unstarted" for clean resubmission (no retry
                    # consumed). The backlog flows back through the
                    # scheduled path.
                    reported = alive = False
                    unstarted: set = set()
                    try:
                        fate = await self.pool.get(daemon_addr).call(
                            "leased_worker_fate", worker_id=worker_id,
                            task_ids=[s["task_id"] for s in batch])
                        reported = bool(fate.get("reported"))
                        alive = bool(fate.get("alive"))
                        unstarted = set(fate.get("unstarted") or [])
                    except Exception:
                        pass
                    if not alive:
                        for s in batch:
                            if s["task_id"] in unstarted or not reported:
                                await self._resubmit_scheduled(s)
                    await self._drain_lease_queue(group)
                    return
        except Exception:
            logger.exception("lease pump failed")
            # Never strand the backlog (a stranded spec hangs its owner's
            # get() forever): push everything queued back through the
            # scheduled path, failing the owners' refs as a last resort.
            await self._drain_lease_queue(group)
        finally:
            group.num_pumps -= 1
            if group.num_pumps == 0 and not group.queue:
                self._lease_groups.pop(key, None)
            if lease_id is not None:
                try:
                    if lease_local and lease_daemon is not None:
                        await self.pool.get(lease_daemon).oneway(
                            "release_lease_local", lease_id=lease_id)
                    else:
                        await self._controller().oneway(
                            "release_lease", lease_id=lease_id)
                except Exception:
                    pass

    # ----------------------------------------------------- submit batching

    async def _submit_spec(self, spec: dict) -> dict:
        """Queue a task spec; a burst submitted in one event-loop tick is
        flushed as a single submit_tasks controller RPC."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._submit_batch.append((spec, fut))
        if not self._submit_flush_scheduled:
            self._submit_flush_scheduled = True
            loop.call_soon(
                lambda: asyncio.ensure_future(self._flush_submits()))
        return await fut

    async def _flush_submits(self) -> None:
        batch, self._submit_batch = self._submit_batch, []
        self._submit_flush_scheduled = False
        if not batch:
            return
        try:
            if len(batch) == 1:
                replies = [await self._controller().call(
                    "submit_task", spec=batch[0][0])]
            else:
                replies = await self._controller().call(
                    "submit_tasks", specs=[s for s, _ in batch])
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (_, fut), reply in zip(batch, replies):
            if fut.done():
                continue
            if isinstance(reply, dict) and reply.get("status") == "error":
                fut.set_exception(RuntimeError(
                    reply.get("error", "submission failed")))
            else:
                fut.set_result(reply)

    # ------------------------------------------------------------ tasks

    def submit_task(self, fn, args: tuple, kwargs: dict, opts: dict,
                    fn_blob: Optional[bytes] = None,
                    fn_hash: Optional[str] = None):
        task_id = TaskID.generate().hex()
        num_returns = opts.get("num_returns") or 1
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 1
        return_ids = [ObjectID.generate().hex() for _ in range(num_returns)]
        for rid in return_ids:
            self.ref_counter.register_owned(rid)
        arg_refs = _collect_refs(args) + _collect_refs(kwargs)
        for r in arg_refs:
            self.ref_counter.pin(r.id)
        blob = fn_blob if fn_blob is not None else serialize_code(fn)
        fn_fields, export_hash = self._fn_ref(blob, fn_hash)
        spec = {
            "task_id": task_id,
            "name": opts.get("name") or getattr(fn, "__name__", "task"),
            **fn_fields,
            "args_blob": serialize((args, kwargs)).to_flat(),
            "return_id": return_ids[0],
            "return_ids": return_ids,
            "num_returns": "streaming" if streaming else num_returns,
            "owner_addr": self.address,
            "resources": _resources_from_opts(opts, default_cpu=1.0),
            "scheduling": opts.get("scheduling_strategy"),
            "is_actor_creation": False,
            "runtime_env": opts.get("runtime_env"),
            # surfaced so the daemon's OOM kill policy can prefer
            # retriable victims (worker_killing_policy.h:39)
            "max_retries": opts.get("max_retries", 0),
            # top-level arg refs (the ones _resolve_args unwraps),
            # surfaced so the daemon can prefetch them while the task
            # waits for a worker (reference: raylet/dependency_manager.h)
            "arg_refs": _top_level_arg_refs(args, kwargs),
            # span context propagation (reference:
            # tracing_helper.py:165 _DictPropagator in task specs)
            "_trace_ctx": _inject_trace(),
        }
        if streaming:
            bp = opts.get("_generator_backpressure_num_objects")
            spec["backpressure"] = bp
            self._streams[return_ids[0]] = StreamState(
                return_ids[0], wants_ack=bool(bp))
        retries = opts.get("max_retries", 0)
        pend = PendingTask(spec, retries, [r.id for r in arg_refs])
        self._pending_tasks[task_id] = pend
        refs = [ObjectRef(rid, self.address, _client=self)
                for rid in return_ids]

        async def _submit():
            try:
                if export_hash is not None:
                    await self._ensure_fn_exported(export_hash, blob)
                key = self._lease_key(spec)
                if key is not None:
                    await self._submit_via_lease(key, spec)
                else:
                    await self._submit_spec(spec)
            except Exception as e:
                err = TaskError(spec["name"], f"submission failed: {e!r}")
                for rid in return_ids:
                    self.memory_store.put_error(rid, err)
                    stream = self._streams.get(rid)
                    if stream is not None:
                        stream.fail(err)
                self._unpin_args(self._pending_tasks.pop(task_id, None))

        self.loop_runner.call_soon(_submit())
        if streaming:
            return ObjectRefGenerator(return_ids[0], self)
        return refs[0] if num_returns == 1 else refs

    # ------------------------------------------------------------ actors

    def create_actor(self, cls, args: tuple, kwargs: dict, opts: dict,
                     cls_blob: Optional[bytes] = None,
                     cls_hash: Optional[str] = None):
        actor_id = ActorID.generate().hex()
        task_id = TaskID.generate().hex()
        return_id = ObjectID.generate().hex()
        self.ref_counter.register_owned(return_id)
        blob = cls_blob if cls_blob is not None else serialize_code(cls)
        fn_fields, export_hash = self._fn_ref(blob, cls_hash)
        spec = {
            "task_id": task_id,
            "name": opts.get("name") or f"{cls.__name__}.__init__",
            "class_name": cls.__name__,
            **fn_fields,
            "args_blob": serialize((args, kwargs)).to_flat(),
            "return_id": return_id,
            "owner_addr": self.address,
            "resources": _resources_from_opts(opts, default_cpu=0.0),
            "scheduling": opts.get("scheduling_strategy"),
            "is_actor_creation": True,
            "actor_id": actor_id,
            "actor_name": opts.get("name"),
            "namespace": opts.get("namespace") or self.namespace,
            "max_concurrency": opts.get("max_concurrency"),
            "concurrency_groups": opts.get("concurrency_groups"),
            "max_restarts": opts.get("max_restarts", 0),
            "lifetime": opts.get("lifetime"),
            "runtime_env": opts.get("runtime_env"),
            "arg_refs": _top_level_arg_refs(args, kwargs),
            "_trace_ctx": _inject_trace(),
        }
        creation_ref = ObjectRef(return_id, self.address, _client=self)

        async def _submit():
            created = asyncio.get_running_loop().create_future()
            self._local_creations[actor_id] = created
            try:
                if export_hash is not None:
                    await self._ensure_fn_exported(export_hash, blob)
                if await self._try_create_actor_local(spec):
                    return
                await self._submit_spec(spec)
            except Exception as e:
                self.memory_store.put_error(
                    return_id,
                    ActorDiedError(actor_id, f"creation submission failed: {e!r}"))
            finally:
                del self._local_creations[actor_id]
                created.set_result(None)

        self.loop_runner.call_soon(_submit())
        return actor_id, creation_ref

    async def _try_create_actor_local(self, spec: dict) -> bool:
        """Daemon-local actor creation (distributed dispatch): ask the
        LOCAL daemon to grant the creation from its delegated resource
        block, keeping the controller off the per-actor critical path
        (reference parity: raylet-granted actor leases,
        gcs_actor_scheduler.h). Returns True when fully handled —
        including a failed __init__, which the worker reports to us
        directly. Ineligible/declined creations return False and take
        the scheduled path."""
        if (spec.get("scheduling") or spec.get("runtime_env")
                or spec.get("actor_name")
                or spec.get("lifetime") == "detached"
                or any(k not in ("CPU", "GPU")
                       for k in (spec.get("resources") or {}))):
            return False
        if (self.node_addr is None or self._local_lease_unsupported):
            return False
        try:
            reply = await self.pool.get(self.node_addr).call(
                "create_actor_local", spec=spec)
        except Exception:
            return False
        status = (reply or {}).get("status")
        if status == "unsupported":
            self._local_lease_unsupported = True
            return False
        if status == "ok":
            # the grant reply carries the worker address: first method
            # call skips the controller directory resolve entirely
            self._actor_addrs[spec["actor_id"]] = tuple(reply["addr"])
            return True
        if status == "created_failed":
            return True          # worker already pushed us the error
        return False             # spill/error: scheduled path

    async def _reresolve_actor(self, actor_id: str, old_addr):
        lock = self._actor_resolve_locks.setdefault(actor_id, asyncio.Lock())
        async with lock:
            cur = self._actor_addrs.get(actor_id)
            if cur is not None and cur != old_addr:
                return cur  # another caller already re-resolved
            self._actor_addrs.pop(actor_id, None)
            addr = await self._resolve_actor(actor_id)
            # New incarnation: restart our submission sequence.
            with self._actor_seq_lock:
                self._actor_seq[actor_id] = 0
            return addr

    async def _resolve_actor(self, actor_id: str, wait: bool = True):
        addr = self._actor_addrs.get(actor_id)
        if addr is not None:
            return addr
        created = self._local_creations.get(actor_id)
        if created is not None:
            await asyncio.shield(created)
            addr = self._actor_addrs.get(actor_id)
            if addr is not None:
                return addr
        reply = await self._controller().call(
            "get_actor_info", actor_id=actor_id, wait=wait)
        if reply is None or reply.get("state") == "DEAD" \
                or reply.get("addr") is None:
            raise ActorDiedError(actor_id, (reply or {}).get("death_cause", ""))
        addr = tuple(reply["addr"])
        self._actor_addrs[actor_id] = addr
        return addr

    def submit_actor_task(self, actor_id: str, method: str, args: tuple,
                          kwargs: dict, opts: dict):
        return_id = ObjectID.generate().hex()
        streaming = opts.get("num_returns") == "streaming"
        self.ref_counter.register_owned(return_id)
        ref = ObjectRef(return_id, self.address, _client=self)
        arg_refs = _collect_refs(args) + _collect_refs(kwargs)
        for r in arg_refs:
            self.ref_counter.pin(r.id)
        args_blob = serialize((args, kwargs)).to_flat()
        with self._actor_seq_lock:
            seq = self._actor_seq.get(actor_id, 0)
            self._actor_seq[actor_id] = seq + 1
        if streaming:
            self._streams[return_id] = StreamState(
                return_id, wants_ack=bool(opts.get(
                    "_generator_backpressure_num_objects")))

        async def _call():
            try:
                await self._call_actor_inner(
                    actor_id, method, args_blob, return_id, seq,
                    streaming=streaming,
                    backpressure=opts.get(
                        "_generator_backpressure_num_objects"),
                    concurrency_group=opts.get("concurrency_group"))
            finally:
                for r in arg_refs:
                    self.ref_counter.unpin(r.id)

        self.loop_runner.call_soon(_call())
        if streaming:
            return ObjectRefGenerator(return_id, self)
        return ref

    async def _call_actor_inner(self, actor_id, method, args_blob,
                                return_id, seq, streaming=False,
                                backpressure=None, concurrency_group=None):
            addr = None
            extra = ({"streaming": True, "owner_addr": self.address,
                      "backpressure": backpressure} if streaming else {})
            if concurrency_group:
                extra["concurrency_group"] = concurrency_group

            def _fail(err):
                self.memory_store.put_error(return_id, err)
                stream = self._streams.get(return_id)
                if stream is not None:
                    stream.fail(err)

            try:
                addr = await self._resolve_actor(actor_id)
                reply = await self.pool.get(addr).call(
                    "call_actor", actor_id=actor_id, method=method,
                    args_blob=args_blob, caller=self.worker_id, seq=seq,
                    return_id=return_id, **extra)
            except ActorDiedError as e:
                _fail(e)
                return
            except (ConnectionLost, OSError):
                # The actor may have restarted elsewhere: re-resolve once and
                # retry with a fresh sequence number from the reset counter.
                try:
                    addr = await self._reresolve_actor(actor_id, addr)
                    with self._actor_seq_lock:
                        seq2 = self._actor_seq.get(actor_id, 0)
                        self._actor_seq[actor_id] = seq2 + 1
                    reply = await self.pool.get(addr).call(
                        "call_actor", actor_id=actor_id, method=method,
                        args_blob=args_blob, caller=self.worker_id, seq=seq2,
                        return_id=return_id, **extra)
                except Exception as e2:
                    _fail(e2 if isinstance(e2, ActorDiedError) else
                          ActorDiedError(actor_id,
                                         f"actor connection lost: {e2!r}"))
                    return
            except Exception as e:
                _fail(ActorDiedError(actor_id, f"call failed: {e!r}"))
                # Don't stall later seqs behind this one.
                if addr is not None:
                    try:
                        await self.pool.get(addr).oneway(
                            "skip_actor_seq", actor_id=actor_id,
                            caller=self.worker_id, seq=seq)
                    except Exception:
                        pass
                return
            status = reply["status"]
            if status == "ok":
                self.memory_store.put_serialized(
                    return_id, SerializedObject.from_flat(reply["payload"]))
            elif status == "location":
                self.memory_store.put_location(return_id, reply["location"])
            elif status == "streaming":
                pass      # items arrive via object_ready / stream_end pushes
            else:
                err = ActorError(method, reply["error_tb"])
                if streaming:
                    _fail(err)
                else:
                    self.memory_store.put_error(return_id, err)

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        self.loop_runner.run_sync(self._controller().call(
            "kill_actor", actor_id=actor_id, no_restart=no_restart))
        self._actor_addrs.pop(actor_id, None)

    def controller_rpc(self, method: str, **kwargs):
        """Generic control-plane RPC (state API, job submission)."""
        return self.loop_runner.run_sync(
            self._controller().call(method, **kwargs))

    def daemon_rpc(self, addr, method: str, **kwargs):
        return self.loop_runner.run_sync(
            self.pool.get(tuple(addr)).call(method, **kwargs))

    def get_actor_handle_info(self, name: str, namespace: Optional[str]):
        return self.loop_runner.run_sync(self._controller().call(
            "get_named_actor", name=name,
            namespace=namespace or self.namespace))

    async def aio_get_actor_handle_info(self, name: str,
                                        namespace: Optional[str]):
        """Event-loop-safe named-actor lookup (for async actors)."""
        return await self._controller().call(
            "get_named_actor", name=name,
            namespace=namespace or self.namespace)

    # -------------------------------------------------------------- cluster

    def cluster_resources(self) -> Dict[str, float]:
        return self.loop_runner.run_sync(
            self._controller().call("cluster_resources"))

    def available_resources(self) -> Dict[str, float]:
        return self.loop_runner.run_sync(
            self._controller().call("available_resources"))

    def nodes(self) -> List[dict]:
        return self.loop_runner.run_sync(self._controller().call("list_nodes"))

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        return self.loop_runner.run_sync(self._controller().call(
            "kv_put", key=key, value=value, overwrite=overwrite))

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.loop_runner.run_sync(self._controller().call("kv_get", key=key))

    def kv_del(self, key: str) -> bool:
        return self.loop_runner.run_sync(self._controller().call("kv_del", key=key))

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.loop_runner.run_sync(
            self._controller().call("kv_keys", prefix=prefix))

    # ------------------------------------------------------------- freeing

    def _free_owned(self, object_id: str) -> None:
        entry = self.memory_store.delete(object_id)
        if entry is not None and entry.location is not None:
            loc = entry.location

            async def _free():
                try:
                    await self.pool.get(loc.node_addr).oneway(
                        "free_object", object_id=object_id)
                except Exception:
                    pass

            if not self.is_shutdown:
                self.loop_runner.call_soon(_free())


class _LeaseGroup:
    """Shared backlog + pump bookkeeping for one lease key."""

    __slots__ = ("key", "queue", "num_pumps")

    def __init__(self, key: tuple):
        self.key = key
        self.queue: "deque[dict]" = deque()
        self.num_pumps = 0


def _inject_trace():
    from ..util import tracing
    return tracing.inject_context()


def _top_level_arg_refs(args: tuple, kwargs: dict) -> List[tuple]:
    """(object_id, owner_addr) for every DIRECT ObjectRef argument —
    exactly the set _resolve_args unwraps; nested refs stay refs."""
    refs = ([a for a in args if isinstance(a, ObjectRef)]
            + [v for v in kwargs.values() if isinstance(v, ObjectRef)])
    return [(r.id, r.owner_addr) for r in refs]


def _collect_refs(obj, out=None) -> List[ObjectRef]:
    if out is None:
        out = []
    if isinstance(obj, ObjectRef):
        out.append(obj)
    elif isinstance(obj, (list, tuple, set)):
        for x in obj:
            _collect_refs(x, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _collect_refs(v, out)
    return out


def _resources_from_opts(opts: dict, default_cpu: float) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    resources["CPU"] = float(default_cpu if num_cpus is None else num_cpus)
    if opts.get("num_tpus"):
        raise ValueError(NUM_TPUS_REFUSED)
    num_gpus = opts.get("num_gpus")
    if num_gpus:
        # pinned: the daemon assigns devices and the worker sets
        # CUDA_VISIBLE_DEVICES (accelerators/gpu.py)
        resources["GPU"] = float(num_gpus)
    memory = opts.get("memory")
    if memory:
        resources["memory"] = float(memory)
    return {k: v for k, v in resources.items() if v}
