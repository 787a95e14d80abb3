"""DeploymentHandle: the client-side call path into a deployment.

Reference parity: serve/handle.py:628 (DeploymentHandle.remote →
DeploymentResponse), router.py:340 (AsyncioRouter) and
replica_scheduler/pow_2_scheduler.py:52 (power-of-two-choices over cached
queue lengths). The router keeps a per-process view of replica targets
(refreshed from the controller) and its own in-flight counts; each
assignment samples two replicas and picks the less loaded.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
import uuid
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch

from ._private.common import (CONTROLLER_NAME, DeploymentTargets,
                              RequestMetadata, deployment_key)

_routers: Dict[str, "Router"] = {}
_routers_lock = threading.Lock()


def _controller():
    return ray_tpu_torch.get_actor(CONTROLLER_NAME)


async def _controller_async():
    return await ray_tpu_torch.aio_get_actor(CONTROLLER_NAME)


class Router:
    """Per-process, per-deployment replica picker."""

    REFRESH_S = 1.0

    def __init__(self, dep_key: str):
        self.dep_key = dep_key
        self.targets: Optional[DeploymentTargets] = None
        self.inflight: Dict[str, int] = {}
        self._last_refresh = 0.0
        self._lock = threading.Lock()

    # -- target refresh -----------------------------------------------------
    def _apply(self, wire: Dict[str, Any]) -> None:
        with self._lock:
            self.targets = DeploymentTargets.from_wire(wire)
            live = {r.replica_id for r in self.targets.replicas}
            self.inflight = {rid: n for rid, n in self.inflight.items()
                             if rid in live}
            self._last_refresh = time.monotonic()

    def _stale(self) -> bool:
        return (self.targets is None
                or time.monotonic() - self._last_refresh > self.REFRESH_S)

    def refresh_sync(self, deadline_s: float = 30.0) -> None:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if self._stale():
                wire = ray_tpu_torch.get(
                    _controller().get_deployment_targets.remote(
                        self.dep_key), timeout=10)
                if wire is not None:
                    self._apply(wire)
            if self.targets is not None and self.targets.replicas:
                return
            time.sleep(0.1)
            # force the next loop iteration to re-poll the controller.
            # Under _lock: _apply writes _last_refresh while holding
            # it, and a bare store here can clobber a refresh that
            # landed between the sleep and the write (racelint RL001)
            with self._lock:
                self._last_refresh = 0.0
        raise TimeoutError(
            f"no running replicas for {self.dep_key} after {deadline_s}s")

    async def refresh_async(self, deadline_s: float = 30.0) -> None:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if self._stale():
                controller = await _controller_async()
                wire = await controller.get_deployment_targets.remote(
                    self.dep_key)
                if wire is not None:
                    self._apply(wire)  # racelint: disable=RL002 -- the lock guards a few dict writes, never I/O
            if self.targets is not None and self.targets.replicas:
                return
            await asyncio.sleep(0.1)
            # see refresh_sync: the re-poll marker must not race a
            # concurrent _apply (racelint RL001)
            with self._lock:  # racelint: disable=RL002 -- held for one store
                self._last_refresh = 0.0
        raise TimeoutError(
            f"no running replicas for {self.dep_key} after {deadline_s}s")

    # -- power of two choices ----------------------------------------------
    def _pick(self):
        replicas = self.targets.replicas
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        na = self.inflight.get(a.replica_id, 0)
        nb = self.inflight.get(b.replica_id, 0)
        return a if na <= nb else b

    def _launch(self, meta: RequestMetadata, args, kwargs,
                stream: bool = False):
        with self._lock:
            target = self._pick()
            rid = target.replica_id
            self.inflight[rid] = self.inflight.get(rid, 0) + 1
        if stream:
            gen = target.actor_handle.handle_request_stream.options(
                num_returns="streaming").remote(
                    meta.__dict__, *args, **kwargs)

            def _stream_done():
                with self._lock:
                    n = self.inflight.get(rid, 1)
                    self.inflight[rid] = max(n - 1, 0)

            # decrement when the STREAM ends (exhaustion/close/GC), not at
            # launch: long-lived streams must weigh in pow-2 routing
            if hasattr(gen, "on_finish"):
                gen.on_finish = _stream_done
            else:                       # local-mode eager generator
                _stream_done()
            return gen
        ref = target.actor_handle.handle_request.remote(
            meta.__dict__, *args, **kwargs)

        def _done(_):
            with self._lock:
                n = self.inflight.get(rid, 1)
                self.inflight[rid] = max(n - 1, 0)
        try:
            ref.future().add_done_callback(_done)
        except Exception:
            _done(None)
        return ref

    def assign_sync(self, meta, args, kwargs, stream: bool = False):
        self.refresh_sync()
        return self._launch(meta, args, kwargs, stream)

    async def assign_async(self, meta, args, kwargs, stream: bool = False):
        await self.refresh_async()
        return self._launch(meta, args, kwargs, stream)  # racelint: disable=RL002 -- the lock covers the pick and a count; the call's I/O runs after


def _router_for(dep_key: str) -> Router:
    with _routers_lock:
        r = _routers.get(dep_key)
        if r is None:
            r = _routers[dep_key] = Router(dep_key)
        return r


class DeploymentResponse:
    """Future-like result of handle.remote() (reference handle.py:
    DeploymentResponse — awaitable in replicas, .result() on drivers)."""

    def __init__(self, ref=None, task: Optional[asyncio.Task] = None):
        self._ref = ref
        self._task = task

    def _object_ref_sync(self):
        if self._ref is None:
            raise RuntimeError(
                "response was created in an async context; await it")
        return self._ref

    def result(self, timeout_s: Optional[float] = None):
        return ray_tpu_torch.get(self._object_ref_sync(), timeout=timeout_s)

    def __await__(self):
        async def _wait():
            ref = self._ref
            if ref is None:
                ref = await self._task
            return await ref
        return _wait().__await__()


class DeploymentHandle:
    """Callable reference to a deployment; picklable (travels into other
    replicas' init args and between processes)."""

    def __init__(self, deployment_name: str, app_name: str = "default",
                 *, method_name: str = "__call__",
                 multiplexed_model_id: str = "", stream: bool = False):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._stream = stream

    # -- options / composition ---------------------------------------------
    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name=method_name or self._method,
            multiplexed_model_id=(multiplexed_model_id
                                  if multiplexed_model_id is not None
                                  else self._model_id),
            stream=self._stream if stream is None else stream)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodProxy(self, name)

    # -- call path ----------------------------------------------------------
    def _meta(self) -> RequestMetadata:
        return RequestMetadata(
            request_id=uuid.uuid4().hex[:12], call_method=self._method,
            multiplexed_model_id=self._model_id)

    def remote(self, *args, **kwargs):
        dep_key = deployment_key(self.app_name, self.deployment_name)
        from ._private import local_testing
        local = local_testing.get(dep_key)
        if local is not None:
            # local testing mode: straight to the in-process replica
            return local.call(self._meta(), args, kwargs,
                              stream=self._stream)
        router = _router_for(dep_key)
        meta = self._meta()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if self._stream:
            # streaming calls: resolve the replica + ObjectRefGenerator
            # eagerly, wrap in a value-yielding generator
            if loop is not None:
                task = loop.create_task(
                    router.assign_async(meta, args, kwargs, stream=True))
                return DeploymentResponseGenerator(task=task)
            return DeploymentResponseGenerator(
                gen=router.assign_sync(meta, args, kwargs, stream=True))
        if loop is not None:
            task = loop.create_task(router.assign_async(meta, args, kwargs))
            return DeploymentResponse(task=task)
        return DeploymentResponse(ref=router.assign_sync(meta, args, kwargs))

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name),
                {"_method": self._method, "_model_id": self._model_id,
                 "_stream": self._stream})

    def __setstate__(self, state):
        self._method = state.get("_method", "__call__")
        self._model_id = state.get("_model_id", "")
        self._stream = state.get("_stream", False)

    def __repr__(self):
        return (f"DeploymentHandle({self.app_name}#{self.deployment_name}"
                f".{self._method})")


class DeploymentResponseGenerator:
    """Streaming counterpart of DeploymentResponse: iterates the replica
    generator's VALUES (reference handle.py DeploymentResponseGenerator).
    Sync iteration on drivers, async inside replicas."""

    def __init__(self, gen=None, task: Optional[asyncio.Task] = None):
        self._gen = gen
        self._task = task

    def __iter__(self):
        return self

    def __next__(self):
        if self._gen is None:
            raise RuntimeError("created in an async context; use async for")
        ref = next(self._gen)                     # raises StopIteration
        return ray_tpu_torch.get(ref)

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._gen is None:
            self._gen = await self._task
            self._task = None
        ref = await self._gen.__anext__()         # StopAsyncIteration
        return await ref

    def close(self):
        if self._gen is not None and hasattr(self._gen, "close"):
            self._gen.close()


class _MethodProxy:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle.options(method_name=method)

    def options(self, **opts) -> "DeploymentHandle":
        return self._handle.options(**opts)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle.remote(*args, **kwargs)


class _HandlePlaceholder:
    """Marker replacing a nested Application in serialized init args."""

    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name


def _materialize_handle_placeholders(obj):
    if isinstance(obj, _HandlePlaceholder):
        return DeploymentHandle(obj.deployment_name, obj.app_name)
    if isinstance(obj, tuple):
        return tuple(_materialize_handle_placeholders(x) for x in obj)
    if isinstance(obj, list):
        return [_materialize_handle_placeholders(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _materialize_handle_placeholders(v)
                for k, v in obj.items()}
    return obj
