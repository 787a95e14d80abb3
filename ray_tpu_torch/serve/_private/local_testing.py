"""Local testing mode: run an app's deployments in-process, no cluster.

Reference parity: serve/_private/local_testing_mode.py:49-133
(make_local_deployment_handle / LocalReplicaResult) — `serve.run(app,
local_testing_mode=True)` constructs every deployment's user callable
eagerly in THIS process and routes DeploymentHandle calls straight to
them on a background asyncio loop, so handle unit tests need no
controller, proxy, or workers. The same Replica wrapper class used by
real replica actors hosts the callable, so local behavior (method
dispatch, request context, reconfigure, streaming) matches the cluster
path.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import threading
from typing import Any, Dict, Optional

from .common import deployment_key

_replicas: Dict[str, "LocalReplica"] = {}
_lock = threading.Lock()
_loop: Optional[asyncio.AbstractEventLoop] = None


def _ensure_loop() -> asyncio.AbstractEventLoop:
    """One background event loop thread hosts every local replica."""
    global _loop
    with _lock:
        if _loop is None or _loop.is_closed():
            loop = asyncio.new_event_loop()
            t = threading.Thread(
                target=loop.run_forever, name="serve-local", daemon=True)
            t.start()
            _loop = loop
        return _loop


class LocalResponse:
    """DeploymentResponse stand-in backed by a concurrent future."""

    def __init__(self, future):
        self._future = future

    def result(self, timeout_s: Optional[float] = None):
        return self._future.result(timeout=timeout_s)

    def __await__(self):
        return asyncio.wrap_future(self._future).__await__()


class LocalResponseGenerator:
    """Streaming stand-in: values arrive on a thread-safe queue fed by
    the replica's async generator on the background loop."""

    _DONE = object()

    def __init__(self, q: "_queue.Queue", future):
        self._q = q
        self._future = future   # resolves when the generator finishes

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            exc = self._future.exception()
            if exc is not None:
                raise exc
            raise StopIteration
        return item

    def __aiter__(self):
        return self

    async def __anext__(self):
        loop = asyncio.get_running_loop()
        item = await loop.run_in_executor(None, self._q.get)
        if item is self._DONE:
            exc = self._future.exception()
            if exc is not None:
                raise exc
            raise StopAsyncIteration
        return item

    def close(self):
        self._future.cancel()


class LocalReplica:
    """In-process host for one deployment's callable."""

    def __init__(self, replica):
        self.replica = replica          # _private.replica.Replica

    def call(self, meta, args, kwargs, stream: bool = False):
        loop = _ensure_loop()
        if stream:
            q: _queue.Queue = _queue.Queue()

            async def _drain():
                try:
                    agen = self.replica.handle_request_stream(
                        meta.__dict__, *args, **kwargs)
                    async for item in agen:
                        q.put(item)
                finally:
                    q.put(LocalResponseGenerator._DONE)

            fut = asyncio.run_coroutine_threadsafe(_drain(), loop)
            return LocalResponseGenerator(q, fut)
        fut = asyncio.run_coroutine_threadsafe(
            self.replica.handle_request(meta.__dict__, *args, **kwargs),
            loop)
        return LocalResponse(fut)


def get(dep_key: str) -> Optional[LocalReplica]:
    with _lock:
        return _replicas.get(dep_key)


def active() -> bool:
    with _lock:
        return bool(_replicas)


def has_app(app_name: str) -> bool:
    prefix = deployment_key(app_name, "")
    with _lock:
        return any(k.startswith(prefix) for k in _replicas)


def clear(app_name: Optional[str] = None) -> None:
    with _lock:
        if app_name is None:
            _replicas.clear()
        else:
            prefix = deployment_key(app_name, "")
            for k in [k for k in _replicas if k.startswith(prefix)]:
                del _replicas[k]


def deploy_local(app_name: str, ingress: str, specs) -> None:
    """Instantiate every deployment in-process (children first — specs
    arrive in dependency order from _build_app_specs, so a parent whose
    __init__ immediately calls a child handle finds it registered)."""
    from .replica import Replica

    for spec in specs:
        dep_key = deployment_key(app_name, spec["name"])
        replica = Replica(
            dep_key, "local", spec["callable_blob"],
            spec["init_args_blob"],
            user_config=spec["config"].user_config)
        with _lock:
            _replicas[dep_key] = LocalReplica(replica)
