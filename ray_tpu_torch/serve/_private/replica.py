"""Replica actor: hosts one copy of a deployment's user callable.

Reference parity: serve/_private/replica.py (UserCallableWrapper, request
counting, health checks, reconfigure). Runs as an async ray_tpu_torch actor with
max_concurrency = max_ongoing_requests, so concurrent requests interleave
on the worker's event loop; sync user code runs in the worker thread pool.
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import time
from typing import Any, Dict, Optional

# Visible to user code via serve.get_multiplexed_model_id() and
# serve.context helpers.
_request_context: contextvars.ContextVar = contextvars.ContextVar(
    "serve_request_context", default=None)


def current_request_context():
    return _request_context.get()


class Replica:
    """The actor class the controller spawns per replica."""

    def __init__(self, deployment_key: str, replica_id: str,
                 callable_blob: bytes, init_args_blob: bytes,
                 user_config: Any = None):
        from ..._private.serialization import deserialize_code
        from ..handle import _materialize_handle_placeholders
        from .serialization_helpers import deserialize_args

        self._deployment_key = deployment_key
        self._replica_id = replica_id
        self._ongoing = 0
        self._total = 0
        self._window: list = []   # (ts,) of recent request starts
        cls_or_fn = deserialize_code(callable_blob)
        args, kwargs = deserialize_args(init_args_blob)
        args = _materialize_handle_placeholders(args)
        kwargs = _materialize_handle_placeholders(kwargs)
        if inspect.isclass(cls_or_fn):
            self._instance = cls_or_fn(*args, **kwargs)
            self._is_function = False
        else:
            self._instance = cls_or_fn
            self._is_function = True
        if user_config is not None:
            self._reconfigure_sync(user_config)

    # -- request path -------------------------------------------------------
    async def handle_request(self, meta: Dict[str, Any], *args, **kwargs):
        self._ongoing += 1
        self._total += 1
        now = time.time()
        self._window.append(now)
        if len(self._window) > 1000:
            del self._window[:500]
        token = _request_context.set(meta)
        try:
            if self._is_function:
                target = self._instance
            else:
                target = getattr(self._instance,
                                 meta.get("call_method") or "__call__")
            if inspect.iscoroutinefunction(target):
                return await target(*args, **kwargs)
            loop = asyncio.get_running_loop()
            ctx = contextvars.copy_context()
            return await loop.run_in_executor(
                None, lambda: ctx.run(target, *args, **kwargs))
        finally:
            _request_context.reset(token)
            self._ongoing -= 1

    async def handle_request_stream(self, meta: Dict[str, Any],
                                    *args, **kwargs):
        """Streaming twin of handle_request: the target user method is a
        (sync or async) generator; items are re-yielded, so calling this
        with num_returns="streaming" streams them to the consumer
        (reference parity: replica.py handle_request_streaming)."""
        self._ongoing += 1
        self._total += 1
        token = _request_context.set(meta)
        try:
            target = (self._instance if self._is_function else
                      getattr(self._instance,
                              meta.get("call_method") or "__call__"))
            gen = target(*args, **kwargs)
            if hasattr(gen, "__anext__"):
                async for item in gen:
                    yield item
            else:
                for item in gen:
                    yield item
        finally:
            _request_context.reset(token)
            self._ongoing -= 1

    # -- control plane ------------------------------------------------------
    def _reconfigure_sync(self, user_config: Any) -> None:
        if not self._is_function and hasattr(self._instance, "reconfigure"):
            self._instance.reconfigure(user_config)

    async def reconfigure(self, user_config: Any) -> bool:
        fn = getattr(self._instance, "reconfigure", None)
        if fn is None:
            return False
        if inspect.iscoroutinefunction(fn):
            await fn(user_config)
        else:
            fn(user_config)
        return True

    async def check_health(self) -> bool:
        fn = getattr(self._instance, "check_health", None)
        if fn is not None:
            if inspect.iscoroutinefunction(fn):
                await fn()
            else:
                fn()
        return True

    async def metrics(self) -> Dict[str, Any]:
        cutoff = time.time() - 10.0
        recent = sum(1 for t in self._window if t >= cutoff)
        out: Dict[str, Any] = {"ongoing": self._ongoing,
                               "total": self._total,
                               "qps_10s": recent / 10.0}
        # optional per-replica health detail: a callable
        # exposing health_detail() — the LLM server reports queue
        # depth / KV occupancy / last-tick age — gets it piggybacked
        # on the controller's existing metrics poll and surfaced in
        # serve.status(). Best-effort: a broken hook must not fail
        # the health probe and kill the replica.
        fn = getattr(self._instance, "health_detail", None)
        if fn is not None:
            try:
                detail = fn()
                if inspect.isawaitable(detail):
                    detail = await detail
                out["detail"] = detail
            except Exception:
                pass
        return out

    async def prepare_for_shutdown(self) -> None:
        """Drain: wait for ongoing requests to finish (graceful stop),
        then run the instance's teardown hook if it defines one (the
        ASGI ingress wrapper uses it to send lifespan.shutdown)."""
        deadline = time.time() + 30
        while self._ongoing > 0 and time.time() < deadline:
            await asyncio.sleep(0.05)
        hook = getattr(self._instance, "__serve_shutdown__", None)
        if hook is not None:
            try:
                result = hook()
                if inspect.isawaitable(result):
                    await asyncio.wait_for(result, timeout=10.0)
            except Exception:
                pass   # teardown is best-effort
