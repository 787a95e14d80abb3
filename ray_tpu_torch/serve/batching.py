"""@serve.batch: transparent request batching inside a replica.

Reference parity: serve/batching.py — callers invoke the wrapped method
with single items; a background flusher gathers up to max_batch_size
items (or waits batch_wait_timeout_s) and invokes the underlying
function ONCE with the list; per-item results resolve each caller's
future. On GPU replicas this is what keeps the tensor cores fed: many
small HTTP requests fuse into one batched forward pass.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.queue: List = []        # (item, future)
        self._flush_task: Optional[asyncio.Task] = None

    async def submit(self, instance, item) -> Any:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.queue.append((item, fut))
        if len(self.queue) >= self.max_batch_size:
            self._do_flush(instance)
        elif self._flush_task is None:
            self._flush_task = loop.create_task(
                self._delayed_flush(instance))
        return await fut

    async def _delayed_flush(self, instance):
        await asyncio.sleep(self.timeout_s)
        self._do_flush(instance)

    def _do_flush(self, instance) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        batch, self.queue = self.queue, []
        if batch:
            asyncio.ensure_future(self._run_batch(instance, batch))

    async def _run_batch(self, instance, batch) -> None:
        items = [b[0] for b in batch]
        futures = [b[1] for b in batch]
        try:
            if instance is not None:
                results = await self.fn(instance, items)
            else:
                results = await self.fn(items)
            if not isinstance(results, list) or len(results) != len(items):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"{len(items)} results, got {type(results).__name__}")
        except Exception as e:
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
            return
        for fut, res in zip(futures, results):
            if not fut.done():
                fut.set_result(res)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator for async methods/functions taking a list of items."""

    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async function")
        attr = f"__serve_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:          # bound method: (self, item)
                instance, item = args
                q = getattr(instance, attr, None)
                if q is None:
                    q = _BatchQueue(fn, max_batch_size,
                                    batch_wait_timeout_s)
                    setattr(instance, attr, q)
                return await q.submit(instance, item)
            (item,) = args              # free function
            q = getattr(wrapper, "_queue", None)
            if q is None:
                q = wrapper._queue = _BatchQueue(
                    fn, max_batch_size, batch_wait_timeout_s)
            return await q.submit(None, item)

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
