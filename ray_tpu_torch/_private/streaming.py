"""Streaming generators: num_returns="streaming".

Reference parity: python/ray/_raylet.pyx:295 (ObjectRefGenerator) +
src/ray/core_worker/task_manager.h:364 (dynamic return streaming).
Architecture here follows the repo's owner-push model: the executing
worker pushes each yielded value to the owner as a normal object
(object_ready with stream metadata), then an end-of-stream marker. The
owner keeps a StreamState per generator; consumers block on the next
index. Backpressure: the worker pauses when more than
`backpressure` items are unconsumed; the consumer acks each item it
takes and the owner forwards the ack to the worker.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from .object_ref import ObjectRef


class StreamState:
    """Owner-side bookkeeping for one streaming generator."""

    def __init__(self, generator_id: str, wants_ack: bool = False):
        self.generator_id = generator_id
        self.items: Dict[int, str] = {}          # index -> object_id
        self.total: Optional[int] = None         # set at end-of-stream
        self.worker_addr: Optional[Tuple[str, int]] = None
        self.error: Optional[Exception] = None   # submission-level failure
        self.wants_ack = wants_ack               # backpressure requested
        self.cancelled = False                   # consumer abandoned
        self.cancel_sent = False
        self.event = asyncio.Event()

    def put(self, index: int, object_id: str,
            worker_addr=None) -> None:
        self.items[index] = object_id
        if worker_addr is not None:
            self.worker_addr = tuple(worker_addr)
        self.event.set()

    def finish(self, total: int) -> None:
        self.total = total
        self.event.set()

    def fail(self, error: Exception) -> None:
        self.error = error
        self.total = len(self.items)
        self.event.set()

    async def wait_for(self, index: int) -> Optional[str]:
        """Object id for item `index`, or None past end-of-stream."""
        while True:
            if index in self.items:
                return self.items[index]
            if self.total is not None and index >= self.total:
                if self.error is not None:
                    raise self.error
                return None
            self.event.clear()
            await self.event.wait()


class ObjectRefGenerator:
    """Iterator over a streaming task's yielded ObjectRefs.

    Supports sync iteration (driver/worker threads) and async iteration
    (async actors). Each next() returns an ObjectRef whose value is
    already owned by this process — `ray_tpu_torch.get(ref)` on it is local.
    """

    def __init__(self, generator_id: str, client):
        self._id = generator_id
        self._client = client
        self._cursor = 0
        self._closed = False
        #: optional hook invoked exactly once when the stream ends
        #: (exhaustion, close, or GC) — used e.g. by serve's router to
        #: track per-replica live streams
        self.on_finish = None

    def _finish(self) -> None:
        cb, self.on_finish = self.on_finish, None
        if cb is not None:
            try:
                cb()
            except Exception:
                pass

    @property
    def generator_id(self) -> str:
        return self._id

    def close(self) -> None:
        """Stop the producer and release unconsumed items. Called
        automatically when the generator is garbage-collected."""
        if self._closed:
            return
        self._closed = True
        try:
            self._client.release_stream(self._id, self._cursor)
        except Exception:
            pass
        self._finish()

    def __del__(self):
        self.close()

    # -- sync protocol ----------------------------------------------------

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        ref = self._client.next_stream_item(self._id, self._cursor)
        if ref is None:
            self._finish()
            raise StopIteration
        self._cursor += 1
        return ref

    # -- async protocol ---------------------------------------------------

    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        ref = await self._client.aio_next_stream_item(self._id, self._cursor)
        if ref is None:
            self._finish()
            raise StopAsyncIteration
        self._cursor += 1
        return ref

    def completed(self) -> List[ObjectRef]:
        """Drain the rest of the stream synchronously."""
        return list(self)

    def __repr__(self) -> str:
        return f"ObjectRefGenerator({self._id[:16]}, next={self._cursor})"
