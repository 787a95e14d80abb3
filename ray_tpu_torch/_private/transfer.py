"""Cross-node object transfer primitives shared by the worker fetch path
and the daemon prefetcher (reference parity: ObjectManager chunked
push/pull, src/ray/object_manager/object_manager.h:208-216)."""

from __future__ import annotations

import asyncio
from typing import Optional

from .config import get_config


async def fetch_flat(node, object_id: str, size: Optional[int] = None,
                     per_call_timeout: Optional[float] = None) -> bytes:
    """Pull an object's flat bytes from a node daemon — one RPC below
    the chunk threshold, semaphore-windowed chunk gather above it.

    `node` is a ClientPool connection to the daemon holding the bytes.
    Raises ConnectionError if the node no longer has the object.
    """
    chunk_bytes = get_config().fetch_chunk_bytes
    chunk_window = get_config().fetch_chunk_window

    async def call(method, **kw):
        coro = node.call(method, **kw)
        if per_call_timeout is not None:
            return await asyncio.wait_for(coro, timeout=per_call_timeout)
        return await coro

    if size is None:
        meta = await call("fetch_object_meta", object_id=object_id)
        if meta is None:
            raise ConnectionError(f"object {object_id[:12]} not on node")
        size = meta["size"]
    if size <= chunk_bytes:
        flat = await call("fetch_object", object_id=object_id)
        if flat is None:
            raise ConnectionError(f"object {object_id[:12]} not on node")
        return flat
    buf = bytearray(size)
    sem = asyncio.Semaphore(chunk_window)

    async def pull(offset: int):
        async with sem:
            chunk = await call(
                "fetch_object_chunk", object_id=object_id, offset=offset,
                length=min(chunk_bytes, size - offset))
        if chunk is None:
            raise ConnectionError(
                f"object {object_id[:12]} chunk source lost")
        buf[offset:offset + len(chunk)] = chunk

    await asyncio.gather(*(pull(o) for o in range(0, size, chunk_bytes)))
    return buf     # bytearray: callers wrap via from_flat without a copy
