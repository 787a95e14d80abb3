"""Asyncio RPC layer: length-prefixed pickle frames over TCP.

Reference parity: ray's gRPC layer (src/ray/rpc/grpc_server.h,
client_call.h). We use a minimal asyncio protocol instead of gRPC: every
process (controller, node daemons, workers, drivers) runs one RpcServer and
dials peers with RpcClient. Calls are request/response with out-of-band
binary buffers (pickle protocol 5) so large numpy/jax host arrays never get
copied into the pickle stream.

Frame layout:
    u32 header_len | header(pickle) | payload buffers...
header = (kind, msg_id, method, nbuf_lens: list[int])
kind: 0=request 1=response-ok 2=response-err 3=oneway
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import struct
import traceback
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_U32 = struct.Struct("<I")

KIND_REQUEST = 0
KIND_RESPONSE_OK = 1
KIND_RESPONSE_ERR = 2
KIND_ONEWAY = 3

# Messages above this size are chunked when written so a single huge frame
# doesn't monopolize the event loop.
MAX_FRAME = 1 << 31


def dumps_oob(obj: Any) -> Tuple[bytes, List[bytes]]:
    """Pickle with out-of-band buffers (zero-copy for large arrays)."""
    buffers: List[pickle.PickleBuffer] = []
    data = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    return data, [b.raw() for b in buffers]


def loads_oob(data: bytes, buffers: List[bytes]) -> Any:
    return pickle.loads(data, buffers=buffers)


class RemoteCallError(Exception):
    """An exception raised on the remote side of an RPC, re-raised locally."""

    def __init__(self, method: str, remote_traceback: str):
        self.method = method
        self.remote_traceback = remote_traceback
        super().__init__(f"RPC {method} failed remotely:\n{remote_traceback}")


class ConnectionLost(Exception):
    pass


async def _read_frame(reader: asyncio.StreamReader):
    raw_len = await reader.readexactly(4)
    (header_len,) = _U32.unpack(raw_len)
    header_bytes = await reader.readexactly(header_len)
    kind, msg_id, method, buf_lens = pickle.loads(header_bytes)
    bufs = []
    for n in buf_lens:
        bufs.append(await reader.readexactly(n))
    return kind, msg_id, method, bufs


def _write_frame(writer: asyncio.StreamWriter, kind: int, msg_id: int,
                 method: str, payload: Any) -> None:
    data, bufs = dumps_oob(payload)
    all_bufs = [data] + bufs
    header = pickle.dumps((kind, msg_id, method, [len(b) for b in all_bufs]))
    writer.write(_U32.pack(len(header)))
    writer.write(header)
    for b in all_bufs:
        writer.write(b)


def _decode_payload(bufs: List[bytes]) -> Any:
    return loads_oob(bufs[0], bufs[1:])


Handler = Callable[..., Awaitable[Any]]


class RpcServer:
    """Serves registered async handlers. One instance per process."""

    def __init__(self, handlers: Optional[Dict[str, Handler]] = None):
        self._handlers: Dict[str, Handler] = handlers or {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.address: Optional[Tuple[str, int]] = None
        self._conn_tasks: set = set()
        self._writers: set = set()

    def register(self, name: str, handler: Handler) -> None:
        self._handlers[name] = handler

    def register_object(self, obj: Any, prefix: str = "") -> None:
        """Register every `rpc_*` coroutine method of obj as a handler."""
        for attr in dir(obj):
            if attr.startswith("rpc_"):
                self._handlers[prefix + attr[4:]] = getattr(obj, attr)

    async def start(self, host: Optional[str] = None,
                    port: int = 0) -> Tuple[str, int]:
        # Every server in the process tree (controller, daemons, the
        # driver's CoreClient, worker CoreClients) binds this default —
        # multi-host clusters need ALL of them reachable (owner_addr /
        # actor addrs cross hosts), not just the control plane.
        if host is None:
            from .config import get_config
            host = get_config().bind_host
        self._server = await asyncio.start_server(self._on_connection, host, port)
        sock = self._server.sockets[0]
        self.address = sock.getsockname()[:2]
        if self.address[0] in ("0.0.0.0", "::"):
            # Advertise a dialable address, not the wildcard bind: the
            # host's primary outbound IP (RAY_TPU_ADVERTISE_HOST overrides).
            from .config import get_config
            adv = get_config().advertise_host
            if not adv:
                import socket as _socket
                probe = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
                try:
                    probe.connect(("8.8.8.8", 80))
                    adv = probe.getsockname()[0]
                except Exception:
                    adv = "127.0.0.1"
                finally:
                    probe.close()
            self.address = (adv, self.address[1])
        return self.address

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for w in list(self._writers):
            try:
                w.close()
            except Exception:
                pass
        if self._server is not None:
            try:
                # 3.12 wait_closed blocks until every connection closes;
                # we just force-closed them, but don't hang on stragglers.
                await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
            except Exception:
                pass
        for t in list(self._conn_tasks):
            t.cancel()

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        write_lock = asyncio.Lock()
        self._writers.add(writer)
        try:
            while True:
                kind, msg_id, method, bufs = await _read_frame(reader)
                task = asyncio.ensure_future(
                    self._dispatch(kind, msg_id, method, bufs, writer, write_lock))
                self._conn_tasks.add(task)
                task.add_done_callback(self._conn_tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, kind, msg_id, method, bufs, writer, write_lock):
        try:
            payload = _decode_payload(bufs)
        except Exception:
            logger.exception("failed to decode payload for %s", method)
            return
        handler = self._handlers.get(method)
        if handler is None:
            if kind == KIND_REQUEST:
                async with write_lock:
                    _write_frame(writer, KIND_RESPONSE_ERR, msg_id, method,
                                 f"no handler for method {method!r}")
                    await writer.drain()
            return
        try:
            result = await handler(**payload)
            if kind == KIND_REQUEST:
                async with write_lock:
                    _write_frame(writer, KIND_RESPONSE_OK, msg_id, method, result)
                    await writer.drain()
        except Exception:
            tb = traceback.format_exc()
            if kind == KIND_REQUEST:
                try:
                    async with write_lock:
                        _write_frame(writer, KIND_RESPONSE_ERR, msg_id, method, tb)
                        await writer.drain()
                except Exception:
                    pass
            else:
                logger.error("oneway handler %s failed:\n%s", method, tb)


class RpcClient:
    """A connection to one peer. Safe for concurrent calls from one loop."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._next_id = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._read_task: Optional[asyncio.Task] = None
        self._write_lock: Optional[asyncio.Lock] = None
        self._connect_lock = asyncio.Lock()
        self._closed = False

    async def connect(self) -> None:
        async with self._connect_lock:
            if self._writer is not None or self._closed:
                return
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port, limit=MAX_FRAME)
            self._write_lock = asyncio.Lock()
            self._read_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        try:
            while True:
                kind, msg_id, method, bufs = await _read_frame(self._reader)
                fut = self._pending.pop(msg_id, None)
                if fut is None or fut.done():
                    continue
                if kind == KIND_RESPONSE_OK:
                    try:
                        fut.set_result(_decode_payload(bufs))
                    except Exception as e:  # corrupt payload
                        fut.set_exception(e)
                else:
                    fut.set_exception(RemoteCallError(method, _decode_payload(bufs)))
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, asyncio.CancelledError) as e:
            err = ConnectionLost(f"connection to {self.host}:{self.port} lost: {e!r}")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            self._writer = None

    async def call(self, _method: str, **kwargs) -> Any:
        if self._writer is None:
            await self.connect()
        msg_id = self._next_id
        self._next_id += 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        async with self._write_lock:
            writer = self._writer  # may go None concurrently on disconnect
            if writer is None:
                self._pending.pop(msg_id, None)
                raise ConnectionError(f"connection closed before {_method}")
            _write_frame(writer, KIND_REQUEST, msg_id, _method, kwargs)
            await writer.drain()
        return await fut

    async def oneway(self, _method: str, **kwargs) -> None:
        if self._writer is None:
            if self._closed:
                return  # fire-and-forget during shutdown: drop silently
            await self.connect()
        async with self._write_lock:
            writer = self._writer
            if writer is None:
                if self._closed:
                    return  # shutdown race: drop silently
                raise ConnectionError(
                    f"connection lost before oneway {_method}")
            _write_frame(writer, KIND_ONEWAY, 0, _method, kwargs)
            await writer.drain()

    async def close(self) -> None:
        self._closed = True
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None

    @property
    def connected(self) -> bool:
        return self._writer is not None


class ClientPool:
    """Caches RpcClients per (host, port)."""

    def __init__(self):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}

    def get(self, addr: Tuple[str, int]) -> RpcClient:
        addr = tuple(addr)
        client = self._clients.get(addr)
        if client is None or client._closed:
            client = RpcClient(*addr)
            self._clients[addr] = client
        return client

    async def close_all(self) -> None:
        for c in self._clients.values():
            await c.close()
        self._clients.clear()
