"""HTTP ingress proxy.

The port's copy of ``ray_tpu/serve/_private/proxy.py`` (reference
parity: serve/_private/proxy.py:534-1131, HTTPProxy on uvicorn; route
table from the controller, requests forwarded through handles). The JAX
package serves it with aiohttp; this one speaks HTTP/1.1 itself on the
standard library's asyncio streams (``asyncio.start_server``), as the
runtime's RPC layer does, inside an async actor. Routes, status codes,
JSON bodies, ``Content-Type`` values, route-prefix matching and 404s
are the JAX proxy's; persistent connections and ``Expect:
100-continue`` are honoured; streamed responses go out with chunked
transfer encoding. The route table refreshes on a short poll of the
controller; request bodies are forwarded to the app's ingress
deployment via the async handle path.

Ingress contract: the ingress callable receives a `serve.Request`
(method/path/headers/query/body helpers). Return values map to HTTP:
dict/list → JSON, str → text/plain, bytes → octet-stream,
Response(status, body, content_type) for full control.
"""

from __future__ import annotations

import asyncio
import json
import logging
from http import HTTPStatus
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote

import ray_tpu_torch

from .common import CONTROLLER_NAME

logger = logging.getLogger("ray_tpu_torch.serve.proxy")

# the largest request body the proxy reads (the JAX proxy's aiohttp
# client_max_size)
MAX_BODY_BYTES = 64 * 1024 * 1024
JSON_TYPE = "application/json; charset=utf-8"
TEXT_TYPE = "text/plain; charset=utf-8"


class Request:
    """What HTTP ingress callables receive (picklable, unlike an ASGI
    scope)."""

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query_params = query
        self.headers = headers
        self._body = body

    def body(self) -> bytes:
        return self._body

    def json(self) -> Any:
        return json.loads(self._body or b"null")

    @property
    def text(self) -> str:
        return (self._body or b"").decode()


class Response:
    def __init__(self, body: Any = b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        # extra response headers (Location, Set-Cookie, ...); content
        # length is recomputed by the proxy
        self.headers = headers


class StreamingHint:
    """Returned by an ingress to switch the proxy to a streaming call:
    the proxy re-invokes `call_method` on the SAME ingress with
    stream=True and writes each yielded str/bytes chunk to the HTTP
    response as it arrives (SSE and chunked responses ride this)."""

    def __init__(self, call_method: str, payload: Any,
                 content_type: str = "text/event-stream"):
        self.call_method = call_method
        self.payload = payload
        self.content_type = content_type


class _BadRequest(Exception):
    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


def _first_of_each(pairs) -> Dict[str, str]:
    """A repeated query key or header keeps its first value, as a dict of
    the JAX proxy's aiohttp multidicts does."""
    out: Dict[str, str] = {}
    for k, v in pairs:
        out.setdefault(k, v)
    return out


class _HttpRequest:
    """One parsed request off the wire."""

    def __init__(self, method: str, target: str, version: str,
                 headers: List[Tuple[str, str]]):
        self.method = method
        self.version = version
        self.headers = headers
        raw_path, _, qs = target.partition("?")
        self.path = unquote(raw_path) or "/"
        self.query = _first_of_each(parse_qsl(qs, keep_blank_values=True))

    def header(self, name: str) -> Optional[str]:
        name = name.lower()
        for k, v in self.headers:
            if k.lower() == name:
                return v
        return None

    def keep_alive(self) -> bool:
        conn = (self.header("connection") or "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[_HttpRequest]:
    """Request line and headers; None when the client closed the
    connection between requests."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise _BadRequest(400, "malformed request line") from None
    if not version.startswith("HTTP/1."):
        raise _BadRequest(505, f"unsupported version {version}")
    headers: List[Tuple[str, str]] = []
    while True:
        line = await reader.readline()
        if not line:
            raise _BadRequest(400, "connection closed inside the headers")
        if line in (b"\r\n", b"\n"):
            break
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest(400, "malformed header line")
        headers.append((name.strip(), value.strip()))
    return _HttpRequest(method.upper(), target, version, headers)


async def _read_body(req: _HttpRequest, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> bytes:
    chunked = "chunked" in (req.header("transfer-encoding") or "").lower()
    length = req.header("content-length")
    if not chunked and length is None:
        return b""
    if (req.header("expect") or "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if not chunked:
        try:
            n = int(length)
        except ValueError:
            raise _BadRequest(400, "malformed Content-Length") from None
        if n < 0:
            raise _BadRequest(400, "malformed Content-Length")
        if n > MAX_BODY_BYTES:
            raise _BadRequest(413, f"body of {n} bytes over the limit "
                                   f"of {MAX_BODY_BYTES}")
        return await reader.readexactly(n)
    parts: List[bytes] = []
    total = 0
    while True:
        size_line = await reader.readline()
        try:
            size = int(size_line.split(b";")[0].strip(), 16)
        except ValueError:
            raise _BadRequest(400, "malformed chunk size") from None
        if size == 0:
            # trailers, then the blank line that ends the body
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            return b"".join(parts)
        total += size
        if total > MAX_BODY_BYTES:
            raise _BadRequest(413, f"body over the limit of "
                                   f"{MAX_BODY_BYTES} bytes")
        parts.append(await reader.readexactly(size))
        await reader.readexactly(2)         # the chunk's CRLF


def _head(status: int, headers: List[Tuple[str, str]]) -> bytes:
    try:
        reason = HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class _Reply:
    """A whole (non-streamed) response."""

    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: Optional[str] = "application/octet-stream",
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}

    def encode(self, keep_alive: bool) -> bytes:
        headers = list(self.headers.items())
        if self.status != 204:
            if self.content_type is not None:
                headers.append(("Content-Type", self.content_type))
            headers.append(("Content-Length", str(len(self.body))))
        if not keep_alive:
            headers.append(("Connection", "close"))
        return _head(self.status, headers) + (
            b"" if self.status == 204 else self.body)


def _text(text: str, status: int = 200) -> _Reply:
    return _Reply(status, text.encode(), TEXT_TYPE)


def _json(obj: Any, status: int = 200) -> _Reply:
    return _Reply(status, json.dumps(obj).encode(), JSON_TYPE)


class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._host = host
        self._port = port
        self._routes: Dict[str, Tuple[str, str]] = {}
        self._handles: Dict[str, Any] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._refresh_task: Optional[asyncio.Task] = None
        self._conns: set = set()

    async def ready(self) -> int:
        """Start the server; returns the bound port."""
        if self._server is not None:
            return self._port
        self._server = await asyncio.start_server(
            self._serve_connection, self._host, self._port,
            limit=1 << 20)
        if self._port == 0:
            self._port = self._server.sockets[0].getsockname()[1]
        self._refresh_task = asyncio.create_task(self._refresh_routes())
        return self._port

    async def _refresh_once(self) -> None:
        controller = await ray_tpu_torch.aio_get_actor(CONTROLLER_NAME)
        table = await controller.get_route_table.remote()
        self._routes = dict(table)

    async def _refresh_routes(self) -> None:
        while True:
            try:
                await self._refresh_once()
            except Exception:
                pass
            await asyncio.sleep(1.0)

    def _match(self, path: str) -> Optional[Tuple[str, str, str]]:
        """Longest-prefix route match → (prefix, app, ingress)."""
        best = None
        for prefix, (app, ingress) in self._routes.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(
                    norm + ("" if norm == "/" else "/")) or norm == "/":
                if best is None or len(norm) > len(best[0]):
                    best = (norm, app, ingress)
        return best

    # -- the connection ----------------------------------------------------
    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    req = await _read_request(reader)
                    if req is None:
                        return
                    body = await _read_body(req, reader, writer)
                except _BadRequest as e:
                    writer.write(_text(e.text, e.status).encode(False))
                    await writer.drain()
                    return
                except (asyncio.IncompleteReadError, ConnectionError,
                        asyncio.LimitOverrunError, ValueError):
                    return
                keep = req.keep_alive()
                if not await self._handle_http(req, body, writer, keep):
                    return
                if not keep:
                    return
        except ConnectionError:
            pass        # the client went away mid-response
        finally:
            self._conns.discard(task)
            writer.close()

    async def _handle_http(self, request: _HttpRequest, body: bytes,
                           writer: asyncio.StreamWriter,
                           keep_alive: bool) -> bool:
        """Answer one request; False when the connection must close."""
        path = request.path
        if path == "/-/healthz":
            return await self._send(writer, _text("success"), keep_alive)
        if path == "/-/routes":
            return await self._send(writer, _json(
                {p: f"{a}#{i}" for p, (a, i) in self._routes.items()}),
                keep_alive)
        match = self._match(path)
        if match is None:
            # the app may have deployed since the last poll tick —
            # refresh inline once before giving up
            try:
                await self._refresh_once()
            except Exception:
                pass
            match = self._match(path)
        if match is None:
            return await self._send(
                writer, _text(f"no app mounted at {path}", 404),
                keep_alive)
        prefix, app_name, ingress = match
        from ..handle import DeploymentHandle
        hkey = f"{app_name}#{ingress}"
        handle = self._handles.get(hkey)
        if handle is None:
            handle = DeploymentHandle(ingress, app_name)
            self._handles[hkey] = handle
        sub_path = path[len(prefix):] if prefix != "/" else path
        req = Request(request.method, sub_path or "/", request.query,
                      _first_of_each(request.headers), body)
        try:
            result = await handle.remote(req)
        except Exception as e:
            logger.exception("request to %s failed", hkey)
            return await self._send(writer, _text(repr(e), 500),
                                    keep_alive)
        if isinstance(result, StreamingHint):
            return await self._stream_http(writer, handle, result,
                                           request.version, keep_alive)
        return await self._send(writer, self._to_http(result), keep_alive)

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, reply: _Reply,
                    keep_alive: bool) -> bool:
        writer.write(reply.encode(keep_alive))
        await writer.drain()
        return keep_alive

    async def _stream_http(self, writer: asyncio.StreamWriter, handle,
                           hint: StreamingHint, version: str,
                           keep_alive: bool) -> bool:
        # HTTP/1.0 has no chunked encoding: the body ends where the
        # connection does
        chunked = version != "HTTP/1.0"
        headers = [("Content-Type", hint.content_type),
                   ("Cache-Control", "no-cache")]
        headers.append(("Transfer-Encoding", "chunked") if chunked
                       else ("Connection", "close"))
        writer.write(_head(200, headers))
        await writer.drain()
        gen = handle.options(method_name=hint.call_method,
                             stream=True).remote(hint.payload)
        try:
            async for chunk in gen:
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                if not chunk:
                    continue    # an empty chunk would end the body
                writer.write(b"%x\r\n%s\r\n" % (len(chunk), chunk)
                             if chunked else chunk)
                await writer.drain()
        except ConnectionError:
            raise
        except Exception:
            logger.exception("stream %s failed", hint.call_method)
        finally:
            gen.close()
        if not chunked:
            return False
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return keep_alive

    @staticmethod
    def _to_http(result) -> _Reply:
        if isinstance(result, Response):
            body = result.body
            if isinstance(body, (dict, list)):
                body = json.dumps(body).encode()
            elif isinstance(body, str):
                body = body.encode()
            extra = {k: v for k, v in (result.headers or {}).items()
                     if k.lower() not in ("content-type",
                                          "content-length")}
            return _Reply(result.status, body, result.content_type, extra)
        if isinstance(result, (dict, list)):
            return _json(result)
        if isinstance(result, str):
            return _text(result)
        if isinstance(result, bytes):
            return _Reply(200, result)
        if result is None:
            return _Reply(204, b"", None)
        return _json({"result": repr(result)})

    async def shutdown(self) -> bool:
        if self._refresh_task:
            self._refresh_task.cancel()
        if self._server is not None:
            self._server.close()
            for task in list(self._conns):
                task.cancel()
            await self._server.wait_closed()
            self._server = None
        return True
