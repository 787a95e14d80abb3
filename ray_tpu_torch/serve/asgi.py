"""ASGI ingress adapter: mount any ASGI application (FastAPI,
Starlette, Quart, a raw ASGI callable) as a deployment's HTTP ingress.

Reference parity: python/ray/serve/api.py:172 ``@serve.ingress(app)`` —
the reference wires FastAPI into its uvicorn proxy; here the adapter
speaks the ASGI protocol DIRECTLY: the proxy's picklable
``serve.Request`` becomes an ASGI http scope, the app's
``http.response.*`` messages become a ``serve.Response``. No web
framework is imported by the adapter itself, so it works with whatever
ASGI framework the environment provides (FastAPI is not bundled in
this image; the protocol is exercised against a hand-rolled ASGI app
in tests and accepts FastAPI/Starlette apps unchanged).

    app = FastAPI()          # or any ASGI callable

    @serve.deployment
    @serve.ingress(app)
    class Api:
        pass                 # routes live on the ASGI app

The app's lifespan protocol runs once per replica on first request
(startup; a reported startup failure makes every request fail loudly)
and ``aclose()`` sends lifespan.shutdown best-effort on teardown.
Streaming ASGI responses are buffered (one proxy hop carries the full
body); use the native StreamingHint ingress for SSE/chunked streams.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional
from urllib.parse import urlencode

from ._private.proxy import Request, Response


class ASGIAdapter:
    """Runs one ASGI app; converts serve.Request <-> ASGI messages."""

    def __init__(self, app):
        self.app = app
        self._startup: Optional[asyncio.Future] = None
        self._startup_error: Optional[Exception] = None
        self._lifespan_receive_q: Optional[asyncio.Queue] = None

    async def _start_lifespan(self) -> None:
        """Best-effort lifespan.startup (FastAPI apps that register
        startup hooks need it; apps without a lifespan handler raise —
        that is allowed by the spec and simply skipped)."""
        receive_q: asyncio.Queue = asyncio.Queue()
        started = asyncio.get_event_loop().create_future()

        async def receive():
            return await receive_q.get()

        async def send(message):
            if message["type"] == "lifespan.startup.complete" \
                    and not started.done():
                started.set_result(True)
            if message["type"] == "lifespan.startup.failed" \
                    and not started.done():
                started.set_exception(
                    RuntimeError(message.get("message", "startup failed")))

        await receive_q.put({"type": "lifespan.startup"})
        self._lifespan_task = asyncio.ensure_future(
            self.app({"type": "lifespan", "asgi": {"version": "3.0"}},
                     receive, send))
        self._lifespan_receive_q = receive_q
        # watch BOTH the completion future and the app task: an app
        # that raises on the lifespan scope (no lifespan support, per
        # spec) is detected instantly, not after a 10s stall
        done, _ = await asyncio.wait(
            {started, self._lifespan_task},
            timeout=10.0, return_when=asyncio.FIRST_COMPLETED)
        if started in done and started.exception() is not None:
            # the app REPORTED lifespan.startup.failed: serving against
            # a half-initialized app produces confusing per-request
            # errors — fail loudly instead (ASGI spec: do not serve)
            self._startup_error = started.exception()
            raise RuntimeError(
                f"ASGI app startup failed: {self._startup_error}")
        if started not in done:
            # app died on / ignored the lifespan scope: allowed by the
            # spec — serve without lifespan
            self._lifespan_task.cancel()
        if not started.done():
            started.cancel()

    async def handle(self, request: Request) -> Response:
        if self._startup is None:
            # one shared startup: concurrent first requests all await
            # the same future instead of racing past a boolean
            self._startup = asyncio.ensure_future(self._start_lifespan())
        await asyncio.shield(self._startup)
        if self._startup_error is not None:
            raise RuntimeError(
                f"ASGI app startup failed: {self._startup_error}")
        headers = [(k.lower().encode("latin-1"), v.encode("latin-1"))
                   for k, v in (request.headers or {}).items()]
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.method.upper(),
            "scheme": "http",
            "path": request.path or "/",
            "raw_path": (request.path or "/").encode("latin-1"),
            "query_string": urlencode(
                request.query_params or {}).encode("latin-1"),
            "root_path": "",
            "headers": headers,
            "client": ("127.0.0.1", 0),
            "server": ("127.0.0.1", 0),
        }
        body = request.body() or b""
        sent_request = False
        status: Dict[str, Any] = {"code": 500, "headers": []}
        chunks: List[bytes] = []
        done = asyncio.Event()

        async def receive():
            nonlocal sent_request
            if not sent_request:
                sent_request = True
                return {"type": "http.request", "body": body,
                        "more_body": False}
            await done.wait()            # client never disconnects early
            return {"type": "http.disconnect"}

        async def send(message):
            if message["type"] == "http.response.start":
                status["code"] = message["status"]
                status["headers"] = message.get("headers", [])
            elif message["type"] == "http.response.body":
                chunks.append(message.get("body", b"") or b"")
                if not message.get("more_body", False):
                    done.set()

        await self.app(scope, receive, send)
        done.set()
        content_type = "application/octet-stream"
        extra: Dict[str, str] = {}
        for k, v in status["headers"]:
            name = k.decode("latin-1").lower()
            if name == "content-type":
                content_type = v.decode("latin-1").split(";")[0].strip()
            elif name != "content-length":   # proxy recomputes length
                extra[name] = v.decode("latin-1")
        return Response(b"".join(chunks), status=status["code"],
                        content_type=content_type,
                        headers=extra or None)


    async def aclose(self) -> None:
        """Best-effort lifespan.shutdown (replica teardown)."""
        task = getattr(self, "_lifespan_task", None)
        q = self._lifespan_receive_q
        if task is None or task.done() or q is None:
            return
        try:
            await q.put({"type": "lifespan.shutdown"})
            await asyncio.wait_for(asyncio.shield(task), timeout=5.0)
        except Exception:
            task.cancel()


def ingress(app):
    """Class decorator mounting ``app`` (ASGI) as the deployment's HTTP
    ingress: requests hitting the deployment's route prefix run through
    the ASGI app; class methods/handle calls still work normally."""

    def decorator(cls):
        adapter_holder = {}

        class ASGIIngress(cls):
            async def __call__(self, request: Request):
                adapter = adapter_holder.get("a")
                if adapter is None:
                    adapter = adapter_holder["a"] = ASGIAdapter(app)
                return await adapter.handle(request)

            async def __serve_shutdown__(self):
                adapter = adapter_holder.get("a")
                if adapter is not None:
                    await adapter.aclose()

        ASGIIngress.__name__ = cls.__name__
        ASGIIngress.__qualname__ = getattr(cls, "__qualname__",
                                           cls.__name__)
        ASGIIngress.__module__ = cls.__module__
        ASGIIngress.__asgi_app__ = app
        return ASGIIngress

    return decorator
