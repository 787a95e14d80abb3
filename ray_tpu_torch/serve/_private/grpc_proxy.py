"""gRPC ingress proxy.

Reference parity: serve/_private/proxy.py gRPCProxy (:534-1131 region —
the reference runs an HTTP and a gRPC proxy side by side). Ours is
built on grpc.aio generic handlers, so neither side needs protoc
codegen: the service is ``raytpu.serve.Serve`` with

    Predict        unary bytes -> bytes
    PredictStream  unary bytes -> stream of bytes

and routing metadata:

    application:  serve application name (default "default")
    call-method:  optional ingress method (default __call__)

Any gRPC client in any language can call it with identity (bytes)
serializers — see tests/test_serve_grpc.py for the Python shape. The
ingress deployment receives the raw request bytes and returns
bytes/str (unary) or a StreamingHint (streamed chunks), exactly like
the HTTP side's streaming contract.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

import ray_tpu_torch

from .common import CONTROLLER_NAME
from .proxy import StreamingHint

logger = logging.getLogger("ray_tpu_torch.serve.grpc")

SERVICE_NAME = "raytpu.serve.Serve"


class GrpcProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        self._host = host
        self._port = port
        self._server = None
        self._apps: Dict[str, str] = {}       # app name -> ingress
        self._handles: Dict[str, object] = {}
        self._refresh_task = None

    async def ready(self) -> int:
        if self._server is not None:
            return self._port
        import grpc

        self._server = grpc.aio.server()
        ident = lambda b: b                    # bytes-in / bytes-out
        handlers = {
            "Predict": grpc.unary_unary_rpc_method_handler(
                self._predict, request_deserializer=ident,
                response_serializer=ident),
            "PredictStream": grpc.unary_stream_rpc_method_handler(
                self._predict_stream, request_deserializer=ident,
                response_serializer=ident),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),))
        bound = self._server.add_insecure_port(
            f"{self._host}:{self._port}")
        if bound == 0:
            raise OSError(
                f"gRPC proxy could not bind {self._host}:{self._port} "
                "(port in use?)")
        self._port = bound
        await self._server.start()
        self._refresh_task = asyncio.create_task(self._refresh_loop())
        return self._port

    # ------------------------------------------------------------- routes

    async def _refresh_once(self) -> None:
        controller = await ray_tpu_torch.aio_get_actor(CONTROLLER_NAME)
        table = await controller.get_route_table.remote()
        self._apps = {app: ingress for app, ingress in table.values()}

    async def _refresh_loop(self) -> None:
        while True:
            try:
                await self._refresh_once()
            except Exception:
                pass
            await asyncio.sleep(1.0)

    async def _resolve(self, context):
        md = dict(context.invocation_metadata())
        app = md.get("application", "default")
        method = md.get("call-method")
        if app not in self._apps:
            try:
                await self._refresh_once()
            except Exception:
                pass
        ingress = self._apps.get(app)
        if ingress is None:
            import grpc
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no serve application {app!r}")
        key = f"{app}#{ingress}"
        handle = self._handles.get(key)
        if handle is None:
            from ..handle import DeploymentHandle
            handle = DeploymentHandle(ingress, app)
            self._handles[key] = handle
        return handle, method

    # ------------------------------------------------------------ methods

    async def _predict(self, request: bytes, context) -> bytes:
        handle, method = await self._resolve(context)
        if method:
            handle = handle.options(method_name=method)
        try:
            result = await handle.remote(request)
        except Exception as e:
            import grpc
            logger.exception("grpc Predict failed")
            await context.abort(grpc.StatusCode.INTERNAL, repr(e))
        if isinstance(result, StreamingHint):
            import grpc
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "ingress returned a stream; call PredictStream")
        return self._to_bytes(result)

    async def _predict_stream(self, request: bytes, context):
        handle, method = await self._resolve(context)
        if method:
            handle = handle.options(method_name=method)
        result = await handle.remote(request)
        if not isinstance(result, StreamingHint):
            # unary result over the stream method: one chunk
            yield self._to_bytes(result)
            return
        gen = handle.options(method_name=result.call_method,
                             stream=True).remote(result.payload)
        try:
            async for chunk in gen:
                yield self._to_bytes(chunk)
        finally:
            gen.close()

    @staticmethod
    def _to_bytes(result) -> bytes:
        if isinstance(result, bytes):
            return result
        if isinstance(result, str):
            return result.encode()
        if result is None:
            return b""
        import json
        return json.dumps(result).encode()

    async def shutdown(self) -> bool:
        if self._refresh_task:
            self._refresh_task.cancel()
        if self._server is not None:
            await self._server.stop(grace=0.5)
            self._server = None
        return True
