"""ray_tpu_torch.serve's gRPC ingress (reference parity: the
reference's gRPCProxy running beside the HTTP proxy). Uses grpc.aio
generic handlers — no protoc codegen on either side.

Mirrors tests/test_serve_grpc.py on the port's runtime."""

import json

import pytest

grpc = pytest.importorskip("grpc")

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture()
def serve_cluster():
    ray_tpu_torch.init(num_cpus=8)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _channel_call(port, method, payload, metadata, stream=False):
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    ident = lambda b: b
    if stream:
        fn = channel.unary_stream(
            f"/raytpu.serve.Serve/{method}",
            request_serializer=ident, response_deserializer=ident)
        out = list(fn(payload, metadata=metadata, timeout=60))
    else:
        fn = channel.unary_unary(
            f"/raytpu.serve.Serve/{method}",
            request_serializer=ident, response_deserializer=ident)
        out = fn(payload, metadata=metadata, timeout=60)
    channel.close()
    return out


def test_grpc_predict_and_stream(serve_cluster):
    @serve.deployment
    class Echo:
        def __call__(self, body: bytes):
            return json.dumps({"echo": body.decode()}).encode()

        def shout(self, body: bytes):
            return body.decode().upper()

        def chunks(self, body: bytes):
            return serve.StreamingHint("gen", body.decode())

        def gen(self, text):
            for part in text.split():
                yield part + "|"

    serve.run(Echo.bind(), name="echoapp", route_prefix="/echo",
              http_options=serve.HTTPOptions(port=0))
    port = serve.start_grpc(port=0)

    # unary, default __call__
    reply = _channel_call(port, "Predict", b"hello",
                          [("application", "echoapp")])
    assert json.loads(reply) == {"echo": "hello"}

    # unary, explicit method via call-method metadata
    reply = _channel_call(port, "Predict", b"quiet",
                          [("application", "echoapp"),
                           ("call-method", "shout")])
    assert reply == b"QUIET"

    # server-streaming through a StreamingHint ingress
    chunks = _channel_call(port, "PredictStream", b"a b c",
                           [("application", "echoapp"),
                            ("call-method", "chunks")], stream=True)
    assert b"".join(chunks) == b"a|b|c|"

    # unknown application -> NOT_FOUND
    with pytest.raises(grpc.RpcError) as err:
        _channel_call(port, "Predict", b"x", [("application", "nope")])
    assert err.value.code() == grpc.StatusCode.NOT_FOUND
