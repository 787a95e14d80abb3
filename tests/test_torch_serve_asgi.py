"""ray_tpu_torch.serve's ASGI ingress adapter (reference:
python/ray/serve/api.py:172 @serve.ingress).

Mirrors tests/test_serve_asgi.py case for case on the port's runtime,
with urllib in place of requests and a proxy port the proxy picks.
FastAPI is not bundled here, so the protocol is exercised with a
hand-rolled ASGI application (routing, query/body/headers, status
codes, lifespan); the FastAPI case runs when the package is available.
"""

import http.client
import json
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_cluster():
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _proxy_port():
    return ray_tpu_torch.get(
        ray_tpu_torch.get_actor("SERVE_PROXY").ready.remote(), timeout=30)


def _get(url, headers=None):
    """(status, headers, body) of a GET, error statuses included, no
    redirect followed."""
    host, _, path = url[len("http://"):].partition("/")
    conn = http.client.HTTPConnection(host, timeout=15)
    try:
        conn.request("GET", "/" + path, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.headers, r.read()
    finally:
        conn.close()


@pytest.fixture(autouse=True)
def _cleanup_apps(serve_cluster):
    yield
    try:
        for app in list(serve.status()["applications"]):
            serve.delete(app)
    except Exception:
        pass


STARTED = {"flag": False}


async def tiny_asgi_app(scope, receive, send):
    """Minimal but protocol-complete ASGI app: lifespan + routes."""
    if scope["type"] == "lifespan":
        while True:
            message = await receive()
            if message["type"] == "lifespan.startup":
                STARTED["flag"] = True
                await send({"type": "lifespan.startup.complete"})
            elif message["type"] == "lifespan.shutdown":
                await send({"type": "lifespan.shutdown.complete"})
                return
    assert scope["type"] == "http"
    message = await receive()
    body = message.get("body", b"")

    async def respond(status, payload, ctype=b"application/json"):
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", ctype)]})
        await send({"type": "http.response.body", "body": payload})

    path, method = scope["path"], scope["method"]
    if path == "/hello" and method == "GET":
        q = scope["query_string"].decode()
        await respond(200, json.dumps(
            {"hi": True, "q": q}).encode())
    elif path == "/sum" and method == "POST":
        data = json.loads(body or b"{}")
        await respond(200, json.dumps(
            {"sum": data["a"] + data["b"]}).encode())
    elif path == "/echo-header":
        hdrs = {k.decode(): v.decode() for k, v in scope["headers"]}
        await respond(200, json.dumps(
            {"x": hdrs.get("x-custom", "")}).encode())
    elif path == "/redirect":
        await send({"type": "http.response.start", "status": 307,
                    "headers": [(b"location", b"/api/hello"),
                                (b"set-cookie", b"sid=1")]})
        await send({"type": "http.response.body", "body": b""})
    elif path == "/chunked":
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"text/plain")]})
        await send({"type": "http.response.body", "body": b"part1-",
                    "more_body": True})
        await send({"type": "http.response.body", "body": b"part2"})
    else:
        await respond(404, b'{"error": "nope"}')


def test_asgi_ingress_end_to_end(serve_cluster):
    @serve.deployment
    @serve.ingress(tiny_asgi_app)
    class Api:
        pass

    serve.run(Api.bind(), name="asgi", route_prefix="/api",
              http_options=serve.HTTPOptions(port=0))
    base = f"http://127.0.0.1:{_proxy_port()}/api"
    status, _, body = _get(base + "/hello?who=x")
    assert status == 200 and json.loads(body)["hi"] is True
    assert "who=x" in json.loads(body)["q"]
    r = urllib.request.urlopen(urllib.request.Request(
        base + "/sum", data=json.dumps({"a": 4, "b": 8}).encode(),
        headers={"Content-Type": "application/json"}), timeout=15)
    assert r.status == 200 and json.loads(r.read()) == {"sum": 12}
    status, _, body = _get(base + "/echo-header", {"X-Custom": "abc"})
    assert json.loads(body) == {"x": "abc"}
    # multi-chunk ASGI bodies are buffered into one response
    status, _, body = _get(base + "/chunked")
    assert status == 200 and body == b"part1-part2"
    status, _, _ = _get(base + "/missing")
    assert status == 404
    # response headers (Location, Set-Cookie) pass through the proxy
    status, headers, _ = _get(base + "/redirect")
    assert status == 307
    assert headers.get("Location") == "/api/hello"
    assert "sid=1" in headers.get("Set-Cookie", "")


def test_asgi_adapter_unit():
    """Protocol-level checks without a cluster: scope fields + lifespan
    startup ran."""
    import asyncio

    from ray_tpu_torch.serve.asgi import ASGIAdapter
    from ray_tpu_torch.serve._private.proxy import Request

    STARTED["flag"] = False
    adapter = ASGIAdapter(tiny_asgi_app)
    req = Request("POST", "/sum", {}, {"content-type": "application/json"},
                  json.dumps({"a": 1, "b": 2}).encode())
    resp = asyncio.run(adapter.handle(req))
    assert resp.status == 200
    assert json.loads(resp.body) == {"sum": 3}
    assert resp.content_type == "application/json"
    assert STARTED["flag"], "lifespan startup did not run"


def test_fastapi_app_if_available(serve_cluster):
    fastapi = pytest.importorskip("fastapi")

    app = fastapi.FastAPI()

    @app.get("/items/{item_id}")
    def read_item(item_id: int):
        return {"item_id": item_id}

    @serve.deployment
    @serve.ingress(app)
    class FApi:
        pass

    serve.run(FApi.bind(), name="fastapi", route_prefix="/f",
              http_options=serve.HTTPOptions(port=0))
    status, _, body = _get(f"http://127.0.0.1:{_proxy_port()}/f/items/7")
    assert status == 200 and json.loads(body) == {"item_id": 7}
