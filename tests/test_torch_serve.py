"""ray_tpu_torch.serve: deployments, composition, routing, scaling,
recovery, HTTP.

Mirrors tests/test_serve.py case for case on the port's runtime. The
HTTP case talks to the port's standard-library proxy with urllib, on a
port the proxy picks (port 0), so that it never meets the JAX suite's
fixed ports. Not mirrored: test_serve_metrics_on_dashboard, which reads
the dashboard's /metrics; the port's dashboard is a later slice
(ROADMAP §A8). The last case holds the port's own HTTP/1.1 handling on
a raw socket.
"""

import asyncio
import json
import time
import urllib.error
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


@pytest.fixture(autouse=True)
def _cleanup_apps(serve_cluster):
    yield
    try:
        for app in list(serve.status()["applications"]):
            serve.delete(app)
    except Exception:
        pass


def _proxy_port():
    return ray_tpu_torch.get(
        ray_tpu_torch.get_actor("SERVE_PROXY").ready.remote(), timeout=30)


def test_basic_deploy_and_call(serve_cluster):
    @serve.deployment
    class Adder:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, x):
            return x + self.offset

    h = serve.run(Adder.bind(10), name="adder", route_prefix="/adder",
                  _start_http=False)
    assert h.remote(5).result(timeout_s=30) == 15


def test_function_deployment(serve_cluster):
    @serve.deployment
    def square(x):
        return x * x

    h = serve.run(square.bind(), name="sq", route_prefix="/sq",
                  _start_http=False)
    assert h.remote(7).result(timeout_s=30) == 49


def test_composition_and_method_calls(serve_cluster):
    @serve.deployment
    class Tokenizer:
        def tokenize(self, text):
            return text.split()

    @serve.deployment
    class Pipeline:
        def __init__(self, tok):
            self.tok = tok

        async def __call__(self, text):
            toks = await self.tok.tokenize.remote(text)
            return len(toks)

    h = serve.run(Pipeline.bind(Tokenizer.bind()), name="pipe",
                  route_prefix="/pipe", _start_http=False)
    assert h.remote("a b c d").result(timeout_s=30) == 4


def test_scale_up_via_redeploy(serve_cluster):
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self, _):
            return "ok"

    serve.run(S.bind(), name="scale", route_prefix="/scale",
              _start_http=False)
    st = serve.status()["applications"]["scale"]["deployments"]["S"]
    assert st["target"] == 1

    serve.run(S.options(num_replicas=3).bind(), name="scale",
              route_prefix="/scale", _start_http=False)
    deadline = time.time() + 30
    while time.time() < deadline:
        st = serve.status()["applications"]["scale"]["deployments"]["S"]
        running = [s for s in st["replica_states"].values()
                   if s == "RUNNING"]
        if st["target"] == 3 and len(running) == 3:
            break
        time.sleep(0.2)
    assert st["target"] == 3 and len(running) == 3


def test_rolling_update_changes_version(serve_cluster):
    @serve.deployment
    class V:
        def __call__(self, _):
            return 1

    serve.run(V.bind(), name="vapp", route_prefix="/v", _start_http=False)
    v1 = serve.status()["applications"]["vapp"]["deployments"]["V"][
        "version"]

    @serve.deployment(name="V")
    class V2:
        def __call__(self, _):
            return 2

    h = serve.run(V2.bind(), name="vapp", route_prefix="/v",
                  _start_http=False)
    v2 = serve.status()["applications"]["vapp"]["deployments"]["V"][
        "version"]
    assert v1 != v2
    assert h.remote(None).result(timeout_s=30) == 2


def test_replica_failure_recovery(serve_cluster):
    @serve.deployment(num_replicas=2, health_check_period_s=0.5)
    class F:
        def pid(self):
            import os
            return os.getpid()

        def __call__(self, _):
            return "alive"

    h = serve.run(F.bind(), name="fail", route_prefix="/fail",
                  _start_http=False)
    assert h.remote(None).result(timeout_s=30) == "alive"
    # kill one replica actor out from under the controller
    rt = ray_tpu_torch
    st = serve.status()["applications"]["fail"]["deployments"]["F"]
    assert len(st["replica_states"]) == 2
    # find a replica actor via the controller's target list
    controller = rt.get_actor("SERVE_CONTROLLER")
    wire = rt.get(controller.get_deployment_targets.remote("fail#F"),
                  timeout=10)
    victim = wire["replicas"][0][1]
    rt.kill(victim)
    # controller must detect and respawn; service stays available
    deadline = time.time() + 30
    ok = False
    while time.time() < deadline:
        try:
            if h.remote(None).result(timeout_s=10) == "alive":
                st = serve.status()["applications"]["fail"][
                    "deployments"]["F"]
                running = [s for s in st["replica_states"].values()
                           if s == "RUNNING"]
                if len(running) == 2:
                    ok = True
                    break
        except Exception:
            pass
        time.sleep(0.3)
    assert ok, "deployment did not recover to 2 running replicas"


def test_user_config_reconfigure(serve_cluster):
    @serve.deployment(user_config={"threshold": 1})
    class C:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, cfg):
            self.threshold = cfg["threshold"]

        def __call__(self, _):
            return self.threshold

    h = serve.run(C.bind(), name="cfg", route_prefix="/cfg",
                  _start_http=False)
    assert h.remote(None).result(timeout_s=30) == 1


def test_batching(serve_cluster):
    @serve.deployment
    class B:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def handle(self, items):
            # one call sees several items
            return [(x, len(items)) for x in items]

        async def __call__(self, x):
            return await self.handle(x)

    h = serve.run(B.bind(), name="batch", route_prefix="/batch",
                  _start_http=False)
    resps = [h.remote(i) for i in range(8)]
    out = [r.result(timeout_s=30) for r in resps]
    values = [v for v, _ in out]
    batch_sizes = [b for _, b in out]
    assert sorted(values) == list(range(8))
    assert max(batch_sizes) > 1, f"no batching happened: {batch_sizes}"


def test_multiplexing(serve_cluster):
    @serve.deployment
    class M:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            return {"id": model_id, "loaded_at": time.time()}

        async def __call__(self, _):
            mid = serve.get_multiplexed_model_id()
            model = await self.get_model(mid)
            return model["id"]

    h = serve.run(M.bind(), name="mux", route_prefix="/mux",
                  _start_http=False)
    assert h.options(multiplexed_model_id="m1").remote(None) \
        .result(timeout_s=30) == "m1"
    assert h.options(multiplexed_model_id="m2").remote(None) \
        .result(timeout_s=30) == "m2"


def test_autoscaling_scales_up(serve_cluster):
    @serve.deployment(
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
            upscale_delay_s=0.3, downscale_delay_s=60.0),
        max_ongoing_requests=16)
    class Slow:
        async def __call__(self, _):
            await asyncio.sleep(0.4)
            return "done"

    h = serve.run(Slow.bind(), name="auto", route_prefix="/auto",
                  _start_http=False)
    # flood with concurrent requests to drive ongoing > target
    resps = [h.remote(None) for _ in range(24)]
    deadline = time.time() + 30
    scaled = False
    while time.time() < deadline:
        st = serve.status()["applications"]["auto"]["deployments"]["Slow"]
        if st["target"] >= 2:
            scaled = True
            break
        resps.extend(h.remote(None) for _ in range(8))
        time.sleep(0.3)
    assert scaled, "autoscaler never raised the target"
    for r in resps[:8]:
        assert r.result(timeout_s=60) == "done"


def test_http_proxy_end_to_end(serve_cluster):
    @serve.deployment
    class HttpApp:
        async def __call__(self, req: serve.Request):
            if req.method == "POST":
                body = req.json()
                return {"sum": body["a"] + body["b"]}
            return serve.Response("plain", status=201,
                                  content_type="text/plain")

    serve.run(HttpApp.bind(), name="web", route_prefix="/web",
              http_options=serve.HTTPOptions(port=0))
    base = f"http://127.0.0.1:{_proxy_port()}"
    r = urllib.request.urlopen(urllib.request.Request(
        base + "/web", data=json.dumps({"a": 2, "b": 3}).encode(),
        headers={"Content-Type": "application/json"}), timeout=15)
    assert r.status == 200 and json.loads(r.read()) == {"sum": 5}
    r = urllib.request.urlopen(base + "/web", timeout=15)
    assert r.status == 201 and r.read() == b"plain"
    r = urllib.request.urlopen(base + "/-/routes", timeout=15)
    assert "/web" in json.loads(r.read())
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/no-app-here", timeout=15)
    assert err.value.code == 404


def test_delete_application(serve_cluster):
    @serve.deployment
    class D:
        def __call__(self, _):
            return "x"

    serve.run(D.bind(), name="todelete", route_prefix="/del",
              _start_http=False)
    assert "todelete" in serve.status()["applications"]
    serve.delete("todelete")
    assert "todelete" not in serve.status()["applications"]


def test_proxy_speaks_http11_on_one_connection(serve_cluster):
    """The port's proxy (asyncio streams, not aiohttp): two requests on
    one kept-alive connection, Expect: 100-continue, a chunked request
    body, an SSE stream in chunked encoding, and the refusals of a
    malformed request line and an oversized body."""
    import socket

    @serve.deployment
    class Echo:
        async def __call__(self, req: serve.Request):
            if req.path == "/stream":
                return serve.StreamingHint("events", 3)
            return {"method": req.method, "body": req.text,
                    "q": req.query_params}

        def events(self, n):
            for i in range(n):
                yield f"data: {i}\n\n"

    serve.run(Echo.bind(), name="wire", route_prefix="/wire",
              http_options=serve.HTTPOptions(port=0))
    port = _proxy_port()

    def read_response(f):
        status = int(f.readline().split()[1])
        headers = {}
        for line in iter(f.readline, b"\r\n"):
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        if headers.get("transfer-encoding") == "chunked":
            body = b""
            while True:
                n = int(f.readline().strip(), 16)
                if n == 0:
                    f.readline()
                    return status, headers, body
                body += f.read(n)
                f.readline()
        return status, headers, f.read(int(headers["content-length"]))

    with socket.create_connection(("127.0.0.1", port), timeout=15) as s:
        f = s.makefile("rb")
        s.sendall(b"GET /wire/a?x=1&x=2 HTTP/1.1\r\nHost: t\r\n\r\n")
        status, headers, body = read_response(f)
        assert status == 200
        assert headers["content-type"] == "application/json; charset=utf-8"
        assert json.loads(body) == {"method": "GET", "body": "",
                                    "q": {"x": "1"}}
        s.sendall(b"POST /wire HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\n"
                  b"Expect: 100-continue\r\n\r\n")
        assert f.readline() == b"HTTP/1.1 100 Continue\r\n"
        assert f.readline() == b"\r\n"
        s.sendall(b"hello")
        assert json.loads(read_response(f)[2])["body"] == "hello"
        s.sendall(b"POST /wire HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: "
                  b"chunked\r\n\r\n3\r\nabc\r\n2\r\nde\r\n0\r\n\r\n")
        assert json.loads(read_response(f)[2])["body"] == "abcde"
        s.sendall(b"GET /wire/stream HTTP/1.1\r\nHost: t\r\n\r\n")
        status, headers, body = read_response(f)
        assert status == 200
        assert headers["content-type"] == "text/event-stream"
        assert body == b"data: 0\n\ndata: 1\n\ndata: 2\n\n"
    for raw, want in ((b"NONSENSE\r\n\r\n", 400),
                      (b"POST /wire HTTP/1.1\r\nContent-Length: "
                       b"999999999999\r\n\r\n", 413)):
        with socket.create_connection(("127.0.0.1", port), timeout=15) as s:
            s.sendall(raw)
            assert int(s.makefile("rb").readline().split()[1]) == want
