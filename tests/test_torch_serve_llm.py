"""The port's LLM serve applications against the JAX package's.

1. Parity on the whole slice. One seeded float32 tree at `debug` widths,
   made with numpy, is written once as an HF safetensors checkpoint by
   the port's writer. Both packages' `build_openai_app` and
   `build_llm_fleet_app` (one replica) serve it under
   `serve.run(..., local_testing_mode=True)`, each engine reading the
   architecture from the checkpoint's `config.json` at float32 (the
   file names no compute dtype, and bf16 rounds differently in XLA's
   CPU kernels and torch's): the JAX side on the gather engine with
   `async_readback=False` (ROADMAP §C's oracle), the port on the CPU
   with `async_readback=False`. The same completion, chat and stream
   bodies give the same responses, text and (through the fleet's SSE
   chunks) token ids. Tolerance: exact.
2. The OpenAI app over HTTP on the port's runtime with a CPU engine,
   mirroring test_llm.py's test_openai_app_http and
   test_openai_streaming_sse and test_llm_telemetry.py's
   test_observability_http_endpoints, with urllib for requests.
3. Reservations and refusals: replicas reserve tp x pp GPUs under
   `accelerator_type`; a CUDA engine with no GPU reserved, and
   `num_tpus`, are refused when the app is built.
4. The fleet ingress, mirroring test_serve_llm_fleet.py's
   test_fleet_app_local_testing_mode,
   test_ingress_relay_terminates_sse_on_exhausted_failover and
   test_e2e_anomaly_capture_fetchable_via_fleet, test_trafficlog.py's
   test_fleet_debug_traffic_endpoints and test_batch_lane.py's
   test_batch_routes_through_serve_app, on port CPU engines.
5. LLMRouterImpl units over stand-in server handles.
"""

import asyncio
import dataclasses
import http.client
import json
import re
import time
import types
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.llm import LLMConfig as JaxLLMConfig
from ray_tpu.llm import build_openai_app as jax_build_openai_app
from ray_tpu.models import checkpoint_io as jck
from ray_tpu.models import llama as jl
from ray_tpu.serve._private.proxy import Request as JaxRequest
from ray_tpu.serve.llm import FleetConfig as JaxFleetConfig
from ray_tpu.serve.llm import build_llm_fleet_app as jax_build_fleet_app
from ray_tpu_torch import LLMServerImpl, serve
from ray_tpu_torch.llm import (LLMConfig, build_llm_deployment,
                               build_openai_app)
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.llm._internal.server import (INTERNAL_BODY_KEYS,
                                                LLMRouterImpl)
from ray_tpu_torch.models import checkpoint_io as tck
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import Response, StreamingHint
from ray_tpu_torch.serve._private.proxy import Request
from ray_tpu_torch.serve.llm import (AdmissionConfig, AutoscaleConfig,
                                     BatchLaneConfig, ChaosReplicaClient,
                                     ChaosSchedule, FleetConfig,
                                     FleetManager, HealthConfig,
                                     LocalReplicaClient, RouterConfig,
                                     WatchdogConfig, build_llm_fleet_app,
                                     decode_capture)
from ray_tpu_torch.serve.llm.deployment import LLMFleetIngressImpl

torch.set_num_threads(1)

KW = dict(max_batch_size=4, page_size=8, num_pages=64, seed=3,
          max_seq_len=256, max_prefill_tokens=32, async_readback=False)
CPU = dict(device="cpu")
BODIES = [
    dict(prompt="The paged cache", max_tokens=12),
    dict(prompt="Hello, world!", max_tokens=5),
    dict(prompt="Continuous batching " * 6, max_tokens=9),
    dict(prompt="sampled", max_tokens=10, temperature=0.9, top_p=0.9,
         top_k=20, seed=1234),
]
CHATS = [
    dict(messages=[{"role": "user", "content": "hi there"}], max_tokens=7),
    dict(messages=[{"role": "system", "content": "Be brief."},
                   {"role": "user", "content": "why?"}], max_tokens=6,
         temperature=0.7, seed=9),
]


# ------------------------------------------------- 1. parity on the slice

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A float32 debug-width tree from numpy, written by the port."""
    tc = tl.config("debug", dtype=torch.float32)
    jc = jl.config("debug", dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jl.init_params(jc,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(17)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "ln" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.08 * rng.standard_normal(leaf.shape)).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    path = str(tmp_path_factory.mktemp("serve_llm") / "ckpt")
    tck.save_llama_checkpoint(tc, tree, path)
    tck.save_config(tc, path)
    return path


def _archs(path):
    """Both packages' architecture from config.json, at float32."""
    return (dataclasses.replace(jck.load_config(path), dtype=jnp.float32),
            dataclasses.replace(tck.load_config(path), dtype=torch.float32))


def _llm_configs(path, tag):
    jarch, tarch = _archs(path)
    jcfg = JaxLLMConfig(
        model_id="m", model_source=jarch, engine_kwargs=dict(
            KW, checkpoint=path, decode_impl="gather",
            prefill_buckets=(16, 32, 64), metrics_model_id=f"j{tag}"))
    tcfg = LLMConfig(
        model_id="m", model_source=tarch, engine_kwargs=dict(
            KW, checkpoint=path, metrics_model_id=f"t{tag}", **CPU))
    return jcfg, tcfg


def _strip(resp):
    """A response without its ids, timestamps and measured costs."""
    r = json.loads(json.dumps(resp))
    r.pop("id", None)
    r.pop("created", None)
    r.get("usage", {}).pop("cost", None)
    return r


def _sse(chunks):
    """SSE chunks as documents without ids and timestamps."""
    out = []
    for c in chunks:
        assert c.startswith("data: ") and c.endswith("\n\n"), c
        payload = c[len("data: "):].strip()
        out.append(payload if payload == "[DONE]" else _strip(
            json.loads(payload)))
    return out


def _drive_app(h, request_cls, hint_cls):
    """Every body through an ingress handle: unary completions and
    chats, then each as a stream (the StreamingHint's method)."""
    def post(path, body):
        return h.remote(request_cls("POST", path, {}, {}, json.dumps(
            body).encode())).result(timeout_s=180)

    unary = ([post("/v1/completions", b) for b in BODIES]
             + [post("/v1/chat/completions", b) for b in CHATS])
    streams = []
    for path, b in ([("/v1/completions", b) for b in BODIES]
                    + [("/v1/chat/completions", b) for b in CHATS]):
        hint = post(path, dict(b, stream=True))
        assert isinstance(hint, hint_cls)
        streams.append(_sse(h.options(method_name=hint.call_method,
                                      stream=True).remote(hint.payload)))
    return [_strip(u) for u in unary], streams


def test_openai_app_equal_jax_over_one_checkpoint(checkpoint):
    jcfg, tcfg = _llm_configs(checkpoint, uuid.uuid4().hex[:6])
    try:
        jh = jserve.run(jax_build_openai_app({"llm_configs": [jcfg]}),
                        name="jax-openai", local_testing_mode=True)
        th = serve.run(build_openai_app({"llm_configs": [tcfg]}),
                       name="port-openai", local_testing_mode=True)
        want = _drive_app(jh, JaxRequest, jserve.StreamingHint)
        got = _drive_app(th, Request, StreamingHint)
        models = th.remote(Request("GET", "/v1/models", {}, {}, b"")) \
            .result(timeout_s=60)
        assert models == jh.remote(JaxRequest(
            "GET", "/v1/models", {}, {}, b"")).result(timeout_s=60)
    finally:
        jserve.shutdown()
        serve.shutdown()
    assert got == want
    unary, streams = got
    assert all(u["usage"]["completion_tokens"] > 0 for u in unary)
    assert all(s[-1] == "[DONE]" for s in streams)
    # the stream's text is the unary response's, where a multi-byte
    # character still incomplete when its chunk went out is one U+FFFD
    first = "".join(d["choices"][0]["text"] for d in streams[0][:-1])
    final = unary[0]["choices"][0]["text"]
    assert len(first) == len(final) and all(
        a == b or a == "\ufffd" for a, b in zip(first, final))


def test_fleet_app_equal_jax_over_one_checkpoint(checkpoint):
    jcfg, tcfg = _llm_configs(checkpoint, uuid.uuid4().hex[:6])
    try:
        jh = jserve.run(jax_build_fleet_app(JaxFleetConfig(
            llm_config=jcfg, min_replicas=1, max_replicas=1)),
            name="jax-fleet", local_testing_mode=True)
        th = serve.run(build_llm_fleet_app(FleetConfig(
            llm_config=tcfg, min_replicas=1, max_replicas=1)),
            name="port-fleet", local_testing_mode=True)
        want = _drive_app(jh, JaxRequest, jserve.StreamingHint)
        got = _drive_app(th, Request, StreamingHint)
    finally:
        jserve.shutdown()
        serve.shutdown()
    assert got == want
    unary, streams = got
    for u, s in zip(unary, streams):
        ids = [t for d in s[:-1] for t in d["choices"][0]["token_ids"]]
        assert len(ids) == u["usage"]["completion_tokens"] > 0
        assert s[-1] == "[DONE]"


# ------------------------------------------- 2. the OpenAI app over HTTP

def _sample(text, name, **tags):
    """Value of one exposition sample (exact tag match) or None."""
    for line in text.splitlines():
        if not line.startswith(name + "{") and line.split(" ")[0] != name:
            continue
        m = re.match(r"^([a-zA-Z0-9_]+)(?:\{(.*)\})? (.+)$", line)
        if m is None or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2) or ""))
        if got == {k: str(v) for k, v in tags.items()}:
            return float(m.group(3))
    return None


def _http(port, method, path, body=None):
    """(status, content type, body) of one exchange with the proxy."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=(
            {"Content-Type": "application/json"} if data else {}))
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type") or "", r.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def openai_http():
    """The port's OpenAI app with a CPU debug engine behind the HTTP
    proxy on the port's runtime; yields the proxy's port."""
    ray_tpu_torch.init(num_cpus=8)
    try:
        app = build_openai_app({"llm_configs": [LLMConfig(
            model_id="m0", model_source="debug",
            engine_kwargs=dict(max_batch_size=4, page_size=8,
                               num_pages=128, **CPU))]})
        serve.run(app, name="llm", route_prefix="/",
                  http_options=serve.HTTPOptions(port=0), timeout_s=180)
        yield ray_tpu_torch.get(ray_tpu_torch.get_actor(
            "SERVE_PROXY").ready.remote(), timeout=30)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_openai_app_http(openai_http):
    port = openai_http
    status, _, body = _http(port, "GET", "/v1/models")
    assert status == 200
    assert json.loads(body)["data"][0]["id"] == "m0"
    status, _, body = _http(port, "POST", "/v1/chat/completions", {
        "model": "m0", "max_tokens": 6,
        "messages": [{"role": "user", "content": "hey"}]})
    assert status == 200
    doc = json.loads(body)
    assert doc["usage"]["completion_tokens"] <= 6
    assert doc["choices"][0]["message"]["role"] == "assistant"
    status, _, _ = _http(port, "POST", "/v1/chat/completions",
                         {"model": "nope", "messages": []})
    assert status == 404
    # /stats: tick-pipeline telemetry is observable in serving
    status, _, body = _http(port, "GET", "/stats")
    assert status == 200
    eng_stats = json.loads(body)["models"]["m0"]
    tt = eng_stats["tick_times"]
    assert {"wall_ms_avg", "host_ms_avg", "device_ms_avg",
            "overlap_ratio", "lagged_ticks", "drains"} <= set(tt)
    assert tt["async_readback"] is True
    assert eng_stats["dispatches"] >= 1


def test_openai_streaming_sse(openai_http):
    """stream=true returns Server-Sent Events with incremental deltas,
    relayed proxy -> router replica -> model server replica over the
    actor streaming plane, in chunked transfer encoding."""
    conn = http.client.HTTPConnection("127.0.0.1", openai_http,
                                      timeout=120)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "model": "m0", "max_tokens": 5, "stream": True,
            "messages": [{"role": "user", "content": "hey"}]}).encode(),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type").startswith("text/event-stream")
        assert r.getheader("Transfer-Encoding") == "chunked"
        events = [line[len(b"data: "):].strip()
                  for line in iter(r.readline, b"")
                  if line.startswith(b"data: ")]
    finally:
        conn.close()
    assert events[-1] == b"[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert 1 <= len(chunks) <= 6
    assert chunks[0]["object"] == "chat.completion.chunk"
    assert chunks[-1]["choices"][0]["finish_reason"] is not None


def test_observability_http_endpoints(openai_http):
    """The router's surface over real HTTP: /metrics renders Prometheus
    text populated by a streamed generation, /debug/trace is a Chrome
    trace, /debug/events dumps the flight recorder, POST /debug/profile
    arms a capture, and an unknown GET is a clean 404."""
    port = openai_http
    status, _, body = _http(port, "GET", "/not/a/route")
    assert status == 404
    assert b"invalid JSON body" not in body
    assert "no route" in json.loads(body)["error"]
    status, _, body = _http(port, "POST", "/v1/chat/completions", {
        "model": "m0", "max_tokens": 6, "stream": True,
        "messages": [{"role": "user", "content": "hey"}]})
    assert status == 200 and b"[DONE]" in body
    status, ctype, body = _http(port, "GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    text = body.decode()
    assert _sample(text, "ray_tpu_llm_ttft_seconds_count", model="m0") >= 1
    assert _sample(text, "ray_tpu_llm_itl_seconds_count", model="m0") >= 1
    assert _sample(text, "ray_tpu_llm_finished_total", model="m0",
                   reason="length") >= 1
    assert _sample(text, "ray_tpu_llm_kv_page_occupancy",
                   model="m0") is not None
    assert "# TYPE ray_tpu_llm_ttft_seconds histogram" in text
    samples = [l for l in text.splitlines() if l and not l.startswith("#")]
    assert len(samples) == len(set(samples))
    kinds = [l for l in text.splitlines() if l.startswith("# TYPE ")]
    assert len(kinds) == len(set(kinds))
    status, _, body = _http(port, "GET", "/debug/trace")
    doc = json.loads(body)
    assert {"queued", "prefill", "decode"} <= {e["name"]
                                              for e in doc["traceEvents"]}
    ring = doc["metadata"]["m0"]["tracing_ring"]
    assert ring["capacity"] > 0 and "dropped" in ring
    status, _, body = _http(port, "GET", "/debug/events")
    assert {"admission", "retirement"} <= {
        e["event"] for e in json.loads(body)["models"]["m0"]}
    status, _, body = _http(port, "POST", "/debug/profile", {"ticks": 2})
    assert status == 200
    m0 = json.loads(body)["models"]["m0"]
    assert m0.get("error") or (m0["ticks"] == 2 and m0["log_dir"])
    status, _, body = _http(port, "GET", "/stats")
    summary = json.loads(body)["models"]["m0"]["requests"]
    assert summary["finished"].get("length", 0) >= 1


# ------------------------------------- 3. reservations and refusals

def test_deployment_gpus_follow_engine_mesh():
    """accelerator_type replicas reserve tp*pp GPUs (the JAX package's
    test_deployment_chips_follow_engine_mesh, on num_gpus)."""
    app = build_llm_deployment(LLMConfig(
        model_id="m", accelerator_type="GPU-H100",
        engine_kwargs={"mesh": {"tp": 2, "pp": 2, "fsdp": 1}}))
    assert app._deployment.config.ray_actor_options == {"num_gpus": 4}
    app1 = build_llm_deployment(LLMConfig(
        model_id="m2", accelerator_type="GPU-H100"))
    assert app1._deployment.config.ray_actor_options["num_gpus"] == 1
    app2 = build_llm_deployment(LLMConfig(
        model_id="m3", accelerator_type="GPU-H100",
        engine_kwargs={"mesh_shape": (1, 2)}))
    assert app2._deployment.config.ray_actor_options["num_gpus"] == 2
    with pytest.raises(ValueError, match="wildcard"):
        build_llm_deployment(LLMConfig(
            model_id="m4", accelerator_type="GPU-H100",
            engine_kwargs={"mesh": {"tp": -1}}))
    # the fleet's replicas reserve theirs the same way
    fleet = build_llm_fleet_app(FleetConfig(llm_config=LLMConfig(
        model_id="mf", accelerator_type="GPU-H100"), max_replicas=2))
    assert [a._deployment.config.ray_actor_options["num_gpus"]
            for a in fleet._args[1:]] == [1, 1]


def test_cuda_engine_without_a_gpu_is_refused_at_build():
    for ekw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
        cfg = LLMConfig(model_id="m", engine_kwargs=ekw)
        for build in (build_llm_deployment,
                      lambda c: build_openai_app({"llm_configs": [c]}),
                      lambda c: build_llm_fleet_app(FleetConfig(
                          llm_config=c))):
            with pytest.raises(ValueError, match="reserves no GPU") as err:
                build(cfg)
            msg = str(err.value)
            assert "accelerator_type" in msg and "num_gpus" in msg \
                and "'device': 'cpu'" in msg
    # any of the three fixes builds
    build_llm_deployment(LLMConfig(model_id="m", engine_kwargs=CPU))
    build_llm_deployment(LLMConfig(model_id="m", accelerator_type="GPU-H100"))
    app = build_llm_deployment(LLMConfig(model_id="m", deployment_config={
        "ray_actor_options": {"num_gpus": 1}}))
    assert app._deployment.config.ray_actor_options == {"num_gpus": 1}


def test_num_tpus_refused():
    with pytest.raises(ValueError, match="num_gpus"):
        serve.deployment(ray_actor_options={"num_tpus": 1})(LLMServerImpl)
    dep = serve.deployment(LLMServerImpl)
    with pytest.raises(ValueError, match="num_gpus"):
        dep.options(ray_actor_options={"num_tpus": 1})
    with pytest.raises(ValueError, match="num_gpus"):
        build_llm_deployment(LLMConfig(model_id="m", engine_kwargs=CPU,
                                       deployment_config={
                                           "ray_actor_options": {
                                               "num_tpus": 1}}))
    app = build_llm_deployment(LLMConfig(model_id="m",
                                         accelerator_type="GPU-H100"))
    assert "num_tpus" not in app._deployment.config.ray_actor_options


# ---------------------------------------------------- 4. the fleet ingress

FLEET_KW = dict(max_batch_size=4, page_size=8, num_pages=96, seed=7,
                max_prefill_tokens=32, **CPU)
SECRET = "zanzibar marmalade heliotrope"   # the privacy tripwire
_state = {}


@pytest.fixture(scope="module")
def fleet_servers():
    """Two port replicas (debug model, CPU) shared by the ingress
    cases."""
    if "servers" not in _state:
        tag = f"tsl{uuid.uuid4().hex[:8]}"
        _state["servers"] = {rid: LLMServerImpl({
            "model_id": "m", "model_source": "debug",
            "engine_kwargs": dict(FLEET_KW, metrics_model_id=tag,
                                  metrics_replica_id=rid)})
            for rid in ("r0", "r1")}
    return _state["servers"]


def _cancel_pumps(servers):
    for srv in servers.values():
        if srv._pump is not None:
            srv._pump.cancel()


def _ingress_over(fleet, model_id="m"):
    ingress = LLMFleetIngressImpl.__new__(LLMFleetIngressImpl)
    ingress.model_id = model_id
    ingress.fleet = fleet
    return ingress


def test_fleet_app_local_testing_mode():
    """FleetConfig -> build_llm_fleet_app -> serve.run(local_testing_mode)
    -> ingress __call__ serves completions, /fleet and /metrics through
    deployment handles."""
    tag = f"fleetapp{uuid.uuid4().hex[:8]}"
    app = build_llm_fleet_app(FleetConfig(
        llm_config=LLMConfig(
            model_id="mf", model_source="debug",
            engine_kwargs=dict(FLEET_KW, metrics_model_id=tag)),
        min_replicas=2, max_replicas=2,
        admission=AdmissionConfig(max_concurrent=4, max_queue=8)))
    try:
        h = serve.run(app, name="fleet-local", local_testing_mode=True)

        def req(method, path, body=b""):
            return Request(method, path, {}, {}, body)

        out = h.remote(req(
            "POST", "/v1/completions",
            json.dumps({"prompt": "hello fleet",
                        "max_tokens": 3}).encode())).result(timeout_s=180)
        assert out["object"] == "text_completion"
        assert out["choices"][0]["finish_reason"] is not None
        models = h.remote(req("GET", "/v1/models")).result(timeout_s=30)
        assert models["data"][0]["id"] == "mf"
        fl = h.remote(req("GET", "/fleet")).result(timeout_s=30)
        assert set(fl["replicas"]) == {"r0", "r1"}
        assert fl["admission"]["admitted"] >= 1
        assert fl["autoscale"]["active"] == 2
        m = h.remote(req("GET", "/metrics")).result(timeout_s=30)
        assert m.status == 200
        assert f'model="{tag}"' in m.body
        tr = h.remote(req("GET", "/fleet/debug/trace")).result(timeout_s=60)
        names = {e["name"] for e in tr["traceEvents"]}
        assert {"fleet_request", "routing_decision"} <= names
        assert tr["metadata"]["ingress"]["buffer"]["events"] > 0
        rid_q = next(e["args"]["request_id"] for e in tr["traceEvents"]
                     if e["name"] == "fleet_request")
        filt = h.remote(Request("GET", "/fleet/debug/trace",
                                {"request_id": rid_q}, {}, b"")).result(
                                    timeout_s=60)
        assert filt["traceEvents"] and all(
            e["args"]["request_id"] == rid_q
            for e in filt["traceEvents"] if e.get("ph") != "M")
        ev = h.remote(req("GET", "/fleet/debug/events")).result(
            timeout_s=60)
        assert ev["object"] == "events"
        assert any(e["replica"] == "r0" for e in ev["events"])
        dmp = h.remote(req("POST", "/debug/dump", json.dumps(
            {"cause": "apptest"}).encode())).result(timeout_s=60)
        assert set(dmp["replicas"]) == {"r0", "r1"}
        assert all(v.get("bundle") for v in dmp["replicas"].values())
        bl = h.remote(req("GET", "/fleet/debug/bundles")).result(
            timeout_s=60)
        assert set(bl["replicas"]) == {"r0", "r1"}
        assert bl["replicas"]["r0"][-1]["cause"] == "apptest"
        one = h.remote(Request(
            "GET", "/fleet/debug/bundles",
            {"replica": "r0", "id": bl["replicas"]["r0"][-1]["id"]},
            {}, b"")).result(timeout_s=60)
        assert one["cause"] == "apptest"
        missing = h.remote(req("GET", "/no/such")).result(timeout_s=30)
        assert missing.status == 404
        bad = h.remote(req("POST", "/v1/completions", json.dumps(
            {"model": "nope", "prompt": "x"}).encode())).result(
                timeout_s=30)
        assert bad.status == 404
    finally:
        serve.shutdown()


def test_ingress_relay_terminates_sse_on_exhausted_failover(fleet_servers):
    """When the failover budget runs out (every replica severs every
    stream), the ingress still ENDS the SSE stream: an error event then
    [DONE], never a silent truncation."""
    schedules = {rid: ChaosSchedule() for rid in fleet_servers}
    for s in schedules.values():
        s.sever_stream(after_chunks=1, count=-1)
    fleet = FleetManager(
        [ChaosReplicaClient(LocalReplicaClient(rid, srv), schedules[rid])
         for rid, srv in fleet_servers.items()],
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=2),
        health=HealthConfig(max_failovers=1, open_cooldown_s=30.0),
        model_id="m")
    ingress = _ingress_over(fleet)

    async def main():
        chunks = []
        async for c in ingress._relay(
                "completions_stream",
                {"prompt": "doomed stream", "max_tokens": 6}):
            chunks.append(c)
        await fleet.stop()
        _cancel_pumps(fleet_servers)
        return chunks

    chunks = asyncio.run(asyncio.wait_for(main(), 120))
    assert chunks[-1] == "data: [DONE]\n\n"
    docs = [json.loads(c[6:]) for c in chunks
            if c.strip() != "data: [DONE]"]
    assert any(d.get("error", {}).get("type") == "upstream_failure"
               for d in docs), chunks
    # tokens that made it out before the failure still framed cleanly
    assert any("choices" in d for d in docs)


def test_e2e_anomaly_capture_fetchable_via_fleet(monkeypatch):
    """A stalled cold tick on one replica produces a classified
    tick_anomaly event, an auto-armed capture and a black-box bundle
    fetchable at GET /fleet/debug/bundles; the anomaly rate rides the
    replica's snapshot into the /fleet row, and /fleet/debug/attribution
    merges both replicas' receipts. The stall is a jump of the engine
    module's clock, as in test_torch_attribution.py: on a loaded machine
    a real sleep does not clear the robust z-score reliably."""
    tag = f"anomfleet{uuid.uuid4().hex[:8]}"
    servers = {rid: LLMServerImpl({
        "model_id": "m", "model_source": "debug",
        "engine_kwargs": dict(
            max_batch_size=4, page_size=8, num_pages=128, seed=7,
            max_prefill_tokens=16, metrics_model_id=tag,
            metrics_replica_id=rid, anomaly={
                "warmup_ticks": 16, "z_threshold": 6.0, "min_wall_ms": 0.0,
                "profile_min_interval_s": 0.0,
                "dump_min_interval_s": 0.0}, **CPU)})
        for rid in ("r0", "r1")}
    fleet = FleetManager(
        [LocalReplicaClient(rid, srv) for rid, srv in servers.items()],
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=2),
        model_id="m")
    ingress = _ingress_over(fleet)
    eng = servers["r0"].engine
    rng = np.random.default_rng(5)
    for i in range(3):
        eng.add_request(te.Request(
            f"w{i}", rng.integers(2, 250, 12).tolist(),
            te.SamplingParams(max_tokens=200), tenant="tenant-a"))
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    for _ in range(40):
        eng.step()
    assert eng.anomaly.stats()["warmed"]
    base = eng.anomaly.anomalies_total
    eng.add_request(te.Request(
        "stall", rng.integers(2, 250, 60).tolist(),
        te.SamplingParams(max_tokens=4)))
    comp0 = eng.compiles
    ragged = eng._ragged_step
    offset = [0.0]
    clock = types.SimpleNamespace(**{n: getattr(time, n) for n in dir(time)
                                     if not n.startswith("_")})
    clock.perf_counter = lambda: time.perf_counter() + offset[0]
    monkeypatch.setattr(te, "time", clock)

    def cold_first_tick(touched):
        if eng.compiles == comp0:
            offset[0] += 600.0         # the build's stall, on the clock
        ragged(touched)
    monkeypatch.setattr(eng, "_ragged_step", cold_first_tick)
    for _ in range(30):
        eng.step()
        if eng.anomaly.anomalies_total > base:
            break
    assert eng.anomaly.anomalies_total >= 1
    assert eng.anomaly.stats()["by_kind"].get("recompile", 0) >= 1
    armed = [e for e in eng.telemetry.recorder.events()
             if e["event"] == "profile_armed"
             and e.get("trigger") == "tick_anomaly"]
    assert armed, "profile capture was not auto-armed"
    monkeypatch.undo()
    eng1 = servers["r1"].engine
    eng1.add_request(te.Request("other", rng.integers(2, 250, 12).tolist(),
                                te.SamplingParams(max_tokens=4)))
    while eng1.has_work():
        eng1.step()

    async def main():
        await fleet.refresh()
        status = await fleet.status()
        bundles = await ingress._handle_get("/fleet/debug/bundles", {})
        bid = next(b["id"] for b in bundles["replicas"]["r0"]
                   if b["cause"] == "tick_anomaly")
        bundle = await ingress._handle_get(
            "/fleet/debug/bundles", {"replica": "r0", "id": bid})
        events = await ingress._handle_get("/fleet/debug/events", {})
        attribution = await ingress._handle_get(
            "/fleet/debug/attribution", {})
        return status, bundle, events, attribution

    status, bundle, events, attribution = asyncio.run(
        asyncio.wait_for(main(), 120))
    row = status["replicas"]["r0"]
    assert row["anomalies_total"] >= 1
    assert row["anomaly_rate"] > 0
    assert row["anomaly_last_kind"] == "recompile"
    assert status["replicas"]["r1"].get("anomalies_total", 0) == 0
    assert "anomaly_state" in status["watchdog"]
    assert bundle["anomaly_event"]["kind"] == "recompile"
    assert bundle["anomaly_event"]["compile_delta"] >= 1
    assert bundle["anomaly"]["anomalies_total"] >= 1
    assert bundle["attribution"] is not None
    kinds = [e["event"] for e in events["events"]]
    assert "tick_anomaly" in kinds
    ev = next(e for e in events["events"] if e["event"] == "tick_anomaly")
    assert ev["anomaly_kind"] == "recompile"
    assert ev["composition"]["dispatches"] >= 1
    assert set(attribution["replicas"]) == {"r0", "r1"}
    assert attribution["top"], "no receipts in the merged doc"
    assert {r["replica"] for r in attribution["top"]} <= {"r0", "r1"}
    assert any(r["tenant"] == "tenant-a" for r in attribution["top"])
    assert attribution["tenants"]["default"]["requests"] >= 1
    _cancel_pumps(servers)


def test_fleet_debug_traffic_endpoints(fleet_servers):
    """GET/POST /fleet/debug/traffic: capture controls through the
    ingress, the ring tail with ?since=, the sealed capture download,
    and the typed errors' statuses (409 misuse, 400 unknown action, 404
    no capture)."""
    fleet = FleetManager(
        [LocalReplicaClient(rid, srv) for rid, srv in fleet_servers.items()],
        router=RouterConfig(prefix_depth=64),
        admission=AdmissionConfig(max_concurrent=16, max_queue=64),
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=2),
        watchdog=WatchdogConfig(enabled=False), model_id="traffic")
    ingress = _ingress_over(fleet, "traffic")

    def post(action, **extra):
        return ingress(Request("POST", "/fleet/debug/traffic", {}, {},
                               json.dumps({"action": action,
                                           **extra}).encode()))

    async def main():
        resp = await ingress._handle_get("/fleet/debug/traffic",
                                         {"capture": "1"})
        assert resp.status == 404
        resp = await post("stop")
        assert resp.status == 409
        resp = await post("rewind")
        assert resp.status == 400
        started = await post("start", note="endpoint")
        assert started["object"] == "traffic_control"
        assert started["active"] is True
        resp = await post("start")
        assert resp.status == 409
        await fleet.dispatch("completions", {
            "prompt": f"endpoint {SECRET}", "max_tokens": 4, "seed": 3})
        marked = await post("mark", label="mid")
        assert marked["marks"] == 1
        doc = await ingress._handle_get("/fleet/debug/traffic", {})
        assert doc["object"] == "traffic" and doc["enabled"]
        assert doc["stats"]["capture"]["records"] == 1
        assert doc["records"][-1]["outcome"]["status"] == "ok"
        high = doc["records"][-1]["seq"]
        newer = await ingress._handle_get("/fleet/debug/traffic",
                                          {"since": str(high)})
        assert newer["records"] == []
        stopped = await post("stop")
        assert stopped["records"] == 1 and stopped["marks"] == 1
        resp = await ingress._handle_get("/fleet/debug/traffic",
                                         {"capture": "1"})
        assert resp.status == 200
        await fleet.stop()
        return resp.body

    text = asyncio.run(asyncio.wait_for(main(), 120))
    _cancel_pumps(fleet_servers)
    assert SECRET not in text
    cap = decode_capture(text)
    assert len(cap["records"]) == 1
    assert [m["label"] for m in cap["marks"]] == ["mid"]


def test_batch_routes_through_serve_app():
    """FleetConfig(batch_lane=...) -> build_llm_fleet_app -> POST
    /v1/batch submits, GET /v1/batch and /v1/batch/{id} report, and the
    job completes through the lane."""
    tag = f"batchapp{uuid.uuid4().hex[:8]}"
    app = build_llm_fleet_app(FleetConfig(
        llm_config=LLMConfig(
            model_id="mb", model_source="debug",
            engine_kwargs=dict(FLEET_KW, metrics_model_id=tag)),
        min_replicas=1, max_replicas=1,
        admission=AdmissionConfig(max_concurrent=4, max_queue=8),
        batch_lane=BatchLaneConfig(max_inflight=2)))
    try:
        h = serve.run(app, name="batch-local", local_testing_mode=True)

        def req(method, path, body=b""):
            return Request(method, path, {}, {}, body)

        brief = h.remote(req("POST", "/v1/batch", json.dumps({
            "requests": [{"prompt": f"bulk {i}", "max_tokens": 4}
                         for i in range(3)]}).encode())).result(
                                 timeout_s=180)
        assert brief["object"] == "batch" and brief["total"] == 3
        jid = brief["id"]
        deadline = time.monotonic() + 120
        doc = None
        while time.monotonic() < deadline:
            doc = h.remote(req("GET", f"/v1/batch/{jid}")).result(
                timeout_s=60)
            if doc["status"] in ("done", "failed"):
                break
            time.sleep(0.05)
        assert doc is not None and doc["status"] == "done", doc
        assert doc["completed"] == 3
        assert all(r["usage"]["completion_tokens"] == 4
                   for r in doc["results"])
        lst = h.remote(req("GET", "/v1/batch")).result(timeout_s=60)
        assert [j["id"] for j in lst["data"]] == [jid]
        assert lst["lane"]["recovered_tokens"] == 12
        missing = h.remote(req("GET", "/v1/batch/nope")).result(
            timeout_s=60)
        assert getattr(missing, "status", 200) == 404
    finally:
        serve.shutdown()


# ----------------------------------------------- 5. LLMRouterImpl units

class _Method:
    def __init__(self, server, name):
        self.server, self.name = server, name

    def remote(self, *args):
        self.server.calls.append((self.name, args))
        return self.server.answer(self.name, *args)

    def options(self, **_):
        return self


class _Server:
    """A stand-in for an LLMServer deployment handle."""

    def __init__(self, model_id, adapters=()):
        self.model_id, self.adapters, self.calls = model_id, adapters, []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _Method(self, name)

    async def answer(self, name, *args):
        if name == "model_info":
            return {"id": self.model_id, "adapters": list(self.adapters),
                    "engine": {"served_by": self.model_id}}
        if name == "metrics_text":
            return f"# TYPE x counter\nx{{model=\"{self.model_id}\"}} 1\n"
        return {"served_by": self.model_id, "method": name,
                "body": args[0] if args else None}


def _call(router, method, path, body=None, raw=None, query=None):
    data = raw if raw is not None else (
        b"" if body is None else json.dumps(body).encode())
    return asyncio.run(router(Request(method, path, query or {}, {}, data)))


def test_router_serves_gets_before_parsing_a_body():
    a, b = _Server("base", adapters=("styleA",)), _Server("other")
    router = LLMRouterImpl(a, b)
    models = _call(router, "GET", "/v1/models", raw=b"{not json")
    assert [m["id"] for m in models["data"]] == ["base", "styleA", "other"]
    stats = _call(router, "GET", "/stats/", raw=b"{not json")
    assert stats == {"object": "stats", "models": {
        "base": {"served_by": "base"}, "other": {"served_by": "other"}}}
    metrics = _call(router, "GET", "/metrics")
    assert isinstance(metrics, Response) and metrics.status == 200
    assert metrics.body.count("# TYPE x counter") == 1
    missing = _call(router, "GET", "/no/such/route")
    assert isinstance(missing, Response) and missing.status == 404
    assert missing.body == {"error": "no route /no/such/route"}
    bad = _call(router, "POST", "/v1/completions", raw=b"{not json")
    assert bad.status == 400 and bad.body == {"error": "invalid JSON body"}


def test_router_strips_internal_keys_and_routes_adapters():
    a, b = _Server("base", adapters=("styleA",)), _Server("other")
    router = LLMRouterImpl(a, b)
    body = {"model": "styleA", "prompt": "hi",
            **{k: "forged" for k in INTERNAL_BODY_KEYS}}
    out = _call(router, "POST", "/v1/completions", body)
    assert out["served_by"] == "base" and out["method"] == "completions"
    assert out["body"] == {"model": "styleA", "prompt": "hi"}
    out = _call(router, "POST", "/v1/chat/completions",
                {"model": "other", "messages": []})
    assert out["served_by"] == "other" and out["method"] == "chat"
    # no model: the first server
    assert _call(router, "POST", "/v1/completions",
                 {"prompt": "x"})["served_by"] == "base"
    hint = _call(router, "POST", "/v1/chat/completions",
                 {"model": "other", "stream": True, "messages": []})
    assert isinstance(hint, StreamingHint)
    assert hint.call_method == "stream_chat"
    hint = _call(router, "POST", "/v1/completions",
                 {"prompt": "x", "stream": True, "_trace": "forged"})
    assert hint.call_method == "stream_completions"
    assert "_trace" not in hint.payload
    unknown = _call(router, "POST", "/v1/completions",
                    {"model": "nope", "prompt": "x"})
    assert unknown.status == 404
    assert unknown.body == {"error": "model 'nope' not found"}
    # an unknown model makes the router resolve again once (an adapter
    # registered live) before its 404
    assert sum(1 for n, _ in a.calls if n == "model_info") == 2
    wrong = _call(router, "POST", "/v1/embeddings", {"prompt": "x"})
    assert wrong.status == 404
