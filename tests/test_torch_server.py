"""ray_tpu_torch's LLMServerImpl against ray_tpu's.

Both servers serve the float32 debug model on the CPU: the JAX server's
engine is the gather engine with async_readback=False, and the port
server's engine is replaced (here, in the test only) by one built on the
JAX engine's weights with async_readback=False. The same bodies give the
same tokens and text through completions, chat and both stream forms;
stop, max_tokens, seed and deadline_s behave alike; a session exported
mid-stream by either server continues token-exact in the other; the
observability surfaces work; an unknown adapter name and an empty
adapter are refused with the JAX server's errors.
"""

import asyncio
import json
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal.server import LLMServerImpl as JaxServer
from ray_tpu.models import llama as jl
from ray_tpu_torch import LLMConfig, LLMServerImpl, load_tokenizer
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)

KW = dict(max_batch_size=4, page_size=8, num_pages=64, seed=3,
          max_seq_len=256, max_prefill_tokens=32, async_readback=False,
          enable_kv_offload=True)


def _servers(**over):
    """(JAX server, port server) over the same weights."""
    mid = f"m{uuid.uuid4().hex[:8]}"
    kw = dict(KW, **over)
    jsrv = JaxServer({"model_id": mid,
                      "model_source": jl.config("debug", dtype=jnp.float32),
                      "engine_kwargs": dict(kw, decode_impl="gather",
                                            prefill_buckets=(16, 32, 64))})
    params = jax.tree_util.tree_map(np.asarray, jsrv.engine.params)
    cfg = LLMConfig(model_id=mid,
                    model_source=tl.config("debug", dtype=torch.float32),
                    engine_kwargs=dict(kw, device="cpu"))
    tsrv = LLMServerImpl(cfg.to_dict())
    tsrv.engine = te.InferenceEngine(te.EngineConfig(
        model=tsrv.engine.config.model, device="cpu",
        metrics_model_id=mid, **kw), params=params)
    return jsrv, tsrv


@pytest.fixture(scope="module")
def servers():
    return _servers()


BODIES = [
    dict(prompt="The paged cache", max_tokens=12),
    dict(prompt="Hello, world!", max_tokens=5),
    dict(prompt="Continuous batching " * 6, max_tokens=9),
    dict(prompt="sampled", max_tokens=10, temperature=0.9, top_p=0.9,
         top_k=20, seed=1234),
    dict(prompt="penalized", max_tokens=8, repetition_penalty=1.3),
]
CHATS = [
    dict(messages=[{"role": "user", "content": "hi there"}], max_tokens=7),
    dict(messages=[{"role": "system", "content": "Be brief."},
                   {"role": "user", "content": "why?"}], max_tokens=6,
         temperature=0.7, seed=9),
]


async def _unary(srv):
    comp = await asyncio.gather(*[srv.completions(dict(b)) for b in BODIES])
    chat = await asyncio.gather(*[srv.chat(dict(b)) for b in CHATS])
    return comp, chat


async def _streams(srv):
    out = []
    for b in BODIES[:3]:
        out.append([c async for c in srv.completions_stream_tokens(dict(b))])
        out.append([c async for c in srv.completions_stream(dict(b))])
    for b in CHATS:
        out.append([c async for c in srv.chat_stream_tokens(dict(b))])
        out.append([c async for c in srv.chat_stream(dict(b))])
    return out


def _strip(resp):
    """A response without its ids, timestamps and measured costs."""
    r = json.loads(json.dumps(resp))
    r.pop("id", None)
    r.pop("created", None)
    cost = r.get("usage", {}).pop("cost", None)
    if cost is not None:
        r["cost_counts"] = {k: cost[k] for k in (
            "flops", "hbm_bytes", "kv_page_ticks", "decode_tokens",
            "prefill_tokens")}
    return r


def test_unary_completions_and_chat_equal_jax(servers):
    jsrv, tsrv = servers
    jc, jh = asyncio.run(_unary(jsrv))
    tc, th = asyncio.run(_unary(tsrv))
    assert [_strip(r) for r in tc] == [_strip(r) for r in jc]
    assert [_strip(r) for r in th] == [_strip(r) for r in jh]
    assert all(r["usage"]["completion_tokens"] > 0 for r in tc)
    assert tc[0]["usage"]["cost"]["flops"] > 0


def test_streams_equal_jax(servers):
    jsrv, tsrv = servers
    js = asyncio.run(_streams(jsrv))
    ts = asyncio.run(_streams(tsrv))
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        if isinstance(b[0], dict):          # token-structured chunks
            assert [(c["i"], c["toks"], c["text"], c["finished"],
                     c["reason"]) for c in a] == \
                [(c["i"], c["toks"], c["text"], c["finished"], c["reason"])
                 for c in b]
        else:                               # SSE text chunks
            strip = lambda s: {k: v for k, v in json.loads(
                s[6:]).items() if k not in ("id", "created")} \
                if s != "data: [DONE]\n\n" else s
            assert [strip(x) for x in a] == [strip(x) for x in b]


def test_stop_max_tokens_seed_and_deadline_as_jax():
    jsrv, tsrv = _servers()
    eos = tsrv.tokenizer.eos_id
    assert eos == jsrv.tokenizer.eos_id
    bodies = [dict(prompt="a", max_tokens=1), dict(prompt="b"),
              dict(prompt="seeded", max_tokens=10, temperature=1.0,
                   seed=77),
              dict(prompt="seeded", max_tokens=10, temperature=1.0,
                   seed=78),
              dict(prompt="late", max_tokens=30, deadline_s=0.0)]

    async def run(srv):
        return await asyncio.gather(*[srv.completions(dict(b))
                                      for b in bodies])
    jr, tr = asyncio.run(run(jsrv)), asyncio.run(run(tsrv))
    assert [_strip(r) for r in tr] == [_strip(r) for r in jr]
    assert tr[0]["usage"]["completion_tokens"] == 1
    # the default max_tokens, unless the eos token stopped it first
    assert tr[1]["usage"]["completion_tokens"] <= 32
    assert tr[1]["choices"][0]["finish_reason"] in ("length", "stop")
    assert tr[2]["choices"][0]["text"] != tr[3]["choices"][0]["text"]
    assert tr[4]["choices"][0]["finish_reason"] == "deadline"


def _exported(src, body):
    """Stream `body` on `src` and export its session after 3 tokens:
    (tokens received, the export response)."""
    async def main():
        got = []

        async def consume():
            async for c in src.completions_stream_tokens(dict(body)):
                got.extend(c["toks"])
        task = asyncio.create_task(consume())
        while len(got) < 3:
            await asyncio.sleep(0.001)
        exp = await src.export_session(
            {"request_id": body["_request_id"]})
        await task
        return got, exp
    return asyncio.run(main())


def _resumed(dst, exp, offset):
    async def main():
        return [c async for c in dst.resume_stream_tokens(
            {"_session": exp["session"], "_resume_offset": offset})]
    return asyncio.run(main())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sessions_cross_token_exact(direction):
    jsrv, tsrv = _servers()
    body = dict(prompt="move me " * 3, max_tokens=16, temperature=0.8,
                top_k=10, seed=5, _request_id=f"s-{direction}")

    async def unmoved():
        return [t async for c in jsrv.completions_stream_tokens(
            {k: v for k, v in body.items() if k != "_request_id"})
            for t in c["toks"]]
    whole = asyncio.run(unmoved())
    src, dst = (jsrv, tsrv) if direction == "jax_to_port" else (tsrv, jsrv)
    got, exp = _exported(src, body)
    assert exp["session"] is not None and exp["pages"] >= 1
    chunks = _resumed(dst, exp, len(got))
    toks = got + [t for c in chunks for t in c["toks"]]
    assert chunks[-1]["finished"] and chunks[-1]["reason"] == "length"
    assert toks == whole and len(toks) == 16


def test_observability_surfaces():
    """On a fresh server: a shared one may have run past the anomaly
    detector's warm-up, and a capture it armed would refuse
    start_profile."""
    tsrv = LLMServerImpl({"model_id": f"o{uuid.uuid4().hex[:8]}",
                          "model_source": tl.config("debug",
                                                    dtype=torch.float32),
                          "engine_kwargs": dict(KW, device="cpu")})

    async def main():
        await tsrv.completions(dict(prompt="observe", max_tokens=4))
        text = await tsrv.metrics_text()
        evs = await tsrv.debug_events()
        tail = await tsrv.debug_events(since=len(evs) - 2)
        attrib = await tsrv.debug_attribution(2)
        trace = await tsrv.debug_trace()
        dump = await tsrv.debug_dump({"cause": "test"})
        bundles = await tsrv.debug_bundles()
        bundle = await tsrv.debug_bundle(dump["bundle"])
        info = await tsrv.model_info()
        fleet = await tsrv.fleet_stats()
        health = await tsrv.health_detail()
        drain = await tsrv.drain(5.0)
        prof = await tsrv.start_profile({"ticks": 1})
        return (text, evs, tail, attrib, trace, dump, bundles, bundle, info,
                fleet, health, drain, prof)
    (text, evs, tail, attrib, trace, dump, bundles, bundle, info, fleet,
     health, drain, prof) = asyncio.run(main())
    mid = tsrv.model_id
    assert f'ray_tpu_llm_generated_tokens_total{{model="{mid}"}}' in text
    assert evs and [e["seq"] for e in tail["events"]] == \
        [e["seq"] for e in evs[-2:]]
    assert tail["high_water"] >= evs[-1]["seq"]
    assert attrib["enabled"] and len(attrib["top"]) <= 2
    assert any(e["name"] == "queued" for e in trace["traceEvents"])
    assert dump["bundle"] in {b["id"] for b in bundles}
    assert bundle["cause"] == "test" and bundle["flight_recorder"]
    assert info["adapters"] == [] and info["engine"]["perf"]["envelope"]
    assert fleet["model"] == mid and fleet["perf"]["envelope"] == "cpu"
    assert "slo_totals" in fleet and "slo_totals" not in health
    assert drain["drained"]
    assert prof["ticks"] == 1 and prof["log_dir"]
    # the armed profile runs with the next tick and writes its trace
    asyncio.run(tsrv.completions(dict(prompt="profiled", max_tokens=2)))
    from ray_tpu_torch.util import profiling
    assert len(profiling.trace_files(prof["log_dir"])) == 1


def test_parse_since_as_jax():
    from ray_tpu.llm._internal.server import parse_since as jparse
    from ray_tpu_torch.llm._internal.server import parse_since
    for raw in (None, "3", 7, "x", "", 2.0, [], "-1"):
        assert parse_since(raw) == jparse(raw)


def test_adapter_names_refused_as_jax(servers):
    jsrv, tsrv = servers
    body = dict(prompt="x", max_tokens=2, model="my-adapter")
    with pytest.raises(ValueError) as jerr:
        asyncio.run(jsrv.completions(dict(body)))
    with pytest.raises(ValueError) as terr:
        asyncio.run(tsrv.completions(dict(body)))
    assert str(terr.value) == str(jerr.value)
    # an adapter that maps no projection: the JAX engine's error, live
    # and from the config
    with pytest.raises(ValueError) as jerr:
        asyncio.run(jsrv.register_lora("my-adapter", {}))
    with pytest.raises(ValueError) as terr:
        asyncio.run(tsrv.register_lora("my-adapter", {}))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="adapters must map a subset"):
        LLMServerImpl({"model_id": "m", "lora_adapters": {"a1": {}},
                       "engine_kwargs": {"device": "cpu"}})
    # the model's own name is served
    out = asyncio.run(tsrv.completions(dict(body, model=tsrv.model_id)))
    assert out["usage"]["completion_tokens"] == 2


def test_server_runs_on_cuda_unless_asked(monkeypatch):
    """The engine under the server runs on CUDA by default: without a
    card it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMServerImpl({"model_id": "m", "engine_kwargs": {}})
    srv = LLMServerImpl({"model_id": "m",
                         "engine_kwargs": {"device": "cpu"}})
    assert srv.engine.device.type == "cpu"
    assert load_tokenizer(None, 300).vocab_size == 300
