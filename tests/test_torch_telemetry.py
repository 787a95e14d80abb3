"""ray_tpu_torch's request telemetry, mirrored on tests/test_llm_telemetry.py.

Each engine test of the JAX package's telemetry suite, on the port's
engine (float32 debug model, CPU): the exposition after generation, the
KV occupancy and prefix hit-rate gauges, the Chrome trace, the flight
recorder, abort paths, the stats summary, telemetry off being inert and
on/off token-exact, profile_next_ticks (torch.profiler on the CPU) and
its disarming on a mid-tick exception. Then parity: one workload through
both engines gives the same metric families and label sets and equal
count-valued samples (requests, tokens, prefix hits, preemptions,
restores, drains, the cost model's FLOP and byte counters). The JAX
engine is the gather engine, with the port's weights taken from it.

Every engine gets a unique Prometheus model tag, so samples of other
tests sharing a registry never leak in.
"""

import json
import os
import re
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu.models import llama as jl
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.llm._internal.telemetry import FlightRecorder
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import tracing

torch.set_num_threads(1)


def make_engine(params=None, **over):
    kw = dict(model=tl.config("debug", dtype=torch.float32),
              max_batch_size=4, page_size=8, num_pages=64, device="cpu",
              metrics_model_id=f"t{uuid.uuid4().hex[:10]}")
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw), params=params)


def _sample(text: str, name: str, **tags):
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


# ----------------------------------------------------------- exposition

def test_metrics_exposition_exact_after_generation():
    eng = make_engine()
    tag = eng.config.metrics_model_id
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 200, n).tolist() for n in (5, 9, 14)]
    reqs = eng.generate([list(p) for p in prompts],
                        te.SamplingParams(max_tokens=6))
    stop = reqs[0].output_tokens[2]
    r = eng.generate([list(prompts[0])],
                     te.SamplingParams(max_tokens=30,
                                       stop_token_ids=(stop,)))[0]
    assert r.finish_reason == "stop"
    gen = sum(len(q.output_tokens) for q in reqs) + len(r.output_tokens)
    text = eng.prometheus_metrics()
    assert _sample(text, "ray_tpu_llm_ttft_seconds_count", model=tag) == 4
    assert _sample(text, "ray_tpu_llm_itl_seconds_count",
                   model=tag) == gen - 4
    assert _sample(text, "ray_tpu_llm_queue_wait_seconds_count",
                   model=tag) == 4
    assert _sample(text, "ray_tpu_llm_e2e_latency_seconds_count",
                   model=tag) == 4
    assert _sample(text, "ray_tpu_llm_finished_total",
                   model=tag, reason="length") == 3.0
    assert _sample(text, "ray_tpu_llm_finished_total",
                   model=tag, reason="stop") == 1.0
    assert _sample(text, "ray_tpu_llm_generated_tokens_total",
                   model=tag) == gen
    assert _sample(text, "ray_tpu_llm_prompt_tokens_total",
                   model=tag) == sum(len(p) for p in prompts) \
        + len(prompts[0])
    assert _sample(text, "ray_tpu_llm_ttft_seconds_sum", model=tag) > 0
    inf = None
    for line in text.splitlines():
        if line.startswith("ray_tpu_llm_ttft_seconds_bucket") \
                and f'model="{tag}"' in line and 'le="+Inf"' in line:
            inf = float(line.rsplit(" ", 1)[1])
    assert inf == 4


def test_kv_occupancy_gauge_matches_allocator_mid_flight():
    eng = make_engine(max_batch_size=2)
    tag = eng.config.metrics_model_id
    rng = np.random.default_rng(1)
    for i in range(3):           # 2 admit, 1 waits (2 slots)
        eng.add_request(te.Request(f"r{i}",
                                   rng.integers(2, 200, 12).tolist(),
                                   te.SamplingParams(max_tokens=16)))
    for _ in range(4):
        eng.step()
    text = eng.prometheus_metrics()
    st = eng.allocator.stats()
    assert _sample(text, "ray_tpu_llm_kv_pages_free",
                   model=tag) == st["free_pages"]
    assert _sample(text, "ray_tpu_llm_kv_pages_used",
                   model=tag) == st["used_pages"]
    assert _sample(text, "ray_tpu_llm_kv_page_occupancy",
                   model=tag) == pytest.approx(st["occupancy"])
    assert st["used_pages"] > 0
    assert _sample(text, "ray_tpu_llm_running_requests", model=tag) == 2
    assert _sample(text, "ray_tpu_llm_waiting_requests", model=tag) == 1
    assert _sample(text, "ray_tpu_llm_kv_device_bytes_used",
                   model=tag) == st["used_pages"] * eng.kv_page_bytes
    while eng.has_work():
        eng.step()
    text = eng.prometheus_metrics()
    assert _sample(text, "ray_tpu_llm_kv_pages_used", model=tag) == 0


def test_prefix_cache_hit_rate_gauge():
    eng = make_engine(max_batch_size=2, num_pages=96)
    tag = eng.config.metrics_model_id
    shared = np.random.default_rng(2).integers(2, 200, 24).tolist()
    eng.generate([shared + [5]], te.SamplingParams(max_tokens=2))
    eng.generate([shared + [9]], te.SamplingParams(max_tokens=2))
    text = eng.prometheus_metrics()
    rate = _sample(text, "ray_tpu_llm_prefix_cache_hit_rate", model=tag)
    assert rate == pytest.approx(eng.allocator.cache_hit_rate)
    assert rate > 0


# ------------------------------------------------------------ chrome trace

def test_chrome_trace_well_formed_lifecycle():
    eng = make_engine(max_prefill_tokens=8)   # forces chunked prefill
    rng = np.random.default_rng(3)
    reqs = eng.generate([rng.integers(2, 200, 20).tolist()],
                        te.SamplingParams(max_tokens=4))
    doc = json.loads(json.dumps(eng.chrome_trace()))
    evs = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    for e in evs:
        assert {"ph", "name", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0
    by_name = {}
    rid = reqs[0].request_id
    for e in evs:
        if e.get("args", {}).get("request_id") == rid \
                or e["name"] == "prefill_chunk":
            by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) >= {"queued", "prefill", "first_token",
                            "decode", "finished:length", "prefill_chunk"}
    q, p = by_name["queued"][0], by_name["prefill"][0]
    d = by_name["decode"][0]
    assert q["ts"] <= p["ts"] <= d["ts"]
    assert p["args"]["prompt_tokens"] == 20
    assert d["args"]["generated_tokens"] == 4
    assert len(by_name["prefill_chunk"]) >= 2       # chunked at 8
    assert sum(e["args"]["tokens"]
               for e in by_name["prefill_chunk"]) == 20
    tids = {e["tid"] for es in by_name.values() for e in es}
    assert len(tids) == 1
    # the perf counter tracks ride the same document
    assert any(e["ph"] == "C" for e in evs)


def test_chrome_trace_merges_tracing_ring():
    eng = make_engine()
    tracing.clear()
    tracing.enable()
    try:
        with tracing.span("driver_side_work", "custom"):
            pass
    finally:
        tracing.disable()
    names = {e["name"] for e in eng.chrome_trace()["traceEvents"]}
    assert "driver_side_work" in names
    tracing.clear()


# --------------------------------------------------------- flight recorder

def test_flight_recorder_ring_and_structured_events():
    eng = make_engine(max_batch_size=2)
    rng = np.random.default_rng(4)
    eng.generate([rng.integers(2, 200, 8).tolist() for _ in range(2)],
                 te.SamplingParams(max_tokens=3))
    kinds = [e["event"] for e in eng.telemetry.recorder.events()]
    assert kinds.count("admission") == 2
    assert kinds.count("retirement") == 2
    assert "device_state_rebuild" in kinds
    evs = eng.telemetry.recorder.events()
    assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
    adm = next(e for e in evs if e["event"] == "admission")
    assert adm["prompt_tokens"] == 8 and "ts" in adm
    ret = next(e for e in evs if e["event"] == "retirement")
    assert ret["reason"] == "length" and ret["generated_tokens"] == 3
    # the closed receipt: the prompt, then two decode ticks (the first
    # token came with the prefill)
    assert (ret["cost"]["prefill_tokens"], ret["cost"]["decode_tokens"]) \
        == (8, 2)

    rec = FlightRecorder(capacity=4)
    for i in range(10):
        rec.record("x", i=i)
    evs = rec.events()
    assert len(evs) == 4 and evs[0]["i"] == 6
    assert rec.stats() == {"events": 4, "total": 10, "dropped": 6}
    assert [e["i"] for e in rec.events(since=8)] == [8, 9]


def test_abort_paths_record_and_count():
    eng = make_engine(max_batch_size=1, enable_prefix_caching=False)
    tag = eng.config.metrics_model_id
    rng = np.random.default_rng(5)
    r1 = te.Request("run1", rng.integers(2, 200, 6).tolist(),
                    te.SamplingParams(max_tokens=20))
    r2 = te.Request("wait1", rng.integers(2, 200, 6).tolist(),
                    te.SamplingParams(max_tokens=20))
    eng.add_request(r1)
    eng.add_request(r2)
    eng.step()
    assert eng.abort("wait1")
    assert eng.abort("run1")
    text = eng.prometheus_metrics()
    assert _sample(text, "ray_tpu_llm_aborts_total", model=tag) == 2.0
    assert _sample(text, "ray_tpu_llm_finished_total",
                   model=tag, reason="abort") == 2.0
    evs = eng.telemetry.recorder.events()
    wheres = {e["request_id"]: e["where"] for e in evs
              if e["event"] == "abort"}
    assert wheres == {"wait1": "waiting", "run1": "running"}
    assert eng.telemetry.summary()["aborted"] == 2


# ----------------------------------------------------------- stats merge

def test_stats_requests_summary_and_budget_utilization():
    eng = make_engine()
    rng = np.random.default_rng(6)
    eng.generate([rng.integers(2, 200, 10).tolist() for _ in range(2)],
                 te.SamplingParams(max_tokens=5))
    st = eng.stats()
    s = st["requests"]
    assert s["enabled"] is True
    assert s["finished"] == {"length": 2}
    assert s["generated_tokens"] == 10
    assert s["prompt_tokens"] == 20
    assert s["ttft_ms_avg"] > 0 and s["e2e_ms_avg"] >= s["ttft_ms_avg"]
    assert 0 < s["budget_utilization"] <= 1
    assert s["flight_recorder"]["events"] > 0
    assert s["live"] == 0
    assert st["perf"]["envelope"] == "cpu" and st["perf"]["window"] > 0
    assert st["attribution"]["requests_total"] == 2
    assert st["anomaly"]["ticks"] == st["perf"]["window"]
    assert st["blackbox"]["enabled"] and st["blackbox"]["bundles"] == 0


def test_telemetry_disabled_is_inert():
    eng = make_engine(enable_metrics=False)
    rng = np.random.default_rng(7)
    reqs = eng.generate([rng.integers(2, 200, 8).tolist()],
                        te.SamplingParams(max_tokens=4))
    assert len(reqs[0].output_tokens) == 4
    assert eng.stats()["requests"] == {"enabled": False}
    assert eng.telemetry.recorder.events() == []
    names = {e["name"] for e in eng.chrome_trace()["traceEvents"]}
    assert "queued" not in names


@pytest.mark.parametrize("async_readback", [True, False],
                         ids=["pipelined", "sync"])
def test_disabled_and_enabled_engines_token_exact(async_readback):
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, 200, n).tolist() for n in (6, 11)]
    off = dict(enable_metrics=False, enable_perf_accounting=False,
               enable_attribution=False, enable_anomaly_detection=False,
               enable_blackbox=False)

    def run(flags):
        eng = make_engine(enable_prefix_caching=False,
                          async_readback=async_readback, **flags)
        return [r.output_tokens for r in eng.generate(
            [list(p) for p in prompts], te.SamplingParams(max_tokens=8))]

    assert run({}) == run(off)


# ------------------------------------------------------------- profiling

def test_profile_next_ticks_writes_trace():
    from ray_tpu_torch.util import profiling
    eng = make_engine()
    rng = np.random.default_rng(9)
    d = eng.profile_next_ticks(2)
    with pytest.raises(RuntimeError, match="already"):
        eng.profile_next_ticks(1)
    eng.generate([rng.integers(2, 200, 8).tolist()],
                 te.SamplingParams(max_tokens=4))
    kinds = [e["event"] for e in eng.telemetry.recorder.events()]
    assert "profile_error" not in kinds
    assert "profile_armed" in kinds and "profile_done" in kinds
    files = profiling.trace_files(d)
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    with pytest.raises(ValueError):
        eng.profile_next_ticks(0)
    eng.profile_next_ticks(1, log_dir=d)
    eng.generate([rng.integers(2, 200, 8).tolist()],
                 te.SamplingParams(max_tokens=2))
    assert len(profiling.trace_files(d)) == 2


def test_profile_disarms_on_mid_tick_exception(monkeypatch):
    eng = make_engine()
    rng = np.random.default_rng(3)
    eng.profile_next_ticks(4)

    def boom(touched):
        raise RuntimeError("mid-tick failure")

    monkeypatch.setattr(eng, "_step_tick", boom)
    with pytest.raises(RuntimeError, match="mid-tick failure"):
        eng.step()
    monkeypatch.undo()
    assert eng._profile is None
    kinds = [e["event"] for e in eng.telemetry.recorder.events()]
    assert "profile_aborted" in kinds
    # the crash black-boxed the engine's last moments
    assert "blackbox_dump" in kinds
    assert eng.blackbox.list()[-1]["cause"] == "engine_crash"
    eng.profile_next_ticks(1)
    eng.generate([rng.integers(2, 200, 8).tolist()],
                 te.SamplingParams(max_tokens=2))


def test_capture_waits_while_another_profiler_session_runs():
    """A capture armed while a caller's torch.profiler session runs in
    another thread stays armed and starts no session of its own (a
    second session's stop would end the caller's); it runs once the
    caller's session is over. trace() itself refuses to start beside
    another session."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.util import profiling
    eng = make_engine()
    rng = np.random.default_rng(4)
    d = eng.profile_next_ticks(1)
    prompt = rng.integers(2, 200, 8).tolist()
    with profile(activities=[ProfilerActivity.CPU]) as caller:
        assert profiling.session_active()
        with pytest.raises(RuntimeError, match="already running"):
            with profiling.trace(d):
                pass
        t = threading.Thread(target=lambda: eng.generate(
            [list(prompt)], te.SamplingParams(max_tokens=3)))
        t.start()
        t.join()
        assert eng._profile is not None and profiling.trace_files(d) == []
        torch.ones(4).sum()
    # the caller's session stopped cleanly and kept its records
    assert any(e.key == "aten::sum" for e in caller.key_averages())
    assert not profiling.session_active()
    eng.generate([list(prompt)], te.SamplingParams(max_tokens=2))
    kinds = [e["event"] for e in eng.telemetry.recorder.events()]
    assert "profile_error" not in kinds and "profile_done" in kinds
    assert eng._profile is None and len(profiling.trace_files(d)) == 1


# ----------------------------------------------------------------- parity

_PARAMS = {}


def _jax_params():
    if not _PARAMS:
        e = je.InferenceEngine(je.EngineConfig(
            model=jl.config("debug", dtype=jnp.float32), max_batch_size=3,
            page_size=8, num_pages=64, seed=5, prefill_buckets=(16, 32, 64)))
        _PARAMS.update(jax.tree_util.tree_map(np.asarray, e.params))
    return _PARAMS


def _parity_workload(eng, mod):
    """Seeded requests through add_request/step: prefix sharing, a stop
    never hit, one abort while waiting, one manual preempt of a decoding
    request (a spill of 4 pages, restored when a slot frees)."""
    rng = np.random.default_rng(21)
    shared = rng.integers(2, 250, 16).tolist()
    prompts = [shared + [3 + i] for i in range(3)] + [
        rng.integers(2, 250, n).tolist() for n in (5, 7, 30)]
    reqs = [mod.Request(f"p{i}", list(p),
                        mod.SamplingParams(max_tokens=20 + 4 * (i % 2)))
            for i, p in enumerate(prompts)]
    for r in reqs[:4]:
        eng.add_request(r)
    eng.step()
    eng.add_request(reqs[4])
    eng.add_request(reqs[5])
    assert eng.abort("p5")
    steps = 1
    preempted = False
    while eng.has_work():
        eng.step()
        steps += 1
        if not preempted and steps >= 12:
            # the request whose cache spans 4 pages (a power of two:
            # the JAX engine moves page counts padded to one)
            victim = next((s.request.request_id for s in eng.slots
                           if s.request is not None and s.ready
                           and 25 <= s.position <= 31), None)
            if victim is not None:
                preempted = eng.preempt(victim)
    assert preempted
    return reqs


_COUNTS = ("_count", "_total")
# samples whose value is a time, a rate or a share: families and labels
# must agree, values not
_TIMED = ("_sum", "_bucket", "ray_tpu_llm_mfu", "ray_tpu_llm_mbu",
          "ray_tpu_llm_tokens_per_s", "ray_tpu_llm_tick_anomaly_rate")


def _by_series(text, tag):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or f'model="{tag}"' not in line:
            continue
        m = re.match(r"^([a-zA-Z0-9_:]+)\{(.*)\} (.+)$", line)
        labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', m.group(2))))
        labels = tuple((k, v) for k, v in labels if k != "model")
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def test_exposition_parity_with_jax():
    """One workload through the JAX gather engine and the port (both
    pipelined): the same families and label sets, and equal
    count-valued samples, the cost model's counters included."""
    jtag, ttag = f"pj{uuid.uuid4().hex[:8]}", f"pt{uuid.uuid4().hex[:8]}"
    common = dict(max_batch_size=3, page_size=8, num_pages=64, seed=5,
                  max_prefill_tokens=16, enable_kv_offload=True)
    jeng = je.InferenceEngine(je.EngineConfig(
        model=jl.config("debug", dtype=jnp.float32),
        prefill_buckets=(16, 32, 64), decode_impl="gather",
        metrics_model_id=jtag, **common))
    teng = make_engine(_jax_params(), metrics_model_id=ttag, **common)
    jr = _parity_workload(jeng, je)
    tr = _parity_workload(teng, te)
    assert [len(r.output_tokens) for r in jr] == \
        [len(r.output_tokens) for r in tr]
    js = _by_series(jeng.prometheus_metrics(), jtag)
    ts = _by_series(teng.prometheus_metrics(), ttag)
    assert set(ts) == set(js)
    counted = 0
    for key, v in js.items():
        name = key[0]
        if any(name.endswith(t) or name == t for t in _TIMED):
            continue
        assert ts[key] == v, (key, ts[key], v)
        counted += 1
    for name, labels in (
            ("ray_tpu_llm_preemptions_total", (("reason", "manual"),)),
            ("ray_tpu_llm_kv_spills_total", ()),
            ("ray_tpu_llm_kv_restores_total", ()),
            ("ray_tpu_llm_drains_total", ()),
            ("ray_tpu_llm_finished_total", (("reason", "abort"),)),
            ("ray_tpu_llm_hbm_bytes_total", (("kind", "d2h"),)),
            ("ray_tpu_llm_hbm_bytes_total", (("kind", "h2d"),))):
        assert ts[(name, labels)] >= 1, name
    assert counted > 20
    # the registries are separate modules: no port series in JAX's
    assert ttag not in jmetrics.export_prometheus()
    assert jtag not in tmetrics.export_prometheus()


def test_families_and_buckets_equal_jax():
    """The metric families themselves: names, types, label names and
    histogram boundaries are the JAX package's."""
    from ray_tpu.llm._internal import telemetry as jt
    from ray_tpu_torch.llm._internal import telemetry as tt
    assert tt.LATENCY_BOUNDARIES == jt.LATENCY_BOUNDARIES
    assert tt.DEFAULT_SLO_TARGETS == jt.DEFAULT_SLO_TARGETS
    jm, tm = jt._build_metrics(), tt._build_metrics()
    assert set(jm) == set(tm)
    for k in jm:
        a, b = jm[k], tm[k]
        assert (type(a).__name__, a._name, a._tag_keys) == \
            (type(b).__name__, b._name, b._tag_keys), k
        assert getattr(a, "boundaries", None) == \
            getattr(b, "boundaries", None)
    assert os.path.basename(tt.__file__) == "telemetry.py"


def test_no_instrumentation_inside_the_decode_graph_body():
    """The JAX suite's no-instrumentation-under-trace gate, for the
    port: the body a CUDA graph captures (_decode_body) runs its Python
    once, at the capture, so no telemetry, cost or attribution call may
    sit inside it; they run beside the dispatch in _decode."""
    import ast
    import inspect
    import textwrap
    src = textwrap.dedent(inspect.getsource(te.InferenceEngine._decode_body))
    names = {n.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Attribute)}
    assert not names & {"telemetry", "perf", "attrib", "anomaly",
                        "recorder", "blackbox"}
    decode = inspect.getsource(te.InferenceEngine._decode)
    assert "_account_decode_batch" in decode
