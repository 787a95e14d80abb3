"""ray_tpu_torch's decode-tick mechanics against ray_tpu's engine.

The port's decode loop is device-resident (static buffers, on-device
feedback of tokens and positions), its readback is pipelined one tick
(`async_readback`, default on) and its sampler keys JAX's threefry noise
on (seed, absolute token index). So:

- greedy and sampled streams are token-exact between the port's two
  readback modes and against the JAX gather engine with
  async_readback=False (the reference's pipelined path gave run-to-run
  different greedy tokens in one process, so it is no oracle for
  tokens), on both port impls, and on int8 and fp8 pages for a sampled
  workload;
- a stop token mid-stream, max_tokens=1, an abort with a tick in flight
  and has_work() with work only in flight behave as in a synchronous
  engine, and every page comes back;
- the pipeline's lagged folds and drains count as the reference's own
  counters do on the same workload (a workload without stop tokens: its
  control flow does not depend on token values, so the reference's
  pipelined run is an oracle for the counts).

float32 debug model, CPU (the kernel impl runs the kernels' plain
versions through the kernel path's plumbing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.models import llama as tl

torch.set_num_threads(1)

ENGINE_KW = dict(max_batch_size=3, page_size=8, num_pages=64,
                 max_prefill_tokens=16, seed=9)
WORKLOADS = {
    "greedy": dict(max_tokens=12),
    "sampled": dict(max_tokens=12, temperature=0.8, top_p=0.9, top_k=20,
                    repetition_penalty=1.1),
}


def _jax_engine(**over):
    kw = dict(ENGINE_KW, model=jl.config("debug", dtype=jnp.float32),
              prefill_buckets=(16, 32, 64), decode_impl="gather",
              async_readback=False)
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw))


_PARAMS = {}


def _params():
    """The debug model's weights, once per process (from the JAX
    engine's seeded init)."""
    if not _PARAMS:
        _PARAMS.update(jax.tree_util.tree_map(np.asarray,
                                              _jax_engine().params))
    return _PARAMS


def _port_engine(impl="gather", **over):
    kw = dict(ENGINE_KW, model=tl.config("debug", dtype=torch.float32),
              device="cpu", decode_impl=impl)
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw), params=_params())


def _prompts():
    rng = np.random.default_rng(3)
    lens = (40, 23, 1, 33, 7, 19)
    return [rng.integers(2, 250, n).tolist() for n in lens]


def _drive(eng, mod, prompts, **sp):
    """Staggered mixed workload: more requests than slots, added while
    earlier ones decode."""
    reqs = [mod.Request(f"r{i}", list(p), mod.SamplingParams(**sp))
            for i, p in enumerate(prompts)]
    for r in reqs[:2]:
        eng.add_request(r)
    for r in reqs[2:]:
        eng.step()
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX gather engine's synchronous streams, once per workload."""
    out = {}
    for name, sp in WORKLOADS.items():
        out["f32", name] = _drive(_jax_engine(), je, _prompts(), **sp)
    for kind in ("int8", "fp8"):
        out[kind, "sampled"] = _drive(_jax_engine(kv_dtype=kind), je,
                                      _prompts(), **WORKLOADS["sampled"])
    return out


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("async_rb", [True, False],
                         ids=["pipelined", "sync"])
@pytest.mark.parametrize("workload", ["greedy", "sampled"])
def test_streams_token_exact_vs_jax_gather(jax_runs, workload, async_rb,
                                           impl):
    eng = _port_engine(impl, async_readback=async_rb)
    assert _drive(eng, te, _prompts(), **WORKLOADS[workload]) \
        == jax_runs["f32", workload]
    st = eng.stats()
    assert st["async_readback"] is async_rb
    assert st["ragged_ticks"] > 0 and st["decode_ticks"] > 0
    assert st["dispatches_per_step"] == 1.0
    assert (st["lagged_ticks"] > 0) is async_rb
    assert st["graph_captures"] == 0            # no graphs on the CPU
    assert st["kv"]["used_pages"] == 0          # every page came back
    assert st["tick_times"]["window"] == st["ticks"]


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("async_rb", [True, False],
                         ids=["pipelined", "sync"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quant_sampled_streams_token_exact_vs_jax_gather(jax_runs, kind,
                                                         async_rb, impl):
    eng = _port_engine(impl, async_readback=async_rb, kv_dtype=kind)
    assert _drive(eng, te, _prompts(), **WORKLOADS["sampled"]) \
        == jax_runs[kind, "sampled"]
    assert eng.stats()["kv"]["used_pages"] == 0


@pytest.mark.parametrize("workload", ["greedy", "sampled"])
def test_pipeline_counts_lagged_ticks_and_drains_as_the_reference(workload):
    """Same workload, same control flow: the port's pipeline folds late
    and drains exactly where the reference's does."""
    jeng = _jax_engine(async_readback=True)
    _drive(jeng, je, _prompts(), **WORKLOADS[workload])
    ref = jeng.stats()["tick_times"]
    eng = _port_engine()
    _drive(eng, te, _prompts(), **WORKLOADS[workload])
    st = eng.stats()
    assert ref["lagged_ticks"] > 0 and ref["drains"] > 0
    assert (st["lagged_ticks"], st["drains"]) == (ref["lagged_ticks"],
                                                  ref["drains"])
    assert st["ticks"] == jeng.ticks


def _sync_streams(prompts, **sp):
    eng = _port_engine(async_readback=False)
    return _drive(eng, te, prompts, **sp)


def test_stop_token_mid_stream_matches_sync():
    prompts = _prompts()
    full = _sync_streams(prompts, **WORKLOADS["sampled"])
    stop = full[0][4]
    sp = dict(WORKLOADS["sampled"], stop_token_ids=(stop,))
    eng = _port_engine()
    reqs = [te.Request(f"r{i}", list(p), te.SamplingParams(**sp))
            for i, p in enumerate(prompts)]
    for r in reqs[:2]:
        eng.add_request(r)
    for r in reqs[2:]:
        eng.step()
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    assert [r.output_tokens for r in reqs] == _sync_streams(prompts, **sp)
    r0 = reqs[0]
    assert r0.finish_reason == "stop"
    assert r0.output_tokens == full[0][:full[0].index(stop) + 1]
    assert eng.stats()["kv"]["used_pages"] == 0


def test_max_tokens_one_matches_sync():
    prompts = _prompts()
    eng = _port_engine()
    out = _drive(eng, te, prompts, max_tokens=1)
    assert out == _sync_streams(prompts, max_tokens=1)
    assert all(len(o) == 1 for o in out)
    st = eng.stats()
    assert st["decode_ticks"] == 0 and st["kv"]["used_pages"] == 0


def _in_flight_engine(n_tokens=20):
    """Two requests decoding, a tick in flight."""
    eng = _port_engine()
    reqs = [te.Request(f"r{i}", p, te.SamplingParams(max_tokens=n_tokens))
            for i, p in enumerate(_prompts()[:2])]
    for r in reqs:
        eng.add_request(r)
    while eng._inflight is None:
        eng.step()
    eng.step()
    assert eng._inflight is not None
    return eng, reqs


def test_abort_with_a_tick_in_flight():
    sync = _sync_streams(_prompts()[:2], max_tokens=20)
    eng, (a, b) = _in_flight_engine()
    drains = eng.stats()["drains"]
    n_a = len(a.output_tokens)
    assert eng.abort("r0")
    assert eng._inflight is None                 # the abort drained it
    assert eng.stats()["drains"] == drains + 1
    assert a.finished and a.finish_reason == "abort"
    # a's in-flight token was discarded; b's folded and waits for step()
    assert a.output_tokens == sync[0][:n_a]
    assert eng._pending_touched == [b]
    assert eng.has_work()
    assert b in eng.step()
    while eng.has_work():
        eng.step()
    assert b.output_tokens == sync[1]
    assert eng.stats()["kv"]["used_pages"] == 0


def test_has_work_with_only_work_in_flight():
    """A pump keyed on has_work() must step again while tokens are in
    flight or folded outside step()."""
    eng, (a, b) = _in_flight_engine()
    held = [s.request for s in eng.slots]
    for s in eng.slots:              # host slot state set aside: only
        s.request = None             # the in-flight tick is left
    assert not eng.waiting and not eng._pending_touched
    assert eng.has_work()
    for s, r in zip(eng.slots, held):
        s.request = r
    # abort both: the first abort's drain folds b's token, which only
    # the next step delivers
    assert eng.abort("r0") and eng.abort("r1")
    assert eng.num_active() == 0 and eng._inflight is None
    assert eng.has_work()
    assert eng.step() == [b]
    assert not eng.has_work()
    assert eng.stats()["kv"]["used_pages"] == 0


def test_tick_times_summary():
    eng = _port_engine()
    _drive(eng, te, _prompts()[:3], max_tokens=6)
    tt = eng.stats()["tick_times"]
    assert tt["window"] == eng.ticks > 0
    for name in ("wall_ms", "host_ms", "device_ms"):
        assert tt[f"{name}_p50"] <= tt[f"{name}_p95"] <= tt[f"{name}_p99"]
        assert tt[f"{name}_avg"] >= 0
    assert tt["wall_ms_avg"] >= tt["device_ms_avg"]
    assert 0.0 <= tt["overlap_ratio"] <= 1.0
    st = eng.stats()
    assert (tt["lagged_ticks"], tt["drains"], tt["async_readback"]) == (
        st["lagged_ticks"], st["drains"], True)
