"""Multi-step decode in ray_tpu_torch against ray_tpu.

Mirrors tests/test_llm.py::test_multi_step_decode_matches_single_step and
::test_multi_step_decode_composes_with_prefix_cache on the port, and
holds the port to the JAX gather engine (`decode_impl="gather",
async_readback=False`) at the same `decode_steps_per_call`:

- K in {2, 4}: greedy, penalty and sampled streams equal the port's K=1
  streams and the JAX engine's at K (float32 debug model, tokens equal);
- budgets clamp at max_tokens (K=8 over 5 tokens), EOS cuts a slot
  mid-round, page growth under kv_watermark_tokens looks K tokens ahead;
- `stats()["perf"]`: the totals and the "multi_decode" samples equal the
  JAX engine's (the same closed forms, weight_reads=K);
- adapters compose with multi-step rounds;
- a steady window of rounds makes no upload and no capture, and reads
  back once a round (dispatch_guard).
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
from ray_tpu_torch.util.dispatch_guard import dispatch_guard

torch.set_num_threads(1)

KW = dict(max_batch_size=4, page_size=8, num_pages=64, seed=9,
          enable_prefix_caching=False)
MODES = {"greedy": dict(max_tokens=13),
         "penalty": dict(max_tokens=13, repetition_penalty=1.3),
         "sampled": dict(max_tokens=13, temperature=0.9, top_p=0.9,
                         top_k=20, seed=17)}


def _jax_engine(**over):
    kw = dict(KW, model=jl.config("debug", dtype=jnp.float32),
              prefill_buckets=(16, 32, 64), decode_impl="gather",
              async_readback=False)
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw))


_PARAMS = {}


def _params():
    """The JAX engine's weights at seed 9, as numpy (one init)."""
    if "p" not in _PARAMS:
        _PARAMS["p"] = jax.tree_util.tree_map(
            np.asarray, je.InferenceEngine(je.EngineConfig(
                model=jl.config("debug", dtype=jnp.float32), seed=9,
                max_batch_size=1, num_pages=8, page_size=8,
                prefill_buckets=(16,))).params)
    return _PARAMS["p"]


def _port_engine(k, impl="gather", **over):
    kw = dict(KW, model=tl.config("debug", dtype=torch.float32),
              device="cpu", decode_impl=impl, decode_steps_per_call=k)
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw), params=_params())


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(2, 250, 6 + i).tolist() for i in range(3)]


def _adapters(cfg):
    L, h, q, kv = cfg.n_layers, cfg.hidden, cfg.q_dim, cfg.kv_dim
    rng = np.random.default_rng(1)
    return {"strong": {"wq": (rng.normal(0, 0.5, (L, h, 4)),
                              rng.normal(0, 0.5, (L, 4, q))),
                       "wk": (rng.normal(0, 0.5, (L, h, 4)),
                              rng.normal(0, 0.5, (L, 4, kv)))},
            "zero": {"wo": (np.zeros((L, q, 2)), np.zeros((L, 2, h)))}}


LORAS = ["strong", None, "zero"]


def _workload(eng, mod):
    """Every mode, then the adapter batch: [(mode, outputs)]."""
    out = {}
    for mode, sp in MODES.items():
        out[mode] = [r.output_tokens for r in eng.generate(
            [list(p) for p in _prompts()], mod.SamplingParams(**sp))]
    eng.register_loras(_adapters(eng.model_cfg))
    out["lora"] = [r.output_tokens for r in eng.generate(
        [list(p) for p in _prompts()], mod.SamplingParams(**MODES["sampled"]),
        loras=LORAS)]
    return out


def _multi_samples(perf):
    keys = ("decode_tokens", "flops", "hbm_bytes", "dispatches")
    return [tuple(getattr(t, k) for k in keys) for t in perf.window()
            if t.kind == "multi_decode"]


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for k in (2, 4):
        jeng = _jax_engine(decode_steps_per_call=k)
        out = _workload(jeng, je)
        runs[k] = (out, jeng.stats()["perf"]["totals"],
                   _multi_samples(jeng.perf))
    return runs


@pytest.fixture(scope="module")
def single_step():
    return _workload(_port_engine(1), te)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("k", [2, 4])
def test_multi_step_matches_single_step_and_jax(jax_runs, single_step, k,
                                                impl):
    eng = _port_engine(k, impl)
    out = _workload(eng, te)
    ref, totals, samples = jax_runs[k]
    for mode in list(MODES) + ["lora"]:
        assert out[mode] == single_step[mode], mode
        assert out[mode] == ref[mode], mode
    assert all(len(o) == 13 for o in out["greedy"])
    # adapters moved the stream; the zero adapter did not
    assert out["lora"][0] != single_step["sampled"][0]
    assert out["lora"][2] == single_step["sampled"][2]
    st = eng.stats()
    assert st["multi_rounds"] > 0 and st["dispatches_per_step"] == 1.0
    assert st["kv"]["used_pages"] == 0
    # the cost model's charges equal the JAX engine's
    assert st["perf"]["totals"] == totals
    assert _multi_samples(eng.perf) == samples and samples


def test_budgets_clamp_and_eos_cuts_mid_round():
    def gen(k, **sp):
        eng = _port_engine(k)
        return [r.output_tokens for r in eng.generate(
            [list(p) for p in _prompts()], te.SamplingParams(**sp))]

    assert all(len(o) == 5 for o in gen(8, max_tokens=5))
    base = gen(1, max_tokens=20)
    stop = base[0][4]
    stopped = gen(4, max_tokens=20, stop_token_ids=[stop])
    assert stopped == gen(1, max_tokens=20, stop_token_ids=[stop])
    assert stopped[0] == base[0][:5]


@pytest.mark.parametrize("async_rb", [True, False],
                         ids=["pipelined", "sync"])
def test_growth_under_watermark_looks_k_ahead(async_rb):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, 250, n).tolist() for n in (9, 14, 5, 11)]

    def run(k):
        eng = _port_engine(k, enable_kv_offload=True, kv_watermark_tokens=2,
                           async_readback=async_rb, num_pages=16)
        reqs = [te.Request(f"w{i}", list(p), te.SamplingParams(
            max_tokens=23, temperature=0.7, seed=i))
            for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        return eng, [r.output_tokens for r in reqs]

    eng4, out4 = run(4)
    _, out1 = run(1)
    assert out4 == out1 and all(len(o) == 23 for o in out4)
    # 15 usable pages against 18 at the requests' full need: slots grow,
    # and growth preempts
    assert eng4.stats()["multi_rounds"] > 0
    assert eng4.preempt_counts.get("growth", 0) > 0
    assert eng4.allocator.used_pages == 0


def test_multi_step_composes_with_prefix_cache():
    rng = np.random.default_rng(7)
    shared = rng.integers(2, 250, 24).tolist()
    prompts = [shared + [5], shared + [9, 11]]

    def gen(k, prefix):
        eng = _port_engine(k, num_pages=96, enable_prefix_caching=prefix)
        outs = [eng.generate([list(p)], te.SamplingParams(max_tokens=10)
                             )[0].output_tokens for p in prompts]
        if prefix:
            assert eng.allocator.cache_hit_tokens >= 16
        return outs

    assert gen(4, True) == gen(1, False)


@pytest.mark.parametrize("sp", [{}, {"temperature": 0.8, "top_k": 20,
                                     "repetition_penalty": 1.2}],
                         ids=["greedy", "sampled_penalized"])
def test_steady_rounds_no_uploads_no_captures_one_readback(sp):
    eng = _port_engine(4, async_readback=True)
    eng.register_loras(_adapters(eng.model_cfg))
    rng = np.random.default_rng(5)
    for i, lo in enumerate(LORAS):
        eng.add_request(te.Request(f"g{i}", rng.integers(2, 250, 12).tolist(),
                                   te.SamplingParams(max_tokens=64, **sp),
                                   lora=lo))
    while eng.waiting or any(s.request is not None and not s.ready
                             for s in eng.slots):
        eng.step()
    eng.step()
    rounds = eng.multi_rounds
    with dispatch_guard(engine=eng) as report:
        for _ in range(8):
            eng.step()
    assert report.uploads == [] and report.captures == []
    assert report.readbacks == 8 and eng.multi_rounds == rounds + 8
    assert all(len(s.request.output_tokens) > 30 for s in eng.slots
               if s.request is not None)


def test_config_checks():
    with pytest.raises(ValueError, match="decode_steps_per_call"):
        _port_engine(0)
    with pytest.raises(ValueError, match="max_loras"):
        _port_engine(1, max_loras=0)
