"""ray_tpu_torch's legacy two-dispatch engine step against ray_tpu's.

`EngineConfig(unified_step=False)`: a tick with a prefilling slot runs
padded prefill dispatches (whole prompts through `prefill`, longer ones
and prefix-cache suffixes chunk by chunk through `prefill_chunk`, the
first token sampled in the same dispatch), then the decode tick.

- tests/test_ragged_attention.py's unified-vs-legacy cases on the port:
  greedy, with a repetition penalty and with the prefix cache, the
  unified engine's tokens equal the legacy engine's; the unified step
  dispatches once a tick, the legacy one more often;
- the port's legacy engine against the JAX legacy engine
  (unified_step=False, decode_impl="gather", async_readback=False, the
  same numpy weights, float32 `debug` preset): tokens, dispatches, ticks
  and the prefill forwards' compile counts equal on the staggered mixed
  workload (prompts longer than max_prefill_tokens chunk), greedy, with
  a penalty and sampled (the first token's noise keyed by (seed, prompt
  length)), with the prefix cache, and with a LoRA adapter; on both of
  the port's attention impls and both readback modes. Exact equality:
  a float32 model.
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

KW = dict(max_batch_size=3, page_size=8, num_pages=64,
          prefill_buckets=(16, 32, 64), max_prefill_tokens=16, seed=9)
_PARAMS = {}


def _jax_engine(**over):
    kw = dict(KW, model=jl.config("debug", dtype=jnp.float32),
              decode_impl="gather", async_readback=False,
              unified_step=False)
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw), params=_params())


def _params():
    """The JAX engine's weights of seed 9, as numpy."""
    if not _PARAMS:
        _PARAMS.update(jax.tree_util.tree_map(np.asarray, jl.init_params(
            jl.config("debug", dtype=jnp.float32), jax.random.PRNGKey(9))))
    return _PARAMS


def _engine(unified, **over):
    kw = dict(KW, model=tl.config("debug", dtype=torch.float32),
              device="cpu", unified_step=unified)
    kw.update(over)
    return te.InferenceEngine(te.EngineConfig(**kw), params=_params())


def _drive(eng, mod, prompts, **sp):
    """Staggered mixed workload: more requests than slots, added while
    earlier ones decode. Returns the tokens and the steps taken."""
    reqs = [mod.Request(f"r{i}", list(p), mod.SamplingParams(**sp))
            for i, p in enumerate(prompts)]
    for r in reqs[:2]:
        eng.add_request(r)
    steps = 0
    for r in reqs[2:]:
        eng.step()
        steps += 1
        eng.add_request(r)
    while eng.has_work():
        eng.step()
        steps += 1
    return [r.output_tokens for r in reqs], steps


def _prompts():
    rng = np.random.default_rng(3)
    # longer than the 16-token chunk (chunked prefill), plus short and
    # single-token prompts
    lens = (40, 23, 1, 33, 7, 19)
    return [rng.integers(2, 250, n).tolist() for n in lens]


WORKLOADS = {
    "greedy": dict(max_tokens=12),
    "penalty": dict(max_tokens=10, repetition_penalty=1.3),
    "sampled": dict(max_tokens=10, temperature=0.8, top_p=0.9, top_k=30),
}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX legacy engine's tokens and counters, once a workload."""
    out = {}
    for name, sp in WORKLOADS.items():
        eng = _jax_engine()
        toks, steps = _drive(eng, je, _prompts(), **sp)
        st = eng.stats()
        out[name] = (toks, steps, st["dispatches"],
                     st["jit_cache"]["prefill_buckets"],
                     st["jit_cache"]["chunk_buckets"])
    return out


# ------------------------------- tests/test_ragged_attention.py, on the port

@pytest.mark.parametrize("workload", ["greedy", "penalty"])
def test_unified_step_token_exact_vs_legacy(workload):
    sp = WORKLOADS[workload]
    out_u, _ = _drive(_engine(True), te, _prompts(), **sp)
    out_l, _ = _drive(_engine(False), te, _prompts(), **sp)
    assert out_u == out_l


def test_unified_step_composes_with_prefix_cache():
    rng = np.random.default_rng(5)
    shared = rng.integers(2, 250, 24).tolist()
    prompts = [shared + [5], shared + [9, 11]]
    eng = _engine(True, enable_prefix_caching=True)
    outs = [eng.generate([list(p)], te.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    assert eng.allocator.cache_hit_tokens >= 16
    cold = _engine(False, enable_prefix_caching=False)
    ref = [cold.generate([list(p)], te.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    assert outs == ref


def test_unified_step_one_dispatch_per_tick():
    """One dispatch a tick for the unified step; the legacy step pays
    two on every mixed tick, more when it drains a cold batch."""
    for unified in (True, False):
        eng = _engine(unified)
        for i, p in enumerate(_prompts()):
            eng.add_request(te.Request(f"d{i}", list(p),
                                       te.SamplingParams(max_tokens=8)))
        steps = 0
        d0 = eng.dispatches
        while eng.has_work():
            eng.step()
            steps += 1
        assert steps > 0
        if unified:
            assert eng.dispatches - d0 == steps
            assert eng.stats()["dispatches_per_step"] == 1.0
        else:
            assert eng.dispatches - d0 > steps
            assert eng.stats()["ragged_ticks"] == 0


# ------------------------------------------------ against the JAX engine

@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_legacy_engine_equal_jax(jax_runs, workload, impl):
    """Tokens, steps, dispatches and the compiles of the prefill and
    chunk forwards (by bucket) equal the JAX legacy engine's; with the
    pipelined readback too (its decode ticks fold a tick late, its
    prefills drain first: the same tokens)."""
    toks, steps, dispatches, n_prefill, n_chunk = jax_runs[workload]
    eng = _engine(False, decode_impl=impl, async_readback=False)
    out, n = _drive(eng, te, _prompts(), **WORKLOADS[workload])
    assert out == toks
    st = eng.stats()
    assert (n, st["dispatches"]) == (steps, dispatches)
    cc = st["compile_cache"]
    assert (cc["prefill_buckets"], cc["chunk_buckets"]) == \
        (n_prefill, n_chunk)
    assert n_chunk > 0 and n_prefill > 0      # both forwards ran
    assert st["ragged_ticks"] == 0 and st["kv"]["used_pages"] == 0
    piped, _ = _drive(_engine(False, decode_impl=impl), te, _prompts(),
                      **WORKLOADS[workload])
    assert piped == toks


def test_legacy_prefix_cache_equal_jax():
    """A prefix-cache hit prefills its suffix through prefill_chunk over
    the shared pages."""
    rng = np.random.default_rng(5)
    shared = rng.integers(2, 250, 24).tolist()
    prompts = [shared + [5], shared + [9, 11], shared[:17]]
    jeng = _jax_engine(enable_prefix_caching=True)
    ref = [jeng.generate([list(p)], je.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    eng = _engine(False, enable_prefix_caching=True, async_readback=False)
    outs = [eng.generate([list(p)], te.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    assert eng.allocator.cache_hit_tokens >= 16
    assert outs == ref
    assert eng.dispatches == jeng.dispatches


def test_legacy_long_prompt_and_lora_equal_jax():
    """A prompt longer than max_prefill_tokens (three chunks) and an
    adapter request beside a base one: the adapter rides both prefill
    forwards and the decode tick. The JAX engine runs with the prefix
    cache off, as for every adapter request (ROADMAP §C)."""
    cfg = jl.config("debug", dtype=jnp.float32)
    L, h, q_dim, r = cfg.n_layers, cfg.hidden, cfg.q_dim, 4
    rng = np.random.default_rng(1)
    adapter = {"wq": (rng.normal(0, 0.5, (L, h, r)),
                      rng.normal(0, 0.5, (r, q_dim)) * np.ones((L, 1, 1)))}
    prompts = [rng.integers(2, 250, 45).tolist(),
               rng.integers(2, 250, 12).tolist(),
               rng.integers(2, 250, 20).tolist()]
    loras = ["strong", None, "strong"]

    def run(eng, mod):
        eng.register_lora("strong", adapter)
        reqs = [mod.Request(f"l{i}", list(p), mod.SamplingParams(
            max_tokens=8), lora=lo) for i, (p, lo) in enumerate(
                zip(prompts, loras))]
        for q in reqs:
            eng.add_request(q)
        while eng.has_work():
            eng.step()
        return [q.output_tokens for q in reqs]

    jeng = _jax_engine(enable_prefix_caching=False, max_batch_size=4)
    ref = run(jeng, je)
    eng = _engine(False, enable_prefix_caching=False, max_batch_size=4,
                  async_readback=False)
    out = run(eng, te)
    assert out == ref
    assert eng.dispatches == jeng.dispatches
    base = _engine(False, enable_prefix_caching=False)
    plain = base.generate([list(prompts[0])],
                          te.SamplingParams(max_tokens=8))[0].output_tokens
    assert plain != out[0]                      # the adapter took effect


def test_legacy_step_receipts_equal_jax():
    """The legacy step's "prefill" charges and the decode ticks': every
    request's receipt and the totals equal the JAX engine's."""
    jeng = _jax_engine(metrics_model_id="legacy-j")
    _drive(jeng, je, _prompts(), max_tokens=8)
    eng = _engine(False, metrics_model_id="legacy-t", async_readback=False)
    _drive(eng, te, _prompts(), max_tokens=8)
    assert eng.attrib.totals() == jeng.attrib.totals()
    assert eng.perf.totals()["flops"] == jeng.perf.totals()["flops"]
    assert any("prefill" in t.kind for t in eng.perf.window())
