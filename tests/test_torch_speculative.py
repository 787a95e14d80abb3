"""ray_tpu_torch's speculative decoding against ray_tpu's.

Every case of tests/test_llm_speculative.py but the tp-mesh one (the
port has no mesh yet), on the port's engine, then the port against the
JAX spec engine on the same numpy target and draft parameters (float32
`debug` preset, CPU): the greedy tokens and the speculative counters
(`spec_rounds`, `spec_acceptance_rate`, `spec_tokens_per_round`),
`dispatches` and the number of speculative forwards equal the JAX
engine's for a perfect draft, a useless one, the mixed-batch fallback
with its catch-up sync, the prefix cache and the legacy step; the cost
receipts equal the JAX engine's; LLMServerImpl with a `speculative`
engine gives the directly driven engine's tokens. Exact equality
throughout: a float32 model and greedy acceptance.

The JAX side runs decode_impl="gather" (a speculative engine reads back
synchronously in both packages).
"""

import asyncio
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import engine as je
from ray_tpu.models import llama as jl
from ray_tpu_torch import LLMServerImpl
from ray_tpu_torch.llm._internal import engine as te
from ray_tpu_torch.llm._internal.attribution import CONSERVED_FIELDS
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import _kernels

torch.set_num_threads(1)

CFG = tl.config("debug", dtype=torch.float32)
JCFG = jl.config("debug", dtype=jnp.float32)
PROMPTS = [np.random.default_rng(i).integers(1, 250, 8 + i).tolist()
           for i in range(3)]
COMMON = dict(max_batch_size=4, num_pages=64, seed=3,
              enable_prefix_caching=False)
_TREES = {}


def _tree(seed):
    """The JAX preset's parameters from PRNGKey(seed), as numpy (seed 3
    is the target: what the JAX engine of seed 3 draws)."""
    if seed not in _TREES:
        _TREES[seed] = jax.tree_util.tree_map(
            np.asarray, jl.init_params(JCFG, jax.random.PRNGKey(seed)))
    return _TREES[seed]


def _spec(mod, draft_seed=3, k=4):
    return {"draft_model": JCFG if mod is je else CFG,
            "num_speculative_tokens": k, "draft_params": _tree(draft_seed)}


def _engine(mod, speculative=None, **over):
    if mod is je:
        kw = dict(COMMON, model=JCFG, decode_impl="gather",
                  async_readback=False)
    else:
        kw = dict(COMMON, model=CFG, device="cpu")
    kw.update(over)
    return mod.InferenceEngine(mod.EngineConfig(speculative=speculative,
                                                **kw), params=_tree(3))


def _gen(speculative, max_tokens=12, mod=te, **over):
    eng = _engine(mod, speculative, **over)
    reqs = eng.generate([list(p) for p in PROMPTS],
                        mod.SamplingParams(max_tokens=max_tokens))
    return [r.output_tokens for r in reqs], eng.stats()


# ------------------------- tests/test_llm_speculative.py, on the port

def test_speculative_matches_greedy_exactly():
    base, _ = _gen(None)
    same, st = _gen(_spec(te))
    assert same == base
    # near-perfect acceptance -> several tokens per verify dispatch
    assert st["spec_acceptance_rate"] > 0.6, st
    assert st["spec_tokens_per_round"] > 2.0, st


def test_speculative_exact_with_useless_draft():
    """The draft drawn from the engine's own generator (seed + 7): every
    candidate is rejected, yet each round emits the target's token."""
    base, _ = _gen(None)
    bad, st = _gen({"draft_model": CFG, "num_speculative_tokens": 3})
    assert bad == base
    assert st["spec_tokens_per_round"] >= 1.0


def test_speculative_respects_max_tokens_and_stops():
    out, _ = _gen(_spec(te), max_tokens=5)
    assert all(len(o) == 5 for o in out)
    base, _ = _gen(None)
    stop = base[1][3]
    eng = _engine(te, _spec(te))
    r = eng.generate([list(PROMPTS[1])], te.SamplingParams(
        max_tokens=12, stop_token_ids=(stop,)))[0]
    assert r.finish_reason == "stop"
    assert r.output_tokens == base[1][:base[1].index(stop) + 1]
    assert eng.stats()["kv"]["used_pages"] == 0


def test_speculative_falls_back_for_sampling_requests():
    eng = _engine(te, _spec(te))
    reqs = eng.generate([list(p) for p in PROMPTS],
                        te.SamplingParams(max_tokens=6, temperature=0.8))
    assert all(len(r.output_tokens) == 6 for r in reqs)
    assert "spec_rounds" not in eng.stats()


@pytest.mark.parametrize("over,match", [
    (dict(speculative={"draft_model": CFG, "num_speculative_tokens": 1}),
     ">= 2"),
    (dict(speculative={"draft_model": tl.config("tiny")}),
     "share a vocab"),
    (dict(speculative={"draft_model": CFG}, enable_kv_offload=True),
     "speculative"),
    (dict(speculative={"draft_model": CFG}, enable_kv_offload=True,
          kv_watermark_tokens=8), "speculative"),
    (dict(speculative={"draft_model": CFG}, kv_dtype="int8"),
     "speculative"),
    (dict(unified_step=False, kv_dtype="fp8"), "unified_step"),
])
def test_speculative_validation(over, match):
    with pytest.raises(ValueError, match=match):
        te.InferenceEngine(te.EngineConfig(model=CFG, device="cpu", **over))


def test_speculative_survives_mixed_batch_fallback():
    """A sampling request joining mid-stream forces regular decode
    ticks; once it leaves, rounds resume after the draft catch-up (the
    delta has outgrown the round's buffer): the greedy stream is the
    plain engine's."""
    eng = _engine(te, _spec(te))
    greedy, sampler = _fallback_drive(eng, te)
    assert eng.stats()["spec_rounds"] > 0
    ref = _engine(te)
    [r] = ref.generate([list(PROMPTS[0])], te.SamplingParams(max_tokens=40))
    assert greedy.output_tokens == r.output_tokens
    assert len(sampler.output_tokens) == 10


def test_speculative_rejects_lora():
    eng = _engine(te, _spec(te), max_batch_size=2)
    r = 2
    adapters = {"wq": (np.zeros((CFG.n_layers, 128, r), np.float32),
                       np.zeros((CFG.n_layers, r, 128), np.float32))}
    with pytest.raises(NotImplementedError, match="speculative"):
        eng.register_lora("a", adapters)


def _prefix_prompts():
    shared = np.random.default_rng(7).integers(1, 250, 24).tolist()
    return [shared + [5, 6], shared + [9], shared + [11, 12, 13]]


def _prefix_gen(mod, speculative, prefix):
    eng = _engine(mod, speculative, max_batch_size=2, num_pages=96,
                  page_size=8, enable_prefix_caching=prefix)
    outs = []
    for p in _prefix_prompts():     # sequential: later prompts hit
        outs.append(eng.generate([list(p)], mod.SamplingParams(
            max_tokens=10))[0].output_tokens)
    return outs, eng


def test_speculative_composes_with_prefix_cache():
    """Shared prompt pages hold the same draft KV for every sharer (the
    admission's draft prefill rewrites them with the values they hold),
    so hits stay token-exact against the plain engine and the JAX spec
    engine with the cache on."""
    base, _ = _prefix_gen(te, None, prefix=False)
    cached, eng = _prefix_gen(te, _spec(te), prefix=True)
    assert cached == base
    assert eng.allocator.stats().get("cache_hit_tokens", 0) > 0
    ref, jeng = _prefix_gen(je, _spec(je), prefix=True)
    assert cached == ref
    assert eng.stats()["spec_rounds"] == jeng.stats()["spec_rounds"]


# ------------------------------------------------ against the JAX engine

def _counters(st, jax_side=False):
    return (st["spec_rounds"], st["spec_acceptance_rate"],
            st["spec_tokens_per_round"], st["dispatches"],
            st["jit_cache" if jax_side else "compile_cache"]["spec_fns"])


@pytest.mark.parametrize("draft_seed,k,impl", [
    (3, 4, "gather"), (10, 3, "gather"), (3, 2, "kernel"),
    (3, 5, "kernel"),
], ids=["perfect-k4", "useless-k3", "perfect-k2-kernel", "perfect-k5-kernel"])
def test_spec_tokens_and_counters_equal_jax(draft_seed, k, impl):
    """The same numpy target and draft in both engines (seed 10: a draft
    whose candidates the target rejects): tokens, rounds, acceptance,
    tokens a round, dispatches and the speculative forwards equal. The
    kernel impl runs the kernels' plain versions on the CPU, through the
    kernel path's plumbing (the draft's decode steps included)."""
    ref, jst = _gen(_spec(je, draft_seed, k), max_tokens=14, mod=je)
    out, st = _gen(_spec(te, draft_seed, k), max_tokens=14,
                   decode_impl=impl)
    assert out == ref
    assert _counters(st) == _counters(jst, jax_side=True)
    assert st["async_readback"] is False


def _fallback_drive(eng, mod):
    """tests/test_llm_speculative.py's mixed batch: a greedy request
    alone for 3 steps, a sampled one joins and finishes, the greedy one
    finishes alone."""
    greedy = mod.Request("g", list(PROMPTS[0]),
                         mod.SamplingParams(max_tokens=40))
    eng.add_request(greedy)
    for _ in range(3):
        eng.step()
    assert eng.stats().get("spec_rounds", 0) > 0
    sampler = mod.Request("s", list(PROMPTS[1]),
                          mod.SamplingParams(max_tokens=10, temperature=0.9))
    eng.add_request(sampler)
    while not sampler.finished:
        eng.step()
    while not greedy.finished:
        eng.step()
    return greedy, sampler


def test_mixed_batch_fallback_equal_jax():
    """The fallback's decode ticks, the catch-up syncs and the resumed
    rounds: both streams (the sampled one by the reference's noise, made
    by the port's threefry), the rounds and the dispatches equal the JAX
    engine's."""
    jeng = _engine(je, _spec(je))
    jg, js = _fallback_drive(jeng, je)
    eng = _engine(te, _spec(te))
    g, s = _fallback_drive(eng, te)
    assert (g.output_tokens, s.output_tokens) == \
        (jg.output_tokens, js.output_tokens)
    assert _counters(eng.stats()) == _counters(jeng.stats(), jax_side=True)
    assert eng.stats()["decode_ticks"] > 0        # the fallback ran


def test_spec_with_legacy_step_equal_jax():
    """A speculative engine on the legacy step (prompts prefilled by
    the padded forwards, one of them chunked): tokens and counters equal
    the JAX engine's."""
    prompts = PROMPTS + [np.random.default_rng(9).integers(
        1, 250, 37).tolist()]
    over = dict(unified_step=False, max_prefill_tokens=16)
    jeng = _engine(je, _spec(je), prefill_buckets=(16, 32, 64), **over)
    ref = [r.output_tokens for r in jeng.generate(
        [list(p) for p in prompts], je.SamplingParams(max_tokens=12))]
    eng = _engine(te, _spec(te), prefill_buckets=(16, 32, 64), **over)
    out = [r.output_tokens for r in eng.generate(
        [list(p) for p in prompts], te.SamplingParams(max_tokens=12))]
    assert out == ref
    assert _counters(eng.stats()) == _counters(jeng.stats(), jax_side=True)
    assert eng.stats()["ragged_ticks"] == 0


def test_spec_receipts_equal_jax():
    """Per-request receipts (the draft's prefill, rounds and syncs on the
    draft's cost model, the verify with its head rows, the emitted
    tokens) and the accountant's totals equal the JAX engine's."""
    jeng = _engine(je, _spec(je), metrics_model_id=f"j{uuid.uuid4().hex}")
    jreqs = jeng.generate([list(p) for p in PROMPTS],
                          je.SamplingParams(max_tokens=12))
    eng = _engine(te, _spec(te), metrics_model_id=f"t{uuid.uuid4().hex}")
    reqs = eng.generate([list(p) for p in PROMPTS],
                        te.SamplingParams(max_tokens=12))
    for r, jr in zip(reqs, jreqs):
        mine = eng.attrib.receipt(r.request_id)
        ref = jeng.attrib.receipt(jr.request_id)
        assert (mine.flops, mine.hbm_bytes, mine.kv_page_ticks) == \
            (ref.flops, ref.hbm_bytes, ref.kv_page_ticks)
        for _, attr in CONSERVED_FIELDS:
            assert getattr(mine, attr) == getattr(ref, attr), attr
        assert mine.ticks == ref.ticks
    assert eng.attrib.totals() == jeng.attrib.totals()
    pt, jpt = eng.perf.totals(), jeng.perf.totals()
    for key in ("flops", "bytes_weights", "decode_tokens", "prefill_tokens"):
        assert pt[key] == jpt[key], key
    kinds = {t.kind for t in eng.perf.window()}
    assert any("spec" in kd for kd in kinds)


def test_server_with_speculative_engine():
    """LLMServerImpl builds a speculative engine from engine_kwargs; its
    completions (greedy, at once) give the tokens of an engine of the
    same config driven directly."""
    kw = dict(COMMON, device="cpu", max_seq_len=256,
              speculative={"draft_model": CFG, "num_speculative_tokens": 3,
                           "draft_params": _tree(5)})
    srv = LLMServerImpl({"model_id": f"s{uuid.uuid4().hex[:8]}",
                         "model_source": CFG, "engine_kwargs": kw})
    bodies = [dict(prompt="The paged cache", max_tokens=12),
              dict(prompt="Hello, world!", max_tokens=5),
              dict(prompt="Speculative rounds " * 3, max_tokens=9)]

    async def run():
        return await asyncio.gather(*[srv.completions(dict(b))
                                      for b in bodies])

    got = asyncio.run(run())
    direct = te.InferenceEngine(te.EngineConfig(model=CFG, **kw))
    prompts = [srv._prompt_tokens(dict(b), chat=False) for b in bodies]
    want = [direct.generate([p], te.SamplingParams(
        max_tokens=b["max_tokens"]))[0].output_tokens
        for p, b in zip(prompts, bodies)]
    assert [g["choices"][0]["text"] for g in got] == \
        [srv.tokenizer.decode(w) for w in want]
    assert srv.engine.stats()["spec_rounds"] > 0


def test_draft_params_tensors_are_shared():
    """A perfect draft given the target's own serving tensors reuses
    them: no second copy of the weights."""
    eng = _engine(te)
    spec = _engine(te, {"draft_model": CFG, "draft_params": eng.params})
    draft = spec._spec["params"]
    for name, w in eng.params["layers"].items():
        if name in ("wq", "wk", "wv", "wo", "wg", "wi", "wd"):
            assert draft["layers"][name] is w
    assert draft["lm_head"] is eng.params["lm_head"]


def test_spec_engine_runs_on_cuda_unless_asked():
    """Without device="cpu" a speculative or legacy engine takes the
    card; with none there, it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engines would run on it")
    for kw in (dict(speculative={"draft_model": CFG}),
               dict(unified_step=False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            te.InferenceEngine(te.EngineConfig(model=CFG, **kw))


def test_draft_decode_counts_launches_only_through_the_kernel():
    """On the CPU the kernel impl's wrappers run their plain versions and
    count no launch: the counters move only on the card."""
    _kernels.reset_launch_counts()
    _gen(_spec(te), max_tokens=6, decode_impl="kernel")
    assert sum(_kernels.launch_counts().values()) == 0
