"""ray_tpu_torch's InferenceEngine and sampler against ray_tpu's.

- `_sample` is token-equal to the JAX sampler when fed JAX's own Gumbel
  noise (jax.random.categorical(key, x) is argmax(x + gumbel(key))).
- The port engine (device="cpu", params converted from the JAX
  engine's; its default pipelined readback, token-exact with its
  synchronous one: tests/test_torch_engine_pipeline.py) gives the same
  greedy tokens as the JAX engine with decode_impl="gather" and
  async_readback=False (the JAX engine's pipelined readback gave
  run-to-run different greedy tokens on the prefix-cache workload
  below, so it is no oracle) on the staggered mixed workload of
  tests/test_ragged_attention.py, with a repetition penalty, and with a
  shared prompt prefix — on both of the port's attention impls (on the
  CPU "kernel" runs the kernels' plain versions through the kernel
  path's plumbing). Exact token equality: float32 debug model.
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
from ray_tpu_torch.ops.threefry import row_gumbel

torch.set_num_threads(1)


# ---------------------------------------------------------------- sampler

SAMPLER_CASES = [
    # temps, top_ps, top_ks, rep_pens
    ("mixed", [0.0, 0.7, 1.3, 1.0], [1.0, 0.9, 0.5, 1.0], [0, 5, 0, 1],
     [1.0, 1.2, 0.8, 1.0]),
    ("top_p_only", [1.0, 0.5, 2.0, 0.9], [0.3, 0.8, 0.95, 0.1],
     [0, 0, 0, 0], [1.0, 1.0, 1.0, 1.0]),
    ("top_k_only", [1.0, 1.0, 0.6, 3.0], [1.0, 1.0, 1.0, 1.0],
     [1, 2, 7, 40], [1.3, 1.0, 1.0, 1.0]),
]


@pytest.mark.parametrize("name,temps,top_ps,top_ks,rep_pens",
                         SAMPLER_CASES)
def test_sample_matches_jax_with_jax_noise(name, temps, top_ps, top_ks,
                                           rep_pens):
    rng = np.random.default_rng(len(name))
    B, V = 4, 64
    for trial in range(5):
        logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
        seen = rng.random((B, V)) < 0.2
        seeds = jnp.asarray(rng.integers(0, 2 ** 31 - 1, B), jnp.int32)
        idx = jnp.asarray(rng.integers(0, 500, B), jnp.int32)
        keys = je._row_sample_keys(seeds, idx)
        noise = np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))
        f32 = lambda a: np.asarray(a, np.float32)
        ref = np.asarray(je._sample(
            jnp.asarray(logits), None, jnp.asarray(f32(temps)),
            jnp.asarray(f32(top_ps)), jnp.asarray(np.asarray(top_ks,
                                                              np.int32)),
            jnp.asarray(f32(rep_pens)), jnp.asarray(seen), False,
            row_keys=keys))
        out = te._sample(
            torch.from_numpy(logits), torch.from_numpy(f32(temps)),
            torch.from_numpy(f32(top_ps)),
            torch.tensor(top_ks, dtype=torch.int32),
            torch.from_numpy(f32(rep_pens)), torch.from_numpy(seen),
            gumbel=torch.from_numpy(noise))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=f"{trial}")


def test_sample_all_greedy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 33)).astype(np.float32)
    logits[2, 4] = logits[2, 9] = logits[2].max() + 1   # tie: first index
    ref = np.asarray(je._sample(jnp.asarray(logits), None, None, None,
                                all_greedy=True))
    out = te._sample(torch.from_numpy(logits), None, None, all_greedy=True)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[2] == 4


def test_gumbel_rows_depend_only_on_seed_and_index():
    """The sampler's noise (``row_gumbel``): row b depends only on
    (seeds[b], index[b]), whatever else shares the batch."""
    i32 = dict(dtype=torch.int32)
    a = row_gumbel(torch.tensor([3, 3, 8], **i32),
                   torch.tensor([10, 11, 10], **i32), 50)
    b = row_gumbel(torch.tensor([8, 3], **i32), torch.tensor([10, 10], **i32),
                   50)
    assert torch.equal(a[0], b[1]) and torch.equal(a[2], b[0])
    assert not torch.equal(a[0], a[1])
    assert torch.isfinite(a).all()


# ----------------------------------------------------------------- engine

ENGINE_KW = dict(max_batch_size=3, page_size=8, num_pages=64,
                 max_prefill_tokens=16, seed=9)


def _jax_engine(**over):
    kw = dict(ENGINE_KW, model=jl.config("debug", dtype=jnp.float32),
              prefill_buckets=(16, 32, 64), decode_impl="gather",
              async_readback=False)
    kw.update(over)
    return je.InferenceEngine(je.EngineConfig(**kw))


def _port_engine(jeng, impl, **over):
    kw = dict(ENGINE_KW, model=tl.config("debug", dtype=torch.float32),
              device="cpu", decode_impl=impl)
    kw.update(over)
    params = jax.tree_util.tree_map(np.asarray, jeng.params)
    return te.InferenceEngine(te.EngineConfig(**kw), params=params)


def _drive(eng, mod, prompts, **sp):
    """Staggered mixed workload: more requests than slots, added while
    earlier ones decode — ticks mix prefill chunks and decode rows."""
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


def _prompts():
    rng = np.random.default_rng(3)
    lens = (40, 23, 1, 33, 7, 19)
    return [rng.integers(2, 250, n).tolist() for n in lens]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX gather engine's outputs, computed once per workload."""
    out = {}
    out["greedy"] = _drive(_jax_engine(), je, _prompts(), max_tokens=12)
    out["penalty"] = _drive(_jax_engine(), je, _prompts(), max_tokens=10,
                            repetition_penalty=1.3)
    return out


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("workload,sp", [
    ("greedy", dict(max_tokens=12)),
    ("penalty", dict(max_tokens=10, repetition_penalty=1.3)),
])
def test_engine_token_exact_vs_jax_gather(jax_runs, workload, sp, impl):
    eng = _port_engine(_jax_engine(), impl)
    out = _drive(eng, te, _prompts(), **sp)
    assert out == jax_runs[workload]
    st = eng.stats()
    assert st["ragged_ticks"] > 0 and st["decode_ticks"] > 0
    assert st["dispatches_per_step"] == 1.0
    assert st["kv"]["used_pages"] == 0          # every page came back


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_engine_prefix_cache_token_exact_vs_jax(impl):
    rng = np.random.default_rng(5)
    shared = rng.integers(2, 250, 24).tolist()
    prompts = [shared + [5], shared + [9, 11]]
    jeng = _jax_engine(enable_prefix_caching=True)
    ref = [jeng.generate([list(p)], je.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    eng = _port_engine(jeng, impl, enable_prefix_caching=True)
    outs = [eng.generate([list(p)], te.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    assert eng.allocator.cache_hit_tokens >= 16
    assert outs == ref
    cold = _port_engine(jeng, impl, enable_prefix_caching=False)
    assert [cold.generate([list(p)], te.SamplingParams(max_tokens=8)
                          )[0].output_tokens for p in prompts] == ref


def test_sampled_stream_independent_of_batch():
    """A sampled request's tokens depend on (seed, token index) only, not
    on what else shares its ticks."""
    jeng = _jax_engine()
    sp = dict(max_tokens=8, temperature=0.9, top_p=0.9, top_k=20, seed=77)
    alone = _port_engine(jeng, "gather")
    req = te.Request("x", _prompts()[0], te.SamplingParams(**sp))
    alone.add_request(req)
    while alone.has_work():
        alone.step()
    busy = _port_engine(jeng, "gather")
    others = [te.Request(f"o{i}", p, te.SamplingParams(max_tokens=5))
              for i, p in enumerate(_prompts()[1:3])]
    req2 = te.Request("y", _prompts()[0], te.SamplingParams(**sp))
    for r in others + [req2]:
        busy.add_request(r)
    while busy.has_work():
        busy.step()
    assert req2.output_tokens == req.output_tokens
    assert len(req.output_tokens) == 8


def test_engine_stop_abort_and_limits():
    jeng = _jax_engine()
    eng = _port_engine(jeng, "gather")
    first = eng.generate([_prompts()[1]], te.SamplingParams(max_tokens=4))[0]
    stop = first.output_tokens[1]
    r = eng.generate([_prompts()[1]], te.SamplingParams(
        max_tokens=4, stop_token_ids=(stop,)))[0]
    assert r.finish_reason == "stop" and r.output_tokens == \
        first.output_tokens[:2]
    a = te.Request("a", _prompts()[0], te.SamplingParams(max_tokens=30))
    b = te.Request("b", _prompts()[3], te.SamplingParams(max_tokens=30))
    eng.add_request(a)
    eng.step()
    eng.add_request(b)
    assert eng.abort("b") and b.finish_reason == "abort"
    assert eng.abort("a") and a.finish_reason == "abort"
    assert not eng.abort("zzz")
    assert not eng.has_work()
    assert eng.stats()["kv"]["used_pages"] == 0
    with pytest.raises(ValueError):
        eng.add_request(te.Request("big", [1] * 250,
                                   te.SamplingParams(max_tokens=10)))


@pytest.mark.parametrize("over,exc", [
    (dict(kv_dtype="int4"), ValueError),
    (dict(decode_impl="pallas"), ValueError),
    (dict(device="meta"), ValueError),
])
def test_engine_config_rejects_unported_options(over, exc):
    kw = dict(device="cpu")
    kw.update(over)
    with pytest.raises(exc):
        te.InferenceEngine(te.EngineConfig(**kw))


def test_engine_config_unknown_fields_raise():
    for field in ("mesh",):
        with pytest.raises(TypeError):
            te.EngineConfig(**{field: None})
    assert te.InferenceEngine(te.EngineConfig(device="cpu")).impl == "gather"


# ------------------------------------------------------ quantized KV pages

@pytest.fixture(scope="module")
def jax_quant_runs():
    """The JAX gather engine's outputs with int8/fp8 pages, per workload,
    computed once."""
    out = {}
    for kind in ("int8", "fp8"):
        out[kind, "greedy"] = _drive(_jax_engine(kv_dtype=kind), je,
                                     _prompts(), max_tokens=12)
        out[kind, "penalty"] = _drive(_jax_engine(kv_dtype=kind), je,
                                      _prompts(), max_tokens=10,
                                      repetition_penalty=1.3)
    return out


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("workload,sp", [
    ("greedy", dict(max_tokens=12)),
    ("penalty", dict(max_tokens=10, repetition_penalty=1.3)),
])
def test_engine_quant_token_exact_vs_jax_gather(jax_quant_runs, workload, sp,
                                                kind, impl):
    """int8/fp8 pages: quantization changes tokens against f32 pages, so
    the oracle is the JAX gather engine of the same kind."""
    eng = _port_engine(_jax_engine(), impl, kv_dtype=kind)
    assert eng.k_pages.dtype == {"int8": torch.int8,
                                 "fp8": torch.float8_e4m3fn}[kind]
    assert eng.k_scales.shape == eng.k_pages.shape[:-1]
    out = _drive(eng, te, _prompts(), **sp)
    assert out == jax_quant_runs[kind, workload]
    st = eng.stats()
    assert st["ragged_ticks"] > 0 and st["decode_ticks"] > 0
    assert st["kv"]["used_pages"] == 0


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_engine_quant_prefix_cache_token_exact_vs_jax(kind, impl):
    """Prefix caching shares quantized pages as they are."""
    rng = np.random.default_rng(5)
    shared = rng.integers(2, 250, 24).tolist()
    prompts = [shared + [5], shared + [9, 11]]
    jeng = _jax_engine(enable_prefix_caching=True, kv_dtype=kind)
    ref = [jeng.generate([list(p)], je.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    eng = _port_engine(jeng, impl, enable_prefix_caching=True,
                       kv_dtype=kind)
    outs = [eng.generate([list(p)], te.SamplingParams(max_tokens=8)
                         )[0].output_tokens for p in prompts]
    assert eng.allocator.cache_hit_tokens >= 16
    assert outs == ref


def test_engine_quant_stats_report_configured_dtype_bytes():
    """stats() byte gauges at the configured page kind, with the JAX
    engine's arithmetic (tests/test_kv_quant.py): f32 pages at the
    model's itemsize, quantized pages at one byte a value plus a float32
    scale per (row, kv head)."""
    from ray_tpu.ops import kv_quant as jkq
    mc = tl.config("debug", dtype=torch.float32)
    rows = {"f32": 2 * mc.n_layers * mc.n_kv_heads * mc.head_dim * 4}
    for kind in ("int8", "fp8"):
        rows[kind] = 2 * mc.n_layers * jkq.token_row_bytes(
            kind, mc.n_kv_heads, mc.head_dim)
    for kind, row in rows.items():
        eng = te.InferenceEngine(te.EngineConfig(
            model=mc, device="cpu", kv_dtype=kind, **ENGINE_KW))
        for i, p in enumerate(_prompts()[:3]):
            eng.add_request(te.Request(f"s{i}", p,
                                       te.SamplingParams(max_tokens=4)))
        for _ in range(3):
            eng.step()
        st = eng.stats()
        assert st["kv_dtype"] == kind
        assert st["kv_page_bytes"] == row * ENGINE_KW["page_size"]
        assert st["kv"]["used_pages"] > 0
        assert st["kv_device_bytes_used"] == (
            eng.allocator.used_pages * st["kv_page_bytes"])
