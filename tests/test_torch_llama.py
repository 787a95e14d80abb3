"""ray_tpu_torch.models.llama / weights against ray_tpu.models.llama.

Same numpy inputs through the JAX functions (CPU) and their PyTorch
counterparts. Tolerance 1e-6 in float32: both sides do the same float32
operations; only transcendental implementations (rsqrt, pow, cos/sin)
may differ in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.weights import params_from_numpy, pools_from_numpy

torch.set_num_threads(1)

PRESETS = ["debug", "tiny"]


@pytest.mark.parametrize("preset", PRESETS)
def test_rms_norm_matches_jax(preset):
    cfg = jl.config(preset)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, cfg.hidden)).astype(np.float32)
    w = rng.normal(size=(cfg.hidden,)).astype(np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                 cfg.norm_eps))
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                      cfg.norm_eps).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset", PRESETS)
def test_rope_matches_jax(preset):
    jcfg, tcfg = jl.config(preset), tl.config(preset)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, jcfg.max_seq, 9).astype(np.int32)
    cos_j, sin_j = jl.rope_frequencies(jcfg, jnp.asarray(pos))
    cos_t, sin_t = tl.rope_frequencies(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    # apply_rope on identical cos/sin: exact float32 arithmetic
    x = rng.normal(size=(2, 9, jcfg.n_heads, jcfg.head_dim)).astype(
        np.float32)
    ref = np.asarray(jl.apply_rope(jnp.asarray(x), cos_j, sin_j))
    out = tl.apply_rope(torch.from_numpy(x),
                        torch.tensor(np.asarray(cos_j)),
                        torch.tensor(np.asarray(sin_j))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_presets_and_config_match_jax():
    assert set(tl.PRESETS) == set(jl.PRESETS)
    for name, jc in jl.PRESETS.items():
        tc = tl.PRESETS[name]
        for f in ("vocab_size", "hidden", "n_layers", "n_heads",
                  "n_kv_heads", "head_dim", "ffn", "rope_theta",
                  "norm_eps", "max_seq", "n_experts", "moe_top_k"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.num_params() == jc.num_params()
        assert tc.dtype == torch.bfloat16 and tc.param_dtype == torch.float32
    assert tl.config("8b", n_layers=2).n_layers == 2


@pytest.mark.parametrize("preset", ["debug", "debug_moe", "tiny"])
def test_init_params_tree_matches_jax(preset):
    """Same names, stacked layer-major layout, (in, out) orientation and
    storage dtype; the numbers come from another generator."""
    jcfg, tcfg = jl.config(preset), tl.config(preset)
    jp = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    tp = tl.init_params(tcfg, gen)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == torch.float32, path
        assert a.dtype == np.float32, path
        if path.endswith(("ln1", "ln2", "final_norm")):
            assert torch.all(b == 1)
        else:
            # same 1/sqrt(fan_in) scale as the JAX initializer
            assert abs(float(b.std()) - float(a.std())) < 0.2 * float(a.std())
    walk(jp, tp)
    again = tl.init_params(tcfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["lm_head"], tp["lm_head"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", PRESETS)
def test_params_from_numpy(preset, dtype):
    """Conversion keeps every value: matrices in the compute dtype (the
    one-time cast equals the JAX forward's per-call .astype), lm_head
    float32, norms in storage dtype."""
    jcfg = jl.config(preset)
    tcfg = tl.config(preset, dtype=getattr(torch, dtype))
    jp = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_numpy(jp, tcfg, "cpu")
    dt = getattr(jnp, dtype)
    for name in ("wq", "wk", "wv", "wo", "wi", "wg", "wd"):
        ref = np.asarray(jnp.asarray(jp["layers"][name]).astype(dt)
                         .astype(jnp.float32))
        assert tp["layers"][name].dtype == tcfg.dtype
        np.testing.assert_array_equal(tp["layers"][name].float().numpy(),
                                      ref)
    ref = np.asarray(jnp.asarray(jp["embed"]).astype(dt).astype(jnp.float32))
    np.testing.assert_array_equal(tp["embed"].float().numpy(), ref)
    assert tp["lm_head"].dtype == torch.float32
    np.testing.assert_array_equal(tp["lm_head"].numpy(), jp["lm_head"])
    np.testing.assert_array_equal(tp["final_norm"].numpy(), jp["final_norm"])
    np.testing.assert_array_equal(tp["layers"]["ln1"].numpy(),
                                  jp["layers"]["ln1"])


def test_pools_from_numpy_keeps_bf16_values():
    rng = np.random.default_rng(4)
    k = jnp.asarray(rng.normal(size=(2, 5, 4, 2, 8)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(2, 5, 4, 2, 8)), jnp.bfloat16)
    tk, tv = pools_from_numpy(np.asarray(k), np.asarray(v), device="cpu")
    assert tk.dtype == torch.bfloat16 and tk.shape == (2, 5, 4, 2, 8)
    np.testing.assert_array_equal(
        tk.float().numpy(), np.asarray(k.astype(jnp.float32)))
    np.testing.assert_array_equal(
        tv.float().numpy(), np.asarray(v.astype(jnp.float32)))
