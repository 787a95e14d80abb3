"""ray_tpu_torch's padded-batch prefill forwards against ray_tpu's.

`prefill` (whole prompts) and `prefill_chunk` (a chunk over cached
context), the forwards of the legacy engine step and of speculative
decoding, through the JAX functions and the port's on the same numpy
parameters, pools and tables: every `emit`, a LoRA index, `ctx_pages`
of -1 and of a bucket, the reference's attention rule (dense by
default, the flash kernel's plain version against Pallas interpret
mode), and the pools after the in-place writes compared row for row
(the scratch page aside: padding rows land there in any order). Then
`chunk_attention_on_gathered` and `paged_attention` against the JAX
functions.

Tolerances: float32 1e-4 (the same float32 products summed in another
order through a few layers); bfloat16 as tests/test_torch_llama_infer.py
(5e-2 on logits; pools within 4e-2 absolute or 1.6e-2 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import llama_infer as jli
from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_infer as tli
from ray_tpu_torch.models.weights import params_from_numpy, pools_from_numpy
from ray_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)

PAGE, NUM_PAGES, MAX_PAGES, SLOTS = 4, 40, 8, 3
TOLS = {"float32": dict(out=(1e-4, 1e-4), pools=(1e-4, 1e-4)),
        "bfloat16": dict(out=(5e-2, 5e-2), pools=(4e-2, 1.6e-2))}
# (start, chunk_lens) of each row: a fresh chunk, a chunk over 5 cached
# tokens, an empty chunk over 7, a short chunk over 13
CHUNK_ROWS = [(0, 6), (5, 3), (7, 0), (13, 4)]
CHUNK = 8


def _setup(dtype="float32", attention_impl="auto"):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jl.config("debug", dtype=jdt, attention_impl=attention_impl)
    tcfg = tl.config("debug", dtype=tdt, attention_impl=attention_impl)
    params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    shape = (jcfg.n_layers, NUM_PAGES, PAGE, jcfg.n_kv_heads,
             jcfg.head_dim)
    k = np.asarray(jnp.asarray(rng.normal(size=shape), jdt))
    v = np.asarray(jnp.asarray(rng.normal(size=shape), jdt))
    tables = rng.permutation(NUM_PAGES - 1)[:4 * MAX_PAGES].reshape(
        4, MAX_PAGES).astype(np.int32)
    return jcfg, tcfg, params, k, v, tables, rng


def _stacks(jcfg, rng, r=3):
    """Gather-layout stacks for wq/wk/wv/wo (slot 0 zero), as the JAX
    engine keeps them, and the port's concatenated layout."""
    dims = {"wq": (jcfg.hidden, jcfg.q_dim),
            "wk": (jcfg.hidden, jcfg.kv_dim),
            "wv": (jcfg.hidden, jcfg.kv_dim),
            "wo": (jcfg.q_dim, jcfg.hidden)}
    jst, tst = {}, {}
    for p, (i, o) in dims.items():
        a = rng.normal(0, 0.1, (jcfg.n_layers, SLOTS, i, r))
        b = rng.normal(0, 0.1, (jcfg.n_layers, SLOTS, r, o))
        a[:, 0] = 0.0
        b[:, 0] = 0.0
        a, b = a.astype(np.float32), b.astype(np.float32)
        jst[p] = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
        ac, bc = tli.lora_cat(a, b)
        tst[p] = {"a": torch.from_numpy(np.ascontiguousarray(ac)),
                  "b": torch.from_numpy(np.ascontiguousarray(bc)), "r": r}
    return jst, tst


def _port(tcfg, params, k, v):
    kt, vt = pools_from_numpy(k, v, device="cpu")
    return params_from_numpy(params, tcfg, "cpu"), kt, vt


def _close(out_t, kt, vt, out_j, kj, vj, dtype):
    a, r = TOLS[dtype]["out"]
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(jnp.asarray(out_j, jnp.float32)),
                               atol=a, rtol=r)
    a, r = TOLS[dtype]["pools"]
    f = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
    for t, j in ((kt, kj), (vt, vj)):
        np.testing.assert_allclose(t.float().numpy()[:, :-1], f(j)[:, :-1],
                                   atol=a, rtol=r)


def _lora_args(jcfg, rng, with_lora, b):
    if not with_lora:
        return {}, {}
    jst, tst = _stacks(jcfg, rng)
    idx = np.asarray([1, 2, 0, 1][:b], np.int32)
    return (dict(lora=jst, lora_idx=jnp.asarray(idx)),
            dict(lora=tst, lora_idx=torch.from_numpy(idx)))


@pytest.mark.parametrize("dtype,emit,with_lora,attention_impl", [
    ("float32", "logits", False, "auto"),
    ("float32", "hidden", False, "auto"),
    ("float32", "logits", True, "auto"),
    ("float32", "hidden", True, "auto"),
    ("bfloat16", "logits", False, "auto"),
    ("float32", "logits", False, "pallas_interpret"),
])
def test_prefill_matches_jax(dtype, emit, with_lora, attention_impl):
    jcfg, tcfg, params, k, v, tables, rng = _setup(dtype, attention_impl)
    b, s = 3, 16
    true_lens = np.asarray([16, 9, 1], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jl_kw, tl_kw = _lora_args(jcfg, rng, with_lora, b)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out_j, kj, vj = jli.prefill(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(true_lens),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables[:b]), emit=emit,
        **jl_kw)
    tp, kt, vt = _port(tcfg, params, k, v)
    out_t, kt2, vt2 = tli.prefill(
        tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(true_lens), kt,
        vt, torch.from_numpy(tables[:b]), emit=emit, **tl_kw)
    assert kt2 is kt and vt2 is vt                  # written in place
    want = (b, tcfg.vocab_size) if emit == "logits" else (b, s, tcfg.hidden)
    assert tuple(out_t.shape) == want
    if emit == "logits":
        assert out_t.dtype == torch.float32
    _close(out_t, kt, vt, out_j, kj, vj, dtype)
    # each row's KV landed at its own pages, and only its valid rows
    kf = kt.float().numpy()
    for row, n in enumerate(true_lens):
        for pos in range(MAX_PAGES * PAGE):
            page, off = tables[row, pos // PAGE], pos % PAGE
            same = np.array_equal(kf[:, page, off], k[:, page, off].astype(
                np.float32))
            assert same == (pos >= n), (row, pos)


def _chunk_inputs(jcfg, rng):
    b = len(CHUNK_ROWS)
    tokens = rng.integers(0, jcfg.vocab_size, (b, CHUNK)).astype(np.int32)
    start = np.asarray([s for s, _ in CHUNK_ROWS], np.int32)
    lens = np.asarray([n for _, n in CHUNK_ROWS], np.int32)
    return tokens, start, lens


@pytest.mark.parametrize("dtype,emit,ctx_pages,with_lora", [
    ("float32", "logits", -1, False),
    ("float32", "logits_all", -1, False),
    ("float32", "hidden", -1, False),
    ("float32", "logits", 4, False),
    ("float32", "logits_all", 4, False),
    ("float32", "hidden", 4, False),
    ("float32", "logits", 4, True),
    ("float32", "logits_all", -1, True),
    ("bfloat16", "logits_all", 4, False),
])
def test_prefill_chunk_matches_jax(dtype, emit, ctx_pages, with_lora):
    """ctx_pages 4 covers the largest start (13 tokens, pages of 4)."""
    jcfg, tcfg, params, k, v, tables, rng = _setup(dtype)
    tokens, start, lens = _chunk_inputs(jcfg, rng)
    b = len(CHUNK_ROWS)
    jl_kw, tl_kw = _lora_args(jcfg, rng, with_lora, b)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out_j, kj, vj = jli.prefill_chunk(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(lens), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), ctx_pages=ctx_pages, emit=emit, **jl_kw)
    tp, kt, vt = _port(tcfg, params, k, v)
    out_t, _, _ = tli.prefill_chunk(
        tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(start),
        torch.from_numpy(lens), kt, vt, torch.from_numpy(tables),
        ctx_pages=ctx_pages, emit=emit, **tl_kw)
    want = {"logits": (b, tcfg.vocab_size),
            "logits_all": (b, CHUNK, tcfg.vocab_size),
            "hidden": (b, CHUNK, tcfg.hidden)}[emit]
    assert tuple(out_t.shape) == want
    assert torch.isfinite(out_t).all()
    _close(out_t, kt, vt, out_j, kj, vj, dtype)


def test_prefill_chunk_continues_prefill():
    """A prompt prefilled whole and one prefilled as a prefix plus a
    chunk over it agree: same pools, same last-token logits."""
    jcfg, tcfg, params, k, v, tables, rng = _setup()
    tp, kt, vt = _port(tcfg, params, k, v)
    _, k2, v2 = _port(tcfg, params, k, v)
    n, cut = 14, 9
    prompt = rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
    table = torch.from_numpy(tables[:1])
    whole, _, _ = tli.prefill(tcfg, tp, torch.from_numpy(prompt[None]),
                              torch.tensor([n], dtype=torch.int32), kt, vt,
                              table)
    tli.prefill(tcfg, tp, torch.from_numpy(prompt[None, :cut]),
                torch.tensor([cut], dtype=torch.int32), k2, v2, table)
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :n - cut] = prompt[cut:]
    last, _, _ = tli.prefill_chunk(
        tcfg, tp, torch.from_numpy(chunk),
        torch.tensor([cut], dtype=torch.int32),
        torch.tensor([n - cut], dtype=torch.int32), k2, v2, table,
        ctx_pages=3)
    np.testing.assert_allclose(last.numpy(), whole.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(k2.numpy()[:, :-1], kt.numpy()[:, :-1],
                               atol=1e-5, rtol=1e-5)


def test_prefill_rejects_unknown_emit():
    jcfg, tcfg, params, k, v, tables, rng = _setup()
    tp, kt, vt = _port(tcfg, params, k, v)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="emit"):
        tli.prefill(tcfg, tp, one[None], one, kt, vt,
                    torch.from_numpy(tables[:1]), emit="logits_all")
    with pytest.raises(ValueError, match="emit"):
        tli.prefill_chunk(tcfg, tp, one[None], one, one, kt, vt,
                          torch.from_numpy(tables[:1]), emit="probs")


# ------------------------------------------------------- attention ops

@pytest.mark.parametrize("h,kvh,c,ctx", [(4, 2, 5, 12), (8, 8, 3, 9),
                                         (8, 1, 6, 0)])
def test_chunk_attention_on_gathered_matches_jax(h, kvh, c, ctx):
    rng = np.random.default_rng(h * 100 + c)
    b, d = 4, 16
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    k_ctx = rng.normal(size=(b, ctx, kvh, d)).astype(np.float32)
    v_ctx = rng.normal(size=(b, ctx, kvh, d)).astype(np.float32)
    k_chk = rng.normal(size=(b, c, kvh, d)).astype(np.float32)
    v_chk = rng.normal(size=(b, c, kvh, d)).astype(np.float32)
    # a row with no key at all (start 0, chunk_lens 0) comes out NaN in
    # both; every other row has at least its own chunk key
    start = np.asarray([0, min(3, ctx), ctx, 0], np.int32)
    lens = np.asarray([c, 1, c - 1, 0], np.int32)
    ref = np.asarray(jpa.chunk_attention_on_gathered(
        *(jnp.asarray(a) for a in (q, k_ctx, v_ctx, k_chk, v_chk, start,
                                   lens))))
    out = tpa.chunk_attention_on_gathered(
        *(torch.from_numpy(a) for a in (q, k_ctx, v_ctx, k_chk, v_chk,
                                        start, lens))).numpy()
    assert out.shape == (b, c, h, d)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out[3]).all() and not np.isnan(out[:3]).any()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,kvh", [(4, 2), (8, 8)])
def test_paged_attention_matches_jax(h, kvh):
    rng = np.random.default_rng(h)
    L, P, page, d, b, maxp = 3, 12, 4, 16, 3, 3
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(L, P, page, kvh, d)).astype(np.float32)
    v = rng.normal(size=(L, P, page, kvh, d)).astype(np.float32)
    tables = rng.permutation(P - 1)[:b * maxp].reshape(b, maxp).astype(
        np.int32)
    lens = np.asarray([1, 7, 12], np.int32)
    for layer in range(L):
        ref = np.asarray(jpa.paged_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(lens), layer))
        out = tpa.paged_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tables), torch.from_numpy(lens), layer).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
