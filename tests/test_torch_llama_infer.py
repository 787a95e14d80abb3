"""ray_tpu_torch.models.llama_infer against ray_tpu.models.llama_infer.

One mixed ragged tick (decode rows over cached context, a fresh chunk,
a chunk over context, padding rows) and one decode step, through the
JAX gather implementation and the port's "gather" and "kernel" impls
(on the CPU the kernel impl runs the kernels' plain versions, with the
kernel path's segment map, new-token merge and table handling). Logits
and both pools after the in-place scatter are compared.

Tolerances: float32 1e-4 (the same float32 products summed in another
order through a few layers); bfloat16 — bf16 rounds at other places in
the two frameworks (matmul outputs, attention outputs), so logits agree
to 5e-2, and pool entries to 2 bf16 ulps (1.6e-2 relative) or 4e-2
absolute where a first-layer rounding difference reaches a later
layer's K/V.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import llama_infer as jli
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_infer as tli
from ray_tpu_torch.models.weights import params_from_numpy, pools_from_numpy

torch.set_num_threads(1)

PAGE, NUM_PAGES, MAX_PAGES = 4, 40, 8
TOLS = {"float32": dict(logits=(1e-4, 1e-4), pools=(1e-4, 1e-4)),
        "bfloat16": dict(logits=(5e-2, 5e-2), pools=(4e-2, 1.6e-2))}


def _setup(dtype, preset="debug"):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jl.config(preset, dtype=jdt)
    tcfg = tl.config(preset, dtype=tdt)
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


def _compare(logits_t, kt, vt, logits_j, kj, vj, dtype):
    a, r = TOLS[dtype]["logits"]
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=a, rtol=r)
    a, r = TOLS[dtype]["pools"]
    f = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
    # the scratch page (last) takes padding rows in any order: skip it
    np.testing.assert_allclose(kt.float().numpy()[:, :-1], f(kj)[:, :-1],
                               atol=a, rtol=r)
    np.testing.assert_allclose(vt.float().numpy()[:, :-1], f(vj)[:, :-1],
                               atol=a, rtol=r)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_forward_matches_jax(dtype, impl):
    jcfg, tcfg, params, k, v, tables, rng = _setup(dtype)
    # slot: (start, n) — decode over 9 cached, fresh 6-token chunk,
    # 5-token chunk over 13 cached, decode over 2 cached; 3 padding rows
    segs = [(9, 1), (0, 6), (13, 5), (2, 1)]
    t = sum(n for _, n in segs) + 3
    tokens = np.zeros(t, np.int32)
    slot_ids = np.zeros(t, np.int32)
    positions = np.zeros(t, np.int32)
    valid = np.zeros(t, bool)
    last_idx = np.zeros(len(segs), np.int32)
    cur = 0
    for s, (st, n) in enumerate(segs):
        tokens[cur:cur + n] = rng.integers(0, jcfg.vocab_size, n)
        slot_ids[cur:cur + n] = s
        positions[cur:cur + n] = np.arange(st, st + n)
        valid[cur:cur + n] = True
        last_idx[s] = cur + n - 1
        cur += n
    start = np.asarray([s for s, _ in segs], np.int32)
    ctx_pages = 4                        # pow2 pages covering start 13
    lj, kj, vj = jli.ragged_forward(
        jcfg, params, *map(jnp.asarray, (tokens, slot_ids, positions,
                                         valid, start, last_idx, k, v,
                                         tables)),
        ctx_pages=ctx_pages, impl="gather")
    tp = params_from_numpy(params, tcfg, "cpu")
    kt, vt = pools_from_numpy(k, v, device="cpu")
    lt, kt2, vt2 = tli.ragged_forward(
        tcfg, tp, *map(torch.from_numpy, (tokens, slot_ids, positions,
                                          valid, start, last_idx)),
        kt, vt, torch.from_numpy(tables), ctx_pages=ctx_pages, impl=impl,
        max_seg_len=8)
    assert kt2 is kt and vt2 is vt
    assert lt.dtype == torch.float32 and lt.shape == (4, jcfg.vocab_size)
    _compare(lt, kt, vt, lj, kj, vj, dtype)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype, impl):
    jcfg, tcfg, params, k, v, tables, rng = _setup(dtype)
    tokens = rng.integers(0, jcfg.vocab_size, 4).astype(np.int32)
    positions = np.asarray([7, 0, 19, 31], np.int32)
    active = np.asarray([True, False, True, True])
    lj, kj, vj = jli.decode_step(
        jcfg, params, *map(jnp.asarray, (tokens, positions, k, v, tables,
                                         active)), impl="gather")
    tp = params_from_numpy(params, tcfg, "cpu")
    kt, vt = pools_from_numpy(k, v, device="cpu")
    lt, _, _ = tli.decode_step(
        tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
        kt, vt, torch.from_numpy(tables), torch.from_numpy(active),
        impl=impl)
    # the inactive row's logits are discarded by the engine, and its
    # seq_len 0 row attends one key on the kernel path (the TPU
    # multi-page kernel's rule) but none on the gather path
    rows = active if impl == "kernel" else slice(None)
    a, r = TOLS[dtype]["logits"]
    np.testing.assert_allclose(lt.numpy()[rows], np.asarray(lj)[rows],
                               atol=a, rtol=r)
    _compare(lt[torch.from_numpy(active)], kt, vt,
             np.asarray(lj)[active], kj, vj, dtype)


def test_impl_is_checked():
    _, tcfg, params, k, v, tables, _ = _setup("float32")
    tp = params_from_numpy(params, tcfg, "cpu")
    kt, vt = pools_from_numpy(k, v, device="cpu")
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tli.decode_step(tcfg, tp, z, z, kt, vt, torch.from_numpy(tables),
                        z.bool(), impl="pallas")


# ------------------------------------------------------- quantized pools

def _quant_pools(k, v, kind):
    """The JAX quantizer's (k, v, k_scales, v_scales), as numpy; fp8 pools
    as ml_dtypes arrays."""
    from ray_tpu.ops import kv_quant as jkq
    out = []
    for x in (k, v):
        q, s = jkq.quantize_rows(jnp.asarray(x), kind)
        out.append((np.asarray(q), np.asarray(s)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _torch_pool(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(a).view(np.uint8))
    return t.view(torch.int8) if a.dtype == np.int8 else \
        t.view(torch.float8_e4m3fn)


def _compare_quant(kind, lt, pools_t, lj, pools_j):
    """float32 logits at the file's tolerance; dequantized pools within one
    quantization step of JAX's (int8: the row's scale; fp8: e4m3's
    spacing at the value, times the scale), scales at 1e-5 relative. The
    scratch page (last) takes padding rows in any order: skipped."""
    a, r = TOLS["float32"]["logits"]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=a, rtol=r)
    kt, vt, kst, vst = pools_t
    kj, vj, ksj, vsj = (np.asarray(x) for x in pools_j)
    for st, sj in ((kst, ksj), (vst, vsj)):
        np.testing.assert_allclose(st.numpy()[:, :-1], sj[:, :-1],
                                   rtol=1e-5, atol=0)
    for pt, st, pj, sj in ((kt, kst, kj, ksj), (vt, vst, vj, vsj)):
        dt = (pt.float() * st[..., None]).numpy()[:, :-1]
        qj = pj.astype(np.float32)[:, :-1]
        dj = qj * sj[:, :-1, ..., None]
        if kind == "int8":
            step = np.ones_like(qj)
        else:
            mag = np.maximum(np.abs(qj), 2.0 ** -6)
            step = 2.0 ** (np.floor(np.log2(mag)) - 3)
        tol = step * sj[:, :-1, ..., None] * (1 + 1e-5)
        assert np.all(np.abs(dt - dj) <= tol)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_ragged_forward_quant_matches_jax(kind, impl):
    jcfg, tcfg, params, k, v, tables, rng = _setup("float32")
    kq, vq, ks, vs = _quant_pools(k, v, kind)
    segs = [(9, 1), (0, 6), (13, 5), (2, 1)]
    t = sum(n for _, n in segs) + 3
    tokens = np.zeros(t, np.int32)
    slot_ids = np.zeros(t, np.int32)
    positions = np.zeros(t, np.int32)
    valid = np.zeros(t, bool)
    last_idx = np.zeros(len(segs), np.int32)
    cur = 0
    for s, (st, n) in enumerate(segs):
        tokens[cur:cur + n] = rng.integers(0, jcfg.vocab_size, n)
        slot_ids[cur:cur + n] = s
        positions[cur:cur + n] = np.arange(st, st + n)
        valid[cur:cur + n] = True
        last_idx[s] = cur + n - 1
        cur += n
    start = np.asarray([s for s, _ in segs], np.int32)
    meta = (tokens, slot_ids, positions, valid, start, last_idx)
    lj, *pools_j = jli.ragged_forward(
        jcfg, params, *map(jnp.asarray, meta), jnp.asarray(kq),
        jnp.asarray(vq), jnp.asarray(tables), ctx_pages=4, impl="gather",
        kv_kind=kind, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    tp = params_from_numpy(params, tcfg, "cpu")
    pools_t = (_torch_pool(kq), _torch_pool(vq), torch.from_numpy(ks.copy()),
               torch.from_numpy(vs.copy()))
    out = tli.ragged_forward(
        tcfg, tp, *map(torch.from_numpy, meta), pools_t[0], pools_t[1],
        torch.from_numpy(tables), ctx_pages=4, impl=impl, max_seg_len=8,
        kv_kind=kind, k_scales=pools_t[2], v_scales=pools_t[3])
    assert len(out) == 5 and all(a is b for a, b in zip(out[1:], pools_t))
    _compare_quant(kind, out[0], pools_t, lj, pools_j)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_decode_step_quant_matches_jax(kind, impl):
    jcfg, tcfg, params, k, v, tables, rng = _setup("float32")
    kq, vq, ks, vs = _quant_pools(k, v, kind)
    tokens = rng.integers(0, jcfg.vocab_size, 4).astype(np.int32)
    positions = np.asarray([7, 0, 19, 31], np.int32)
    active = np.asarray([True, False, True, True])
    lj, *pools_j = jli.decode_step(
        jcfg, params, *map(jnp.asarray, (tokens, positions, kq, vq, tables,
                                         active)), impl="gather",
        kv_kind=kind, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    tp = params_from_numpy(params, tcfg, "cpu")
    pools_t = (_torch_pool(kq), _torch_pool(vq), torch.from_numpy(ks.copy()),
               torch.from_numpy(vs.copy()))
    lt, *_ = tli.decode_step(
        tcfg, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
        pools_t[0], pools_t[1], torch.from_numpy(tables),
        torch.from_numpy(active), impl=impl, kv_kind=kind,
        k_scales=pools_t[2], v_scales=pools_t[3])
    # the inactive row's logits are discarded (see test_decode_step)
    _compare_quant(kind, lt[torch.from_numpy(active)], pools_t,
                   np.asarray(lj)[active], pools_j)


def test_kv_kind_needs_its_scales():
    _, tcfg, params, k, v, tables, _ = _setup("float32")
    tp = params_from_numpy(params, tcfg, "cpu")
    kt, vt = pools_from_numpy(k, v, device="cpu")
    z = torch.zeros(4, dtype=torch.int32)
    for kind, scales in (("int8", {}), ("f32", dict(k_scales=kt[..., 0],
                                                    v_scales=vt[..., 0])),
                         ("int4", {})):
        with pytest.raises(ValueError):
            tli.decode_step(tcfg, tp, z, z, kt, vt, torch.from_numpy(tables),
                            z.bool(), kv_kind=kind, **scales)
