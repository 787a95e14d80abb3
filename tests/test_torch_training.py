"""ray_tpu_torch's training path against ray_tpu's: llama.forward /
loss_fn and their gradients, the optimizer, and TrainStepBundle.

The same numpy parameters and tokens go through the JAX functions (CPU,
flash attention through the Pallas kernels in interpret mode) and the
port (CPU: the flash kernels' plain versions). Float32 configs, as the
point is the algorithm. Tolerances, each with its reason:
  - logits and loss rtol 1e-5, gradients atol 1e-6: both sides run the
    same float32 operations, summed in other orders (measured: ~1e-7);
  - optimizer parameters atol 1e-6 (float32 arithmetic in another
    association, one rounding per op);
  - parameters after three TrainStepBundle steps: Adam's update
    m / (sqrt(v) + 1e-8) turns a float32 gradient rounding on an element
    whose gradient is near zero into an update of another size, so a
    few elements move differently; 99.9% of elements agree to 1e-6 and
    every element to a quarter of the learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import training as jtr
from ray_tpu.parallel import MeshSpec
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as ttr
from ray_tpu_torch.models.weights import train_params_from_numpy

torch.set_num_threads(2)

IMPLS = {"xla": "xla", "pallas": "pallas_interpret"}   # port -> JAX


def _configs(preset, impl, **kw):
    jc = jl.config(preset, dtype=jnp.float32, attention_impl=IMPLS[impl],
                   **kw)
    tc = tl.config(preset, dtype=torch.float32, attention_impl=impl, **kw)
    return jc, tc


def _params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jl.init_params(jc, jax.random.PRNGKey(seed)))


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


@pytest.mark.parametrize("preset,impl", [("debug", "xla"),
                                         ("debug", "pallas"),
                                         ("tiny", "pallas")])
def test_forward_logits_match_jax(preset, impl):
    jc, tc = _configs(preset, impl)
    p = _params(jc)
    toks = _tokens(jc.vocab_size, 2, 64)
    ref = np.asarray(jl.forward(jc, p, jnp.asarray(toks)))
    out = tl.forward(tc, train_params_from_numpy(p, tc, "cpu"),
                     torch.from_numpy(toks))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


# preset, impl, S, loss_chunk, remat, masked
LOSS_CASES = [
    ("debug", "xla", 64, 16, True, False),     # chunked (4 chunks)
    ("debug", "xla", 60, 16, True, False),     # awkward S: chunk 15
    ("debug", "xla", 64, 0, True, False),      # unchunked
    ("debug", "xla", 64, 16, False, True),     # no remat, with a mask
    ("debug", "pallas", 64, 16, True, False),
    ("tiny", "xla", 64, 16, True, False),
    ("tiny", "pallas", 64, 32, True, False),
]


@pytest.mark.parametrize("preset,impl,s,chunk,remat,masked", LOSS_CASES,
                         ids=[f"{c[0]}_{c[1]}_s{c[2]}_chunk{c[3]}_"
                              f"remat{int(c[4])}_mask{int(c[5])}"
                              for c in LOSS_CASES])
def test_loss_and_grads_match_jax(preset, impl, s, chunk, remat, masked):
    jc, tc = _configs(preset, impl, loss_chunk=chunk, remat=remat)
    p = _params(jc, seed=1)
    toks = _tokens(jc.vocab_size, 2, s, seed=1)
    mask = None
    if masked:
        mask = np.ones((2, s), np.int32)
        mask[0, s // 2:] = 0

    def f(params):
        return jl.loss_fn(jc, params, jnp.asarray(toks),
                          mask=None if mask is None else jnp.asarray(mask))
    (loss_j, met_j), g_j = jax.value_and_grad(f, has_aux=True)(p)
    tp = train_params_from_numpy(p, tc, "cpu")
    loss_t, met_t = tl.loss_fn(
        tc, tp, torch.from_numpy(toks),
        mask=None if mask is None else torch.from_numpy(mask))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for k in ("loss", "tokens", "ppl_proxy"):
        np.testing.assert_allclose(met_t[k].item(), float(met_j[k]),
                                   rtol=1e-5, err_msg=k)
    for path, gj, pt in _pairs(g_j, tp):
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj),
                                   atol=1e-6, rtol=0, err_msg=path)


@pytest.mark.parametrize("s,chunk", [(64, 16), (60, 16), (61, 16), (64, 0),
                                     (64, 512), (2048, 512), (2047, 512)])
def test_loss_chunk_rule_matches_jax(s, chunk, monkeypatch):
    """The chunk is the largest divisor of S within loss_chunk: count the
    head calls the port makes and compare with the JAX rule."""
    c = min(chunk, s) if chunk else 0
    while c > 1 and s % c:
        c -= 1
    want = s // c if (c and s > c) else 1
    tc = tl.config("debug", dtype=torch.float32, loss_chunk=chunk,
                   n_layers=1, vocab_size=16, hidden=8, n_heads=1,
                   n_kv_heads=1, head_dim=8, ffn=8, max_seq=4096)
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(tc, gen, "cpu")
    calls = []
    real = tl._head_logits
    monkeypatch.setattr(tl, "_head_logits",
                        lambda *a: calls.append(a[1].shape[1]) or real(*a))
    with torch.no_grad():
        tl.loss_fn(tc, params, torch.zeros((1, s), dtype=torch.int32))
    assert len(calls) == want
    assert sum(calls) == s


def test_head_logits_bf16_operands_give_f32_logits():
    """bf16 operands, float32 output: the same numbers as the JAX einsum
    with preferred_element_type=float32 (exact products of bf16 values,
    float32 sums)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    jc = jl.config("debug")
    tc = tl.config("debug")
    ref = np.asarray(jl._head_logits(jc, jnp.asarray(x), jnp.asarray(w)))
    out = tl._head_logits(tc, torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_flops_per_token_matches_jax():
    for name in ("debug", "tiny", "1b", "8b", "debug_moe", "8x7b"):
        assert tl.flops_per_token(tl.config(name), 2048) == \
            jl.flops_per_token(jl.config(name), 2048)
    assert tl.config("8b").num_params() == jl.config("8b").num_params()


def test_moe_and_sequence_parallel_attention_raise():
    tc = tl.config("debug_moe", dtype=torch.float32)
    params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.loss_fn(tc, params, torch.zeros((1, 8), dtype=torch.int32))
    for impl in ("ring", "ulysses"):
        tc = tl.config("debug", dtype=torch.float32, attention_impl=impl)
        params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.loss_fn(tc, params, torch.zeros((1, 8), dtype=torch.int32))


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 10), (2, 100),
                                          (5, 20), (3, 3)])
def test_schedule_matches_optax(warmup, total):
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                             max(total, warmup + 1))
    opt = ttr.default_optimizer(learning_rate=3e-4, warmup_steps=warmup,
                                total_steps=total)
    for count in range(0, total + 5):
        np.testing.assert_allclose(opt.schedule(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)
    if warmup:
        assert opt.schedule(0) == 0.0


def _tree(rng, scale):
    return {"a": (rng.normal(size=(16, 8)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(10,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 3, 4)) * scale).astype(
                      np.float32)}}


@pytest.mark.parametrize("grad_scale", [0.01, 1.0],
                         ids=["unclipped", "clipped"])
def test_optimizer_matches_optax_chain(grad_scale):
    """default_optimizer against the JAX package's optax chain, four
    updates through warmup into the cosine decay. grad_scale 1.0 puts
    the global norm above the clip (1.0); 0.01 below it."""
    rng = np.random.default_rng(4)
    p = _tree(rng, 1.0)
    grads = [_tree(rng, grad_scale) for _ in range(4)]
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    jopt = jtr.default_optimizer(**kw)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    sj = jopt.init(pj)
    topt = ttr.default_optimizer(**kw)
    pt = jax.tree_util.tree_map(torch.tensor, p)
    st = topt.init(pt)
    for i, g in enumerate(grads):
        norm = float(optax.global_norm(g))
        assert (norm > 1.0) == (grad_scale == 1.0)
        u, sj = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, u)
        st = topt.update_([torch.tensor(x) for x in
                           jax.tree_util.tree_leaves(g)], st, pt)
        assert st["count"] == i + 1
        for path, a, b in _pairs(jax.tree_util.tree_map(np.asarray, pj),
                                 pt):
            np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=0,
                                       err_msg=f"step {i} {path}")
        if i == 0:   # lr 0 at count 0: the first step changes nothing
            for path, a, b in _pairs(p, pt):
                np.testing.assert_array_equal(b.numpy(), a)


def test_optimizer_mu_dtype_bf16_matches_optax():
    """First moment stored in bf16. Both sides compute the step in
    float32 and store mu rounded to bf16; XLA's fusion and torch round a
    few elements one bf16 ulp apart, so parameters agree to 3% of one
    step's lr (measured: 1.6e-4 after four steps at lr 1e-2)."""
    rng = np.random.default_rng(5)
    p = _tree(rng, 1.0)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    jopt = jtr.default_optimizer(mu_dtype=jnp.bfloat16, **kw)
    topt = ttr.default_optimizer(mu_dtype=torch.bfloat16, **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    sj = jopt.init(pj)
    pt = jax.tree_util.tree_map(torch.tensor, p)
    st = topt.init(pt)
    assert all(m.dtype == torch.bfloat16 for _, _, m in
               _pairs(p, st["mu"]))
    for _ in range(4):
        g = _tree(rng, 0.01)
        u, sj = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, u)
        st = topt.update_([torch.tensor(x) for x in
                           jax.tree_util.tree_leaves(g)], st, pt)
    for path, a, b in _pairs(jax.tree_util.tree_map(np.asarray, pj), pt):
        np.testing.assert_allclose(b.numpy(), a, atol=3e-4, rtol=0,
                                   err_msg=path)


# ---------------------------------------------------------- train bundle

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_train_step_bundle_matches_jax_bundle(impl):
    """Three steps (warmup_steps=1: the first at lr 0) of the port's
    bundle from the JAX bundle's initial parameters, against the JAX
    bundle on a one-device CPU mesh: loss and grad_norm at every step,
    every parameter leaf after the third."""
    jc, tc = _configs("debug", impl, loss_chunk=16)
    mesh = MeshSpec(dp=1, fsdp=1, sp=1, tp=1).build([jax.devices()[0]])
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jb = jtr.TrainStepBundle(jc, mesh,
                             optimizer=jtr.default_optimizer(**kw))
    st = jb.init_state(0)
    p0 = jax.tree_util.tree_map(np.asarray, st[0])
    toks = _tokens(jc.vocab_size, 2, 64, seed=2)
    jt = jb.shard_batch(jnp.asarray(toks))
    tb = ttr.TrainStepBundle(tc, "cpu", optimizer=ttr.default_optimizer(**kw))
    ts = tb.state_from_numpy(p0)
    tt = tb.shard_batch(toks)
    assert tt.dtype == torch.int32 and tt.device.type == "cpu"
    for i in range(3):
        st, mj = jb.step(st, jt)
        ts, mt = tb.step(ts, tt)
        assert set(mt) == set(mj) == {"loss", "tokens", "ppl_proxy",
                                      "grad_norm"}
        for k in mj:
            assert mt[k].dim() == 0
            np.testing.assert_allclose(mt[k].item(), float(mj[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        if i == 0:
            for path, a, b in _pairs(p0, ts[0]):
                np.testing.assert_array_equal(b.detach().numpy(), a,
                                              err_msg=path)
    lr = kw["learning_rate"]
    pj = jax.tree_util.tree_map(np.asarray, st[0])
    for path, a, b in _pairs(pj, ts[0]):
        d = np.abs(b.detach().numpy() - a)
        assert np.mean(d > 1e-6) < 1e-3, (path, np.mean(d > 1e-6))
        assert d.max() < 0.25 * lr, (path, d.max())
    assert ts[1]["count"] == 3
    ev = tb.eval_loss(ts, tt)
    evj = jb.eval_loss(st, jt)
    np.testing.assert_allclose(ev["loss"].item(), float(evj["loss"]),
                               rtol=1e-5)


def test_train_params_from_numpy_keeps_storage_dtype():
    tc = tl.config("debug")                 # bf16 compute, f32 storage
    p = _params(jl.config("debug"))
    tp = train_params_from_numpy(p, tc, "cpu")
    for path, a, b in _pairs(p, tp):
        assert b.dtype == torch.float32 and b.requires_grad and b.is_leaf
        np.testing.assert_array_equal(b.detach().numpy(), a)


def test_bf16_train_step_on_cpu_runs_and_learns():
    """The default bf16-compute config: finite metrics and a falling
    loss on a repeated batch."""
    tc = tl.config("debug", attention_impl="pallas")
    tb = ttr.TrainStepBundle(tc, "cpu", optimizer=ttr.default_optimizer(
        learning_rate=3e-3, warmup_steps=1, total_steps=20))
    state = tb.init_state(0)
    toks = tb.shard_batch(_tokens(tc.vocab_size, 2, 64, seed=3))
    losses = []
    for _ in range(4):
        state, m = tb.step(state, toks)
        assert all(torch.isfinite(v) for v in m.values())
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]


def test_bundle_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.TrainStepBundle(tl.config("debug"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.TrainStepBundle(tl.config("debug"), device="cuda")
    assert ttr.TrainStepBundle(tl.config("debug"),
                               device="cpu").device.type == "cpu"
