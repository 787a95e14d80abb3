"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention.

The same numpy inputs go through the JAX functions (CPU; the flash
kernels in Pallas interpret mode) and the port (CPU: the plain versions
of the CUDA kernels, which the wrappers run for CPU tensors). Float32
throughout, as the point is the algorithm, apart from one bf16 test at
the dtype the tensor-core kernels take. Tolerances are those of the
JAX package's own flash tests (tests/test_ops_attention.py): 2e-5 on the
forward (float32 softmax, summed in another order: blockwise online in
Pallas, dense here) and 1e-4 on the gradients (three chained float32
products).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as ta

ja = importlib.import_module("ray_tpu.ops.attention")

torch.set_num_threads(1)

FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4

# B, Sq, Sk, H, KVH, D, causal, block
CASES = [
    (2, 128, 128, 4, 4, 32, True, 64),      # GQA group 1, small blocks
    (2, 128, 128, 4, 2, 32, True, 32),      # group 2
    (1, 128, 128, 8, 2, 64, True, 64),      # group 4, D 64
    (2, 128, 128, 4, 2, 64, False, 64),     # non-causal
    (1, 64, 192, 4, 1, 32, False, 32),      # non-causal Sq < Sk
    (1, 192, 64, 4, 2, 64, False, 64),      # non-causal Sq > Sk
    (1, 96, 96, 4, 4, 32, True, 32),        # causal, 3 blocks a side
]
IDS = [f"b{c[0]}_sq{c[1]}_sk{c[2]}_h{c[3]}_kvh{c[4]}_d{c[5]}_"
       f"{'causal' if c[6] else 'full'}_blk{c[7]}" for c in CASES]


def _qkv(b, sq, sk, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,blk", CASES, ids=IDS)
def test_flash_forward_plain_matches_pallas_interpret(b, sq, sk, h, kvh, d,
                                                      causal, blk):
    q, k, v, _ = _qkv(b, sq, sk, h, kvh, d)
    out_j, res = ja._flash_fwd_rule(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, None, blk, blk,
                                    True)
    out_t, lse_t = ta.flash_forward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, d ** -0.5)
    assert lse_t.shape == res[4].shape == (b * h, sq, 1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(res[4]),
                               atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,blk", CASES, ids=IDS)
def test_flash_backward_plain_matches_pallas_interpret(b, sq, sk, h, kvh, d,
                                                       causal, blk):
    """The backward kernels' plain versions against the Pallas dq and
    dk/dv kernels, on the same forward residuals."""
    q, k, v, do = _qkv(b, sq, sk, h, kvh, d, seed=1)
    _, res = ja._flash_fwd_rule(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, None, blk, blk, True)
    g_j = ja._flash_bwd_rule(causal, None, blk, blk, True, res,
                             jnp.asarray(do))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out_t, lse_t = ta.flash_forward_plain(*t, causal, d ** -0.5)
    g_t = ta.flash_backward_plain(*t, out_t, lse_t, torch.from_numpy(do),
                                  causal, d ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,blk", CASES, ids=IDS)
def test_flash_attention_grad_matches_jax_grad(b, sq, sk, h, kvh, d, causal,
                                               blk):
    """Through the autograd Function: jax.grad of sum(out**2) with the
    Pallas kernels in interpret mode, against torch autograd."""
    q, k, v, _ = _qkv(b, sq, sk, h, kvh, d, seed=2)

    def loss_j(q, k, v):
        return jnp.sum(ja.flash_attention(q, k, v, causal, None, blk, blk,
                                          True) ** 2)

    val_j, g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    val_t = (ta.flash_attention(*t, causal, None, blk, blk) ** 2).sum()
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    for name, a, r in zip(("dq", "dk", "dv"), t, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative: 8 significant bits
BF16_CASES = [(1, 128, 128, 4, 2, 64, True, 64),
              (1, 64, 192, 4, 1, 128, False, 32)]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,blk", BF16_CASES,
                         ids=["causal_d64", "full_sq64_sk192_d128"])
def test_flash_plain_matches_pallas_interpret_bf16(b, sq, sk, h, kvh, d,
                                                   causal, blk):
    """bf16 inputs, the dtype the tensor-core kernels take: the plain
    versions against the Pallas forward and backward in interpret mode.
    Both upcast to float32, compute in float32 and round each output to
    bf16 once, so the outputs agree to one bf16 ulp of the output
    (relative 2^-7) plus the float32 atol (FWD_ATOL, GRAD_ATOL: sums in
    another order). The backward runs on the Pallas forward's residuals
    (its bf16 out and float32 lse), so each side differs only in its
    own kernel."""
    q, k, v, do = (x.astype(jnp.bfloat16) for x in _qkv(b, sq, sk, h, kvh,
                                                        d, seed=7))
    out_j, res = ja._flash_fwd_rule(q, k, v, causal, None, blk, blk, True)
    g_j = ja._flash_bwd_rule(causal, None, blk, blk, True, res, do)

    def tt(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    t = [tt(x) for x in (q, k, v)]
    out_t, lse_t = ta.flash_forward_plain(*t, causal, d ** -0.5)
    assert out_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=FWD_ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(res[4]),
                               atol=FWD_ATOL, rtol=0)
    g_t = ta.flash_backward_plain(*t, tt(out_j), torch.from_numpy(
        np.array(res[4])), tt(do), causal, d ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv"), g_t, g_j):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=BF16_ULP, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal,offsets", [(True, (0, 0)), (False, (0, 0)),
                                            (True, (64, 32))])
def test_reference_attention_matches_jax(causal, offsets):
    q, k, v, _ = _qkv(2, 48, 80, 4, 2, 32, seed=3)
    ref = ja.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, *offsets)
    out = ta.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal, *offsets)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6,
                               rtol=0)


def test_reference_attention_bf16_keeps_dtype_and_matches_jax():
    """bf16 inputs: float32 logits and softmax, bf16 probabilities into
    the value product; both sides round the same float32 numbers to
    bf16 once, so they agree to one bf16 ulp (7.8e-3 at |x| < 2)."""
    q, k, v, _ = _qkv(1, 64, 64, 4, 2, 32, seed=4)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = ja.reference_attention(qb, kb, vb, True)
    out = ta.reference_attention(
        *(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
          for x in (qb, kb, vb)), True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=8e-3, rtol=0)


def test_repeat_kv_matches_jax():
    _, k, _, _ = _qkv(2, 8, 8, 8, 2, 16)
    np.testing.assert_array_equal(
        ta._repeat_kv(torch.from_numpy(k), 8).numpy(),
        np.asarray(ja._repeat_kv(jnp.asarray(k), 8)))


@pytest.mark.parametrize("limit", [8, 64, 128, 512])
def test_pick_and_resolve_blocks_match_jax(limit):
    for s in list(range(0, 300)) + [1000, 2048, 4096, 8190]:
        assert ta._pick_block(limit, s) == ja._pick_block(limit, s), s
    for sq, sk in [(7, 64), (64, 13), (2048, 2048), (96, 40)]:
        try:
            want = ja._resolve_blocks(sq, sk, limit, limit)
        except ValueError as e:
            with pytest.raises(ValueError, match="multiple of 8"):
                ta._resolve_blocks(sq, sk, limit, limit)
            assert "impl='xla'" in str(e)
        else:
            assert ta._resolve_blocks(sq, sk, limit, limit) == want


def test_flash_attention_raises_on_awkward_lengths():
    q = torch.zeros((1, 12, 2, 64))
    k = torch.zeros((1, 12, 2, 64))
    with pytest.raises(ValueError, match="multiple of 8"):
        ta.flash_attention(q, k, k)


def test_auto_impl_rules():
    # on CUDA: flash where the JAX dispatcher would take Pallas on a TPU
    assert ta.auto_impl("cuda", 2048, 2048, 128) == "pallas"
    assert ta.auto_impl("cuda", 256, 256, 64) == "pallas"
    assert ta.auto_impl("cuda", 128, 384, 128) == "pallas"
    # awkward shapes: resolved blocks under 128, no block, small head dim
    assert ta.auto_impl("cuda", 64, 64, 128) == "xla"
    assert ta.auto_impl("cuda", 2048, 1016, 128) == "xla"   # bk = 8
    assert ta.auto_impl("cuda", 2047, 2047, 128) == "xla"
    assert ta.auto_impl("cuda", 2048, 2048, 32) == "xla"
    # a head dim the kernels do not take goes to the reference
    assert ta.auto_impl("cuda", 2048, 2048, 96) == "xla"
    # the CPU always takes the reference
    assert ta.auto_impl("cpu", 2048, 2048, 128) == "xla"


def test_dispatcher_paths_on_cpu(monkeypatch):
    q, k, v, _ = _qkv(1, 128, 128, 4, 2, 64, seed=5)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    calls = []
    real_fwd = ta.flash_forward_plain
    monkeypatch.setattr(ta, "flash_forward_plain",
                        lambda *a: calls.append("flash") or real_fwd(*a))
    real_ref = ta.reference_attention
    monkeypatch.setattr(ta, "reference_attention",
                        lambda *a, **kw: calls.append("ref")
                        or real_ref(*a, **kw))
    outs = {}
    for impl in ("auto", "xla", "pallas", "pallas_interpret"):
        calls.clear()
        outs[impl] = ta.attention(*t, causal=True, impl=impl)
        want = "ref" if impl in ("auto", "xla") else "flash"
        assert calls == [want], (impl, calls)
    for impl in ("pallas", "pallas_interpret"):
        np.testing.assert_allclose(outs[impl].numpy(), outs["xla"].numpy(),
                                   atol=FWD_ATOL)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ta.attention(*t, impl=impl)
    with pytest.raises(ValueError, match="unknown"):
        ta.attention(*t, impl="nope")


def test_flash_wrappers_take_plain_path_only_on_cpu():
    q = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ta.flash_forward(q, q, q, True, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        ta.flash_backward(q, q, q, q, q, q, True, 0.125)


def test_flash_attention_bf16_on_cpu_keeps_dtypes():
    q, k, v, _ = _qkv(1, 64, 64, 4, 2, 64, seed=6)
    t = [torch.from_numpy(x).bfloat16().requires_grad_(True)
         for x in (q, k, v)]
    out = ta.flash_attention(*t, True)
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 for x in t)
