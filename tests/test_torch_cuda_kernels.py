"""ray_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU: it carries the `cuda`
marker and skips, inside the test, without one. This file imports no
jax, so it also runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: float32 1e-4/1e-5 (same products, another summation order);
bfloat16 3e-2 absolute (both sides round one float32 result to bf16;
one bf16 ulp at |x| < 4 is 1.6e-2). Flash attention gradients in bf16:
relative 1.6e-2 (two bf16 ulps of the element: each side rounds its
float32 sum once) plus 1e-3 of the largest element (sums near zero).
"""

import pytest
import torch

from ray_tpu_torch.ops import _kernels, kv_quant
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops import ragged_paged_attention as rpa


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode "
                    "(their plain versions are tested against the JAX "
                    "package in tests/test_torch_*_attention.py)")
    return torch.device("cuda")


def _randn(gen, shape, dev, dtype):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _decode_case(dev, dtype, lens, max_pages, H, KVH, D, page=16, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    P = B * max_pages + 1
    tables = torch.randperm(P - 1, generator=gen, device=dev)[
        :B * max_pages].reshape(B, max_pages).to(torch.int32)
    return dict(
        q=_randn(gen, (B, H, D), dev, dtype),
        k=_randn(gen, (P, page, KVH, D), dev, dtype),
        v=_randn(gen, (P, page, KVH, D), dev, dtype),
        tables=tables,
        lens=torch.tensor(lens, dtype=torch.int32, device=dev),
        k_new=_randn(gen, (B, KVH, D), dev, dtype),
        v_new=_randn(gen, (B, KVH, D), dev, dtype))


def _tol(dtype):
    return (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
            else dict(atol=3e-2, rtol=0))


DECODE_CASES = [
    # dtype, lens, max_pages, H, KVH, D
    (torch.bfloat16, [0, 31, 300, 640, 4096], 512, 32, 8, 128),
    (torch.bfloat16, [1, 16, 17, 128], 8, 32, 8, 128),
    (torch.float32, [5, 77, 256], 32, 8, 2, 64),
    (torch.float16, [9, 1000], 64, 16, 16, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lens,max_pages,H,KVH,D", DECODE_CASES)
def test_decode_kernel_matches_plain(dev, dtype, lens, max_pages, H, KVH,
                                     D):
    c = _decode_case(dev, dtype, lens, max_pages, H, KVH, D)
    args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
    before = _kernels.PAGED_DECODE.launches
    out, m, l = pa.paged_decode_attention(*args, return_stats=True)
    ref, m_r, l_r = pa.paged_decode_attention_plain(*args,
                                                    return_stats=True)
    torch.cuda.synchronize()
    assert _kernels.PAGED_DECODE.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, l_r, atol=1e-3, rtol=1e-4)
    out = pa.paged_decode_with_new_token(*args, c["k_new"], c["v_new"])
    ref = pa.paged_decode_with_new_token_plain(*args, c["k_new"],
                                               c["v_new"])
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


def _ragged_case(dev, dtype, segs, pad, H, KVH, D, page=16, seed=1):
    """[(start, n)] per slot: cached context of `start` tokens in the
    pool, n tokens in the flat batch at positions start.., padding rows
    after them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(segs)
    max_pages = max(-(-max(s + n for s, n in segs) // page), 1)
    P = B * max_pages + 1
    tables = torch.randperm(P - 1, generator=gen, device=dev)[
        :B * max_pages].reshape(B, max_pages).to(torch.int32)
    t = sum(n for _, n in segs) + pad
    slot_ids = torch.zeros(t, dtype=torch.int32)
    positions = torch.zeros(t, dtype=torch.int32)
    valid = torch.zeros(t, dtype=torch.bool)
    cur = 0
    for s, (start, n) in enumerate(segs):
        slot_ids[cur:cur + n] = s
        positions[cur:cur + n] = torch.arange(start, start + n)
        valid[cur:cur + n] = True
        cur += n
    return (_randn(gen, (t, H, D), dev, dtype),
            _randn(gen, (P, page, KVH, D), dev, dtype),
            _randn(gen, (P, page, KVH, D), dev, dtype), tables,
            slot_ids.to(dev), positions.to(dev), valid.to(dev),
            torch.tensor([s for s, _ in segs], dtype=torch.int32,
                         device=dev),
            _randn(gen, (t, KVH, D), dev, dtype),
            _randn(gen, (t, KVH, D), dev, dtype))


RAGGED_CASES = [
    # name, dtype, segs, pad, H, KVH, D
    ("decode_only", torch.float32, [(5, 1), (11, 1), (3, 1), (80, 1)], 0,
     4, 2, 64),
    ("mixed", torch.float32, [(7, 1), (0, 5), (12, 1), (40, 70)], 0,
     4, 2, 64),
    ("gqa_group1", torch.float32, [(6, 2), (0, 3), (10, 1)], 0, 3, 3, 32),
    ("gqa_group4", torch.float32, [(6, 2), (0, 3), (100, 1)], 0, 8, 2, 32),
    ("start_zero", torch.float32, [(0, 1), (0, 4), (0, 1)], 0, 4, 2, 64),
    ("padding_rows", torch.float32, [(5, 1), (0, 4)], 7, 4, 2, 64),
    ("all_padding", torch.float32, [(0, 0)], 6, 4, 2, 64),
    ("8b_mixed_bf16", torch.bfloat16,
     [(33, 1), (1023, 1), (3999, 1), (0, 200), (700, 300)], 3, 32, 8, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,segs,pad,H,KVH,D", RAGGED_CASES)
def test_ragged_kernel_matches_plain(dev, name, dtype, segs, pad, H, KVH,
                                     D):
    args = _ragged_case(dev, dtype, segs, pad, H, KVH, D)
    before = _kernels.RAGGED_PAGED.launches
    out = rpa.ragged_paged_attention(*args)
    ref = rpa.ragged_paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.RAGGED_PAGED.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    valid = args[6]
    assert torch.all(out[~valid] == 0)
    # static bounds that cover the live data change nothing
    t = args[0].shape[0]
    seg = max(max(n for _, n in segs), 1)
    ctx = max(-(-max(s for s, _ in segs) // 16), 1)
    bounded = rpa.ragged_paged_attention(*args, ctx_pages=ctx,
                                         max_seg_len=min(seg, t))
    torch.testing.assert_close(bounded, out, atol=0, rtol=0)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    c = _decode_case(dev, torch.bfloat16, [3, 9], 4, 8, 2, 64)
    args = [c["q"], c["k"], c["v"], c["tables"], c["lens"]]
    with pytest.raises(TypeError):
        pa.paged_decode_attention(*args[:3], args[3].long(), args[4])
    with pytest.raises(TypeError):
        pa.paged_decode_attention(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        pa.paged_decode_attention(args[0], args[1][..., :60].contiguous(),
                                  args[2][..., :60].contiguous(),
                                  *args[3:])
    with pytest.raises(ValueError):
        pa.paged_decode_attention(args[0], *args[1:3], args[3].cpu(),
                                  args[4])


@pytest.mark.cuda
def test_engine_kernel_impl_matches_gather_f32(dev):
    """Small float32 engine: greedy tokens of the kernel impl equal the
    gather impl's, and both kernels' launch counters move."""
    from ray_tpu_torch import (EngineConfig, InferenceEngine, Request,
                               SamplingParams)
    from ray_tpu_torch.models import llama
    kw = dict(model=llama.config("debug", dtype=torch.float32),
              max_batch_size=3, page_size=8, num_pages=64,
              max_prefill_tokens=16, seed=9)
    ek = InferenceEngine(EngineConfig(decode_impl="kernel", **kw))
    eg = InferenceEngine(EngineConfig(decode_impl="gather", **kw),
                         params=ek.params)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(2, 250, (n,), generator=gen).tolist()
               for n in (40, 23, 1, 33, 7, 19)]
    outs = []
    for eng in (ek, eg):
        reqs = [Request(f"r{i}", p, SamplingParams(max_tokens=10))
                for i, p in enumerate(prompts)]
        _kernels.reset_launch_counts()
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        outs.append([r.output_tokens for r in reqs])
        counts = _kernels.launch_counts()
        if eng is ek:
            assert counts["ragged_paged"] > 0 and counts["paged_decode"] > 0
        else:
            assert not any(counts.values()), counts
    assert outs[0] == outs[1]


# ------------------------------------------------- quantized serving kernels

KIND_CODE = {"int8": 1, "fp8": 2}


def _quantize_pools(k, v, kind, ramp=True):
    """int8/fp8 pools and their scale pools from float pools; with ramp,
    each page's magnitude is 10**-5 .. 10**1 (six orders across pages),
    so a kernel that read another row's scale would be far off."""
    if ramp:
        mags = 10.0 ** torch.linspace(-5, 1, k.shape[0], device=k.device)
        k = k.float() * mags[:, None, None, None]
        v = v.float() * mags[:, None, None, None]
    kq, ks = kv_quant.quantize_rows(k, kind)
    vq, vs = kv_quant.quantize_rows(v, kind)
    return kq, vq, dict(k_scales=ks, v_scales=vs)


def _quant_tol(dtype):
    # bf16 outputs reach |x| ~ 10 here: two bf16 ulps there, 3e-2 below
    return (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
            else dict(atol=3e-2, rtol=1.6e-2))


QUANT_DECODE_CASES = [
    # dtype, lens (partial last pages, seq_len 0), max_pages, H, KVH, D
    (torch.bfloat16, [0, 31, 300, 640, 4096], 512, 32, 8, 128),
    (torch.bfloat16, [1, 16, 17, 128], 8, 32, 8, 128),
    (torch.float32, [0, 5, 77, 256], 32, 8, 2, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype,lens,max_pages,H,KVH,D", QUANT_DECODE_CASES)
def test_quant_decode_kernel_matches_plain(dev, dtype, lens, max_pages, H,
                                           KVH, D, kind):
    c = _decode_case(dev, dtype, lens, max_pages, H, KVH, D, seed=2)
    kq, vq, sc = _quantize_pools(c["k"], c["v"], kind)
    args = (c["q"], kq, vq, c["tables"], c["lens"])
    kern = _kernels.PAGED_DECODE_BY_KIND[KIND_CODE[kind]]
    before = (kern.launches, _kernels.PAGED_DECODE.launches)
    out, m, l = pa.paged_decode_attention(*args, return_stats=True, **sc)
    again = pa.paged_decode_attention(*args, return_stats=True, **sc)
    ref, m_r, l_r = pa.paged_decode_attention_plain(*args, return_stats=True,
                                                    **sc)
    torch.cuda.synchronize()
    assert (kern.launches, _kernels.PAGED_DECODE.launches) == \
        (before[0] + 2, before[1])
    assert all(torch.equal(x, y) for x, y in zip((out, m, l), again))
    torch.testing.assert_close(out.float(), ref.float(), **_quant_tol(dtype))
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, l_r, atol=1e-3, rtol=1e-4)
    new = (c["k_new"], c["v_new"])
    out = pa.paged_decode_with_new_token(*args, *new, **sc)
    ref = pa.paged_decode_with_new_token_plain(*args, *new, **sc)
    torch.testing.assert_close(out.float(), ref.float(), **_quant_tol(dtype))


QUANT_RAGGED_CASES = [
    # name, dtype, segs, pad, H, KVH, D
    ("decode_only", torch.float32, [(5, 1), (11, 1), (3, 1), (80, 1)], 0,
     4, 2, 64),
    ("mixed", torch.float32, [(7, 1), (0, 5), (12, 1), (40, 70)], 0,
     4, 2, 64),
    ("gqa_group4", torch.float32, [(6, 2), (0, 3), (100, 1)], 0, 8, 2, 32),
    ("padding_rows", torch.float32, [(5, 1), (0, 4)], 7, 4, 2, 64),
    ("all_padding", torch.bfloat16, [(0, 0)], 6, 4, 2, 64),
    ("8b_mixed_bf16", torch.bfloat16,
     [(33, 1), (1023, 1), (3999, 1), (0, 200), (700, 300)], 3, 32, 8, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("name,dtype,segs,pad,H,KVH,D", QUANT_RAGGED_CASES)
def test_quant_ragged_kernel_matches_plain(dev, name, dtype, segs, pad, H,
                                           KVH, D, kind):
    args = list(_ragged_case(dev, dtype, segs, pad, H, KVH, D, seed=3))
    args[1], args[2], sc = _quantize_pools(args[1], args[2], kind)
    kern = _kernels.RAGGED_PAGED_BY_KIND[KIND_CODE[kind]]
    before = (kern.launches, _kernels.RAGGED_PAGED.launches)
    out = rpa.ragged_paged_attention(*args, **sc)
    again = rpa.ragged_paged_attention(*args, **sc)
    ref = rpa.ragged_paged_attention_plain(*args, **sc)
    torch.cuda.synchronize()
    assert (kern.launches, _kernels.RAGGED_PAGED.launches) == \
        (before[0] + 2, before[1])
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), **_quant_tol(dtype))
    assert torch.all(out[~args[6]] == 0)


@pytest.mark.cuda
def test_quant_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    c = _decode_case(dev, torch.bfloat16, [3, 9], 4, 8, 2, 64)
    kq, vq, sc = _quantize_pools(c["k"], c["v"], "int8", ramp=False)
    args = [c["q"], kq, vq, c["tables"], c["lens"]]
    with pytest.raises(ValueError):                  # one scale pool alone
        pa.paged_decode_attention(*args, k_scales=sc["k_scales"])
    with pytest.raises(TypeError):                   # int8 pools, no scales
        pa.paged_decode_attention(*args)
    with pytest.raises(ValueError):                  # scales on the CPU
        pa.paged_decode_attention(*args, k_scales=sc["k_scales"].cpu(),
                                  v_scales=sc["v_scales"].cpu())
    kq8, vq8, sc8 = _quantize_pools(c["k"][..., :8].contiguous(),
                                    c["v"][..., :8].contiguous(), "fp8",
                                    ramp=False)
    with pytest.raises(ValueError):                  # head_dim % 16
        pa.paged_decode_attention(c["q"][..., :8].contiguous(), kq8, vq8,
                                  *args[3:], **sc8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_engine_quant_kernel_impl_matches_gather_f32(dev, kind):
    """Small float32 engine on int8/fp8 pages: the kernel impl's greedy
    tokens equal the gather impl's; only this kind's counters move."""
    from ray_tpu_torch import (EngineConfig, InferenceEngine, Request,
                               SamplingParams)
    from ray_tpu_torch.models import llama
    kw = dict(model=llama.config("debug", dtype=torch.float32),
              max_batch_size=3, page_size=8, num_pages=64,
              max_prefill_tokens=16, seed=9, kv_dtype=kind)
    ek = InferenceEngine(EngineConfig(decode_impl="kernel", **kw))
    eg = InferenceEngine(EngineConfig(decode_impl="gather", **kw),
                         params=ek.params)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(2, 250, (n,), generator=gen).tolist()
               for n in (40, 23, 1, 33, 7, 19)]
    outs = []
    for eng in (ek, eg):
        reqs = [Request(f"r{i}", p, SamplingParams(max_tokens=10))
                for i, p in enumerate(prompts)]
        _kernels.reset_launch_counts()
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        outs.append([r.output_tokens for r in reqs])
        counts = _kernels.launch_counts()
        if eng is ek:
            st = eng.stats()
            L = eng.model_cfg.n_layers
            assert counts[f"ragged_paged_{kind}"] == L * st["ragged_ticks"]
            assert counts[f"paged_decode_{kind}"] == L * st["decode_ticks"]
            assert st["decode_ticks"] > 0
            assert sum(counts.values()) == L * st["ticks"]
        else:
            assert not any(counts.values()), counts
    assert outs[0] == outs[1]


# ------------------------------------------------------------ flash kernels

FLASH_CASES = [
    # B, Sq, Sk, H, KVH, D, causal
    (2, 256, 256, 8, 2, 64, True),
    (2, 256, 256, 8, 2, 128, True),
    (1, 192, 192, 4, 4, 128, False),
    (1, 100, 300, 4, 1, 64, False),      # ragged tiles, Sq != Sk
    (2, 136, 136, 8, 8, 128, True),      # ragged last tile
    (1, 320, 128, 4, 2, 64, True),       # causal, Sq > Sk
    # shapes that cut the bf16 kernels' 128-row q tiles, 128-key tiles and
    # 64-row dk/dv q tiles unevenly
    (1, 1000, 1000, 8, 2, 128, True),
    (1, 130, 260, 4, 2, 64, False),
    (2, 512, 512, 16, 2, 128, True),
]


def _flash_inputs(dev, dtype, b, sq, sk, h, kvh, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn(gen, (b, sq, h, d), dev, dtype),
            _randn(gen, (b, sk, kvh, d), dev, dtype),
            _randn(gen, (b, sk, kvh, d), dev, dtype),
            _randn(gen, (b, sq, h, d), dev, dtype))


def _flash_close(out, ref, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4, msg=what)
    else:
        torch.testing.assert_close(
            out.float(), ref.float(), rtol=1.6e-2,
            atol=1e-3 * ref.float().abs().max().item(), msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", FLASH_CASES)
def test_flash_kernels_match_plain(dev, dtype, b, sq, sk, h, kvh, d,
                                   causal):
    """bf16 runs the tensor-core forward and dk/dv, f32 and f16 the
    CUDA-core instances; every dtype against the same plain versions."""
    q, k, v, do = _flash_inputs(dev, dtype, b, sq, sk, h, kvh, d)
    scale = d ** -0.5
    before = [kk.launches for kk in (_kernels.FLASH_FWD, _kernels.FLASH_DQ,
                                     _kernels.FLASH_DKV)]
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    grads = fa.flash_backward(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    after = [kk.launches for kk in (_kernels.FLASH_FWD, _kernels.FLASH_DQ,
                                    _kernels.FLASH_DKV)]
    assert after == [x + 1 for x in before]
    ref, lse_ref = fa.flash_forward_plain(q, k, v, causal, scale)
    _flash_close(out, ref, dtype, "out")
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    # the backward on the same residuals as the kernels'
    ref_g = fa.flash_backward_plain(q, k, v, out, lse, do, causal, scale)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_g):
        assert a.dtype == dtype
        _flash_close(a, r, dtype, name)


@pytest.mark.cuda
def test_flash_kernels_are_deterministic(dev):
    """No atomics: two launches on the same inputs give the same bits, at
    a shape with several tiles in each dimension of every kernel (6 q
    tiles of 128 rows, 6 kv tiles of 128 keys, 12 dk/dv q tiles of 64
    rows, a GQA group of 4)."""
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, 2, 768, 768, 8, 2, 128)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_forward(q, k, v, True, 128 ** -0.5)
        runs.append((out, lse) + fa.flash_backward(q, k, v, out, lse, do,
                                                   True, 128 ** -0.5))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_autograd_on_cuda(dev):
    """flash_attention's autograd Function runs the kernels both ways and
    agrees with the reference's gradients (float32)."""
    q, k, v, do = _flash_inputs(dev, torch.float32, 1, 256, 256, 8, 2, 64)
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    rs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n0 = _kernels.FLASH_DKV.launches
    out = fa.attention(*qs, causal=True, impl="pallas")
    (out * do).sum().backward()
    ref = fa.attention(*rs, causal=True, impl="xla")
    (ref * do).sum().backward()
    assert _kernels.FLASH_DKV.launches == n0 + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for a, b in zip(qs, rs):
        torch.testing.assert_close(a.grad, b.grad, atol=2e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, 1, 64, 64, 4, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(q[..., :32].contiguous(), k[..., :32].contiguous(),
                         v[..., :32].contiguous(), True, 0.2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(q.transpose(1, 2), k, v, True, 0.125)
    with pytest.raises(TypeError):
        fa.flash_forward(q.float(), k, v, True, 0.125)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_forward(q, k.cpu(), v, True, 0.125)


# ------------------------------------------ bf16: the tensor-core redesigns

DQ_TC_CASES = [
    # B, Sq, Sk, H, KVH, D, causal: uneven S (1000 cuts the 128-row q
    # tiles and 64-key tiles), Sq != Sk both ways, GQA group 1 and 4
    (1, 1000, 1000, 8, 2, 128, True),
    (1, 1000, 1000, 4, 4, 64, True),
    (2, 1000, 1000, 4, 4, 128, False),
    (1, 300, 700, 8, 2, 64, False),
    (1, 700, 300, 8, 2, 128, True),
    (2, 256, 640, 4, 4, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", DQ_TC_CASES)
def test_flash_dq_tc_matches_plain(dev, b, sq, sk, h, kvh, d, causal):
    """bf16 dq runs flash_dq_tc_kernel: against flash_dq_plain on the
    same residuals, and bit-identical over two launches."""
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, b, sq, sk, h, kvh, d,
                                seed=4)
    scale = d ** -0.5
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    delta = fa.flash_delta(out, do)
    n0 = _kernels.FLASH_DQ.launches
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal, scale)
    again = fa.flash_dq(q, k, v, do, lse, delta, causal, scale)
    ref = fa.flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert _kernels.FLASH_DQ.launches == n0 + 2
    assert torch.equal(dq, again)
    _flash_close(dq, ref, torch.bfloat16, "dq")


TC_RAGGED_CASES = [
    # name, segs [(start, n)], pad, H, KVH, D, page
    ("decode_only", [(5, 1), (11, 1), (3, 1), (80, 1)], 0, 32, 8, 128, 16),
    ("all_padding", [(0, 0)], 6, 8, 2, 64, 16),
    ("start_zero", [(0, 1), (0, 4), (0, 1)], 2, 32, 8, 128, 16),
    ("partial_last_page", [(37, 1), (50, 9), (16, 3)], 1, 32, 8, 128, 16),
    # contexts of 63-65 tiles: 8-9 key chunks merged by the combine pass
    ("long_decode_many_chunks", [(3999, 1), (4100, 1), (700, 1)], 0,
     32, 8, 128, 16),
    # chunks that cross 16-token q tiles and 512-key chunks, one of them
    # over in-batch keys only (tokens past 512 of a fresh 600-token slot)
    ("crosses_q_tiles_and_chunks", [(450, 100), (0, 600), (600, 300)], 3,
     32, 8, 128, 16),
    ("group1", [(70, 1), (0, 70), (130, 40)], 0, 8, 8, 64, 16),
    ("group8", [(70, 1), (0, 70), (530, 40)], 0, 16, 2, 128, 16),
    # group 3: 21 tokens x 3 heads fill 63 of a tile's 64 rows
    ("group3_padding_rows", [(20, 1), (10, 30)], 0, 6, 2, 64, 16),
    ("page8", [(100, 1), (33, 50)], 0, 32, 8, 128, 8),
    ("page64", [(100, 1), (200, 70)], 0, 32, 8, 128, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("name,segs,pad,H,KVH,D,page", TC_RAGGED_CASES)
def test_ragged_tc_kernel_matches_plain(dev, name, segs, pad, H, KVH, D,
                                        page, kind):
    """bf16 queries run the tensor-core ragged kernel on each page kind:
    against the plain version, padding rows exact zeros, two launches
    bit-identical, one launch-counter step per call."""
    args = list(_ragged_case(dev, torch.bfloat16, segs, pad, H, KVH, D,
                             page=page, seed=5))
    sc = {}
    if kind != "bf16":
        args[1], args[2], sc = _quantize_pools(args[1], args[2], kind)
    kern = _kernels.RAGGED_PAGED_BY_KIND[KIND_CODE.get(kind, 0)]
    n0 = kern.launches
    out = rpa.ragged_paged_attention(*args, **sc)
    again = rpa.ragged_paged_attention(*args, **sc)
    ref = rpa.ragged_paged_attention_plain(*args, **sc)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 2
    assert torch.equal(out, again)
    tol = _tol(torch.bfloat16) if kind == "bf16" else \
        _quant_tol(torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.all(out[~args[6]] == 0)


OFF_TC_RAGGED_CASES = [
    # name, segs, pad, H, KVH, D, page: bf16 shapes `tc_takes` refuses
    ("debug_preset_d32", [(5, 1), (0, 3), (40, 20)], 2, 4, 2, 32, 16),
    ("page4", [(5, 1), (0, 3), (37, 9)], 1, 4, 2, 64, 4),
    ("page4_8b_widths", [(130, 1), (0, 30), (61, 7)], 0, 32, 8, 128, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("name,segs,pad,H,KVH,D,page", OFF_TC_RAGGED_CASES)
def test_ragged_bf16_off_tensor_core_shapes_match_plain(dev, name, segs, pad,
                                                        H, KVH, D, page,
                                                        kind):
    """bf16 queries of a head_dim or page size the tensor-core kernel
    does not take run the CUDA-core kernel's bf16 instance: against the
    plain version, padding rows exact zeros, one launch-counter step."""
    assert not rpa.tc_takes(torch.bfloat16, D, page, H // KVH)
    args = list(_ragged_case(dev, torch.bfloat16, segs, pad, H, KVH, D,
                             page=page, seed=7))
    sc = {}
    if kind != "bf16":
        args[1], args[2], sc = _quantize_pools(args[1], args[2], kind)
    kern = _kernels.RAGGED_PAGED_BY_KIND[KIND_CODE.get(kind, 0)]
    n0 = kern.launches
    out = rpa.ragged_paged_attention(*args, **sc)
    ref = rpa.ragged_paged_attention_plain(*args, **sc)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    tol = _tol(torch.bfloat16) if kind == "bf16" else \
        _quant_tol(torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.all(out[~args[6]] == 0)


@pytest.mark.cuda
def test_ragged_tc_shared_scratch(dev):
    """One ragged_scratch buffer serves several calls (a tick's layers)
    with the same bits as a buffer of each call's own; a buffer too
    small raises."""
    args = _ragged_case(dev, torch.bfloat16, [(3999, 1), (700, 30)], 2,
                        32, 8, 128, seed=3)
    q, k_pages, tables = args[0], args[1], args[3]
    scratch = rpa.ragged_scratch(q.shape[0], 32, 128, torch.bfloat16,
                                 k_pages, tables)
    _, _, n_chunks = rpa.tc_geometry(q.shape[0], 2, 4, q.shape[0],
                                     tables.shape[1], 16)
    assert n_chunks > 1
    assert scratch.numel() == rpa.scratch_numel(q.shape[0], 32, 128,
                                                n_chunks)
    own = rpa.ragged_paged_attention(*args)
    for _ in range(2):
        shared = rpa.ragged_paged_attention(*args, scratch=scratch)
        assert torch.equal(shared, own)
    with pytest.raises(ValueError, match="scratch"):
        rpa.ragged_paged_attention(*args, scratch=scratch[:-1])


@pytest.mark.cuda
def test_default_engine_serves_on_the_card(dev):
    """InferenceEngine(EngineConfig()): the `debug` preset (bf16,
    head_dim 32) on the kernel impl, through mixed and decode ticks;
    every request finishes with its tokens and both kernels launch."""
    from ray_tpu_torch import (EngineConfig, InferenceEngine, Request,
                               SamplingParams)
    eng = InferenceEngine(EngineConfig())
    assert eng.impl == "kernel"
    gen = torch.Generator().manual_seed(11)
    reqs = [Request(f"r{i}", torch.randint(2, 250, (n,),
                                           generator=gen).tolist(),
                    SamplingParams(max_tokens=6))
            for i, n in enumerate((40, 3, 17, 90))]
    _kernels.reset_launch_counts()
    for r in reqs:
        eng.add_request(r)
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
    counts = _kernels.launch_counts()
    assert ticks >= 3
    assert counts["ragged_paged"] > 0 and counts["paged_decode"] > 0
    for r in reqs:
        assert len(r.output_tokens) == 6
        assert all(0 <= x < 256 for x in r.output_tokens)

# ------------------------------------ pipelined decode kernel (bf16 queries)

EDGE_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257, 4095, 4096]
SHORT_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128]

PIPE_DECODE_CASES = [
    # name, lens, max_pages, page, H, KVH, D: every one `decode_takes`
    ("512_pages", EDGE_LENS, 512, 16, 32, 8, 128),
    ("8_pages", SHORT_LENS, 8, 16, 32, 8, 128),
    ("page8", EDGE_LENS[:11], 40, 8, 32, 8, 128),
    ("page32", EDGE_LENS, 128, 32, 32, 8, 128),
    ("page64_d64_group8", SHORT_LENS, 3, 64, 16, 2, 64),
    ("d64_group1", EDGE_LENS[:9], 20, 16, 8, 8, 64),
    ("group3", EDGE_LENS[:10], 17, 16, 12, 4, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("name,lens,max_pages,page,H,KVH,D",
                         PIPE_DECODE_CASES)
def test_pipelined_decode_matches_plain(dev, name, lens, max_pages, page, H,
                                        KVH, D, kind):
    """bf16 queries on bf16, int8 and fp8 pages: the pipelined kernel
    against the plain version at every length edge (the 16-key tile, the
    chunk, pages, the table's end), with stats and with the new token;
    two launches give the same bits, and so does a shared partials
    buffer; every call takes the pipelined route."""
    assert pa.decode_takes(torch.bfloat16, D, page, H // KVH)
    c = _decode_case(dev, torch.bfloat16, lens, max_pages, H, KVH, D,
                     page=page, seed=5)
    k, v, sc = c["k"], c["v"], {}
    tol = _tol(torch.bfloat16)
    if kind != "bf16":
        k, v, sc = _quantize_pools(k, v, kind)
        tol = _quant_tol(torch.bfloat16)
    args = (c["q"], k, v, c["tables"], c["lens"])
    new = (c["k_new"], c["v_new"])
    kern = _kernels.PAGED_DECODE_BY_KIND[KIND_CODE.get(kind, 0)]
    before = kern.routes.get("pipelined", 0)
    out, m, l = pa.paged_decode_attention(*args, return_stats=True, **sc)
    again = pa.paged_decode_attention(*args, return_stats=True, **sc)
    ref, m_r, l_r = pa.paged_decode_attention_plain(*args, return_stats=True,
                                                    **sc)
    out_n = pa.paged_decode_with_new_token(*args, *new, **sc)
    again_n = pa.paged_decode_with_new_token(*args, *new, **sc)
    ref_n = pa.paged_decode_with_new_token_plain(*args, *new, **sc)
    scratch = pa.decode_scratch(len(lens), H, D, torch.bfloat16, k,
                                c["tables"])
    shared = [pa.paged_decode_with_new_token(*args, *new, scratch=scratch,
                                             **sc) for _ in range(2)]
    torch.cuda.synchronize()
    assert kern.routes["pipelined"] == before + 6
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(m, m_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, l_r, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(out_n.float(), ref_n.float(), **tol)
    assert all(torch.equal(x, y) for x, y in zip((out, m, l), again))
    assert torch.equal(out_n, again_n)
    assert all(torch.equal(out_n, s) for s in shared)


@pytest.mark.cuda
def test_pipelined_decode_scratch_is_checked(dev):
    """A partials buffer too small, or of the wrong type, raises; the
    8b decode tick's call needs one (16 chunks)."""
    c = _decode_case(dev, torch.bfloat16, [3000, 5], 512, 32, 8, 128)
    args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
    scratch = pa.decode_scratch(2, 32, 128, torch.bfloat16, c["k"],
                                c["tables"])
    assert scratch is not None and scratch.numel() == \
        pa.decode_partials_numel(2, 32, 128, pa.decode_plan(
            torch.bfloat16, 128, 16, 8, 4, 2, 512,
            pa._sm_count(dev))[2])
    for bad in (scratch[:-1], scratch.double()):
        with pytest.raises(ValueError, match="scratch"):
            pa.paged_decode_attention(*args, scratch=bad)


OFF_ROUTE_DECODE_CASES = [
    # name, lens, max_pages, page, H, KVH, D: bf16 shapes `decode_takes`
    # refuses, still served by the CUDA-core kernel
    ("debug_preset_d32", [0, 5, 40, 77], 8, 16, 4, 2, 32),
    ("page4", [1, 4, 5, 63], 16, 4, 32, 8, 128),
    ("group16", [3, 70, 200], 16, 16, 32, 2, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("name,lens,max_pages,page,H,KVH,D",
                         OFF_ROUTE_DECODE_CASES)
def test_decode_off_route_shapes_match_plain(dev, name, lens, max_pages,
                                             page, H, KVH, D, kind):
    assert not pa.decode_takes(torch.bfloat16, D, page, H // KVH)
    c = _decode_case(dev, torch.bfloat16, lens, max_pages, H, KVH, D,
                     page=page, seed=6)
    k, v, sc = c["k"], c["v"], {}
    tol = _tol(torch.bfloat16)
    if kind != "bf16":
        k, v, sc = _quantize_pools(k, v, kind)
        tol = _quant_tol(torch.bfloat16)
    args = (c["q"], k, v, c["tables"], c["lens"])
    kern = _kernels.PAGED_DECODE_BY_KIND[KIND_CODE.get(kind, 0)]
    before = kern.routes.get("cuda_core", 0)
    out = pa.paged_decode_with_new_token(*args, c["k_new"], c["v_new"], **sc)
    ref = pa.paged_decode_with_new_token_plain(*args, c["k_new"],
                                               c["v_new"], **sc)
    torch.cuda.synchronize()
    assert kern.routes["cuda_core"] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_decode_other_query_types_take_the_cuda_core_kernel(dev, dtype):
    c = _decode_case(dev, dtype, [0, 17, 300], 32, 32, 8, 128)
    args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
    before = _kernels.PAGED_DECODE.routes.get("cuda_core", 0)
    out = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert _kernels.PAGED_DECODE.routes["cuda_core"] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


# ----------------------------------- sampling noise, decode graphs, guard

GUMBEL_TOL = 2.0 ** -22     # as tests/test_torch_threefry.py: each side's
#                             logf within an ulp of the true value


@pytest.mark.cuda
@pytest.mark.parametrize("b,vocab", [(8, 128256), (3, 50), (1, 257),
                                     (2, 5000)])
def test_row_noise_kernel_matches_plain(dev, b, vocab):
    """Bits and uniforms bit-equal to the plain version (itself bit-equal
    to jax.random), Gumbel values within the two logs' rounding."""
    from ray_tpu_torch.ops import threefry as tf
    gen = torch.Generator().manual_seed(b * vocab)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=gen,
                          dtype=torch.int32).to(dev)
    index = torch.randint(0, 2 ** 31 - 1, (b,), generator=gen,
                          dtype=torch.int32).to(dev)
    before = _kernels.ROW_GUMBEL.launches
    got = {s: tf.row_noise(seeds, index, vocab, s) for s in tf.STAGES}
    torch.cuda.synchronize()
    assert _kernels.ROW_GUMBEL.launches == before + 3
    want = {s: tf.row_noise_plain(seeds, index, vocab, s)
            for s in tf.STAGES}
    assert torch.equal(got["bits"], want["bits"])
    assert torch.equal(got["uniform"].view(torch.int32),
                       want["uniform"].view(torch.int32))
    g, w = got["gumbel"], want["gumbel"]
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= GUMBEL_TOL * w.abs().clamp(min=1.0)).all()
    assert torch.equal(tf.row_gumbel(seeds, index, vocab), g)


def _serve(eng, prompts, **sp):
    from ray_tpu_torch import Request, SamplingParams
    reqs = [Request(f"r{i}", p, SamplingParams(**sp))
            for i, p in enumerate(prompts)]
    _kernels.reset_launch_counts()
    for r in reqs[:3]:
        eng.add_request(r)
    pending = reqs[3:]
    while eng.has_work() or pending:
        eng.step()
        if pending:
            eng.add_request(pending.pop(0))
    return [r.output_tokens for r in reqs], _kernels.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
def test_graph_engine_matches_eager_engine(dev, kind):
    """The default engine (a CUDA graph per decode tick, pipelined
    readback) against cuda_graph=False on the same weights: the same
    greedy and sampled tokens, the same launch counts (the same ticks:
    both pipelined), paged_decode launched layers x decode ticks; and
    the tokens of a synchronous eager engine."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    kw = dict(max_batch_size=4, page_size=16, num_pages=129, seed=3,
              kv_dtype=kind)
    eg = InferenceEngine(EngineConfig(**kw))
    ee = InferenceEngine(EngineConfig(cuda_graph=False, **kw),
                         params=eg.params)
    es = InferenceEngine(EngineConfig(cuda_graph=False, async_readback=False,
                                      **kw), params=eg.params)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(2, 250, (n,), generator=gen).tolist()
               for n in (40, 3, 17, 90, 9)]
    name = "paged_decode" + ("" if kind == "f32" else f"_{kind}")
    for sp in (dict(max_tokens=12),
               dict(max_tokens=12, temperature=0.8, top_p=0.95, top_k=50)):
        t0 = eg.decode_ticks
        out_g, n_g = _serve(eg, prompts, **sp)
        out_e, n_e = _serve(ee, prompts, **sp)
        assert out_g == out_e == _serve(es, prompts, **sp)[0]
        assert n_g == n_e
        assert n_g[name] == eg.model_cfg.n_layers * (eg.decode_ticks - t0)
    st = eg.stats()
    assert st["graph_captures"] == 2 and ee.stats()["graph_captures"] == 0
    assert st["lagged_ticks"] > 0
    eg.release_graphs()


@pytest.mark.cuda
def test_graph_engine_counts_launches_per_decode_tick(dev):
    from ray_tpu_torch import EngineConfig, InferenceEngine
    eng = InferenceEngine(EngineConfig(max_batch_size=4, num_pages=129))
    gen = torch.Generator().manual_seed(8)
    prompts = [torch.randint(2, 250, (n,), generator=gen).tolist()
               for n in (12, 30, 5)]
    t0 = eng.decode_ticks
    _, counts = _serve(eng, prompts, max_tokens=20, temperature=0.7)
    n = eng.decode_ticks - t0
    assert n > 10 and eng.stats()["graph_captures"] == 1
    assert counts["paged_decode"] == eng.model_cfg.n_layers * n
    assert _kernels.route_counts()["paged_decode"] == {
        "cuda_core": eng.model_cfg.n_layers * n}     # debug: head_dim 32
    assert counts["row_gumbel"] >= n


@pytest.mark.cuda
def test_dispatch_guard_on_the_card(dev):
    """A steady window of graph replays: no upload, no capture, one
    readback a tick; a stray sync raises at its line."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, Request, \
        SamplingParams
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    eng = InferenceEngine(EngineConfig(max_batch_size=3, num_pages=129))
    for i in range(3):
        eng.add_request(Request(f"g{i}", [5 + i] * 12, SamplingParams(
            max_tokens=64, temperature=0.8, top_k=20,
            repetition_penalty=1.2)))
    with dispatch_guard(max_captures=1, engine=eng,
                        raise_on_violation=False) as warm:
        for _ in range(6):
            eng.step()
    assert len(warm.captures) == 1
    with dispatch_guard(engine=eng) as report:
        for _ in range(16):
            eng.step()
    assert report.uploads == [] and report.captures == []
    assert report.readbacks == 16
    with pytest.raises(RuntimeError):
        with dispatch_guard(engine=eng):
            eng.step()
            eng._d_tokens.sum().item()


@pytest.mark.cuda
def test_capture_survives_a_dead_engine_collected(dev):
    """The cause of test_dispatch_guard_on_the_card's intermittent
    failure (CUBLAS_STATUS_EXECUTION_FAILED inside a capture, then
    cudaErrorStreamCaptureInvalidated): a dead engine's decode graph,
    held only by the engine's reference cycles, freed by an automatic
    collection while another engine captures. Here the dead engine's
    objects are kept young (no collection while it lives) and a
    collection falls due inside the capture, after its last outside
    reference goes: collections wait until the capture ends, so it
    succeeds, the dead engine is freed after it, and the tokens are the
    eager engine's."""
    import gc
    import weakref
    from ray_tpu_torch import EngineConfig, InferenceEngine, SamplingParams
    kw = dict(max_batch_size=3, num_pages=129)
    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(10 ** 9)        # the dead engine stays in generation 0
    try:
        dead = [InferenceEngine(EngineConfig(**kw))]
        dead[0].generate([[5] * 12], SamplingParams(max_tokens=6))
        assert dead[0].graph_captures == 1
        gone = weakref.ref(dead[0])
        eng = InferenceEngine(EngineConfig(**kw))
        own = eng._decode_body

        def body(*a):
            if torch.cuda.is_current_stream_capturing() and dead:
                dead.clear()         # the engine's own cycles hold it now
                gc.set_threshold(1)  # a collection falls due
                [[{}] for _ in range(64)]
            return own(*a)

        eng._decode_body = body
        [got] = eng.generate([[7] * 12], SamplingParams(max_tokens=8))
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    assert eng.graph_captures == 1 and not dead and gone() is None
    ref = InferenceEngine(EngineConfig(cuda_graph=False,
                                       async_readback=False, **kw),
                          params=eng.params)
    [want] = ref.generate([[7] * 12], SamplingParams(max_tokens=8))
    assert got.output_tokens == want.output_tokens
    eng.release_graphs()


def _restored_rows_equal(eng, slot, parked):
    """A gather of the restored slot's first `position` token rows
    against the host copy it was restored from, byte for byte."""
    from ray_tpu_torch.llm._internal.engine import _bits
    from ray_tpu_torch.llm._internal.kv_offload import host_tensor
    got = eng._gather_pages(slot.pages[:parked.n_pages])
    for g, h in zip(got, eng._host_pages(parked)):
        rows_g = _bits(g.cpu()).flatten(1, 2)[:, :parked.position]
        rows_h = _bits(host_tensor(h)).flatten(1, 2)[:, :parked.position]
        if not torch.equal(rows_g, rows_h):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
def test_graph_engine_preempt_restore_in_place(dev, kind):
    """Preempt (spill) and restore on the default engine (decode graphs,
    pipelined readback): every stream equals a run of the same engine
    never preempted, no graph is captured in that run, the pools keep
    their addresses (the restore writes in place), and a gather of the
    restored pages equals the host copy byte for byte."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, Request, \
        SamplingParams
    eng = InferenceEngine(EngineConfig(max_batch_size=4, num_pages=129,
                                       seed=3, kv_dtype=kind,
                                       enable_kv_offload=True))
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(2, 250, (n,), generator=gen).tolist()
               for n in (40, 23, 57, 9)]

    def run(preempt):
        eng.allocator.clear_cache()
        reqs = [Request(f"p{i}", p, SamplingParams(
            max_tokens=24, temperature=0.8, top_k=40, seed=20 + i))
            for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        while len(reqs[1].output_tokens) < 6:
            eng.step()
        ok = True
        if preempt:
            assert eng.preempt("p1")
            parked = eng.parked[0]
            eng.step()
            slot = next(s for s in eng.slots if s.request is reqs[1])
            ok = _restored_rows_equal(eng, slot, parked)
        while eng.has_work():
            eng.step()
        return [r.output_tokens for r in reqs], ok

    want, _ = run(False)
    captures = eng.graph_captures
    ptrs = [t.data_ptr() for t in eng._pools()]
    got, bytes_equal = run(True)
    assert got == want
    assert bytes_equal
    assert eng.graph_captures == captures
    assert [t.data_ptr() for t in eng._pools()] == ptrs
    st = eng.stats()
    assert st["kv"]["spills_total"] == st["kv"]["restores_total"] == 1
    eng.release_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "fp8"])
def test_graph_engine_oversubscribed_matches_eager(dev, kind):
    """Optimistic admission on the default engine: growth preempts, the
    victims spill and restore, every request finishes, and the streams,
    preemption counts, spills and restores equal an engine that runs
    the same ticks eagerly (cuda_graph=False, same readback mode, so the
    same packing)."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, Request, \
        SamplingParams
    kw = dict(max_batch_size=4, page_size=8, seed=9, max_prefill_tokens=16,
              num_pages=15, enable_kv_offload=True, kv_watermark_tokens=8,
              kv_dtype=kind)
    graph = InferenceEngine(EngineConfig(**kw))
    eager = InferenceEngine(EngineConfig(cuda_graph=False, **kw),
                            params=graph.params)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(2, 250, (12,), generator=gen).tolist()
               for _ in range(8)]
    outs = []
    for e in (graph, eager):
        reqs = [Request(f"q{i}", p, SamplingParams(
            max_tokens=44, temperature=0.7, top_p=0.9, seed=i))
            for i, p in enumerate(prompts)]
        for r in reqs:
            e.add_request(r)
        while e.has_work():
            e.step()
        assert all(r.finish_reason == "length" for r in reqs)
        assert len(e.parked) == 0 and e.host_tier.used_bytes == 0
        outs.append(([r.output_tokens for r in reqs],
                     dict(e.preempt_counts), e.host_tier.spills_total,
                     e.host_tier.restores_total))
    assert outs[0] == outs[1]
    assert outs[0][2] >= 1 and outs[0][3] == outs[0][2]
    assert graph.graph_captures >= 1 and eager.graph_captures == 0
    graph.release_graphs()


# ------------------------------------------- multi-LoRA and multi-step

def _lora_adapters(cfg, seed=0, r=8):
    """A strong adapter on all four projections and an all-zero one."""
    gen = torch.Generator().manual_seed(seed)
    L, h, q, kv = cfg.n_layers, cfg.hidden, cfg.q_dim, cfg.kv_dim
    dims = {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h)}
    strong = {p: (torch.randn(L, i, r, generator=gen) * 0.3,
                  torch.randn(L, r, o, generator=gen) * 0.3)
              for p, (i, o) in dims.items()}
    zero = {p: (torch.zeros(L, i, r), torch.zeros(L, r, o))
            for p, (i, o) in dims.items()}
    return {"strong": strong, "zero": zero}


def _serve_loras(eng, prompts, loras, **sp):
    from ray_tpu_torch import Request, SamplingParams
    # one seed: requests on one prompt differ only by their adapter
    reqs = [Request(f"l{i}", p, SamplingParams(seed=11, **sp), lora=lo)
            for i, (p, lo) in enumerate(zip(prompts, loras))]
    _kernels.reset_launch_counts()
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs], _kernels.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
def test_lora_graph_engine_matches_eager_engine(dev, kind):
    """Adapters on the card: the default engine (decode graphs keyed by
    stacks present, pipelined readback) against cuda_graph=False and a
    synchronous eager engine: the same greedy and sampled tokens and
    launch counts; the zero adapter's tokens bit-equal the base ones;
    the first registration counts one compile and no capture, a second
    one of the same ranks neither."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    kw = dict(max_batch_size=4, page_size=16, num_pages=129, seed=3,
              kv_dtype=kind)
    eg = InferenceEngine(EngineConfig(**kw))
    ee = InferenceEngine(EngineConfig(cuda_graph=False, **kw),
                         params=eg.params)
    es = InferenceEngine(EngineConfig(cuda_graph=False, async_readback=False,
                                      **kw), params=eg.params)
    ads = _lora_adapters(eg.model_cfg)
    c0, g0 = eg.compiles, eg.graph_captures
    for e in (eg, ee, es):
        e.register_loras(ads)
    assert eg.compiles == c0 + 1 and eg.graph_captures == g0
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(2, 250, (n,), generator=gen).tolist()
               for n in (40, 40, 17, 90)]
    prompts[1] = list(prompts[0])
    loras = ["zero", None, "strong", "strong"]
    name = "paged_decode" + ("" if kind == "f32" else f"_{kind}")
    for sp in (dict(max_tokens=12),
               dict(max_tokens=12, temperature=0.8, top_p=0.95, top_k=50)):
        t0 = eg.decode_ticks
        out_g, n_g = _serve_loras(eg, prompts, loras, **sp)
        out_e, n_e = _serve_loras(ee, prompts, loras, **sp)
        assert out_g == out_e == _serve_loras(es, prompts, loras, **sp)[0]
        assert n_g == n_e
        assert n_g[name] == eg.model_cfg.n_layers * (eg.decode_ticks - t0)
        assert out_g[0] == out_g[1]            # zero adapter == base
    c1, g1 = eg.compiles, eg.graph_captures
    eg.register_lora("another", ads["zero"])
    assert (eg.compiles, eg.graph_captures) == (c1, g1)
    out_g, _ = _serve_loras(eg, prompts, ["another", None, "strong",
                                          "strong"], max_tokens=12)
    assert eg.graph_captures == g1 and out_g[0] == out_g[1]
    eg.release_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
def test_multistep_graph_engine_matches_single_step(dev, kind):
    """decode_steps_per_call=4 on the card: one graph replay a round,
    step-exact against K=1 and against the eager round, with adapters;
    decode launches equal layers x (ticks + 4 x rounds); a steady window
    of rounds makes no upload and no capture and reads back once a
    round."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    kw = dict(max_batch_size=4, page_size=16, num_pages=129, seed=3,
              kv_dtype=kind)
    e1 = InferenceEngine(EngineConfig(**kw))
    e4 = InferenceEngine(EngineConfig(decode_steps_per_call=4, **kw),
                         params=e1.params)
    ee = InferenceEngine(EngineConfig(decode_steps_per_call=4,
                                      cuda_graph=False, **kw),
                         params=e1.params)
    ads = _lora_adapters(e1.model_cfg)
    for e in (e1, e4, ee):
        e.register_loras(ads)
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(2, 250, (n,), generator=gen).tolist()
               for n in (33, 7, 60, 21)]
    loras = [None, "strong", "zero", None]
    name = "paged_decode" + ("" if kind == "f32" else f"_{kind}")
    for sp in (dict(max_tokens=14),
               dict(max_tokens=14, temperature=0.8, top_p=0.95, top_k=50)):
        t0, r0 = e4.decode_ticks, e4.multi_rounds
        out4, n4 = _serve_loras(e4, prompts, loras, **sp)
        assert out4 == _serve_loras(e1, prompts, loras, **sp)[0]
        assert out4 == _serve_loras(ee, prompts, loras, **sp)[0]
        rounds = e4.multi_rounds - r0
        assert rounds > 0
        assert n4[name] == e4.model_cfg.n_layers * (
            e4.decode_ticks - t0 + 4 * rounds)
    from ray_tpu_torch import Request, SamplingParams
    for i, lo in enumerate(loras):
        e4.add_request(Request(f"s{i}", list(prompts[i]), SamplingParams(
            max_tokens=120, temperature=0.8, top_k=20), lora=lo))
    while e4.waiting or any(s.request is not None and not s.ready
                            for s in e4.slots):
        e4.step()
    e4.step()
    with dispatch_guard(engine=e4) as report:
        for _ in range(8):
            e4.step()
    assert report.uploads == [] and report.captures == []
    assert report.readbacks == 8
    e4.release_graphs()
    e1.release_graphs()


# ---------------------------- speculative decoding and the legacy step

def _spec_prompts(seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(2, 250, (n,), generator=gen).tolist()
            for n in (40, 3, 17, 90, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["perfect", "bf16_d64"])
def test_spec_engine_matches_default_engine(dev, draft):
    """A speculative engine on the card (float32 `debug` target, k 4)
    against the default engine on the same weights: the same greedy
    tokens; the ragged kernel launched layers x mixed ticks and the
    draft's decode kernel draft layers x (k-2) x draft dispatches (a
    bf16 draft at head_dim 64 on the pipelined route); a sampled request
    in the batch falls back to decode ticks and still finishes."""
    from ray_tpu_torch import EngineConfig, InferenceEngine, SamplingParams
    from ray_tpu_torch.models import llama
    cfg = llama.config("debug", dtype=torch.float32)
    kw = dict(model=cfg, max_batch_size=4, page_size=16, num_pages=129,
              seed=3)
    base = InferenceEngine(EngineConfig(**kw))
    if draft == "perfect":
        spec = {"draft_model": cfg, "draft_params": base.params}
    else:
        spec = {"draft_model": llama.config(
            "debug", head_dim=64, n_heads=4, n_kv_heads=2,
            dtype=torch.bfloat16)}
    eng = InferenceEngine(EngineConfig(speculative=dict(
        num_speculative_tokens=4, **spec), **kw), params=base.params)
    prompts = _spec_prompts(21)
    want, _ = _serve(base, prompts, max_tokens=20)
    calls = []
    own = eng._spec_draft
    eng._spec_draft = lambda *a, **k: calls.append(1) or own(*a, **k)
    r0 = eng.ragged_ticks
    got, counts = _serve(eng, prompts, max_tokens=20)
    assert got == want
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["decode_ticks"] == 0
    assert counts["ragged_paged"] == cfg.n_layers * (eng.ragged_ticks - r0)
    dl = eng._spec["cfg"].n_layers
    assert counts["paged_decode"] == dl * 2 * len(calls) > 0
    route = "cuda_core" if draft == "perfect" else "pipelined"
    assert _kernels.route_counts()["paged_decode"] == {
        route: counts["paged_decode"]}
    if draft == "perfect":
        assert st["spec_acceptance_rate"] > 0.6
    from ray_tpu_torch import Request
    s = Request("samp", prompts[3], SamplingParams(max_tokens=8,
                                                   temperature=0.9))
    g = Request("greedy", prompts[0], SamplingParams(max_tokens=30))
    eng.add_request(g)
    eng.step()
    eng.add_request(s)
    while eng.has_work():
        eng.step()
    assert len(s.output_tokens) == 8 and eng.stats()["decode_ticks"] > 0
    [ref] = base.generate([prompts[0]], SamplingParams(max_tokens=30))
    assert g.output_tokens == ref.output_tokens
    base.release_graphs()
    eng.release_graphs()


@pytest.mark.cuda
def test_legacy_engine_matches_unified_engine(dev):
    """unified_step=False on the card (float32 `debug`): the unified
    engine's greedy and penalty tokens; no ragged launch, the decode
    kernel layers x decode ticks; more dispatches than ticks."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import llama
    cfg = llama.config("debug", dtype=torch.float32)
    kw = dict(model=cfg, max_batch_size=3, page_size=16, num_pages=129,
              seed=4, max_prefill_tokens=32)
    uni = InferenceEngine(EngineConfig(**kw))
    leg = InferenceEngine(EngineConfig(unified_step=False, **kw),
                          params=uni.params)
    prompts = _spec_prompts(22)
    for sp in (dict(max_tokens=12), dict(max_tokens=10,
                                         repetition_penalty=1.3)):
        want, _ = _serve(uni, prompts, **sp)
        t0, d0, k0 = leg.decode_ticks, leg.dispatches, leg.ticks
        got, counts = _serve(leg, prompts, **sp)
        assert got == want
        assert counts["ragged_paged"] == 0
        assert counts["paged_decode"] == cfg.n_layers * (
            leg.decode_ticks - t0) > 0
        assert leg.dispatches - d0 > leg.ticks - k0
    st = leg.stats()
    assert st["compile_cache"]["chunk_buckets"] > 0
    assert st["compile_cache"]["prefill_buckets"] > 0
    uni.release_graphs()
    leg.release_graphs()


def _fleet_engines(n, **over):
    """n `tiny` float32 engines on the card over one set of weights."""
    from ray_tpu_torch import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import llama
    kw = dict(model=llama.config("tiny", dtype=torch.float32),
              max_batch_size=4, page_size=16, num_pages=129, seed=5,
              max_prefill_tokens=64, **over)
    first = InferenceEngine(EngineConfig(**kw))
    return [first] + [InferenceEngine(EngineConfig(**kw),
                                      params=first.params)
                      for _ in range(n - 1)]


def _fleet_requests(tag, prompts, sampled):
    from ray_tpu_torch import Request, SamplingParams
    sp = (dict(temperature=0.8, top_p=0.95, top_k=50) if sampled else {})
    return [Request(f"{tag}{i}", list(p), SamplingParams(
        max_tokens=24, seed=100 + i, **sp)) for i, p in enumerate(prompts)]


def _run_engine(eng, reqs, start=None):
    if start is not None:
        start.wait(timeout=60)
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


@pytest.mark.cuda
def test_fleet_two_engines_step_concurrently(dev):
    """Two engines of one process on one card (a fleet's two replicas),
    stepped from two threads at once from their first tick, so each
    captures its decode graph while the other works: each engine's
    tokens equal those of the same engine alone, the launch counters
    are the sum of each alone, every engine captured its graph and none
    crashed (an invalidated capture raises out of step()). The engines
    share the device's lock."""
    import threading
    gen = torch.Generator().manual_seed(11)
    prompts = [torch.randint(2, 2000, (n,), generator=gen).tolist()
               for n in (40, 3, 17, 90, 9, 64)]
    alone = _fleet_engines(2)
    assert alone[0]._step_lock is alone[1]._step_lock
    want, counts_alone = [], {}
    for i, eng in enumerate(alone):
        _kernels.reset_launch_counts()
        want.append(_run_engine(eng, _fleet_requests("a", prompts, i == 1)))
        for k, v in _kernels.launch_counts().items():
            counts_alone[k] = counts_alone.get(k, 0) + v
    pair = _fleet_engines(2)
    _kernels.reset_launch_counts()
    start = threading.Barrier(2)
    got, errors = [None, None], []

    def worker(i):
        try:
            got[i] = _run_engine(pair[i], _fleet_requests(
                "b", prompts, i == 1), start)
        except BaseException as e:      # reported by the main thread
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert got == want
    assert _kernels.launch_counts() == counts_alone
    assert counts_alone["paged_decode"] > 0 \
        and counts_alone["ragged_paged"] > 0
    for a, b in zip(alone, pair):
        assert b.graph_captures == a.graph_captures >= 1
        assert "engine_crash" not in [
            e["event"] for e in b.telemetry.recorder.events()]
    for e in alone + pair:
        e.release_graphs()


@pytest.mark.cuda
def test_fleet_two_replicas_on_the_card_token_exact(dev):
    """A two-replica fleet on one card (port LLMServerImpl replicas on
    `tiny` float32 engines sharing their weights): 4 unary requests and
    4 streams at once, then a drain to one replica that ships the live
    sessions over the RTKV wire; every request's tokens equal those of
    one synchronous eager engine on the same weights, and the launch
    counters are layers x ticks summed over both replicas."""
    import asyncio
    import dataclasses
    import json
    from ray_tpu_torch import InferenceEngine, LLMServerImpl, Request
    from ray_tpu_torch.serve.llm import (AutoscaleConfig, FleetManager,
                                         LocalReplicaClient, TransportConfig)
    [e0] = _fleet_engines(1, enable_kv_offload=True,
                          metrics_replica_id="r0")
    e1, ref = (InferenceEngine(dataclasses.replace(e0.config, **kw),
                               params=e0.params)
               for kw in (dict(metrics_replica_id="r1"),
                          dict(cuda_graph=False, async_readback=False,
                               metrics_replica_id="ref")))
    submitted = []
    servers = {}
    for eng in (e0, e1):
        add = eng.add_request
        eng.add_request = (lambda a: lambda r: submitted.append(r) or a(r))(
            add)
        rid = eng.config.metrics_replica_id
        servers[rid] = LLMServerImpl({"model_id": "tiny"}, engine=eng)
    fleet = FleetManager(
        [LocalReplicaClient(r, s) for r, s in servers.items()],
        autoscale=AutoscaleConfig(min_replicas=2, max_replicas=2),
        transport=TransportConfig(enable_disagg=False,
                                  enable_prefix_store=False))
    texts = [f"fleet request {i} " * (1 + 3 * i) for i in range(8)]
    ticks0 = [(e.ragged_ticks, e.decode_ticks) for e in (e0, e1)]
    _kernels.reset_launch_counts()

    async def stream(body, started):
        toks = []
        async for c in fleet.dispatch_stream("completions_stream", body):
            if c.startswith("data: {"):
                toks += json.loads(c[6:])["choices"][0]["token_ids"]
                if not started.done():
                    started.set_result(None)
        return toks

    async def main():
        loop = asyncio.get_running_loop()
        started = [loop.create_future() for _ in texts[4:]]
        unary = [fleet.dispatch("completions",
                                {"prompt": t, "max_tokens": 24})
                 for t in texts[:4]]
        streams = [stream({"prompt": t, "max_tokens": 48}, s)
                   for t, s in zip(texts[4:], started)]
        tasks = [asyncio.ensure_future(c) for c in unary + streams]
        await asyncio.wait_for(asyncio.gather(*started), 120)
        fleet._apply_target(1)
        out = await asyncio.wait_for(asyncio.gather(*tasks), 300)
        for s in servers.values():
            s._pump.cancel()
        return out

    out = asyncio.run(main())
    counts = _kernels.launch_counts()
    n_layers = e0.model_cfg.n_layers
    mixed = sum(e.ragged_ticks - t[0] for e, t in zip((e0, e1), ticks0))
    dec = sum(e.decode_ticks - t[1] for e, t in zip((e0, e1), ticks0))
    assert counts["ragged_paged"] == n_layers * mixed > 0
    assert counts["paged_decode"] == n_layers * dec > 0
    assert "session_migrated" in [e["event"]
                                  for e in fleet.recorder.events()]
    tok = servers["r0"].tokenizer
    first = {}
    for r in submitted:                  # the first submission of a prompt
        first.setdefault(tuple(r.prompt_tokens), r)
    for i, text in enumerate(texts):
        r = first[tuple(tok.encode(text))]
        [want] = _run_engine(ref, [Request(f"ref{i}", list(r.prompt_tokens),
                                           r.params)])
        if i < 4:
            assert out[i]["choices"][0]["text"] == tok.decode(want), i
        else:
            assert out[i] == want, i
    for e in (e0, e1):
        e.release_graphs()


# -------------------------------------------------- MoE and checkpoints

def _moe_cfg(**kw):
    """A small MoE config whose attention takes the flash kernels (head
    dim 64, sequences of 256)."""
    from ray_tpu_torch.models import llama
    return llama.config("debug_moe", vocab_size=512, hidden=256, n_heads=4,
                        n_kv_heads=2, head_dim=64, ffn=512, max_seq=256,
                        **kw)


@pytest.mark.cuda
def test_moe_grouped_mm_matches_expert_loop(dev):
    """torch._grouped_mm (a library call the port does not use) against
    the port's per-expert loop on the same expert-sorted bf16 rows,
    forward and the gradients of rows and weights: two bf16 ulps
    (relative 1.6e-2) plus 1e-3 of the largest element. Groups of 0 to
    60 rows, one empty."""
    gen = torch.Generator(device=dev).manual_seed(3)
    sizes = [37, 0, 60, 9, 22, 8, 48, 16]
    x = _randn(gen, (sum(sizes), 128), dev, torch.bfloat16)
    w = _randn(gen, (len(sizes), 128, 256), dev, torch.bfloat16)
    g = _randn(gen, (sum(sizes), 256), dev, torch.bfloat16)
    offs = torch.cumsum(torch.tensor(sizes, device=dev), 0).to(torch.int32)

    def loop(x, w):
        return torch.cat([r @ w[e] for e, r in enumerate(x.split(sizes))])

    def grouped(x, w):
        return torch._grouped_mm(x, w, offs=offs)
    res = []
    for fn in (loop, grouped):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = fn(xg, wg)
        out.backward(g)
        res.append((out.float(), xg.grad.float(), wg.grad.float()))
    for what, a, b in zip(("out", "dx", "dw"), *res):
        tol = 1.6e-2 * a.abs() + 1e-3 * a.abs().max()
        assert ((b - a).abs() <= tol).all(), what


@pytest.mark.cuda
@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_moe_bf16_step_matches_xla_attention(dev, dropless):
    """A small bf16 MoE step through the flash kernels against the same
    step on attention_impl="xla": loss within 5e-3 and grad norm within
    5e-2 (chip_smoke's train tolerances: bf16 activations, rounded at
    other places); flash launches as remat implies."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import TrainStepBundle
    cfg = _moe_cfg(moe_dropless=dropless)
    out = {}
    for impl in ("auto", "xla"):
        tb = TrainStepBundle(llama.config(cfg, attention_impl=impl))
        state = tb.init_state(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        _kernels.reset_launch_counts()
        _, m = tb.step(state, toks)
        out[impl] = {k: v.item() for k, v in m.items()}
        counts = _kernels.launch_counts()
        if impl == "auto":
            assert counts["flash_fwd"] == 2 * cfg.n_layers
            assert counts["flash_dq"] == counts["flash_dkv"] == cfg.n_layers
        else:
            assert counts["flash_fwd"] == 0
    a, b = out["auto"], out["xla"]
    assert abs(a["loss"] - b["loss"]) <= 5e-3 * abs(b["loss"])
    assert abs(a["grad_norm"] - b["grad_norm"]) <= 5e-2 * b["grad_norm"]
    assert a["moe_aux"] > 0


@pytest.mark.cuda
def test_checkpoint_roundtrip_on_the_card(dev, tmp_path):
    """A bf16 tree on the card written and read back onto the card (the
    default device): bit-equal; the trainer's state from it at float32
    equals the upcast tree; an engine from it serves."""
    import dataclasses
    from ray_tpu_torch import EngineConfig, InferenceEngine, Request
    from ray_tpu_torch import SamplingParams
    from ray_tpu_torch.models import checkpoint_io, llama
    from ray_tpu_torch.models.training import TrainStepBundle
    cfg = llama.config("tiny")
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = llama.init_params(
        dataclasses.replace(cfg, param_dtype=torch.bfloat16), gen, dev)
    checkpoint_io.save_llama_checkpoint(cfg, tree, str(tmp_path),
                                        max_shard_bytes=8 << 20)
    checkpoint_io.save_config(cfg, str(tmp_path))
    back = checkpoint_io.load_llama_params(cfg, str(tmp_path),
                                           dtype=torch.bfloat16)

    def flat(t, p=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{p}/{k}").items()}
        return {p: t}
    src = flat(tree)
    for path, t in flat(back).items():
        assert t.is_cuda and torch.equal(t, src[path]), path
    state = TrainStepBundle(cfg).init_state_from_checkpoint(str(tmp_path))
    for path, t in flat(state[0]).items():
        assert t.dtype == torch.float32 and torch.equal(
            t, src[path].float()), path
    eng = InferenceEngine(EngineConfig(model=None,
                                       checkpoint=str(tmp_path)))
    assert eng.model_cfg == cfg
    req = Request("c", list(range(5, 40)), SamplingParams(max_tokens=8))
    eng.add_request(req)
    while eng.has_work():
        eng.step()
    assert len(req.output_tokens) == 8
    eng.release_graphs()


def _rllib_fragment(runner):
    """A runner's next fragment through its stages, with each step's gap
    between the two best Gumbel-perturbed scores [T, B] (on the CPU)."""
    draws = runner._draw()
    out = runner._finish(runner._steps(draws))
    with torch.no_grad():
        logits = runner.module(torch.as_tensor(
            out["batch"]["obs"], device=runner.device))["action_dist_inputs"]
    top = (logits + draws["act"][0]).topk(2, dim=-1).values
    return draws, out, (top[..., 0] - top[..., 1]).cpu().numpy()


@pytest.mark.cuda
def test_rllib_runner_on_the_card_matches_cpu(dev):
    """CartPole, 64 envs x 128 steps, seed 0, the same weights: the card's
    first fragment against the port's on the CPU by the near-tie rule of
    tests/test_torch_rllib_runner.py (each env compared up to its first
    step whose top-two gap is <= 1e-4: actions and dones equal, obs
    within 1e-4); the step loop makes no host sync; the keys and reset
    draws are bit-equal, the Gumbel noise within 2^-22 x max(1, |g|)."""
    from ray_tpu_torch.rllib import SingleAgentEnvRunner
    kw = dict(num_envs=64, rollout_length=128, seed=0)
    cpu = SingleAgentEnvRunner("CartPole-v1", device="cpu", **kw)
    card = SingleAgentEnvRunner("CartPole-v1", device=dev, **kw)
    card.set_weights(cpu.get_weights())
    cdraws, cout, gaps = _rllib_fragment(cpu)
    draws = card._draw()
    torch.testing.assert_close(draws["reset"].cpu(), cdraws["reset"],
                               rtol=0, atol=0)
    g, cg = draws["act"][0].cpu(), cdraws["act"][0]
    assert ((g - cg).abs() <= 2.0 ** -22 * cg.abs().clamp(min=1)).all()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev_batch = card._steps(draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = card._finish(dev_batch)
    b, cb = out["batch"], cout["batch"]
    tied = 0
    for e in range(64):
        for t in range(128):
            where = f"step {t}, env {e}, gap {gaps[t, e]:.3g}"
            assert abs(b["obs"][t, e] - cb["obs"][t, e]).max() <= 1e-4, where
            if gaps[t, e] <= 1e-4:
                tied += 1
                break
            assert b["actions"][t, e] == cb["actions"][t, e], where
            assert b["dones"][t, e] == cb["dones"][t, e], where
    if not tied:
        assert out["stats"] == cout["stats"]
    assert out["stats"]["num_episodes"] > 64


@pytest.mark.cuda
def test_rllib_ppo_iteration_on_the_card(dev):
    """One PPO iteration with the default device: runner and learner on
    the card, the weights synced tensor to tensor, finite metrics."""
    import math
    from ray_tpu_torch.rllib import PPOConfig
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .training(minibatch_size=256, num_epochs=4).build())
    m = algo.train()
    assert m["num_env_steps_sampled"] == 16 * 128
    assert all(math.isfinite(v) for k, v in m.items()
               if k.startswith("learner/"))
    learner = algo.learner_group._local
    assert all(p.is_cuda for p in learner.params)
    assert learner.opt_state["count"] == 4 * 8
    runner_w = algo.env_runner_group.get_weights()
    for k, v in learner.get_weights().items():
        assert runner_w[k].is_cuda and torch.equal(runner_w[k], v), k


def _adam_first_step_close(card, cpu, lr, eps, what):
    """Parameters after one Adam step from the same weights: 1e-6 plus
    what lr g / (|g| + eps) makes of gradients 1e-4 (of themselves and
    of the largest) apart where |g| is small (g from the CPU side's first
    moment, a tenth of the clipped gradient)."""
    mus = [m.abs() / 0.1 for m in cpu["mu"]]
    top = max(float(m.max()) for m in mus)
    for (name, p), pc, g in zip(card["named"], cpu["params"], mus):
        tol = 1e-6 + lr * 2e-4 * (g + 10 * top) / (g + eps)
        err = (p.detach().cpu() - pc.detach()).abs()
        assert (err <= tol).all(), (what, name, float((err - tol).max()))


@pytest.mark.cuda
def test_rllib_sac_update_on_the_card_matches_cpu(dev):
    """One SAC update (critic + actor backward, clipped Adam, the
    temperature's step, the polyak targets) on the card against the
    CPU's from the same weights, batch and key: metrics 1e-4 relative
    plus 1e-4, first moments 2e-4 relative plus 2e-4 of the largest,
    parameters by Adam's first-step bound, targets and log_alpha 1e-6;
    the step itself makes no host sync."""
    import numpy as np
    from ray_tpu_torch.rllib import SACConfig
    from ray_tpu_torch.rllib.algorithms.sac import SACLearner
    from ray_tpu_torch.rllib.env.torch_env import Pendulum
    sides = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        cfg = SACConfig().training(lr=3e-3, action_scale=2.0)
        sides[name] = SACLearner(Pendulum().spec, cfg, device=d)
    cpu, card = sides["cpu"], sides["card"]
    card.set_state(cpu.get_state())
    rng = np.random.default_rng(0)
    f = np.float32
    batch = dict(obs=rng.normal(size=(256, 3)).astype(f),
                 actions=rng.uniform(-2, 2, (256, 1)).astype(f),
                 rewards=rng.normal(size=256).astype(f),
                 dones=(rng.random(256) < 0.1).astype(f),
                 next_obs=rng.normal(size=(256, 3)).astype(f))
    want = cpu.update(batch)
    tb, key = card._to_device(batch), card._next_key()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = card._sac_step(tb, key)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {k: v.item() for k, v in aux.items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    top = max(float(m.abs().max()) for m in cpu.opt_state["mu"])
    for m, mc in zip(card.opt_state["mu"], cpu.opt_state["mu"]):
        torch.testing.assert_close(m.cpu(), mc, rtol=2e-4, atol=2e-4 * top)
    _adam_first_step_close(
        dict(named=list(card.module.named_parameters())),
        dict(params=cpu.params, mu=cpu.opt_state["mu"]), 3e-3, 1e-5, "sac")
    for t, tc in zip(card.target.parameters(), cpu.target.parameters()):
        torch.testing.assert_close(t.cpu(), tc, rtol=0, atol=1e-6)
    assert abs(card.log_alpha.item() - cpu.log_alpha.item()) <= 1e-6


@pytest.mark.cuda
def test_rllib_dreamer_update_on_the_card_matches_cpu(dev):
    """One DreamerV3 update at small widths on the card against the
    CPU's from the same weights, batch and key: the same Gumbel samples
    (argmax of draws 2^-22 apart), metrics 1e-4 relative plus 1e-5,
    each group's first moments and parameters as in the SAC case, the
    return-scale EMA 1e-5; the step makes no host sync."""
    import numpy as np
    from ray_tpu_torch.rllib import DreamerV3Config
    from ray_tpu_torch.rllib.algorithms import dreamer_v3 as pd
    from ray_tpu_torch.rllib.env.torch_env import CartPole
    sides = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        cfg = DreamerV3Config()
        cfg.module_class = pd.DreamerV3Module
        cfg.model_config = dict(deter=32, stoch=4, classes=4, units=32,
                                embed=24, twohot_bins=15)
        cfg.seq_len, cfg.imagine_horizon = 8, 6
        sides[name] = pd.DreamerV3Learner(CartPole().spec, cfg, device=d)
    cpu, card = sides["cpu"], sides["card"]
    card.set_state(cpu.get_state())
    rng = np.random.default_rng(1)
    f = np.float32
    dones = (rng.random((6, 8)) < 0.15).astype(f)
    isf = np.concatenate([np.ones((6, 1), f), dones[:, :-1]], 1)
    batch = dict(obs=(rng.normal(size=(6, 8, 4)) * 2).astype(f),
                 actions=rng.integers(0, 2, (6, 8)).astype(np.int32),
                 rewards=np.ones((6, 8), f), dones=dones, is_first=isf)
    want = cpu.update(batch)
    tb, key = card._to_device(batch), card._next_key()
    scale = torch.ones((), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = card._dreamer_step(tb, key, scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {k: v.item() for k, v in aux.items()}
    spread = got.pop("ret_spread")
    card.ret_scale = 0.99 + 0.01 * max(spread, 1e-8)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert abs(card.ret_scale - cpu.ret_scale) <= 1e-5
    lrs = {"wm": 4e-4, "actor": 1e-4, "critic": 1e-4}
    named = dict(card.module.named_parameters())
    ids = {id(p): k for k, p in named.items()}
    for g, ps in card.groups.items():
        cps = cpu.groups[g]
        cmu = cpu.opt_states[g]["mu"]
        top = max(float(m.abs().max()) for m in cmu)
        for m, mc in zip(card.opt_states[g]["mu"], cmu):
            torch.testing.assert_close(m.cpu(), mc, rtol=1e-4,
                                       atol=1e-4 * top)
        _adam_first_step_close(dict(named=[(ids[id(p)], p) for p in ps]),
                               dict(params=cps, mu=cmu), lrs[g], 1e-8,
                               f"dreamer {g}")


@pytest.mark.cuda
def test_sanitizer_traced_device_lock_two_engines(dev):
    """With the thread sanitizer armed, two `tiny` engines on the card
    share one traced re-entrant lock named after the device (over the
    device's own RLock), step from two threads at once and under a
    dispatch guard, which holds the lock while step() re-enters it: no
    violation, tokens equal to the same engines' disarmed, and the
    re-entries counted by the function that made them."""
    import threading
    from ray_tpu_torch.util import thread_sanitizer as ts
    from ray_tpu_torch.util.dispatch_guard import dispatch_guard
    gen = torch.Generator().manual_seed(12)
    prompts = [torch.randint(2, 2000, (n,), generator=gen).tolist()
               for n in (33, 5, 70, 12)]
    alone = _fleet_engines(2)
    want = [_run_engine(e, _fleet_requests("a", prompts, i == 1))
            for i, e in enumerate(alone)]
    for e in alone:
        e.release_graphs()
    idx = torch.cuda.current_device()
    with ts.sanitized():
        pair = _fleet_engines(2)
        lock = pair[0]._step_lock
        assert isinstance(lock, ts._TracedRLock)
        assert lock is pair[1]._step_lock
        assert lock.name == f"engine._step_lock[cuda:{idx}]"
        assert lock._lock is alone[0]._step_lock
        start = threading.Barrier(2)
        got, errors = [None, None], []

        def worker(i):
            try:
                got[i] = _run_engine(pair[i], _fleet_requests(
                    "b", prompts, i == 1), start)
            except BaseException as e:
                errors.append(e)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert errors == [] and got == want
        # a guarded window holds the lock; step() re-enters it
        eng = pair[0]
        reqs = _fleet_requests("c", prompts[:2], False)
        for r in reqs:
            eng.add_request(r)
        while any(s.request is not None and not s.ready for s in eng.slots) \
                or eng.waiting:
            eng.step()
        for _ in range(3):
            eng.step()
        before = lock.reentries
        with dispatch_guard(max_captures=1, engine=eng):
            for _ in range(4):
                eng.step()
        assert lock.reentries - before >= 4
        assert "InferenceEngine.step" in lock.reentry_sites
        while eng.has_work():
            eng.step()
        ts.assert_clean()
    for e in pair:
        e.release_graphs()


@pytest.mark.cuda
def test_runtime_gpu_task_tensor_comes_back_to_the_host(dev):
    """A num_gpus=1 task computes on the card; its CUDA tensor arrives
    in the driver as a CPU tensor, bit-equal to the same work here."""
    import ray_tpu_torch as rt

    def work(seed):
        import os
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(1 << 16, device="cuda", generator=g)
        return os.environ.get("CUDA_VISIBLE_DEVICES"), (x.sin() * 2).bfloat16()

    rt.init(num_cpus=2)
    try:
        visible, got = rt.get(rt.remote(num_gpus=1)(work).remote(3),
                              timeout=300)
    finally:
        rt.shutdown()
    assert visible == "0"
    assert got.device.type == "cpu" and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       work(3)[1].cpu().view(torch.int16))


@pytest.mark.cuda
def test_runtime_two_gpu_actors_in_turn(dev):
    """The second num_gpus=1 actor waits while the first holds the card,
    then starts in a fresh fork that initializes CUDA."""
    import ray_tpu_torch as rt

    class Holder:
        def __init__(self):
            import os
            self.fresh = not torch.cuda.is_initialized()
            self.x = torch.ones(1, device="cuda")
            self.pid = os.getpid()

        def facts(self):
            return self.pid, self.fresh, torch.cuda.is_initialized()

    rt.init(num_cpus=2)
    try:
        cls = rt.remote(num_gpus=1)(Holder)
        a = cls.remote()
        pa = rt.get(a.facts.remote(), timeout=300)
        b = cls.remote()
        ready, _ = rt.wait([b.facts.remote()], timeout=2.0)
        assert not ready
        rt.kill(a)
        pb = rt.get(b.facts.remote(), timeout=300)
    finally:
        rt.shutdown()
    assert pa[1:] == (True, True) and pb[1:] == (True, True)
    assert pa[0] != pb[0]
