"""ray_tpu_torch.ops.paged_attention against ray_tpu.ops.paged_attention.

The port's decode kernel runs only on a CUDA card; on the CPU its
wrappers run the plain PyTorch versions, which are held here against
the JAX Pallas kernels in interpret mode (as tests/test_paged_kernel.py
runs them) and against the dense reference. The kernel itself is held
against the plain version by tests/test_torch_cuda_kernels.py (and
chip_smoke.py) on the card.

Tolerances: float32 throughout, 2e-5 — the JAX kernels and the port sum
the same float32 products in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(seed, B, H, KVH, D, num_pages, page_size, max_pages, lens):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(num_pages, page_size, KVH, D)).astype(np.float32)
    v = rng.normal(size=(num_pages, page_size, KVH, D)).astype(np.float32)
    tables = rng.permutation(num_pages - 1)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k_new = rng.normal(size=(B, KVH, D)).astype(np.float32)
    v_new = rng.normal(size=(B, KVH, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, tables=tables,
                lens=np.asarray(lens, np.int32), k_new=k_new, v_new=v_new)


def _t(c, *names):
    return [torch.from_numpy(np.array(c[n])) for n in names]


def _j(c, *names):
    return [jnp.asarray(c[n]) for n in names]


def _decode_f64(c):
    """A case's decode sums in float64 numpy (keys at positions
    < max(seq_len, 1)): out, m and l, the yardstick a failing comparison
    measures each side against."""
    q, k, v, tables, lens = (c[n] for n in ("q", "k", "v", "tables", "lens"))
    b, h, d = q.shape
    kvh = k.shape[2]
    kg = k[tables].reshape(b, -1, kvh, d).astype(np.float64)
    vg = v[tables].reshape(b, -1, kvh, d).astype(np.float64)
    qg = q.reshape(b, kvh, h // kvh, d).astype(np.float64)
    s = np.einsum("bkgd,bckd->bkgc", qg, kg) * d ** -0.5
    live = np.arange(kg.shape[1])[None, :] < np.maximum(lens, 1)[:, None]
    s = np.where(live[:, None, None], s, -np.inf)
    m = s.max(-1)
    p = np.exp(s - m[..., None])
    l = p.sum(-1)
    out = np.einsum("bkgc,bckd->bkgd", p, vg) / l[..., None]
    return out.reshape(b, h, d), m.reshape(b, h), l.reshape(b, h)


def _process_state():
    """The host and the process settings that could move either side's
    float32 sums, for a failure message."""
    import platform

    import jax
    cpu = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name")), cpu)
    except OSError:
        pass
    return dict(
        cpu=cpu, torch_cpu_capability=torch.backends.cpu.get_cpu_capability(),
        torch_threads=torch.get_num_threads(),
        torch_matmul_precision=torch.get_float32_matmul_precision(),
        mkldnn_matmul_precision=getattr(torch.backends.mkldnn.matmul,
                                        "fp32_precision", None),
        jax_matmul_precision=jax.config.jax_default_matmul_precision,
        jax_x64=jax.config.jax_enable_x64, torch=torch.__version__,
        jax=jax.__version__)


def _assert_decode_close(c, port, ref):
    """The port's (out, m, l) against JAX's, each within TOL. A failure
    also says, for each of out, m and l, where the two sides differ most
    and how far each lies from the float64 sums (which side moved), and
    the host and process state."""
    names = ("out", "m", "l")
    for name, t, j in zip(names, port, ref):
        try:
            np.testing.assert_allclose(t, j, **TOL)
        except AssertionError as e:
            lines = []
            for n, tt, jj, ff in zip(names, port, ref, _decode_f64(c)):
                at = tuple(int(i) for i in np.unravel_index(
                    np.argmax(np.abs(tt - jj)), tt.shape))
                lines.append(
                    f"{n}: |port-jax| {np.abs(tt - jj).max():.3e} at {at} "
                    f"(port {float(tt[at])!r}, jax {float(jj[at])!r}, "
                    f"f64 {float(ff[at])!r}); "
                    f"|port-f64| {np.abs(tt - ff).max():.3e}, "
                    f"|jax-f64| {np.abs(jj - ff).max():.3e}")
            raise AssertionError(f"{name}: {e}\n" + "\n".join(lines)
                                 + f"\n{_process_state()}") from None


CASES = [
    # name, B, H, KVH, D, num_pages, page_size, max_pages, lens
    ("narrow", 3, 8, 4, 64, 32, 16, 8, [5, 37, 128]),
    ("gqa4", 4, 8, 2, 32, 40, 8, 8, [1, 9, 64, 33]),
    ("mha", 2, 4, 4, 32, 20, 4, 6, [24, 7]),
]


@pytest.mark.parametrize("name,B,H,KVH,D,P,page,maxp,lens", CASES)
def test_decode_plain_matches_pallas_interpret(name, B, H, KVH, D, P, page,
                                               maxp, lens):
    """Plain decode (with stats) vs the one-page-per-step Pallas kernel
    (`_paged_decode_kernel`, what interpret mode runs)."""
    c = _case(len(name), B, H, KVH, D, P, page, maxp, lens)
    out_j, m_j, l_j = jpa.paged_decode_attention(
        *_j(c, "q", "k", "v", "tables", "lens"), return_stats=True,
        interpret=True)
    out_t, m_t, l_t = tpa.paged_decode_attention(
        *_t(c, "q", "k", "v", "tables", "lens"), return_stats=True)
    _assert_decode_close(c, [x.numpy() for x in (out_t, m_t, l_t)],
                         [np.asarray(x) for x in (out_j, m_j, l_j)])


def test_decode_plain_matches_multipage_interpret():
    """Plain decode vs the multi-page Pallas kernel
    (`_paged_decode_kernel_mp`, the TPU hot path) in interpret mode —
    including the seq_len 0 row, which attends one key there and here."""
    c = _case(3, 3, 8, 4, 64, 100, 8, 32, [0, 77, 256])
    out_j, m_j, l_j = jpa._paged_decode_multipage(
        *_j(c, "q", "k", "v", "tables", "lens"), ppb=4, interpret=True)
    out_t, m_t, l_t = tpa.paged_decode_attention(
        *_t(c, "q", "k", "v", "tables", "lens"), return_stats=True)
    _assert_decode_close(c, [x.numpy() for x in (out_t, m_t, l_t)],
                         [np.asarray(out_j).reshape(3, 8, 64),
                          np.asarray(m_j).reshape(3, 8),
                          np.asarray(l_j).reshape(3, 8)])


@pytest.mark.parametrize("name,B,H,KVH,D,P,page,maxp,lens", CASES)
def test_decode_with_new_token_matches_jax(name, B, H, KVH, D, P, page,
                                           maxp, lens):
    c = _case(7 + len(name), B, H, KVH, D, P, page, maxp, lens)
    ref = jpa.paged_decode_with_new_token(
        *_j(c, "q", "k", "v", "tables", "lens", "k_new", "v_new"),
        interpret=True)
    out = tpa.paged_decode_with_new_token(
        *_t(c, "q", "k", "v", "tables", "lens", "k_new", "v_new"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # and the dense reference with the new token appended
    kt, vt, tb = _t(c, "k", "v", "tables")
    kn, vn = _t(c, "k_new", "v_new")
    k_full = torch.cat([tpa.gather_layer(kt, tb), kn[:, None]], 1)
    v_full = torch.cat([tpa.gather_layer(vt, tb), vn[:, None]], 1)
    dense = tpa.paged_attention_on_gathered(
        torch.from_numpy(c["q"]), k_full, v_full,
        torch.from_numpy(c["lens"]), append_len=1)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)


def test_gather_and_dense_attention_match_jax():
    rng = np.random.default_rng(5)
    L, P, page, KVH, D, B, H = 2, 12, 4, 2, 8, 3, 4
    k = rng.normal(size=(L, P, page, KVH, D)).astype(np.float32)
    v = rng.normal(size=(L, P, page, KVH, D)).astype(np.float32)
    tables = rng.integers(0, P - 1, (B, 3)).astype(np.int32)
    kj, vj = jpa.gather_kv(jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(tables))
    kt, vt = tpa.gather_kv(torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(tables))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(
        tpa.gather_layer(torch.from_numpy(k[1]),
                         torch.from_numpy(tables)).numpy(), np.asarray(kj[1]))
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    lens = np.asarray([3, 12, 7], np.int32)
    for append in (0, 1):
        ref = jpa.paged_attention_on_gathered(
            jnp.asarray(q), kj[0], vj[0], jnp.asarray(lens),
            append_len=append)
        out = tpa.paged_attention_on_gathered(
            torch.from_numpy(q), kt[0], vt[0], torch.from_numpy(lens),
            append_len=append)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_kv_matches_jax(dtype):
    """In-place scatter vs JAX's functional one: valid rows land on their
    own pages at the same flat rows; invalid rows only touch the scratch
    page (whose final contents depend on write order on both sides)."""
    rng = np.random.default_rng(6)
    L, P, page, KVH, D, N = 2, 24, 4, 2, 8, 9
    k0 = rng.normal(size=(L, P, page, KVH, D)).astype(np.float32)
    v0 = rng.normal(size=(L, P, page, KVH, D)).astype(np.float32)
    tables = rng.permutation(P - 1)[:N * 2].reshape(N, 2).astype(np.int32)
    positions = rng.integers(0, 2 * page, N).astype(np.int32)
    valid = np.asarray([1, 1, 0, 1, 0, 1, 1, 0, 1], bool)
    k_new = rng.normal(size=(N, L, KVH, D)).astype(np.float32)
    v_new = rng.normal(size=(N, L, KVH, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kj, vj = jpa.scatter_kv(
        jnp.asarray(k0, jdt), jnp.asarray(v0, jdt), jnp.asarray(k_new, jdt),
        jnp.asarray(v_new, jdt), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(valid))
    kt = torch.from_numpy(k0).to(tdt)
    vt = torch.from_numpy(v0).to(tdt)
    rk, rv = tpa.scatter_kv(kt, vt, torch.from_numpy(k_new).to(tdt),
                            torch.from_numpy(v_new).to(tdt),
                            torch.from_numpy(tables),
                            torch.from_numpy(positions),
                            torch.from_numpy(valid))
    assert rk is kt and rv is vt                      # written in place
    kj32 = np.asarray(kj.astype(jnp.float32))
    vj32 = np.asarray(vj.astype(jnp.float32))
    np.testing.assert_array_equal(kt.float().numpy()[:, :-1],
                                  kj32[:, :-1])
    np.testing.assert_array_equal(vt.float().numpy()[:, :-1],
                                  vj32[:, :-1])
    # each scratch row holds one invalid row's values, or its old ones
    scratch = kt.float().numpy()[:, -1]               # [L, page, KVH, D]
    old = torch.from_numpy(k0).to(tdt).float().numpy()[:, -1]
    knew = torch.from_numpy(k_new).to(tdt).float().numpy()
    by_row = {}
    for i in np.flatnonzero(~valid):
        by_row.setdefault(int(positions[i] % page), []).append(i)
    for r in range(page):
        if r in by_row:
            assert any(np.array_equal(scratch[:, r], knew[i])
                       for i in by_row[r])
        else:
            np.testing.assert_array_equal(scratch[:, r], old[:, r])


def test_decode_args_are_checked():
    c = _case(9, 2, 8, 4, 32, 10, 4, 3, [3, 5])
    q, k, v, tb, ln = _t(c, "q", "k", "v", "tables", "lens")
    tpa._check_decode_args(q, k, v, tb, ln)
    with pytest.raises(TypeError):
        tpa._check_decode_args(q, k, v, tb.long(), ln)
    with pytest.raises(TypeError):
        tpa._check_decode_args(q.double(), k, v, tb, ln)
    with pytest.raises(ValueError):
        tpa._check_decode_args(q[:, :6], k, v, tb, ln)
    with pytest.raises(ValueError):
        tpa._check_decode_args(q, k, v, tb.t().contiguous().t(), ln)
    with pytest.raises(ValueError):
        tpa._check_decode_args(q, k, v, tb, ln, k_new=q, v_new=q)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q.to("meta"), k, v, tb, ln)


# ------------------------------------------------------- quantized pools

def _quant_case(seed, kind, B, H, KVH, D, num_pages, page_size, max_pages,
                lens):
    """_case with int8/fp8 pools and their scale pools, quantized by the
    JAX quantizer; the torch side gets the same bytes."""
    from ray_tpu.ops import kv_quant as jkq
    c = _case(seed, B, H, KVH, D, num_pages, page_size, max_pages, lens)
    # magnitudes ramping over 3.5 orders across pages (a mixed-up scale
    # row would be off by orders of magnitude), at most ~3: the scores
    # stay in the range where 2e-5 bounds a float32 reordering
    mags = 10.0 ** np.linspace(-3, 0.5, num_pages, dtype=np.float32)
    for n in ("k", "v"):
        q, s = jkq.quantize_rows(jnp.asarray(c[n] * mags[:, None, None,
                                                          None]), kind)
        c[n] = np.asarray(q)
        c[n + "s"] = np.asarray(s)
    return c


def _tq(c, *names):
    """torch tensors of the case's arrays; fp8 pools by their bytes."""
    out = []
    for n in names:
        a = np.array(c[n])
        if a.dtype == jnp.float8_e4m3fn:
            out.append(torch.from_numpy(a.view(np.uint8)).view(
                torch.float8_e4m3fn))
        else:
            out.append(torch.from_numpy(a))
    return out


QUANT_CASES = [
    # name, B, H, KVH, D, num_pages, page_size, max_pages, lens
    ("narrow", 3, 8, 4, 64, 32, 16, 8, [5, 37, 128]),
    ("gqa4", 4, 8, 2, 32, 40, 8, 8, [1, 9, 64, 33]),
]


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("name,B,H,KVH,D,P,page,maxp,lens", QUANT_CASES)
def test_quant_decode_plain_matches_pallas_interpret(name, B, H, KVH, D, P,
                                                     page, maxp, lens, kind):
    """Plain decode over int8/fp8 pools vs the quantized branch of the
    one-page Pallas kernel (`_paged_decode_kernel`) in interpret mode."""
    c = _quant_case(len(name), kind, B, H, KVH, D, P, page, maxp, lens)
    out_j, m_j, l_j = jpa.paged_decode_attention(
        *_j(c, "q", "k", "v", "tables", "lens"), return_stats=True,
        k_scales=jnp.asarray(c["ks"]), v_scales=jnp.asarray(c["vs"]),
        interpret=True)
    ks, vs = _tq(c, "ks", "vs")
    out_t, m_t, l_t = tpa.paged_decode_attention(
        *_tq(c, "q", "k", "v", "tables", "lens"), return_stats=True,
        k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quant_decode_plain_matches_multipage_interpret(kind):
    """Plain decode over quantized pools vs the quantized branch of the
    multi-page Pallas kernel (`_paged_decode_kernel_mp`), seq_len 0 row
    included (it attends one key on both)."""
    c = _quant_case(3, kind, 3, 8, 4, 64, 100, 8, 32, [0, 77, 256])
    out_j, m_j, l_j = jpa._paged_decode_multipage(
        *_j(c, "q", "k", "v", "tables", "lens"), ppb=4, interpret=True,
        k_scales=jnp.asarray(c["ks"]), v_scales=jnp.asarray(c["vs"]))
    ks, vs = _tq(c, "ks", "vs")
    out_t, m_t, l_t = tpa.paged_decode_attention(
        *_tq(c, "q", "k", "v", "tables", "lens"), return_stats=True,
        k_scales=ks, v_scales=vs)
    _assert_decode_close(c, [x.numpy() for x in (out_t, m_t, l_t)],
                         [np.asarray(out_j).reshape(3, 8, 64),
                          np.asarray(m_j).reshape(3, 8),
                          np.asarray(l_j).reshape(3, 8)])


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("name,B,H,KVH,D,P,page,maxp,lens", QUANT_CASES)
def test_quant_decode_with_new_token_matches_jax(name, B, H, KVH, D, P, page,
                                                 maxp, lens, kind):
    c = _quant_case(7 + len(name), kind, B, H, KVH, D, P, page, maxp, lens)
    ref = jpa.paged_decode_with_new_token(
        *_j(c, "q", "k", "v", "tables", "lens", "k_new", "v_new"),
        k_scales=jnp.asarray(c["ks"]), v_scales=jnp.asarray(c["vs"]),
        interpret=True)
    ks, vs = _tq(c, "ks", "vs")
    args = _tq(c, "q", "k", "v", "tables", "lens", "k_new", "v_new")
    out = tpa.paged_decode_with_new_token(*args, k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the kernel path's plain version and the dense reference over the
    # dequantized, gathered context with the new token appended agree
    plain = tpa.paged_decode_with_new_token_plain(*args, k_scales=ks,
                                                  v_scales=vs)
    assert torch.equal(out, plain)
    q, kp, vp, tb, ln, kn, vn = args
    k_full = torch.cat([tpa.gather_layer_quant(kp, ks, tb), kn[:, None]], 1)
    v_full = torch.cat([tpa.gather_layer_quant(vp, vs, tb), vn[:, None]], 1)
    dense = tpa.paged_attention_on_gathered(q, k_full, v_full, ln,
                                            append_len=1)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)


def test_quant_decode_args_are_checked():
    c = _quant_case(9, "int8", 2, 8, 4, 32, 10, 4, 3, [3, 5])
    q, k, v, tb, ln, ks, vs = _tq(c, "q", "k", "v", "tables", "lens", "ks",
                                  "vs")
    assert tpa._check_decode_args(q, k, v, tb, ln, k_scales=ks,
                                  v_scales=vs) == 1
    assert tpa._check_decode_args(
        q, k.view(torch.float8_e4m3fn), v.view(torch.float8_e4m3fn), tb, ln,
        k_scales=ks, v_scales=vs) == 2
    with pytest.raises(ValueError):                 # one scale pool alone
        tpa._check_decode_args(q, k, v, tb, ln, k_scales=ks)
    with pytest.raises(TypeError):                  # int8 pools, no scales
        tpa._check_decode_args(q, k, v, tb, ln)
    with pytest.raises(ValueError):                 # scales of another shape
        tpa._check_decode_args(q, k, v, tb, ln, k_scales=ks[..., :1],
                               v_scales=vs[..., :1])
    with pytest.raises(TypeError):                  # bf16 pools with scales
        tpa._check_decode_args(q, k.float(), v.float(), tb, ln, k_scales=ks,
                               v_scales=vs)
