"""ray_tpu_torch.ops.kv_quant and the quantized pool writes/reads of
ray_tpu_torch.ops.paged_attention against the JAX package's.

The quantizer and the quantize-at-append scatter repeat the reference's
arithmetic step for step (float32 absmax, divide by the scale, round
half to even and clip for int8, a straight cast for fp8), so their
values (fp8 compared as bytes) and scales are held BIT-EQUAL to JAX's.
Round-trip bounds and the byte table mirror tests/test_kv_quant.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import kv_quant as jkq
from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import kv_quant as tkq
from ray_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)
KINDS = ("int8", "fp8")
# quantizer round-trip bounds (tests/test_kv_quant.py): int8 has 7 value
# bits per row-scaled lane, fp8 e4m3 about 3 mantissa bits
RT_RTOL = {"int8": 0.01, "fp8": 0.07}


def _bytes(x) -> np.ndarray:
    """Stored values as raw bytes, from a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _rows(seed, shape, lo=-4, hi=4):
    """float32 rows whose magnitudes span 10**lo .. 10**hi, one scale per
    row, with a few all-zero rows."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(lo, hi, size=shape[:-1] + (1,))
    x = (rng.normal(size=shape) * mags).astype(np.float32)
    x.reshape(-1, shape[-1])[::7] = 0.0
    return x


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_rows_bit_equal_to_jax(kind):
    x = _rows(0, (16, 3, 4, 64))
    qj, sj = jkq.quantize_rows(jnp.asarray(x), kind)
    qt, st = tkq.quantize_rows(torch.from_numpy(x), kind)
    assert qt.dtype == tkq.storage_dtype(kind) and st.dtype == torch.float32
    assert tuple(qt.shape) == x.shape and tuple(st.shape) == x.shape[:-1]
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # and the dequantized rows, zero rows included
    dj = np.asarray(jkq.dequantize_rows(qj, sj, kind))
    dt = tkq.dequantize_rows(qt, st, kind).numpy()
    np.testing.assert_array_equal(dt, dj)
    zero = ~x.any(axis=-1)
    assert zero.any() and np.all(dt[zero] == 0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_rows_roundtrip_bounded(kind):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(5, 7, 3, 16)).astype(np.float32)
                         * 4.0)
    y = tkq.dequantize_rows(*tkq.quantize_rows(x, kind), kind=kind)
    rel = float(torch.linalg.norm(y - x) / torch.linalg.norm(x))
    assert rel < RT_RTOL[kind], (kind, rel)


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_rows_zero_rows_exact_and_no_nan(kind):
    q, s = tkq.quantize_rows(torch.zeros((3, 4, 2, 8)), kind)
    y = tkq.dequantize_rows(q, s, kind)
    assert float(y.abs().max()) == 0.0 and not torch.isnan(y).any()


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_rows_scale_extremes(kind):
    """Rows spanning 8 orders of magnitude keep a flat relative error."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(8, 1, 1, 16)).astype(np.float32)
    mags = (10.0 ** np.arange(-4, 4)).reshape(8, 1, 1, 1)
    x = torch.from_numpy((base * mags).astype(np.float32))
    y = tkq.dequantize_rows(*tkq.quantize_rows(x, kind), kind=kind)
    for i in range(8):
        rel = float(torch.linalg.norm(y[i] - x[i]) / torch.linalg.norm(x[i]))
        assert rel < RT_RTOL[kind], (kind, i, rel)


def test_kind_table_and_bytes_match_jax():
    assert tkq.KV_KINDS == jkq.KV_KINDS
    assert tkq.SCALE_BYTES == jkq.SCALE_BYTES
    for kind in tkq.KV_KINDS:
        assert tkq.validate_kind(kind) == kind
        assert tkq.is_quantized(kind) == jkq.is_quantized(kind)
        assert tkq.value_bytes(kind) == jkq.value_bytes(kind)
        for kvh, d in ((2, 32), (8, 128)):
            assert tkq.token_row_bytes(kind, kvh, d) == \
                jkq.token_row_bytes(kind, kvh, d)
    for kind in KINDS:
        assert tkq.qmax(kind) == jkq.qmax(kind)
        assert torch.tensor([], dtype=tkq.storage_dtype(kind)).element_size() \
            == np.dtype(jkq.storage_dtype(kind)).itemsize
        assert tkq.kind_of(tkq.storage_dtype(kind)) == kind
    assert tkq.storage_dtype("int8") == torch.int8
    assert tkq.storage_dtype("fp8") == torch.float8_e4m3fn
    # "f32" pools are in the model's compute dtype
    assert tkq.storage_dtype("f32", torch.bfloat16) == torch.bfloat16
    assert tkq.scale_shape((2, 5, 4, 3, 16)) == \
        jkq.scale_shape((2, 5, 4, 3, 16)) == (2, 5, 4, 3)
    with pytest.raises(ValueError):
        tkq.validate_kind("int4")
    with pytest.raises(ValueError):
        tkq.quantize_rows(torch.zeros((2, 4)), "f32")
    with pytest.raises(TypeError):
        tkq.kind_of(torch.bfloat16)


def _scatter_case(seed, kind, L=2, P=24, page=4, kvh=2, d=16, n=11):
    rng = np.random.default_rng(seed)
    k0, ks0 = tkq.quantize_rows(torch.from_numpy(_rows(seed + 1,
                                                       (L, P, page, kvh, d))),
                                kind)
    v0, vs0 = tkq.quantize_rows(torch.from_numpy(_rows(seed + 2,
                                                       (L, P, page, kvh, d))),
                                kind)
    tables = rng.permutation(P - 1)[:n * 2].reshape(n, 2)
    return dict(
        k=k0, v=v0, ks=ks0, vs=vs0,
        k_new=_rows(seed + 3, (n, L, kvh, d), -3, 3),
        v_new=_rows(seed + 4, (n, L, kvh, d), -3, 3),
        tables=tables.astype(np.int32),
        positions=rng.integers(0, 2 * page, n).astype(np.int32),
        valid=np.asarray([1, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0][:n], bool))


def _to_jax(t: torch.Tensor):
    """A torch pool to a JAX array of the same storage dtype, by bytes."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            jnp.float8_e4m3fn))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_scatter_kv_quant_bit_equal_to_jax(kind):
    c = _scatter_case(3, kind)
    kj, vj, ksj, vsj = jpa.scatter_kv_quant(
        _to_jax(c["k"]), _to_jax(c["v"]), jnp.asarray(c["ks"].numpy()),
        jnp.asarray(c["vs"].numpy()), jnp.asarray(c["k_new"]),
        jnp.asarray(c["v_new"]), jnp.asarray(c["tables"]),
        jnp.asarray(c["positions"]), jnp.asarray(c["valid"]), kind)
    kt, vt, kst, vst = (c[n].clone() for n in ("k", "v", "ks", "vs"))
    out = tpa.scatter_kv_quant(
        kt, vt, kst, vst, torch.from_numpy(c["k_new"]),
        torch.from_numpy(c["v_new"]), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["positions"]), torch.from_numpy(c["valid"]), kind)
    assert all(a is b for a, b in zip(out, (kt, vt, kst, vst)))  # in place
    # every page but the scratch page (last) is bit-equal
    for t, j in ((kt, kj), (vt, vj)):
        np.testing.assert_array_equal(_bytes(t)[:, :-1], _bytes(j)[:, :-1])
    for t, j in ((kst, ksj), (vst, vsj)):
        np.testing.assert_array_equal(t.numpy()[:, :-1], np.asarray(j)[:, :-1])
    # invalid rows land on the scratch page only: each scratch row holds
    # one invalid row's quantized values and scale, or its old contents
    page = kt.shape[2]
    kq, ks = tkq.quantize_rows(torch.from_numpy(c["k_new"]), kind)
    by_row = {}
    for i in np.flatnonzero(~c["valid"]):
        by_row.setdefault(int(c["positions"][i] % page), []).append(i)
    for r in range(page):
        got = (_bytes(kt)[:, -1, r], kst.numpy()[:, -1, r])
        cands = ([(_bytes(kq[i].contiguous()), ks[i].numpy())
                  for i in by_row[r]] if r in by_row else
                 [(_bytes(c["k"])[:, -1, r], c["ks"].numpy()[:, -1, r])])
        assert any(np.array_equal(got[0], a) for a, _ in cands)
        assert any(np.array_equal(got[1], b) for _, b in cands)


@pytest.mark.parametrize("kind", KINDS)
def test_scatter_quant_write_only_append(kind):
    """Appending a row leaves the rows written before it byte for byte."""
    rng = np.random.default_rng(4)
    L, P, page, kvh, d = 1, 3, 4, 1, 16
    kp = torch.zeros((L, P, page, kvh, d), dtype=tkq.storage_dtype(kind))
    vp = torch.zeros_like(kp)
    ks = torch.zeros((L, P, page, kvh))
    vs = torch.zeros_like(ks)

    def append(pos):
        kn = torch.from_numpy(rng.normal(size=(1, L, kvh, d))
                              .astype(np.float32))
        tpa.scatter_kv_quant(kp, vp, ks, vs, kn, kn,
                             torch.tensor([[0, 1]], dtype=torch.int32),
                             torch.tensor([pos], dtype=torch.int32),
                             torch.ones(1, dtype=torch.bool), kind)

    append(0)
    before, sbefore = _bytes(kp[0, 0, 0]).copy(), ks[0, 0, 0].clone()
    append(1)
    np.testing.assert_array_equal(_bytes(kp[0, 0, 0]), before)
    assert torch.equal(ks[0, 0, 0], sbefore)
    assert ks[0, 0, 1].abs().sum() > 0


@pytest.mark.parametrize("kind", KINDS)
def test_gather_quant_matches_jax(kind):
    c = _scatter_case(5, kind)
    tables = np.asarray([[3, 0, 7], [1, 1, 10]], np.int32)
    kj, vj = jpa.gather_kv_quant(
        _to_jax(c["k"]), _to_jax(c["v"]), jnp.asarray(c["ks"].numpy()),
        jnp.asarray(c["vs"].numpy()), jnp.asarray(tables))
    kt, vt = tpa.gather_kv_quant(c["k"], c["v"], c["ks"], c["vs"],
                                 torch.from_numpy(tables))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    one = tpa.gather_layer_quant(c["k"][1], c["ks"][1],
                                 torch.from_numpy(tables))
    assert one.dtype == torch.float32
    np.testing.assert_array_equal(one.numpy(), np.asarray(kj[1]))
