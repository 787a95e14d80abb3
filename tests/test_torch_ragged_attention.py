"""ray_tpu_torch.ops.ragged_paged_attention against
ray_tpu.ops.ragged_paged_attention.

On the CPU the kernel entry `ragged_paged_attention` runs its plain
version; here it is held against the JAX Pallas ragged kernel in
interpret mode and the dense numpy oracle, on the segment cases of
tests/test_ragged_attention.py (pure decode, pure prefill, mixed,
single-token prompts, page-straddling chunks, padding rows, GQA
widths, partial last pages, start=0, all padding). The segment map the
CUDA kernel reads (`ragged_plan`) is checked here too; the kernel itself
is held against the plain version by tests/test_torch_cuda_kernels.py
(and chip_smoke.py) on the card.

Tolerances: float32 — 2e-4/2e-5 against the oracle (the JAX op's own
gate), 2e-3 against the interpret-mode kernel (its gate).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import ragged_paged_attention as jrpa
from ray_tpu_torch.ops import ragged_paged_attention as trpa

torch.set_num_threads(1)


def _ragged_case(rng, segs, page_size=4, kvh=2, group=2, d=8, pad=0):
    """The JAX test's case builder: [(start, n_tokens)] per slot, each
    slot's context scattered into a paged pool."""
    b = len(segs)
    h = kvh * group
    max_ctx = max((s for s, _ in segs), default=0)
    max_pages = max(-(-max(s + n for s, n in segs) // page_size), 1)
    num_pages = b * max_pages + 1
    k_pages = np.zeros((num_pages, page_size, kvh, d), np.float32)
    v_pages = np.zeros((num_pages, page_size, kvh, d), np.float32)
    tables = np.arange(b * max_pages, dtype=np.int32).reshape(b, max_pages)
    dense_k = rng.normal(size=(b, max(max_ctx, 1), kvh, d)).astype(
        np.float32)
    dense_v = rng.normal(size=(b, max(max_ctx, 1), kvh, d)).astype(
        np.float32)
    for s in range(b):
        for p in range(segs[s][0]):
            page = tables[s, p // page_size]
            k_pages[page, p % page_size] = dense_k[s, p]
            v_pages[page, p % page_size] = dense_v[s, p]
    t = sum(n for _, n in segs) + pad
    slot_ids = np.zeros(t, np.int32)
    positions = np.zeros(t, np.int32)
    valid = np.zeros(t, bool)
    cur = 0
    for s, (start, n) in enumerate(segs):
        slot_ids[cur:cur + n] = s
        positions[cur:cur + n] = np.arange(start, start + n)
        valid[cur:cur + n] = True
        cur += n
    q = rng.normal(size=(t, h, d)).astype(np.float32)
    k_new = rng.normal(size=(t, kvh, d)).astype(np.float32)
    v_new = rng.normal(size=(t, kvh, d)).astype(np.float32)
    start = np.asarray([s for s, _ in segs], np.int32)
    return dict(q=q, k_pages=k_pages, v_pages=v_pages, tables=tables,
                slot_ids=slot_ids, positions=positions, valid=valid,
                start=start, k_new=k_new, v_new=v_new,
                dense_k=dense_k, dense_v=dense_v)


ARGS = ("q", "k_pages", "v_pages", "tables", "slot_ids", "positions",
        "valid", "start", "k_new", "v_new")


def _torch_args(c):
    return [torch.from_numpy(np.array(c[n])) for n in ARGS]


def _oracle(c):
    return jrpa.ragged_attention_dense_oracle(
        c["q"], c["dense_k"], c["dense_v"], c["k_new"], c["v_new"],
        c["slot_ids"], c["positions"], c["valid"], c["start"])


OP_CASES = [
    ("pure_decode", [(5, 1), (11, 1), (3, 1)], 0),
    ("pure_prefill", [(0, 6), (0, 3), (0, 9)], 0),
    ("mixed", [(7, 1), (0, 5), (12, 1), (4, 6)], 0),
    ("single_token_prompts", [(0, 1), (0, 1), (9, 1)], 0),
    ("page_straddle", [(3, 6), (6, 5), (2, 1)], 0),
    ("padding_rows", [(5, 1), (0, 4)], 7),
]


@pytest.mark.parametrize("name,segs,pad", OP_CASES)
def test_dense_op_matches_jax_op_and_oracle(name, segs, pad):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    c = _ragged_case(rng, segs, pad=pad)
    out = trpa.ragged_paged_prefill_decode_attention(
        *_torch_args(c)).numpy()
    ref_j = np.asarray(jrpa.ragged_paged_prefill_decode_attention(
        *[jnp.asarray(c[n]) for n in ARGS]))
    v = c["valid"]
    np.testing.assert_allclose(out[v], _oracle(c)[v], rtol=2e-4, atol=2e-5)
    # padding rows attend themselves on both sides: every row agrees
    np.testing.assert_allclose(out, ref_j, rtol=2e-5, atol=2e-6)


KERNEL_CASES = [
    ("decode_only", [(5, 1), (11, 1), (3, 1), (8, 1)], 0, 2, 2),
    ("mixed", [(7, 1), (0, 5), (12, 1), (4, 6)], 0, 2, 2),
    ("gqa_group1", [(6, 2), (0, 3), (10, 1)], 0, 3, 1),
    ("gqa_group4", [(6, 2), (0, 3), (10, 1)], 0, 2, 4),
    ("partial_last_page", [(5, 3), (9, 1), (1, 2), (6, 1)], 0, 2, 2),
    ("start_zero", [(0, 1), (0, 4), (0, 1)], 0, 2, 2),
    ("padding_rows", [(5, 1), (0, 4)], 7, 2, 2),
    ("all_padding", [(0, 0)], 6, 2, 2),
]


@pytest.mark.parametrize("name,segs,pad,kvh,group", KERNEL_CASES)
def test_kernel_entry_matches_pallas_interpret_and_oracle(name, segs, pad,
                                                          kvh, group):
    """The kernel entry's contract on the CPU (plain version): valid rows
    match the oracle and the interpret-mode Pallas kernel, invalid rows
    are exact zeros on both."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    c = _ragged_case(rng, segs, pad=pad, kvh=kvh, group=group)
    out = trpa.ragged_paged_attention(*_torch_args(c)).numpy()
    ref_k = np.asarray(jrpa.ragged_paged_attention_pallas(
        *[jnp.asarray(c[n]) for n in ARGS], q_block=4, pages_per_block=2,
        interpret=True))
    v = c["valid"]
    np.testing.assert_allclose(out[v], _oracle(c)[v], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out[v], ref_k[v], rtol=2e-3, atol=2e-3)
    if (~v).any():
        assert np.all(out[~v] == 0.0)
        assert np.all(ref_k[~v] == 0.0)


def test_kernel_entry_ctx_and_seg_bounds():
    """ctx_pages and max_seg_len that cover the live data leave the
    result unchanged (as for the Pallas kernel)."""
    rng = np.random.default_rng(11)
    c = _ragged_case(rng, [(6, 1), (0, 3), (5, 4)])
    full = trpa.ragged_paged_attention(*_torch_args(c)).numpy()
    bounded = trpa.ragged_paged_attention(
        *_torch_args(c), ctx_pages=2, max_seg_len=4).numpy()
    ref = np.asarray(jrpa.ragged_paged_attention_pallas(
        *[jnp.asarray(c[n]) for n in ARGS], ctx_pages=2, max_seg_len=4,
        interpret=True))
    v = c["valid"]
    np.testing.assert_allclose(full[v], bounded[v], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bounded[v], ref[v], rtol=2e-3, atol=2e-3)


def test_ctx_bucketing_matches_full_table():
    rng = np.random.default_rng(0)
    c = _ragged_case(rng, [(6, 1), (0, 3), (5, 4)])
    full = trpa.ragged_paged_prefill_decode_attention(*_torch_args(c))
    bucketed = trpa.ragged_paged_prefill_decode_attention(
        *_torch_args(c), ctx_pages=2)
    v = torch.from_numpy(c["valid"])
    torch.testing.assert_close(full[v], bucketed[v], rtol=1e-6, atol=1e-7)


def test_numpy_oracle_is_the_jax_oracle():
    rng = np.random.default_rng(2)
    c = _ragged_case(rng, [(7, 1), (0, 5), (4, 6)], pad=3)
    args = (c["q"], c["dense_k"], c["dense_v"], c["k_new"], c["v_new"],
            c["slot_ids"], c["positions"], c["valid"], c["start"])
    np.testing.assert_array_equal(trpa.ragged_attention_dense_oracle(*args),
                                  jrpa.ragged_attention_dense_oracle(*args))


@pytest.mark.parametrize("name,segs,pad", OP_CASES)
def test_ragged_plan_maps_segments(name, segs, pad):
    """The CUDA kernel reads the flat batch through ragged_plan: q_len is
    each slot's valid-token count, tok_idx[slot, i] the flat index of the
    slot's token at offset i (position - start), -1 past the segment."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    c = _ragged_case(rng, segs, pad=pad)
    # shuffle the flat order: the map must not rely on it
    perm = rng.permutation(len(c["slot_ids"]))
    sl, po, va = (c[n][perm] for n in ("slot_ids", "positions", "valid"))
    max_seg = max(n for _, n in segs)
    qlen, tok = trpa.ragged_plan(torch.from_numpy(sl), torch.from_numpy(po),
                                 torch.from_numpy(va),
                                 torch.from_numpy(c["start"]), max_seg)
    assert qlen.dtype == torch.int32 and tok.dtype == torch.int32
    assert tok.shape == (len(segs), max_seg)
    assert qlen.tolist() == [n for _, n in segs]
    for s, (start, n) in enumerate(segs):
        for i in range(max_seg):
            t = int(tok[s, i])
            if i < n:
                assert va[t] and sl[t] == s and po[t] == start + i
            else:
                assert t == -1


# ------------------------------------------------------- quantized pools

QUANT_CASES = [
    # tests/test_kv_quant.py's segment layouts: name, segs, pad, kvh, group
    ("decode_only", [(5, 1), (11, 1), (3, 1), (8, 1)], 0, 2, 2),
    ("mixed", [(7, 1), (0, 5), (12, 1), (4, 6)], 0, 2, 2),
    ("gqa_group1", [(6, 2), (0, 3), (10, 1)], 0, 3, 1),
    ("gqa_group4", [(6, 2), (0, 3), (10, 1)], 0, 2, 4),
    ("partial_last_page", [(5, 3), (9, 1), (1, 2), (6, 1)], 0, 2, 2),
    ("padding_rows", [(5, 1), (0, 4)], 7, 2, 2),
]


def _quantize_pools(c, kind):
    """Quantize the case's pools with the JAX quantizer: returns the JAX
    (pools, scales) and the torch tensors of the same bytes."""
    from ray_tpu.ops import kv_quant as jkq
    jx, tx = {}, {}
    for n in ("k_pages", "v_pages"):
        q, s = jkq.quantize_rows(jnp.asarray(c[n]), kind)
        jx[n], jx[n + "_s"] = q, s
        raw = np.array(q).view(np.uint8)
        t = torch.from_numpy(raw)
        tx[n] = t.view(torch.int8) if kind == "int8" else \
            t.view(torch.float8_e4m3fn)
        tx[n + "_s"] = torch.from_numpy(np.array(s))
    return jx, tx


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("name,segs,pad,kvh,group", QUANT_CASES)
def test_quant_kernel_entry_matches_pallas_interpret(name, segs, pad, kvh,
                                                     group, kind):
    """The kernel entry over int8/fp8 pools (the plain version on the
    CPU) vs the quantized branch of the Pallas ragged kernel in interpret
    mode; padding rows are exact zeros on both."""
    rng = np.random.default_rng(zlib.crc32(f"{name}/{kind}".encode()))
    c = _ragged_case(rng, segs, pad=pad, kvh=kvh, group=group, d=16)
    jx, tx = _quantize_pools(c, kind)
    jargs = [jx[n] if n in jx else jnp.asarray(c[n]) for n in ARGS]
    ref = np.asarray(jrpa.ragged_paged_attention_pallas(
        *jargs, q_block=4, pages_per_block=2, k_scales=jx["k_pages_s"],
        v_scales=jx["v_pages_s"], interpret=True))
    targs = [tx[n] if n in tx else torch.from_numpy(np.array(c[n]))
             for n in ARGS]
    out = trpa.ragged_paged_attention(
        *targs, k_scales=tx["k_pages_s"], v_scales=tx["v_pages_s"]).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    v = c["valid"]
    if (~v).any():
        assert np.all(out[~v] == 0.0) and np.all(ref[~v] == 0.0)
    # the plain version is the dense op over the dequantized context
    kd = tx["k_pages"].float() * tx["k_pages_s"][..., None]
    vd = tx["v_pages"].float() * tx["v_pages_s"][..., None]
    dense = trpa.ragged_paged_prefill_decode_attention(
        *targs[:1], kd, vd, *targs[3:]).numpy()
    np.testing.assert_array_equal(out[v], dense[v])


# ------------------------------------- the bf16 tensor-core kernel's grid

# (T, B, group, max_seg, n_ctx_pages, page_size) -> (tokens a q tile,
# (slot, q tile) pairs, key chunks), worked by hand:
#   tpt = 64 // group; pairs = min((T + B (tpt - 1)) // tpt,
#   B ceil(max_seg / tpt)); chunks = ceil((ceil(n_ctx_pages page / 64)
#   + ceil(max_seg / 64)) / 8)
TC_GEOMETRY_CASES = [
    # the kernel phase's tick of chip_smoke.py: 632 // 16 = 39 pairs;
    # 4096 context keys = 64 tiles + 8 in-batch tiles = 72 -> 9 chunks
    ((512, 8, 4, 512, 256, 16), (16, 39, 9)),
    # the engine's 1024-token bucket: 1144 // 16 = 71; 32 + 8 = 40 -> 5
    ((1024, 8, 4, 512, 128, 16), (16, 71, 5)),
    # decode rows only: 8 pairs; 128 + 1 = 129 tiles -> 17 chunks
    ((8, 8, 4, 1, 512, 16), (16, 8, 17)),
    # group 1: 289 // 64 = 4 pairs (B ceil(70 / 64) = 6); 0 + 2 -> 1
    ((100, 3, 1, 70, 0, 8), (64, 4, 1)),
    # group 8: 78 // 8 = 9 pairs (4 x 7 = 28); 5 + 1 = 6 tiles -> 1
    ((50, 4, 8, 50, 10, 32), (8, 9, 1)),
    # group 3 (64 rows = 21 tokens x 3 + 1 padding row): 80 // 21 = 3
    # pairs (2 x 2 = 4); 1 + 1 tiles -> 1 chunk
    ((40, 2, 3, 30, 4, 16), (21, 3, 1)),
    # segments capped below T: B ceil(max_seg / tpt) = 2 x 1 binds
    ((64, 2, 4, 16, 1, 16), (16, 2, 1)),
]


@pytest.mark.parametrize("args,want", TC_GEOMETRY_CASES)
def test_tc_geometry_hand_worked(args, want):
    assert trpa.tc_geometry(*args) == want


@pytest.mark.parametrize("seed", range(4))
def test_tc_geometry_covers_every_work_item(seed):
    """Random ticks through ragged_plan: the grid's pairs cover every
    (slot, q tile) pair with a token, and its chunks every key chunk a
    q tile's keys (context tiles, then in-batch tiles up to the tile's
    last token) span."""
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 9))
    page = int(rng.choice([8, 16, 32, 64]))
    group = int(rng.choice([1, 2, 3, 4, 8]))
    max_seg = int(rng.integers(1, 300))
    n_ctx = int(rng.integers(0, 40))
    segs = [(int(rng.integers(0, n_ctx * page + 100)),
             int(rng.integers(0, max_seg + 1))) for _ in range(b)]
    pad = int(rng.integers(0, 9))
    t = max(sum(n for _, n in segs) + pad, 1)
    slot_ids = np.zeros(t, np.int32)
    positions = np.zeros(t, np.int32)
    valid = np.zeros(t, bool)
    cur = 0
    for s, (start, n) in enumerate(segs):
        slot_ids[cur:cur + n] = s
        positions[cur:cur + n] = np.arange(start, start + n)
        valid[cur:cur + n] = True
        cur += n
    start = np.array([s for s, _ in segs], np.int32)
    qlen, _ = trpa.ragged_plan(torch.from_numpy(slot_ids),
                               torch.from_numpy(positions),
                               torch.from_numpy(valid),
                               torch.from_numpy(start), max_seg)
    tpt, n_pairs, n_chunks = trpa.tc_geometry(t, b, group, max_seg, n_ctx,
                                              page)
    tile = trpa.TC_TILE
    pairs = 0
    for s in range(b):
        q = min(int(qlen[s]), max_seg)
        ctx = min(int(start[s]), n_ctx * page)
        for i0 in range(0, q, tpt):
            pairs += 1
            tiles = -(-ctx // tile) + -(-min(i0 + tpt, q) // tile)
            assert -(-tiles // trpa.TC_CHUNK_TILES) <= n_chunks
    assert pairs <= n_pairs
    assert tpt * group <= trpa.TC_ROWS


TC_TAKES_CASES = [
    # dtype, head_dim, page_size, group -> tensor-core kernel?
    (torch.bfloat16, 128, 16, 4, True),       # the 8b preset
    (torch.bfloat16, 64, 8, 2, True),         # tiny, smallest page
    (torch.bfloat16, 64, 64, 64, True),       # largest page and group
    (torch.bfloat16, 32, 16, 2, False),       # the debug preset
    (torch.bfloat16, 128, 4, 4, False),       # pages under 8 rows
    (torch.bfloat16, 128, 24, 4, False),      # pages not tiling 64 keys
    (torch.bfloat16, 128, 128, 4, False),
    (torch.bfloat16, 256, 16, 4, False),
    (torch.bfloat16, 64, 16, 128, False),     # a group past one q tile
    (torch.float32, 128, 16, 4, False),       # by type
    (torch.float16, 64, 16, 4, False),
]


@pytest.mark.parametrize("dtype,d,page,group,want", TC_TAKES_CASES)
def test_tc_takes_routes_by_dtype_and_shape(dtype, d, page, group, want):
    assert trpa.tc_takes(dtype, d, page, group) is want


@pytest.mark.parametrize("args,want", [
    # one chunk: the items write their rows, no scratch
    ((512, 32, 128, 1), 0),
    # acc [T, H, chunks, D] + m and l [T, H, chunks]: 512 x 32 x 9 x 130
    ((512, 32, 128, 9), 19169280),
    # the 1024 bucket over the full 512-page table at page 16: 8192 + 512
    # keys = 136 tiles -> 17 chunks; x 4 bytes ~ 290 MB
    ((1024, 32, 128, 17), 72417280),
    ((7, 3, 64, 2), 2772),
])
def test_scratch_numel_hand_worked(args, want):
    assert trpa.scratch_numel(*args) == want


def test_ragged_scratch_needs_no_buffer_on_the_cpu():
    pool = torch.zeros((9, 16, 8, 128), dtype=torch.bfloat16)
    tables = torch.zeros((2, 512), dtype=torch.int32)
    assert trpa.ragged_scratch(512, 32, 128, torch.bfloat16, pool,
                               tables) is None
