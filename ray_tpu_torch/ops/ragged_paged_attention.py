"""Ragged paged attention: one attention call for a mixed
prefill+decode batch over the paged KV cache.

PyTorch counterpart of ``ray_tpu/ops/ragged_paged_attention.py``. A flat
("ragged") token batch holds each active slot's tokens: 1 for a
decoding slot, a chunk of C for a prefilling one. Token t of slot s at
absolute position p attends
  - cached context of s: pool positions c < start[s];
  - batch tokens of s:   tokens u with positions[u] <= p.

Two implementations:
- dense (``ragged_prefill_decode_attention`` /
  ``ragged_paged_prefill_decode_attention``), the plain version;
- the hand-written CUDA kernels ``csrc/ragged_paged.cu`` behind
  ``ragged_paged_attention``, which keep
  ``ragged_paged_attention_pallas``' contract: each slot's valid tokens
  form one run at positions start[slot] + rank, invalid rows are
  ignored on input and exact zeros on output. bf16 queries run the
  tensor-core kernel, which splits each slot's keys into chunks of 512
  and merges them in a combine pass (``tc_geometry`` sizes its grid and
  scratch); float32 and float16 queries run the first, CUDA-core
  kernel. On a CPU tensor it runs ``ragged_paged_attention_plain``; on
  a CUDA tensor it launches the kernel or raises.

Both take quantized pools (int8/fp8 values with float32 scale pools,
``kv_quant``): the dense op over the dequantized gathered context, the
kernel with the dequant fused into its page loads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .paged_attention import check_pool_kind, gather_context


def ragged_prefill_decode_attention(
        q: torch.Tensor, k_ctx: torch.Tensor, v_ctx: torch.Tensor,
        k_new: torch.Tensor, v_new: torch.Tensor, slot_ids: torch.Tensor,
        positions: torch.Tensor, valid: torch.Tensor, start: torch.Tensor
) -> torch.Tensor:
    """Ragged attention over gathered context + the batch's own KV.

    q: [T, H, D]; k_ctx/v_ctx: [B, ctx, KVH, D] gathered context per
    slot (row c = position c); k_new/v_new: [T, KVH, D]; slot_ids,
    positions, valid: [T]; start: [B]. Every token also attends itself,
    which keeps padding rows finite (the JAX version's rule). Softmax in
    float32. Returns [T, H, D].

    The JAX version gathers k_ctx[slot_ids], a [T, ctx, KVH, D]
    transient; here each slot's context is scored against the whole
    batch and selected by slot, B matmuls with no such transient (same
    products, same masking)."""
    t, h, d = q.shape
    b, ctx, kvh = k_ctx.shape[0], k_ctx.shape[1], k_ctx.shape[2]
    group = h // kvh
    scale = 1.0 / (d ** 0.5)
    slot_ids = slot_ids.long()
    start = start.long()
    qf = q.reshape(t, kvh, group, d).float()
    kc, vc = k_ctx.float(), v_ctx.float()
    s_ctx = qf.new_zeros((t, kvh, group, ctx))
    for s in range(b):
        mine = (slot_ids == s)[:, None, None, None]
        s_ctx = torch.where(mine, torch.einsum("tkgd,ckd->tkgc", qf, kc[s]),
                            s_ctx)
    s_new = torch.einsum("tkgd,ukd->tkgu", qf, k_new.float())
    ctx_mask = (torch.arange(ctx, device=q.device)[None, :]
                < start[slot_ids][:, None])                      # [T, ctx]
    new_mask = ((slot_ids[:, None] == slot_ids[None, :])
                & (positions[None, :] <= positions[:, None])
                & valid[None, :]) | torch.eye(t, dtype=torch.bool,
                                              device=q.device)
    neg = float("-inf")
    s_ctx = (s_ctx * scale).masked_fill(~ctx_mask[:, None, None, :], neg)
    s_new = (s_new * scale).masked_fill(~new_mask[:, None, None, :], neg)
    probs = torch.softmax(torch.cat([s_ctx, s_new], dim=-1), dim=-1)
    p_ctx, p_new = probs[..., :ctx], probs[..., ctx:]
    out = torch.einsum("tkgu,ukd->tkgd", p_new, v_new.float())
    for s in range(b):
        mine = (slot_ids == s)[:, None, None, None]
        out = out + torch.where(
            mine, torch.einsum("tkgc,ckd->tkgd", p_ctx, vc[s]),
            torch.zeros_like(out))
    return out.reshape(t, h, d).to(q.dtype)


def ragged_paged_prefill_decode_attention(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        page_tables: torch.Tensor, slot_ids: torch.Tensor,
        positions: torch.Tensor, valid: torch.Tensor, start: torch.Tensor,
        k_new: torch.Tensor, v_new: torch.Tensor,
        ctx_pages: int = -1, k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single layer: gather each slot's pages (the first ctx_pages table
    entries, -1 = all; dequantized to float32 when k_scales/v_scales
    are given) then run the ragged attention."""
    tables = page_tables if ctx_pages < 0 else page_tables[:, :ctx_pages]
    return ragged_prefill_decode_attention(
        q, gather_context(k_pages, k_scales, tables),
        gather_context(v_pages, v_scales, tables), k_new, v_new, slot_ids,
        positions, valid, start)


def ragged_attention_dense_oracle(
        q, dense_k, dense_v, k_new, v_new, slot_ids, positions, valid,
        start) -> np.ndarray:
    """Numpy dense reference for the ragged op (per-token loops — slow
    and obviously correct). dense_k/dense_v: [B, max_ctx, KVH, D] each
    slot's cached KV in position order. Rows of invalid tokens are
    zero."""
    q = np.asarray(q, np.float32)
    dense_k = np.asarray(dense_k, np.float32)
    dense_v = np.asarray(dense_v, np.float32)
    k_new = np.asarray(k_new, np.float32)
    v_new = np.asarray(v_new, np.float32)
    slot_ids = np.asarray(slot_ids)
    positions = np.asarray(positions)
    valid = np.asarray(valid)
    start = np.asarray(start)
    t, h, d = q.shape
    kvh = k_new.shape[1]
    group = h // kvh
    out = np.zeros_like(q)
    for i in range(t):
        if not valid[i]:
            continue
        s = int(slot_ids[i])
        keys = [dense_k[s, :start[s]]]
        vals = [dense_v[s, :start[s]]]
        mates = [j for j in range(t)
                 if valid[j] and slot_ids[j] == s
                 and positions[j] <= positions[i]]
        keys.append(k_new[mates])
        vals.append(v_new[mates])
        kk = np.repeat(np.concatenate(keys), group, axis=1)
        vv = np.repeat(np.concatenate(vals), group, axis=1)
        sc = np.einsum("hd,nhd->hn", q[i], kk) / np.sqrt(d)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        out[i] = np.einsum("hn,nhd->hd", p, vv)
    return out


# ------------------------------------------------------------- ragged kernel

def ragged_plan(slot_ids: torch.Tensor, positions: torch.Tensor,
                valid: torch.Tensor, start: torch.Tensor,
                max_seg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot segment map for the kernel, built once per tick (it is
    the same for every layer): q_len [B] int32, the valid tokens of each
    slot, and tok_idx [B, max_seg] int32, the flat index of the token at
    offset i = positions - start[slot] of each slot (-1 where none).
    Replaces the TPU wrapper's per-slot repack into padded staging
    arrays; the kernel reads the flat batch through it."""
    b = start.shape[0]
    t = slot_ids.shape[0]
    dev = slot_ids.device
    slot = slot_ids.long()
    v = valid.bool()
    off = positions.long() - start.long()[slot]
    keep = v & (off >= 0) & (off < max_seg)
    row = torch.where(keep, slot, torch.full_like(slot, b))
    col = torch.where(keep, off, torch.zeros_like(off))
    tok_idx = torch.full((b + 1, max_seg), -1, dtype=torch.int32,
                         device=dev)
    tok_idx[row, col] = torch.arange(t, dtype=torch.int32, device=dev)
    qlen = torch.zeros(b + 1, dtype=torch.int32, device=dev)
    qlen.index_add_(0, row, keep.to(torch.int32))
    return qlen[:b].contiguous(), tok_idx[:b].contiguous()


def _q_block(group: int, max_seg: int) -> int:
    """Query tokens per kernel block of the float32/float16 kernel: about
    32 score rows (q_blk tokens x group heads), never more tokens than a
    segment can hold."""
    return max(1, min(32 // max(group, 1), max_seg))


# The tensor-core kernel for bf16 queries: a work item is (slot, q tile,
# kv head, key chunk); a q tile is TC_ROWS rows (TC_ROWS // group tokens
# x the group's heads of one kv head), a key chunk TC_CHUNK_TILES tiles
# of TC_TILE keys (the slot's context tiles, then its in-batch tiles).
TC_ROWS = 64
TC_TILE = 64
TC_CHUNK_TILES = 8
TC_HEAD_DIMS = (64, 128)
TC_PAGE_SIZES = (8, 16, 32, 64)       # a page is whole 8-row swizzle atoms


def tc_takes(dtype: torch.dtype, d: int, page_size: int, group: int) -> bool:
    """Whether a call runs the tensor-core kernel: bf16 queries with
    head_dim in TC_HEAD_DIMS, page_size in TC_PAGE_SIZES and group <=
    TC_ROWS (``rtc::takes`` in the source says the same). Every other
    call, bf16 ones included (the ``debug`` preset's head_dim 32, pages
    of 4 rows), runs the CUDA-core kernel."""
    return (dtype == torch.bfloat16 and d in TC_HEAD_DIMS
            and page_size in TC_PAGE_SIZES and group <= TC_ROWS)


def tc_geometry(t: int, b: int, group: int, max_seg: int,
                n_ctx_pages: int, page_size: int) -> Tuple[int, int, int]:
    """(tokens a q tile, (slot, q tile) pairs, key chunks) of the bf16
    kernel's grid for T tokens over B slots, from static bounds only (no
    host sync). Slot s holds q_s <= max_seg tokens and sum q_s <= T, so
    sum ceil(q_s / tpt) <= (T + B (tpt - 1)) // tpt, and at most
    B ceil(max_seg / tpt). A q tile sees at most ceil(n_ctx_pages *
    page_size / 64) context tiles and ceil(max_seg / 64) in-batch tiles.
    The grid is (chunks, pairs, KVH); the chunks' partials need
    ``scratch_numel`` float32 values when chunks > 1."""
    tpt = TC_ROWS // group
    n_pairs = min((t + b * (tpt - 1)) // tpt, b * -(-max_seg // tpt))
    tiles = -(-n_ctx_pages * page_size // TC_TILE) + -(-max_seg // TC_TILE)
    return tpt, n_pairs, -(-tiles // TC_CHUNK_TILES)


def scratch_numel(t: int, h: int, d: int, n_chunks: int) -> int:
    """float32 values of the key chunks' partials, 0 for one chunk: acc
    [T, H, chunks, D], then m and l [T, H, chunks] each (acc first, so
    its rows keep the 16-byte alignment the combine pass reads them
    with)."""
    return 0 if n_chunks <= 1 else t * h * n_chunks * (d + 2)


def _call_geometry(t, h, d, dtype, kvh, page_size, b, n_table, ctx_pages,
                   max_seg_len):
    """(tensor-core?, max_seg, n_ctx, q_blk, n_pairs, n_chunks) of one
    call, from shapes only."""
    max_seg = t if max_seg_len < 0 else max(min(max_seg_len, t), 1)
    n_ctx = n_table if ctx_pages < 0 else min(ctx_pages, n_table)
    group = h // kvh
    if not tc_takes(dtype, d, page_size, group):
        return False, max_seg, n_ctx, _q_block(group, max_seg), 0, 0
    return (True, max_seg, n_ctx) + tc_geometry(t, b, group, max_seg, n_ctx,
                                                page_size)


def ragged_scratch(t: int, h: int, d: int, dtype: torch.dtype,
                   k_pages: torch.Tensor, page_tables: torch.Tensor, *,
                   ctx_pages: int = -1, max_seg_len: int = -1
                   ) -> Optional[torch.Tensor]:
    """One float32 buffer for the key chunks' partials of every
    ``ragged_paged_attention`` call of a tick with these arguments (q
    [T, H, D] of `dtype`, one layer's pool `k_pages`), or None when the
    calls need none (CPU tensors, the CUDA-core kernel, one chunk).
    The calls run in stream order, so the layers share it."""
    if page_tables.device.type != "cuda":
        return None
    _, page_size, kvh, _ = k_pages.shape
    geo = _call_geometry(t, h, d, dtype, kvh, page_size,
                         page_tables.shape[0], page_tables.shape[1],
                         ctx_pages, max_seg_len)
    n = scratch_numel(t, h, d, geo[5])
    if not geo[0] or n == 0:
        return None
    return torch.empty(n, dtype=torch.float32, device=page_tables.device)


def ragged_paged_attention_plain(
        q, k_pages, v_pages, page_tables, slot_ids, positions, valid,
        start, k_new, v_new, *, ctx_pages: int = -1, max_seg_len: int = -1,
        plan=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """Plain version of the kernel: the dense op (over the dequantized
    context when scales are given), with invalid rows zeroed as the
    kernel's contract says. `plan` is accepted and ignored, so both
    versions take the same arguments."""
    del max_seg_len, plan
    out = ragged_paged_prefill_decode_attention(
        q, k_pages, v_pages, page_tables, slot_ids, positions, valid,
        start, k_new, v_new, ctx_pages=ctx_pages, k_scales=k_scales,
        v_scales=v_scales)
    return torch.where(valid.bool()[:, None, None], out,
                       torch.zeros_like(out))


def ragged_paged_attention(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        page_tables: torch.Tensor, slot_ids: torch.Tensor,
        positions: torch.Tensor, valid: torch.Tensor, start: torch.Tensor,
        k_new: torch.Tensor, v_new: torch.Tensor, *, ctx_pages: int = -1,
        max_seg_len: int = -1,
        plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        k_scales: Optional[torch.Tensor] = None,
        v_scales: Optional[torch.Tensor] = None,
        scratch: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Ragged paged attention for one layer, the kernel entry.

    q: [T, H, D] (kv-major head order); k_pages/v_pages: [num_pages,
    page_size, KVH, D]; page_tables: [B, max_pages] int32; slot_ids,
    positions: [T] int32; valid: [T] bool; start: [B] int32; k_new,
    v_new: [T, KVH, D]. ctx_pages bounds the context sweep (-1 = the
    whole table); max_seg_len bounds any one slot's token count this
    call (-1 = T); plan is ``ragged_plan``'s result for these
    arguments (built here when None). With k_scales/v_scales
    ([num_pages, page_size, KVH] float32) the pools hold int8 or fp8
    values, dequantized as they are read; k_new/v_new stay in q's
    dtype. Returns [T, H, D] with invalid rows exact zeros.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/ragged_paged.cu`` (or raise): the calls ``tc_takes`` (bf16
    queries of head_dim 64 or 128, page_size 8, 16, 32 or 64, group <=
    64; slot_ids and positions int32) the tensor-core kernel and its
    combine pass, with float32 scratch for the key chunks' partials when
    a q tile's keys can span more than one chunk (``tc_geometry``); all
    others the CUDA-core kernel. `scratch` is ``ragged_scratch``'s
    buffer for these arguments, shared by a tick's layers (None
    allocates one for this call). One launch-counter step per call."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, page_tables, slot_ids, positions, valid,
            start, k_new, v_new, ctx_pages=ctx_pages, k_scales=k_scales,
            v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for device "
                         f"{q.device}")
    t, h, d = q.shape
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q [T, H, D] and pools [P, page, KVH, D] expected")
    _, page_size, kvh, dk = k_pages.shape
    b = page_tables.shape[0]
    if dk != d or h % kvh:
        raise ValueError(f"head dims disagree: q {tuple(q.shape)}, "
                         f"pool {tuple(k_pages.shape)}")
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 8 "
                         f"up to 256")
    if k_new.shape != (t, kvh, d) or v_new.shape != (t, kvh, d):
        raise ValueError("k_new/v_new must be [T, KVH, D]")
    if slot_ids.shape != (t,) or positions.shape != (t,) \
            or valid.shape != (t,) or start.shape != (b,):
        raise ValueError("slot_ids/positions/valid [T], start [B] expected")
    kind = check_pool_kind(q, k_pages, v_pages, k_scales, v_scales)
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("k_new/v_new must be in q's dtype")
    if page_tables.dtype != torch.int32 or start.dtype != torch.int32:
        raise TypeError("page_tables and start must be int32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    tc, max_seg, n_ctx, q_blk, n_pairs, n_chunks = _call_geometry(
        t, h, d, q.dtype, kvh, page_size, b, page_tables.shape[1],
        ctx_pages, max_seg_len)
    if plan is None:
        plan = ragged_plan(slot_ids, positions, valid, start, max_seg)
    qlen, tok_idx = plan
    if tok_idx.shape != (b, max_seg) or qlen.shape != (b,) \
            or tok_idx.dtype != torch.int32 or qlen.dtype != torch.int32:
        raise ValueError("plan does not match max_seg_len / the tables")
    scales = (k_scales, v_scales) if kind else ()
    for x in (q, k_pages, v_pages, page_tables, start, valid, k_new, v_new,
              qlen, tok_idx) + scales:
        if x.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (k_pages, v_pages, k_new, v_new)):
        raise ValueError("pools and new KV must be 16-byte aligned (the "
                         "kernel reads them in 16-byte vectors)")
    tok_ids = (None, None)
    part_m = part_l = part_acc = None
    if tc:
        # the tensor-core kernel: the flat batch's slot and position (the
        # combine pass writes rows by token), and the chunks' scratch
        for x in (slot_ids, positions):
            if x.dtype != torch.int32 or x.device != q.device \
                    or not x.is_contiguous():
                raise ValueError("slot_ids/positions must be contiguous "
                                 "int32 on q's device")
        tok_ids = (slot_ids.data_ptr(), positions.data_ptr())
        if q.data_ptr() % 16:
            raise ValueError("q must be 16-byte aligned")
        need = scratch_numel(t, h, d, n_chunks)
        if need:
            if scratch is None:
                scratch = torch.empty(need, dtype=torch.float32,
                                      device=q.device)
            elif scratch.dtype != torch.float32 \
                    or scratch.device != q.device \
                    or scratch.numel() < need \
                    or not scratch.is_contiguous() \
                    or scratch.data_ptr() % 16:
                raise ValueError(f"scratch must be a contiguous, 16-byte "
                                 f"aligned float32 tensor of at least "
                                 f"{need} values on q's device")
            n_acc = t * h * n_chunks * d
            part_acc = scratch[:n_acc]
            part_m = scratch[n_acc:n_acc + t * h * n_chunks]
            part_l = scratch[n_acc + t * h * n_chunks:need]
    out = torch.empty_like(q)
    ptr = lambda x: x.data_ptr() if x is not None else None
    kernel = _kernels.RAGGED_PAGED_BY_KIND[kind]
    fn = kernel.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                ptr(k_scales), ptr(v_scales), page_tables.data_ptr(),
                start.data_ptr(), qlen.data_ptr(), tok_idx.data_ptr(),
                valid.data_ptr(), *tok_ids,
                k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
                ptr(part_m), ptr(part_l), ptr(part_acc), t, b, h, kvh, d,
                page_size, page_tables.shape[1], n_ctx, max_seg,
                k_pages.shape[0], q_blk, n_pairs, n_chunks,
                _kernels.dtype_code(q.dtype), kind, stream)
    _kernels.check(rc, kernel.name)
    kernel.launches += 1
    return out
