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
- the hand-written CUDA kernel ``csrc/ragged_paged.cu`` behind
  ``ragged_paged_attention``, which keeps
  ``ragged_paged_attention_pallas``' contract: each slot's valid tokens
  form one run at positions start[slot] + rank, invalid rows are
  ignored on input and exact zeros on output. On a CPU tensor it runs
  ``ragged_paged_attention_plain``; on a CUDA tensor it launches the
  kernel or raises.

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
    """Query tokens per kernel block: about 32 score rows (q_blk tokens
    x group heads), never more tokens than a segment can hold."""
    return max(1, min(32 // max(group, 1), max_seg))


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
        v_scales: Optional[torch.Tensor] = None
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
    ``csrc/ragged_paged.cu`` (or raise)."""
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
    max_seg = t if max_seg_len < 0 else max(min(max_seg_len, t), 1)
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
    n_ctx = page_tables.shape[1] if ctx_pages < 0 else \
        min(ctx_pages, page_tables.shape[1])
    q_blk = _q_block(h // kvh, max_seg)
    out = torch.empty_like(q)
    ptr = lambda x: x.data_ptr() if x is not None else None
    kernel = _kernels.RAGGED_PAGED_BY_KIND[kind]
    fn = kernel.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                ptr(k_scales), ptr(v_scales), page_tables.data_ptr(),
                start.data_ptr(), qlen.data_ptr(), tok_idx.data_ptr(),
                valid.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                out.data_ptr(), t, b, h, kvh, d, page_size,
                page_tables.shape[1], n_ctx, max_seg, q_blk,
                _kernels.dtype_code(q.dtype), kind, stream)
    _kernels.check(rc, kernel.name)
    kernel.launches += 1
    return out
