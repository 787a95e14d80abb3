"""Cache-aware Llama forward passes for serving.

PyTorch counterpart of ``ray_tpu/models/llama_infer.py``: the unified
ragged forward (one call per engine tick with a prefilling slot) and
the pure-decode step, over the shared paged pool
``[n_layers, num_pages, page_size, KVH, D]``. ``impl`` picks the
attention: "gather" (dense, the plain version) or "kernel" (the CUDA
kernels on a CUDA tensor; their plain versions on a CPU tensor).

The padded-batch forwards of the legacy engine step and of speculative
decoding: ``prefill`` (whole prompts, dense causal attention by
``cfg.attention_impl`` under the reference's rule, so "auto" is the
dense path and "pallas" the flash kernel) and ``prefill_chunk`` (a
chunk of each prompt over its cached context, through
``chunk_attention_on_gathered``; the context is gathered one layer at a
time, where the reference gathers every layer's at once). Both write
the valid rows' KV into the pools in place; they take float32/bf16
pools only, as in the reference.

``kv_kind`` "int8"/"fp8" serves from quantized pools with float32 scale
pools ``[n_layers, num_pages, page_size, KVH]`` beside them: the gather
impl dequantizes what it gathers, the kernel impl hands each layer's
scale pools to the kernels (which fuse the dequant into their page
loads), and the write side quantizes the tick's KV at append.

Multi-LoRA: ``lora`` holds each projection's adapter stacks in the
concatenated layout ``{"a": (L, in, S*r), "b": (L, S*r, out), "r": r}``
(S = max_loras + 1 slots, slot 0 the zero adapter), and ``lora_idx``
the slot of each row: one per token in ``ragged_forward``, one per
batch slot in ``decode_step``. ``wq``/``wk``/``wv``/``wo`` add the
delta ``((y @ A) * mask(idx)) @ B`` (``lora_delta``), the sum of
products the reference's gather-and-einsum form (``lora_delta_plain``)
computes, without a gathered ``(rows, in, r)`` copy of the stacks.

Not here yet: tensor parallelism.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import kv_quant
from ..ops.attention import attention as attention_op
from ..ops.paged_attention import (chunk_attention_on_gathered,
                                   decode_scratch, gather_context,
                                   gather_layer, paged_attention_on_gathered,
                                   paged_decode_with_new_token, scatter_kv,
                                   scatter_kv_quant)
from ..ops.ragged_paged_attention import (ragged_paged_attention,
                                          ragged_plan,
                                          ragged_prefill_decode_attention,
                                          ragged_scratch)
from .llama import LlamaConfig, rms_norm, rope_frequencies

IMPLS = ("gather", "kernel")


def _rope_single(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, D) one token per row; cos/sin: (B, D//2)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    cos = cos[:, None, :]
    sin = sin[:, None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


LORA_PROJS = ("wq", "wk", "wv", "wo")


def lora_mask(idx: torch.Tensor, r: int, n_cols: int) -> torch.Tensor:
    """(rows, S*r) bool: the r columns of each row's own adapter slot.
    Built on the device from idx (no host sync, a static shape)."""
    cols = torch.arange(n_cols, device=idx.device) // r
    return idx.long()[:, None] == cols[None, :]


def lora_delta(y: torch.Tensor, stack: Dict[str, Any], idx: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row low-rank delta for one projection at one layer.

    y: (N, in) or (N, S, in) activations; stack: this layer's slice of
    the concatenated stacks {"a": (in, S*r), "b": (S*r, out), "r": r};
    idx: (N,) adapter slot per row (0: the zero adapter, an exact
    no-op); mask: lora_mask(idx, r, S*r) when the caller shares one
    across layers. The middle product is in y's dtype (rounded before
    the second product, as in the reference); other slots' columns are
    masked to exact zeros, so the sum is the reference's."""
    if mask is None:
        mask = lora_mask(idx, stack["r"], stack["a"].shape[-1])
    return _lora_mid(y, stack["a"], mask) @ stack["b"]


def _lora_mid(y: torch.Tensor, a: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """(y @ A) with every column outside the row's slot zeroed."""
    mid = y @ a
    if mask.dtype != mid.dtype:
        mask = mask.to(mid.dtype)
    if y.dim() == 3:
        mask = mask[:, None, :]
    return mid * mask


def lora_delta_plain(y: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """The reference's form (``lora_delta`` in
    ``ray_tpu/models/llama_infer.py``): gather each row's adapter,
    then two rank-r products. a_stack: (S, in, r); b_stack: (S, r,
    out)."""
    a = a_stack[idx.long()]          # (N, in, r)
    b = b_stack[idx.long()]          # (N, r, out)
    if y.dim() == 2:
        mid = torch.einsum("bh,bhr->br", y, a)
        return torch.einsum("br,bro->bo", mid, b)
    mid = torch.einsum("bsh,bhr->bsr", y, a)
    return torch.einsum("bsr,bro->bso", mid, b)


def lora_cat(a_stack: np.ndarray, b_stack: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather-layout stacks (L, S, in, r) / (L, S, r, out) -> the
    concatenated layout (L, in, S*r) / (L, S*r, out)."""
    L, S, h, r = a_stack.shape
    return (a_stack.transpose(0, 2, 1, 3).reshape(L, h, S * r),
            b_stack.reshape(L, S * r, -1))


def _lora_layer(lora: Optional[Dict[str, Any]], i: int, masks):
    """Layer i's slice of the stacks, each with its shared mask."""
    if lora is None:
        return None
    return {p: {"a": st["a"][i], "b": st["b"][i], "r": st["r"],
                "mask": masks[st["r"]]} for p, st in lora.items()}


def _lora_masks(lora: Optional[Dict[str, Any]], idx, dt
                ) -> Dict[int, Any]:
    """One mask per distinct rank, in the compute dtype, shared by every
    layer of a forward."""
    if lora is None:
        return {}
    if idx is None:
        raise ValueError("lora stacks need lora_idx")
    return {st["r"]: lora_mask(idx, st["r"], st["a"].shape[-1]).to(dt)
            for st in lora.values()}


def _proj(y: torch.Tensor, w: torch.Tensor, dt,
          lora_l: Optional[Dict[str, Any]] = None,
          key: str = "") -> torch.Tensor:
    """y @ w in the compute dtype (weights are already stored in it by
    ``weights.params_from_numpy``; the cast is then a no-op), plus the
    rows' adapter delta for projection `key` when stacks are given: the
    masked middle product (rounded to the compute dtype, as in the
    reference), then its product with B accumulated onto y @ w in place,
    one launch (``addmm_``: the sum rounds once where the reference
    rounds the delta and then the sum; the zero adapter stays an exact
    no-op)."""
    out = y @ w.to(dt)
    if lora_l is not None and key in lora_l:
        st = lora_l[key]
        out.addmm_(_lora_mid(y, st["a"], st["mask"]), st["b"])
    return out


def _layer_body(cfg: LlamaConfig, dt, x, layer: Dict[str, torch.Tensor],
                lead: int, rope_fn, attn_fn, lora_l=None):
    """ONE transformer layer, shared by the ragged and decode paths.
    Returns (x, (k, v)) with k/v rope'd, ready for the KV scatter.
    lora_l: this layer's adapter stacks with the rows' slot masks
    (``_lora_layer``)."""
    y = rms_norm(x, layer["ln1"], cfg.norm_eps)
    q = _proj(y, layer["wq"], dt, lora_l, "wq").reshape(
        lead, cfg.n_heads, cfg.head_dim)
    k = _proj(y, layer["wk"], dt, lora_l, "wk").reshape(
        lead, cfg.n_kv_heads, cfg.head_dim)
    v = _proj(y, layer["wv"], dt, lora_l, "wv").reshape(
        lead, cfg.n_kv_heads, cfg.head_dim)
    q = rope_fn(q)
    k = rope_fn(k)
    attn = attn_fn(q, k, v)
    x = x + _proj(attn.reshape(lead, cfg.q_dim), layer["wo"], dt, lora_l,
                  "wo")
    y = rms_norm(x, layer["ln2"], cfg.norm_eps)
    gate = F.silu(y @ layer["wg"].to(dt))
    up = y @ layer["wi"].to(dt)
    x = x + (gate * up) @ layer["wd"].to(dt)
    return x, (k, v)


def _layer(params, i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i] for name, w in params["layers"].items()}


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _check_kind(kv_kind: str, k_scales, v_scales) -> bool:
    """Whether the pools are quantized; their scale pools come with them."""
    quantized = kv_quant.is_quantized(kv_kind)
    if quantized != (k_scales is not None) or \
            (k_scales is None) != (v_scales is None):
        raise ValueError(f"kv_kind {kv_kind!r} needs k_scales/v_scales "
                         f"exactly when it is int8/fp8")
    return quantized


def _at(scales: Optional[torch.Tensor], i: int) -> Optional[torch.Tensor]:
    """Layer i's scale pool (None for pools without scales)."""
    return None if scales is None else scales[i]


def _write_kv(k_pages, v_pages, k_scales, v_scales, k_rows, v_rows, tables,
              positions, valid, kv_kind: str):
    """The tick's KV into the pools, in place (quantized at append when
    the pools are)."""
    if k_scales is None:
        scatter_kv(k_pages, v_pages, k_rows, v_rows, tables, positions,
                   valid)
    else:
        scatter_kv_quant(k_pages, v_pages, k_scales, v_scales, k_rows,
                         v_rows, tables, positions, valid, kv_kind)


def ragged_forward(cfg: LlamaConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, slot_ids: torch.Tensor,
                   positions: torch.Tensor, valid: torch.Tensor,
                   start: torch.Tensor, last_idx: torch.Tensor,
                   k_pages: torch.Tensor, v_pages: torch.Tensor,
                   page_tables: torch.Tensor, ctx_pages: int = -1,
                   impl: str = "gather", max_seg_len: int = -1,
                   kv_kind: str = "f32",
                   k_scales: Optional[torch.Tensor] = None,
                   v_scales: Optional[torch.Tensor] = None,
                   lora: Optional[Dict[str, Any]] = None,
                   lora_idx: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Unified ragged prefill+decode forward over a flat token batch.

    tokens, slot_ids, positions: (T,) int32; valid: (T,) bool; start:
    (B,) int32 tokens already cached per slot; last_idx: (B,) flat index
    of each slot's last token (the logits source); page_tables:
    (B, max_pages) int32. Returns (logits (B, V) float32, k_pages,
    v_pages) with every valid token's KV written into the pools IN
    PLACE at its position (invalid rows hit the scratch page); with
    kv_kind int8/fp8, (logits, k_pages, v_pages, k_scales, v_scales).
    lora: the adapter stacks (module docstring); lora_idx: (T,) int32
    adapter slot per token."""
    _check_impl(impl)
    quantized = _check_kind(kv_kind, k_scales, v_scales)
    t = tokens.shape[0]
    dt = cfg.dtype
    masks = _lora_masks(lora, lora_idx, dt)
    x = params["embed"].to(dt)[tokens.long()]             # (T, H)
    cos, sin = rope_frequencies(cfg, positions)
    if impl == "gather":
        ctx_tables = (page_tables if ctx_pages < 0
                      else page_tables[:, :ctx_pages])
    else:
        max_seg = t if max_seg_len < 0 else max(min(max_seg_len, t), 1)
        # the segment map and the key chunks' scratch are the same for
        # every layer: build them once
        plan = ragged_plan(slot_ids, positions, valid, start, max_seg)
        scratch = ragged_scratch(t, cfg.n_heads, cfg.head_dim, dt,
                                 k_pages[0], page_tables,
                                 ctx_pages=ctx_pages, max_seg_len=max_seg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        if impl == "gather":
            k_ctx = gather_context(k_pages[i], _at(k_scales, i), ctx_tables)
            v_ctx = gather_context(v_pages[i], _at(v_scales, i), ctx_tables)

            def attn_fn(q, k, v):
                return ragged_prefill_decode_attention(
                    q, k_ctx, v_ctx, k, v, slot_ids, positions, valid,
                    start)
        else:
            def attn_fn(q, k, v, i=i):
                return ragged_paged_attention(
                    q, k_pages[i], v_pages[i], page_tables, slot_ids,
                    positions, valid, start, k.contiguous(),
                    v.contiguous(), ctx_pages=ctx_pages,
                    max_seg_len=max_seg, plan=plan,
                    k_scales=_at(k_scales, i), v_scales=_at(v_scales, i),
                    scratch=scratch)
        x, (k, v) = _layer_body(cfg, dt, x, _layer(params, i), t,
                                lambda a: _rope_single(a, cos, sin),
                                attn_fn, _lora_layer(lora, i, masks))
        ks.append(k)
        vs.append(v)
    k_rows = torch.stack(ks, dim=1)                      # (T, L, KVH, D)
    v_rows = torch.stack(vs, dim=1)
    _write_kv(k_pages, v_pages, k_scales, v_scales, k_rows, v_rows,
              page_tables[slot_ids.long()], positions, valid, kv_kind)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[last_idx.long()]                            # (B, H)
    logits = last.float() @ params["lm_head"].float()
    if quantized:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages


def decode_step(cfg: LlamaConfig, params: Dict[str, Any],
                tokens: torch.Tensor, positions: torch.Tensor,
                k_pages: torch.Tensor, v_pages: torch.Tensor,
                page_tables: torch.Tensor, active: torch.Tensor,
                impl: str = "gather", kv_kind: str = "f32",
                k_scales: Optional[torch.Tensor] = None,
                v_scales: Optional[torch.Tensor] = None,
                lora: Optional[Dict[str, Any]] = None,
                lora_idx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
    """One decode step for the whole running batch.

    tokens: (B,) last sampled token per slot; positions: (B,) int32 its
    absolute position (== cached tokens); active: (B,) bool. Returns
    (logits (B, V) float32, k_pages, v_pages) with the new token's KV
    written IN PLACE; with kv_kind int8/fp8, (logits, k_pages, v_pages,
    k_scales, v_scales). The kernel impl passes the full-width table;
    the kernel stops at each sequence's own last page. lora: the
    adapter stacks (module docstring); lora_idx: (B,) int32 adapter
    slot per batch slot."""
    _check_impl(impl)
    quantized = _check_kind(kv_kind, k_scales, v_scales)
    b = tokens.shape[0]
    dt = cfg.dtype
    masks = _lora_masks(lora, lora_idx, dt)
    x = params["embed"].to(dt)[tokens.long()]             # (B, H)
    cos, sin = rope_frequencies(cfg, positions)
    if impl != "gather":
        # the split context's partials: one buffer for every layer
        scratch = decode_scratch(b, cfg.n_heads, cfg.head_dim, dt,
                                 k_pages[0], page_tables)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        if impl == "gather":
            k_ctx = gather_context(k_pages[i], _at(k_scales, i), page_tables)
            v_ctx = gather_context(v_pages[i], _at(v_scales, i), page_tables)

            def attn_fn(q, k, v):
                # a dequantized context is float32; the new token joins it
                k_full = torch.cat([k_ctx, k[:, None].to(k_ctx.dtype)], 1)
                v_full = torch.cat([v_ctx, v[:, None].to(v_ctx.dtype)], 1)
                return paged_attention_on_gathered(
                    q, k_full, v_full, positions, append_len=1)
        else:
            def attn_fn(q, k, v, i=i):
                return paged_decode_with_new_token(
                    q, k_pages[i], v_pages[i], page_tables, positions,
                    k.contiguous(), v.contiguous(),
                    k_scales=_at(k_scales, i), v_scales=_at(v_scales, i),
                    scratch=scratch)
        x, (k, v) = _layer_body(cfg, dt, x, _layer(params, i), b,
                                lambda a: _rope_single(a, cos, sin),
                                attn_fn, _lora_layer(lora, i, masks))
        ks.append(k)
        vs.append(v)
    k_rows = torch.stack(ks, dim=1)                      # (B, L, KVH, D)
    v_rows = torch.stack(vs, dim=1)
    _write_kv(k_pages, v_pages, k_scales, v_scales, k_rows, v_rows,
              page_tables, positions, active, kv_kind)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x.float() @ params["lm_head"].float()
    if quantized:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages


# ------------------------------------------------- padded-batch prefill

def _check_emit(emit: str, allowed: Tuple[str, ...]) -> None:
    if emit not in allowed:
        raise ValueError(f"emit must be one of {allowed}, got {emit!r}")


def _prefill_attention_impl(cfg: LlamaConfig) -> str:
    """The reference's rule: "auto" and "ring" run the dense path."""
    return ("xla" if cfg.attention_impl in ("auto", "ring")
            else cfg.attention_impl)


def _rows_lora_idx(lora_idx: Optional[torch.Tensor],
                   n: int) -> Optional[torch.Tensor]:
    """(B,) adapter slots of the batch rows -> (B*n,) of their tokens."""
    return None if lora_idx is None else lora_idx.repeat_interleave(n)


def _padded_forward(cfg: LlamaConfig, params: Dict[str, Any],
                    tokens: torch.Tensor, positions: torch.Tensor,
                    k_pages, v_pages, page_tables, valid, attn_for_layer,
                    lora, lora_idx) -> torch.Tensor:
    """Every layer over a (B, S) padded batch, flattened to B*S rows for
    the products; `attn_for_layer(i)` gives layer i's attention on the
    flat (B*S, heads, D) q/k/v. Writes the valid rows' KV into the pools
    in place and returns the final activations (B, S, hidden)."""
    b, s = tokens.shape
    n = b * s
    dt = cfg.dtype
    idx = _rows_lora_idx(lora_idx, s)
    masks = _lora_masks(lora, idx, dt)
    x = params["embed"].to(dt)[tokens.reshape(-1).long()]      # (B*S, H)
    cos, sin = rope_frequencies(cfg, positions)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _layer_body(cfg, dt, x, _layer(params, i), n,
                                lambda a: _rope_single(a, cos, sin),
                                attn_for_layer(i), _lora_layer(lora, i, masks))
        ks.append(k)
        vs.append(v)
    scatter_kv(k_pages, v_pages, torch.stack(ks, dim=1),
               torch.stack(vs, dim=1), page_tables.repeat_interleave(s, 0),
               positions, valid)
    return x.reshape(b, s, -1)


def prefill(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            true_lens: torch.Tensor, k_pages: torch.Tensor,
            v_pages: torch.Tensor, page_tables: torch.Tensor,
            lora: Optional[Dict[str, Any]] = None,
            lora_idx: Optional[torch.Tensor] = None, emit: str = "logits"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-prompt forward over padded prompts.

    tokens: (B, S) int32, each row a prompt from position 0 padded past
    true_lens[b]; page_tables: (B, max_pages) int32. Causal attention
    over the batch's own keys (``_prefill_attention_impl``). Every valid
    row's KV is written IN PLACE (padding rows hit the scratch page).
    Returns (last_logits (B, V) float32 at row true_lens - 1, k_pages,
    v_pages); with emit="hidden", the activations (B, S, hidden) in
    place of the logits. lora_idx: (B,) adapter slot of each prompt."""
    _check_emit(emit, ("logits", "hidden"))
    b, s = tokens.shape
    dev = tokens.device
    impl = _prefill_attention_impl(cfg)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.arange(s, dtype=torch.int32, device=dev).repeat(b)

    def attn_for_layer(i):
        def attn(q, k, v):
            out = attention_op(q.reshape(b, s, h, d), k.reshape(b, s, kvh, d),
                               v.reshape(b, s, kvh, d), causal=True,
                               impl=impl)
            return out.reshape(b * s, h, d)
        return attn

    valid = positions < true_lens.repeat_interleave(s)
    x = _padded_forward(cfg, params, tokens, positions, k_pages, v_pages,
                        page_tables, valid, attn_for_layer, lora, lora_idx)
    if emit == "hidden":
        return x, k_pages, v_pages
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[torch.arange(b, device=dev), (true_lens.long() - 1)]
    logits = last.float() @ params["lm_head"].float()
    return logits, k_pages, v_pages


def prefill_chunk(cfg: LlamaConfig, params: Dict[str, Any],
                  tokens: torch.Tensor, start_pos: torch.Tensor,
                  chunk_lens: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, page_tables: torch.Tensor,
                  ctx_pages: int = -1, lora: Optional[Dict[str, Any]] = None,
                  lora_idx: Optional[torch.Tensor] = None,
                  emit: str = "logits"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A chunk of each prompt against its already-cached context.

    tokens: (B, C) int32 padded chunk; start_pos: (B,) tokens already in
    the pool; chunk_lens: (B,) valid tokens in the chunk. Query i sits
    at start_pos + i and attends the context (positions < start_pos,
    gathered one layer at a time from the first `ctx_pages` table
    entries, -1: all) and the chunk's keys j <= i. The chunk's valid KV
    is written IN PLACE at start_pos + [0, chunk_lens) through the full
    table. Returns (logits, k_pages, v_pages): emit="logits" the
    float32 logits (B, V) at each chunk's last valid token, "logits_all"
    float32 logits at every position (B, C, V) (a speculative verify),
    "hidden" the activations (B, C, hidden). lora_idx: (B,) adapter slot
    of each row."""
    _check_emit(emit, ("logits", "logits_all", "hidden"))
    b, c = tokens.shape
    dev = tokens.device
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    start = start_pos.to(torch.int32)
    positions = (start[:, None] + torch.arange(
        c, dtype=torch.int32, device=dev)[None, :]).reshape(-1)   # (B*C,)
    ctx_tables = page_tables if ctx_pages < 0 else page_tables[:, :ctx_pages]

    def attn_for_layer(i):
        k_ctx = gather_layer(k_pages[i], ctx_tables)
        v_ctx = gather_layer(v_pages[i], ctx_tables)

        def attn(q, k, v):
            out = chunk_attention_on_gathered(
                q.reshape(b, c, h, d), k_ctx, v_ctx, k.reshape(b, c, kvh, d),
                v.reshape(b, c, kvh, d), start, chunk_lens)
            return out.reshape(b * c, h, d)
        return attn

    valid = (torch.arange(c, device=dev)[None, :]
             < chunk_lens.to(dev)[:, None]).reshape(-1)
    x = _padded_forward(cfg, params, tokens, positions, k_pages, v_pages,
                        page_tables, valid, attn_for_layer, lora, lora_idx)
    if emit == "hidden":
        return x, k_pages, v_pages
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if emit == "logits_all":
        return x.float() @ params["lm_head"].float(), k_pages, v_pages
    last = x[torch.arange(b, device=dev),
             torch.clamp(chunk_lens.long() - 1, min=0)]
    logits = last.float() @ params["lm_head"].float()
    return logits, k_pages, v_pages
