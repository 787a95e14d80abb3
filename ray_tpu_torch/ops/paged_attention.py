"""Paged attention: decode-time attention over a block-paged KV cache.

PyTorch counterpart of ``ray_tpu/ops/paged_attention.py``, same pool
layout: one pool shared by all layers, layer-major,

    k_pages, v_pages: [n_layers, num_pages, page_size, n_kv_heads, head_dim]

whose last page is a scratch page that masked writes land on.

Quantized pools (``kv_quant``): int8 or fp8 values with float32 scale
pools ``[n_layers, num_pages, page_size, n_kv_heads]`` beside them.
The write side quantizes at append (``scatter_kv_quant``); the read
side dequantizes on gather (``gather_kv_quant``, ``gather_layer_quant``)
or in the decode kernel's page loads (``k_scales``/``v_scales``).

Two decode paths:
- dense gather (``gather_kv`` + ``paged_attention_on_gathered``);
- the hand-written CUDA kernel ``csrc/paged_decode.cu`` behind
  ``paged_decode_attention`` / ``paged_decode_with_new_token``. On a CPU
  tensor these wrappers run the plain PyTorch version beside them
  (``paged_decode_attention_plain`` / ``paged_decode_with_new_token_plain``);
  on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels, kv_quant

MASK = -1e30
# keys per block of the decode kernel's split of each context (split-K);
# a combine pass merges the chunks
SPLIT_TOKENS = 256


def gather_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
              page_tables: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """page_tables: [B, max_pages] ->
    k/v: [n_layers, B, max_pages*page_size, n_kv_heads, head_dim]."""
    def one(pages):
        g = pages[:, page_tables.long()]       # [L, B, P, page, KVH, D]
        l, b, p, s, h, d = g.shape
        return g.reshape(l, b, p * s, h, d)
    return one(k_pages), one(v_pages)


def gather_layer(pages: torch.Tensor, page_tables: torch.Tensor
                 ) -> torch.Tensor:
    """One layer's pool [num_pages, page, KVH, D] gathered by the table:
    [B, max_pages*page, KVH, D] (``gather_kv`` one layer at a time, so
    a forward never holds every layer's gathered context at once)."""
    g = pages[page_tables.long()]
    b, p, s, h, d = g.shape
    return g.reshape(b, p * s, h, d)


def gather_kv_quant(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k_scales: torch.Tensor, v_scales: torch.Tensor,
                    page_tables: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gather_kv`` over quantized pools: values and scales gathered by
    the table and dequantized -> float32 [n_layers, B, ctx, KVH, D]."""
    def one(pages, scales):
        g = pages[:, page_tables.long()].float()     # [L, B, P, page, KVH, D]
        s = scales[:, page_tables.long()].float()    # [L, B, P, page, KVH]
        l, b, p, sz, h, d = g.shape
        return (g * s[..., None]).reshape(l, b, p * sz, h, d)
    return one(k_pages, k_scales), one(v_pages, v_scales)


def gather_layer_quant(pages: torch.Tensor, scales: torch.Tensor,
                       page_tables: torch.Tensor) -> torch.Tensor:
    """One layer of ``gather_kv_quant``: pool [num_pages, page, KVH, D]
    and scales [num_pages, page, KVH] -> float32 [B, ctx, KVH, D]."""
    g = pages[page_tables.long()].float()
    s = scales[page_tables.long()].float()
    b, p, sz, h, d = g.shape
    return (g * s[..., None]).reshape(b, p * sz, h, d)


def gather_context(pages: torch.Tensor, scales: Optional[torch.Tensor],
                   page_tables: torch.Tensor) -> torch.Tensor:
    """One layer's context by the table: ``gather_layer_quant`` (float32)
    when the pool has scales, else ``gather_layer`` (the pool's dtype)."""
    if scales is None:
        return gather_layer(pages, page_tables)
    return gather_layer_quant(pages, scales, page_tables)


def paged_attention_on_gathered(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, seq_lens: torch.Tensor,
                                append_len: int = 0) -> torch.Tensor:
    """q: [B, H, D]; k/v: [B, ctx, KVH, D]; seq_lens: [B] -> [B, H, D].

    Valid positions: the first seq_lens[b] entries plus the last
    `append_len` (decode appends the current token's KV at the tail).
    GQA in kv-major head order, softmax in float32."""
    b, h, d = q.shape
    ctx, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qf = q.reshape(b, kvh, group, d).float()
    scores = torch.einsum("bkgd,bckd->bkgc", qf, k.float()) / (d ** 0.5)
    idx = torch.arange(ctx, device=q.device)[None, :]
    mask = idx < seq_lens.to(q.device)[:, None]
    if append_len:
        mask = mask | (idx >= ctx - append_len)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


# ------------------------------------------------------------- decode kernel

def paged_decode_attention_plain(q, k_pages, v_pages, page_tables, seq_lens,
                                 *, return_stats: bool = False,
                                 k_scales=None, v_scales=None):
    """Plain version of the decode kernel: dense gather of each
    sequence's table (dequantized as ``value.float() * scale`` when scales
    are given), then the kernel's exact masking rule (keys at positions
    < max(seq_len, 1), -1e30 mask, 1e-30 denominator floor) with the
    float32 row max `m` and denominator `l` it reports."""
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    group = h // kvh
    kg = gather_context(k_pages, k_scales, page_tables).float()
    vg = gather_context(v_pages, v_scales, page_tables).float()
    ctx = kg.shape[1]
    qf = q.reshape(b, kvh, group, d).float()
    s = torch.einsum("bkgd,bckd->bkgc", qf, kg) * (d ** -0.5)
    length = torch.clamp(seq_lens.to(q.device).long(), min=1)
    live = (torch.arange(ctx, device=q.device)[None, :]
            < length[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, MASK))
    m = s.amax(dim=-1)                                 # [B, KVH, G]
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgc,bckd->bkgd", p, vg)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(b, h, d)
    out = out.to(q.dtype)
    if return_stats:
        return out, m.reshape(b, h), l.reshape(b, h)
    return out


def _merge_new_token(q, out, m, l, k_new, v_new):
    """One more online-softmax step for the not-yet-paged token's KV
    (``paged_decode_with_new_token``'s merge in the JAX package)."""
    b, h, d = q.shape
    kvh = k_new.shape[1]
    group = h // kvh
    qf = q.reshape(b, kvh, group, d).float()
    s_new = torch.einsum("bkgd,bkd->bkg", qf, k_new.float()).reshape(
        b, h) * (d ** -0.5)
    m_tot = torch.maximum(m, s_new)
    c_old = torch.exp(m - m_tot)
    c_new = torch.exp(s_new - m_tot)
    l_tot = l * c_old + c_new
    vf = torch.repeat_interleave(v_new.float(), group, dim=1)
    num = out.float() * (l * c_old)[..., None] + vf * c_new[..., None]
    return (num / torch.clamp(l_tot, min=1e-30)[..., None]).to(q.dtype)


def paged_decode_with_new_token_plain(q, k_pages, v_pages, page_tables,
                                      seq_lens, k_new, v_new, *,
                                      k_scales=None, v_scales=None):
    out, m, l = paged_decode_attention_plain(
        q, k_pages, v_pages, page_tables, seq_lens, return_stats=True,
        k_scales=k_scales, v_scales=v_scales)
    return _merge_new_token(q, out, m, l, k_new, v_new)


def check_pool_kind(q, k_pages, v_pages, k_scales, v_scales) -> int:
    """The kernels' pool kind code: 0 for pools in q's dtype (no
    scales), 1 for int8 and 2 for fp8 pools with float32 scale pools
    [num_pages, page, KVH]. Raises on anything else."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must come together")
    if _kernels.dtype_code(q.dtype) is None:
        raise TypeError("q must be float32, bfloat16 or float16")
    if k_scales is None:
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise TypeError("pools without scales must be in q's dtype")
        return 0
    code = {"int8": 1, "fp8": 2}[kv_quant.kind_of(k_pages.dtype)]
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("k and v pools must share one storage dtype")
    want = kv_quant.scale_shape(tuple(k_pages.shape))
    for s in (k_scales, v_scales):
        if s.dtype != torch.float32 or tuple(s.shape) != want:
            raise ValueError(f"scales must be float32 {want}")
    if k_pages.shape[-1] % 16:
        raise ValueError("quantized pools need head_dim % 16 == 0 (the "
                         "kernel reads 16 one-byte values a load)")
    return code


def _check_decode_args(q, k_pages, v_pages, page_tables, seq_lens,
                       k_new=None, v_new=None, k_scales=None, v_scales=None):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("q [B, H, D] and pools [P, page, KVH, D] expected")
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != d or h % kvh:
        raise ValueError(f"head dims disagree: q {tuple(q.shape)}, "
                         f"pool {tuple(k_pages.shape)}")
    if page_tables.dim() != 2 or page_tables.shape[0] != b \
            or seq_lens.shape != (b,):
        raise ValueError("page_tables [B, max_pages] and seq_lens [B]")
    if page_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("page_tables and seq_lens must be int32")
    kind = check_pool_kind(q, k_pages, v_pages, k_scales, v_scales)
    if d % 8 or d > 256:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 8 "
                         f"up to 256")
    ts = [q, k_pages, v_pages, page_tables, seq_lens]
    if k_new is not None:
        if k_new.shape != (b, kvh, d) or v_new.shape != (b, kvh, d) \
                or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
            raise ValueError("k_new/v_new must be [B, KVH, D] in q's dtype")
        ts += [k_new, v_new]
    scales = [k_scales, v_scales] if kind else []
    for t in ts + scales:
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    for t in ts[1:3] + ts[5:]:
        if t.data_ptr() % 16:
            raise ValueError("pools and new KV must be 16-byte aligned "
                             "(the kernel reads them in 16-byte vectors)")
    return kind


def _launch_decode(q, k_pages, v_pages, page_tables, seq_lens, k_new, v_new,
                   stats: bool, k_scales=None, v_scales=None):
    kind = _check_decode_args(q, k_pages, v_pages, page_tables, seq_lens,
                              k_new, v_new, k_scales, v_scales)
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = page_tables.shape[1]
    n_splits = max(-(-max_pages * page_size // SPLIT_TOKENS), 1)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((b, h), **f32)
        l = torch.empty((b, h), **f32)
    part_m = part_l = part_acc = None
    if n_splits > 1:
        part_m = torch.empty((b, h, n_splits), **f32)
        part_l = torch.empty((b, h, n_splits), **f32)
        part_acc = torch.empty((b, h, n_splits, d), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None
    kernel = _kernels.PAGED_DECODE_BY_KIND[kind]
    fn = kernel.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scales),
                ptr(v_scales), ptr(page_tables), ptr(seq_lens), ptr(k_new),
                ptr(v_new), ptr(out), ptr(m), ptr(l), ptr(part_m),
                ptr(part_l), ptr(part_acc), b, h, kvh, d, page_size,
                max_pages, SPLIT_TOKENS, n_splits,
                _kernels.dtype_code(q.dtype), kind, stream)
    _kernels.check(rc, kernel.name)
    kernel.launches += 1
    return out, m, l


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           return_stats: bool = False,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None):
    """Paged decode attention for one layer.

    q: [B, H, D]; k_pages/v_pages: [num_pages, page_size, KVH, D] (one
    layer); page_tables: [B, max_pages] int32; seq_lens: [B] int32
    cached tokens. Returns [B, H, D], or (out, m, l) with the [B, H]
    float32 row max and denominator when return_stats. A sequence
    attends its first max(seq_len, 1) cached keys. With k_scales/
    v_scales ([num_pages, page_size, KVH] float32) the pools hold int8
    or fp8 values, dequantized as they are read.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/paged_decode.cu`` (or raise)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_tables, seq_lens,
            return_stats=return_stats, k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for "
                         f"device {q.device}")
    out, m, l = _launch_decode(q, k_pages, v_pages, page_tables, seq_lens,
                               None, None, stats=return_stats,
                               k_scales=k_scales, v_scales=v_scales)
    return (out, m, l) if return_stats else out


def paged_decode_with_new_token(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_tables: torch.Tensor,
                                seq_lens: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, *,
                                k_scales: Optional[torch.Tensor] = None,
                                v_scales: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Decode over the cached pages plus the current token's KV (not yet
    scattered into the pool). q/k_new/v_new: [B, H, D] / [B, KVH, D];
    seq_lens counts cached tokens only. With scales the pools are int8/
    fp8 and the new token's KV stays in q's dtype. On CUDA the kernel
    merges the new token as one more always-live key in the same launch;
    the plain version merges it after the fact, as the JAX package
    does."""
    if q.device.type == "cpu":
        return paged_decode_with_new_token_plain(
            q, k_pages, v_pages, page_tables, seq_lens, k_new, v_new,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_with_new_token: no kernel for "
                         f"device {q.device}")
    out, _, _ = _launch_decode(q, k_pages, v_pages, page_tables, seq_lens,
                               k_new.contiguous(), v_new.contiguous(),
                               stats=False, k_scales=k_scales,
                               v_scales=v_scales)
    return out


# ---------------------------------------------------------------- KV writes

def scatter_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor,
               page_tables: torch.Tensor, positions: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new KV rows into the page pool, IN PLACE (the JAX version
    returns new pools; the port updates the tensors it was given and
    returns them).

    k_new/v_new: [N, n_layers, KVH, D]; page_tables: [N, max_pages] each
    token's own table; positions: [N]; valid: [N] bool — invalid rows
    write to the scratch page (the pool's last page). Row index on the
    flattened [L, P*page, KVH, D] view: page * page_size + offset. The
    table column is clamped into range, as JAX's gather clamps."""
    l, num_pages, page_size, kvh, d = k_pages.shape
    rows = _flat_rows(page_tables, positions, valid, num_pages, page_size)
    kf = k_pages.view(l, num_pages * page_size, kvh, d)
    vf = v_pages.view(l, num_pages * page_size, kvh, d)
    kf.index_copy_(1, rows, k_new.transpose(0, 1).to(k_pages.dtype))
    vf.index_copy_(1, rows, v_new.transpose(0, 1).to(v_pages.dtype))
    return k_pages, v_pages


def _flat_rows(page_tables, positions, valid, num_pages: int,
               page_size: int) -> torch.Tensor:
    """Each token's row in the flattened [P*page] view of a layer; invalid
    tokens land on the scratch page (the last)."""
    positions = positions.long()
    col = torch.clamp(positions // page_size, 0, page_tables.shape[1] - 1)
    page_idx = torch.gather(page_tables.long(), 1, col[:, None])[:, 0]
    page_idx = torch.where(valid, page_idx,
                           torch.full_like(page_idx, num_pages - 1))
    return page_idx * page_size + positions % page_size


def scatter_kv_quant(k_pages: torch.Tensor, v_pages: torch.Tensor,
                     k_scales: torch.Tensor, v_scales: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     page_tables: torch.Tensor, positions: torch.Tensor,
                     valid: torch.Tensor, kind: str):
    """``scatter_kv`` for quantized pools, IN PLACE: the new rows
    [N, n_layers, KVH, D] are quantized to `kind` with per-(row, head)
    scales, and values and scales land at the same flat rows of their
    pools (invalid rows on the scratch page of both). Each row carries
    its own scale, so no neighbour row is re-read. Values are written
    through a uint8 view of the pool: bit-exact, and it needs no
    index_copy_ kernel for float8. Returns the four pools."""
    l, num_pages, page_size, kvh, d = k_pages.shape
    rows = _flat_rows(page_tables, positions, valid, num_pages, page_size)
    n = num_pages * page_size
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        q, s = kv_quant.quantize_rows(new, kind)     # [N, L, KVH, (D)]
        pages.view(torch.uint8).view(l, n, kvh, d).index_copy_(
            1, rows, q.transpose(0, 1).contiguous().view(torch.uint8))
        scales.view(l, n, kvh).index_copy_(1, rows, s.transpose(0, 1))
    return k_pages, v_pages, k_scales, v_scales
