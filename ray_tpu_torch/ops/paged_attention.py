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
- dense gather (``gather_kv`` + ``paged_attention_on_gathered``, or
  ``paged_attention`` for one layer);
- the hand-written CUDA kernels ``csrc/paged_decode.cu`` behind
  ``paged_decode_attention`` / ``paged_decode_with_new_token``: bf16
  queries of the shapes ``decode_takes`` run the pipelined kernel (page
  rows in the pool's own type through per-warp ``cp.async`` rings, the
  products as ``mma.sync`` tiles), every other call the CUDA-core
  kernel; both split each context into chunks
  (``decode_split``) merged by a combine pass. On a CPU tensor these
  wrappers run the plain PyTorch version beside them
  (``paged_decode_attention_plain`` / ``paged_decode_with_new_token_plain``);
  on a CUDA tensor they launch a kernel or raise.

``chunk_attention_on_gathered`` runs multi-token queries over a gathered
context and the chunk's own causal keys (the chunked-prefill forward
``llama_infer.prefill_chunk``: the legacy engine step's long prompts and
the speculative draft and verify). Like the reference, where it is XLA
code outside any Pallas kernel, it is plain PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import _kernels, kv_quant

MASK = -1e30
# The decode kernels cut each context into chunks of split_tokens keys,
# one block a (sequence, kv head, chunk), and a combine pass merges the
# chunks (`decode_split` chooses the split).
MIN_BLOCKS_PER_SM = 2    # what a short table's split aims for
# The pipelined kernel for bf16 queries (``pdk`` in csrc/paged_decode.cu;
# ``pdk::takes`` there says the same as `decode_takes`).
DECODE_TILE = 16                   # keys a warp takes a step (kTile)
DECODE_MAX_SPLIT = 512             # keys a chunk at most
DECODE_HEAD_DIMS = (64, 128)
DECODE_PAGE_SIZES = (8, 16, 32, 64)
DECODE_MAX_GROUP = 8
# The CUDA-core kernel (every other call).
CUDA_CORE_TILE = 64                # its tile (kTK in flash_tile.cuh)
CUDA_CORE_MAX_SPLIT = 256


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


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_tables: torch.Tensor,
                    seq_lens: torch.Tensor, layer: int) -> torch.Tensor:
    """Single-layer decode attention, dense: layer `layer`'s pages
    gathered by the table, then ``paged_attention_on_gathered``.
    q: [B, H, D] (one new token a sequence); seq_lens: [B] valid cached
    tokens (the new one included). Returns [B, H, D]."""
    k = gather_layer(k_pages[layer], page_tables)
    v = gather_layer(v_pages[layer], page_tables)
    return paged_attention_on_gathered(q, k, v, seq_lens)


def chunk_attention_on_gathered(q: torch.Tensor, k_ctx: torch.Tensor,
                                v_ctx: torch.Tensor, k_chunk: torch.Tensor,
                                v_chunk: torch.Tensor, start: torch.Tensor,
                                chunk_lens: torch.Tensor) -> torch.Tensor:
    """Multi-token queries over a gathered context plus the chunk itself
    (chunked prefill, a prefix-cache suffix, a speculative verify).

    q: [B, C, H, D] queries at absolute positions start[b] + i;
    k_ctx/v_ctx: [B, ctx, KVH, D] the gathered pool (valid: position <
    start[b]); k_chunk/v_chunk: [B, C, KVH, D] the chunk's own KV;
    chunk_lens: [B] valid tokens in the chunk. Query i attends context
    positions < start[b] and chunk positions j <= i with j <
    chunk_lens[b]. Scores masked with -inf, softmax in float32 over both
    parts at once, GQA in kv-major head order. A row with no key (a slot
    with chunk_lens 0 and start 0) comes out NaN, as in the reference;
    callers discard those rows. Returns [B, C, H, D]."""
    b, c, h, d = q.shape
    ctx, kvh = k_ctx.shape[1], k_ctx.shape[2]
    group = h // kvh
    dev = q.device
    qf = q.reshape(b, c, kvh, group, d).float()
    scale = 1.0 / (d ** 0.5)
    s_ctx = torch.einsum("bikgd,bckd->bkgic", qf, k_ctx.float())
    s_chk = torch.einsum("bikgd,bjkd->bkgij", qf, k_chunk.float())
    ctx_mask = (torch.arange(ctx, device=dev)[None, :]
                < start.to(dev).long()[:, None])                # [B, ctx]
    i_idx = torch.arange(c, device=dev)[:, None]
    j_idx = torch.arange(c, device=dev)[None, :]
    chk_mask = ((j_idx <= i_idx)[None]
                & (j_idx[None] < chunk_lens.to(dev).long()[:, None, None]))
    neg = float("-inf")
    s_ctx = (s_ctx * scale).masked_fill(~ctx_mask[:, None, None, None, :],
                                        neg)
    s_chk = (s_chk * scale).masked_fill(~chk_mask[:, None, None, :, :], neg)
    probs = torch.softmax(torch.cat([s_ctx, s_chk], dim=-1), dim=-1)
    p_ctx, p_chk = probs[..., :ctx], probs[..., ctx:]
    out = (torch.einsum("bkgic,bckd->bikgd", p_ctx, v_ctx.float())
           + torch.einsum("bkgij,bjkd->bikgd", p_chk, v_chunk.float()))
    return out.reshape(b, c, h, d).to(q.dtype)


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


def decode_takes(dtype: torch.dtype, d: int, page_size: int,
                 group: int) -> bool:
    """Whether a decode call runs the pipelined kernel: bf16 queries with
    head_dim in DECODE_HEAD_DIMS, page_size in DECODE_PAGE_SIZES and
    group <= DECODE_MAX_GROUP. Every other call (float32 and float16
    queries; bf16 ones of other shapes, such as the ``debug`` preset's
    head_dim 32 or pages of 4 rows) runs the CUDA-core kernel."""
    return (dtype == torch.bfloat16 and d in DECODE_HEAD_DIMS
            and page_size in DECODE_PAGE_SIZES
            and 1 <= group <= DECODE_MAX_GROUP)


def decode_split(max_pages: int, page_size: int, n_rows: int, tile: int,
                 max_split: int, n_sm: int = 132) -> Tuple[int, int]:
    """(split_tokens, n_splits) for a table of `max_pages` pages and
    `n_rows` (sequence, kv head) pairs (B * KVH), from shapes only (the
    host knows the table's width, not the lengths). A chunk is a multiple
    of the page size and of the kernel's `tile`, at most `max_split` keys
    (rounded down to that multiple) so that long sequences spread over
    many blocks whatever the others' lengths, and small enough that a
    short table still gives each of `n_sm` SMs MIN_BLOCKS_PER_SM blocks
    where the unit allows it."""
    ctx = max(max_pages * page_size, 1)
    unit = math.lcm(page_size, tile)
    want = -(-MIN_BLOCKS_PER_SM * n_sm // max(n_rows, 1))
    split = min(ctx // want, max_split) // unit * unit
    split = max(split, unit)
    return split, -(-ctx // split)


def decode_partials_numel(b: int, h: int, d: int, n_splits: int) -> int:
    """float32 values of the chunks' partials, 0 for one chunk: acc
    [B, H, n_splits, D], then m and l [B, H, n_splits] each."""
    return 0 if n_splits <= 1 else b * h * n_splits * (d + 2)


def decode_partial_offsets(b: int, h: int, d: int,
                           n_splits: int) -> Tuple[int, int, int]:
    """Element offsets of (part_m, part_l, part_acc) in the one float32
    buffer of `decode_partials_numel` values: acc first (its rows keep
    the 16-byte alignment of the buffer), then m, then l."""
    n = b * h * n_splits
    return n * d, n * d + n, 0


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device: torch.device) -> int:
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())


@functools.lru_cache(maxsize=256)
def decode_plan(dtype: torch.dtype, d: int, page_size: int, kvh: int,
                group: int, b: int, max_pages: int,
                n_sm: int = 132) -> Tuple[bool, int, int]:
    """(pipelined kernel?, split_tokens, n_splits) of one decode call."""
    fast = decode_takes(dtype, d, page_size, group)
    if fast:
        split, n = decode_split(max_pages, page_size, b * kvh, DECODE_TILE,
                                DECODE_MAX_SPLIT, n_sm)
    else:
        split, n = decode_split(max_pages, page_size, b * kvh,
                                CUDA_CORE_TILE, CUDA_CORE_MAX_SPLIT, n_sm)
    return fast, split, n


def decode_scratch(b: int, h: int, d: int, dtype: torch.dtype,
                   k_pages: torch.Tensor, page_tables: torch.Tensor
                   ) -> Optional[torch.Tensor]:
    """One float32 buffer for the chunks' partials of every decode call
    of a tick with these arguments (q [B, H, D] of `dtype`, one layer's
    pool `k_pages`), or None when the calls need none (CPU tensors, one
    chunk). The calls run in stream order, so the layers share it."""
    if page_tables.device.type != "cuda":
        return None
    _, page_size, kvh, _ = k_pages.shape
    _, _, n = decode_plan(dtype, d, page_size, kvh, h // kvh, b,
                          page_tables.shape[1], _sm_count(page_tables.device))
    need = decode_partials_numel(b, h, d, n)
    if need == 0:
        return None
    return torch.empty(need, dtype=torch.float32, device=page_tables.device)


def _check_decode_args(q, k_pages, v_pages, page_tables, seq_lens,
                       k_new=None, v_new=None, k_scales=None, v_scales=None):
    """Raise on what the decode kernels do not take; return the pool kind
    (``check_pool_kind``)."""
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
    ts = (q, k_pages, v_pages, page_tables, seq_lens)
    if k_new is not None:
        if k_new.shape != (b, kvh, d) or v_new.shape != (b, kvh, d) \
                or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
            raise ValueError("k_new/v_new must be [B, KVH, D] in q's dtype")
        ts += (k_new, v_new)
    if kind:
        ts += (k_scales, v_scales)
    dev = q.get_device()
    for t in ts:
        if t.get_device() != dev:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16 or (
            k_new is not None
            and (k_new.data_ptr() % 16 or v_new.data_ptr() % 16)):
        raise ValueError("pools and new KV must be 16-byte aligned "
                         "(the kernel reads them in 16-byte vectors)")
    return kind


def _launch_decode(q, k_pages, v_pages, page_tables, seq_lens, k_new, v_new,
                   stats: bool, k_scales=None, v_scales=None, scratch=None):
    kind = _check_decode_args(q, k_pages, v_pages, page_tables, seq_lens,
                              k_new, v_new, k_scales, v_scales)
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = page_tables.shape[1]
    dev = q.device
    idx = dev.index
    fast, split, n_splits = decode_plan(q.dtype, d, page_size, kvh, h // kvh,
                                        b, max_pages, _sm_count(dev))
    if fast and q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned (the pipelined kernel "
                         "reads it in 16-byte vectors)")
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m, l = torch.empty((2, b, h), dtype=torch.float32, device=dev)
    part_m = part_l = part_acc = None
    if n_splits > 1:
        need = decode_partials_numel(b, h, d, n_splits)
        if scratch is None:
            scratch = torch.empty(need, dtype=torch.float32, device=dev)
        elif scratch.dtype != torch.float32 or scratch.get_device() != idx \
                or scratch.numel() < need or not scratch.is_contiguous() \
                or scratch.data_ptr() % 16:
            raise ValueError(f"scratch must be a contiguous, 16-byte "
                             f"aligned float32 tensor of at least {need} "
                             f"values on q's device")
        base = scratch.data_ptr()
        part_m, part_l, part_acc = (
            base + 4 * o for o in decode_partial_offsets(b, h, d, n_splits))
    kernel = _kernels.PAGED_DECODE_BY_KIND[kind]
    fn = kernel.fn()
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            page_tables.data_ptr(), seq_lens.data_ptr(),
            None if k_new is None else k_new.data_ptr(),
            None if v_new is None else v_new.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(), part_m, part_l, part_acc,
            b, h, kvh, d, page_size, max_pages, split, n_splits,
            _kernels.dtype_code(q.dtype), kind)
    if idx == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    _kernels.check(rc, kernel.name)
    kernel.count("pipelined" if fast else "cuda_core")
    return out, m, l


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           return_stats: bool = False,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None,
                           scratch: Optional[torch.Tensor] = None):
    """Paged decode attention for one layer.

    q: [B, H, D]; k_pages/v_pages: [num_pages, page_size, KVH, D] (one
    layer); page_tables: [B, max_pages] int32; seq_lens: [B] int32
    cached tokens. Returns [B, H, D], or (out, m, l) with the [B, H]
    float32 row max and denominator when return_stats. A sequence
    attends its first max(seq_len, 1) cached keys. With k_scales/
    v_scales ([num_pages, page_size, KVH] float32) the pools hold int8
    or fp8 values, dequantized as they are read.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/paged_decode.cu`` (or raise): the pipelined kernel for the
    calls ``decode_takes``, the CUDA-core kernel for all others, each
    with a combine pass when the context is split into several chunks
    (``decode_split``). `scratch` is ``decode_scratch``'s buffer for the
    chunks' partials, shared by a tick's layers (None allocates one for
    this call)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_tables, seq_lens,
            return_stats=return_stats, k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for "
                         f"device {q.device}")
    out, m, l = _launch_decode(q, k_pages, v_pages, page_tables, seq_lens,
                               None, None, stats=return_stats,
                               k_scales=k_scales, v_scales=v_scales,
                               scratch=scratch)
    return (out, m, l) if return_stats else out


def paged_decode_with_new_token(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_tables: torch.Tensor,
                                seq_lens: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, *,
                                k_scales: Optional[torch.Tensor] = None,
                                v_scales: Optional[torch.Tensor] = None,
                                scratch: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Decode over the cached pages plus the current token's KV (not yet
    scattered into the pool). q/k_new/v_new: [B, H, D] / [B, KVH, D];
    seq_lens counts cached tokens only. With scales the pools are int8/
    fp8 and the new token's KV stays in q's dtype. On CUDA the kernel
    merges the new token as one more always-live key in the same launch;
    the plain version merges it after the fact, as the JAX package
    does. `scratch` as in ``paged_decode_attention``."""
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
                               v_scales=v_scales, scratch=scratch)
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
