"""Attention for training: the dense reference and flash attention.

PyTorch counterpart of ``ray_tpu/ops/attention.py``. Shapes follow
(batch, seq, heads, head_dim) with GQA (kv_heads divides heads).

- ``reference_attention``: the dense path (the JAX package's "xla").
- ``flash_attention``: a ``torch.autograd.Function`` whose forward and
  backward are the hand-written CUDA kernels of
  ``csrc/flash_attention.cu`` (forward, dq, dk/dv). Its forward saves
  (q, k, v, out, lse); its backward computes delta = rowsum(dO * O) and
  runs dq, then dk/dv. On CPU tensors the wrappers run the plain
  versions beside them (``flash_forward_plain``,
  ``flash_backward_plain``); on CUDA tensors they launch the kernels or
  raise. The kernels read the public layout through its strides, so
  none of the JAX wrapper's (B*H, S, D) transposes happen here; the
  logsumexp keeps the JAX contract, float32 (B*H, Sq, 1).
- ``attention``: the dispatcher, with the JAX package's rules.

``block_q``/``block_k`` keep the JAX signature and its validity rule
(``_resolve_blocks`` raises the same ValueError); the CUDA kernels tile
by their own 64 x 64 tiles and take any sequence length.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30
# head dims the CUDA kernels take (the `1b` and `8b` presets' 64 and 128)
KERNEL_HEAD_DIMS = (64, 128)


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, H, D) by repeating each kv head."""
    b, s, kvh, d = k.shape
    if kvh == num_heads:
        return k
    reps = num_heads // kvh
    return k[:, :, :, None, :].expand(b, s, kvh, reps, d).reshape(
        b, s, num_heads, d)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        kv_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q: (B, Sq, H, D); k/v: (B, Sk, KVH, D).

    Logits in float32 (products of the inputs, float32 sums), softmax in
    float32, probabilities cast to v's dtype for the value product, as
    the JAX reference does. q_offset/kv_offset are the global positions
    of the first query/key."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)[None]
        logits = torch.where((q_pos >= k_pos)[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ----------------------------------------------------------- plain versions

def _scores(q, k, causal, scale):
    """float32 scores (B, KVH, G, Sq, Sk) with the -1e30 causal mask
    (top-left aligned: row >= col, both from 0)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if causal:
        live = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None])
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    return s


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_flash_kernel`` computes, densely: out (q's dtype, (B, Sq,
    H, D)) and lse (float32, (B*H, Sq, 1)).

        m = max_k s, l = sum_k exp(s - m), out = (P V) / max(l, 1e-30),
        lse = m + log(max(l, 1e-30))."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    s = _scores(q, k, causal, scale)                  # (B, KVH, G, Sq, Sk)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    lse = (m + torch.log(l_safe)).reshape(b * h, sq, 1)
    return out.to(q.dtype), lse


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, laid out (B*H, Sq, 1) like
    lse (the JAX wrapper computes it in XLA before its kernels)."""
    b, sq, h, _ = out.shape
    d = (out.float() * do.float()).sum(-1)            # (B, Sq, H)
    return d.transpose(1, 2).reshape(b * h, sq, 1).contiguous()


def _probs(q, k, lse, causal, scale):
    """P = exp(s - lse), (B, KVH, G, Sq, Sk): masked scores underflow
    to 0."""
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    s = _scores(q, k, causal, scale)
    return torch.exp(s - lse.reshape(b, kvh, h // kvh, sq, 1))


def _dscores(q, k, v, do, lse, delta, causal, scale):
    """(P, dS) with dS = P * (dO V^T - delta)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    p = _probs(q, k, lse, causal, scale)
    dof = do.float().reshape(b, sq, kvh, g, d)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    return p, p * (dp - delta.reshape(b, kvh, g, sq, 1))


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float
                   ) -> torch.Tensor:
    """What ``_flash_dq_kernel`` computes: dq = scale * dS K."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    _, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    return dq.reshape(b, sq, h, d).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_flash_dkv_kernel`` computes, summed over each kv head's
    GQA group: dk = scale * dS^T Q, dv = P^T dO."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    p, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(b, sq, kvh, g, d)) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p,
                      do.float().reshape(b, sq, kvh, g, d))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, out, lse, do, causal: bool, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain versions, from the forward's saved
    lse: delta = rowsum(dO * O), P = exp(s - lse), dS = P * (dO V^T -
    delta); dq = scale * dS K; dk = scale * dS^T Q and dv = P^T dO, each
    summed over the GQA group. Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    delta = flash_delta(out, do)
    dq = flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    return (dq,) + flash_dkv_plain(q, k, v, do, lse, delta, causal, scale)


# ------------------------------------------------------------------ kernels

def _check(q, k, v, *more):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q (B, Sq, H, D) and k/v (B, Sk, KVH, D) expected")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the flash kernels take "
                         f"{KERNEL_HEAD_DIMS}")
    if _kernels.dtype_code(q.dtype) is None or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one of float32/bfloat16/"
                        "float16")
    for t in (q, k, v) + more:
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("inputs must be 16-byte aligned (the kernels "
                             "read them in 16-byte vectors)")


def _dims(q, k, causal, scale):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, int(bool(causal)),
            float(scale), _kernels.dtype_code(q.dtype))


def _launch(kernel, *ptrs_and_dims, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = kernel.fn()(*ptrs_and_dims, stream)
    _kernels.check(rc, kernel.name)
    kernel.launches += 1


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of flash attention. CPU tensors run
    ``flash_forward_plain``; CUDA tensors launch ``flash_fwd_kernel``
    (or raise)."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: no kernel for device {q.device}")
    _check(q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    _launch(_kernels.FLASH_FWD, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *_dims(q, k, causal, scale),
            device=q.device)
    return out, lse


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v, do, lse, delta)
    b, sq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must match q in shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b * h, sq, 1):
            raise ValueError(f"{name} must be float32 (B*H, Sq, 1)")


def flash_dq(q, k, v, do, lse, delta, causal: bool, scale: float
             ) -> torch.Tensor:
    """dq. CPU tensors run ``flash_dq_plain``; CUDA tensors launch
    ``flash_dq_tc_kernel`` (bf16) or ``flash_dq_kernel`` (float32,
    float16), or raise."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dq: no kernel for device {q.device}")
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch(_kernels.FLASH_DQ, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_dims(q, k, causal, scale), device=q.device)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv). CPU tensors run ``flash_dkv_plain``; CUDA tensors launch
    ``flash_dkv_kernel`` (or raise)."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dkv: no kernel for device {q.device}")
    _check_bwd(q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(_kernels.FLASH_DKV, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_dims(q, k, causal, scale), device=q.device)
    return dk, dv


def flash_backward(q, k, v, out, lse, do, causal: bool, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's out and lse: delta, then dq, then
    dk/dv. CPU tensors run the plain versions; CUDA tensors launch
    ``flash_dq_kernel`` and ``flash_dkv_kernel`` (or raise)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_backward: no kernel for device {q.device}")
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("out must match q in shape and dtype")
    do = do.contiguous()
    delta = flash_delta(out, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq,) + flash_dkv(q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, interpret):
        fwd = flash_forward_plain if interpret else flash_forward
        out, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.interpret = causal, scale, interpret
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_backward_plain if ctx.interpret else flash_backward
        dq, dk, dv = bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def _pick_block(limit: int, s: int) -> Optional[int]:
    """Largest block <= limit that divides s and is a multiple of 8."""
    b = min(limit, s)
    b -= b % 8
    while b >= 8:
        if s % b == 0:
            return b
        b -= 8
    return None


def _resolve_blocks(sq, sk, block_q, block_k):
    bq = _pick_block(block_q, sq)
    bk = _pick_block(block_k, sk)
    if bq is None or bk is None:
        raise ValueError(
            f"flash_attention needs seq lengths with a divisor that is a "
            f"multiple of 8 (sq={sq}, sk={sk}); pad inputs or use "
            f"impl='xla'.")
    return bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    interpret: bool = False) -> torch.Tensor:
    """Flash attention. q: (B, Sq, H, D); k/v: (B, Sk, KVH, D).
    Differentiable in q, k and v. ``interpret=True`` runs the plain
    versions on any device (the JAX ``interpret`` mode's counterpart)."""
    _resolve_blocks(q.shape[1], k.shape[1], block_q, block_k)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale, interpret)


# --------------------------------------------------------------- dispatcher

def auto_impl(device_type: str, sq: int, sk: int, d: int) -> str:
    """What "auto" resolves to: "pallas" (flash) on CUDA when the
    resolved blocks are >= 128 and head_dim is one the kernels take
    (both >= 64, the JAX rule's floor), else "xla" (tiny blocks mean
    awkward sequence lengths, where the dense path does better)."""
    bq = _pick_block(DEFAULT_BLOCK_Q, sq)
    bk = _pick_block(DEFAULT_BLOCK_K, sk)
    ok_shapes = (bq is not None and bk is not None and bq >= 128
                 and bk >= 128 and d in KERNEL_HEAD_DIMS)
    return "pallas" if (device_type == "cuda" and ok_shapes) else "xla"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """The JAX dispatcher's rules, with CUDA in the TPU's place.

    "auto" takes the flash kernels on a CUDA tensor when the shapes suit
    them and the reference otherwise (``auto_impl``): a rule by shape,
    not a caught failure. "pallas" is flash attention
    (kernels on CUDA, plain versions on CPU), "pallas_interpret" the
    plain versions, "xla" the reference. Ring and Ulysses attention need
    a sequence-sharded mesh, which this package does not have yet."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet (ROADMAP.md, "
            f"A11: ops/ring_attention.py and ops/ulysses.py)")
    if impl == "auto":
        impl = auto_impl(q.device.type, q.shape[1], k.shape[1], q.shape[-1])
    if impl == "pallas":
        return flash_attention(q, k, v, causal)
    if impl == "pallas_interpret":
        return flash_attention(q, k, v, causal, None, DEFAULT_BLOCK_Q,
                               DEFAULT_BLOCK_K, True)
    if impl == "xla":
        return reference_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")
