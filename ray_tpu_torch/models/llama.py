"""Llama-family model configuration, parameters and shared modules.

PyTorch counterpart of ``ray_tpu/models/llama.py``: the same presets,
the same parameter tree (names, layers stacked on a leading axis,
``(in, out)`` matrix orientation), so one tree converts to the other
through numpy (``weights.params_from_numpy``), and the training half:
``decoder_layer``, ``hidden_states``, ``forward``, ``loss_fn`` and
``flops_per_token`` (dense models on one device; MoE, ring/Ulysses
attention, meshes and pipelines are not ported yet).

Remat is ``torch.utils.checkpoint`` per layer and per loss chunk, where
the JAX package uses ``jax.checkpoint``: it changes what is kept for
the backward, not the numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention as attention_op


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    ffn: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq: int = 8192
    dtype: Any = torch.bfloat16          # activation/compute dtype
    param_dtype: Any = torch.float32     # storage dtype
    attention_impl: str = "auto"
    # MoE fields are kept so the presets read as in the JAX package;
    # the serving path here runs dense models only.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dropless: bool = False
    pp_microbatches: int = 4
    pp_schedule: str = "gpipe"
    pp_interleave: int = 2
    remat: bool = True
    remat_policy: str = "dots_no_batch"
    loss_chunk: int = 512

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def num_params(self) -> int:
        ffn_mult = max(self.n_experts, 1)
        per_layer = (self.hidden * (self.q_dim + 2 * self.kv_dim)
                     + self.q_dim * self.hidden
                     + 3 * self.hidden * self.ffn * ffn_mult
                     + (self.hidden * self.n_experts if self.n_experts else 0)
                     + 2 * self.hidden)
        return (self.vocab_size * self.hidden * 2
                + self.n_layers * per_layer + self.hidden)


# Model-size presets (Llama-3 family shapes).
PRESETS: Dict[str, LlamaConfig] = {
    "debug": LlamaConfig(vocab_size=256, hidden=128, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=32, ffn=256, max_seq=256),
    "tiny": LlamaConfig(vocab_size=2048, hidden=512, n_layers=4, n_heads=8,
                        n_kv_heads=4, head_dim=64, ffn=1536, max_seq=2048),
    "debug_moe": LlamaConfig(vocab_size=256, hidden=128, n_layers=2,
                             n_heads=4, n_kv_heads=2, head_dim=32, ffn=256,
                             max_seq=256, n_experts=4, moe_top_k=2),
    "8x7b": LlamaConfig(vocab_size=32000, hidden=4096, n_layers=32,
                        n_heads=32, n_kv_heads=8, head_dim=128, ffn=14336,
                        n_experts=8, moe_top_k=2),
    "1b": LlamaConfig(vocab_size=128256, hidden=2048, n_layers=16,
                      n_heads=32, n_kv_heads=8, head_dim=64, ffn=8192),
    "3b": LlamaConfig(vocab_size=128256, hidden=3072, n_layers=28,
                      n_heads=24, n_kv_heads=8, head_dim=128, ffn=8192),
    "8b": LlamaConfig(vocab_size=128256, hidden=4096, n_layers=32,
                      n_heads=32, n_kv_heads=8, head_dim=128, ffn=14336),
    "70b": LlamaConfig(vocab_size=128256, hidden=8192, n_layers=80,
                       n_heads=64, n_kv_heads=8, head_dim=128, ffn=28672),
}


def config(name_or_cfg, **overrides) -> LlamaConfig:
    cfg = PRESETS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# --------------------------------------------------------------------- params

def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Random parameters (layers stacked on the leading axis), drawn from
    `generator` on `device` (the generator's own device by default).
    Same tree and orientation as the JAX package; the numbers differ."""
    device = torch.device(device) if device is not None else generator.device
    h, L = cfg.hidden, cfg.n_layers
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    if cfg.n_experts:
        E = cfg.n_experts
        mlp = {
            "router": dense((L, h, E), h),
            "wi": dense((L, E, h, cfg.ffn), h),
            "wg": dense((L, E, h, cfg.ffn), h),
            "wd": dense((L, E, cfg.ffn, h), cfg.ffn),
        }
    else:
        mlp = {
            "wi": dense((L, h, cfg.ffn), h),
            "wg": dense((L, h, cfg.ffn), h),
            "wd": dense((L, cfg.ffn, h), cfg.ffn),
        }
    return {
        "embed": dense((cfg.vocab_size, h), h),
        "layers": {
            "wq": dense((L, h, cfg.q_dim), h),
            "wk": dense((L, h, cfg.kv_dim), h),
            "wv": dense((L, h, cfg.kv_dim), h),
            "wo": dense((L, cfg.q_dim, h), cfg.q_dim),
            **mlp,
            "ln1": ones((L, h)),
            "ln2": ones((L, h)),
        },
        "final_norm": ones((h,)),
        "lm_head": dense((h, cfg.vocab_size), h),
    }


# -------------------------------------------------------------------- modules

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope_frequencies(cfg: LlamaConfig, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (S,) -> cos/sin of shape (S, head_dim//2), float32."""
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32,
                     device=positions.device) / half))
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); rotate-half RoPE."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ training

def _attend(cfg: LlamaConfig, q, k, v):
    # "ring" and "ulysses" raise in the dispatcher: no sequence-sharded
    # mesh in this package yet
    return attention_op(q, k, v, causal=True, impl=cfg.attention_impl)


def decoder_layer(cfg: LlamaConfig, x: torch.Tensor,
                  layer: Dict[str, torch.Tensor], cos: torch.Tensor,
                  sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dense layer. Returns (x, aux): aux is the MoE load-balance
    loss, 0 for the dense layers this package runs."""
    if cfg.n_experts:
        raise NotImplementedError("MoE layers (ops/moe.py) are not ported "
                                  "yet (ROADMAP.md, A11)")
    b, s, _ = x.shape
    dt = cfg.dtype
    y = rms_norm(x, layer["ln1"], cfg.norm_eps)
    q = (y @ layer["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (y @ layer["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (y @ layer["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = _attend(cfg, q, k, v).reshape(b, s, cfg.q_dim)
    x = x + attn @ layer["wo"].to(dt)
    y = rms_norm(x, layer["ln2"], cfg.norm_eps)
    gate = F.silu(y @ layer["wg"].to(dt))
    up = y @ layer["wi"].to(dt)
    x = x + (gate * up) @ layer["wd"].to(dt)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def hidden_states_with_aux(cfg: LlamaConfig, params: Dict[str, Any],
                           tokens: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int -> (final-norm hidden states (B, S, hidden),
    summed MoE aux loss)."""
    _, s = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    cos, sin = rope_frequencies(
        cfg, torch.arange(s, device=tokens.device))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # one unbind per stacked leaf (lax.scan's slicing): its backward
    # stacks the layers' grads once, where indexing each layer would add
    # a full-size gradient per layer
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        layer = {name: w[i] for name, w in layers.items()}
        if cfg.remat:
            # one layer's activations are recomputed in the backward; the
            # computation has no randomness, so no RNG state is stashed
            x, a = checkpoint(decoder_layer, cfg, x, layer, cos, sin,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = decoder_layer(cfg, x, layer, cos, sin)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def hidden_states(cfg: LlamaConfig, params: Dict[str, Any],
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> final-norm hidden states (B, S, hidden)."""
    return hidden_states_with_aux(cfg, params, tokens)[0]


class _HeadMatmul(torch.autograd.Function):
    """(N, h) @ (h, V) of bf16/f16 operands on CUDA with a float32 result:
    cuBLAS's product with a float32 output
    (``torch.mm(..., out_dtype=torch.float32)``). The backward gives dx
    and dw in the operands' dtype (the JAX transpose rules' output
    dtypes) from the float32 cotangent rounded to that dtype, as a TPU's
    default-precision dot rounds it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.t(), x.t() @ g


def _head_logits(cfg: LlamaConfig, x: torch.Tensor,
                 lm_head: torch.Tensor) -> torch.Tensor:
    """(B, S, hidden) -> float32 logits (B, S, vocab) from compute-dtype
    operands, as the JAX einsum with preferred_element_type=float32.
    Off CUDA (or in float32) the operands are upcast: the products of
    bf16 numbers are exact in float32, so both paths are one
    float32-accumulated product of the rounded operands."""
    b, s, h = x.shape
    x = x.to(cfg.dtype).reshape(b * s, h)
    w = lm_head.to(cfg.dtype)
    if x.is_cuda and x.dtype != torch.float32:
        logits = _HeadMatmul.apply(x, w)
    else:
        logits = x.float() @ w.float()
    return logits.reshape(b, s, -1)


def forward(cfg: LlamaConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab) float32."""
    return _head_logits(cfg, hidden_states(cfg, params, tokens),
                        params["lm_head"])


def _chunk_nll(cfg, x_c, t_c, lm_head):
    logits = _head_logits(cfg, x_c, lm_head)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, t_c[..., None])[..., 0]
    return lse - tgt


def loss_fn(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy. tokens: (B, S); mask: (B, S) or None.

    The head matmul and softmax run in sequence chunks (cfg.loss_chunk)
    under remat, so the (B, S, vocab) logits never materialize. The
    chunk is the largest divisor of S within cfg.loss_chunk."""
    b, s = tokens.shape
    tokens = tokens.long()
    x, moe_aux = hidden_states_with_aux(cfg, params, tokens)
    # position i predicts token i+1; the weight of position i is the
    # target's mask (mask[i+1]); the last position is masked out
    zero = torch.zeros((b, 1), dtype=tokens.dtype, device=tokens.device)
    targets = torch.cat([tokens[:, 1:], zero], dim=1)
    if mask is not None:
        m = torch.cat([mask[:, 1:].float(), zero.float()], dim=1)
    else:
        m = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
        m[:, -1] = 0.0

    chunk = 0
    if cfg.loss_chunk:
        c = min(cfg.loss_chunk, s)
        while c > 1 and s % c:
            c -= 1
        chunk = c
    if chunk and s > chunk:
        nll = torch.cat([
            checkpoint(_chunk_nll, cfg, x[:, i:i + chunk],
                       targets[:, i:i + chunk], params["lm_head"],
                       use_reentrant=False, preserve_rng_state=False)
            for i in range(0, s, chunk)], dim=1)
    else:
        logits = _head_logits(cfg, x, params["lm_head"])
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]

    total = (nll * m).sum()
    count = torch.clamp(m.sum(), min=1.0)
    ce = total / count
    metrics = {"loss": ce, "tokens": count,
               "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}
    return ce, metrics


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs/token (fwd+bwd = 6*N_active +
    attention). For MoE only top_k of n_experts FFNs touch a token."""
    n = cfg.num_params()
    if cfg.n_experts:
        n -= (3 * cfg.hidden * cfg.ffn * cfg.n_layers
              * max(cfg.n_experts - cfg.moe_top_k, 0))
    attn = 12 * cfg.n_layers * cfg.hidden * seq_len  # causal attn matmuls
    return 6.0 * n + attn
