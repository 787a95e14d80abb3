"""Llama-family model configuration, parameters and shared modules.

PyTorch counterpart of ``ray_tpu/models/llama.py``: the same presets,
the same parameter tree (names, layers stacked on a leading axis,
``(in, out)`` matrix orientation), so one tree converts to the other
through numpy (``weights.params_from_numpy``). Training (``forward``,
``loss_fn``) is not part of this package yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


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
