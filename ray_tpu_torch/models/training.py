"""Train step for a Llama config on one device: params + AdamW state.

PyTorch counterpart of ``ray_tpu/models/training.py`` without the mesh:
one device, no FSDP/TP/SP/PP and no 1F1B schedule. ``default_optimizer``
reproduces the JAX package's optax chain

    clip_by_global_norm(grad_clip)
    adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), b1, b2,
          eps=1e-8, eps_root=0, weight_decay, mu_dtype)

as plain functions on tensors, updating parameters and moments in place
(where the JAX bundle donates its state). The learning rate is read at
the step count before the step, as optax's schedule is, so the first
step has lr 0 and leaves the parameters unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import llama
from .weights import train_params_from_numpy

ADAM_EPS = 1e-8     # optax.adamw's eps, outside the sqrt (its eps_root is 0)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm),
    as a 0-d float32 tensor on the tensors' device (no host sync)."""
    sq = [torch.linalg.vector_norm(t.float()).square() for t in tensors]
    return torch.stack(sq).sum().sqrt()


@dataclasses.dataclass(frozen=True)
class AdamW:
    """clip_by_global_norm + adamw with a warmup-cosine schedule (see the
    module docstring). ``mu_dtype`` stores the first moment in another
    dtype (the second stays float32); the step computes in float32."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    mu_dtype: Optional[torch.dtype] = None

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay) at
        `count`, with decay = max(total, warmup + 1), in float32."""
        f = np.float32
        peak, warm = f(self.learning_rate), self.warmup_steps
        decay = max(self.total_steps, warm + 1)
        if count < warm:
            frac = f(1) - f(min(max(count, 0), warm)) / f(warm)
            return float((f(0) - peak) * frac + peak)
        t = f(min(count - warm, decay - warm))
        cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * t / f(decay - warm)))
        return float(peak * cosine)

    def init(self, params) -> Dict[str, Any]:
        mu_dtype = self.mu_dtype
        return {
            "count": 0,
            "mu": _map(lambda p: torch.zeros_like(
                p, dtype=mu_dtype or p.dtype, requires_grad=False), params),
            "nu": _map(lambda p: torch.zeros_like(
                p, requires_grad=False), params),
        }

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], state: Dict[str, Any],
                params, grad_norm: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        """One step, in place on `params`, the moments and `grads` (which
        are clipped where they lie). `grads` follow ``_leaves(params)``'s
        order; `grad_norm` is their global norm if already computed.
        Returns the new state."""
        count = state["count"]
        lr = self.schedule(count)
        f = np.float32
        t = count + 1
        bc1 = float(f(1) - f(self.b1) ** f(t))
        bc2 = float(f(1) - f(self.b2) ** f(t))
        if grad_norm is None:
            grad_norm = global_norm(grads)
        # clip: g if norm < max_norm else (g / norm) * max_norm, no sync
        keep = grad_norm < self.grad_clip
        den = torch.where(keep, torch.ones_like(grad_norm), grad_norm)
        num = torch.where(keep, torch.ones_like(grad_norm),
                          torch.full_like(grad_norm, self.grad_clip))
        for p, g, mu, nu in zip(_leaves(params), grads,
                                _leaves(state["mu"]), _leaves(state["nu"])):
            g = g.float().div_(den).mul_(num)
            m = g * (1 - self.b1) + mu.float() * self.b1
            v = g.square().mul_(1 - self.b2).add_(nu * self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(ADAM_EPS))
            u.add_(p.float() * self.weight_decay)
            p.add_(u.to(p.dtype), alpha=-lr)
            mu.copy_(m)
            nu.copy_(v)
        return {"count": t, "mu": state["mu"], "nu": state["nu"]}


def default_optimizer(learning_rate=3e-4, weight_decay=0.1,
                      warmup_steps=100, total_steps=10000,
                      b1=0.9, b2=0.95, grad_clip=1.0,
                      mu_dtype=None) -> AdamW:
    """mu_dtype=torch.bfloat16 halves first-moment memory (the second
    moment stays float32)."""
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 warmup_steps=warmup_steps, total_steps=total_steps,
                 b1=b1, b2=b2, grad_clip=grad_clip, mu_dtype=mu_dtype)


def resolve_device(device) -> torch.device:
    """None means the card; without one that raises unless the caller
    asks for the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TrainStepBundle runs on CUDA and no CUDA "
                           "device is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


class TrainStepBundle:
    """Everything needed to train a Llama config on one device.

    State is ``(params, opt_state)``: params the JAX package's tree of
    float32 leaf tensors, opt_state ``AdamW.init``'s dict. ``step``
    updates it in place and returns it with metrics (loss, tokens,
    ppl_proxy, grad_norm: the norm of the unclipped grads), each a 0-d
    tensor on the device, so a step does not wait for the device."""

    def __init__(self, cfg: llama.LlamaConfig, device=None,
                 optimizer: Optional[AdamW] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = optimizer or default_optimizer()

    def _state(self, params):
        return params, self.optimizer.init(params)

    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = llama.init_params(self.cfg, gen, self.device)
        return self._state(_map(lambda p: p.requires_grad_(True), params))

    def state_from_numpy(self, params_tree):
        """State from a parameter tree of numpy arrays (the JAX
        package's, through ``jax.tree_util.tree_map(np.asarray, ..)``)."""
        return self._state(train_params_from_numpy(params_tree, self.cfg,
                                                   self.device))

    def step(self, state, tokens: torch.Tensor):
        params, opt_state = state
        leaves = _leaves(params)
        loss, metrics = llama.loss_fn(self.cfg, params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = global_norm(grads)
        opt_state = self.optimizer.update_(list(grads), opt_state, params,
                                           grad_norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return (params, opt_state), metrics

    @torch.no_grad()
    def eval_loss(self, state, tokens: torch.Tensor):
        return llama.loss_fn(self.cfg, state[0], tokens)[1]

    def shard_batch(self, tokens) -> torch.Tensor:
        """A copy of `tokens` on the device (one device: no sharding)."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(self.device, copy=True)
