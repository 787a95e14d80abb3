"""Parameter and KV-pool conversion from numpy trees.

The JAX package's parameter tree (``jax.tree_util.tree_map(np.asarray,
params)``) and this package's share names, stacking and orientation,
so conversion is a walk over the tree. Two layout choices for serving:

- Matrix weights are stored once in the model's compute dtype. The JAX
  forward casts them with ``.astype(dt)`` on every call
  (``llama_infer.py`` ``_layer_body``/``_proj``); casting once up
  front gives the same numbers, since the cast is elementwise and
  deterministic.
- ``lm_head`` stays float32: logits are ``f32 @ f32`` there.
- Norm weights stay in their storage dtype (``rms_norm`` upcasts them
  to float32 itself); ``embed`` is cast to the compute dtype, as the
  JAX forward does before its row gather.

Training (``train_params_from_numpy``) keeps every leaf in the storage
dtype instead: the optimizer updates float32 parameters, and the
training forward casts them at each use, as the JAX one does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .llama import LlamaConfig

_MATMULS = ("wq", "wk", "wv", "wo", "wi", "wg", "wd", "router")


def _host(a) -> torch.Tensor:
    """numpy (or tensor) -> CPU tensor; numpy has no native bfloat16, so
    an ml_dtypes bfloat16 array goes through float32 (exact)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)          # a copy: the array may be read-only


def _to(a, dtype, device) -> torch.Tensor:
    return _host(a).to(device=device, dtype=dtype).contiguous()


def params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig,
                      device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter tree, as numpy arrays (or this
    package's own tree of tensors), -> the serving tree above on
    `device`. Tensors already in that layout on `device` are shared,
    not copied."""
    dt = cfg.dtype
    device = torch.device(device)
    layers = {}
    for name, w in tree["layers"].items():
        if name in _MATMULS:
            layers[name] = _to(w, dt, device)
        else:
            layers[name] = _to(w, cfg.param_dtype, device)
    return {
        "embed": _to(tree["embed"], dt, device),
        "layers": layers,
        "final_norm": _to(tree["final_norm"], cfg.param_dtype, device),
        "lm_head": _to(tree["lm_head"], torch.float32, device),
    }


def train_params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig,
                            device="cuda") -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy arrays, or tensors) -> the
    same tree of fresh leaf tensors on `device`, every leaf in
    ``cfg.param_dtype`` and requiring grad."""
    device = torch.device(device)

    def leaf(a):
        t = _host(a).to(device=device, dtype=cfg.param_dtype, copy=True)
        return t.contiguous().requires_grad_(True)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)
    return walk(tree)


def pools_from_numpy(k_pages, v_pages, dtype: Optional[torch.dtype] = None,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """KV pools ``[L, num_pages, page_size, KVH, D]`` as numpy arrays ->
    tensors on `device` (in `dtype`, default: as given)."""
    def one(a):
        t = _host(a)
        return t.to(device=device, dtype=dtype or t.dtype).contiguous()
    return one(k_pages), one(v_pages)
