"""MultiRLModule: a dict of RLModules keyed by module id.

Counterpart of ``ray_tpu/rllib/core/multi_rl_module.py`` (reference
parity: rllib/core/rl_module/multi_rl_module.py: sub-RLModules,
get_module / add_module, weights per module). The port's modules own
their parameters, so the per-module ``forward_*`` take no params dict;
weights move as ``{module_id: {name: tensor}}``.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, Optional

import torch

from .rl_module import RLModule, build_module


class MultiRLModule:
    """Container of per-policy modules."""

    def __init__(self, modules: Dict[str, RLModule]):
        self._modules = dict(modules)

    @classmethod
    def from_specs(cls, specs: Dict[str, Any],
                   module_classes: Optional[Dict[str, type]] = None,
                   model_configs: Optional[Dict[str, dict]] = None
                   ) -> "MultiRLModule":
        module_classes = module_classes or {}
        model_configs = model_configs or {}
        return cls({
            mid: build_module(spec, module_classes.get(mid),
                              model_configs.get(mid))
            for mid, spec in specs.items()})

    @property
    def module_ids(self):
        return tuple(self._modules)

    def get_module(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def __getitem__(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def __contains__(self, module_id: str) -> bool:
        return module_id in self._modules

    def add_module(self, module_id: str, module: RLModule) -> None:
        self._modules[module_id] = module

    @staticmethod
    def module_seed(seed: int, module_id: str) -> int:
        """Each module's own init seed: same-architecture policies must
        not start with the same weights."""
        return (seed * 1_000_003 + zlib.crc32(module_id.encode())) \
            % 2 ** 31

    def init_parameters(self, seed: int) -> "MultiRLModule":
        """Fresh parameters for every module, each from its own seed."""
        for mid, m in self._modules.items():
            m.init_parameters(self.module_seed(seed, mid))
        return self

    def to(self, device) -> "MultiRLModule":
        for m in self._modules.values():
            m.to(device)
        return self

    # per-module forward_*
    def forward_exploration(self, module_id: str, obs, key):
        return self._modules[module_id].forward_exploration(obs, key)

    def forward_inference(self, module_id: str, obs):
        return self._modules[module_id].forward_inference(obs)

    def forward_train(self, module_id: str, obs):
        return self._modules[module_id].forward_train(obs)

    def get_weights(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Detached copies of every module's parameters, by module id
        and name."""
        return {mid: {k: v.detach().clone()
                      for k, v in m.named_parameters()}
                for mid, m in self._modules.items()}

    @torch.no_grad()
    def set_weights(self, weights) -> None:
        """Copy `{module_id: {name: tensor or array}}` in place."""
        for mid, w in weights.items():
            params = dict(self._modules[mid].named_parameters())
            if sorted(params) != sorted(w):
                raise ValueError(f"weights of {mid!r} hold {sorted(w)}, "
                                 f"the module {sorted(params)}")
            for k, p in params.items():
                p.copy_(torch.as_tensor(w[k]))
