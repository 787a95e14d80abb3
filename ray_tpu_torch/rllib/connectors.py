"""ConnectorV2 pipelines: env→module, module→env, learner.

Counterpart of ``ray_tpu/rllib/connectors.py``. A connector is a
callable batch transform; pipelines compose them. The rollout
(env_runner.py) carries the env/module connectors' hot work on the
device (the mean-std observation filter and frame stacking), so the
default pipelines here carry the learner-side transforms over the
runner's numpy batch: GAE, flatten time×env, advantage normalization.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .core.postprocessing import compute_gae


class ConnectorV2:
    def __call__(self, batch: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        raise NotImplementedError


class ConnectorPipelineV2(ConnectorV2):
    def __init__(self, connectors: Optional[List[ConnectorV2]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def __call__(self, batch, **kwargs):
        for c in self.connectors:
            batch = c(batch, **kwargs)
        return batch


class GeneralAdvantageEstimation(ConnectorV2):
    def __init__(self, gamma: float = 0.99, lam: float = 0.95):
        self.gamma, self.lam = gamma, lam

    def __call__(self, batch, **kwargs):
        t = {k: torch.as_tensor(np.asarray(batch[k]))
             for k in ("rewards", "vf", "dones", "final_vf")}
        adv, targets = compute_gae(
            t["rewards"], t["vf"], t["dones"], t["final_vf"],
            gamma=self.gamma, lam=self.lam)
        batch["advantages"] = adv.numpy()
        batch["value_targets"] = targets.numpy()
        return batch


class NormalizeAdvantages(ConnectorV2):
    def __call__(self, batch, **kwargs):
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        return batch


class FlattenTimeEnv(ConnectorV2):
    """[T, B, ...] → [T*B, ...] train batch (drops rollout-only keys)."""

    DROP = ("final_vf", "final_obs")

    def __call__(self, batch, **kwargs):
        out = {}
        for k, v in batch.items():
            if k in self.DROP:
                continue
            v = np.asarray(v)
            out[k] = v.reshape((-1,) + v.shape[2:])
        return out


def default_learner_pipeline(gamma: float = 0.99, lam: float = 0.95,
                             normalize_advantages: bool = True
                             ) -> ConnectorPipelineV2:
    pipe = ConnectorPipelineV2([GeneralAdvantageEstimation(gamma, lam),
                                FlattenTimeEnv()])
    if normalize_advantages:
        pipe.append(NormalizeAdvantages())
    return pipe
