"""APPO: asynchronous PPO — IMPALA's architecture, PPO's loss.

Counterpart of ``ray_tpu/rllib/algorithms/appo.py`` (reference parity:
rllib/algorithms/appo/appo.py): a clipped-surrogate policy loss over
V-trace advantages instead of IMPALA's plain importance-weighted one;
sampling is IMPALA's.
"""

from __future__ import annotations

import torch

from .impala import IMPALA, IMPALAConfig, IMPALALearner


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.clip_param = 0.2         # PPO surrogate clip (reference: 0.4
        #                               default for APPO; 0.2 matches PPO)
        self.num_epochs = 1           # async: each batch consumed once


class APPOLearner(IMPALALearner):
    """PPO clipped surrogate over V-trace targets; minibatches are
    env-major [b, T, ...] like IMPALA's."""

    def compute_loss(self, mb):
        cfg = self._cfg
        out, inputs, target_logp, behavior_logp, vs, pg_adv = \
            self._targets(mb)
        adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(correction=0) + 1e-8)
        ratio = torch.exp(target_logp - behavior_logp)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_param,
                              1.0 + cfg.clip_param)
        policy_loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
        vf_loss = torch.mean((out["vf"] - vs) ** 2)
        entropy = torch.mean(self.module.dist.entropy(inputs))
        loss = (policy_loss + cfg.vf_loss_coeff * vf_loss
                - cfg.entropy_coeff * entropy)
        return loss, {"total_loss": loss, "policy_loss": policy_loss,
                      "vf_loss": vf_loss, "entropy": entropy,
                      "clip_fraction": torch.mean(
                          ((ratio - 1.0).abs() > cfg.clip_param).float())}


class APPO(IMPALA):
    @classmethod
    def default_config(cls) -> APPOConfig:
        return APPOConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> APPOLearner:
        return APPOLearner(spec, config, device)
