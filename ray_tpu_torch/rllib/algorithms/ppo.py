"""PPO: clipped-surrogate policy optimization.

Counterpart of ``ray_tpu/rllib/algorithms/ppo.py`` (reference parity:
rllib/algorithms/ppo/ppo.py:388 training_step, the ppo_torch_learner
loss).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .. import connectors
from ..core.learner import Learner
from .algorithm import Algorithm, AlgorithmConfig


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PPO)
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.normalize_advantages = True


class PPOLearner(Learner):
    def __init__(self, spec, config: PPOConfig, device=None):
        self._clip = config.clip_param
        self._vf_coeff = config.vf_loss_coeff
        self._ent_coeff = config.entropy_coeff
        super().__init__(spec, config.learner_hyperparams(),
                         config.module_class, config.model_config,
                         seed=config.seed,
                         device=config.device if device is None else device)

    def compute_loss(self, mb):
        out = self.module.forward_train(mb["obs"])
        dist = self.module.dist
        inputs = out["action_dist_inputs"]
        logp = dist.log_prob(inputs, mb["actions"])
        ratio = torch.exp(logp - mb["logp"])
        adv = mb["advantages"]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - self._clip, 1 + self._clip) * adv)
        policy_loss = -torch.mean(surr)
        vf_loss = torch.mean((out["vf"] - mb["value_targets"]) ** 2)
        entropy = torch.mean(dist.entropy(inputs))
        loss = (policy_loss + self._vf_coeff * vf_loss
                - self._ent_coeff * entropy)
        return loss, {
            "total_loss": loss, "policy_loss": policy_loss,
            "vf_loss": vf_loss, "entropy": entropy,
            "kl": torch.mean(mb["logp"] - logp),
        }


class PPO(Algorithm):
    @classmethod
    def default_config(cls) -> PPOConfig:
        return PPOConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> PPOLearner:
        return PPOLearner(spec, config, device)

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        cfg = self._config
        self._learner_pipeline = connectors.default_learner_pipeline(
            gamma=cfg.gamma, lam=cfg.lambda_,
            normalize_advantages=getattr(cfg, "normalize_advantages", True))

    def training_step(self) -> Dict[str, Any]:
        result = self.env_runner_group.sample()
        train_batch = self._learner_pipeline(result["batch"])
        learner_metrics = self.learner_group.update(train_batch)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return self._roll_metrics(result["stats"], learner_metrics)
