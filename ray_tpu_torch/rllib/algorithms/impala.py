"""IMPALA: V-trace off-policy correction.

Counterpart of ``ray_tpu/rllib/algorithms/impala.py`` (reference
parity: rllib/algorithms/impala/impala.py:599). V-trace (Espeholt et
al. 2018) is a reverse loop over time inside the loss. With the local
runner, each iteration samples after a weight sync
(``sample_async_next``), as the reference's local mode does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import Learner
from .algorithm import Algorithm, AlgorithmConfig


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, dones, final_value,
           *, gamma: float = 0.99, rho_bar: float = 1.0, c_bar: float = 1.0):
    """All inputs time-major [T, B] (final_value [B]). Returns
    (vs [T, B], pg_advantages [T, B]), outside the autograd graph."""
    not_done = 1.0 - dones.float()
    rho = torch.clamp(torch.exp(target_logp - behavior_logp), max=rho_bar)
    c = torch.clamp(torch.exp(target_logp - behavior_logp), max=c_bar)
    next_values = torch.cat([values[1:], final_value[None]], dim=0)
    deltas = rho * (rewards + gamma * next_values * not_done - values)
    acc = torch.zeros_like(final_value)
    out = []
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + gamma * not_done[t] * c[t] * acc
        out.append(acc)
    vs = torch.stack(out[::-1]) + values
    next_vs = torch.cat([vs[1:], final_value[None]], dim=0)
    pg_adv = rho * (rewards + gamma * next_vs * not_done - values)
    return vs, pg_adv


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(IMPALA)
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rho_bar = 1.0
        self.c_bar = 1.0
        self.num_epochs = 1          # each batch consumed once
        self.minibatch_size = 10 ** 9  # full batch


def _tm(a):
    return a.transpose(0, 1)        # [b, T, ...] -> [T, b, ...]


class IMPALALearner(Learner):
    """Minibatches are env-major [b, T, ...]; the loss transposes to
    time-major and runs the vtrace loop."""

    def __init__(self, spec, config: IMPALAConfig, device=None):
        self._cfg = config
        super().__init__(spec, config.learner_hyperparams(),
                         config.module_class, config.model_config,
                         seed=config.seed,
                         device=config.device if device is None else device)

    def _targets(self, mb):
        cfg = self._cfg
        out = self.module.forward_train(_tm(mb["obs"]))
        inputs = out["action_dist_inputs"]
        target_logp = self.module.dist.log_prob(inputs, _tm(mb["actions"]))
        behavior_logp = _tm(mb["logp"])
        vs, pg_adv = vtrace(
            behavior_logp, target_logp.detach(), _tm(mb["rewards"]),
            out["vf"].detach(), _tm(mb["dones"]), mb["final_vf"],
            gamma=cfg.gamma, rho_bar=cfg.rho_bar, c_bar=cfg.c_bar)
        return out, inputs, target_logp, behavior_logp, vs, pg_adv

    def compute_loss(self, mb):
        cfg = self._cfg
        out, inputs, target_logp, _, vs, pg_adv = self._targets(mb)
        policy_loss = -torch.mean(pg_adv * target_logp)
        vf_loss = torch.mean((out["vf"] - vs) ** 2)
        entropy = torch.mean(self.module.dist.entropy(inputs))
        loss = (policy_loss + cfg.vf_loss_coeff * vf_loss
                - cfg.entropy_coeff * entropy)
        return loss, {"total_loss": loss, "policy_loss": policy_loss,
                      "vf_loss": vf_loss, "entropy": entropy}


def _to_env_major(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in batch.items():
        out[k] = v if k in ("final_vf", "final_obs") \
            else np.swapaxes(v, 0, 1)
    return out


class IMPALA(Algorithm):
    @classmethod
    def default_config(cls) -> IMPALAConfig:
        return IMPALAConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> IMPALALearner:
        return IMPALALearner(spec, config, device)

    def training_step(self) -> Dict[str, Any]:
        result = self.env_runner_group.sample_async_next(
            self.learner_group.get_weights())
        train_batch = _to_env_major(result["batch"])
        learner_metrics = self.learner_group.update(train_batch)
        return self._roll_metrics(result["stats"], learner_metrics)
