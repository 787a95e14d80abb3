"""CQL: conservative Q-learning for offline RL (Kumar et al. 2020).

Counterpart of ``ray_tpu/rllib/algorithms/cql.py`` (reference parity:
rllib/algorithms/cql/cql.py + cql_torch_learner): SAC's machinery
trained purely from a recorded dataset, with the CQL(H) conservative
penalty on the critics — push down the Q of out-of-distribution actions
(logsumexp over sampled random + policy actions, importance-corrected)
and push up the Q of dataset actions — through SACLearner's
critic-penalty hook, inside the same update.

Dataset shards are OfflineData .npz transitions and must carry
obs/actions/rewards/next_obs/dones.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ...ops import threefry
from ..offline import OfflineData
from .sac import SAC, SACConfig, SACLearner, _squash


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.input_path = None
        self.cql_alpha = 1.0          # penalty weight (reference default 1.0)
        self.cql_n_actions = 4        # sampled actions per logsumexp term

    def offline_data(self, *, input_path: str) -> "CQLConfig":
        self.input_path = input_path
        return self


class CQLLearner(SACLearner):
    def __init__(self, spec, config: CQLConfig, device=None):
        self._cql_alpha = config.cql_alpha
        self._cql_n = config.cql_n_actions
        super().__init__(spec, config, device)

    def _make_critic_penalty(self):
        module = self.module
        n, weight = self._cql_n, self._cql_alpha
        action_dim = self.module.spec.action_dim
        scale = getattr(module, "action_scale", 1.0)
        # uniform density over the action box, as float32
        logp_rand = float(-action_dim * np.log(np.float32(2.0 * scale)))

        def penalty(batch, key, alpha):
            del alpha
            obs = batch["obs"]
            bsz = obs.shape[0]
            two = threefry.split(key)
            kr, kp = (two[0][..., 0], two[1][..., 0]), \
                (two[0][..., 1], two[1][..., 1])
            # random actions, uniform over the action box
            a_rand = threefry.uniform(kr, n * bsz * action_dim, -scale,
                                      scale).reshape(n, bsz, action_dim)
            # current-policy actions at obs, one key each of n draws
            pi, _, _ = module.pi_and_q(obs, batch["actions"])
            mean, log_std = pi.chunk(2, dim=-1)
            a_pi, logp_pi = _squash(mean, log_std, threefry.split(kp, n))
            obs_n = obs.expand((n,) + tuple(obs.shape))
            q1_rand, q2_rand = module._net.q(obs_n, a_rand)       # [n, B]
            q1_pi, q2_pi = module._net.q(obs_n, a_pi * scale)

            def lse(q_rand, q_pi_):
                cat = torch.cat([q_rand - logp_rand, q_pi_ - logp_pi], 0)
                return torch.logsumexp(cat, dim=0) - math.log(2.0 * n)

            _, q1_data, q2_data = module.pi_and_q(obs, batch["actions"])
            gap = (torch.mean(lse(q1_rand, q1_pi) - q1_data)
                   + torch.mean(lse(q2_rand, q2_pi) - q2_data))
            return weight * gap, {"cql_penalty": weight * gap}

        return penalty


class CQL(SAC):
    @classmethod
    def default_config(cls) -> CQLConfig:
        return CQLConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> CQLLearner:
        return CQLLearner(spec, config, device)

    def setup(self, config: Dict[str, Any]) -> None:
        super().setup(config)
        cfg = self._config
        if not getattr(cfg, "input_path", None):
            raise ValueError("CQL requires .offline_data(input_path=...)")
        self.offline = OfflineData(cfg.input_path, seed=cfg.seed)
        if "next_obs" not in self.offline.data:
            raise ValueError(
                "CQL shards need next_obs (record transition tuples, "
                "not policy-only batches)")

    def training_step(self) -> Dict[str, Any]:
        cfg = self._config
        learner_metrics: Dict[str, float] = {}
        for _ in range(cfg.num_updates_per_iter):
            learner_metrics = self.learner_group.update(
                self.offline.sample(cfg.train_batch_size))
        # evaluation rollout with the learned policy
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self.env_runner_group.sample()
        return self._roll_metrics(result["stats"], learner_metrics)
