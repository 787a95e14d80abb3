"""DQN: Q-learning with replay + target network (double-Q by default).

Counterpart of ``ray_tpu/rllib/algorithms/dqn.py`` (reference parity:
rllib/algorithms/dqn/dqn.py training_step: sample -> replay add -> N
replay updates -> periodic target sync; the dqn_rainbow_torch_learner
TD loss). The target network is a second module in learner state,
hard-synced every `target_network_update_freq` updates.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import threefry
from ..core.learner import Learner
from ..core.rl_module import RLModule
from ..utils.replay_buffers import ReplayBuffer
from .algorithm import Algorithm, AlgorithmConfig


class QModule(RLModule):
    """Q-network module with epsilon-greedy exploration (a static
    model_config knob, as in the reference port)."""

    def __init__(self, spec, hiddens: Sequence[int] = (64, 64),
                 epsilon: float = 0.1):
        if not spec.discrete:
            raise ValueError("DQN requires a discrete action space")
        super().__init__(spec)
        self.epsilon = float(epsilon)
        dims = (spec.obs_dim,) + tuple(hiddens)
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        self.out = nn.Linear(dims[-1], spec.num_actions)

    def flax_layers(self):
        layers = list(self.hidden) + [self.out]
        return [(f"Dense_{i}", m, "lecun") for i, m in enumerate(layers)]

    def q(self, obs):
        x = obs
        for layer in self.hidden:
            x = F.relu(layer(x))
        return self.out(x)

    def forward(self, obs):
        q = self.q(obs)
        return {"action_dist_inputs": q, "vf": q.max(dim=-1).values}

    def exploration_noise(self, key, batch: int):
        """``k1, k2 = split(key)``: a random action from ``randint(k1)``
        and the explore test's ``uniform(k2)``, per row."""
        a, b = threefry.split(key)
        k1, k2 = (a[..., 0], b[..., 0]), (a[..., 1], b[..., 1])
        return (threefry.randint(k1, batch, 0, self.spec.num_actions),
                threefry.uniform(k2, batch))

    def explore_with(self, obs, noise):
        random_a, u = noise
        q = self.q(obs)
        greedy = torch.argmax(q, dim=-1)
        action = torch.where(u < self.epsilon, random_a, greedy)
        # logp of the epsilon-greedy behavior policy (for the batch
        # shape; DQN's TD loss never reads it)
        n = self.spec.num_actions
        logp = torch.log(torch.where(
            action == greedy, 1 - self.epsilon + self.epsilon / n,
            self.epsilon / n))
        return action, logp, q.max(dim=-1).values


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(DQN)
        self.lr = 5e-4
        self.buffer_size = 50_000
        self.train_batch_size = 128
        self.num_updates_per_iter = 8
        self.target_network_update_freq = 100     # in learner updates
        self.num_steps_before_learning = 1_000
        self.double_q = True
        self.epsilon = 0.1


class DQNLearner(Learner):
    def __init__(self, spec, config: DQNConfig, device=None):
        self._gamma = config.gamma
        self._double_q = config.double_q
        self._target_freq = config.target_network_update_freq
        super().__init__(spec, config.learner_hyperparams(),
                         config.module_class, config.model_config,
                         seed=config.seed,
                         device=config.device if device is None else device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._updates = 0

    def compute_loss(self, batch):
        module, gamma = self.module, self._gamma
        q = module(batch["obs"])["action_dist_inputs"]
        q_sa = q.gather(-1, batch["actions"].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next_t = self.target(batch["next_obs"])["action_dist_inputs"]
            if self._double_q:
                a_star = torch.argmax(
                    module(batch["next_obs"])["action_dist_inputs"], dim=-1)
                v_next = q_next_t.gather(-1, a_star[:, None])[:, 0]
            else:
                v_next = q_next_t.max(dim=-1).values
            target = batch["rewards"] + gamma * (1.0 - batch["dones"]) \
                * v_next
        td = q_sa - target
        loss = torch.mean(td ** 2)
        return loss, {"total_loss": loss, "qf_mean": torch.mean(q_sa),
                      "td_error_abs": torch.mean(td.abs())}

    # replaces the on-policy epoch machinery
    def update(self, train_batch: Dict[str, Any]) -> Dict[str, float]:
        aux = self._apply(self._to_device(train_batch))
        self._updates += 1
        if self._updates % self._target_freq == 0:
            self._sync_target()
        keys = list(aux)
        return dict(zip(keys, torch.stack([aux[k] for k in keys])
                        .cpu().tolist()))

    @torch.no_grad()
    def _sync_target(self) -> None:
        for t, p in zip(self.target.parameters(), self.module.parameters()):
            t.copy_(p)

    def get_state(self):
        state = super().get_state()
        state["target_params"] = {
            k: v.detach().cpu().numpy()
            for k, v in self.target.named_parameters()}
        state["updates"] = self._updates
        return state

    @torch.no_grad()
    def set_state(self, state) -> None:
        super().set_state(state)
        src = state.get("target_params", state["params"])
        for k, t in self.target.named_parameters():
            t.copy_(torch.as_tensor(np.asarray(src[k])))
        self._updates = state.get("updates", 0)


def _to_transitions(batch: Dict[str, Any]) -> Dict[str, Any]:
    """[T, B, ...] rollout -> flat [T*B] transitions with next_obs."""
    obs, final_obs = batch["obs"], batch["final_obs"]
    next_obs = np.concatenate([obs[1:], final_obs[None]], axis=0)
    flat = lambda a: np.asarray(a).reshape((-1,) + np.asarray(a).shape[2:])
    return {
        "obs": flat(obs).astype(np.float32),
        "actions": flat(batch["actions"]),
        "rewards": flat(batch["rewards"]).astype(np.float32),
        "dones": flat(batch["dones"]).astype(np.float32),
        "next_obs": flat(next_obs).astype(np.float32),
    }


class DQN(Algorithm):
    @classmethod
    def default_config(cls) -> DQNConfig:
        return DQNConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> DQNLearner:
        return DQNLearner(spec, config, device)

    def setup(self, config: Dict[str, Any]) -> None:
        algo_cfg = config.get("_algo_config")
        if algo_cfg is None:
            algo_cfg = type(self).default_config().update_from_dict(config)
        if algo_cfg.num_learners > 1:
            raise ValueError("DQN supports num_learners <= 1 (the target "
                             "network lives in learner state)")
        if algo_cfg.module_class is None:
            algo_cfg.module_class = QModule
            algo_cfg.model_config = dict(algo_cfg.model_config,
                                         epsilon=algo_cfg.epsilon)
        super().setup({"_algo_config": algo_cfg})
        self.replay = ReplayBuffer(algo_cfg.buffer_size,
                                   seed=algo_cfg.seed)

    def training_step(self) -> Dict[str, Any]:
        cfg = self._config
        result = self.env_runner_group.sample()
        self.replay.add_batch(_to_transitions(result["batch"]))
        learner_metrics: Dict[str, float] = {}
        if len(self.replay) >= cfg.num_steps_before_learning:
            for _ in range(cfg.num_updates_per_iter):
                learner_metrics = self.learner_group.update(
                    self.replay.sample(cfg.train_batch_size))
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
        return self._roll_metrics(result["stats"], learner_metrics)
