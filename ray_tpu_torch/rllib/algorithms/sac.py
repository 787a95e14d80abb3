"""SAC: soft actor-critic for continuous control.

Counterpart of ``ray_tpu/rllib/algorithms/sac.py`` (reference parity:
rllib/algorithms/sac/sac.py + sac_torch_learner: actor, twin-critic and
entropy-temperature losses; polyak-averaged target critics). One replay
update is ``_sac_step``: the critic and actor losses in one backward
over the module, the module's clipped Adam step, the temperature's Adam
step on ``log_alpha``, then the polyak refresh of the target module
from the new parameters — the JAX program's order — with no host sync;
``update`` reads its metrics back once.

The policy is a tanh-squashed diagonal Gaussian; alpha is auto-tuned
toward target entropy -action_dim. The squash's normals are JAX's
(``threefry.normal``), so one key gives the JAX action and log-prob.

Like DQN, num_learners > 1 is rejected (target critics live in learner
state).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import threefry
from ..core.distributions import _batched
from ..core.learner import Adam, Learner
from ..core.rl_module import RLModule
from ..utils.replay_buffers import ReplayBuffer
from .algorithm import Algorithm, AlgorithmConfig
from .dqn import _to_transitions

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0
_LOG_2PI = float(np.log(np.float32(2 * np.pi)))


class _SACNet(nn.Module):
    """Policy head + twin Q heads in one module, flax's layer names."""

    def __init__(self, obs_dim: int, hiddens: Sequence[int],
                 action_dim: int):
        super().__init__()
        self.heads = nn.ModuleDict()
        for name, n_in, out in (("pi", obs_dim, 2 * action_dim),
                                ("q1", obs_dim + action_dim, 1),
                                ("q2", obs_dim + action_dim, 1)):
            dims = (n_in,) + tuple(hiddens)
            self.heads[name] = nn.ModuleList(
                [nn.Linear(a, b) for a, b in zip(dims, dims[1:])]
                + [nn.Linear(dims[-1], out)])

    def flax_layers(self):
        out = []
        for name, layers in self.heads.items():
            for i, layer in enumerate(layers):
                tag = "out" if i == len(layers) - 1 else str(i)
                out.append((f"{name}_{tag}", layer, "lecun"))
        return out

    def mlp(self, name: str, x):
        layers = self.heads[name]
        for layer in layers[:-1]:
            x = F.relu(layer(x))
        return layers[-1](x)

    def pi(self, obs):
        return self.mlp("pi", obs)

    def q(self, obs, action):
        sa = torch.cat([obs, action], dim=-1)
        return self.mlp("q1", sa)[..., 0], self.mlp("q2", sa)[..., 0]

    def forward(self, obs, action):
        q1, q2 = self.q(obs, action)
        return self.pi(obs), q1, q2


def _squash_with(mean, log_std, eps):
    """A tanh-squashed gaussian action and its log-prob from standard
    normals `eps` (broadcast against mean)."""
    std = torch.exp(torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))
    pre = mean + std * eps
    action = torch.tanh(pre)
    logp = (-0.5 * (eps ** 2 + _LOG_2PI) - torch.log(std)).sum(-1)
    # tanh change of variables
    logp = logp - torch.log(1 - action ** 2 + 1e-6).sum(-1)
    return action, logp


def _squash(mean, log_std, key):
    """Sample a tanh-squashed gaussian action + its log-prob:
    ``jax.random.normal(key, mean.shape)`` through the port's threefry.
    Keys with a batch shape K draw K x mean.shape."""
    eps = _batched(key, math.prod(mean.shape), mean.shape, threefry.normal)
    return _squash_with(mean, log_std, eps)


class SACModule(RLModule):
    def __init__(self, spec, hiddens: Sequence[int] = (64, 64),
                 action_scale: float = 1.0):
        if spec.discrete:
            raise ValueError("SAC requires a continuous action space")
        super().__init__(spec)
        self.action_scale = float(action_scale)
        self._net = _SACNet(spec.obs_dim, hiddens, spec.action_dim)

    def flax_layers(self):
        return self._net.flax_layers()

    def pi_and_q(self, obs, action):
        return self._net(obs, action)

    def forward(self, obs):
        dummy = torch.zeros(obs.shape[:-1] + (self.spec.action_dim,),
                            dtype=obs.dtype, device=obs.device)
        q1, _ = self._net.q(obs, dummy)
        return {"action_dist_inputs": self._net.pi(obs), "vf": q1}

    def exploration_noise(self, key, batch: int):
        shape = (batch, self.spec.action_dim)
        return (_batched(key, math.prod(shape), shape, threefry.normal),)

    def explore_with(self, obs, noise):
        out = self(obs)
        mean, log_std = out["action_dist_inputs"].chunk(2, dim=-1)
        action, logp = _squash_with(mean, log_std, noise[0])
        return action * self.action_scale, logp, out["vf"]

    def forward_inference(self, obs):
        mean, _ = self._net.pi(obs).chunk(2, dim=-1)
        return torch.tanh(mean) * self.action_scale


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(SAC)
        self.lr = 3e-4
        self.buffer_size = 100_000
        self.train_batch_size = 256
        self.num_updates_per_iter = 8
        self.tau = 0.005                     # polyak for target critics
        self.initial_alpha = 0.2
        self.target_entropy = None           # default: -action_dim
        self.num_steps_before_learning = 1_000
        self.action_scale = 1.0


class SACLearner(Learner):
    def __init__(self, spec, config: SACConfig, device=None):
        self._gamma = config.gamma
        self._tau = config.tau
        self._target_entropy = (config.target_entropy
                                if config.target_entropy is not None
                                else -float(spec.action_dim))
        if config.module_class is None:
            config.module_class = SACModule
            config.model_config = dict(
                config.model_config, action_scale=config.action_scale)
        super().__init__(spec, config.learner_hyperparams(),
                         config.module_class, config.model_config,
                         seed=config.seed,
                         device=config.device if device is None else device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self.log_alpha = torch.tensor(
            float(np.float32(np.log(config.initial_alpha))),
            dtype=torch.float32, device=self.device).requires_grad_(True)
        # optax.adam(lr): no clip, eps 1e-8
        self._alpha_opt = Adam(config.lr, math.inf, eps=1e-8)
        self._alpha_opt_state = self._alpha_opt.init([self.log_alpha])
        self._key = threefry.prng_key(
            torch.tensor(config.seed + 1, device=self.device))
        self._penalty = self._make_critic_penalty()

    def _make_critic_penalty(self):
        """Hook: extra critic regularizer (batch, key, alpha) ->
        (penalty, aux dict). CQL overrides; plain SAC has none."""
        return None

    def _sac_step(self, batch: Dict[str, torch.Tensor], key):
        """One update on device tensors: the JAX ``sac_update``'s order,
        no host sync; returns its metrics as 0-d tensors."""
        module, target = self.module, self.target
        ks = threefry.split(key, 3)
        k1, k2, k3 = ((ks[0][..., i], ks[1][..., i]) for i in range(3))
        alpha = self.log_alpha.detach().exp()
        # --- critic + actor losses share one backward over the module
        with torch.no_grad():
            mean_n, log_std_n = target._net.pi(batch["next_obs"]).chunk(
                2, dim=-1)
            a_next, logp_next = _squash(mean_n, log_std_n, k1)
            tq1, tq2 = target._net.q(batch["next_obs"], a_next)
            v_next = torch.minimum(tq1, tq2) - alpha * logp_next
            tgt = batch["rewards"] + self._gamma * (
                1.0 - batch["dones"]) * v_next
        pi, q1, q2 = module.pi_and_q(batch["obs"], batch["actions"])
        critic_loss = (torch.mean((q1 - tgt) ** 2)
                       + torch.mean((q2 - tgt) ** 2))
        pen_aux: Dict[str, torch.Tensor] = {}
        if self._penalty is not None:
            penalty, pen_aux = self._penalty(batch, k3, alpha)
            critic_loss = critic_loss + penalty
        mean, log_std = pi.chunk(2, dim=-1)
        a_pi, logp_pi = _squash(mean, log_std, k2)
        q1_pi, q2_pi = module._net.q(batch["obs"], a_pi)
        q_pi = torch.minimum(q1_pi, q2_pi)
        actor_loss = torch.mean(alpha * logp_pi - q_pi)
        grads = torch.autograd.grad(critic_loss + actor_loss, self.params)
        self.optimizer.step_(self.params, list(grads), self.opt_state)
        # --- temperature
        logp_sg = logp_pi.detach()
        alpha_loss = -torch.mean(self.log_alpha.exp()
                                 * (logp_sg + self._target_entropy))
        (a_grad,) = torch.autograd.grad(alpha_loss, [self.log_alpha])
        self._alpha_opt.step_([self.log_alpha], [a_grad],
                              self._alpha_opt_state)
        # --- polyak target critics, from the new parameters
        with torch.no_grad():
            tps = list(target.parameters())
            new = torch._foreach_add(
                torch._foreach_mul(tps, 1 - self._tau),
                torch._foreach_mul(self.params, self._tau))
            torch._foreach_copy_(tps, new)
        aux = {"critic_loss": critic_loss, "actor_loss": actor_loss,
               "alpha": self.log_alpha.exp(), "alpha_loss": alpha_loss,
               "q_mean": torch.mean(q_pi),
               "entropy": -torch.mean(logp_pi), **pen_aux}
        return {k: v.detach() for k, v in aux.items()}

    def _next_key(self):
        two = threefry.split(self._key)
        self._key = (two[0][..., 0], two[1][..., 0])
        return (two[0][..., 1], two[1][..., 1])

    def update(self, train_batch: Dict[str, Any]) -> Dict[str, float]:
        aux = self._sac_step(self._to_device(train_batch), self._next_key())
        keys = list(aux)
        return dict(zip(keys, torch.stack([aux[k] for k in keys])
                        .cpu().tolist()))

    def get_state(self):
        state = super().get_state()
        state["target_params"] = {
            k: v.detach().cpu().numpy()
            for k, v in self.target.named_parameters()}
        state["log_alpha"] = self.log_alpha.item()
        return state

    @torch.no_grad()
    def set_state(self, state) -> None:
        super().set_state(state)
        src = state.get("target_params", state["params"])
        for k, t in self.target.named_parameters():
            t.copy_(torch.as_tensor(np.asarray(src[k])))
        if "log_alpha" in state:
            self.log_alpha.fill_(float(state["log_alpha"]))


class SAC(Algorithm):
    @classmethod
    def default_config(cls) -> SACConfig:
        return SACConfig()

    @classmethod
    def build_learner(cls, spec, config, device=None) -> SACLearner:
        return SACLearner(spec, config, device)

    def setup(self, config: Dict[str, Any]) -> None:
        algo_cfg = config.get("_algo_config")
        if algo_cfg is None:
            algo_cfg = type(self).default_config().update_from_dict(config)
        if algo_cfg.num_learners > 1:
            raise ValueError("SAC supports num_learners <= 1 (target "
                             "critics live in learner state)")
        if algo_cfg.module_class is None:
            algo_cfg.module_class = SACModule
            algo_cfg.model_config = dict(
                algo_cfg.model_config,
                action_scale=algo_cfg.action_scale)
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
