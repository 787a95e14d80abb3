"""Batched multi-agent PyTorch environments.

Counterpart of ``ray_tpu/rllib/env/multi_agent_env.py`` (reference
parity: rllib/env/multi_agent_env.py:32, dict obs/action/reward spaces
keyed by agent id). As ``torch_env.py`` does for one agent, these act on
``[B]`` batches of envs on the device, and draw JAX's random stream
(``ops/threefry.py``): a rollout steps every agent of every env with a
few tensor ops.

Design as in the JAX package: simultaneous moves over a static agent
set (turn-based games mask), and an env-level ``done`` shared by all
agents.

Env protocol (batched):
  agents: tuple of agent-id strings (static)
  specs:  {agent_id: EnvSpec}
  reset(keys) -> (state, obs_dict)
  step(state, action_dict, keys) -> (state, obs_dict, reward_dict, done)
split, as in ``torch_env.py``, into ``reset_noise``/``reset_from`` and
``step_noise``/``step_from`` (None for an env whose step draws nothing),
so a rollout can draw its randomness before its step loop.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from .torch_env import CartPole, EnvSpec, _halves


class MultiAgentTorchEnv:
    """Base class; subclasses are stateless — state is in the tuple of
    tensors they return."""

    agents: Tuple[str, ...]
    specs: Dict[str, EnvSpec]

    def reset_noise(self, keys) -> torch.Tensor:
        raise NotImplementedError

    def reset_from(self, noise):
        raise NotImplementedError

    def step_noise(self, keys):
        return None

    def step_from(self, state, actions: Dict[str, torch.Tensor], noise):
        raise NotImplementedError

    def reset(self, keys):
        return self.reset_from(self.reset_noise(keys))

    def step(self, state, actions: Dict[str, torch.Tensor], keys):
        return self.step_from(state, actions, self.step_noise(keys))


# the JAX package's name for the base class
MultiAgentJaxEnv = MultiAgentTorchEnv


class DualCartPole(MultiAgentTorchEnv):
    """Two independent cart-poles, one per agent, in a shared episode.

    The episode ends when EITHER pole falls (or at truncation), so each
    agent's return depends on both policies. Physics are exactly
    torch_env.CartPole's.
    """

    def __init__(self, max_episode_steps: int = 200):
        self._cart = CartPole(max_episode_steps=max_episode_steps)
        self.max_episode_steps = max_episode_steps
        self.agents = ("cart_0", "cart_1")
        spec = EnvSpec(obs_dim=4, num_actions=2,
                       max_episode_steps=max_episode_steps)
        self.specs = {aid: spec for aid in self.agents}

    def reset_noise(self, keys):
        # k0, k1 = split(key): each cart's reset draw
        k0, k1 = _halves(keys)
        return torch.cat([self._cart.reset_noise(k0),
                          self._cart.reset_noise(k1)], dim=-1)

    def reset_from(self, noise):
        s0, s1 = noise[..., :4], noise[..., 4:]
        t = torch.zeros(noise.shape[:-1], dtype=torch.int32,
                        device=noise.device)
        return (s0, s1, t), {"cart_0": s0, "cart_1": s1}

    def step_from(self, state, actions, noise):
        s0, s1, t = state
        # the single cart's physics track their own clock: feed zero and
        # keep the joint clock here
        zero = torch.zeros_like(t)
        (s0n, _), obs0, _, d0 = self._cart.step_from(
            (s0, zero), actions["cart_0"], None)
        (s1n, _), obs1, _, d1 = self._cart.step_from(
            (s1, zero), actions["cart_1"], None)
        t2 = t + 1
        done = d0 | d1 | (t2 >= self.max_episode_steps)
        one = torch.ones(t.shape, device=t.device)
        return ((s0n, s1n, t2), {"cart_0": obs0, "cart_1": obs1},
                {"cart_0": one, "cart_1": one}, done)


class RockPaperScissors(MultiAgentTorchEnv):
    """Iterated rock-paper-scissors, zero-sum, two agents.

    Obs is the one-hot of the opponent's previous move (zeros on the
    first step); rewards sum to zero by construction.
    """

    def __init__(self, episode_len: int = 10):
        self.episode_len = episode_len
        self.agents = ("player_0", "player_1")
        spec = EnvSpec(obs_dim=3, num_actions=3,
                       max_episode_steps=episode_len)
        self.specs = {aid: spec for aid in self.agents}

    def reset_noise(self, keys):
        # the reset draws nothing: an empty draw carries the batch shape
        return torch.zeros(tuple(keys[0].shape) + (0,),
                           device=keys[0].device)

    def reset_from(self, noise):
        lead = tuple(noise.shape[:-1])
        state = torch.zeros(lead, dtype=torch.int32, device=noise.device)
        obs = torch.zeros(lead + (3,), device=noise.device)
        return state, {"player_0": obs, "player_1": obs}

    def step_from(self, state, actions, noise):
        a0, a1 = actions["player_0"].long(), actions["player_1"].long()
        # 0 beats 2, 1 beats 0, 2 beats 1 (rock/paper/scissors)
        win0 = ((a0 - a1) % 3) == 1
        win1 = ((a1 - a0) % 3) == 1
        r0 = torch.where(win0, 1.0, torch.where(win1, -1.0, 0.0))
        t2 = state + 1
        obs = {"player_0": F.one_hot(a1, 3).float(),
               "player_1": F.one_hot(a0, 3).float()}
        return t2, obs, {"player_0": r0, "player_1": -r0}, (
            t2 >= self.episode_len)


_MA_ENV_REGISTRY: Dict[str, Callable[[], MultiAgentTorchEnv]] = {
    "DualCartPole": DualCartPole,
    "RockPaperScissors": RockPaperScissors,
}


def register_multi_agent_env(name: str,
                             factory: Callable[[], MultiAgentTorchEnv]
                             ) -> None:
    _MA_ENV_REGISTRY[name] = factory


def make_multi_agent_env(name_or_env) -> MultiAgentTorchEnv:
    if isinstance(name_or_env, MultiAgentTorchEnv):
        return name_or_env
    if isinstance(name_or_env, str):
        if name_or_env not in _MA_ENV_REGISTRY:
            raise ValueError(
                f"unknown multi-agent env {name_or_env!r}; registered: "
                f"{sorted(_MA_ENV_REGISTRY)}")
        return _MA_ENV_REGISTRY[name_or_env]()
    if callable(name_or_env):
        return name_or_env()
    raise TypeError(f"cannot build multi-agent env from {name_or_env!r}")
