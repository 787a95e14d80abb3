"""Batched PyTorch environments.

Counterpart of ``ray_tpu/rllib/env/jax_env.py``. The JAX envs are
written per env and ``vmap``ped; these act on ``[B]`` batches by
construction, so a rollout step is a few tensor ops over all envs on
the device. The randomness is JAX's own stream: keys are the port's
threefry keys (``ops/threefry.py``), and each draw reproduces the JAX
env's ``jax.random`` call bit for bit.

Env protocol (batched gymnax style):
  reset(keys)                -> (state, obs)
  step(state, action, keys)  -> (state, obs, reward, done)

States are tuples of ``[B, ...]`` tensors. A rollout draws all of a
fragment's randomness before its step loop, so each draw is split from
its use: ``reset_noise(keys)`` / ``reset_from(noise)`` and
``step_noise(keys)`` / ``step_from(state, action, noise)`` (None for
an env whose step draws nothing). The noise functions take keys of any
batch shape and add one trailing axis.

Physics runs in float32 in the JAX envs' order of operations; XLA may
fuse a multiply-add the port rounds twice, so states can differ in the
last bit (``tests/test_torch_rllib_env.py`` states the bound).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ...ops import threefry
from ...ops.threefry import Key


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static description the module/connectors need."""
    obs_dim: int
    num_actions: int          # >0 -> discrete; 0 -> continuous
    action_dim: int = 0       # for continuous envs
    max_episode_steps: int = 500
    # pixel envs: the (H, W, C) the flat obs vector reshapes to — lets
    # conv modules recover the image without a side channel
    obs_shape: Tuple[int, ...] = ()

    @property
    def discrete(self) -> bool:
        return self.num_actions > 0


def stacked_spec(spec: "EnvSpec", framestack: int) -> "EnvSpec":
    """The spec a module sees under feature-wise frame stacking — ONE
    definition used by both the runner and the learner, so
    their module widths can never desynchronize."""
    if framestack <= 1:
        return spec
    return dataclasses.replace(spec, obs_dim=spec.obs_dim * framestack)


def _halves(keys: Key) -> Tuple[Key, Key]:
    """``k1, k2 = jax.random.split(key)`` over batched keys."""
    a, b = threefry.split(keys)
    return (a[..., 0], b[..., 0]), (a[..., 1], b[..., 1])


class TorchEnv:
    """Base class; subclasses are stateless — all state is in the tuple
    of tensors they return."""

    spec: EnvSpec

    def reset_noise(self, keys: Key) -> torch.Tensor:
        raise NotImplementedError

    def reset_from(self, noise: torch.Tensor):
        raise NotImplementedError

    def step_noise(self, keys: Key) -> Optional[torch.Tensor]:
        return None

    def step_from(self, state, action, noise):
        raise NotImplementedError

    def reset(self, keys: Key):
        return self.reset_from(self.reset_noise(keys))

    def step(self, state, action, keys: Key):
        return self.step_from(state, action, self.step_noise(keys))


class CartPole(TorchEnv):
    """Classic cart-pole balance, standard physics (Barto et al.).

    Matches gymnasium CartPole-v1 dynamics: force ±10 N, tau=0.02 s,
    terminate at |x|>2.4 or |theta|>12 deg, reward 1 per step.
    """

    def __init__(self, max_episode_steps: int = 500):
        self.spec = EnvSpec(obs_dim=4, num_actions=2,
                            max_episode_steps=max_episode_steps)

    def reset_noise(self, keys):
        return threefry.uniform(keys, 4, -0.05, 0.05)

    def reset_from(self, noise):
        t = torch.zeros(noise.shape[:-1], dtype=torch.int32,
                        device=noise.device)
        return (noise, t), noise

    def step_from(self, state, action, noise):
        s, t = state
        x, x_dot, theta, theta_dot = s.unbind(-1)
        force = torch.where(action == 1, 10.0, -10.0)
        costh, sinth = torch.cos(theta), torch.sin(theta)
        total_mass, polemass_length, length = 1.1, 0.05, 0.5
        temp = (force + polemass_length * theta_dot ** 2 * sinth) / total_mass
        theta_acc = (9.8 * sinth - costh * temp) / (
            length * (4.0 / 3.0 - 0.1 * costh ** 2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costh / total_mass
        tau = 0.02
        s2 = torch.stack([x + tau * x_dot, x_dot + tau * x_acc,
                          theta + tau * theta_dot,
                          theta_dot + tau * theta_acc], dim=-1)
        t2 = t + 1
        terminated = (s2[..., 0].abs() > 2.4) | (s2[..., 2].abs() > 0.2095)
        truncated = t2 >= self.spec.max_episode_steps
        reward = torch.ones_like(x)
        return (s2, t2), s2, reward, terminated | truncated


def _remainder(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.remainder`` (numpy's ``%``): the truncated remainder
    (``fmod``) moved into the divisor's sign. ``torch.remainder``
    computes ``x - floor(x / y) * y`` instead, which rounds apart."""
    r = torch.fmod(x, y)
    move = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(move, r + y, r)


class Pendulum(TorchEnv):
    """Torque-controlled pendulum swing-up (continuous actions)."""

    def __init__(self, max_episode_steps: int = 200):
        self.spec = EnvSpec(obs_dim=3, num_actions=0, action_dim=1,
                            max_episode_steps=max_episode_steps)

    def reset_noise(self, keys):
        k1, k2 = _halves(keys)
        theta = threefry.uniform(k1, 1, -math.pi, math.pi)
        theta_dot = threefry.uniform(k2, 1, -1.0, 1.0)
        return torch.cat([theta, theta_dot], dim=-1)

    def reset_from(self, noise):
        t = torch.zeros(noise.shape[:-1], dtype=torch.int32,
                        device=noise.device)
        return (noise, t), self._obs(noise)

    @staticmethod
    def _obs(s):
        return torch.stack([torch.cos(s[..., 0]), torch.sin(s[..., 0]),
                            s[..., 1]], dim=-1)

    def step_from(self, state, action, noise):
        s, t = state
        theta, theta_dot = s.unbind(-1)
        u = action[..., 0].clamp(-2.0, 2.0)
        norm_th = _remainder(theta + math.pi, 2 * math.pi) - math.pi
        cost = norm_th ** 2 + 0.1 * theta_dot ** 2 + 0.001 * u ** 2
        theta_dot2 = (theta_dot + (3 * 9.81 / 2 * torch.sin(theta)
                                   + 3.0 * u) * 0.05).clamp(-8.0, 8.0)
        theta2 = theta + theta_dot2 * 0.05
        t2 = t + 1
        done = t2 >= self.spec.max_episode_steps
        s2 = torch.stack([theta2, theta_dot2], dim=-1)
        return (s2, t2), self._obs(s2), -cost, done


class CatchPixels(TorchEnv):
    """Pixel-observation catch game: a ball falls one row per step on a
    HxW grid; a 3-px paddle on the bottom row moves left/stay/right;
    catching scores +1, missing -1, the ball respawns. Observations are
    the raw pixels (ball 1.0, paddle 0.5) flattened — solvable only by
    reading the image, which gates the CNN module and the frame
    pipeline end to end.

    Random play expects about -4 per 8-drop episode; the committed
    regression target is +4 (>=75% catch rate)."""

    H, W = 10, 12
    PAD = 1            # paddle half-width

    def __init__(self, max_episode_steps: int = 80):
        self.spec = EnvSpec(obs_dim=self.H * self.W, num_actions=3,
                            max_episode_steps=max_episode_steps,
                            obs_shape=(self.H, self.W, 1))

    def _render(self, ball_r, ball_c, pad_c):
        dev = ball_r.device
        rows = torch.arange(self.H, device=dev)[:, None]
        cols = torch.arange(self.W, device=dev)
        ball = ((rows == ball_r[..., None, None])
                & (cols == ball_c[..., None, None]))
        paddle = ((rows == self.H - 1)
                  & ((cols - pad_c[..., None, None]).abs() <= self.PAD))
        grid = ball.float() + 0.5 * paddle.float()
        return grid.clamp(0.0, 1.0).flatten(-2)

    def reset_noise(self, keys):
        k1, k2 = _halves(keys)
        return torch.cat([threefry.randint(k1, 1, 0, self.W),
                          threefry.randint(k2, 1, self.PAD,
                                           self.W - self.PAD)], dim=-1)

    def reset_from(self, noise):
        ball_c, pad_c = noise.unbind(-1)
        zero = torch.zeros_like(ball_c)
        state = (zero, ball_c, pad_c, zero)
        return state, self._render(zero, ball_c, pad_c)

    def step_noise(self, keys):
        return threefry.randint(keys, 1, 0, self.W)[..., 0]

    def step_from(self, state, action, noise):
        ball_r, ball_c, pad_c, t = state
        pad_c = (pad_c + (action.long() - 1)).clamp(
            self.PAD, self.W - 1 - self.PAD)
        ball_r = ball_r + 1
        at_bottom = ball_r >= self.H - 1
        caught = (ball_c - pad_c).abs() <= self.PAD
        reward = torch.where(at_bottom, torch.where(caught, 1.0, -1.0), 0.0)
        ball_r = torch.where(at_bottom, 0, ball_r)
        ball_c = torch.where(at_bottom, noise, ball_c)
        t2 = t + 1
        done = t2 >= self.spec.max_episode_steps
        s2 = (ball_r, ball_c, pad_c, t2)
        return s2, self._render(ball_r, ball_c, pad_c), reward, done


_ENV_REGISTRY: Dict[str, Callable[[], TorchEnv]] = {
    "CartPole-v1": CartPole,
    "CartPole": CartPole,
    "Pendulum-v1": Pendulum,
    "Pendulum": Pendulum,
    "CatchPixels-v0": CatchPixels,
    "CatchPixels": CatchPixels,
}


def register_env(name: str, factory: Callable[[], TorchEnv]) -> None:
    """Register a user env factory (reference: ray.tune.register_env)."""
    _ENV_REGISTRY[name] = factory


def make_env(name_or_env) -> TorchEnv:
    if isinstance(name_or_env, TorchEnv):
        return name_or_env
    if isinstance(name_or_env, str):
        if name_or_env not in _ENV_REGISTRY:
            raise ValueError(
                f"unknown env {name_or_env!r}; registered: "
                f"{sorted(_ENV_REGISTRY)}")
        return _ENV_REGISTRY[name_or_env]()
    if callable(name_or_env):
        return name_or_env()
    raise TypeError(f"cannot build env from {name_or_env!r}")
