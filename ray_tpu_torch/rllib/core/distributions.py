"""Action distributions over PyTorch tensors.

Counterpart of ``ray_tpu/rllib/core/distributions.py``: stateless
namespaces over tensors, sampling JAX's own stream through the port's
threefry. A sample is split into its noise and its use, so a rollout
can draw a whole fragment's noise before its step loop:
``noise(key, shape)`` draws what ``sample`` would for inputs of
``shape`` (keys batch over leading axes of their own), and
``sample_with(inputs, noise)`` turns it into actions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops import threefry

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
_HALF_LOG_2PIE = 0.5 * math.log(2 * math.pi * math.e)


def _batched(key, n: int, shape, draw) -> torch.Tensor:
    """`n` draws a key, shaped key's shape + `shape`."""
    return draw(key, n).reshape(tuple(key[0].shape) + tuple(shape))


class Categorical:
    @staticmethod
    def noise(key, shape) -> torch.Tensor:
        """The Gumbel noise ``jax.random.categorical(key, logits)`` adds
        to logits of `shape` (one key covers the whole array)."""
        return _batched(key, math.prod(shape), shape, threefry.gumbel)

    @staticmethod
    def sample_with(logits, noise):
        return torch.argmax(noise + logits, dim=-1)

    @staticmethod
    def sample(logits, key):
        return threefry.categorical(key, logits)

    @staticmethod
    def log_prob(logits, actions):
        logp = F.log_softmax(logits, dim=-1)
        return logp.gather(-1, actions.long()[..., None])[..., 0]

    @staticmethod
    def entropy(logits):
        logp = F.log_softmax(logits, dim=-1)
        return -torch.sum(logp.exp() * logp, dim=-1)

    @staticmethod
    def kl(logits_p, logits_q):
        logp = F.log_softmax(logits_p, dim=-1)
        logq = F.log_softmax(logits_q, dim=-1)
        return torch.sum(logp.exp() * (logp - logq), dim=-1)

    @staticmethod
    def deterministic(logits):
        return torch.argmax(logits, dim=-1)


class DiagGaussian:
    """Parameterised by concat([mean, log_std], axis=-1)."""

    @staticmethod
    def split(params):
        mean, log_std = params.chunk(2, dim=-1)
        return mean, log_std.clamp(-20.0, 2.0)

    @staticmethod
    def noise(key, shape) -> torch.Tensor:
        """The standard normals ``sample`` scales, for params of `shape`
        (``jax.random.normal(key, mean.shape)``)."""
        shape = tuple(shape[:-1]) + (shape[-1] // 2,)
        return _batched(key, math.prod(shape), shape, threefry.normal)

    @staticmethod
    def sample_with(params, noise):
        mean, log_std = DiagGaussian.split(params)
        return mean + log_std.exp() * noise

    @staticmethod
    def sample(params, key):
        return DiagGaussian.sample_with(
            params, DiagGaussian.noise(key, params.shape))

    @staticmethod
    def log_prob(params, actions):
        mean, log_std = DiagGaussian.split(params)
        var = torch.exp(2 * log_std)
        return torch.sum(
            -0.5 * ((actions - mean) ** 2 / var)
            - log_std - _HALF_LOG_2PI, dim=-1)

    @staticmethod
    def entropy(params):
        _, log_std = DiagGaussian.split(params)
        return torch.sum(log_std + _HALF_LOG_2PIE, dim=-1)

    @staticmethod
    def kl(params_p, params_q):
        mp, lsp = DiagGaussian.split(params_p)
        mq, lsq = DiagGaussian.split(params_q)
        return torch.sum(
            lsq - lsp
            + (torch.exp(2 * lsp) + (mp - mq) ** 2) / (2 * torch.exp(2 * lsq))
            - 0.5, dim=-1)

    @staticmethod
    def deterministic(params):
        mean, _ = DiagGaussian.split(params)
        return mean


def for_spec(spec):
    """Pick the distribution class for an EnvSpec."""
    return Categorical if spec.discrete else DiagGaussian
