"""Trajectory postprocessing: GAE as a reverse loop over time.

Counterpart of ``ray_tpu/rllib/core/postprocessing.py``, whose reverse
``lax.scan`` becomes a Python loop over T on ``[T, B]`` tensors (of any
device; the loop holds no host sync).
"""

from __future__ import annotations

import torch


@torch.no_grad()
def compute_gae(rewards, values, dones, final_values, *,
                gamma: float = 0.99, lam: float = 0.95):
    """rewards/values/dones: [T, B]; final_values: [B].
    Returns (advantages [T, B], value_targets [T, B]).

    Episode boundaries (dones) cut the bootstrap; auto-reset rollouts make
    this exact for terminations and the standard approximation for
    truncations.
    """
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], final_values[None]], dim=0)
    deltas = rewards + gamma * next_values * not_done - values
    adv = torch.zeros_like(final_values)
    out = []
    for t in reversed(range(deltas.shape[0])):
        adv = deltas[t] + gamma * lam * not_done[t] * adv
        out.append(adv)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values
