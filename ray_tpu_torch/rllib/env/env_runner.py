"""EnvRunner: samples experience with a batched rollout on the device.

Counterpart of ``ray_tpu/rllib/env/env_runner.py``, whose rollout is one
jitted ``lax.scan``. Here a fragment is three stages, each a method:

1. ``_draw``: every random number of the fragment in a few batched
   threefry calls (the T x 3 step keys, the policy's noise, the reset
   draws and any random step draws), none of which depends on the
   trajectory. The keys split exactly as the JAX runner's do, so a
   fragment draws JAX's own stream.
2. ``_steps``: the step loop, policy forward, env physics, auto-reset,
   episode bookkeeping, frame stacking and the mean-std filter's raw
   moments, all device ops with ``torch.where`` selects: no host sync.
3. ``_finish``: one readback of the batch (the reference's
   ``jax.device_get``), the filter's moments folded on the host, the
   episode stats from the read-back arrays.

``sample()`` runs the three; the batch and ``stats`` keys are the JAX
runner's. A recurrent module (one with ``initial_state``, DreamerV3's)
threads its state through the step loop (``explore_with(obs, noise,
state)``), across fragments too, and a finished env's state restarts
from ``initial_state``, as in the JAX runner's scan.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...models.training import resolve_device
from ...ops import threefry
from ..core.rl_module import RLModule, build_module
from .torch_env import TorchEnv, make_env, stacked_spec


def merge_moments(a, b):
    """Chan parallel-Welford combine of two (count, mean, M2) states
    (the runner folds each fragment's moments in with it)."""
    ca, ma, sa = a
    cb, mb, sb = b
    if cb <= 0:
        return a
    if ca <= 0:
        return b
    delta = mb - ma
    tot = ca + cb
    mean = ma + delta * (cb / tot)
    m2 = sa + sb + delta * delta * (ca * cb / tot)
    return (tot, mean, m2)


def _key_at(key, i):
    return key[0][..., i], key[1][..., i]


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """numpy copies of device tensors through one synchronise: each
    copy is queued without waiting, then the stream is waited on once."""
    out = {k: v.to("cpu", non_blocking=True) for k, v in tensors.items()}
    if any(v.is_cuda for v in tensors.values()):
        torch.cuda.current_stream().synchronize()
    return {k: v.numpy() for k, v in out.items()}


class SingleAgentEnvRunner:
    """Owns a batched env + a module on `device`; sample() returns a
    numpy batch of shape [T, B, ...] plus episode stats. `device` None
    means the card (raises without one); the tests pass "cpu"."""

    def __init__(self, env, num_envs: int = 8, rollout_length: int = 128,
                 seed: int = 0, module_class: Optional[type] = None,
                 model_config: Optional[Dict[str, Any]] = None,
                 obs_filter: Optional[str] = None,
                 framestack: int = 1, device=None):
        self.device = resolve_device(device, "SingleAgentEnvRunner")
        self.env: TorchEnv = make_env(env)
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        # env->module frame stacking: the module sees the last N frames
        # concatenated feature-wise; the rolling buffer lives on the
        # device and refills with the reset obs when an episode ends.
        self.framestack = int(framestack)
        if self.framestack < 1:
            raise ValueError("framestack must be >= 1")
        self.module: RLModule = build_module(
            stacked_spec(self.env.spec, self.framestack),
            module_class, model_config).init_parameters(seed).to(
                self.device)
        key = threefry.prng_key(torch.tensor(seed, device=self.device))
        keys = threefry.split(key, 3)
        # (the JAX runner's init key has no use here: the module draws
        # its parameters from the seed's torch generator)
        self._key, reset_key = _key_at(keys, 0), _key_at(keys, 2)
        self._env_state, self._obs = self.env.reset(
            threefry.split(reset_key, num_envs))
        if self.framestack > 1:
            self._stack = self._obs[:, None].repeat(
                1, self.framestack, *([1] * (self._obs.dim() - 1)))
        # recurrent policies (world models) carry their state across
        # steps and fragments
        self._mstate = (self.module.initial_state(num_envs)
                        if hasattr(self.module, "initial_state") else None)
        self._ep_ret = torch.zeros(num_envs, device=self.device)
        self._ep_len = torch.zeros(num_envs, dtype=torch.int32,
                                   device=self.device)
        # env->module mean-std observation filter: (obs-mean)/std clipped
        # to ±10, applied before the policy and recorded as the batch's
        # obs; raw-obs sum/sumsq accumulate on the device and fold into
        # the running Welford state on the host after each sample().
        if obs_filter not in (None, "mean_std"):
            raise ValueError(f"unknown obs_filter {obs_filter!r}")
        self.obs_filter = obs_filter
        if obs_filter:
            shape = tuple(self._obs.shape[1:])
            self._filt_state = (0.0, np.zeros(shape, np.float64),
                                np.zeros(shape, np.float64))
            # moments since the last get_filter_delta (a remote group
            # merges only deltas across its runners)
            self._filt_delta = self._filt_state

    # -- the rollout --------------------------------------------------------
    def _draw(self) -> Dict[str, Any]:
        """Stage 1: the fragment's randomness, split from the runner's
        key as the JAX runner splits it (``key, sub = split(key)``; T x 3
        step keys from ``sub``: the policy's, the step's and the
        resets', each split into B per step), and the filter's
        statistics on the device."""
        B, T = self.num_envs, self.rollout_length
        two = threefry.split(self._key)
        self._key, sub = _key_at(two, 0), _key_at(two, 1)
        k1, k2 = threefry.split(sub, T * 3)
        steps = (k1.reshape(T, 3), k2.reshape(T, 3))
        act, step, reset = (_key_at(steps, j) for j in range(3))
        draws = {"act": self.module.exploration_noise(act, B),
                 "reset": self.env.reset_noise(threefry.split(reset, B)),
                 "step": self.env.step_noise(threefry.split(step, B))}
        if self.obs_filter:
            draws["fmean"] = torch.as_tensor(
                self._filt_state[1], dtype=torch.float32).to(self.device)
            draws["fstd"] = torch.as_tensor(self._filter_std()).to(
                self.device)
        return draws

    @torch.no_grad()
    def _steps(self, draws: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Stage 2: T steps of every env on the device, no host sync.
        Returns the fragment's [T, B, ...] tensors, the final value and
        obs, the raw-obs moments and the finished episodes' returns and
        lengths (the ``dones`` steps)."""
        env, module = self.env, self.module
        B, T, N = self.num_envs, self.rollout_length, self.framestack
        if self.obs_filter:
            fmean, fstd = draws["fmean"], draws["fstd"]

            def filt(x):
                # broadcasts over a (B, D) obs or a (B, N, D) stack
                return torch.clamp((x - fmean) / fstd, -10.0, 10.0)
        else:
            def filt(x):
                return x

        def sel(done, a, b):
            return torch.where(done.reshape((B,) + (1,) * (a.dim() - 1)),
                               a, b)
        state, obs = self._env_state, self._obs
        mstate = self._mstate
        stack = self._stack if N > 1 else None
        ep_ret, ep_len = self._ep_ret, self._ep_len
        fsum = torch.zeros(obs.shape[1:], device=self.device)
        fsq = torch.zeros(obs.shape[1:], device=self.device)
        keys = ("obs", "actions", "logp", "vf", "rewards", "dones",
                "finished_return", "finished_len")
        rec = {k: [] for k in keys}
        for t in range(T):
            net_in = filt(stack).reshape(B, -1) if N > 1 else filt(obs)
            noise_t = tuple(n[t] for n in draws["act"])
            if mstate is not None:
                action, logp, vf, mstate = module.explore_with(
                    net_in, noise_t, mstate)
            else:
                action, logp, vf = module.explore_with(net_in, noise_t)
            noise = draws["step"][t] if draws["step"] is not None else None
            next_state, next_obs, reward, done = env.step_from(
                state, action, noise)
            ep_ret = ep_ret + reward
            ep_len = ep_len + 1
            # auto-reset finished envs (fresh state, static shapes)
            reset_state, reset_obs = env.reset_from(draws["reset"][t])
            state = tuple(sel(done, r, s) for r, s in zip(reset_state,
                                                    next_state))
            next_obs = sel(done, reset_obs, next_obs)
            if N > 1:
                # slide the window; a finished episode refills the
                # whole buffer with its fresh reset obs
                rolled = torch.cat([stack[:, 1:], next_obs[:, None]], 1)
                stack = sel(done, next_obs[:, None].expand_as(stack),
                            rolled)
            for k, v in zip(keys, (
                    net_in, action.to(torch.int32)
                    if action.dtype == torch.int64 else action,
                    logp, vf, reward, done,
                    torch.where(done, ep_ret, 0.0),
                    torch.where(done, ep_len, 0))):
                rec[k].append(v)
            ep_ret = torch.where(done, 0.0, ep_ret)
            ep_len = torch.where(done, 0, ep_len)
            if mstate is not None:
                # done envs restart their recurrent state
                mstate = tuple(sel(done, f, m) for f, m in zip(
                    module.initial_state(B), mstate))
            if self.obs_filter:
                # raw-obs moments: two obs-shaped tensors leave the
                # device, not [T, B, obs]
                fsum = fsum + obs.sum(dim=0)
                fsq = fsq + (obs * obs).sum(dim=0)
            obs = next_obs
        self._env_state, self._obs = state, obs
        self._mstate = mstate
        self._ep_ret, self._ep_len = ep_ret, ep_len
        if N > 1:
            self._stack = stack
        final = filt(stack).reshape(B, -1) if N > 1 else filt(obs)
        batch = {k: torch.stack(v) for k, v in rec.items()}
        # the observation after the last step — off-policy algorithms
        # reconstruct next_obs[t] as obs[t+1] (+ this for t = T-1);
        # filtered/stacked like every obs the learner sees
        batch.update(final_vf=module(final)["vf"], final_obs=final,
                     filt_sum=fsum, filt_sumsq=fsq)
        return batch

    def _finish(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Stage 3: one readback, the filter fold, the episode stats."""
        batch = to_host(batch)
        fsum = batch.pop("filt_sum")
        fsq = batch.pop("filt_sumsq")
        if self.obs_filter:
            self._fold_filter_batch(fsum, fsq,
                                    self.num_envs * self.rollout_length)
        done_mask = batch.pop("dones")
        fin_ret = batch.pop("finished_return")
        fin_len = batch.pop("finished_len")
        n_done = int(done_mask.sum())
        stats = {
            "num_episodes": n_done,
            "episode_return_mean": float(fin_ret.sum() / max(n_done, 1)),
            "episode_len_mean": float(fin_len.sum() / max(n_done, 1)),
            "env_steps": self.num_envs * self.rollout_length,
        }
        batch["dones"] = done_mask
        return {"batch": batch, "stats": stats}

    # -- public API ---------------------------------------------------------
    def _filter_std(self) -> np.ndarray:
        count, _, m2 = self._filt_state
        if count < 1.0:
            # no data yet: identity scaling, NOT std->0 (which would
            # saturate the whole first rollout to ±10 sign patterns)
            return np.ones(m2.shape, np.float32)
        return np.sqrt(np.maximum(m2 / count, 1e-12)).astype(np.float32)

    def _fold_filter_batch(self, fsum: np.ndarray, fsq: np.ndarray,
                           n: int) -> None:
        """Fold one rollout's (sum, sumsq) into BOTH the running state
        and the since-last-sync delta."""
        fsum = fsum.astype(np.float64)
        mean = fsum / n
        m2 = np.maximum(fsq.astype(np.float64) - n * mean * mean, 0.0)
        batch = (float(n), mean, m2)
        self._filt_state = merge_moments(self._filt_state, batch)
        self._filt_delta = merge_moments(self._filt_delta, batch)

    def get_filter_state(self):
        if not self.obs_filter:
            return None
        c, m, s = self._filt_state
        return (c, m.copy(), s.copy())

    def set_filter_state(self, state) -> None:
        if not self.obs_filter or state is None:
            return
        self._filt_state = (float(state[0]),
                            np.asarray(state[1], np.float64).copy(),
                            np.asarray(state[2], np.float64).copy())

    def get_filter_delta(self):
        """Moments accumulated since the last call — the group's sync
        merges ONLY deltas, so history is never double-counted."""
        if not self.obs_filter:
            return None
        delta, self._filt_delta = self._filt_delta, (
            0.0, np.zeros_like(self._filt_delta[1]),
            np.zeros_like(self._filt_delta[2]))
        return delta

    def sample(self) -> Dict[str, Any]:
        return self._finish(self._steps(self._draw()))

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """A detached copy of the module's parameters, by name, on the
        runner's device."""
        return {k: v.detach().clone()
                for k, v in self.module.named_parameters()}

    @torch.no_grad()
    def set_weights(self, weights) -> None:
        """Copy `weights` (name -> tensor or array) into the module in
        place: tensor to tensor on the device, never through the host
        unless given host arrays."""
        params = dict(self.module.named_parameters())
        if sorted(params) != sorted(weights):
            raise ValueError(f"weights hold {sorted(weights)}, the module "
                             f"{sorted(params)}")
        for k, p in params.items():
            p.copy_(torch.as_tensor(weights[k]))

    def ping(self) -> bool:
        return True

    def device_info(self) -> Dict[str, Optional[str]]:
        """Where this runner samples: its device and the process's
        CUDA_VISIBLE_DEVICES (a remote runner reports its own)."""
        return device_info(self.device)


def device_info(device) -> Dict[str, Optional[str]]:
    return {"device": str(device),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}
