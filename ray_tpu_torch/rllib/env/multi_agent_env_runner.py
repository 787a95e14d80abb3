"""MultiAgentEnvRunner: batched multi-agent rollouts on the device.

Counterpart of ``ray_tpu/rllib/env/multi_agent_env_runner.py``
(reference parity: rllib/env/multi_agent_env_runner.py:67, sample over
a MultiAgentEnv with per-agent episodes and a policy-mapping fn). As
the single-agent runner does, a fragment is ``_draw`` (every key and
policy noise of the fragment, split as the JAX runner splits them:
agent i's keys are ``fold_in(act_key, i)``), ``_steps`` (the step loop
over every agent's policy and the joint env on the device, no host
sync) and ``_finish`` (one readback, the stats, the per-module
batches).

Policy mapping: evaluated once per agent at construction (self-play =
map every agent to the same module id), as in the JAX runner.

``MultiAgentEnvRunnerGroup`` holds the local runner, or N runner
actors of the port's runtime whose per-module batches it concatenates
along the env axis (the reference's remote group, :227-282).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch as rt

from ...models.training import resolve_device
from ...ops import threefry
from ..core.multi_rl_module import MultiRLModule
from .env_runner import _key_at, to_host
from .multi_agent_env import MultiAgentTorchEnv, make_multi_agent_env


def call_mapping_fn(fn: Callable, agent_id: str) -> str:
    """Evaluate a policy-mapping fn, tolerating the reference's 2-arg
    signature fn(agent_id, episode, **kw)."""
    try:
        return str(fn(agent_id))
    except TypeError:
        return str(fn(agent_id, None))


def derive_module_specs(env: MultiAgentTorchEnv, policy_mapping_fn: Callable
                        ) -> tuple:
    """(agent->module mapping, module->EnvSpec) for an env + mapping fn,
    validating that agents sharing a module share an EnvSpec."""
    mapping = {aid: call_mapping_fn(policy_mapping_fn, aid)
               for aid in env.agents}
    module_specs: Dict[str, Any] = {}
    for aid in env.agents:
        mid = mapping[aid]
        spec = env.specs[aid]
        if mid in module_specs and module_specs[mid] != spec:
            raise ValueError(
                f"agents mapped to module {mid!r} have different "
                f"EnvSpecs; use separate modules")
        module_specs[mid] = spec
    return mapping, module_specs


class MultiAgentEnvRunner:
    """Samples {module_id: [T, B_mod, ...]} batches from a multi-agent
    env. Streams of agents mapped to the same module are concatenated
    along the env axis, so each module's learner sees one batch.
    `device` None means the card (raises without one)."""

    def __init__(self, env, policy_mapping_fn: Callable[[str], str],
                 num_envs: int = 8, rollout_length: int = 128,
                 seed: int = 0,
                 module_classes: Optional[Dict[str, type]] = None,
                 model_configs: Optional[Dict[str, dict]] = None,
                 device=None):
        self.device = resolve_device(device, "MultiAgentEnvRunner")
        self.env: MultiAgentTorchEnv = make_multi_agent_env(env)
        self.agents = tuple(self.env.agents)
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.mapping, self.module_specs = derive_module_specs(
            self.env, policy_mapping_fn)
        self.multi_module = MultiRLModule.from_specs(
            self.module_specs, module_classes, model_configs
        ).init_parameters(seed).to(self.device)
        key = threefry.prng_key(torch.tensor(seed, device=self.device))
        keys = threefry.split(key, 3)
        # (the JAX runner's init key has no use here: the modules draw
        # their parameters from their seeds' torch generators)
        self._key, reset_key = _key_at(keys, 0), _key_at(keys, 2)
        self._env_state, self._obs = self.env.reset(
            threefry.split(reset_key, num_envs))
        self._ep_ret = {aid: torch.zeros(num_envs, device=self.device)
                        for aid in self.agents}
        self._ep_len = torch.zeros(num_envs, dtype=torch.int32,
                                   device=self.device)

    # -- the rollout --------------------------------------------------------
    def _draw(self) -> Dict[str, Any]:
        """The fragment's randomness: ``key, sub = split(key)``, T x 3
        step keys from ``sub`` (policy, step, reset), agent i's policy
        keys ``fold_in(act_key, i)``."""
        B, T = self.num_envs, self.rollout_length
        two = threefry.split(self._key)
        self._key, sub = _key_at(two, 0), _key_at(two, 1)
        k1, k2 = threefry.split(sub, T * 3)
        steps = (k1.reshape(T, 3), k2.reshape(T, 3))
        act, step, reset = (_key_at(steps, j) for j in range(3))
        noise = {}
        for i, aid in enumerate(self.agents):
            akey = threefry.fold_in(act, torch.full_like(act[0], i))
            noise[aid] = self.multi_module[
                self.mapping[aid]].exploration_noise(akey, B)
        return {"act": noise,
                "reset": self.env.reset_noise(threefry.split(reset, B)),
                "step": self.env.step_noise(threefry.split(step, B))}

    @torch.no_grad()
    def _steps(self, draws: Dict[str, Any]) -> Dict[str, Any]:
        """T joint steps of every env on the device, no host sync."""
        env, mm, agents = self.env, self.multi_module, self.agents
        B, T = self.num_envs, self.rollout_length

        def sel(done, a, b):
            return torch.where(done.reshape((B,) + (1,) * (a.dim() - 1)),
                               a, b)
        state, obs = self._env_state, self._obs
        ep_ret, ep_len = self._ep_ret, self._ep_len
        per_agent = ("obs", "actions", "logp", "vf", "rewards",
                     "finished_return")
        rec = {k: {aid: [] for aid in agents} for k in per_agent}
        dones, fin_len = [], []
        for t in range(T):
            actions = {}
            for aid in agents:
                a, lp, v = mm[self.mapping[aid]].explore_with(
                    obs[aid], tuple(n[t] for n in draws["act"][aid]))
                actions[aid] = a
                rec["obs"][aid].append(obs[aid])
                rec["actions"][aid].append(
                    a.to(torch.int32) if a.dtype == torch.int64 else a)
                rec["logp"][aid].append(lp)
                rec["vf"][aid].append(v)
            noise = draws["step"][t] if draws["step"] is not None else None
            next_state, next_obs, rewards, done = env.step_from(
                state, actions, noise)
            ep_len = ep_len + 1
            reset_state, reset_obs = env.reset_from(draws["reset"][t])
            state = tuple(sel(done, r, s)
                          for r, s in zip(reset_state, next_state)) \
                if isinstance(next_state, tuple) \
                else sel(done, reset_state, next_state)
            for aid in agents:
                ep_ret[aid] = ep_ret[aid] + rewards[aid]
                rec["rewards"][aid].append(rewards[aid])
                rec["finished_return"][aid].append(
                    torch.where(done, ep_ret[aid], 0.0))
                ep_ret[aid] = torch.where(done, 0.0, ep_ret[aid])
            dones.append(done)
            fin_len.append(torch.where(done, ep_len, 0))
            ep_len = torch.where(done, 0, ep_len)
            obs = {aid: sel(done, reset_obs[aid], next_obs[aid])
                   for aid in agents}
        self._env_state, self._obs = state, obs
        self._ep_ret, self._ep_len = ep_ret, ep_len
        out = {f"{k}/{aid}": torch.stack(v[aid])
               for k, v in rec.items() for aid in agents}
        for aid in agents:
            out[f"final_vf/{aid}"] = mm.forward_train(
                self.mapping[aid], obs[aid])["vf"]
            out[f"final_obs/{aid}"] = obs[aid]
        out["dones"] = torch.stack(dones)
        out["finished_len"] = torch.stack(fin_len)
        return out

    def _finish(self, out: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One readback, the stats, the per-module batches."""
        host = to_host(out)
        dones = host.pop("dones")                         # [T, B]
        fin_len = host.pop("finished_len")
        n_done = int(dones.sum())
        agent_returns = {
            aid: float(host[f"finished_return/{aid}"].sum()
                       / max(n_done, 1))
            for aid in self.agents}
        stats = {
            "num_episodes": n_done,
            "episode_len_mean": float(fin_len.sum() / max(n_done, 1)),
            "episode_return_mean": float(
                sum(agent_returns.values())),      # sum-of-agents return
            "agent_episode_returns": agent_returns,
            "env_steps": self.num_envs * self.rollout_length,
            "agent_steps": (self.num_envs * self.rollout_length
                            * len(self.agents)),
        }
        # regroup per-agent streams into per-module batches, concat along
        # the env axis ([T, B] -> [T, B * n_agents_of_module])
        per_module: Dict[str, Dict[str, np.ndarray]] = {}
        for mid in self.module_specs:
            aids = [a for a in self.agents if self.mapping[a] == mid]
            mb = {k: np.concatenate([host[f"{k}/{a}"] for a in aids],
                                    axis=1)
                  for k in ("obs", "actions", "logp", "vf", "rewards")}
            mb["dones"] = np.concatenate([dones] * len(aids), axis=1)
            for k in ("final_vf", "final_obs"):
                mb[k] = np.concatenate([host[f"{k}/{a}"] for a in aids],
                                       axis=0)
            per_module[mid] = mb
        return {"batches": per_module, "stats": stats}

    # -- public API ---------------------------------------------------------
    def sample(self) -> Dict[str, Any]:
        return self._finish(self._steps(self._draw()))

    def get_weights(self):
        return self.multi_module.get_weights()

    def set_weights(self, weights) -> None:
        self.multi_module.set_weights(weights)

    def ping(self) -> bool:
        return True


def _merge_ma(results: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge remote runners' results: concat per-module env axes,
    weight-average stats."""
    merged: Dict[str, Dict[str, np.ndarray]] = {}
    for mid in results[0]["batches"]:
        mb = {}
        for k in results[0]["batches"][mid]:
            axis = 0 if k in ("final_vf", "final_obs") else 1
            mb[k] = np.concatenate(
                [r["batches"][mid][k] for r in results], axis=axis)
        merged[mid] = mb
    n_eps = sum(r["stats"]["num_episodes"] for r in results)
    agents = list(results[0]["stats"]["agent_episode_returns"])
    agent_returns = {
        aid: sum(r["stats"]["agent_episode_returns"][aid]
                 * r["stats"]["num_episodes"] for r in results)
        / max(n_eps, 1)
        for aid in agents}
    stats = {
        "num_episodes": n_eps,
        "episode_len_mean": sum(
            r["stats"]["episode_len_mean"] * r["stats"]["num_episodes"]
            for r in results) / max(n_eps, 1),
        "episode_return_mean": float(sum(agent_returns.values())),
        "agent_episode_returns": agent_returns,
        "env_steps": sum(r["stats"]["env_steps"] for r in results),
        "agent_steps": sum(r["stats"]["agent_steps"] for r in results),
    }
    return {"batches": merged, "stats": stats}


class MultiAgentEnvRunnerGroup:
    """Local or remote fleet of MultiAgentEnvRunners (mirror of
    env_runner_group.EnvRunnerGroup for the multi-agent path); remote
    runners run on `device` in their own processes (None: the card)."""

    def __init__(self, env, policy_mapping_fn, num_env_runners: int = 0,
                 num_envs_per_runner: int = 8, rollout_length: int = 128,
                 seed: int = 0,
                 module_classes: Optional[Dict[str, type]] = None,
                 model_configs: Optional[Dict[str, dict]] = None,
                 runner_resources: Optional[Dict[str, float]] = None,
                 device=None):
        self.num_env_runners = num_env_runners
        # specs computed here (not via an actor round-trip): env + mapping
        # fully determine them
        self.mapping, self._module_specs = derive_module_specs(
            make_multi_agent_env(env), policy_mapping_fn)
        if num_env_runners == 0:
            self._local = MultiAgentEnvRunner(
                env, policy_mapping_fn, num_envs_per_runner,
                rollout_length, seed, module_classes, model_configs,
                device=device)
            self._remote = []
        else:
            self._local = None
            remote_cls = rt.remote(
                **(runner_resources or {"num_cpus": 1}))(MultiAgentEnvRunner)
            self._remote = [
                remote_cls.remote(env, policy_mapping_fn,
                                  num_envs_per_runner, rollout_length,
                                  seed + 1000 * (i + 1), module_classes,
                                  model_configs, device=device)
                for i in range(num_env_runners)]
            rt.get([r.ping.remote() for r in self._remote])

    def sample(self) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.sample()
        return _merge_ma(rt.get([r.sample.remote() for r in self._remote]))

    def sync_weights(self, weights_by_module) -> None:
        if self._local is not None:
            self._local.set_weights(weights_by_module)
            return
        ref = rt.put(weights_by_module)
        rt.get([r.set_weights.remote(ref) for r in self._remote])

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return rt.get(self._remote[0].get_weights.remote())

    @property
    def module_specs(self):
        return self._module_specs

    def stop(self) -> None:
        if not self._remote:
            return
        for r in self._remote:
            try:
                rt.kill(r)
            except Exception:
                pass
