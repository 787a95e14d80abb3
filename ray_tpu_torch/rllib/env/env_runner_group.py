"""EnvRunnerGroup: local or remote fleet of EnvRunners.

Counterpart of ``ray_tpu/rllib/env/env_runner_group.py`` (reference
parity: rllib/env/env_runner_group.py:71 and the synchronous sampling
helper rllib/execution/rollout_ops.py:20). With ``num_env_runners=0``
one SingleAgentEnvRunner samples in-process on the group's device;
otherwise N runner actors of the port's runtime sample in parallel, each
on `device` in its own process (None: the card), and the group gathers
their host batches. Weights reach the runners through one ``put``: a
CUDA tensor crosses the object store as host bytes, and each runner
copies it onto its own device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt

from .env_runner import SingleAgentEnvRunner, merge_moments


def _merge_batches(results: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate [T, B, ...] batches along the env axis; average stats."""
    batches = [r["batch"] for r in results]
    merged = {}
    for k in batches[0]:
        axis = 0 if k in ("final_vf", "final_obs") else 1
        merged[k] = np.concatenate([b[k] for b in batches], axis=axis)
    n_eps = sum(r["stats"]["num_episodes"] for r in results)
    ret_sum = sum(r["stats"]["episode_return_mean"]
                  * r["stats"]["num_episodes"] for r in results)
    len_sum = sum(r["stats"]["episode_len_mean"]
                  * r["stats"]["num_episodes"] for r in results)
    stats = {
        "num_episodes": n_eps,
        "episode_return_mean": ret_sum / max(n_eps, 1),
        "episode_len_mean": len_sum / max(n_eps, 1),
        "env_steps": sum(r["stats"]["env_steps"] for r in results),
    }
    return {"batch": merged, "stats": stats}


class EnvRunnerGroup:
    def __init__(self, env, num_env_runners: int = 0, num_envs_per_runner:
                 int = 8, rollout_length: int = 128, seed: int = 0,
                 module_class: Optional[type] = None,
                 model_config: Optional[Dict[str, Any]] = None,
                 runner_resources: Optional[Dict[str, float]] = None,
                 obs_filter: Optional[str] = None,
                 framestack: int = 1, device=None):
        self.num_env_runners = num_env_runners
        self.obs_filter = obs_filter
        self._filter_global = None      # merged cross-runner state
        self._inflight: Dict[Any, Any] = {}   # sample ref -> runner
        if num_env_runners == 0:
            self._local = SingleAgentEnvRunner(
                env, num_envs_per_runner, rollout_length, seed,
                module_class, model_config, obs_filter=obs_filter,
                framestack=framestack, device=device)
            self._remote = []
        else:
            self._local = None
            remote_cls = rt.remote(
                **(runner_resources or {"num_cpus": 1}))(SingleAgentEnvRunner)
            self._remote = [
                remote_cls.remote(env, num_envs_per_runner, rollout_length,
                                  seed + 1000 * (i + 1), module_class,
                                  model_config, obs_filter=obs_filter,
                                  framestack=framestack, device=device)
                for i in range(num_env_runners)]
            rt.get([r.ping.remote() for r in self._remote])

    def sample(self) -> Dict[str, Any]:
        """Synchronous parallel sample across all runners."""
        if self._local is not None:
            return self._local.sample()
        return _merge_batches(
            rt.get([r.sample.remote() for r in self._remote]))

    def sample_async_next(self, weights) -> Dict[str, Any]:
        """IMPALA's async path: keep one in-flight sample per remote
        runner, return whichever lands first, and re-arm that runner with
        the given (fresh) weights so sampling overlaps learning. Local
        mode degrades to sync sample with a weight sync."""
        if self._local is not None:
            self._local.set_weights(weights)
            return self._local.sample()
        if not self._inflight:
            for r in self._remote:
                self._inflight[r.sample.remote()] = r
        ready, _ = rt.wait(list(self._inflight), num_returns=1)
        runner = self._inflight.pop(ready[0])
        result = rt.get(ready[0])
        runner.set_weights.remote(rt.put(weights))
        if self.obs_filter:
            # per-runner filter sync on the async cadence: fold THIS
            # runner's delta into the global state and hand the merged
            # state back before re-arming (the sync sync_weights path
            # never runs under IMPALA/APPO)
            d = rt.get(runner.get_filter_delta.remote())
            if d is not None:
                self._filter_global = (
                    d if self._filter_global is None
                    else merge_moments(self._filter_global, d))
                runner.set_filter_state.remote(self._filter_global)
        self._inflight[runner.sample.remote()] = runner
        return result

    def sync_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
            return
        # one put, fanned out by reference — the object store dedups
        ref = rt.put(weights)
        rt.get([r.set_weights.remote(ref) for r in self._remote])
        # filter state rides the weight-sync cadence (reference
        # parity: connector states synchronize with weights)
        self.sync_filters()

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return rt.get(self._remote[0].get_weights.remote())

    def sync_filters(self) -> None:
        """Merge every runner's since-last-sync filter DELTA into the
        group-held global state and push that back (reference parity:
        the filter-synchronization step of RLlib's connector pipelines).
        Deltas, not full states: re-merging full states would count the
        shared history once per runner per sync, growing the count
        ~R^k and freezing the stats."""
        if not self.obs_filter or self._local is not None:
            return
        deltas = [d for d in rt.get(
            [r.get_filter_delta.remote() for r in self._remote])
            if d is not None]
        for d in deltas:
            self._filter_global = (
                d if self._filter_global is None
                else merge_moments(self._filter_global, d))
        if self._filter_global is not None:
            rt.get([r.set_filter_state.remote(self._filter_global)
                    for r in self._remote])

    def get_filter_state(self):
        """Checkpointable filter state (a restored policy must see obs
        normalized by the stats it was trained against)."""
        if not self.obs_filter:
            return None
        if self._local is not None:
            return self._local.get_filter_state()
        self.sync_filters()
        return self._filter_global

    def set_filter_state(self, state) -> None:
        if not self.obs_filter or state is None:
            return
        if self._local is not None:
            self._local.set_filter_state(state)
            return
        self._filter_global = state
        rt.get([r.set_filter_state.remote(state) for r in self._remote])
        # runner deltas predate the restored state: drop them
        rt.get([r.get_filter_delta.remote() for r in self._remote])

    def device_info(self) -> List[Dict[str, Optional[str]]]:
        """Each runner's device and CUDA_VISIBLE_DEVICES."""
        if self._local is not None:
            return [self._local.device_info()]
        return rt.get([r.device_info.remote() for r in self._remote])

    @property
    def module(self):
        if self._local is not None:
            return self._local.module
        return None

    def stop(self) -> None:
        if not self._remote:
            return
        for r in self._remote:
            try:
                rt.kill(r)
            except Exception:
                pass
