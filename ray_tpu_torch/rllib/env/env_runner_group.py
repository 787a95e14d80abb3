"""EnvRunnerGroup: the local env runner.

Counterpart of ``ray_tpu/rllib/env/env_runner_group.py``'s local path
(``num_env_runners=0``): one in-process SingleAgentEnvRunner on the
group's device. Remote runners need an actor runtime, which the port
does not have yet (ROADMAP.md §A5; RLlib's remote paths on it are §A6),
so ``num_env_runners > 0`` is refused rather than sampled locally.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .env_runner import SingleAgentEnvRunner


class EnvRunnerGroup:
    def __init__(self, env, num_env_runners: int = 0, num_envs_per_runner:
                 int = 8, rollout_length: int = 128, seed: int = 0,
                 module_class: Optional[type] = None,
                 model_config: Optional[Dict[str, Any]] = None,
                 obs_filter: Optional[str] = None,
                 framestack: int = 1, device=None):
        if num_env_runners > 0:
            raise ValueError(
                f"num_env_runners={num_env_runners}: remote env runners "
                f"wait for an actor runtime in ray_tpu_torch (ROADMAP.md "
                f"§A5, then RLlib's remote paths, §A6); use "
                f"num_env_runners=0 for the local runner")
        self.num_env_runners = num_env_runners
        self.obs_filter = obs_filter
        self._local = SingleAgentEnvRunner(
            env, num_envs_per_runner, rollout_length, seed,
            module_class, model_config, obs_filter=obs_filter,
            framestack=framestack, device=device)

    def sample(self) -> Dict[str, Any]:
        return self._local.sample()

    def sample_async_next(self, weights) -> Dict[str, Any]:
        """IMPALA's async path; with the local runner a sample after a
        weight sync (as the reference's local mode)."""
        self._local.set_weights(weights)
        return self._local.sample()

    def sync_weights(self, weights) -> None:
        self._local.set_weights(weights)

    def get_weights(self):
        return self._local.get_weights()

    def get_filter_state(self):
        """Checkpointable filter state (a restored policy must see obs
        normalized by the stats it was trained against)."""
        return self._local.get_filter_state()

    def set_filter_state(self, state) -> None:
        self._local.set_filter_state(state)

    @property
    def module(self):
        return self._local.module

    def stop(self) -> None:
        pass
