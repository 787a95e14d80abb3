"""Multi-agent PPO: per-policy learners over one batched rollout.

Counterpart of ``ray_tpu/rllib/algorithms/multi_agent_ppo.py``
(reference parity: rllib/algorithms/ppo with
AlgorithmConfig.multi_agent(policies=..., policy_mapping_fn=...),
algorithm_config.py:2766, and the MultiLearner update path). Each
policy gets its own PPOLearner (its own optimizer state) on the
config's device; one runner steps every policy and the joint env on the
device (``env/multi_agent_env_runner.py``).
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional

from .. import connectors
from ..env.multi_agent_env import make_multi_agent_env
from ..env.multi_agent_env_runner import (MultiAgentEnvRunnerGroup,
                                          call_mapping_fn)
from .algorithm import Algorithm
from .ppo import PPOConfig, PPOLearner


class MultiAgentPPOConfig(PPOConfig):
    """PPOConfig + the reference's .multi_agent() section."""

    def __init__(self):
        super().__init__()
        self.algo_class = MultiAgentPPO
        self.policies: Dict[str, Optional[dict]] = {}
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None

    def multi_agent(self, *, policies: Optional[Dict[str, Optional[dict]]]
                    = None,
                    policy_mapping_fn: Optional[Callable] = None
                    ) -> "MultiAgentPPOConfig":
        """policies: {policy_id: None | per-policy config overrides
        (module_class / model_config / any training key)}.
        policy_mapping_fn: agent_id -> policy_id (evaluated once per
        agent — see multi_agent_env_runner.py's docstring)."""
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def per_policy_config(self, policy_id: str) -> "MultiAgentPPOConfig":
        overrides = self.policies.get(policy_id) or {}
        cfg = self.copy()
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(
                    f"unknown per-policy override {k!r} for {policy_id!r}")
            setattr(cfg, k, v)
        return cfg


class MultiAgentPPO(Algorithm):
    """PPO over a MultiAgentTorchEnv with N independent policies."""

    @classmethod
    def default_config(cls) -> MultiAgentPPOConfig:
        return MultiAgentPPOConfig()

    def setup(self, config: Dict[str, Any]) -> None:
        algo_cfg = config.get("_algo_config")
        if algo_cfg is None:
            algo_cfg = type(self).default_config().update_from_dict(config)
        self._config = algo_cfg
        cfg = self._config
        if cfg.env is None:
            raise ValueError("no environment configured")
        env = make_multi_agent_env(cfg.env)
        mapping_fn = cfg.policy_mapping_fn
        if mapping_fn is None:
            if cfg.policies:
                raise ValueError(
                    "policies configured but no policy_mapping_fn")
            # default: one policy per agent, named after the agent
            mapping_fn = lambda aid: aid
        module_classes = {}
        model_configs = {}
        for pid in (cfg.policies or
                    {call_mapping_fn(mapping_fn, a): None
                     for a in env.agents}):
            pcfg = cfg.per_policy_config(pid)
            if pcfg.module_class is not None:
                module_classes[pid] = pcfg.module_class
            if pcfg.model_config:
                model_configs[pid] = pcfg.model_config
        if getattr(cfg, "observation_filter", None):
            raise ValueError(
                "observation_filter is not supported by the multi-agent "
                "env runner (per-agent obs spaces would each need their "
                "own running stats); unset it for MultiAgentPPO")
        if getattr(cfg, "framestack", 1) > 1:
            raise ValueError(
                "framestack is not supported by the multi-agent env "
                "runner; unset it for MultiAgentPPO")
        self.env_runner_group = MultiAgentEnvRunnerGroup(
            cfg.env, mapping_fn, num_env_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_env_runner,
            rollout_length=cfg.rollout_fragment_length, seed=cfg.seed,
            module_classes=module_classes, model_configs=model_configs,
            device=cfg.device)
        # one local learner (own optimizer + hyperparams) per policy, as
        # the JAX package builds them whatever num_learners says
        self.learners: Dict[str, PPOLearner] = {}
        self._pipelines = {}
        for pid, spec in self.env_runner_group.module_specs.items():
            pcfg = cfg.per_policy_config(pid)
            if "seed" not in (cfg.policies.get(pid) or {}):
                # distinct init per policy: identical seeds would start
                # same-architecture policies byte-identical
                pcfg.seed = cfg.seed + 1 + (
                    zlib.crc32(pid.encode()) % 100003)
            self.learners[pid] = PPOLearner(spec, pcfg)
            self._pipelines[pid] = connectors.default_learner_pipeline(
                gamma=pcfg.gamma, lam=pcfg.lambda_,
                normalize_advantages=getattr(
                    pcfg, "normalize_advantages", True))
        self.env_runner_group.sync_weights(self._weights())
        self._lifetime_env_steps = 0
        self._last_return_mean = float("nan")
        self._last_agent_returns: Dict[str, float] = {}

    def _weights(self):
        return {pid: lr.get_weights() for pid, lr in self.learners.items()}

    def training_step(self) -> Dict[str, Any]:
        result = self.env_runner_group.sample()
        learner_metrics: Dict[str, float] = {}
        for pid, batch in result["batches"].items():
            train_batch = self._pipelines[pid](batch)
            for k, v in self.learners[pid].update(train_batch).items():
                learner_metrics[f"{pid}/{k}"] = v
        self.env_runner_group.sync_weights(self._weights())
        return self._roll_metrics(result["stats"], learner_metrics)

    def _roll_metrics(self, stats, learner_metrics):
        out = super()._roll_metrics(stats, learner_metrics)
        agent_returns = stats.get("agent_episode_returns")
        if stats["num_episodes"] > 0 and agent_returns:
            self._last_agent_returns = dict(agent_returns)
        out["agent_episode_returns"] = dict(self._last_agent_returns)
        out["num_agent_steps_sampled"] = stats.get("agent_steps", 0)
        return out

    # -- Trainable ----------------------------------------------------------
    def save_checkpoint(self) -> Any:
        return {"learners": {pid: lr.get_state()
                             for pid, lr in self.learners.items()},
                "lifetime_env_steps": self._lifetime_env_steps}

    def load_checkpoint(self, state: Any) -> None:
        for pid, lstate in state["learners"].items():
            self.learners[pid].set_state(lstate)
        self._lifetime_env_steps = state.get("lifetime_env_steps", 0)
        self.env_runner_group.sync_weights(self._weights())

    def cleanup(self) -> None:
        self.env_runner_group.stop()
