"""Algorithm + AlgorithmConfig: the RLlib-equivalent training loop.

Counterpart of ``ray_tpu/rllib/algorithms/algorithm.py`` (reference
parity: rllib/algorithms/algorithm.py:198, a Tune Trainable; the fluent
algorithm_config.py). An Algorithm owns an EnvRunnerGroup (sampling)
and a LearnerGroup (gradients), both on ``config.device``: "cuda" by
default (raising without a card), "cpu" when asked. With
``num_env_runners > 0`` or ``num_learners > 1`` they are actors of the
port's runtime, each on that device in its own process.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional, Type

from ...tune.trainable import Trainable
from ..core.learner import Learner, LearnerGroup, LearnerHyperparams
from ..env.env_runner_group import EnvRunnerGroup
from ..env.torch_env import make_env, stacked_spec


class AlgorithmConfig:
    """Fluent configuration; sections mirror the reference's
    (.environment/.env_runners/.training/.learners/.rl_module), plus
    .resources(device=...)."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self.env = None
        self.seed = 0
        #: where the runner and the learner run
        self.device = "cuda"
        # env runners
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 8
        self.rollout_fragment_length = 128
        #: None | "mean_std" — running obs normalization inside the
        #: rollout (reference: connectors mean_std_filter)
        self.observation_filter: Optional[str] = None
        #: frames concatenated feature-wise for the module (reference:
        #: connectors frame stacking); 1 = off
        self.framestack: int = 1
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.grad_clip = 0.5
        self.num_epochs = 4
        self.minibatch_size = 256
        # learners
        self.num_learners = 0
        # module
        self.module_class = None
        self.model_config: Dict[str, Any] = {}

    # -- fluent sections ----------------------------------------------------
    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    observation_filter: Optional[str] = None,
                    framestack: Optional[int] = None
                    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if observation_filter is not None:
            self.observation_filter = observation_filter
        if framestack is not None:
            self.framestack = framestack
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, *, num_learners: Optional[int] = None
                 ) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def resources(self, *, device=None) -> "AlgorithmConfig":
        if device is not None:
            self.device = device
        return self

    def rl_module(self, *, module_class: Optional[type] = None,
                  model_config: Optional[Dict[str, Any]] = None
                  ) -> "AlgorithmConfig":
        if module_class is not None:
            self.module_class = module_class
        if model_config is not None:
            self.model_config = dict(model_config)
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d.pop("algo_class", None)
        return d

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            if k.startswith("_"):
                continue
            if not hasattr(self, k):
                # fail loudly: a mistyped hyperparameter silently running
                # with its default is the worst sweep outcome
                raise ValueError(
                    f"unknown config key {k!r}; valid keys: "
                    f"{sorted(a for a in vars(self) if a != 'algo_class')}")
            setattr(self, k, v)
        return self

    def learner_hyperparams(self) -> LearnerHyperparams:
        return LearnerHyperparams(
            lr=self.lr, grad_clip=self.grad_clip,
            num_epochs=self.num_epochs, minibatch_size=self.minibatch_size)

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use e.g. PPOConfig")
        return self.algo_class(config={"_algo_config": self})


class Algorithm(Trainable):
    """Subclasses define default_config(), build_learner(spec, config,
    device) and training_step()."""

    _config: AlgorithmConfig

    @classmethod
    def default_config(cls) -> AlgorithmConfig:
        return AlgorithmConfig(cls)

    @classmethod
    def build_learner(cls, spec, config: AlgorithmConfig,
                      device=None) -> Learner:
        raise NotImplementedError

    def setup(self, config: Dict[str, Any]) -> None:
        algo_cfg = config.get("_algo_config")
        if algo_cfg is None:
            algo_cfg = type(self).default_config().update_from_dict(config)
        self._config = algo_cfg
        cfg = self._config
        if cfg.env is None:
            raise ValueError("no environment configured")
        # the learner's module must match the runner's stacked width
        spec = stacked_spec(make_env(cfg.env).spec, cfg.framestack)
        self.env_runner_group = EnvRunnerGroup(
            cfg.env, num_env_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_env_runner,
            rollout_length=cfg.rollout_fragment_length, seed=cfg.seed,
            module_class=cfg.module_class, model_config=cfg.model_config,
            obs_filter=cfg.observation_filter, framestack=cfg.framestack,
            device=cfg.device)
        cls = type(self)
        self.learner_group = LearnerGroup(
            lambda device: cls.build_learner(spec, cfg, device),
            num_learners=cfg.num_learners, device=cfg.device)
        # start sampling with the learner's weights
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self._lifetime_env_steps = 0
        self._last_return_mean = float("nan")

    # -- Trainable ----------------------------------------------------------
    def step(self) -> Dict[str, Any]:
        t0 = time.time()
        metrics = self.training_step()
        metrics.setdefault("time_this_iter_s", time.time() - t0)
        return metrics

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        return {"learner": self.learner_group.get_state(),
                "lifetime_env_steps": self._lifetime_env_steps,
                # a restored policy must see obs normalized by the
                # stats its weights were trained against
                "obs_filter": self.env_runner_group.get_filter_state()}

    def load_checkpoint(self, state: Any) -> None:
        self.learner_group.set_state(state["learner"])
        self._lifetime_env_steps = state.get("lifetime_env_steps", 0)
        self.env_runner_group.set_filter_state(state.get("obs_filter"))
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def cleanup(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.stop()

    # -- shared metric plumbing --------------------------------------------
    def _roll_metrics(self, stats: Dict[str, Any],
                      learner_metrics: Dict[str, float]) -> Dict[str, Any]:
        self._lifetime_env_steps += stats["env_steps"]
        if stats["num_episodes"] > 0:
            self._last_return_mean = stats["episode_return_mean"]
        out = {
            "episode_return_mean": self._last_return_mean,
            "episode_len_mean": stats.get("episode_len_mean", float("nan")),
            "num_episodes": stats["num_episodes"],
            "num_env_steps_sampled": stats["env_steps"],
            "num_env_steps_sampled_lifetime": self._lifetime_env_steps,
        }
        out.update({f"learner/{k}": v for k, v in learner_metrics.items()})
        return out
