"""Tuner: the user-facing experiment API.

The port's copy of ``ray_tpu/tune/tuner.py``.

Reference parity: python/ray/tune/tuner.py (Tuner.fit :312) +
tune/result_grid.py (ResultGrid/get_best_result). Trainables may be a
function(config), a Trainable subclass, or a ray_tpu_torch.train trainer
instance (wrapped the way base_trainer.py:808 wraps trainers into
trainables).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

from .execution.tune_controller import TuneController
from .schedulers.trial_scheduler import TrialScheduler
from .search.searcher import BasicVariantGenerator, Searcher
from .trainable import Trainable, wrap_function
from .trial import Trial


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None
    stop: Optional[Dict[str, float]] = None
    # experiment-level durability: snapshot searcher/scheduler/trials
    # here every checkpoint_period_s; Tuner.restore(path, trainable)
    # resumes the sweep
    experiment_path: Optional[str] = None
    checkpoint_period_s: float = 10.0


@dataclasses.dataclass
class TuneResult:
    """One trial's outcome (the reference's tune/result.py Result)."""
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    checkpoint: Any
    error: Optional[str]
    trial_id: str

    @property
    def metrics_dataframe(self) -> List[Dict[str, Any]]:
        return self._history

    def __repr__(self):
        return f"Result({self.trial_id}, metrics={self.metrics})"


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str):
        self._trials = trials
        self._metric, self._mode = metric, mode
        self.results = []
        for trial in trials:
            result = TuneResult(config=trial.config,
                                metrics=trial.last_result,
                                checkpoint=trial.checkpoint,
                                error=trial.error,
                                trial_id=trial.trial_id)
            result._history = trial.results
            self.results.append(result)

    def __len__(self):
        return len(self.results)

    def __getitem__(self, index: int) -> TuneResult:
        return self.results[index]

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self.results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TuneResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric)")
        scored = [r for r in self.results if metric in (r.metrics or {})]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self) -> List[Dict[str, Any]]:
        rows = []
        for r in self.results:
            row = dict(r.metrics or {})
            row["trial_id"] = r.trial_id
            row.update({f"config/{k}": v for k, v in r.config.items()})
            rows.append(row)
        return rows


def _as_trainable_cls(trainable: Any) -> type:
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable) and not isinstance(trainable, type):
        return wrap_function(trainable)
    # Train-library trainer instance → function trainable running fit()
    # (reference: base_trainer.py:808 as_trainable).
    if hasattr(trainable, "as_trainable"):
        return trainable.as_trainable()
    raise TypeError(f"cannot tune over {trainable!r}")


class Tuner:
    def __init__(self, trainable: Any,
                 *, param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Any = None):
        self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config
        self._restore_path: Optional[str] = None

    def fit(self) -> ResultGrid:
        cfg = self.tune_config
        searcher = cfg.search_alg
        if searcher is None:
            searcher = BasicVariantGenerator(
                self.param_space, num_samples=cfg.num_samples,
                seed=cfg.seed, metric=cfg.metric, mode=cfg.mode)
        else:
            searcher.set_search_properties(cfg.metric, cfg.mode,
                                           self.param_space)
        resources = None
        max_failures = 0
        if self.run_config is not None:
            failure = getattr(self.run_config, "failure_config", None)
            if failure is not None:
                max_failures = failure.max_failures
        trainable_cls = _as_trainable_cls(self._trainable)
        if hasattr(self._trainable, "tune_resources_per_trial"):
            resources = self._trainable.tune_resources_per_trial()
        controller = TuneController(
            trainable_cls, searcher, cfg.scheduler,
            max_concurrent=cfg.max_concurrent_trials,
            resources_per_trial=resources,
            max_failures=max_failures,
            time_budget_s=cfg.time_budget_s,
            stop=cfg.stop,
            experiment_path=cfg.experiment_path,
            checkpoint_period_s=cfg.checkpoint_period_s)
        metric, mode = cfg.metric, cfg.mode
        if self._restore_path:
            controller.restore_experiment(self._restore_path)
            # a bare restore (no tune_config) recovers metric/mode from
            # the pickled searcher so get_best_result just works
            if metric is None:
                metric = controller.searcher.metric
                mode = controller.searcher.mode or mode
            controller.scheduler.set_search_properties(
                controller.searcher.metric, controller.searcher.mode)
        trials = controller.run()
        return ResultGrid(trials, metric, mode)

    @classmethod
    def restore(cls, path: str, trainable: Any,
                *, tune_config: Optional[TuneConfig] = None,
                run_config: Any = None) -> "Tuner":
        """Resume an interrupted sweep from an experiment snapshot
        (reference parity: Tuner.restore — searcher observation
        history, scheduler state, finished-trial results all carry
        over; interrupted trials re-launch from their last
        checkpoint). Call .fit() on the returned Tuner."""
        tuner = cls(trainable, tune_config=tune_config,
                    run_config=run_config)
        if tuner.tune_config.experiment_path is None:
            # copy, don't mutate: the caller may reuse its TuneConfig
            tuner.tune_config = dataclasses.replace(
                tuner.tune_config, experiment_path=path)
        tuner._restore_path = path
        return tuner


def run(trainable: Any, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, metric: Optional[str] = None,
        mode: str = "max", scheduler: Optional[TrialScheduler] = None,
        search_alg: Optional[Searcher] = None,
        max_concurrent_trials: int = 4,
        stop: Optional[Dict[str, float]] = None, **_ignored) -> ResultGrid:
    """tune.run-style convenience wrapper over Tuner."""
    tuner = Tuner(trainable, param_space=config,
                  tune_config=TuneConfig(
                      metric=metric, mode=mode, num_samples=num_samples,
                      scheduler=scheduler, search_alg=search_alg,
                      max_concurrent_trials=max_concurrent_trials,
                      stop=stop))
    return tuner.fit()
