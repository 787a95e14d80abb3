"""Population Based Training.

The port's copy of ``ray_tpu/tune/schedulers/pbt.py``.

Reference parity: python/ray/tune/schedulers/pbt.py (PopulationBasedTraining
:221 — at each perturbation_interval, bottom-quantile trials _exploit the
checkpoint+config of a top-quantile peer then _explore :54 by perturbing
hyperparams: continuous values x0.8/x1.2 or resample, categoricals shift
or resample).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from ..search.sample import Domain
from ..trial import RUNNING, Trial
from .trial_scheduler import CONTINUE, TrialScheduler


def explore(config: Dict[str, Any],
            mutations: Dict[str, Any],
            resample_probability: float,
            rng: random.Random) -> Dict[str, Any]:
    new_config = dict(config)
    for key, spec in mutations.items():
        if isinstance(spec, Domain):
            if rng.random() < resample_probability or key not in new_config:
                new_config[key] = spec.sample(np.random.default_rng(
                    rng.randrange(2**31)))
            elif isinstance(new_config[key], (int, float)):
                factor = 1.2 if rng.random() > 0.5 else 0.8
                new_config[key] = type(new_config[key])(
                    new_config[key] * factor)
        elif isinstance(spec, list):
            if rng.random() < resample_probability or \
                    new_config.get(key) not in spec:
                new_config[key] = rng.choice(spec)
            else:
                index = spec.index(new_config[key])
                shift = rng.choice([-1, 1])
                new_config[key] = spec[max(0, min(len(spec) - 1,
                                                  index + shift))]
        elif callable(spec):
            new_config[key] = spec()
    return new_config


class PopulationBasedTraining(TrialScheduler):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.perturbation_interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile_fraction = quantile_fraction
        self.resample_probability = resample_probability
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        # exploit requests consumed by the controller:
        # trial_id -> (source_trial_id, new_config)
        self.pending_exploits: Dict[str, Any] = {}
        self.num_perturbations = 0

    def _quantiles(self, trials: List[Trial]):
        scored = [t for t in trials
                  if t.trial_id in self._scores and not t.is_finished]
        if len(scored) < 2:
            return [], []
        scored.sort(key=lambda t: self._scores[t.trial_id])
        count = max(1, int(len(scored) * self.quantile_fraction))
        if count > len(scored) / 2:
            count = int(len(scored) / 2)
        return scored[:count], scored[-count:]   # bottom, top

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        if score is not None:
            self._scores[trial.trial_id] = score
        step = int(result.get(self.time_attr, 0))
        last = self._last_perturb.get(trial.trial_id, 0)
        if step - last < self.perturbation_interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = step
        bottom, top = self._quantiles(trial.tune_trials
                                      if hasattr(trial, "tune_trials") else [])
        if trial in bottom and top:
            source = self.rng.choice(top)
            new_config = self._explore_config(source.config, step)
            self.pending_exploits[trial.trial_id] = (source.trial_id,
                                                     new_config)
            self.num_perturbations += 1
        return CONTINUE

    def _explore_config(self, config: Dict[str, Any],
                        step: int) -> Dict[str, Any]:
        """Subclass hook: PBT perturbs randomly; PB2 fits a GP bandit."""
        return explore(config, self.mutations,
                       self.resample_probability, self.rng)
