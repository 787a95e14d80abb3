"""PB2: Population Based Bandits (Parker-Holder et al. 2020).

The port's copy of ``ray_tpu/tune/schedulers/pb2.py``.

Reference parity: python/ray/tune/schedulers/pb2.py (which wraps GPy).
Nothing external is vendored: the time-varying GP (RBF kernel over
[t, hyperparams], Cholesky solve) and the UCB acquisition are
implemented directly on numpy. PBT picks new hyperparams by random
perturbation; PB2 instead fits a GP to the population's observed
(time, config) -> reward-improvement data and selects the UCB argmax
over the bounded search box — provably efficient for small
populations, where random perturbation wastes trials.

Only bounded continuous hyperparams (`hyperparam_bounds`) ride the GP;
anything in `hyperparam_mutations` keeps PBT-style exploration.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .pbt import PopulationBasedTraining, explore


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d / (ls * ls))


class _GP:
    """Minimal GP regressor: RBF kernel, fixed noise, Cholesky solve."""

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-2):
        self.ls = lengthscale
        self.noise = noise
        self.x: Optional[np.ndarray] = None
        self.alpha: Optional[np.ndarray] = None
        self.chol: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        k = _rbf(x, x, self.ls) + self.noise * np.eye(len(x))
        self.chol = np.linalg.cholesky(k)
        self.alpha = np.linalg.solve(
            self.chol.T, np.linalg.solve(self.chol, y))
        self.x = x

    def predict(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ks = _rbf(q, self.x, self.ls)
        mu = ks @ self.alpha
        v = np.linalg.solve(self.chol, ks.T)
        var = np.clip(1.0 - (v * v).sum(0), 1e-9, None)
        return mu, np.sqrt(var)


class PB2(PopulationBasedTraining):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[
                     Dict[str, Tuple[float, float]]] = None,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 time_attr: str = "training_iteration",
                 ucb_kappa: float = 2.0,
                 n_candidates: int = 256,
                 seed: Optional[int] = None):
        super().__init__(metric, mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=hyperparam_mutations,
                         quantile_fraction=quantile_fraction,
                         time_attr=time_attr, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 needs hyperparam_bounds={name: (lo, hi)}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._np_rng = np.random.default_rng(seed)
        # observation log: (t, config values at t, score at t) per trial
        self._obs: Dict[str, List[Tuple[float, Dict[str, float], float]]] = {}

    # ------------------------------------------------------------- observe

    def on_trial_result(self, trial, result):
        score = self._score(result)
        if score is not None:
            t = float(result.get(self.time_attr, 0))
            vals = {k: float(trial.config.get(k, 0.0))
                    for k in self.bounds}
            rows = self._obs.setdefault(trial.trial_id, [])
            rows.append((t, vals, score))
            if len(rows) > 64:        # only consecutive deltas are used
                del rows[:-64]
        return super().on_trial_result(trial, result)

    # ------------------------------------------------------------- explore

    def _training_data(self):
        """(X=[t, *hyperparams] normalized, y=reward deltas normalized)."""
        keys = sorted(self.bounds)
        xs, ys = [], []
        for rows in self._obs.values():
            for (t0, v0, s0), (t1, v1, s1) in zip(rows, rows[1:]):
                xs.append([t1] + [v1[k] for k in keys])
                ys.append(s1 - s0)
        if not xs:
            return keys, None, None
        x = np.asarray(xs, np.float64)
        y = np.asarray(ys, np.float64)
        # normalize: t and each hyperparam into [0,1]; y standardized
        lo = np.array([x[:, 0].min()] + [self.bounds[k][0] for k in keys])
        hi = np.array([x[:, 0].max()] + [self.bounds[k][1] for k in keys])
        span = np.where(hi > lo, hi - lo, 1.0)
        x = (x - lo) / span
        y = (y - y.mean()) / (y.std() + 1e-9)
        return keys, x, y

    def _explore_config(self, config: Dict[str, Any],
                        step: int) -> Dict[str, Any]:
        # non-GP params keep PBT exploration
        new_config = explore(config, self.mutations,
                             self.resample_probability, self.rng)
        keys, x, y = self._training_data()
        if x is None or len(x) < 4:
            # cold start: uniform sample in bounds
            for k in keys:
                lo, hi = self.bounds[k]
                new_config[k] = float(self._np_rng.uniform(lo, hi))
            return new_config
        gp = _GP()
        # cap the dataset so the Cholesky stays cheap
        if len(x) > 512:
            sel = self._np_rng.choice(len(x), 512, replace=False)
            x, y = x[sel], y[sel]
        gp.fit(x, y)
        # candidates at the CURRENT (latest) normalized time, sweeping
        # the hyperparam box: pick the UCB argmax
        q = self._np_rng.uniform(
            size=(self.n_candidates, 1 + len(keys)))
        q[:, 0] = x[:, 0].max()           # "what helps going forward"
        mu, sd = gp.predict(q)
        best = q[int(np.argmax(mu + self.kappa * sd))]
        for i, k in enumerate(keys):
            lo, hi = self.bounds[k]
            new_config[k] = float(lo + best[1 + i] * (hi - lo))
        return new_config
