"""BOHB: Bayesian Optimization + HyperBand (Falkner et al. 2018).

The port's copy of ``ray_tpu/tune/search/bohb.py``.

Reference parity: python/ray/tune/search/bohb/bohb_search.py (TuneBOHB,
which wraps the external hpbandster lib) paired with HyperBandForBOHB.
Nothing external is vendored here: the model is the native TPE
implementation (tpe.py), kept PER BUDGET — results observed at deeper
training_iteration milestones build separate, more-trustworthy models,
and suggestions come from the deepest budget that has enough
observations (BOHB's core rule). Pair with HyperBandScheduler, whose
successive-halving milestones produce exactly the budget strata this
searcher feeds on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .tpe import TPESearch


class BOHBSearch(TPESearch):
    def __init__(self, space: Dict[str, Any], metric: str, mode: str = "max",
                 num_samples: int = 64, n_startup_trials: int = 8,
                 n_candidates: int = 24, gamma: float = 0.25,
                 budget_key: str = "training_iteration",
                 min_points_in_model: Optional[int] = None,
                 seed: Optional[int] = None):
        super().__init__(space, metric, mode, num_samples=num_samples,
                         n_startup_trials=n_startup_trials,
                         n_candidates=n_candidates, gamma=gamma, seed=seed)
        self.budget_key = budget_key
        # BOHB default: dim+1 points before a budget's model is usable
        self.min_points = (min_points_in_model
                           if min_points_in_model is not None
                           else len(self.space) + 1)
        # budget level -> [(config, score)] observed AT that budget
        self._budget_scores: Dict[int, List[Tuple[dict, float]]] = {}
        self._trial_budget: Dict[str, int] = {}

    # ------------------------------------------------------------ observe

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        super().on_trial_result(trial_id, result)
        if not result or self.metric not in result:
            return
        budget = int(result.get(self.budget_key, 0) or 0)
        self._trial_budget[trial_id] = max(
            budget, self._trial_budget.get(trial_id, 0))
        config = self._trials.get(trial_id)
        if config is None:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        # keep only the LATEST observation of this trial at this budget
        pool = self._budget_scores.setdefault(budget, [])
        pool[:] = [(c, s) for c, s in pool if c is not config]
        pool.append((config, score))

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        self._trial_budget.pop(trial_id, None)
        super().on_trial_complete(trial_id, result, error)

    # ------------------------------------------------------------ model

    def _split(self):
        """Rank/split from the deepest budget with enough points —
        observations that survived more halvings are worth more. Falls
        back to the global pool (TPE behavior) before any budget
        matures."""
        for budget in sorted(self._budget_scores, reverse=True):
            pool = self._budget_scores[budget]
            if len(pool) >= self.min_points:
                saved, self._scores = self._scores, pool
                try:
                    return super()._split()
                finally:
                    self._scores = saved
        return super()._split()
