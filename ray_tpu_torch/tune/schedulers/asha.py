"""ASHA: asynchronous successive halving.

The port's copy of ``ray_tpu/tune/schedulers/asha.py``.

Reference parity: python/ray/tune/schedulers/async_hyperband.py
(AsyncHyperBandScheduler with brackets of rungs; a trial reaching a rung
milestone continues only if it is in the top 1/reduction_factor of
recorded scores at that rung).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..trial import Trial
from .trial_scheduler import CONTINUE, STOP, TrialScheduler


class _Bracket:
    def __init__(self, min_t: int, max_t: int, reduction_factor: float,
                 stop_last_trials: bool):
        self.rf = reduction_factor
        self.stop_last_trials = stop_last_trials
        self.rungs: List[Dict[str, Any]] = []
        milestone = min_t
        while milestone < max_t:
            self.rungs.append({"milestone": milestone, "recorded": {}})
            milestone = int(milestone * reduction_factor)
        self.rungs.reverse()  # highest milestone first, like the reference

    def on_result(self, trial_id: str, cur_iter: int,
                  score: Optional[float]) -> str:
        decision = CONTINUE
        for rung in self.rungs:
            milestone, recorded = rung["milestone"], rung["recorded"]
            if cur_iter < milestone or trial_id in recorded:
                continue
            if score is not None:
                values = list(recorded.values())
                if values:
                    values.sort()
                    cutoff = values[
                        max(0, len(values) - max(1, int(len(values) / self.rf)))]
                    if score < cutoff:
                        decision = STOP
                recorded[trial_id] = score
            break
        return decision


class AsyncHyperBandScheduler(TrialScheduler):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4, brackets: int = 1,
                 time_attr: str = "training_iteration",
                 stop_last_trials: bool = True):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self._brackets = [
            _Bracket(grace_period * int(reduction_factor ** s), max_t,
                     reduction_factor, stop_last_trials)
            for s in range(brackets)
        ]
        self._trial_bracket: Dict[str, _Bracket] = {}
        self._rr = 0

    def on_trial_add(self, trial: Trial) -> None:
        self._trial_bracket[trial.trial_id] = \
            self._brackets[self._rr % len(self._brackets)]
        self._rr += 1

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        cur_iter = int(result.get(self.time_attr, 0))
        if cur_iter >= self.max_t:
            return STOP
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return CONTINUE
        return bracket.on_result(trial.trial_id, cur_iter,
                                 self._score(result))


ASHAScheduler = AsyncHyperBandScheduler
