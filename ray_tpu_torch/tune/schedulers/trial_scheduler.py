"""TrialScheduler interface + FIFO and MedianStopping.

The port's copy of ``ray_tpu/tune/schedulers/trial_scheduler.py``.

Reference parity: python/ray/tune/schedulers/trial_scheduler.py (decision
enum CONTINUE/PAUSE/STOP) and median_stopping_rule.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..trial import Trial

CONTINUE = "CONTINUE"
PAUSE = "PAUSE"
STOP = "STOP"


class TrialScheduler:
    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric, self.mode = metric, mode

    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str]) -> None:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode

    def _score(self, result: Dict[str, Any]) -> Optional[float]:
        value = result.get(self.metric) if self.metric else None
        if value is None:
            return None
        return float(value) if self.mode == "max" else -float(value)

    def on_trial_add(self, trial: Trial) -> None:
        pass

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial: Trial,
                          result: Optional[Dict[str, Any]]) -> None:
        pass

    def choose_trial_to_run(self, trials: List[Trial]) -> Optional[Trial]:
        """Pick the next PENDING/PAUSED trial to (re)start; FIFO default."""
        from ..trial import PAUSED, PENDING
        for trial in trials:
            if trial.status == PENDING:
                return trial
        for trial in trials:
            if trial.status == PAUSED:
                return trial
        return None


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion in submission order."""


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average metric falls below the median of
    completed averages at the same step (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3):
        super().__init__(metric, mode)
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = {}

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        if score is None:
            return CONTINUE
        history = self._history.setdefault(trial.trial_id, [])
        history.append(score)
        step = len(history)
        if step <= self.grace_period:
            return CONTINUE
        peers = [sum(h[:step]) / step
                 for tid, h in self._history.items()
                 if tid != trial.trial_id and len(h) >= step]
        if len(peers) < self.min_samples:
            return CONTINUE
        peers.sort()
        median = peers[len(peers) // 2]
        mine = sum(history) / step
        return STOP if mine < median else CONTINUE
