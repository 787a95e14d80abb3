"""Synchronous HyperBand.

The port's copy of ``ray_tpu/tune/schedulers/hyperband.py``.

Reference parity: python/ray/tune/schedulers/hyperband.py — trials are
grouped into brackets; at each rung boundary the bracket PAUSES until all
members report, then the bottom (1 - 1/eta) fraction is stopped and the
rest resume with a larger budget.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from ..trial import PAUSED, Trial
from .trial_scheduler import CONTINUE, PAUSE, STOP, TrialScheduler


class _SyncBracket:
    def __init__(self, milestones: List[int], eta: float):
        self.milestones = milestones   # increasing rung budgets
        self.eta = eta
        self.members: List[str] = []
        self.rung_of: Dict[str, int] = {}
        self.waiting: Dict[str, float] = {}   # trial_id -> score at rung
        self.stopped: set = set()
        self.newly_stopped: set = set()       # drained by the scheduler

    def add(self, trial_id: str) -> None:
        self.members.append(trial_id)
        self.rung_of[trial_id] = 0

    def live_members(self) -> List[str]:
        return [t for t in self.members if t not in self.stopped]

    def on_result(self, trial_id: str, cur_iter: int,
                  score: Optional[float]) -> str:
        rung = self.rung_of[trial_id]
        if rung >= len(self.milestones):
            return STOP
        if cur_iter < self.milestones[rung]:
            return CONTINUE
        self.waiting[trial_id] = -math.inf if score is None else score
        if set(self.waiting) >= set(self.live_members()):
            self._promote()
            return CONTINUE if trial_id not in self.stopped else STOP
        return PAUSE

    def _promote(self) -> None:
        ranked = sorted(self.waiting.items(), key=lambda kv: kv[1],
                        reverse=True)
        keep = max(1, int(len(ranked) / self.eta))
        for i, (tid, _) in enumerate(ranked):
            if i < keep:
                self.rung_of[tid] += 1
            else:
                self.stopped.add(tid)
                self.newly_stopped.add(tid)
        self.waiting.clear()


class HyperBandScheduler(TrialScheduler):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 max_t: int = 81, reduction_factor: float = 3,
                 time_attr: str = "training_iteration"):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        s_max = int(math.log(max_t) / math.log(reduction_factor))
        # Bracket spec pairs (capacity, halving exponent s): the bracket
        # with the MOST trials starts at the SMALLEST budget (most rungs,
        # aggressive halving) and vice versa.
        self._bracket_specs = [
            (max(1, int(math.ceil((s_max + 1) / (s + 1)
                                  * reduction_factor ** s))), s)
            for s in reversed(range(s_max + 1))]
        self._brackets: List[_SyncBracket] = []
        self._next_bracket = 0
        self._trial_bracket: Dict[str, _SyncBracket] = {}

    def _open_bracket(self) -> _SyncBracket:
        capacity, s = self._bracket_specs[
            self._next_bracket % len(self._bracket_specs)]
        rungs = []
        budget = max(1, int(self.max_t / self.eta ** s))
        while budget <= self.max_t:
            rungs.append(budget)
            budget = int(budget * self.eta)
        bracket = _SyncBracket(rungs or [self.max_t], self.eta)
        bracket.capacity = capacity
        self._brackets.append(bracket)
        self._next_bracket += 1
        return bracket

    def on_trial_add(self, trial: Trial) -> None:
        for bracket in self._brackets:
            if len(bracket.members) < bracket.capacity:
                bracket.add(trial.trial_id)
                self._trial_bracket[trial.trial_id] = bracket
                return
        bracket = self._open_bracket()
        bracket.add(trial.trial_id)
        self._trial_bracket[trial.trial_id] = bracket

    def on_trial_result(self, trial: Trial, result: Dict[str, Any]) -> str:
        if int(result.get(self.time_attr, 0)) >= self.max_t:
            return STOP
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return CONTINUE
        return bracket.on_result(trial.trial_id,
                                 int(result.get(self.time_attr, 0)),
                                 self._score(result))

    def on_trial_complete(self, trial: Trial,
                          result: Optional[Dict[str, Any]]) -> None:
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return
        bracket.stopped.add(trial.trial_id)
        bracket.newly_stopped.discard(trial.trial_id)
        bracket.waiting.pop(trial.trial_id, None)
        if bracket.waiting and set(bracket.waiting) >= set(bracket.live_members()):
            bracket._promote()

    def pop_trials_to_stop(self) -> List[str]:
        out: List[str] = []
        for bracket in self._brackets:
            out.extend(bracket.newly_stopped)
            bracket.newly_stopped.clear()
        return out

    def choose_trial_to_run(self, trials: List[Trial]) -> Optional[Trial]:
        """Hold the synchronous rung barrier: a PAUSED trial is resumable
        only once its bracket promoted it (it is no longer parked in
        `waiting` and was not halved away)."""
        from ..trial import PENDING
        for trial in trials:
            if trial.status == PENDING:
                return trial
        for trial in trials:
            if trial.status != PAUSED:
                continue
            bracket = self._trial_bracket.get(trial.trial_id)
            if bracket is None:
                return trial
            if trial.trial_id in bracket.waiting or \
                    trial.trial_id in bracket.stopped:
                continue
            return trial
        return None
