"""Trial: driver-side record of one hyperparameter configuration.

The port's copy of ``ray_tpu/tune/trial.py``.

Reference parity: python/ray/tune/experiment/trial.py (status machine
PENDING/RUNNING/PAUSED/TERMINATED/ERROR, last_result, checkpoint
bookkeeping).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"

_counter = itertools.count()


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any],
                 experiment_name: str = "exp"):
        self.trial_id = trial_id
        self.config = config
        self.experiment_name = experiment_name
        self.status = PENDING
        self.actor = None
        self.inflight = None            # outstanding train() ObjectRef
        self.last_result: Dict[str, Any] = {}
        self.results: List[Dict[str, Any]] = []
        self.checkpoint: Any = None     # payload from Trainable.save()
        self.error: Optional[str] = None
        self.iteration = 0
        self.restore_payload: Any = None

    @property
    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def metric_value(self, metric: str) -> Optional[float]:
        value = self.last_result.get(metric)
        return None if value is None else float(value)

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, it={self.iteration})"


def new_trial_id() -> str:
    return f"trial_{next(_counter):05d}"


def advance_trial_counter_past(trial_ids) -> None:
    """Experiment restore in a FRESH process: the global counter starts
    at 0 again, which would reissue restored trial ids and merge two
    trials' scheduler/searcher state. Fast-forward past the max."""
    global _counter
    import itertools
    top = -1
    for tid in trial_ids:
        try:
            top = max(top, int(str(tid).rsplit("_", 1)[-1]))
        except ValueError:
            continue
    current = next(_counter)
    _counter = itertools.count(max(current, top + 1))
