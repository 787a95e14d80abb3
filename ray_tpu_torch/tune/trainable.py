"""Trainable: the unit a Tune trial runs (class API).

A copy of ``ray_tpu/tune/trainable.py``'s ``Trainable`` (reference
parity: python/ray/tune/trainable/trainable.py: train :289, save :467,
restore :507): class trainables implement step/save_checkpoint/
load_checkpoint. Function trainables and ``tune.report`` wait for a
Tune slice of the port.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Subclass API: setup(config), step() -> metrics dict,
    save_checkpoint() -> state, load_checkpoint(state)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self._iteration = 0
        self._start = time.time()
        self.setup(self.config)

    # -- subclass hooks -----------------------------------------------------
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        return None

    def load_checkpoint(self, state: Any) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable supports in-place config swap
        (lets PBT exploit without restarting the trial)."""
        return False

    def cleanup(self) -> None:
        pass

    # -- caller-facing API --------------------------------------------------
    def train(self) -> Dict[str, Any]:
        result = self.step() or {}
        self._iteration += 1
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault("time_total_s", time.time() - self._start)
        result.setdefault(DONE, False)
        return result

    def save(self) -> Any:
        return {"iteration": self._iteration,
                "state": self.save_checkpoint()}

    def restore(self, payload: Any) -> None:
        self._iteration = payload["iteration"]
        self.load_checkpoint(payload["state"])

    def reset(self, new_config: Dict[str, Any]) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = dict(new_config)
        return ok

    def stop(self) -> None:
        self.cleanup()
