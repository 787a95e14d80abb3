"""Trainable: the unit a Tune trial actor runs.

The port's copy of ``ray_tpu/tune/trainable.py``. Reference parity: python/ray/tune/trainable/trainable.py (Trainable.train
:289, save :467, restore :507) and function_trainable.py (user function in
a thread, reports bridged over a queue). Class trainables implement
step/save_checkpoint/load_checkpoint; function trainables call
tune.report() and are driven one-report-per-train() for scheduler
decisions (ASHA/PBT need per-iteration control).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

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
        (lets PBT exploit without restarting the actor)."""
        return False

    def cleanup(self) -> None:
        pass

    # -- driver-facing API (called remotely by the controller) --------------
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


class _FnReporter:
    def __init__(self):
        self.queue: "queue.Queue" = queue.Queue()
        self.continue_event = threading.Event()

    def report(self, metrics: Dict[str, Any],
               checkpoint: Any = None) -> None:
        self.queue.put(("report", dict(metrics), checkpoint))
        # Block the user loop until the controller consumes the report —
        # gives schedulers per-iteration pause/stop control.
        self.continue_event.wait()
        self.continue_event.clear()


_fn_reporter: Optional[_FnReporter] = None


def report(metrics: Dict[str, Any], checkpoint: Any = None) -> None:
    """tune.report from inside a function trainable."""
    if _fn_reporter is None:
        raise RuntimeError("tune.report() called outside a Tune trial")
    _fn_reporter.report(metrics, checkpoint)


def get_checkpoint() -> Any:
    return getattr(_fn_reporter, "starting_checkpoint", None)


class FunctionTrainable(Trainable):
    """Wraps fn(config) into the Trainable step protocol.

    Pause/resume contract (same as the reference's function trainables):
    on resume the user function restarts from its beginning in a fresh
    actor — it must call tune.get_checkpoint() and fast-forward from the
    restored state, reporting checkpoints via tune.report(..., checkpoint=)
    at rung-relevant milestones. A function that ignores checkpoints will
    redo its pre-pause work."""

    _fn: Callable[[Dict[str, Any]], Any] = None  # set by wrap_function

    def setup(self, config: Dict[str, Any]) -> None:
        self._reporter = _FnReporter()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_checkpoint: Any = None

    def _runner(self) -> None:
        global _fn_reporter
        _fn_reporter = self._reporter
        try:
            type(self)._fn(self.config)
        except BaseException as exc:  # surfaced from step()
            self._error = exc
        finally:
            self._reporter.queue.put(("finished", None, None))

    def step(self) -> Dict[str, Any]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._runner, daemon=True)
            self._thread.start()
        kind, metrics, checkpoint = self._reporter.queue.get()
        if kind == "finished":
            if self._error is not None:
                raise self._error
            return {DONE: True}
        if checkpoint is not None:
            self._last_checkpoint = checkpoint
        self._reporter.continue_event.set()
        return metrics

    def save_checkpoint(self) -> Any:
        return self._last_checkpoint

    def load_checkpoint(self, state: Any) -> None:
        self._reporter.starting_checkpoint = state


def wrap_function(fn: Callable[[Dict[str, Any]], Any]) -> type:
    return type(f"fn_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})
