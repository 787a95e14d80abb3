"""Per-worker training session: report/get_checkpoint/get_context.

The port's copy of ``ray_tpu/train/session.py`` (reference parity:
python/ray/train/_internal/session.py: _TrainSession, report :405/:672,
get_checkpoint :786) — simplified to a module-global
session living inside each TrainWorker actor; reports are buffered on the
actor and drained by the controller.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

from .checkpoint import Checkpoint


@dataclasses.dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    storage_path: str
    group_name: str


class _Session:
    def __init__(self, context: TrainContext,
                 starting_checkpoint: Optional[Checkpoint]):
        self.context = context
        self.starting_checkpoint = starting_checkpoint
        self.reports: List[Dict[str, Any]] = []
        self.lock = threading.Lock()
        self.finished = False

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        with self.lock:
            self.reports.append({"metrics": dict(metrics),
                                 "checkpoint": checkpoint})

    def drain(self) -> List[Dict[str, Any]]:
        with self.lock:
            out, self.reports = self.reports, []
            return out


_session: Optional[_Session] = None


def _set_session(session: Optional[_Session]) -> None:
    global _session
    _session = session


def _get_session() -> _Session:
    if _session is None:
        raise RuntimeError(
            "no train session active; this API must be called inside a "
            "train_loop_per_worker")
    return _session


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) from a worker."""
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from, if any."""
    return _get_session().starting_checkpoint


def get_context() -> TrainContext:
    return _get_session().context


def get_world_rank() -> int:
    return _get_session().context.world_rank


def get_world_size() -> int:
    return _get_session().context.world_size


def get_local_rank() -> int:
    return _get_session().context.local_rank
