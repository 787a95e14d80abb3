"""User-visible exception types.

Reference parity: python/ray/exceptions.py (RayError hierarchy).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ray_tpu_torch.get()."""

    def __init__(self, task_name: str, remote_traceback: str,
                 cause: Exception | None = None):
        self.task_name = task_name
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(
            f"task {task_name!r} failed:\n{remote_traceback}")

    def __reduce__(self):
        return (type(self), (self.task_name, self.remote_traceback, None))


class ActorError(TaskError):
    """An actor method raised an exception."""


class ActorDiedError(RayTpuError):
    """The actor is dead (killed, crashed, or owner exited)."""

    def __init__(self, actor_id: str, reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"actor {actor_id[:12]} is dead. {reason}")

    def __reduce__(self):
        return (type(self), (self.actor_id, self.reason))


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class OutOfMemoryError(WorkerCrashedError):
    """The node memory monitor killed this worker to relieve memory
    pressure (reference parity: ray.exceptions.OutOfMemoryError /
    src/ray/common/memory_monitor.h:52). Subclasses WorkerCrashedError so
    the task-retry machinery treats OOM kills as retriable crashes."""


class ObjectLostError(RayTpuError):
    """The object's value is unreachable (owner or storing node gone)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get() timed out."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before/while running."""


class InfeasibleResourceError(RayTpuError):
    """No node in the cluster can ever satisfy the resource request."""


class RuntimeEnvSetupError(RayTpuError):
    """Failed to set up the runtime environment for a task/actor."""


class PlacementGroupUnavailableError(RayTpuError):
    """The referenced placement group was removed or could not be created."""
