"""User-visible error types (counterpart of ``ray_tpu/core/errors.py``;
upstream Ray's python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised an exception; carries the formatted remote traceback."""

    def __init__(self, cause: BaseException, remote_tb: str, task_desc: str = ""):
        self.cause = cause
        self.remote_tb = remote_tb
        self.task_desc = task_desc
        super().__init__(f"task {task_desc} failed: {cause!r}\n--- remote traceback ---\n{remote_tb}")


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died (e.g. OOM-killed)."""


class ActorDiedError(RayTpuError):
    """Method called on an actor that is dead (ctor failed, killed, or crashed
    past its restart budget)."""


class ActorUnavailableError(RayTpuError):
    """Actor temporarily unavailable (restarting)."""


class ObjectLostError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class PlacementGroupUnavailableError(RayTpuError):
    pass
