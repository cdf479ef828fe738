"""Task specification (counterpart of ``ray_tpu/core/task.py``; upstream
Ray's TaskSpecification, src/ray/common/task/task_spec.h, slimmed: specs
stay in one process, so they carry the callable and its arguments by
reference). The accelerator resource is ``num_gpus`` -> ``"GPU"``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.utils.ids import ActorID, ObjectID, TaskID


@dataclasses.dataclass
class TaskOptions:
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: dict = dataclasses.field(default_factory=dict)
    num_returns: int | str = 1  # int or "streaming"
    max_retries: int = 3
    retry_exceptions: bool = False
    name: Optional[str] = None
    placement_group: Optional[Any] = None  # PlacementGroup
    placement_group_bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    # {env_vars, working_dir, py_modules}: needs worker processes, which
    # the in-process thread runtime does not have (setting it raises)
    runtime_env: Optional[dict] = None

    def resource_set(self) -> ResourceSet:
        req = dict(self.resources)
        if self.num_cpus:
            req["CPU"] = req.get("CPU", 0) + self.num_cpus
        if self.num_gpus:
            req["GPU"] = req.get("GPU", 0) + self.num_gpus
        return ResourceSet(req)


@dataclasses.dataclass
class ActorOptions:
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: dict = dataclasses.field(default_factory=dict)
    name: Optional[str] = None
    get_if_exists: bool = False
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    lifetime: Optional[str] = None  # None | "detached"
    placement_group: Optional[Any] = None
    placement_group_bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    runtime_env: Optional[dict] = None

    def resource_set(self) -> ResourceSet:
        req = dict(self.resources)
        if self.num_cpus:
            req["CPU"] = req.get("CPU", 0) + self.num_cpus
        if self.num_gpus:
            req["GPU"] = req.get("GPU", 0) + self.num_gpus
        return ResourceSet(req)


@dataclasses.dataclass
class TaskSpec:
    task_id: TaskID
    func: Callable  # already bound/unpickled in-process
    args: tuple
    kwargs: dict
    options: TaskOptions
    return_ids: list[ObjectID] = dataclasses.field(default_factory=list)
    # actor tasks
    actor_id: Optional[ActorID] = None
    method_name: Optional[str] = None
    # bookkeeping
    attempt: int = 0
    streaming: bool = False
    # submitter's TraceContext as a dict (ray_tpu_torch.obs.context): attached
    # around execution so task events + nested calls carry the trace
    trace: Optional[dict] = None
    # process mode: the cards this attempt was granted (indices into the
    # runtime's own "GPU" cards); its worker's CUDA_VISIBLE_DEVICES names them
    gpu_ids: Optional[tuple] = None

    def describe(self) -> str:
        # cached: called on every event record / error message
        d = getattr(self, "_describe", None)
        if d is None:
            name = self.options.name or getattr(self.func, "__name__", "task")
            if self.method_name:
                name = f"{name}.{self.method_name}"
            d = f"{name}[{self.task_id.hex()[:8]}]"
            object.__setattr__(self, "_describe", d)
        return d
