"""Ids, logging and the config flag registry (counterpart of ``ray_tpu/utils``)."""

from ray_tpu_torch.utils.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch.utils.logging import get_logger

__all__ = [
    "ActorID",
    "JobID",
    "NodeID",
    "ObjectID",
    "PlacementGroupID",
    "TaskID",
    "WorkerID",
    "get_logger",
]
