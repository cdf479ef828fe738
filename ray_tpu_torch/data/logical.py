"""Logical plan: what the user asked for, before physical planning.

Mirrors the reference's logical-operator layer
(python/ray/data/_internal/logical/) — a linear op chain per Dataset,
with Union/Zip referencing other chains. The streaming executor
(ray_tpu_torch.data.executor) lowers each op to a physical operator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

from ray_tpu_torch.data.aggregate import AggregateFn
from ray_tpu_torch.data.datasource import Datasource


@dataclasses.dataclass
class ComputeStrategy:
    """Tasks by default; ActorPoolStrategy pins a pool of stateful workers
    (reference: python/ray/data/_internal/compute.py)."""


@dataclasses.dataclass
class TaskPoolStrategy(ComputeStrategy):
    pass


@dataclasses.dataclass
class ActorPoolStrategy(ComputeStrategy):
    size: int = 2


@dataclasses.dataclass
class LogicalOp:
    pass


@dataclasses.dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1


@dataclasses.dataclass
class MapBatches(LogicalOp):
    fn: Any  # callable or callable class
    batch_size: Optional[int] = None
    compute: Optional[ComputeStrategy] = None
    fn_args: tuple = ()
    fn_kwargs: dict = dataclasses.field(default_factory=dict)
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: dict = dataclasses.field(default_factory=dict)
    num_cpus: Optional[float] = None
    zero_copy_batch: bool = True


@dataclasses.dataclass
class MapRows(LogicalOp):
    fn: Callable
    compute: Optional[ComputeStrategy] = None


@dataclasses.dataclass
class Filter(LogicalOp):
    fn: Callable
    compute: Optional[ComputeStrategy] = None


@dataclasses.dataclass
class FlatMap(LogicalOp):
    fn: Callable
    compute: Optional[ComputeStrategy] = None


@dataclasses.dataclass
class Repartition(LogicalOp):
    num_blocks: int
    shuffle: bool = False


@dataclasses.dataclass
class RandomShuffle(LogicalOp):
    seed: Optional[int] = None


@dataclasses.dataclass
class Sort(LogicalOp):
    keys: Sequence[str]
    descending: bool = False


@dataclasses.dataclass
class GroupByAggregate(LogicalOp):
    keys: Sequence[str]
    aggs: Sequence[AggregateFn]


@dataclasses.dataclass
class Limit(LogicalOp):
    n: int


@dataclasses.dataclass
class Union(LogicalOp):
    others: list  # list[LogicalPlan]


@dataclasses.dataclass
class Zip(LogicalOp):
    other: Any  # LogicalPlan


@dataclasses.dataclass
class LogicalPlan:
    ops: list[LogicalOp]

    def then(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])
