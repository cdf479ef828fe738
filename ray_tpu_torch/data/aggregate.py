"""Aggregations for Dataset.groupby / Dataset.aggregate.

Same accumulate/merge/finalize shape as the reference
(python/ray/data/aggregate.py) so distributed two-phase aggregation
(per-block partial → cross-block merge) works over the task runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.data.block import Block


@dataclasses.dataclass
class AggregateFn:
    name: str
    init: Callable[[], Any]
    accumulate_block: Callable[[Any, Block], Any]  # (acc, block) -> acc
    merge: Callable[[Any, Any], Any]
    finalize: Callable[[Any], Any] = lambda a: a


def _col(block: Block, on: Optional[str]) -> np.ndarray:
    if on is None:
        cols = list(block.columns)
        if len(cols) != 1:
            raise ValueError(f"aggregation needs on= with multiple columns {cols}")
        on = cols[0]
    return block.columns[on]


def Count() -> AggregateFn:
    return AggregateFn(
        name="count()",
        init=lambda: 0,
        accumulate_block=lambda a, b: a + b.num_rows,
        merge=lambda a, b: a + b,
    )


def _np_agg(name, npfn, on, merge, finalize=lambda a: a):
    def acc(a, block):
        col = _col(block, on)
        if len(col) == 0:
            return a
        val = npfn(col)
        return val if a is None else merge(a, val)

    return AggregateFn(
        name=f"{name}({on or ''})",
        init=lambda: None,
        accumulate_block=acc,
        merge=lambda a, b: b if a is None else (a if b is None else merge(a, b)),
        finalize=lambda a: None if a is None else finalize(a),
    )


def Sum(on: Optional[str] = None) -> AggregateFn:
    return _np_agg("sum", np.sum, on, lambda a, b: a + b)


def Min(on: Optional[str] = None) -> AggregateFn:
    return _np_agg("min", np.min, on, min)


def Max(on: Optional[str] = None) -> AggregateFn:
    return _np_agg("max", np.max, on, max)


def Mean(on: Optional[str] = None) -> AggregateFn:
    def acc(a, block):
        col = _col(block, on)
        s, n = a
        return (s + (np.sum(col) if len(col) else 0.0), n + len(col))

    return AggregateFn(
        name=f"mean({on or ''})",
        init=lambda: (0.0, 0),
        accumulate_block=acc,
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda a: None if a[1] == 0 else a[0] / a[1],
    )


def Std(on: Optional[str] = None, ddof: int = 1) -> AggregateFn:
    # Chan et al. parallel variance: track (n, mean, M2).
    def acc(a, block):
        col = np.asarray(_col(block, on), np.float64)
        if len(col) == 0:
            return a
        b = (len(col), float(np.mean(col)), float(np.var(col) * len(col)))
        return _merge(a, b)

    def _merge(a, b):
        if a[0] == 0:
            return b
        if b[0] == 0:
            return a
        n = a[0] + b[0]
        delta = b[1] - a[1]
        mean = a[1] + delta * b[0] / n
        m2 = a[2] + b[2] + delta * delta * a[0] * b[0] / n
        return (n, mean, m2)

    return AggregateFn(
        name=f"std({on or ''})",
        init=lambda: (0, 0.0, 0.0),
        accumulate_block=acc,
        merge=_merge,
        finalize=lambda a: None if a[0] <= ddof else float(np.sqrt(a[2] / (a[0] - ddof))),
    )
