"""Dataset: the public data API (reference: python/ray/data/dataset.py;
counterpart of ``ray_tpu/data/dataset.py``, with ``iter_device_batches``
in place of ``iter_jax_batches``).

Lazy: every transform appends a logical op; execution happens on
iteration/consumption through the streaming executor, so pipelines
stream blocks through task/actor pools with backpressure instead of
materializing. `materialize()` pins the block list for reuse.
"""

from __future__ import annotations

import builtins
import os
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from ray_tpu_torch.core import api
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum
from ray_tpu_torch.data.block import ITEM_COLUMN, Block, BlockMetadata
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    TextDatasource,
    write_csv_block,
    write_json_block,
    write_parquet_block,
)
from ray_tpu_torch.data.executor import ExecStats, aggregate_global, execute_plan
from ray_tpu_torch.data.iterator import DataIterator, StreamSplitIterator

ActorPoolStrategy = L.ActorPoolStrategy


class Dataset:
    def __init__(self, plan: L.LogicalPlan, materialized: Optional[list] = None):
        self._plan = plan
        self._materialized = materialized  # list[(ref, meta)] when pinned
        self._stats = ExecStats()

    # -- execution ----------------------------------------------------------

    def _ref_metas(self) -> Iterator[tuple]:
        if self._materialized is not None:
            return iter(self._materialized)
        return execute_plan(self._plan, self._stats)

    def materialize(self) -> "Dataset":
        """Execute now; the result holds pinned block refs."""
        if self._materialized is not None:
            return self
        return Dataset(self._plan, materialized=list(self._ref_metas()))

    def stats(self) -> str:
        return self._stats.summary()

    # -- transforms (lazy) --------------------------------------------------

    def _with(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(self._plan.then(op))

    def map_batches(
        self,
        fn,
        *,
        batch_size: Optional[int] = None,
        compute=None,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
        num_cpus: Optional[float] = None,
        concurrency: Optional[int] = None,
        **_ignored,
    ) -> "Dataset":
        # a callable CLASS is stateful per-worker by definition: default it
        # onto an actor pool (reference: map_batches requires concurrency/
        # ActorPoolStrategy for classes) instead of constructing per batch
        if isinstance(fn, type) and compute is None:
            compute = L.ActorPoolStrategy(size=concurrency or 1)
        return self._with(
            L.MapBatches(
                fn,
                batch_size=batch_size,
                compute=compute,
                fn_args=fn_args,
                fn_kwargs=fn_kwargs or {},
                fn_constructor_args=fn_constructor_args,
                fn_constructor_kwargs=fn_constructor_kwargs or {},
                num_cpus=num_cpus,
            )
        )

    def map(self, fn, *, compute=None) -> "Dataset":
        return self._with(L.MapRows(fn, compute=compute))

    def filter(self, fn, *, compute=None) -> "Dataset":
        return self._with(L.Filter(fn, compute=compute))

    def flat_map(self, fn, *, compute=None) -> "Dataset":
        return self._with(L.FlatMap(fn, compute=compute))

    def add_column(self, name: str, fn) -> "Dataset":
        def add(batch):
            batch = dict(batch)
            batch[name] = fn(batch)
            return batch

        return self.map_batches(add)

    def drop_columns(self, cols: Sequence[str]) -> "Dataset":
        return self.map_batches(
            lambda b, _c=tuple(cols): {k: v for k, v in b.items() if k not in _c}
        )

    def select_columns(self, cols: Sequence[str]) -> "Dataset":
        return self.map_batches(
            lambda b, _c=tuple(cols): {k: b[k] for k in _c}
        )

    def rename_columns(self, mapping: dict) -> "Dataset":
        return self.map_batches(
            lambda b, _m=dict(mapping): {_m.get(k, k): v for k, v in b.items()}
        )

    def repartition(self, num_blocks: int, *, shuffle: bool = False) -> "Dataset":
        return self._with(L.Repartition(num_blocks, shuffle=shuffle))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(L.RandomShuffle(seed=seed))

    def sort(self, key: Union[str, Sequence[str]], descending: bool = False) -> "Dataset":
        keys = [key] if isinstance(key, str) else list(key)
        return self._with(L.Sort(keys, descending=descending))

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(L.Union([o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(L.Zip(other._plan))

    def groupby(self, key: Union[str, Sequence[str]]) -> "GroupedData":
        keys = [key] if isinstance(key, str) else list(key)
        return GroupedData(self, keys)

    def random_split(
        self, fractions: list[float], *, seed: Optional[int] = None
    ) -> list["Dataset"]:
        mat = self.materialize()
        rows = list(mat.iter_rows())
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(rows))
        bounds = np.cumsum([0.0] + list(fractions))
        if abs(bounds[-1] - 1.0) > 1e-6:
            raise ValueError("fractions must sum to 1")
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            idx = perm[int(lo * len(rows)) : int(hi * len(rows))]
            out.append(from_items([rows[i] for i in idx]))
        return out

    def split(self, n: int) -> list["Dataset"]:
        mat = self.materialize()
        rows = list(mat.iter_rows())
        bounds = np.linspace(0, len(rows), n + 1).astype(int)
        return [from_items(rows[lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]

    # -- consumption --------------------------------------------------------

    def iterator(self) -> DataIterator:
        return DataIterator(self._ref_metas)

    def iter_rows(self):
        return self.iterator().iter_rows()

    def iter_batches(self, **kw):
        return self.iterator().iter_batches(**kw)

    def iter_device_batches(self, **kw):
        return self.iterator().iter_device_batches(**kw)

    def iter_torch_batches(self, **kw):
        return self.iterator().iter_torch_batches(**kw)

    def iter_internal_blocks(self) -> Iterator[Block]:
        for ref, _ in self._ref_metas():
            yield api.get(ref)

    def streaming_split(self, n: int, *, equal: bool = True) -> list[DataIterator]:
        """n concurrent iterators over one shared execution (reference:
        dataset.py:1598 — the Train integration point)."""
        splitter = StreamSplitIterator(self._ref_metas, n, equal)
        return [splitter.split(i) for i in builtins.range(n)]

    def take(self, n: int = 20) -> list:
        out = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        return sum(m.num_rows for _, m in self._ref_metas())

    def schema(self) -> Optional[dict[str, str]]:
        for _, meta in self._ref_metas():
            if meta.schema:
                return meta.schema
        return None

    def columns(self) -> Optional[list[str]]:
        s = self.schema()
        return list(s) if s else None

    def num_blocks(self) -> int:
        return sum(1 for _ in self._ref_metas())

    def size_bytes(self) -> int:
        return sum(m.size_bytes for _, m in self._ref_metas())

    def aggregate(self, *aggs: AggregateFn) -> dict:
        inputs = list(self._ref_metas())
        vals = aggregate_global(inputs, list(aggs))
        return {a.name: v for a, v in zip(aggs, vals)}

    def sum(self, on: Optional[str] = None):
        return self.aggregate(Sum(on))[f"sum({on or ''})"]

    def min(self, on: Optional[str] = None):
        return self.aggregate(Min(on))[f"min({on or ''})"]

    def max(self, on: Optional[str] = None):
        return self.aggregate(Max(on))[f"max({on or ''})"]

    def mean(self, on: Optional[str] = None):
        return self.aggregate(Mean(on))[f"mean({on or ''})"]

    def std(self, on: Optional[str] = None):
        return self.aggregate(Std(on))[f"std({on or ''})"]

    def to_pandas(self):
        blocks = list(self.iter_internal_blocks())
        return Block.concat(blocks).to_pandas()

    # -- writers ------------------------------------------------------------

    def _write(self, path: str, writer, ext: str) -> None:
        os.makedirs(path, exist_ok=True)
        write = api.remote(
            lambda block, p: (writer(block, p), None)[1]
        )
        refs = []
        for i, (ref, _) in enumerate(self._ref_metas()):
            out = os.path.join(path, f"part-{i:05d}.{ext}")
            # pass the ref: the task resolves it from the object store
            # (blocks never round-trip through the caller)
            refs.append(write.remote(ref, out))
        api.get(refs)

    def write_csv(self, path: str) -> None:
        self._write(path, write_csv_block, "csv")

    def write_json(self, path: str) -> None:
        self._write(path, write_json_block, "json")

    def write_parquet(self, path: str) -> None:
        self._write(path, write_parquet_block, "parquet")

    def __repr__(self):
        ops = " -> ".join(type(o).__name__ for o in self._plan.ops)
        return f"Dataset({ops})"


class GroupedData:
    def __init__(self, ds: Dataset, keys: list[str]):
        self._ds = ds
        self._keys = keys

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return self._ds._with(L.GroupByAggregate(self._keys, list(aggs)))

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Std(on))

    def map_groups(self, fn) -> Dataset:
        keys = self._keys

        def per_group(batch):
            block = Block.from_batch(batch)
            tags = [
                tuple(block.columns[k][i] for k in keys)
                for i in builtins.range(block.num_rows)
            ]
            by_tag: dict = {}
            for i, tag in enumerate(tags):
                by_tag.setdefault(tag, []).append(i)
            outs = []
            for idx in by_tag.values():
                group = block.take_indices(np.asarray(idx))
                outs.append(Block.from_batch(fn(group.to_batch())))
            return Block.concat(outs).to_batch()

        # group rows together first via a sort exchange, then map per group
        return self._ds.sort(keys[0]).map_batches(per_group, batch_size=None)


# ---------------------------------------------------------------------------
# constructors (module-level API, reference: ray.data.range etc.)
# ---------------------------------------------------------------------------


def _read(ds: Datasource, parallelism: int = -1) -> Dataset:
    return Dataset(L.LogicalPlan([L.Read(ds, parallelism)]))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return _read(RangeDatasource(n), parallelism)


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    return _read(ItemsDatasource(items), parallelism)


def from_numpy(arrays: Union[np.ndarray, dict], *, parallelism: int = -1) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = {ITEM_COLUMN: arrays}
    return _read(NumpyDatasource(arrays), parallelism)


def from_pandas(df) -> Dataset:
    return _read(NumpyDatasource({c: df[c].to_numpy() for c in df.columns}))


def read_csv(paths, *, parallelism: int = -1) -> Dataset:
    return _read(CSVDatasource(paths), parallelism)


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    return _read(JSONDatasource(paths), parallelism)


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    return _read(TextDatasource(paths), parallelism)


def read_parquet(paths, *, parallelism: int = -1) -> Dataset:
    return _read(ParquetDatasource(paths), parallelism)


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return _read(BinaryDatasource(paths), parallelism)


def read_datasource(ds: Datasource, *, parallelism: int = -1) -> Dataset:
    return _read(ds, parallelism)


def read_tfrecords(paths, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasources_ext import TFRecordDatasource

    return _read(TFRecordDatasource(paths), parallelism)


def read_arrow(paths, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasources_ext import ArrowDatasource

    return _read(ArrowDatasource(paths), parallelism)


def read_sql(sql: str, connection_factory, *, parallelism_queries=None,
             parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasources_ext import SQLDatasource

    return _read(
        SQLDatasource(sql, connection_factory, parallelism_queries), parallelism
    )


def read_images(paths, *, size=None, mode="RGB", parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasources_ext import ImageDatasource

    return _read(ImageDatasource(paths, size=size, mode=mode), parallelism)


def read_webdataset(paths, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasources_ext import WebDatasetDatasource

    return _read(WebDatasetDatasource(paths), parallelism)


def from_arrow(tables) -> Dataset:
    """Datasets from in-memory pyarrow Tables (reference: from_arrow) —
    dtype-preserving (columns convert via to_numpy, not a row round trip)."""
    from ray_tpu_torch.data.datasources_ext import block_from_arrow

    if not isinstance(tables, (list, tuple)):
        tables = [tables]
    merged = Block.concat([block_from_arrow(t) for t in tables])
    return _read(NumpyDatasource(dict(merged.columns)))
