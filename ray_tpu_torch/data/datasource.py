"""Datasources: parallel read task generation (reference:
python/ray/data/_internal/datasource/ — 38 modules; here the core set,
each a thin ReadTask factory so reads parallelize over the task runtime).
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import io
import json
import os
from typing import Any, Callable, Iterable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import ITEM_COLUMN, Block, BlockMetadata


@dataclasses.dataclass
class ReadTask:
    """A no-arg callable producing blocks, plus a size estimate for the
    optimizer. Executed remotely by the read operator."""

    fn: Callable[[], Iterable[Block]]
    estimated_rows: Optional[int] = None

    def __call__(self) -> Iterable[Block]:
        return self.fn()


class Datasource:
    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimated_num_rows(self) -> Optional[int]:
        return None


class RangeDatasource(Datasource):
    def __init__(self, n: int, use_column: bool = True):
        self.n = n
        self.use_column = use_column

    def estimated_num_rows(self):
        return self.n

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        splits = np.array_split(np.arange(self.n, dtype=np.int64), parallelism)

        def make(chunk):
            return ReadTask(
                lambda: [Block({ITEM_COLUMN: chunk})], estimated_rows=len(chunk)
            )

        return [make(c) for c in splits if len(c) or parallelism == 1]


class ItemsDatasource(Datasource):
    def __init__(self, items: list):
        self.items = list(items)

    def estimated_num_rows(self):
        return len(self.items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = len(self.items)
        parallelism = max(1, min(parallelism, n or 1))
        bounds = np.linspace(0, n, parallelism + 1).astype(int)

        def make(lo, hi):
            chunk = self.items[lo:hi]
            return ReadTask(
                lambda: [Block.from_rows(chunk)], estimated_rows=len(chunk)
            )

        return [make(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo or n == 0]


class NumpyDatasource(Datasource):
    def __init__(self, arrays: dict[str, np.ndarray]):
        self.arrays = arrays

    def estimated_num_rows(self):
        return len(next(iter(self.arrays.values()))) if self.arrays else 0

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n = self.estimated_num_rows()
        parallelism = max(1, min(parallelism, n or 1))
        bounds = np.linspace(0, n, parallelism + 1).astype(int)

        def make(lo, hi):
            chunk = {k: v[lo:hi] for k, v in self.arrays.items()}
            return ReadTask(lambda: [Block(chunk)], estimated_rows=hi - lo)

        return [make(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo or n == 0]


def _expand_paths(paths) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class FileDatasource(Datasource):
    """One read task per file (files are the natural parallelism unit)."""

    def __init__(self, paths):
        self.paths = _expand_paths(paths)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        return [ReadTask(lambda p=p: self._read_file(p)) for p in self.paths]

    def _read_file(self, path: str) -> Iterable[Block]:
        raise NotImplementedError


class CSVDatasource(FileDatasource):
    def _read_file(self, path):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        # numeric inference column-wise
        if rows:
            block = Block.from_rows(rows)
            cols = {}
            for k, v in block.columns.items():
                try:
                    cols[k] = v.astype(np.int64)
                except (ValueError, TypeError):
                    try:
                        cols[k] = v.astype(np.float64)
                    except (ValueError, TypeError):
                        cols[k] = v
            return [Block(cols)]
        return [Block({})]


class JSONDatasource(FileDatasource):
    """JSONL or a top-level JSON array per file."""

    def _read_file(self, path):
        with open(path) as f:
            text = f.read().strip()
        if not text:
            return [Block({})]
        if text.startswith("["):
            rows = json.loads(text)
        else:
            rows = [json.loads(line) for line in text.splitlines() if line.strip()]
        return [Block.from_rows(rows)]


class TextDatasource(FileDatasource):
    def _read_file(self, path):
        with open(path) as f:
            lines = [line.rstrip("\n") for line in f]
        return [Block({"text": np.array(lines, dtype=object)})]


class ParquetDatasource(FileDatasource):
    def _read_file(self, path):
        pq = _require_pyarrow_parquet()
        table = pq.read_table(path)
        return [
            Block({name: table.column(name).to_numpy(zero_copy_only=False)
                   for name in table.column_names})
        ]


class BinaryDatasource(FileDatasource):
    def _read_file(self, path):
        with open(path, "rb") as f:
            data = f.read()
        return [Block({"bytes": np.array([data], dtype=object),
                       "path": np.array([path], dtype=object)})]


def _require_pyarrow_parquet():
    try:
        import pyarrow.parquet as pq  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover - env without pyarrow
        raise ImportError(
            "read_parquet/write_parquet require pyarrow, which is not "
            "installed in this environment"
        ) from e
    return pq


# -- writers (one file per block, executed as remote tasks) -----------------


def write_csv_block(block: Block, path: str) -> None:
    cols = list(block.columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(block.num_rows):
            w.writerow([block.columns[c][i] for c in cols])


def write_json_block(block: Block, path: str) -> None:
    with open(path, "w") as f:
        for row in block.iter_rows():
            if not isinstance(row, dict):
                row = {ITEM_COLUMN: row}
            f.write(json.dumps({k: _json_safe(v) for k, v in row.items()}) + "\n")


def write_parquet_block(block: Block, path: str) -> None:
    pq = _require_pyarrow_parquet()
    import pyarrow as pa

    table = pa.table({k: list(v) for k, v in block.columns.items()})
    pq.write_table(table, path)


def _json_safe(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v
