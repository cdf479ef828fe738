"""Block: the unit of data movement in ray_tpu_torch.data (counterpart of
``ray_tpu/data/block.py``).

A block is a dict of equal-length numpy columns (object dtype for
ragged/python values) held in the runtime's object store; in thread-worker
mode block hand-off between operators is zero-copy by construction. Numpy
columns are the right terminus for a CUDA feed: ``torch.from_numpy`` of a
contiguous ndarray shares its memory, and a pinned copy of it goes to the
card without a staging buffer. Nothing here imports pandas: a DataFrame is
recognised by its type's module name.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

# Non-dict rows (ds.from_items([1,2,3])) live in a single default column,
# like the reference's "item" column for simple datasets.
ITEM_COLUMN = "item"

Batch = dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class BlockMetadata:
    """Caller-side stats that travel with a block ref (reference:
    python/ray/data/block.py BlockMetadata)."""

    num_rows: int
    size_bytes: int
    schema: Optional[dict[str, str]] = None  # column -> dtype str


def _as_column(values: list) -> np.ndarray:
    try:
        return np.asarray(values)
    except ValueError:
        # ragged rows (variable-length lists/arrays): object column
        arr = np.empty(len(values), object)
        arr[:] = values
        return arr


class Block:
    """Immutable columnar block."""

    __slots__ = ("columns",)

    def __init__(self, columns: dict[str, np.ndarray]):
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged columns: {lens}")
        self.columns = columns

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_rows(rows: list) -> "Block":
        if not rows:
            return Block({})
        if isinstance(rows[0], dict):
            cols = {}
            for key in rows[0]:
                cols[key] = _as_column([r[key] for r in rows])
            return Block(cols)
        return Block({ITEM_COLUMN: _as_column(rows)})

    @staticmethod
    def from_batch(batch: Any) -> "Block":
        if isinstance(batch, Block):
            return batch
        if isinstance(batch, dict):
            return Block({k: np.asarray(v) for k, v in batch.items()})
        if isinstance(batch, np.ndarray):
            return Block({ITEM_COLUMN: batch})
        if _is_pandas(batch):
            return Block({c: batch[c].to_numpy() for c in batch.columns})
        raise TypeError(f"cannot build a block from {type(batch)}")

    @staticmethod
    def concat(blocks: list["Block"]) -> "Block":
        blocks = [b for b in blocks if b.num_rows > 0]
        if not blocks:
            return Block({})
        keys = list(blocks[0].columns)
        for b in blocks:
            if list(b.columns) != keys:
                raise ValueError(
                    f"cannot concat blocks with schemas {keys} vs {list(b.columns)}"
                )
        return Block(
            {k: np.concatenate([b.columns[k] for b in blocks]) for k in keys}
        )

    # -- accessors ----------------------------------------------------------

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def size_bytes(self) -> int:
        total = 0
        for v in self.columns.values():
            if v.dtype.kind == "O":
                total += sum(sys.getsizeof(x) for x in v[:64]) * max(1, len(v) // 64)
            else:
                total += v.nbytes
        return total

    def schema(self) -> dict[str, str]:
        return {k: str(v.dtype) for k, v in self.columns.items()}

    def metadata(self) -> BlockMetadata:
        return BlockMetadata(self.num_rows, self.size_bytes, self.schema())

    def slice(self, start: int, stop: int) -> "Block":
        return Block({k: v[start:stop] for k, v in self.columns.items()})

    def take_indices(self, idx: np.ndarray) -> "Block":
        return Block({k: v[idx] for k, v in self.columns.items()})

    def to_batch(self) -> Batch:
        return dict(self.columns)

    def iter_rows(self) -> Iterator[Any]:
        cols = self.columns
        if list(cols) == [ITEM_COLUMN]:
            yield from cols[ITEM_COLUMN]
            return
        for i in range(self.num_rows):
            yield {k: v[i] for k, v in cols.items()}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: list(v) if v.ndim > 1 else v for k, v in self.columns.items()})

    # -- compute helpers used by physical operators -------------------------

    def sort_by(self, keys: list[str], descending: bool = False) -> "Block":
        if self.num_rows == 0:
            return self
        order = np.lexsort([self.columns[k] for k in reversed(keys)])
        if descending:
            order = order[::-1]
        return self.take_indices(order)

    def __repr__(self):
        return f"Block({self.schema()}, num_rows={self.num_rows})"


def _is_pandas(x) -> bool:
    mod = getattr(type(x), "__module__", "")
    return mod.startswith("pandas") and type(x).__name__ == "DataFrame"


def batch_to_output(out: Any) -> Block:
    """Normalize a user map_batches return value to a Block."""
    return Block.from_batch(out)


def iter_batches_from_blocks(
    blocks: Iterable[Block],
    batch_size: Optional[int],
    *,
    drop_last: bool = False,
) -> Iterator[Block]:
    """Re-batch a block stream to exactly batch_size rows (coalescing across
    block boundaries). batch_size=None yields blocks as-is."""
    if batch_size is None:
        for b in blocks:
            if b.num_rows:
                yield b
        return
    # merged-once cursor: emitting a batch slices views out of the current
    # merged buffer instead of rebuilding the remainder (keeps iteration
    # linear in total rows, not quadratic per block).
    buf: list[Block] = []
    buffered = 0
    merged: Optional[Block] = None
    offset = 0
    for b in blocks:
        if b.num_rows == 0:
            continue
        buf.append(b)
        buffered += b.num_rows
        if buffered < batch_size:
            continue
        if merged is not None and offset < merged.num_rows:
            buf.insert(0, merged.slice(offset, merged.num_rows))
        merged = buf[0] if len(buf) == 1 else Block.concat(buf)
        offset = 0
        buf, buffered = [], 0
        while merged.num_rows - offset >= batch_size:
            yield merged.slice(offset, offset + batch_size)
            offset += batch_size
        buffered = merged.num_rows - offset
    tail = []
    if merged is not None and offset < merged.num_rows:
        tail.append(merged.slice(offset, merged.num_rows))
    tail.extend(buf)
    if tail and not drop_last:
        yield Block.concat(tail)
