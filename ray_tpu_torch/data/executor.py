"""Streaming executor: lowers a LogicalPlan to remote tasks/actor pools.

Reference: python/ray/data/_internal/execution/streaming_executor.py — a
pull-based scheduling loop with backpressure. Here the pull chain *is*
the Python generator stack: each physical operator is a generator over
(block_ref, metadata) pairs that keeps at most `window` tasks in flight,
so downstream consumption rate bounds upstream submission (backpressure
without a central controller). All-to-all ops (shuffle/sort/groupby/
repartition) are barriers, implemented as classic two-phase map/reduce
exchanges over the task runtime — the same design as the reference's
push-based shuffle scheduler: on a cluster each merge runs on the node
holding most of its partition's split outputs.

Counterpart of ``ray_tpu/data/executor.py``. On the port's in-process
runtime tasks and actors are threads and blocks pass by reference; with
the driver attached to a cluster (``init(address=)``) they are worker
processes and blocks move through the nodes' object stores.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from ray_tpu_torch.core import api
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.aggregate import AggregateFn
from ray_tpu_torch.data.block import Block, BlockMetadata, iter_batches_from_blocks

RefMeta = tuple  # (ObjectRef[Block], BlockMetadata)

DEFAULT_WINDOW = 8  # max in-flight tasks per operator


# ---------------------------------------------------------------------------
# remote task bodies (plain functions; wrapped by api.remote lazily so that
# importing ray_tpu_torch.data never boots the runtime)
# ---------------------------------------------------------------------------


def _exec_read(task) -> tuple:
    blocks = [b for b in task() if b.num_rows > 0]
    block = blocks[0] if len(blocks) == 1 else Block.concat(blocks)
    return block, block.metadata()


def _exec_map(fn, *blocks) -> tuple:
    out = fn(Block.concat(list(blocks)) if len(blocks) != 1 else blocks[0])
    return out, out.metadata()


def _exec_split(block, n: int, assign, block_idx: int):
    """Map side of an exchange: route each row to one of n partitions."""
    part = assign(block, block_idx)
    return tuple(block.take_indices(np.nonzero(part == j)[0]) for j in range(n))


def _exec_merge(postprocess, part_idx, *parts) -> tuple:
    out = Block.concat(list(parts))
    if postprocess is not None:
        out = postprocess(out, part_idx)
    return out, out.metadata()


def _exec_slices(slices, *blocks) -> tuple:
    """Reduce side of shuffle-free repartition: concat row ranges."""
    out = Block.concat([b.slice(lo, hi) for b, (lo, hi) in zip(blocks, slices)])
    return out, out.metadata()


def _exec_partial_agg(aggs: list[AggregateFn], block) -> list:
    return [a.accumulate_block(a.init(), block) for a in aggs]


_REMOTES: dict = {}


def _remote(fn, **opts):
    key = (fn, tuple(sorted(opts.items())))
    if key not in _REMOTES:
        _REMOTES[key] = api.remote(**opts)(fn) if opts else api.remote(fn)
    return _REMOTES[key]


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


class ExecStats:
    def __init__(self):
        self.ops: dict[str, dict] = {}

    def record(self, op: str, n_tasks: int = 0, n_blocks: int = 0, rows: int = 0):
        d = self.ops.setdefault(op, {"tasks": 0, "blocks": 0, "rows": 0})
        d["tasks"] += n_tasks
        d["blocks"] += n_blocks
        d["rows"] += rows

    def summary(self) -> str:
        lines = [f"{op}: {d}" for op, d in self.ops.items()]
        return "\n".join(lines) or "(no ops executed)"


# ---------------------------------------------------------------------------
# physical operators (generator-based)
# ---------------------------------------------------------------------------


def _windowed(submit: Callable[[Any], tuple], inputs: Iterable, window: int):
    """Submit with at most `window` outstanding; yield in submission order."""
    pending = collections.deque()
    for item in inputs:
        if len(pending) >= window:
            yield _resolve(pending.popleft())
        pending.append(submit(item))
    while pending:
        yield _resolve(pending.popleft())


def _resolve(refs) -> RefMeta:
    block_ref, meta_ref = refs
    return block_ref, api.get(meta_ref)


def _read_op(op: L.Read, stats: ExecStats, window: int) -> Iterator[RefMeta]:
    parallelism = op.parallelism if op.parallelism > 0 else 16
    tasks = op.datasource.get_read_tasks(parallelism)
    stats.record("read", n_tasks=len(tasks))
    run = _remote(_exec_read, num_returns=2)
    yield from _windowed(lambda t: run.remote(t), tasks, window)


def _make_block_fn(op: L.LogicalOp) -> Callable[[Block], Block]:
    """Lower a row/batch-level logical op to a Block -> Block function."""
    if isinstance(op, L.MapBatches):
        fn, args, kwargs = op.fn, op.fn_args, op.fn_kwargs
        batch_size = op.batch_size

        def run(block: Block, _fn=None) -> Block:
            f = _fn if _fn is not None else fn
            outs = [
                Block.from_batch(f(b.to_batch(), *args, **kwargs))
                for b in iter_batches_from_blocks([block], batch_size)
            ]
            return Block.concat(outs) if outs else Block({})

        return run
    if isinstance(op, L.MapRows):

        def run(block: Block, _fn=None) -> Block:
            f = _fn if _fn is not None else op.fn
            return Block.from_rows([f(r) for r in block.iter_rows()])

        return run
    if isinstance(op, L.Filter):

        def run(block: Block, _fn=None) -> Block:
            f = _fn if _fn is not None else op.fn
            keep = np.fromiter(
                (bool(f(r)) for r in block.iter_rows()), bool, count=block.num_rows
            )
            return block.take_indices(np.nonzero(keep)[0])

        return run
    if isinstance(op, L.FlatMap):

        def run(block: Block, _fn=None) -> Block:
            f = _fn if _fn is not None else op.fn
            rows = []
            for r in block.iter_rows():
                rows.extend(f(r))
            return Block.from_rows(rows)

        return run
    raise TypeError(f"not a map-like op: {op}")


class _MapWorker:
    """Actor wrapping a callable class for ActorPoolStrategy compute."""

    def __init__(self, cls, ctor_args, ctor_kwargs, block_fn):
        self._callable = cls(*ctor_args, **ctor_kwargs)
        self._block_fn = block_fn

    def apply(self, *blocks):
        block = Block.concat(list(blocks)) if len(blocks) != 1 else blocks[0]
        out = self._block_fn(block, _fn=self._callable)
        return out, out.metadata()


def _map_op(
    op: L.LogicalOp, upstream: Iterator[RefMeta], stats: ExecStats, window: int
) -> Iterator[RefMeta]:
    name = type(op).__name__.lower()
    block_fn = _make_block_fn(op)
    compute = getattr(op, "compute", None)

    batch_size = getattr(op, "batch_size", None)

    def bundles() -> Iterator[list]:
        """Group upstream refs so each task sees >= batch_size rows."""
        if batch_size is None:
            for rm in upstream:
                stats.record(name, n_blocks=1, rows=rm[1].num_rows)
                yield [rm[0]]
            return
        buf, buffered = [], 0
        for ref, meta in upstream:
            stats.record(name, n_blocks=1, rows=meta.num_rows)
            buf.append(ref)
            buffered += meta.num_rows
            if buffered >= batch_size:
                yield buf
                buf, buffered = [], 0
        if buf:
            yield buf

    if isinstance(compute, L.ActorPoolStrategy):
        if not (isinstance(op, L.MapBatches) and isinstance(op.fn, type)):
            raise ValueError("ActorPoolStrategy requires map_batches with a class")
        Worker = api.remote(_MapWorker)
        pool = [
            Worker.remote(op.fn, op.fn_constructor_args, op.fn_constructor_kwargs, block_fn)
            for _ in range(compute.size)
        ]
        rr = [0]

        def submit(refs):
            actor = pool[rr[0] % len(pool)]
            rr[0] += 1
            return actor.apply.options(num_returns=2).remote(*refs)

        try:
            yield from _windowed(submit, bundles(), max(window, len(pool)))
        finally:
            for a in pool:
                api.kill(a)
        return

    opts = {"num_returns": 2}
    if getattr(op, "num_cpus", None):
        opts["num_cpus"] = op.num_cpus
    run = _remote(_exec_map, **opts)
    yield from _windowed(lambda refs: run.remote(block_fn, *refs), bundles(), window)


def _materialize(upstream: Iterator[RefMeta]) -> list[RefMeta]:
    return list(upstream)


def _holder_map(all_refs) -> "tuple[dict, dict] | None":
    """ONE batched locality snapshot for a whole exchange: object id ->
    holder addrs, plus addr -> node_id. The locality signal for
    push-based reduce placement (upstream:
    exchange/push_based_shuffle_task_scheduler.py:400: merges pipeline
    on the nodes that already hold the map outputs, so partition bytes
    never transit the driver or a third node). Two GCS RPCs in all, not
    two per partition."""
    from ray_tpu_torch.core.api import _cluster

    cb = _cluster()
    if cb is None:
        return None
    try:
        client = cb.client
        ids = [getattr(r, "id", None) for r in all_refs]
        ids = [i for i in ids if i is not None]
        if not ids:
            return None
        locs = client.gcs.call("locate_many", {"object_ids": ids}, timeout=5)
        addr_node = {
            tuple(n["addr"]): n["node_id"]
            for n in client.gcs.call("list_nodes", None, timeout=5)
        }
        return (locs or {}), addr_node
    except Exception:  # noqa: BLE001 — locality is an optimization only
        return None


def _majority_holder(refs, holder_map) -> "str | None":
    """node_id holding the most of these split outputs, or None."""
    if holder_map is None:
        return None
    locs, addr_node = holder_map
    counts: dict = {}
    for r in refs:
        for a in locs.get(getattr(r, "id", None)) or ():
            counts[tuple(a)] = counts.get(tuple(a), 0) + 1
    if not counts:
        return None
    return addr_node.get(max(counts, key=counts.get))


def _exchange(
    inputs: list[RefMeta],
    n_out: int,
    assign: Callable[[Block], np.ndarray],
    postprocess: Optional[Callable[[Block], Block]],
    stats: ExecStats,
    name: str,
) -> Iterator[RefMeta]:
    """Two-phase all-to-all: split every input block into n_out partitions,
    then merge partition j across all inputs. On a cluster, each merge is
    scheduled (soft affinity) on the node holding most of its partition's
    split outputs: block bytes move holder -> reducer directly through
    the object plane, never via the driver. In-process every task is a
    thread and a merge reads its partitions by reference."""
    if not inputs:
        return
    from ray_tpu_torch.core.api import _cluster

    split = _remote(_exec_split, num_returns=n_out) if n_out > 1 else None
    parts: list[tuple] = []  # per input: tuple of n_out refs
    for i, (ref, _) in enumerate(inputs):
        if n_out == 1:
            parts.append((ref,))
        else:
            out = split.remote(ref, n_out, assign, i)
            parts.append(tuple(out))
    stats.record(f"{name}.map", n_tasks=len(inputs))
    merge = _remote(_exec_merge, num_returns=2)
    holder_map = None
    if _cluster() is not None and n_out > 1:
        # the locality lookup needs the split outputs to EXIST; a short
        # bounded wait trades a little pipelining for placed reduces
        try:
            api.wait([p[0] for p in parts], num_returns=len(parts), timeout=10.0)
        except Exception:  # noqa: BLE001
            pass
        holder_map = _holder_map([r for p in parts for r in p])
    for j in range(n_out):
        refs_j = [p[j] for p in parts]
        node = _majority_holder(refs_j, holder_map)
        m = merge
        if node is not None:
            m = merge.options(
                scheduling_strategy=api.NodeAffinitySchedulingStrategy(node, soft=True))
        refs = m.remote(postprocess, j, *refs_j)
        stats.record(f"{name}.reduce", n_tasks=1)
        yield _resolve(refs)


def _random_shuffle_op(op, upstream, stats, window):
    inputs = _materialize(upstream)
    n = max(1, len(inputs))
    rng_seed = op.seed if op.seed is not None else int(time.time() * 1e6) % (2**31)

    def assign(block: Block, block_idx: int, _n=n, _seed=rng_seed) -> np.ndarray:
        # distinct stream per input block, or equal-sized blocks would all
        # draw identical assignment vectors
        rng = np.random.default_rng([_seed, block_idx])
        return rng.integers(0, _n, block.num_rows)

    def postprocess(block: Block, part_idx: int, _seed=rng_seed) -> Block:
        rng = np.random.default_rng([_seed ^ 0x5EED, part_idx])
        return block.take_indices(rng.permutation(block.num_rows))

    yield from _exchange(inputs, n, assign, postprocess, stats, "random_shuffle")


def _sort_op(op, upstream, stats, window):
    inputs = _materialize(upstream)
    if not inputs:
        return
    keys = list(op.keys)
    n = len(inputs)
    # boundary sampling on the first key (reference: sort_task_scheduler)
    samples = []
    for ref, _ in inputs:
        block: Block = api.get(ref)
        col = block.columns.get(keys[0])
        if col is not None and len(col):
            take = np.linspace(0, len(col) - 1, min(20, len(col))).astype(int)
            samples.append(np.asarray(col)[take])
    allsamp = np.sort(np.concatenate(samples)) if samples else np.array([])
    bounds = (
        allsamp[np.linspace(0, len(allsamp) - 1, n + 1).astype(int)[1:-1]]
        if len(allsamp)
        else np.array([])
    )

    def assign(block: Block, block_idx: int, _b=bounds, _k=keys[0]) -> np.ndarray:
        if not len(_b):
            return np.zeros(block.num_rows, np.int64)
        return np.searchsorted(_b, block.columns[_k], side="right")

    def postprocess(block: Block, part_idx: int) -> Block:
        return block.sort_by(keys, op.descending)

    out = _exchange(inputs, max(1, n), assign, postprocess, stats, "sort")
    yield from (reversed(list(out)) if op.descending else out)


def _groupby_op(op, upstream, stats, window):
    inputs = _materialize(upstream)
    if not inputs:
        return
    keys = list(op.keys)
    aggs = list(op.aggs)
    n = min(len(inputs), 8) or 1

    def assign(block: Block, block_idx: int, _k=keys, _n=n) -> np.ndarray:
        h = np.zeros(block.num_rows, np.uint64)
        for k in _k:
            col = block.columns[k]
            h = h * np.uint64(1000003) + np.array(
                [hash(x) & 0xFFFFFFFF for x in col], np.uint64
            )
        return (h % np.uint64(_n)).astype(np.int64)

    def postprocess(block: Block, part_idx: int, _k=keys, _aggs=aggs) -> Block:
        if block.num_rows == 0:
            return Block({})
        rows = []
        keycols = [block.columns[k] for k in _k]
        tags = np.array([hash(tuple(kc[i] for kc in keycols)) for i in range(block.num_rows)])
        for tag in dict.fromkeys(tags.tolist()):
            idx = np.nonzero(tags == tag)[0]
            group = block.take_indices(idx)
            row = {k: group.columns[k][0] for k in _k}
            for a in _aggs:
                row[a.name] = a.finalize(a.accumulate_block(a.init(), group))
            rows.append(row)
        return Block.from_rows(rows)

    yield from _exchange(inputs, n, assign, postprocess, stats, "groupby")


def _repartition_op(op, upstream, stats, window):
    inputs = _materialize(upstream)
    n_out = op.num_blocks
    if op.shuffle:
        def assign(block: Block, block_idx: int, _n=n_out) -> np.ndarray:
            rng = np.random.default_rng([17, block_idx])
            return rng.integers(0, _n, block.num_rows)

        yield from _exchange(inputs, n_out, assign, None, stats, "repartition")
        return
    # shuffle=False: contiguous re-slicing preserving order
    total = sum(m.num_rows for _, m in inputs)
    bounds = np.linspace(0, total, n_out + 1).astype(int)
    run = _remote(_exec_slices, num_returns=2)
    # global row offset of each input block
    offsets = np.cumsum([0] + [m.num_rows for _, m in inputs])
    for j in range(n_out):
        lo, hi = int(bounds[j]), int(bounds[j + 1])
        needed, slices = [], []
        for (ref, m), off in zip(inputs, offsets[:-1]):
            s, e = max(lo, off), min(hi, off + m.num_rows)
            if e > s:
                needed.append(ref)
                slices.append((s - off, e - off))
        if not needed and total > 0:
            # empty output split (more splits than rows)
            needed, slices = [inputs[0][0]], [(0, 0)]
        stats.record("repartition", n_tasks=1)
        yield _resolve(run.remote(slices, *needed))


def _limit_op(op, upstream, stats, window):
    remaining = op.n
    run = _remote(_exec_map, num_returns=2)
    for ref, meta in upstream:
        if remaining <= 0:
            return
        if meta.num_rows <= remaining:
            remaining -= meta.num_rows
            yield ref, meta
        else:
            take = remaining
            remaining = 0
            yield _resolve(run.remote(lambda b, _t=take: b.slice(0, _t), ref))
            return


# ---------------------------------------------------------------------------
# plan execution
# ---------------------------------------------------------------------------


def execute_plan(
    plan: L.LogicalPlan, stats: Optional[ExecStats] = None, window: int = DEFAULT_WINDOW
) -> Iterator[RefMeta]:
    """Lower + run. Returns a pull-based iterator of (block_ref, meta)."""
    stats = stats if stats is not None else ExecStats()
    stream: Optional[Iterator[RefMeta]] = None
    for op in plan.ops:
        if isinstance(op, L.Read):
            stream = _read_op(op, stats, window)
        elif isinstance(op, (L.MapBatches, L.MapRows, L.Filter, L.FlatMap)):
            stream = _map_op(op, stream, stats, window)
        elif isinstance(op, L.RandomShuffle):
            stream = _random_shuffle_op(op, stream, stats, window)
        elif isinstance(op, L.Sort):
            stream = _sort_op(op, stream, stats, window)
        elif isinstance(op, L.GroupByAggregate):
            stream = _groupby_op(op, stream, stats, window)
        elif isinstance(op, L.Repartition):
            stream = _repartition_op(op, stream, stats, window)
        elif isinstance(op, L.Limit):
            stream = _limit_op(op, stream, stats, window)
        elif isinstance(op, L.Union):
            parts = [stream] + [execute_plan(p, stats, window) for p in op.others]

            def chain(parts=parts):
                for p in parts:
                    yield from p

            stream = chain()
        elif isinstance(op, L.Zip):
            stream = _zip_op(op, stream, stats, window)
        else:
            raise TypeError(f"unknown logical op {op}")
    assert stream is not None, "empty plan"
    return stream


def _zip_op(op, upstream, stats, window):
    left = _materialize(upstream)
    right = _materialize(execute_plan(op.other, stats, window))

    def rows(side):
        return sum(m.num_rows for _, m in side)

    if rows(left) != rows(right):
        raise ValueError(f"zip: row counts differ ({rows(left)} vs {rows(right)})")

    def _zip_blocks(lrefs, rrefs, lslices, rslices):
        lb = Block.concat([api.get(r).slice(lo, hi) for r, (lo, hi) in zip(lrefs, lslices)])
        rb = Block.concat([api.get(r).slice(lo, hi) for r, (lo, hi) in zip(rrefs, rslices)])
        cols = dict(lb.columns)
        for k, v in rb.columns.items():
            cols[k if k not in cols else f"{k}_1"] = v
        out = Block(cols)
        return out, out.metadata()

    # align on left block boundaries
    run = _remote(_zip_blocks, num_returns=2)
    loff = 0
    roffsets = np.cumsum([0] + [m.num_rows for _, m in right])
    for ref, meta in left:
        lo, hi = loff, loff + meta.num_rows
        loff = hi
        rrefs, rslices = [], []
        for (rref, rm), off in zip(right, roffsets[:-1]):
            s, e = max(lo, off), min(hi, off + rm.num_rows)
            if e > s:
                rrefs.append(rref)
                rslices.append((s - off, e - off))
        stats.record("zip", n_tasks=1)
        yield _resolve(run.remote([ref], rrefs, [(0, meta.num_rows)], rslices))


def aggregate_global(
    inputs: list[RefMeta], aggs: list[AggregateFn]
) -> list:
    """Tree aggregation without keys: per-block partials, merged by the caller."""
    run = _remote(_exec_partial_agg)
    partial_refs = [run.remote(aggs, ref) for ref, _ in inputs]
    accs = [a.init() for a in aggs]
    for pref in partial_refs:
        partials = api.get(pref)
        accs = [a.merge(acc, p) for a, acc, p in zip(aggs, accs, partials)]
    return [a.finalize(acc) for a, acc in zip(aggs, accs)]
