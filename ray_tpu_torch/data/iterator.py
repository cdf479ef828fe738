"""Batch iteration + device feed: the Dataset -> card boundary (counterpart
of ``ray_tpu/data/iterator.py``).

Reference: python/ray/data/iterator.py + stream_split_iterator.py. The
device piece is ``iter_device_batches``, the port's ``iter_jax_batches``:
numpy batches are copied to the card one step ahead of consumption. On a
CUDA device the ``data-prefetch`` thread pins each host batch and starts
its copies ``non_blocking`` on a side stream of the feed's own, so the
copy of batch i+1 overlaps the step that reads batch i; the consumer's
stream waits on the copy's event before the batch is handed out.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from ray_tpu_torch.core import api
from ray_tpu_torch.data.block import Batch, Block, iter_batches_from_blocks


class DataIterator:
    """One consumer's view of a block stream."""

    def __init__(self, ref_meta_iter_factory):
        self._factory = ref_meta_iter_factory

    def _iter_blocks(self) -> Iterator[Block]:
        for ref, _ in self._factory():
            yield api.get(ref)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Batch]:
        blocks = self._iter_blocks()
        if local_shuffle_buffer_size:
            blocks = _shuffling_blocks(
                blocks, local_shuffle_buffer_size, local_shuffle_seed
            )
        for b in iter_batches_from_blocks(blocks, batch_size, drop_last=drop_last):
            yield b.to_batch()

    def iter_rows(self) -> Iterator[Any]:
        for b in self._iter_blocks():
            yield from b.iter_rows()

    def iter_device_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        drop_last: bool = False,
        device="cuda",
        dtypes: Optional[dict] = None,
        prefetch: int = 1,
        local_shuffle_buffer_size: Optional[int] = None,
    ) -> Iterator[dict]:
        """Batches as torch tensors on ``device``, copied ahead of
        consumption (the reference's ``iter_jax_batches``).

        ``dtypes`` maps a column to a numpy or torch dtype, applied on the
        host before the copy; object columns stay Python lists. The device
        goes through ``ray_tpu_torch.resolve_device``: a CUDA device that is
        not present raises here, and nothing falls back to the CPU. The
        reference's ``sharding=`` waits for the device mesh (ROADMAP.md
        Queue 1, item 7): every batch lands whole on one device.
        """
        from ray_tpu_torch import resolve_device

        dev = resolve_device(device)
        batches = self.iter_batches(
            batch_size=batch_size,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
        )
        if dev.type == "cpu":
            # a placed batch owns its memory: no view of a block
            return _prefetched((_host_tensors(b, dtypes, copy=True) for b in batches), prefetch)
        return _CudaFeed(dev).feed((_host_tensors(b, dtypes) for b in batches), prefetch)

    def iter_torch_batches(
        self, *, batch_size: Optional[int] = 256, drop_last: bool = False
    ) -> Iterator[dict]:
        for batch in self.iter_batches(batch_size=batch_size, drop_last=drop_last):
            yield {
                k: torch.from_numpy(np.ascontiguousarray(v))
                if v.dtype.kind != "O"
                else list(v)
                for k, v in batch.items()
            }


def _host_tensors(batch: Batch, dtypes: Optional[dict], copy: bool = False) -> dict:
    """A numpy batch as host tensors: ``dtypes`` applied (a numpy dtype by
    ``astype`` as the reference does, a torch dtype, e.g. bfloat16 that
    numpy lacks, by ``Tensor.to`` on the host); object columns as lists.
    Without ``copy`` a tensor may share its memory with the block."""
    out = {}
    for k, v in batch.items():
        if v.dtype.kind == "O":
            out[k] = list(v)
            continue
        dt = dtypes.get(k) if dtypes else None
        if dt is not None and not isinstance(dt, torch.dtype):
            v = v.astype(dt)
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.to(dt) if isinstance(dt, torch.dtype) else t
        out[k] = t.clone() if copy else t
    return out


class _CudaFeed:
    """Host batches to one CUDA device on a side stream of the feed's own.

    ``_copy`` runs on the thread that produces the batches (``data-prefetch``
    when ``prefetch > 0``): under ``torch.cuda.stream`` on that thread (the
    current stream is per thread) it pins each column, starts its copy
    ``non_blocking`` and records one event. ``feed`` runs on the consumer's
    thread: its current stream waits on the event, and each tensor is marked
    used on that stream (``record_stream``), so the caching allocator does
    not hand the block back while the consumer still reads it. Each pinned
    host buffer stays referenced until its event has completed."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def _copy(self, host: dict) -> tuple:
        out, pinned = {}, []
        with torch.cuda.stream(self.stream):
            for k, v in host.items():
                if isinstance(v, list):
                    out[k] = v
                    continue
                p = v.pin_memory()
                pinned.append(p)
                out[k] = p.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, pinned, done

    def feed(self, host: Iterator[dict], prefetch: int) -> Iterator[dict]:
        held: "collections.deque" = collections.deque()  # (event, pinned) in copy order
        try:
            for out, pinned, done in _prefetched((self._copy(b) for b in host), prefetch):
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(done)
                for v in out.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(consumer)
                held.append((done, pinned))
                while held and held[0][0].query():
                    held.popleft()
                yield out
        finally:
            for done, _ in held:
                done.synchronize()
            held.clear()


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Run `it` in a background thread, keeping `depth` items ready."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE, ERR = object(), object()

    def pump():
        try:
            for x in it:
                q.put(x)
            q.put(DONE)
        except BaseException as e:  # noqa: BLE001 - must surface to consumer
            q.put((ERR, e))

    t = threading.Thread(target=pump, daemon=True, name="data-prefetch")
    t.start()
    while True:
        x = q.get()
        if x is DONE:
            return
        if isinstance(x, tuple) and len(x) == 2 and x[0] is ERR:
            raise x[1]
        yield x


def _shuffling_blocks(
    blocks: Iterator[Block], buffer_rows: int, seed: Optional[int]
) -> Iterator[Block]:
    """Local (non-global) shuffle: maintain a row buffer, emit random samples."""
    rng = np.random.default_rng(seed)
    buf: list[Block] = []
    buffered = 0
    for b in blocks:
        buf.append(b)
        buffered += b.num_rows
        while buffered >= 2 * buffer_rows:
            merged = Block.concat(buf)
            perm = rng.permutation(merged.num_rows)
            yield merged.take_indices(perm[:buffer_rows])
            buf = [merged.take_indices(perm[buffer_rows:])]
            buffered = buf[0].num_rows
    if buf:
        merged = Block.concat(buf)
        yield merged.take_indices(rng.permutation(merged.num_rows))


class StreamSplitIterator:
    """streaming_split(n): one producer thread feeds n consumer queues
    (reference: stream_split_iterator.py's coordinator actor; thread-mode
    runtime makes a thread + bounded queues the equivalent construct).

    One streaming pass total: each split is consumable once; a second
    iteration of an exhausted split yields nothing (instead of blocking).
    `close()` (called by e.g. JaxTrainer when the gang fails) unblocks the
    pump so unconsumed splits can't wedge the producer forever."""

    _DONE = object()

    def __init__(self, ref_meta_iter_factory, n: int, equal: bool, maxsize: int = 4):
        self._factory = ref_meta_iter_factory
        self._n = n
        self._equal = equal
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._queues: Optional[list[queue.Queue]] = None
        self._closed = threading.Event()
        self._finished = [False] * n

    def close(self) -> None:
        """Stop the pump; pending/future consumers see end-of-stream."""
        self._closed.set()

    def _ensure_started(self):
        with self._lock:
            if self._queues is not None:
                return
            self._queues = [queue.Queue(maxsize=self._maxsize) for _ in range(self._n)]
            t = threading.Thread(target=self._pump, daemon=True, name="stream-split")
            t.start()

    def _put(self, q: queue.Queue, item) -> bool:
        """Timed put loop so a stalled consumer can't wedge the pump once
        close() is called. Returns False if closed."""
        while not self._closed.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self):
        try:
            i = 0
            for ref, meta in self._factory():
                if not self._put(self._queues[i % self._n], (ref, meta)):
                    return
                i += 1
        except BaseException as e:  # noqa: BLE001
            for q in self._queues:
                self._put(q, ("__error__", e))
            return
        for q in self._queues:
            self._put(q, self._DONE)

    def split(self, idx: int) -> DataIterator:
        def factory():
            self._ensure_started()
            if self._finished[idx]:
                return
            q = self._queues[idx]
            while True:
                try:
                    item = q.get(timeout=0.2)
                except queue.Empty:
                    if self._closed.is_set():
                        self._finished[idx] = True
                        return
                    continue
                if item is self._DONE:
                    self._finished[idx] = True
                    return
                if isinstance(item, tuple) and item[0] == "__error__":
                    self._finished[idx] = True
                    raise item[1]
                yield item

        it = DataIterator(factory)
        it.splitter = self
        return it
