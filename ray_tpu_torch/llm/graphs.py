"""One captured CUDA graph per pipelined-decode bucket (the port's
counterpart of the reference engine's ``_pipe_chunk_fn`` jit cache,
``ray_tpu/llm/engine.py``: one compiled program per chunk bucket).

A bucket is (B_pad, stop width, block-table width) — the shapes of the
static buffers a ``DeviceBatchState`` lives in — and (n_steps, sample
mode). Each graph is captured on its bucket's first use, after one eager
warm-up of its shapes on the capture stream (kernel builds, cuBLAS
handles and the first-launch attribute calls stay out of the capture);
every graph draws from one shared memory pool. A replay reads the batch
from the static buffers and writes the carry back into them, so chunk
N+1 continues from chunk N on the device with nothing read back.

After each replay its outputs (tokens, logprobs, n_emitted, steps_run)
are copied on the same stream into fresh pinned host tensors and an
event is recorded: the next replay overwrites the graph's outputs, and
the host waits on that event, not on the stream (which would also wait
for the chunk dispatched after it).

On the CPU the same chunk runs eagerly on the same buffers. Nothing
falls back: a capture or a replay that fails raises.

``launches`` counts the kernel launches replays made: the wrappers'
counters (``ops/paged_attention.py``, ``ops/ragged.py``) see a kernel
once, when its launch is recorded into the graph (``captured_launches``
sums those), so each graph keeps the count recorded at its capture and
every replay adds it here. Launches on the device = wrapper count -
captured_launches + launches.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

# graphs kept at once; the least recently replayed goes first
MAX_GRAPHS = 64


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy a host array into a device buffer, ordered on the current
    stream after the work already queued there (a chunk in flight) and
    without waiting for it: the source goes through a fresh pinned copy,
    which the caching host allocator keeps until the transfer is done."""
    t = torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type == "cuda":
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)


def _kernel_counters() -> dict:
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.ops.ragged import ragged_attention_cuda

    return {"paged_attention": paged_attention_cuda, "ragged_attention": ragged_attention_cuda}


@dataclasses.dataclass
class ChunkBuffers:
    """The static inputs of one (B_pad, stop width, table width) bucket.
    The first five are the carry, rewritten in place by every chunk."""

    key: tuple
    tokens: torch.Tensor
    positions: torch.Tensor
    context_lens: torch.Tensor
    done: torch.Tensor
    starts: torch.Tensor
    temps: torch.Tensor
    top_ks: torch.Tensor
    top_ps: torch.Tensor
    seed_bases: torch.Tensor
    max_toks: torch.Tensor
    stop_ids: torch.Tensor
    stop_on_eos: torch.Tensor
    lora_ids: torch.Tensor
    block_tables: torch.Tensor

    @classmethod
    def empty(cls, B: int, stop_w: int, bt_width: int, device) -> "ChunkBuffers":
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        i32 = torch.int32
        return cls(
            key=(B, stop_w, bt_width), tokens=z(B, i32), positions=z(B, i32),
            context_lens=z(B, i32), done=z(B, torch.bool), starts=z(B, i32),
            temps=z(B, torch.float32), top_ks=z(B, i32), top_ps=z(B, torch.float32),
            seed_bases=z(B, torch.int64), max_toks=z(B, i32), stop_ids=z((B, stop_w), i32),
            stop_on_eos=z(B, torch.bool), lora_ids=z(B, i32),
            block_tables=z((B, bt_width), i32),
        )

    def carry(self) -> tuple:
        return (self.tokens, self.positions, self.context_lens, self.done, self.starts)

    def clone_done(self) -> "ChunkBuffers":
        """A copy with every row done: a warm-up on it writes only the
        trash page and leaves the real carry alone."""
        out = ChunkBuffers(self.key, *(getattr(self, f.name).clone()
                                       for f in dataclasses.fields(self)[1:]))
        out.done.fill_(True)
        return out


@dataclasses.dataclass
class InFlight:
    """One dispatched chunk: its outputs (host tensors on the card path,
    filled by the copies queued behind the replay) and the event after
    those copies."""

    toks: torch.Tensor
    lps: torch.Tensor
    n_emit: torch.Tensor
    steps_run: torch.Tensor
    event: Optional[Any] = None

    def wait(self):
        """Block until the chunk is done: (toks, lps, n_emit) as numpy
        arrays and steps_run as an int."""
        if self.event is not None:
            self.event.synchronize()
        return (self.toks.numpy(), self.lps.numpy(), self.n_emit.numpy(),
                int(self.steps_run))


class ChunkGraphs:
    """``run(fn, bufs, n_steps, mode)`` dispatches one chunk of ``fn`` — a
    callable ``fn(bufs, n_steps, mode, early_exit)`` that runs the masked
    chunk on the buffers, writes the carry back into them and returns
    (toks, lps, n_emit, steps_run), the same callable at every call — as a
    graph replay on the card and eagerly on the CPU. ``fn`` is not kept:
    an engine that owns this object and passes its own method stays free
    of a reference cycle, so dropping the engine frees its memory at once."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: dict = {}
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._warm: set = set()
        self._pool = None
        self._stream = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.evicted = 0
        self.eager_runs = 0
        self.launches: dict = collections.Counter()
        # wrapper counts taken while a launch was only being recorded
        self.captured_launches: dict = collections.Counter()

    def buffers(self, B: int, stop_w: int, bt_width: int) -> ChunkBuffers:
        key = (B, stop_w, bt_width)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = ChunkBuffers.empty(B, stop_w, bt_width, self.device)
        return bufs

    def run(self, fn: Callable, bufs: ChunkBuffers, n_steps: int, mode: str) -> InFlight:
        if self.device.type != "cuda":
            self.eager_runs += 1
            return InFlight(*fn(bufs, n_steps, mode, True))
        key = (bufs.key, n_steps, mode)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(fn, bufs, n_steps, mode)
        self._graphs.move_to_end(key)
        graph, outs, per_replay = entry
        graph.replay()
        self.replays += 1
        self.launches.update(per_replay)
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return InFlight(*host, event=event)

    def _capture(self, fn: Callable, bufs: ChunkBuffers, n_steps: int, mode: str):
        if len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)
            self.evicted += 1
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        if (bufs.key, mode) not in self._warm:
            with torch.cuda.stream(s):
                fn(bufs.clone_done(), 1, mode, False)
            self._warm.add((bufs.key, mode))
        torch.cuda.current_stream(self.device).wait_stream(s)
        counters = _kernel_counters()
        before = {n: f.launches for n, f in counters.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=s):
            outs = fn(bufs, n_steps, mode, False)
        per_replay = {n: f.launches - before[n] for n, f in counters.items()}
        per_replay = {n: k for n, k in per_replay.items() if k}
        self.captured_launches.update(per_replay)
        entry = (graph, tuple(outs), per_replay)
        self._graphs[(bufs.key, n_steps, mode)] = entry
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return entry

    def stats(self) -> dict:
        return {
            "graphs": len(self._graphs), "captured": self.captures,
            "capture_s": round(self.capture_s, 4), "replays": self.replays,
            "evicted": self.evicted, "max_graphs": MAX_GRAPHS,
            "eager_chunks": self.eager_runs,
            "replay_kernel_launches": dict(self.launches),
            "captured_kernel_launches": dict(self.captured_launches),
        }
