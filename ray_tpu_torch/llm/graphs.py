"""Captured CUDA graphs per bucket: the port's counterpart of the
reference engine's per-shape jit caches (``ray_tpu/llm/engine.py``):

 * ``ChunkGraphs`` — one graph per pipelined-decode bucket (the
   counterpart of ``_pipe_chunk_fn``): (B_pad, stop width, block-table
   width), the shapes of the static buffers a ``DeviceBatchState`` lives
   in, and (n_steps, sample mode). A replay reads the batch from the
   static buffers and writes the carry back into them, so chunk N+1
   continues from chunk N on the device with nothing read back. After
   each replay its outputs (tokens, logprobs, n_emitted, steps_run) are
   copied on the same stream into fresh pinned host tensors and an event
   is recorded: the next replay overwrites the graph's outputs, and the
   host waits on that event, not on the stream (which would also wait for
   the chunk dispatched after it).
 * ``PackedGraphs`` — one graph per packed-token bucket of a packed
   program (the counterparts of ``_mixed_fn`` and ``_verify_ragged_fn``,
   which jit re-specializes per ``T_pad = token_bucket(T)``): the mixed
   prefill+decode step and the ragged spec verifier, keyed by their
   shapes alone (``PackedBuffers``). The step's arrays are data in the
   bucket's static buffers, written in full every step; the logits
   output stays in the graph pool and the caller reads it before the
   bucket's next replay.

Each graph is captured on its bucket's first use, after one eager
warm-up of its shapes on the capture stream that writes only the trash
page (kernel builds, cuBLAS handles and the first-launch attribute calls
stay out of the capture). An engine's graphs, of both kinds, draw from
one memory pool: every graph's outputs stay referenced, so no capture
allocates over them, and every replay runs on the one current stream,
its outputs read before the next graph replays, so the graphs share only
temporaries. The least recently replayed graph of a family goes past
MAX_GRAPHS.

On the CPU the same program runs eagerly on the same buffers. Nothing
falls back: a capture or a replay that fails raises.

``launches`` counts the kernel launches replays made: the wrappers'
counters (``ops/paged_attention.py``, ``ops/ragged.py``) see a kernel
once, when its launch is recorded into the graph (``captured_launches``
sums those), so each graph keeps the count recorded at its capture and
every replay adds it here. Launches on the device = wrapper count -
captured_launches + launches, summed over an engine's graph families.

Several engines may run in one process, each on its own thread (the
disaggregated pools, ``llm/disagg``). A capture runs in the
``thread_local`` capture mode, so another thread's syncs, allocations and
launches neither fail it nor join it; captures take one process-wide lock,
so two never overlap (entering a capture synchronizes the device and
empties the allocator's cache), and hold the garbage collector off, so no
thread's collection destroys another engine's graph mid-capture; a
graph's per-replay count is read from the capturing thread's own tally of
launches.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import threading
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


# one capture at a time in the process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()


class _no_gc:
    """No automatic garbage collection inside: a collection run by any
    thread during a capture may free another engine's graph, and a graph
    freed mid-capture fails it."""

    def __enter__(self):
        self._was = gc.isenabled()
        gc.disable()

    def __exit__(self, *exc):
        if self._was:
            gc.enable()


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


class GraphFamily:
    """One family of captured graphs on one device, by bucket key: the
    capture (on first use, after one eager warm-up per warm-up key), the
    LRU cap, the launch accounting and the shared pool. ``shared_with``
    draws the capture stream and memory pool from another family of the
    same engine."""

    def __init__(self, device: torch.device, shared_with: "Optional[GraphFamily]" = None):
        self.device = device
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._warm: set = set()
        self._share = shared_with
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
        # per bucket key: the seconds of each capture (a recapture after an
        # eviction adds one) and the replays
        self.capture_s_by_key: dict = collections.defaultdict(list)
        self.replays_by_key: dict = collections.Counter()

    def _capture_context(self):
        if self._share is not None:
            return self._share._capture_context()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        return self._pool, self._stream

    def _replay(self, key, warm_key, warm: Callable[[], Any],
                record: Callable[[], tuple]) -> tuple:
        """Replay ``key``'s graph on the current stream, capturing it first
        (``warm()`` runs once per ``warm_key`` before a capture; ``record()``
        is the work captured, returning its outputs). Returns the outputs."""
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, warm_key, warm, record)
        self._graphs.move_to_end(key)
        graph, outs, per_replay = entry
        graph.replay()
        self.replays += 1
        self.replays_by_key[key] += 1
        self.launches.update(per_replay)
        return outs

    def _capture(self, key, warm_key, warm: Callable[[], Any], record: Callable[[], tuple]):
        if len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)
            self.evicted += 1
        from ray_tpu_torch.ops.paged_attention import thread_launches

        t0 = time.perf_counter()
        with _CAPTURE_LOCK, _no_gc():
            pool, s = self._capture_context()
            cur = torch.cuda.current_stream(self.device)
            s.wait_stream(cur)
            if warm_key not in self._warm:
                with torch.cuda.stream(s):
                    warm()
                self._warm.add(warm_key)
            cur.wait_stream(s)
            before = thread_launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=s, capture_error_mode="thread_local"):
                outs = record()
            after = thread_launches()
        per_replay = {n: k - before.get(n, 0) for n, k in after.items()}
        per_replay = {n: k for n, k in per_replay.items() if k}
        self.captured_launches.update(per_replay)
        entry = (graph, tuple(outs), per_replay)
        self._graphs[key] = entry
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += seconds
        self.capture_s_by_key[key].append(seconds)
        return entry

    def stats(self) -> dict:
        return {
            "graphs": len(self._graphs), "captured": self.captures,
            "capture_s": round(self.capture_s, 4), "replays": self.replays,
            "evicted": self.evicted, "max_graphs": MAX_GRAPHS,
            "replay_kernel_launches": dict(self.launches),
            "captured_kernel_launches": dict(self.captured_launches),
        }


class ChunkGraphs(GraphFamily):
    """``run(fn, bufs, n_steps, mode)`` dispatches one chunk of ``fn`` — a
    callable ``fn(bufs, n_steps, mode, early_exit)`` that runs the masked
    chunk on the buffers, writes the carry back into them and returns
    (toks, lps, n_emit, steps_run), the same callable at every call — as a
    graph replay on the card and eagerly on the CPU. ``fn`` is not kept:
    an engine that owns this object and passes its own method stays free
    of a reference cycle, so dropping the engine frees its memory at once."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self._bufs: dict = {}

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
        outs = self._replay(
            (bufs.key, n_steps, mode), (bufs.key, mode),
            warm=lambda: fn(bufs.clone_done(), 1, mode, False),
            record=lambda: fn(bufs, n_steps, mode, False),
        )
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return InFlight(*host, event=event)

    def stats(self) -> dict:
        return {**super().stats(), "eager_chunks": self.eager_runs}


@dataclasses.dataclass
class PackedBuffers:
    """The static inputs of one packed-program bucket. ``key`` is
    (program, T_pad, B_pad, table width, K + 1, lora): program "mixed" or
    "verify", K + 1 the verifier's rows per sequence (0 for mixed), lora
    whether the engine carries adapters. Every step writes every buffer in
    full (``fill``), so nothing of an earlier step in the same bucket
    survives: a stale pad token would write real K/V into a live slot."""

    key: tuple
    tokens: torch.Tensor        # [T_pad] packed tokens (pad 0)
    positions: torch.Tensor     # [T_pad] absolute positions (pad 0)
    slots: torch.Tensor         # [T_pad] cache slots (pad -> the trash slot)
    lora_ids: torch.Tensor      # [T_pad] adapter slot per token (pad 0)
    cu_q_lens: torch.Tensor     # [B_pad + 1] (pad sequences: q_len 0)
    context_lens: torch.Tensor  # [B_pad] (pad 0)
    block_tables: torch.Tensor  # [B_pad, W] (rows past the batch 0)
    gather_idx: Optional[torch.Tensor] = None  # [B_pad, K + 1], verify only

    @classmethod
    def empty(cls, key: tuple, device) -> "PackedBuffers":
        program, T_pad, B_pad, W, k1, _lora = key

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return cls(key, z(T_pad), z(T_pad), z(T_pad), z(T_pad), z(B_pad + 1), z(B_pad),
                   z(B_pad, W), z(B_pad, k1) if program == "verify" else None)

    def _inputs(self) -> list:
        return [f.name for f in dataclasses.fields(self)[1:] if getattr(self, f.name) is not None]

    def fill(self, **arrays: np.ndarray) -> None:
        """Upload one step's arrays, one for every buffer, each of its
        buffer's full shape (the padded tail included)."""
        if sorted(arrays) != sorted(self._inputs()):
            raise ValueError(f"fill takes {self._inputs()}, got {sorted(arrays)}")
        for name, arr in arrays.items():
            dst = getattr(self, name)
            if tuple(np.shape(arr)) != tuple(dst.shape):
                raise ValueError(
                    f"{name}: {tuple(np.shape(arr))} does not cover the buffer "
                    f"{tuple(dst.shape)}"
                )
            upload(dst, np.asarray(arr, np.int32))

    def idle(self, trash_slot: int) -> "PackedBuffers":
        """A copy on which the program writes only the trash page: every
        token to the trash slot, every sequence q_len 0 and context 0 (the
        eager warm-up before a capture runs for real)."""
        out = PackedBuffers(self.key, *(getattr(self, n).clone() for n in self._inputs()))
        out.slots.fill_(trash_slot)
        out.cu_q_lens.zero_()
        out.context_lens.zero_()
        return out


class PackedGraphs(GraphFamily):
    """``run(fn, bufs)`` runs one packed program — ``fn(bufs)`` runs it on
    a bucket's buffers, writes the new K/V into the cache in place and
    returns its logits; the same callable at every call, not kept — as a
    graph replay on the card (the logits live in the graph pool until the
    bucket's next replay: read them first) and eagerly on the CPU."""

    def __init__(self, device: torch.device, trash_slot: int,
                 shared_with: Optional[GraphFamily] = None):
        super().__init__(device, shared_with)
        self.trash_slot = trash_slot
        self._bufs: dict = {}

    def buffers(self, program: str, T_pad: int, B_pad: int, bt_width: int,
                k1: int = 0, lora: bool = False) -> PackedBuffers:
        key = (program, T_pad, B_pad, bt_width, k1, lora)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = PackedBuffers.empty(key, self.device)
        return bufs

    def run(self, fn: Callable, bufs: PackedBuffers) -> torch.Tensor:
        if self.device.type != "cuda":
            self.eager_runs += 1
            return fn(bufs)
        return self._replay(
            bufs.key, bufs.key,
            warm=lambda: fn(bufs.idle(self.trash_slot)),
            record=lambda: (fn(bufs),),
        )[0]

    def stats(self) -> dict:
        """The family's counts, with capture seconds and replays per
        bucket (every bucket used, captured or not: on the CPU none is)."""
        buckets = [
            {"program": k[0], "T_pad": k[1], "B_pad": k[2], "table_width": k[3],
             "k_plus_1": k[4], "lora": k[5], "captures": len(self.capture_s_by_key.get(k, ())),
             "capture_s": round(sum(self.capture_s_by_key.get(k, ())), 4),
             "replays": self.replays_by_key[k], "live": k in self._graphs}
            for k in self._bufs
        ]
        return {**super().stats(), "eager_runs": self.eager_runs, "buckets": buckets}
