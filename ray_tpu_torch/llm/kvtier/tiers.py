"""Tiered spill/resurrect machinery behind one engine's prefix cache
(counterpart of ``ray_tpu/llm/kvtier/tiers.py``).

``KVTierManager`` hangs off an ``LLMEngine`` and listens to its
``BlockAllocator``:

 * ``on_seal`` — a full block was registered reusable: remember its chain
   metadata (parent hash, tokens, prefix length) for the spill path and
   the prefix index.
 * ``on_evict`` — allocation pressure is about to reuse a zero-ref cached
   block. The block's pages are CAPTURED: one stacked copy of its K and V
   slots into a new device tensor, queued on the engine's current stream
   (the stream every prefill, import and graph replay writes the cache
   on), so stream order runs it before the block's new owner can write.
   With ``async_spill`` a spill worker drains the queue in batches: it
   waits (on the engine's copy stream) for an event recorded behind the
   captures, copies each into a slot of a pinned host slab, waits for that
   copy on its own thread, then CRC-seals each block as a ``SpilledBlock``
   (the ``KVHandoff`` seal, so spill and handoff integrity are one code
   path). Without it the same happens inline on the allocation path.
 * ``on_drop`` — the allocator invalidated its prefix cache: every tier
   drops the affected chains.

The host tier is a bounded LRU over a slab of block-sized slots allocated
once (pinned on the card, sized by ``host_bytes``): a spilled block's pages
are views into its slot. A slot returns to the free list when the last
view of it dies (on LRU eviction, promotion or invalidation, or later if a
prefetch still holds the block), so a slot is never refilled while anyone
can still read it; a host→device copy out of a slot and the device→host
copy that refills it are both queued on the engine's copy stream, so the
refill runs after the read. When no slot is free the block lands in plain
host memory. The object tier serializes blocks to plain host bytes
(``core/object_store.py``).

Resurrection runs in the engine's admission (``LLMEngine._resurrect_tiers``)
and in the prefetch tick (``llm/kvfetch``): verified blocks are copied to
the device on the copy stream and scattered into the cache tensors IN
PLACE on the current stream (``LLMEngine._scatter_block_pages``, the
``import_handoff`` recipe), so graphs captured before the resurrection
read the pages.

Threads: the engine thread drives every allocator callback and admission;
the spill worker, the prefetch worker and other engines' fetch pulls read
and change the tier tables concurrently under ``_lock`` (an RLock). CUDA
work off the engine thread is copies on the engine's copy stream and waits
on events (never a device synchronize, never the capture stream): legal
while the engine thread captures a graph in ``thread_local`` mode.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.core.object_store import ObjectID, deserialize, serialize, tier_store
from ray_tpu_torch.llm.kvtier.config import (
    TIER_CODES,
    TIER_HBM,
    TIER_HOST,
    TIER_OBJECT,
    KVTierConfig,
)

logger = logging.getLogger("ray_tpu_torch.llm.kvtier")

# the per-block stages ``stats()["timings"]`` reports (ms per block): the
# capture and the gather, copy (h2d) and scatter are device time on the
# card (CUDA events), the rest host time
STAGES = ("capture", "gather", "pin", "seal", "verify", "h2d", "scatter")


def _pages_to_wire(t: torch.Tensor) -> np.ndarray:
    """A page tensor's bytes as a fresh uint8 array (numpy has no bfloat16);
    a copy, so a host-slab slot is never pickled or aliased."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().copy()


def _pages_from_wire(raw: np.ndarray, dtype: str, shape: tuple) -> torch.Tensor:
    return torch.from_numpy(raw).view(getattr(torch, dtype)).reshape(shape)


def _rebuild_spilled(header, k, v, dtype, shape, parent_hash, n_prefix_tokens):
    header.k_pages = _pages_from_wire(k, dtype, shape)
    header.v_pages = _pages_from_wire(v, dtype, shape)
    return SpilledBlock(handoff=header, parent_hash=parent_hash, n_prefix_tokens=n_prefix_tokens)


@dataclasses.dataclass
class SpilledBlock:
    """One sealed full block outside HBM: its pages as a CRC-sealed
    KVHandoff (pages [L, KVH, block_size, D] on the CPU, prompt_token_ids =
    the block's tokens) plus the chain metadata resurrection re-links.
    Pickles its pages as uint8 arrays, out of band (the object tier).

    A host-tier block's pages are views of a slab slot: the slot is held
    while those two page tensors live, so copy what must outlive them (a
    numpy array or a reshaped view made from a page does not hold it)."""

    handoff: Any          # llm.disagg.handoff.KVHandoff
    parent_hash: int
    n_prefix_tokens: int  # prompt tokens covered through this block

    @property
    def nbytes(self) -> int:
        return int(self.handoff.nbytes)

    @property
    def tokens(self) -> tuple:
        return tuple(self.handoff.prompt_token_ids)

    def __reduce__(self):
        h = self.handoff
        header = dataclasses.replace(h, k_pages=None, v_pages=None)
        dtype = str(h.k_pages.dtype).removeprefix("torch.")
        return (_rebuild_spilled, (header, _pages_to_wire(h.k_pages), _pages_to_wire(h.v_pages),
                                   dtype, tuple(h.k_pages.shape), self.parent_hash,
                                   self.n_prefix_tokens))


@dataclasses.dataclass
class _PendingSpill:
    """An evicted block captured on the device, awaiting the batched
    gather. ``pages`` [2, L, KVH, bs, D] is an independent copy taken on
    the engine's stream; ``ready`` (on the card) is an event recorded
    behind it, which the gather waits for on the copy stream."""

    content_hash: int
    parent_hash: int
    tokens: tuple
    n_prefix_tokens: int
    pages: Any
    ready: Any
    t_enqueued: float


class _SlotLease:
    """Returns a slab slot to the free list once its K and V views died."""

    __slots__ = ("slab", "index", "live")

    def __init__(self, slab: "_HostSlab", index: int):
        self.slab, self.index, self.live = slab, index, 2

    def release(self) -> None:
        self.live -= 1  # the two finalizers run one at a time under the GIL
        if self.live == 0:
            self.slab._give(self.index)


class _HostSlab:
    """``n_slots`` block-sized slots of host memory [n, 2, L, KVH, bs, D],
    allocated once (pinned when the engine is on the card): the host tier
    never pins memory per block."""

    def __init__(self, n_slots: int, page_shape: tuple, dtype, pin: bool):
        t0 = time.perf_counter()
        self.buf = torch.empty((n_slots, 2) + tuple(page_shape), dtype=dtype, pin_memory=pin)
        self.alloc_ms = (time.perf_counter() - t0) * 1e3
        self.pinned = pin
        self.n_slots = n_slots
        self._lock = threading.Lock()
        self._free = list(range(n_slots - 1, -1, -1))
        self._used_once: set = set()
        self.taken = 0
        self.reused = 0
        self.misses = 0

    def take(self) -> Optional[tuple]:
        """(slot [2, ...], k view, v view) or None when every slot is held."""
        with self._lock:
            if not self._free:
                self.misses += 1
                return None
            i = self._free.pop()
            self.taken += 1
            if i in self._used_once:
                self.reused += 1
            self._used_once.add(i)
        slot = self.buf[i]
        k, v = slot[0], slot[1]
        lease = _SlotLease(self, i)
        weakref.finalize(k, lease.release)
        weakref.finalize(v, lease.release)
        return slot, k, v

    def _give(self, i: int) -> None:
        with self._lock:
            self._free.append(i)

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            taken, reused, misses = self.taken, self.reused, self.misses
        return {
            "slots": self.n_slots, "free": free, "bytes": self.buf.numel() * self.buf.element_size(),
            "pinned": self.pinned, "alloc_ms": round(self.alloc_ms, 3),
            "taken": taken, "reused": reused, "misses": misses,
        }


class KVTierManager:
    """HBM -> host DRAM -> object store ladder for one engine."""

    def __init__(self, engine: Any, config: Optional[KVTierConfig] = None):
        self.engine = engine
        self.config = config or KVTierConfig()
        c = self.config
        self._cuda = engine.device.type == "cuda"
        # guards _meta/_root/_host/_obj/_pending/_gathering: the spill
        # worker, the prefetch worker and remote fetch pulls all touch the
        # tier tables off the engine thread
        self._lock = threading.RLock()
        # chain metadata for hashes currently sealed in HBM
        self._meta: dict[int, tuple] = {}  # h -> (parent, tokens, n_prefix)
        # h -> root salt of its chain: survives spill and eviction so a
        # scoped invalidation finds every tier's copies
        self._root: dict[int, int] = {}
        self._host: "OrderedDict[int, SpilledBlock]" = OrderedDict()
        self._host_bytes = 0
        self._store = tier_store(c.object_store)
        self._obj: "OrderedDict[int, tuple]" = OrderedDict()  # h -> (oid, nbytes, parent, n_prefix)
        self._obj_bytes = 0
        self._pending: "OrderedDict[int, _PendingSpill]" = OrderedDict()
        # hashes the worker popped and has not inserted yet (the gather window)
        self._gathering: dict[int, bool] = {}
        # bumped by every invalidation: inserts that began before it drop
        self.generation = 0
        m, dt = engine.config.model, engine.cache["k"].dtype
        bs = engine.config.block_size
        self._page_shape = (m.n_layers, m.n_kv_heads, bs, m.head_dim)
        block_nbytes = 2 * int(np.prod(self._page_shape)) * torch.empty((), dtype=dt).element_size()
        self.block_nbytes = block_nbytes
        n_slots = c.host_bytes // block_nbytes if c.host_bytes > 0 else 0
        self._slab = _HostSlab(n_slots, self._page_shape, dt, pin=self._cuda) if n_slots else None
        if self._cuda:
            engine._copies()  # one copy stream for every h2d/d2h of the tiers
        # per-stage totals (ms, blocks) and device spans read once complete
        self._timing_lock = threading.Lock()
        self._stage_ms = {s: 0.0 for s in STAGES}
        self._stage_blocks = {s: 0 for s in STAGES}
        self._deferred: collections.deque = collections.deque()
        self._spill_wake = threading.Event()
        self._spill_stop = False
        self._spill_thread: Optional[threading.Thread] = None
        if c.async_spill:
            t = threading.Thread(target=self._spill_worker, name="kvtier-spill", daemon=True)
            t.start()
            self._spill_thread = t
        # prefix index publishing (epoch banked per incarnation)
        self.index: Any = None
        self.engine_key: str = getattr(engine, "model_tag", "engine")
        self.fetch_addr: Any = None
        self._epoch = int(time.time() * 1000)
        self._seq = 0
        self._index_dirty = True
        self._index_next = 0.0
        self._index_refresh_next = 0.0
        # stats
        self.spilled_bytes = {TIER_HOST: 0, TIER_OBJECT: 0}
        self.resurrected_tokens = {TIER_HOST: 0, TIER_OBJECT: 0}
        self.corrupt_dropped = {TIER_HOST: 0, TIER_OBJECT: 0}
        self.spills_dropped = 0
        self.spill_queue_dropped = 0
        self.spill_gather_failures = 0
        self.evicted_blocks = 0
        self.fetch_blocks_served = 0
        self.fetch_bytes_served = 0
        # host wall time per eviction INSIDE the allocation path
        self.spill_wall_ms: collections.deque = collections.deque(maxlen=1024)
        self._bind_allocator()

    # -- timings ----------------------------------------------------------------

    def note_ms(self, stage: str, ms: float, n_blocks: int = 1) -> None:
        with self._timing_lock:
            self._stage_ms[stage] += ms
            self._stage_blocks[stage] += n_blocks

    def note_span(self, stage: str, start, end, n_blocks: int) -> None:
        """A stage measured by two CUDA events (read once ``end`` completed,
        never waited for) or, on the CPU, two host clock readings."""
        if not self._cuda:
            self.note_ms(stage, (end - start) * 1e3, n_blocks)
            return
        with self._timing_lock:
            self._deferred.append((stage, start, end, n_blocks))
            backlog = len(self._deferred)
        if backlog > 512:
            self._resolve_timings()  # completed spans only: never waits

    def _resolve_timings(self) -> None:
        with self._timing_lock:
            done = []
            while self._deferred and self._deferred[0][2].query():
                done.append(self._deferred.popleft())
        for stage, a, b, n in done:
            self.note_ms(stage, a.elapsed_time(b), n)

    def mark(self):
        """A point in time for ``note_span``: a CUDA event recorded on the
        current stream on the card, the host clock on the CPU."""
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()  # on the current stream
        return ev

    # -- allocator listeners ---------------------------------------------------

    def _bind_allocator(self) -> None:
        alloc = self.engine.allocator
        alloc.seal_listener = self.on_seal
        alloc.evict_listener = self.on_evict
        alloc.drop_listener = self.on_drop

    def rebind_allocator(self) -> None:
        """The engine rebuilt its allocator (``recover(rebuild_kv=True)``):
        HBM rows are gone, spilled copies (pending captures included: their
        pages are independent copies) stay resurrectable."""
        with self._lock:
            self._meta.clear()
            self._index_dirty = True
        self._bind_allocator()

    def on_seal(self, block_id: int, content_hash: int, parent_hash: int,
                tokens: tuple, n_prefix_tokens: int) -> None:
        with self._lock:
            self._meta[content_hash] = (parent_hash, tuple(tokens), int(n_prefix_tokens))
            self._root[content_hash] = self._root.get(parent_hash, parent_hash)
            self._index_dirty = True

    def on_evict(self, block_id: int, content_hash: int) -> None:
        """A zero-ref sealed block is being reused: capture its pages before
        they are overwritten. Never throws into allocation (a failed spill
        is a future cache miss)."""
        t0 = time.perf_counter()
        with self._lock:
            meta = self._meta.pop(content_hash, None)
            self._index_dirty = True
            gen = self.generation
        if meta is None:
            return  # sealed before the manager attached, or already spilled
        if self.config.host_bytes <= 0 and self.config.object_bytes <= 0:
            return
        parent, tokens, n_prefix = meta
        try:
            entry = self._capture_block(block_id, content_hash, parent, tokens, n_prefix)
            if self.config.async_spill:
                with self._lock:
                    self._pending[content_hash] = entry
                    self._pending.move_to_end(content_hash)
                    while len(self._pending) > self.config.spill_queue_depth:
                        self._pending.popitem(last=False)
                        self.spill_queue_dropped += 1
                self._spill_wake.set()
            else:
                (k, v), = self._gather([entry])
                sb = self._materialize(content_hash, parent, tokens, n_prefix, k, v)
                if sb is not None:
                    self._insert(content_hash, sb, gen=gen)
        except Exception:  # noqa: BLE001 — spill must never break allocation
            logger.exception("kvtier spill of block %d failed", block_id)
        finally:
            with self._lock:
                self.spill_wall_ms.append((time.perf_counter() - t0) * 1e3)

    def on_drop(self, salt: Optional[int] = None) -> None:
        """The allocator invalidated its prefix cache (weight swap, LoRA
        slot reuse): every tier drops the affected chains."""
        if salt is None:
            self.invalidate_all()
        else:
            self.invalidate_salt(salt)

    # -- spill path ------------------------------------------------------------

    def _capture_block(self, block_id: int, content_hash: int, parent: int,
                       tokens: tuple, n_prefix: int) -> _PendingSpill:
        """Copy one block's K and V pages into a new device tensor, queued on
        the current stream (the eviction window: the new owner writes only
        later on that stream)."""
        bs = self.engine.config.block_size
        cache = self.engine.cache
        a = self.mark()
        pages = torch.stack((cache["k"].narrow(2, block_id * bs, bs),
                             cache["v"].narrow(2, block_id * bs, bs)))
        b = self.mark()
        self.note_span("capture", a, b, 1)
        return _PendingSpill(content_hash=content_hash, parent_hash=parent, tokens=tokens,
                             n_prefix_tokens=n_prefix, pages=pages,
                             ready=b if self._cuda else None, t_enqueued=time.time())

    def _make_room(self, hashes: list) -> None:
        """Demote least-recently-used host entries so the incoming blocks
        fit ``host_bytes`` (the reference's insert-then-evict, evicting
        first so the victims' slots can take the new pages)."""
        demote = []
        with self._lock:
            incoming = sum(1 for h in hashes if h not in self._host) * self.block_nbytes
            while self._host and self._host_bytes + incoming > self.config.host_bytes:
                old_h, old = self._host.popitem(last=False)
                self._host_bytes -= old.nbytes
                if self.config.object_bytes > 0:
                    demote.append((old_h, old))
                else:
                    self.evicted_blocks += 1
            self._index_dirty = True
        for old_h, old in demote:
            self._object_insert(old_h, old)

    def _gather(self, entries: list) -> list:
        """Device -> host for a batch of captures: each into a slab slot
        (or plain host memory when none is free), on the copy stream after
        the captures' events; this thread waits for the copies (the engine
        thread never does). Returns [(k, v)] host page views."""
        if self.config.host_bytes > 0:
            self._make_room([e.content_hash for e in entries])
        dsts = []
        for _ in entries:
            t0 = time.perf_counter()
            got = self._slab.take() if self._slab is not None else None
            if got is None:
                slot = torch.empty((2,) + self._page_shape, dtype=entries[0].pages.dtype)
                got = (slot, slot[0], slot[1])
            self.note_ms("pin", (time.perf_counter() - t0) * 1e3)
            dsts.append(got)
        if self._cuda:
            cs = self.engine._copies()
            with torch.cuda.stream(cs):
                for e in entries:
                    cs.wait_event(e.ready)
                a = self.mark()
                for e, (slot, _k, _v) in zip(entries, dsts):
                    slot.copy_(e.pages, non_blocking=True)
                b = self.mark()
            b.synchronize()  # this thread only: not a device synchronize
            self.note_ms("gather", a.elapsed_time(b), len(entries))
        else:
            t0 = time.perf_counter()
            for e, (slot, _k, _v) in zip(entries, dsts):
                slot.copy_(e.pages)
            self.note_ms("gather", (time.perf_counter() - t0) * 1e3, len(entries))
        return [(k, v) for _slot, k, v in dsts]

    def _materialize(self, content_hash: int, parent: int, tokens: tuple,
                     n_prefix: int, k, v) -> Optional[SpilledBlock]:
        """Host half of a spill: CRC seal and the chaos gate. Never called
        under ``_lock``."""
        from ray_tpu_torch.llm.disagg.handoff import KVHandoff

        c = self.engine.config
        t0 = time.perf_counter()
        h = KVHandoff(
            request_id=f"kvtier-{content_hash & 0xFFFFFFFF:08x}",
            prompt_token_ids=list(tokens),
            output_token_ids=[],
            sampling_params=None,
            seed_base=0,
            num_kv_tokens=c.block_size,
            k_pages=k,
            v_pages=v,
            model_sig=(c.model.n_layers, c.model.n_kv_heads, c.model.head_dim),
        ).seal()
        self.note_ms("seal", (time.perf_counter() - t0) * 1e3)
        if _chaos.ACTIVE is not None:
            for _f in _chaos.fire(
                "llm.kvtier.spill",
                kinds=(_chaos.DROP_KV_TRANSFER, _chaos.CORRUPT_KV_TRANSFER),
                chain=content_hash,
            ):
                if _f.kind == _chaos.DROP_KV_TRANSFER:
                    # the spill is lost: a later probe misses and recomputes
                    with self._lock:
                        self.spills_dropped += 1
                    return None
                if _f.kind == _chaos.CORRUPT_KV_TRANSFER:
                    # bit-flip AFTER sealing, on a copy: resurrection's
                    # verify() must catch it
                    h.k_pages = _flip(h.k_pages)
        return SpilledBlock(handoff=h, parent_hash=parent, n_prefix_tokens=n_prefix)

    def _insert(self, content_hash: int, sb: SpilledBlock, gen: Optional[int] = None) -> None:
        """Insert into the first enabled deep tier; dropped when an
        invalidation landed since the producer began (``gen``)."""
        with self._lock:
            if gen is not None and gen != self.generation:
                return
            if self.config.host_bytes > 0:
                self._host_insert(content_hash, sb)
            else:
                self._object_insert(content_hash, sb)

    def _spill_worker(self) -> None:
        """Drain the pending queue in batches; parks on a bounded wait so a
        ``stop()`` is honoured within one poll slice."""
        while not self._spill_stop:
            self._spill_wake.wait(timeout=0.1)
            self._spill_wake.clear()
            self._drain_pending()

    def _drain_pending(self, only_hash: Optional[int] = None) -> None:
        with self._lock:
            gen = self.generation
            if only_hash is not None:
                e = self._pending.pop(only_hash, None)
                entries = [e] if e is not None else []
            else:
                entries = list(self._pending.values())
                self._pending.clear()
            for e in entries:
                self._gathering[e.content_hash] = True
        if not entries:
            return
        # in chunks the slab can hold: a chunk's inserts evict the LRU
        # entries (returning their slots) before the next chunk takes slots
        step = max(1, self._slab.n_slots if self._slab is not None else len(entries))
        try:
            for lo in range(0, len(entries), step):
                self._spill_chunk(entries[lo:lo + step], gen)
        finally:
            with self._lock:
                for e in entries:
                    self._gathering.pop(e.content_hash, None)

    def _spill_chunk(self, entries: list, gen: int) -> None:
        try:
            rows = self._gather(entries)
        except Exception:  # noqa: BLE001 — died mid-gather: blocks missed
            with self._lock:
                self.spill_gather_failures += len(entries)
            logger.exception("kvtier spill gather of %d block(s) failed; entries dropped",
                             len(entries))
            return
        for e, (k, v) in zip(entries, rows):
            try:
                sb = self._materialize(e.content_hash, e.parent_hash, e.tokens,
                                       e.n_prefix_tokens, k, v)
            except Exception:  # noqa: BLE001
                with self._lock:
                    self.spill_gather_failures += 1
                continue
            if sb is not None:
                self._insert(e.content_hash, sb, gen=gen)

    def flush_spills(self, timeout_s: float = 10.0) -> bool:
        """Wait (bounded) until every pending spill has materialized."""
        deadline = time.monotonic() + timeout_s
        self._spill_wake.set()
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending and not self._gathering:
                    return True
            if self._spill_thread is None or not self._spill_thread.is_alive():
                self._drain_pending()
            else:
                self._spill_wake.set()
                time.sleep(0.002)
        return False

    def stop(self) -> None:
        """Stop the spill worker (bounded join)."""
        self._spill_stop = True
        self._spill_wake.set()
        if self._spill_thread is not None:
            self._spill_thread.join(timeout=2)

    def _host_insert(self, content_hash: int, sb: SpilledBlock) -> None:
        with self._lock:
            old = self._host.get(content_hash)
            if old is not None:
                # re-spill of a hash still resident: replace, don't double count
                self._host_bytes -= old.nbytes
            self._host[content_hash] = sb
            self._host.move_to_end(content_hash)
            self._host_bytes += sb.nbytes
            self.spilled_bytes[TIER_HOST] += sb.nbytes
            demote: list = []
            while self._host_bytes > self.config.host_bytes and self._host:
                old_h, old = self._host.popitem(last=False)
                self._host_bytes -= old.nbytes
                if self.config.object_bytes > 0:
                    demote.append((old_h, old))
                else:
                    self.evicted_blocks += 1
            self._index_dirty = True
        self._count_spill(TIER_HOST, sb.nbytes)
        for old_h, old in demote:
            self._object_insert(old_h, old)

    def _object_insert(self, content_hash: int, sb: SpilledBlock) -> None:
        # serialization (a host copy of the pages) stays outside the lock
        oid = self._object_id(content_hash)
        payload, buffers = serialize(sb)
        with self._lock:
            old = self._obj.pop(content_hash, None)
            if old is not None:
                self._obj_bytes -= old[1]
                self._store.remove_ref(old[0])
            self._store.put_serialized(oid, payload, buffers)
            self._obj[content_hash] = (oid, sb.nbytes, sb.parent_hash, sb.n_prefix_tokens)
            self._obj.move_to_end(content_hash)
            self._obj_bytes += sb.nbytes
            self.spilled_bytes[TIER_OBJECT] += sb.nbytes
            while self._obj_bytes > self.config.object_bytes and self._obj:
                _old_h, (old_oid, old_n, _p, _np) = self._obj.popitem(last=False)
                self._obj_bytes -= old_n
                self._store.remove_ref(old_oid)
                self.evicted_blocks += 1
            self._index_dirty = True
        self._count_spill(TIER_OBJECT, sb.nbytes)

    def _object_id(self, content_hash: int) -> ObjectID:
        digest = hashlib.blake2b(f"kvtier:{self.engine_key}:{content_hash}".encode(),
                                 digest_size=16).digest()
        return ObjectID(digest)

    def _series(self, name: str, n: float, tier: Optional[str] = None) -> None:
        try:
            from ray_tpu_torch.llm.kvtier import metrics as kvtier_metrics

            tags = {"model": self.engine.model_tag}
            if tier is not None:
                tags["tier"] = tier
            getattr(kvtier_metrics, name)().inc(n, tags=tags)
        except Exception:  # noqa: BLE001 — observability never breaks serving
            pass

    def _count_spill(self, tier: str, nbytes: int) -> None:
        self._series("spilled_bytes_counter", nbytes, tier)

    # -- resurrect path --------------------------------------------------------

    def peek(self, content_hash: int) -> Optional[str]:
        """Which deep tier holds this hash (read-only). A pending or
        mid-gather spill counts as host-resident: ``get`` serves it."""
        with self._lock:
            if (content_hash in self._host or content_hash in self._pending
                    or content_hash in self._gathering):
                return TIER_HOST
            if content_hash in self._obj:
                return TIER_OBJECT
        return None

    def get(self, content_hash: int) -> Optional[tuple]:
        """(tier, SpilledBlock) without removing the entry; a pending spill
        is materialized here, a mid-gather one waited for (bounded)."""
        with self._lock:
            pending = content_hash in self._pending
        if pending:
            self._drain_pending(only_hash=content_hash)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._lock:
                busy = content_hash in self._gathering
            if not busy:
                break
            time.sleep(0.001)
        with self._lock:
            sb = self._host.get(content_hash)
            if sb is not None:
                self._host.move_to_end(content_hash)
                return TIER_HOST, sb
            rec = self._obj.get(content_hash)
            oid = rec[0] if rec is not None else None
        if oid is None:
            return None
        try:
            payload, buffers = self._store.serialized_get(oid, timeout=1.0)
            sb = deserialize(payload, buffers)
        except Exception:  # noqa: BLE001 — torn store entry = miss
            self._drop_entry(content_hash, TIER_OBJECT)
            return None
        with self._lock:
            if content_hash in self._obj:
                self._obj.move_to_end(content_hash)
        return TIER_OBJECT, sb

    def take_verified(self, content_hash: int, expect_tokens: tuple) -> Optional[tuple]:
        """(tier, SpilledBlock) iff the seal verifies AND the tokens match
        the prompt's block; a corrupt entry is dropped and counted."""
        got = self.get(content_hash)
        if got is None:
            return None
        tier, sb = got
        t0 = time.perf_counter()
        ok = self.verify_block(sb, expect_tokens)
        self.note_ms("verify", (time.perf_counter() - t0) * 1e3)
        if not ok:
            with self._lock:
                self.corrupt_dropped[tier] += 1
            self._drop_entry(content_hash, tier)
            self._series("corrupt_dropped_counter", 1, tier)
            logger.warning("kvtier: dropped corrupt %s-tier block (chain %x); falling back to "
                           "recompute", tier, content_hash & 0xFFFFFFFF)
            return None
        return tier, sb

    @staticmethod
    def verify_block(sb: SpilledBlock, expect_tokens: tuple) -> bool:
        """Seal + token check shared by local resurrection and the kvfetch
        requester."""
        try:
            return tuple(sb.tokens) == tuple(expect_tokens) and sb.handoff.verify()
        except Exception:  # noqa: BLE001 — malformed entry = corrupt
            return False

    def promoted(self, content_hash: int, tier: str) -> None:
        """The block is back in HBM: drop the deep-tier copy."""
        self._drop_entry(content_hash, tier)

    def count_resurrected(self, tier: str, n_tokens: int) -> None:
        with self._lock:
            self.resurrected_tokens[tier] = self.resurrected_tokens.get(tier, 0) + n_tokens
        self._series("resurrected_tokens_counter", n_tokens, tier)

    def _drop_entry(self, content_hash: int, tier: str) -> None:
        with self._lock:
            self._pending.pop(content_hash, None)
            if tier == TIER_HOST:
                sb = self._host.pop(content_hash, None)
                if sb is not None:
                    self._host_bytes -= sb.nbytes
            else:
                rec = self._obj.pop(content_hash, None)
                if rec is not None:
                    self._obj_bytes -= rec[1]
                    self._store.remove_ref(rec[0])
            self._index_dirty = True

    # -- cross-engine fetch (the llm.kvfetch source side) ----------------------

    def serve_fetch(self, hashes: list, tokens_list: list) -> list:
        """Serve spilled blocks to another same-weights engine,
        non-destructively; the requester re-verifies each. The
        ``llm.kvfetch`` chaos site: DROP fails the pull with a typed error,
        CORRUPT bit-flips the first served block's pages after its seal,
        DELAY sleeps."""
        from ray_tpu_torch.llm.kvfetch.plane import KVFetchError

        corrupt = False
        if _chaos.ACTIVE is not None:
            for _f in _chaos.fire(
                "llm.kvfetch",
                kinds=(_chaos.DROP_KV_TRANSFER, _chaos.CORRUPT_KV_TRANSFER, _chaos.DELAY_RPC),
                engine=self.engine_key, n_blocks=len(hashes),
            ):
                if _f.kind == _chaos.DROP_KV_TRANSFER:
                    raise KVFetchError(f"chaos: dropped kv fetch from {self.engine_key!r}")
                if _f.kind == _chaos.DELAY_RPC:
                    time.sleep(_f.delay_s)
                if _f.kind == _chaos.CORRUPT_KV_TRANSFER:
                    corrupt = True
        out: list = []
        for h, toks in zip(hashes, tokens_list):
            got = self.get(int(h))
            if got is None:
                out.append(None)
                continue
            _tier, sb = got
            if tuple(sb.tokens) != tuple(toks):
                out.append(None)  # hash collision: not the caller's block
                continue
            if corrupt:
                # on a copy AFTER the seal (the resident entry stays intact)
                sb = SpilledBlock(
                    handoff=dataclasses.replace(sb.handoff, k_pages=_flip(sb.handoff.k_pages)),
                    parent_hash=sb.parent_hash, n_prefix_tokens=sb.n_prefix_tokens,
                )
                corrupt = False  # one block is enough to prove the gate
            out.append(sb)
            with self._lock:
                self.fetch_blocks_served += 1
                self.fetch_bytes_served += sb.nbytes
        return out

    def adopt_fetched(self, content_hash: int, sb: SpilledBlock, gen: Optional[int] = None) -> None:
        """A verified block pulled from another engine joins the local deep
        tier (bounded LRU), unless an invalidation landed since ``gen``."""
        self._insert(content_hash, sb, gen=gen)

    # -- probes (read-only; the routing signal) --------------------------------

    def probe_tiers(self, tokens: list, salt: int = 0) -> dict:
        """Longest contiguous resurrectable prefix across ALL tiers,
        tier-discounted. Returns {"n_tokens", "discounted", "by_tier"}."""
        from ray_tpu_torch.llm.kv_cache import BlockAllocator

        alloc = self.engine.allocator
        bs = alloc.block_size
        c = self.config
        h = salt
        n = 0
        discounted = 0.0
        by_tier: dict[str, int] = {}
        for i in range(len(tokens) // bs):
            h = BlockAllocator.chain_hash(h, tuple(tokens[i * bs : (i + 1) * bs]))
            if alloc.contains_hash(h):
                tier = TIER_HBM
            else:
                tier = self.peek(h)
                if tier is None:
                    break
            n += bs
            discounted += c.weight(tier) * bs
            by_tier[tier] = by_tier.get(tier, 0) + bs
        return {"n_tokens": n, "discounted": discounted, "by_tier": by_tier}

    # -- invalidation ----------------------------------------------------------

    def invalidate_all(self) -> None:
        """Every tier's cached K/V is stale: drop host, object and pending
        entries, forget HBM metadata, publish an empty index snapshot."""
        with self._lock:
            self.generation += 1
            self._meta.clear()
            self._host.clear()
            self._host_bytes = 0
            self._pending.clear()
            for oid, _n, _p, _np in self._obj.values():
                self._store.remove_ref(oid)
            self._obj.clear()
            self._obj_bytes = 0
            self._root.clear()
            self._index_dirty = True
        kvf = getattr(self.engine, "kvfetch", None)
        if kvf is not None:
            kvf.reset()  # staged prefetches reference pre-swap KV
        self.flush_index(force=True)

    def invalidate_salt(self, salt: int) -> None:
        """One adapter swapped: drop only chains rooted at ``salt`` (the
        generation still bumps: in-flight inserts carry no salt)."""
        with self._lock:
            self.generation += 1
            for h in [h for h, r in self._root.items() if r == salt]:
                self._root.pop(h, None)
                self._meta.pop(h, None)
                self._pending.pop(h, None)
                sb = self._host.pop(h, None)
                if sb is not None:
                    self._host_bytes -= sb.nbytes
                rec = self._obj.pop(h, None)
                if rec is not None:
                    self._obj_bytes -= rec[1]
                    self._store.remove_ref(rec[0])
            self._index_dirty = True
        kvf = getattr(self.engine, "kvfetch", None)
        if kvf is not None:
            kvf.reset()
        self.flush_index(force=True)

    # -- prefix-index publishing ----------------------------------------------

    def attach_index(self, index: Any, engine_key: Optional[str] = None,
                     fetch_addr: Any = None) -> None:
        self.index = index
        if engine_key is not None:
            self.engine_key = engine_key
        if fetch_addr is not None:
            self.fetch_addr = fetch_addr
        with self._lock:
            self._index_dirty = True
        self.flush_index(force=True)

    # a steady engine still re-publishes on this heartbeat (the store
    # omits silent publishers past its stale_after_s)
    INDEX_REFRESH_S = 10.0

    def flush_index(self, force: bool = False) -> None:
        """Ship a full snapshot of resident chain hashes (throttled); a
        failed publish re-arms the dirty flag so the next tick retries."""
        if self.index is None:
            return
        now = time.monotonic()
        with self._lock:
            due = self._index_dirty or now >= self._index_refresh_next
            if not force and (not due or now < self._index_next):
                return
            self._index_next = now + self.config.index_flush_interval_s
            self._index_refresh_next = now + self.INDEX_REFRESH_S
            rows = [[h, TIER_CODES[TIER_HBM], n] for h, (_p, _t, n) in self._meta.items()]
            rows += [[h, TIER_CODES[TIER_HOST], sb.n_prefix_tokens] for h, sb in self._host.items()]
            rows += [[h, TIER_CODES[TIER_HOST], e.n_prefix_tokens] for h, e in self._pending.items()]
            rows += [[h, TIER_CODES[TIER_OBJECT], n] for h, (_o, _b, _p, n) in self._obj.items()]
            self._seq += 1
            self._index_dirty = False
            seq = self._seq
        ok = False
        try:
            payload = {"engine": self.engine_key, "epoch": self._epoch, "seq": seq, "rows": rows}
            if self.fetch_addr is not None:
                payload["fetch_addr"] = list(self.fetch_addr)
            got = self.index.update(payload)
            # the store returns {"ok": ...}; "stale" means a newer snapshot
            # of ours already landed, which is not a failure to retry
            ok = bool(got) if not isinstance(got, dict) else bool(got.get("ok"))
            if isinstance(got, dict) and got.get("reason") == "stale":
                ok = True
        except Exception:  # noqa: BLE001 — a dark index costs freshness only
            ok = False
        if not ok:
            with self._lock:
                self._index_dirty = True

    # -- observability ---------------------------------------------------------

    def update_gauges(self) -> None:
        try:
            from ray_tpu_torch.llm.kvfetch import metrics as kvfetch_metrics
            from ray_tpu_torch.llm.kvtier import metrics as kvtier_metrics

            g = kvtier_metrics.resident_bytes_gauge()
            tag = {"model": self.engine.model_tag}
            with self._lock:
                host_b, obj_b = self._host_bytes, self._obj_bytes
                pending = len(self._pending)
            g.set(host_b, tags={**tag, "tier": TIER_HOST})
            g.set(obj_b, tags={**tag, "tier": TIER_OBJECT})
            kvfetch_metrics.spill_queue_gauge().set(pending, tags=tag)
        except Exception:  # noqa: BLE001
            pass

    def timings(self) -> dict:
        """{stage: {"blocks", "ms_per_block"}} over the stages completed so far."""
        self._resolve_timings()
        with self._timing_lock:
            return {s: {"blocks": self._stage_blocks[s],
                        "ms_per_block": (self._stage_ms[s] / self._stage_blocks[s]
                                         if self._stage_blocks[s] else 0.0)}
                    for s in STAGES}

    def stats(self) -> dict:
        with self._lock:
            host_entries, host_b = len(self._host), self._host_bytes
            obj_entries, obj_b = len(self._obj), self._obj_bytes
            pending = len(self._pending)
            walls = sorted(self.spill_wall_ms)
            evicted = self.evicted_blocks
            spilled, resurrected = dict(self.spilled_bytes), dict(self.resurrected_tokens)
            corrupt = dict(self.corrupt_dropped)
            served = {"blocks": self.fetch_blocks_served, "bytes": self.fetch_bytes_served}
            dropped, failures = self.spills_dropped, self.spill_gather_failures
        wall_p99 = walls[min(len(walls) - 1, int(len(walls) * 0.99))] if walls else 0.0
        return {
            "host": {"entries": host_entries, "resident_bytes": host_b,
                     "capacity_bytes": self.config.host_bytes},
            "object": {"entries": obj_entries, "resident_bytes": obj_b,
                       "capacity_bytes": self.config.object_bytes},
            "spilled_bytes_total": spilled,
            "resurrected_tokens": resurrected,
            "corrupt_dropped": corrupt,
            "spills_dropped": dropped,
            "evicted_blocks": evicted,
            "spill_queue": {
                "pending": pending,
                "depth_cap": self.config.spill_queue_depth,
                "dropped": self.spill_queue_dropped,
                "gather_failures": failures,
                "async": bool(self.config.async_spill),
                "wall_p99_ms": round(wall_p99, 4),
            },
            "fetch_served": served,
            "index_attached": self.index is not None,
            "engine_key": self.engine_key,
            "slab": self._slab.stats() if self._slab is not None else None,
            "timings": self.timings(),
        }


def _flip(pages: torch.Tensor) -> torch.Tensor:
    """A copy of ``pages`` with a span of bytes in the middle inverted."""
    out = pages.clone()
    flat = out.reshape(-1).view(torch.uint8)
    if flat.numel():
        mid = flat.numel() // 2
        span = max(1, min(16, flat.numel() - mid))
        flat[mid:mid + span] ^= 0xFF
    return out
