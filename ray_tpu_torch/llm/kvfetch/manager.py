"""KVFetchManager: prefetch-at-admission and cross-engine pulls for one
engine (counterpart of ``ray_tpu/llm/kvfetch/manager.py``).

Resurrecting a spilled prefix at admission puts the CRC verify, the
object-tier deserialize and (for a remote holder) the pull on the prefill
path. Here that work runs on a bounded prefetch worker while the request
still waits in the queue:

 1. ``request_admitted`` (engine thread, from ``add_request``) queues a
    prefetch task for the new request's prompt.
 2. The worker walks the prompt's chain hashes: blocks resident in HBM are
    skipped; local host/object-tier entries are taken and verified
    (``take_verified``); blocks another engine holds (prefix-index rows +
    the fetch plane, ``plane.py``) are pulled, re-verified and adopted into
    the local deep tier. The verified chain is staged.
 3. ``tick`` (engine thread, from ``step()`` before admission) lands a
    pipelined chunk in flight, then scatters each staged chain into the
    paged cache (``LLMEngine._scatter_block_pages``: copies on the engine's
    copy stream, an in-place scatter on its current stream) and registers
    the blocks with a RESERVATION ref, so the request's admission finds its
    prefix resident and ``probe_admission_need`` discounts it.
 4. ``consumed`` (admission) releases the reservation; ``cancel`` (abort)
    releases it too and drops staged state: an abort storm leaks nothing.

Threads: the worker touches only thread-safe surfaces (the tier manager
under its lock, the fetch plane, the index) and read-only allocator peeks;
it issues no CUDA work of its own beyond what ``take_verified`` needs for a
still-pending spill (copies on the copy stream and an event wait). Every
allocator and cache mutation happens on the engine thread in ``tick`` /
``consumed`` / ``cancel``.

Failures: a dead or dropped source is a typed ``KVFetchError`` (local tiers
and recompute serve the request); a corrupt fetched block fails the
requester's verify and is a counted drop, never wrong tokens.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.llm.kvfetch.plane import FetchClient, KVFetchError

logger = logging.getLogger("ray_tpu_torch.llm.kvfetch.manager")


class KVFetchManager:
    """Prefetch + cross-engine fetch orchestration for one LLMEngine."""

    def __init__(self, engine: Any):
        self.engine = engine
        self.cfg = engine.config.kvtier
        self.client: Optional[FetchClient] = None
        self._lock = threading.Lock()
        self._tasks: "queue.Queue[tuple]" = queue.Queue(
            maxsize=max(1, self.cfg.prefetch_queue_depth)
        )
        # rid -> {"entries": [(hash, SpilledBlock, n_prefix, src_tier)],
        #         "salt", "ready_t"} — verified chains awaiting the
        # engine-thread scatter
        self._staged: dict[str, dict] = {}
        # rid -> [block_ids]: the reservation ref held between the tick
        # scatter and admission (released on consume/cancel)
        self._reserved: dict[str, list] = {}
        # rid -> staged-ready time (feeds the prefetch-lead histogram)
        self._ready_t: dict[str, float] = {}
        # rid -> {source tier: tokens} for blocks the tick scattered:
        # they match as HBM residents at admission, and the engine's
        # per-tier hit accounting re-attributes them to the tier the
        # prefetch actually pulled them from
        self._attribution: dict[str, dict] = {}
        self._cancelled: dict[str, float] = {}
        # stats
        self.prefetch_started = 0
        self.prefetch_completed = 0
        self.prefetch_wasted = 0      # cancelled/finished before consumption
        self.prefetch_skipped = 0     # bounded task queue overflow
        self.prefetch_failures = 0    # worker task died (request unaffected)
        self.remote_fetches = 0
        self.remote_blocks = 0
        self.fetch_corrupt_dropped = 0
        self.fetch_failures = 0       # typed plane failures (drop/dead/timeout)
        self.index_dark = 0           # lookups answered by a dark index
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        if self.cfg.prefetch:
            t = threading.Thread(
                target=self._loop, name="kvfetch-prefetch", daemon=True
            )
            t.start()
            self._thread = t

    # -- wiring ---------------------------------------------------------------

    def attach(self, client: FetchClient) -> None:
        """Give this engine a fetch plane; without one, prefetch still
        runs (local-tiers verification/deserialize ahead of admission)
        but never pulls remote blocks."""
        self.client = client

    # -- engine-thread surface -------------------------------------------------

    def request_admitted(self, req: Any) -> None:
        """Called from add_request: queue a prefetch for this prompt
        (only when at least one full block could be covered)."""
        if not self.cfg.prefetch:
            return
        bs = self.engine.config.block_size
        if len(req.prompt_token_ids) <= bs:
            return
        try:
            self._tasks.put_nowait(
                (req.request_id, list(req.prompt_token_ids), req.lora_slot)
            )
            self.prefetch_started += 1
            try:
                from ray_tpu_torch.llm.kvfetch import metrics as kvfetch_metrics

                kvfetch_metrics.prefetch_counter("started").inc(
                    1, tags={"model": self.engine.model_tag}
                )
            except Exception:  # noqa: BLE001
                pass
        except queue.Full:
            self.prefetch_skipped += 1

    def tick(self) -> None:
        """Engine thread, called from step() before admission: scatter
        every staged verified chain into the paged cache and hold a
        reservation ref per block. Bounded work: one scatter per staged
        request, nothing when the stage is empty."""
        with self._lock:
            if not self._staged:
                return
            ready = list(self._staged.items())
            self._staged.clear()
        # the scatters below change cache membership: land the pipelined
        # chunk in flight first (its outputs go out with the next step())
        self.engine._pipe_flush(deliver=True)
        from ray_tpu_torch.llm.engine import RequestStatus

        alloc = self.engine.allocator
        for rid, rec in ready:
            req = self.engine.requests.get(rid)
            with self._lock:
                cancelled = rid in self._cancelled
            if req is None or req.status != RequestStatus.WAITING or cancelled:
                with self._lock:
                    self._note_wasted(rid)
                continue
            # drop entries that landed in HBM since staging (another
            # request shared the prefix) — the scatter must not duplicate
            entries = [e for e in rec["entries"]
                       if not alloc.contains_hash(e[0])]
            if not entries:
                with self._lock:
                    self._ready_t.setdefault(rid, rec["ready_t"])
                continue
            # starvation guard: prefetching a QUEUED request must not eat
            # the free blocks the head of the queue needs to admit — the
            # deep-tier copies stay resurrectable at admission instead
            head = self.engine.waiting[0] if self.engine.waiting else None
            if (head is not None and head.request_id != rid
                    and alloc.num_free - len(entries)
                    < self.engine._admission_need(head)):
                continue
            try:
                blocks = alloc.allocate(len(entries))
            except Exception:  # noqa: BLE001 — no room: resurrect at admission
                continue
            try:
                self._scatter(entries, blocks)
            except Exception:  # noqa: BLE001 — scatter died: release refs
                self.prefetch_failures += 1
                logger.exception("prefetch scatter for %s failed", rid)
                alloc.free(blocks)
                continue
            attr: dict = {}
            for _h, _sb, _npfx, src_tier in entries:
                t = src_tier.replace("remote:", "")
                attr[t] = attr.get(t, 0) + self.engine.config.block_size
            with self._lock:
                self._reserved[rid] = blocks
                self._ready_t.setdefault(rid, rec["ready_t"])
                self._attribution[rid] = attr

    def _scatter(self, entries: list, blocks: list) -> None:
        """One scatter for a staged chain (``engine._scatter_block_pages``,
        the recipe ``_resurrect_tiers`` uses too), then chain registration,
        tier promotion and resurrection accounting."""
        eng = self.engine
        bs = eng.config.block_size
        mgr = eng.kvtier
        eng._scatter_block_pages([e[1] for e in entries], blocks)
        tier_counts: dict[str, int] = {}
        for (h, sb, n_prefix, src_tier), b in zip(entries, blocks):
            eng.allocator.register_full_block(
                b, h, parent_hash=sb.parent_hash, tokens=sb.tokens,
                n_prefix_tokens=n_prefix,
            )
            # a block staged from a LOCAL tier is now promoted (drop the
            # deep copy); a REMOTE-fetched block was adopted by the
            # worker into whichever deep tier is enabled — promote that
            if src_tier.startswith("remote"):
                local = "host" if mgr.config.host_bytes > 0 else "object"
                mgr.promoted(h, local)
            else:
                mgr.promoted(h, src_tier)
            tier_counts[src_tier] = tier_counts.get(src_tier, 0) + bs
        for tier, n in tier_counts.items():
            mgr.count_resurrected(tier.replace("remote:", ""), n)

    def take_attribution(self, rid: str) -> dict:
        """{source tier: tokens} for blocks prefetch-scattered for this
        request — consumed once by _prefill_one's hit accounting so the
        per-tier mix reflects where the KV actually came from, not the
        HBM residency the prefetch manufactured."""
        with self._lock:
            return self._attribution.pop(rid, {})

    def consumed(self, rid: str) -> None:
        """Admission succeeded for ``rid``: its sequence holds its own
        refs now — release the reservation and book the lead time (how
        far ahead of admission the prefetch landed)."""
        with self._lock:
            blocks = self._reserved.pop(rid, None)
            ready_t = self._ready_t.pop(rid, None)
            self._cancelled.pop(rid, None)
            self._attribution.pop(rid, None)
        if blocks:
            self.engine.allocator.free(blocks)
        if ready_t is not None:
            self.prefetch_completed += 1
            try:
                from ray_tpu_torch.llm.kvfetch import metrics as kvfetch_metrics

                tags = {"model": self.engine.model_tag}
                kvfetch_metrics.prefetch_counter("completed").inc(1, tags=tags)
                kvfetch_metrics.prefetch_lead_histogram().observe(
                    max(0.0, time.time() - ready_t), tags=tags
                )
            except Exception:  # noqa: BLE001
                pass

    def cancel(self, rid: str) -> None:
        """Abort/flush discipline: release the reservation refs AND the
        staged state for an aborted (or preempted-away) request — the
        regression contract is an abort storm mid-prefetch leaking zero
        blocks and zero endpoint capacity. Deep-tier/fetched copies stay
        in the bounded host LRU: they are cache, not a leak."""
        with self._lock:
            blocks = self._reserved.pop(rid, None)
            staged = self._staged.pop(rid, None)
            ready = self._ready_t.pop(rid, None)
            self._attribution.pop(rid, None)
            self._cancelled[rid] = time.time()
            # bounded tombstones: the worker consults them only to skip
            # a racing task, so pruning the oldest is always safe
            while len(self._cancelled) > 1024:
                self._cancelled.pop(next(iter(self._cancelled)))
        if blocks:
            self.engine.allocator.free(blocks)
        if blocks or staged or ready is not None:
            with self._lock:
                self._note_wasted(rid)

    def reset(self, forget_blocks: bool = False) -> None:
        """Crash-recovery flush (engine.recover): drop every staged
        chain and reservation. ``forget_blocks`` when the allocator was
        rebuilt — the old block ids died with it and must NOT be freed
        into the new one."""
        with self._lock:
            reserved, self._reserved = self._reserved, {}
            self._staged.clear()
            self._ready_t.clear()
            self._attribution.clear()
        if not forget_blocks:
            for blocks in reserved.values():
                try:
                    self.engine.allocator.free(blocks)
                except Exception:  # noqa: BLE001 — torn allocator state
                    pass

    def _note_wasted(self, rid: str) -> None:
        """Count a prefetch that was never consumed (caller holds ``_lock``:
        the engine thread and the worker both count)."""
        self.prefetch_wasted += 1
        try:
            from ray_tpu_torch.llm.kvfetch import metrics as kvfetch_metrics

            kvfetch_metrics.prefetch_counter("wasted").inc(
                1, tags={"model": self.engine.model_tag}
            )
        except Exception:  # noqa: BLE001
            pass

    # -- worker ----------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop:
            try:
                task = self._tasks.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._process(*task)
            except Exception:  # noqa: BLE001 — a failed prefetch is a no-op
                self.prefetch_failures += 1
                logger.exception("prefetch task failed")
            finally:
                self._tasks.task_done()

    def _process(self, rid: str, prompt: list, salt: int) -> None:
        from ray_tpu_torch.llm.kv_cache import BlockAllocator

        with self._lock:
            if rid in self._cancelled:
                self._cancelled.pop(rid, None)
                self._note_wasted(rid)
                return
        eng = self.engine
        mgr = eng.kvtier
        # generation snapshot: a weight swap between here and staging
        # (or mid-fetch) invalidates everything this task produces
        gen0 = mgr.generation
        bs = eng.config.block_size
        # >=1 token stays un-cached so prefill yields next-token logits —
        # the same contract _resurrect_tiers keeps
        limit = (len(prompt) - 1) // bs
        h = salt
        plan: list = []  # (hash, block_tokens, n_prefix)
        for i in range(limit):
            blk = tuple(prompt[i * bs:(i + 1) * bs])
            h = BlockAllocator.chain_hash(h, blk)
            plan.append((h, blk, (i + 1) * bs))
        # classify: resident | local deep tier (verify NOW, off the
        # admission path) | needed from a remote holder
        entries: dict[int, tuple] = {}  # index -> staged entry
        needed: list = []               # (index, hash, blk, n_prefix)
        for i, (bh, blk, npfx) in enumerate(plan):
            if eng.allocator.contains_hash(bh):
                continue
            got = mgr.take_verified(bh, blk)
            if got is not None:
                entries[i] = (bh, got[1], npfx, got[0])
            else:
                needed.append((i, bh, blk, npfx))
        if needed and self.client is not None:
            self._fetch_remote(plan, needed, entries, gen0)
        # stage the longest CONTIGUOUS usable chain: every block index
        # must be resident or staged — a gap ends what admission can use
        staged: list = []
        for i, (bh, _blk, _npfx) in enumerate(plan):
            if eng.allocator.contains_hash(bh):
                continue
            e = entries.get(i)
            if e is None:
                break
            staged.append(e)
        with self._lock:
            if rid in self._cancelled or mgr.generation != gen0:
                # aborted, or a weight swap landed mid-task: the staged
                # chain references pre-swap KV — drop it entirely
                self._cancelled.pop(rid, None)
                self._note_wasted(rid)
                return
            self._staged[rid] = {
                "entries": staged, "salt": salt, "ready_t": time.time(),
            }
            if not staged:
                # nothing to scatter: the prefetch still "completed"
                # (local verification done / nothing coverable)
                self._staged.pop(rid, None)
                self._ready_t[rid] = time.time()
            # bounded bookkeeping: a ready mark landing AFTER its
            # request admitted is never consumed — pruning the oldest
            # is safe (the mark only feeds the lead-time histogram)
            while len(self._ready_t) > 4096:
                self._ready_t.pop(next(iter(self._ready_t)))

    def _fetch_remote(self, plan: list, needed: list,
                      entries: dict, gen0: int) -> None:
        """Pull the needed blocks from the best index-advertised remote
        holder; verified blocks are adopted into the LOCAL host tier
        (so a late prefetch still serves the admission-time resurrect)
        and staged for the tick scatter."""
        mgr = self.engine.kvtier
        index = mgr.index
        if index is None:
            return
        try:
            lookup = index.lookup([p[0] for p in plan])
        except Exception:  # noqa: BLE001 — dark index = no information
            lookup = None
        if not lookup:
            self.index_dark += 1
            return
        rows = lookup.get("engines") or {}
        best = None
        for key, row in rows.items():
            if key == mgr.engine_key:
                continue
            if row.get("age_s", 0.0) > self.cfg.index_stale_after_s:
                continue
            score = self.cfg.weight(row.get("tier")) * float(
                row.get("n_tokens", 0)
            )
            if score > 0.0 and (best is None or score > best[0]):
                best = (score, key, row)
        if best is None:
            return
        _score, src_key, row = best
        want = needed[: self.cfg.fetch_max_blocks]
        try:
            blocks = self.client.fetch(
                src_key, row.get("fetch_addr"),
                [w[1] for w in want], [w[2] for w in want],
                timeout_s=self.cfg.fetch_timeout_s,
            )
        except KVFetchError as e:
            self.fetch_failures += 1
            logger.warning("kvfetch from %s failed (%s); serving local "
                           "tiers only", src_key, e)
            return
        self.remote_fetches += 1
        for (i, bh, blk, npfx), sb in zip(want, blocks):
            if sb is None:
                continue
            if not mgr.verify_block(sb, blk):
                # corrupt in flight: counted drop, never scattered —
                # the chain breaks here and admission recomputes on
                self.fetch_corrupt_dropped += 1
                try:
                    from ray_tpu_torch.llm.kvfetch import metrics as kvfetch_metrics

                    kvfetch_metrics.fetch_corrupt_counter().inc(
                        1, tags={"model": self.engine.model_tag}
                    )
                except Exception:  # noqa: BLE001
                    pass
                continue
            self.remote_blocks += 1
            # adopt into the local host tier: even if the tick scatter
            # never runs (cache pressure), admission resurrects locally
            # (gen-guarded: a swap mid-fetch drops the stale adoption)
            mgr.adopt_fetched(bh, sb, gen=gen0)
            entries[i] = (bh, sb, npfx, f"remote:{row.get('tier', 'host')}")

    # -- lifecycle / introspection --------------------------------------------

    def wait_idle(self, timeout_s: float = 10.0) -> bool:
        """Bounded wait until every queued task has been processed (a task
        counts from its put to the end of its processing, so there is no
        window between the worker's get and its work)."""
        if self._thread is None:
            return True
        deadline = time.monotonic() + timeout_s
        done = self._tasks.all_tasks_done
        with done:
            while self._tasks.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._thread.is_alive():
                    return False
                done.wait(min(remaining, 0.1))
        return True

    def close(self) -> None:
        """Stop the prefetch worker (bounded join) and the fetch client."""
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self.client is not None:
            self.client.close()

    def stats(self) -> dict:
        with self._lock:
            staged = len(self._staged)
            reserved = sum(len(b) for b in self._reserved.values())
            wasted = self.prefetch_wasted
        out = {
            "prefetch": {
                "started": self.prefetch_started,
                "completed": self.prefetch_completed,
                "wasted": wasted,
                "skipped": self.prefetch_skipped,
                "failures": self.prefetch_failures,
                "staged": staged,
                "reserved_blocks": reserved,
            },
            "remote": {
                "fetches": self.remote_fetches,
                "blocks": self.remote_blocks,
                "corrupt_dropped": self.fetch_corrupt_dropped,
                "failures": self.fetch_failures,
                "index_dark": self.index_dark,
            },
        }
        if self.client is not None:
            out["client"] = self.client.stats()
        return out
