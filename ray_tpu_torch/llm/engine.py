"""Continuous-batching LLM engine (counterpart of ``ray_tpu/llm/engine.py``).

 * paged KV cache (``llm/kv_cache.py``) with prefix reuse;
 * scheduler: admit-prefill-then-decode with preemption by recompute and
   priority admission, host-side and O(batch);
 * mixed batching (``mixed_batch=True``): in-flight prefill chunks and
   every decode row in ONE ragged dispatch per step (``llm/mixed.py``,
   ``ops/ragged.py``); steps without prefill work take the decode path
   (``ops/paged_attention.py``);
 * chunked decode: up to ``decode_chunk`` decode+sample steps per host
   sync (``llm/decode_loop.py``).

The API mirrors the reference (add_request / step / generate / stats).
Not ported yet, and refused by ``EngineConfig`` with NotImplementedError
so no caller silently gets a different engine: speculative decoding,
the tiered KV cache, tensor-parallel meshes, LoRA adapters, pipelined
decode and the profiling hooks (ROADMAP.md, Queue 1). Chaos hooks, trace
spans and telemetry gauges are left out likewise.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.kv_cache import BlockAllocator, NoFreeBlocksError, SequenceBlocks
from ray_tpu_torch.llm.mixed import MixedBatchPlan, MixedStats
from ray_tpu_torch.llm.pipeline import CHUNK_BUCKETS, assemble_batch_arrays
from ray_tpu_torch.llm.sampling import (
    SamplingParams,
    request_seed_base,
    row_seed,
    sample_tokens,
)
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama_decode import decode_step, init_cache, mixed_step, prefill
from ray_tpu_torch.ops.paged_attention import pick_impl


@dataclasses.dataclass
class EngineConfig:
    model: llama.LlamaConfig = dataclasses.field(default_factory=lambda: llama.LLAMA_TINY)
    num_blocks: int = 512
    block_size: int = 16
    max_num_seqs: int = 16          # decode batch ceiling
    max_prefill_len: int = 1024     # longest admitted prompt suffix
    attn_impl: str = "auto"         # auto | torch (CPU) | cuda
    cache_dtype: Any = None          # default: model dtype
    enable_prefix_caching: bool = True
    eos_token_id: int = 2
    mesh_spec: Any = None
    max_loras: int = 0
    lora_rank: int = 8
    lora_targets: tuple = ("wq", "wv")
    # decode+sample steps per host round trip (llm/decode_loop.py);
    # 1 = one sync per token. EOS overshoot is discarded host-side.
    decode_chunk: int = 8
    # the reference defaults to True; the pipelined path is not ported yet
    pipeline_decode: bool = False
    profile: bool = False
    spec: Any = None
    kvtier: Any = None
    # mixed ragged batching (llm/mixed.py over ops/ragged.py): prompts
    # stream mixed_prefill_chunk tokens per step, packed with every decode
    # row into one dispatch
    mixed_batch: bool = False
    mixed_prefill_chunk: int = 256

    def __post_init__(self):
        if not isinstance(self.model, llama.LlamaConfig):
            raise TypeError(
                f"EngineConfig.model must be a LlamaConfig, got {type(self.model)} "
                "(the model registry is not ported yet)"
            )
        unported = (
            ("spec", self.spec is not None, "speculative decoding (Queue 1, B5)"),
            ("kvtier", self.kvtier is not None, "the tiered KV cache (Queue 1, C3)"),
            ("mesh_spec", self.mesh_spec is not None, "tensor-parallel serving (Queue 1, B4)"),
            ("max_loras", self.max_loras > 0, "LoRA adapters (Queue 1, B3/B4)"),
            ("pipeline_decode", self.pipeline_decode, "pipelined decode (Queue 1, B4)"),
            ("profile", self.profile, "the decode profiling hooks (Queue 1, slice E)"),
        )
        for name, requested, item in unported:
            if requested:
                raise NotImplementedError(
                    f"EngineConfig.{name}: {item} is not ported to ray_tpu_torch "
                    "yet; see ROADMAP.md"
                )
        if self.attn_impl not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        # a prefill bucket longer than the context window can never be used
        self.max_prefill_len = min(self.max_prefill_len, self.model.max_seq)
        self.decode_chunk = min(self.decode_chunk, CHUNK_BUCKETS[-1])
        self.mixed_prefill_chunk = max(
            1, min(self.mixed_prefill_chunk, self.max_prefill_len)
        )

    def prefill_buckets(self) -> list[int]:
        out, b = [], 16
        while b < self.max_prefill_len:
            out.append(b)
            b *= 2
        out.append(self.max_prefill_len)
        return out

    def decode_buckets(self) -> list[int]:
        out, b = [], 1
        while b < self.max_num_seqs:
            out.append(b)
            b *= 2
        out.append(self.max_num_seqs)
        return out

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.model.max_seq // self.block_size)


class RequestStatus:
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    ABORTED = "aborted"


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_token_ids: list
    sampling_params: SamplingParams
    output_token_ids: list = dataclasses.field(default_factory=list)
    status: str = RequestStatus.WAITING
    seq: Optional[SequenceBlocks] = None
    arrival: float = dataclasses.field(default_factory=time.time)
    finish_reason: Optional[str] = None
    num_preemptions: int = 0
    cumulative_logprob: float = 0.0
    token_logprobs: list = dataclasses.field(default_factory=list)
    # higher priority admits first and may preempt lower-priority requests
    priority: int = 0
    # seed of this request's sampling streams (sampling.request_seed_base)
    seed_base: int = 0
    # wall time the first output token was booked (survives preemption)
    t_first_token: Optional[float] = None

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    new_token_ids: list
    output_token_ids: list
    finished: bool
    finish_reason: Optional[str] = None
    num_cached_tokens: int = 0


class LLMEngine:
    def __init__(
        self,
        config: EngineConfig,
        params: Optional[llama.Params] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.config = config
        c = config
        self.device = resolve_device(device)
        pick_impl("attn_impl", self.device, c.attn_impl)  # refuse a mismatch now, not mid-step
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = llama.init_params(c.model, gen, self.device, dtype=c.model.dtype)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on {self.device}"
            )
        # serving keeps its weights in the compute dtype (a no-op when they are)
        self.params = llama.cast_params(params, c.model.dtype)
        self.allocator = BlockAllocator(c.num_blocks, c.block_size)
        self.cache = init_cache(
            c.model, c.num_blocks * c.block_size, dtype=c.cache_dtype,
            trash_slots=c.block_size, device=self.device,
        )
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.requests: dict[str, Request] = {}  # unfinished only
        self.num_preemptions = 0
        self._counter = itertools.count()
        self._seed = seed ^ 0x5EED
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.num_prefill_batches = 0
        # mixed ragged batching: prefill cursors (request_id -> next
        # un-prefilled absolute token index; a request in here is RUNNING
        # but mid-prompt) and padding-waste stats. The cursor dict exists
        # unconditionally so preempt/abort never need a mode check.
        self._mixed_prefills: dict[str, int] = {}
        self._mixed_stats = MixedStats() if c.mixed_batch else None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    @staticmethod
    def _sample_mode(batch) -> str:
        """Sampler fast path for this batch: greedy and plain-temperature
        batches skip the top-k/top-p machinery; a request with top_k >
        TOP_CAP forces the exact full sort. Greedy requests' knobs are
        ignored (top-k/top-p cannot change an argmax)."""
        sampled = [r for r in batch if not r.sampling_params.greedy]
        if not sampled:
            return "greedy"
        if all(
            r.sampling_params.top_k <= 0 and r.sampling_params.top_p >= 1.0
            for r in sampled
        ):
            return "categorical"
        if any(r.sampling_params.needs_full_sort for r in sampled):
            return "full_sort"
        return "full"

    # -- public API -----------------------------------------------------------

    def add_request(
        self,
        prompt_token_ids: list,
        sampling_params: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        priority: int = 0,
    ) -> str:
        sp = sampling_params or SamplingParams()
        rid = request_id or f"req-{next(self._counter)}"
        if len(prompt_token_ids) > self.config.max_prefill_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} exceeds "
                f"max_prefill_len={self.config.max_prefill_len}"
            )
        # must leave room for >= 1 generated token inside the RoPE tables
        if len(prompt_token_ids) >= self.config.model.max_seq:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} >= model max_seq="
                f"{self.config.model.max_seq}; prompts must be shorter than "
                "the model context window"
            )
        # a prompt the cache can NEVER hold would wedge the queue head
        need = self.allocator.blocks_needed(len(prompt_token_ids) + 1)
        if need > self.config.num_blocks:
            raise ValueError(
                f"prompt needs {need} KV blocks but the cache has only "
                f"{self.config.num_blocks}; raise num_blocks or shorten it"
            )
        req = Request(rid, list(map(int, prompt_token_ids)), sp)
        req.priority = int(priority)
        req.seed_base = request_seed_base(
            self._seed if sp.seed is None else sp.seed, rid
        )
        self.requests[rid] = req
        self.waiting.append(req)
        return rid

    def abort_request(self, request_id: str) -> None:
        req = self.requests.get(request_id)
        if req is None or req.status in (RequestStatus.FINISHED, RequestStatus.ABORTED):
            return
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        self._mixed_prefills.pop(request_id, None)
        if req.seq is not None:
            req.seq.release()
        req.status = RequestStatus.ABORTED
        req.finish_reason = "abort"
        self.requests.pop(request_id, None)

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running)

    def step(self) -> list[RequestOutput]:
        """One engine iteration: admit + prefill waiting requests, else
        decode (or, with mixed batching, one mixed dispatch)."""
        if self.waiting:
            # QoS admission order: the highest-priority waiting request
            # first (strictly FIFO when priorities are uniform)
            self._promote_priority()
            head = self.waiting[0]
            if head.priority > 0 and self.running and (
                len(self.running) >= self.config.max_num_seqs
                or self._admission_need(head) > self.allocator.num_free
            ):
                # priority preemption: a request blocked on batch-slot or
                # KV pressure displaces the lowest-priority running one,
                # which recomputes later
                victim = min(self.running, key=lambda r: (r.priority, -r.arrival))
                if victim.priority < head.priority:
                    self._preempt_one(below_priority=head.priority)
                    self._promote_priority()
        if self.config.mixed_batch:
            return self._mixed_step()
        if (
            self.waiting
            and len(self.running) < self.config.max_num_seqs
            # read-only precheck: free blocks must cover the head's prompt
            # minus live-shared prefix-cache hits
            and self._admission_need(self.waiting[0]) <= self.allocator.num_free
        ):
            admitted: list = []  # (req, last-token logits [1, V]) pairs
            while self.waiting and len(self.running) < self.config.max_num_seqs:
                got = self._prefill_one()
                if got is None:
                    break  # no cache room: decode to free blocks
                admitted.append(got)
            if admitted:
                reqs = [r for r, _ in admitted]
                logits = torch.cat([lg for _, lg in admitted], dim=0)
                tok, logprob = self._sample_batch(logits, reqs)
                return self._append_tokens(reqs, tok, logprob)
        if self.running:
            return self._decode_step()
        return []

    def generate(
        self,
        prompts: list,
        sampling_params: "SamplingParams | list[SamplingParams] | None" = None,
    ) -> list:
        """Blocking batch generation; returns output token lists in order."""
        if sampling_params is None or isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params or SamplingParams()] * len(prompts)
        rids = [
            self.add_request(p, sp) for p, sp in zip(prompts, sampling_params)
        ]
        finals: dict[str, list] = {}
        while self.has_unfinished():
            for out in self.step():
                if out.finished:
                    finals[out.request_id] = out.output_token_ids
        return [finals[r] for r in rids]

    def stats(self) -> dict:
        out = {
            "num_waiting": len(self.waiting),
            "num_running": len(self.running),
            "free_blocks": self.allocator.num_free,
            "total_blocks": self.config.num_blocks,
            "num_prefill_batches": self.num_prefill_batches,
            "num_preemptions": self.num_preemptions,
            "prefix_cache": {
                "hit_tokens": self.prefix_hit_tokens,
                "lookup_tokens": self.prefix_lookup_tokens,
                "hit_rate": (
                    round(self.prefix_hit_tokens / self.prefix_lookup_tokens, 4)
                    if self.prefix_lookup_tokens else 0.0
                ),
            },
        }
        if self._mixed_stats is not None and self._mixed_stats.dispatches:
            out["mixed"] = self._mixed_stats.to_dict()
        return out

    # -- admission -------------------------------------------------------------

    def _admission_need(self, req) -> int:
        """Free-pool blocks admitting ``req`` would consume."""
        if not self.config.enable_prefix_caching:
            return self.allocator.blocks_needed(req.num_tokens)
        return self.allocator.probe_admission_need(
            req.prompt_token_ids + req.output_token_ids
        )

    def _pad_to_bucket(self, n: int, buckets: list) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _admit_one(self):
        """Admit the head of the waiting queue: prefix match, capacity
        reservation for the FULL recompute prompt, hit accounting —
        everything up to (not including) dispatch. Returns
        (req, seq, prompt, matched), or None when the cache has no room."""
        c = self.config
        req = self.waiting[0]
        seq = SequenceBlocks(self.allocator)
        # after a preemption the recompute covers prompt + generated tokens
        prompt = req.prompt_token_ids + req.output_token_ids
        matched_blocks: list = []
        matched = 0
        if c.enable_prefix_caching:
            blocks, matched, chain = self.allocator.match_prefix(prompt)
            if matched >= len(prompt):
                # whole prompt cached: leave >= 1 token to prefill so there
                # are next-token logits
                self.allocator.free(blocks)
                blocks, matched, chain = self.allocator.match_prefix(prompt[:-1])
            if blocks:
                seq.adopt_prefix(blocks, chain, matched)
                matched_blocks = blocks
        try:
            seq.ensure_capacity(len(prompt))
        except NoFreeBlocksError:
            if matched_blocks:
                seq.release()
            return None  # no room: fall through to decode; retry later
        self.waiting.popleft()
        self.num_prefill_batches += 1
        # hit accounting over the ORIGINAL prompt only: a preemption
        # recompute re-matching its own sealed blocks is not a hit
        if req.num_preemptions == 0:
            self.prefix_lookup_tokens += len(req.prompt_token_ids)
            self.prefix_hit_tokens += min(matched, len(req.prompt_token_ids))
        return req, seq, prompt, matched

    def _prefill_one(self):
        """Prefill the head of the waiting queue (no host sync). Returns
        (req, last-token logits [1, V]) or None when the cache has no room."""
        got = self._admit_one()
        if got is None:
            return None
        req, seq, prompt, matched = got
        c = self.config
        num_slots = c.num_blocks * c.block_size
        bt = np.zeros((1, self._bt_width([len(seq.blocks)])), np.int32)
        bt[0, : len(seq.blocks)] = seq.blocks
        bt = self._tensor(bt)
        # chunked prefill: a preemption recompute can exceed max_prefill_len;
        # each chunk extends context_lens, only the last chunk's logits count
        logits = None
        for start in range(matched, len(prompt), c.max_prefill_len):
            chunk = prompt[start : start + c.max_prefill_len]
            S_pad = self._pad_to_bucket(len(chunk), c.prefill_buckets())
            tokens = np.zeros((1, S_pad), np.int32)
            tokens[0, : len(chunk)] = chunk
            positions = np.zeros((1, S_pad), np.int32)
            positions[0, : len(chunk)] = np.arange(start, start + len(chunk))
            slots = np.full((1, S_pad), num_slots, np.int32)  # trash by default
            slots[0, : len(chunk)] = seq.slots_for_range(start, start + len(chunk))
            logits, self.cache = prefill(
                self.params, self._tensor(tokens), self._tensor(positions),
                self._tensor([len(chunk)]), self._tensor(slots), bt,
                self._tensor(np.asarray([start + len(chunk)], np.int32)),
                self.cache, c.model, block_size=c.block_size,
            )
        seq.num_tokens = len(prompt)
        if c.enable_prefix_caching:
            seq.seal_full_blocks(prompt)
        req.seq = seq
        req.status = RequestStatus.RUNNING
        self.running.append(req)
        return req, logits

    # -- mixed ragged batching -------------------------------------------------

    def _mixed_admit(self):
        """Admit the queue head WITHOUT dispatching its prompt: the mixed
        dispatch feeds it chunk by chunk from the cursor this records."""
        got = self._admit_one()
        if got is None:
            return None
        req, seq, prompt, matched = got
        # seq.num_tokens tracks positions with K/V WRITTEN: the matched
        # prefix until chunks land
        seq.num_tokens = matched
        req.seq = seq
        req.status = RequestStatus.RUNNING
        self.running.append(req)
        self._mixed_prefills[req.request_id] = matched
        return req

    def _mixed_step(self) -> list[RequestOutput]:
        """One mixed-batch iteration: admit waiting requests, then serve
        every in-flight prefill chunk plus every decode row in ONE ragged
        dispatch. Steps with no prefill work take the regular decode path."""
        c = self.config
        if (
            self.waiting
            and len(self.running) < c.max_num_seqs
            and self._admission_need(self.waiting[0]) <= self.allocator.num_free
        ):
            while self.waiting and len(self.running) < c.max_num_seqs:
                if self._mixed_admit() is None:
                    break  # no cache room: decode to free blocks
        if not self._mixed_prefills:
            return self._decode_step() if self.running else []
        # KV for this step's writes: mid-prompt rows reserved their full
        # recompute prompt at admission; decode rows grow one position
        while True:
            try:
                for r in self.running:
                    if r.request_id not in self._mixed_prefills:
                        r.seq.ensure_capacity(r.num_tokens + 1)
                break
            except NoFreeBlocksError:
                if not self._preempt_one():
                    raise  # single running request can't fit: cache too small
        plan = MixedBatchPlan.build(self)
        logits, self.cache = mixed_step(
            self.params, self._tensor(plan.tokens), self._tensor(plan.positions),
            self._tensor(plan.slots), self._tensor(plan.bt),
            self._tensor(plan.cu_q_lens), self._tensor(plan.context_lens),
            self.cache, c.model, block_size=c.block_size,
            max_q_len=c.mixed_prefill_chunk, attn_impl=c.attn_impl,
        )
        plan.note(self._mixed_stats)

        # advance prefill cursors; a finishing prompt seals its full blocks
        # and becomes a decode row
        done_set = set(plan.completes)
        for row in range(plan.B):
            if plan.kinds[row] != "prefill":
                continue
            r = plan.reqs[row]
            end = plan.starts[row] + plan.chunk_lens[row]
            r.seq.num_tokens = end
            if row in done_set:
                if c.enable_prefix_caching:
                    r.seq.seal_full_blocks(r.prompt_token_ids + r.output_token_ids)
                del self._mixed_prefills[r.request_id]
            else:
                self._mixed_prefills[r.request_id] = end

        if not plan.emit_rows:
            return []
        emit_reqs = [plan.reqs[i] for i in plan.emit_rows]
        tok, logprob = self._sample_batch(
            logits[self._tensor(np.asarray(plan.emit_rows, np.int64))], emit_reqs
        )
        return self._append_tokens(emit_reqs, tok, logprob)

    # -- scheduling ------------------------------------------------------------

    def _promote_priority(self) -> None:
        """Move the highest-priority waiting request to the queue head
        (stable: FIFO within a priority class)."""
        w = self.waiting
        if len(w) < 2:
            return
        best_i = max(range(len(w)), key=lambda i: (w[i].priority, -i))
        if best_i:
            req = w[best_i]
            del w[best_i]
            w.appendleft(req)

    def _preempt_one(self, below_priority: Optional[int] = None) -> bool:
        """Kick a running request back to waiting (recompute). The victim
        is the lowest-priority, newest-arrival request. ``below_priority``
        only preempts a victim strictly below it and may empty the batch;
        the KV-pressure path keeps a batch of one running."""
        if not self.running:
            return False
        if below_priority is None and len(self.running) <= 1:
            return False
        victim = min(self.running, key=lambda r: (r.priority, -r.arrival))
        if below_priority is not None and victim.priority >= below_priority:
            return False
        self.running.remove(victim)
        # a mid-prefill mixed row re-queues like any victim
        self._mixed_prefills.pop(victim.request_id, None)
        victim.seq.release()
        victim.seq = None
        # outputs are kept; re-admission prefills prompt + outputs
        victim.status = RequestStatus.WAITING
        victim.num_preemptions += 1
        self.num_preemptions += 1
        self.waiting.appendleft(victim)
        return True

    def _bt_width(self, page_counts) -> int:
        """Block-table width for this call: the batch's real page count
        rounded up to a power of two (floor 16 blocks), capped at the
        model maximum."""
        w = max(list(page_counts) or [1])
        w = 1 << max(0, (w - 1)).bit_length()
        w = max(w, min(16, self.config.max_blocks_per_seq))
        return min(w, self.config.max_blocks_per_seq)

    def _chunk_steps(self) -> int:
        """Device-side steps this round: the configured chunk, shrunk only
        by the HARD max_seq wall (positions past it index off the RoPE
        table), floored to a power of two."""
        c = self.config
        n = max(1, c.decode_chunk)
        for r in self.running:
            n = min(n, max(1, c.model.max_seq - r.num_tokens))
        return 1 << (n.bit_length() - 1)

    def _remaining(self, r) -> int:
        """Output tokens this request can still KEEP (max_tokens budget)."""
        return max(1, r.sampling_params.max_tokens - len(r.output_token_ids))

    def _decode_step(self) -> list[RequestOutput]:
        return self._plain_decode_step()

    def _plain_decode_step(self) -> list[RequestOutput]:
        c = self.config
        n_steps = self._chunk_steps()
        # grow each sequence by the chunk's slots it can USE: overshoot
        # steps past max_tokens write the trash page (decode_loop
        # `remaining`). Preempt on real cache pressure only.
        while True:
            try:
                for r in self.running:
                    r.seq.ensure_capacity(
                        r.num_tokens + min(n_steps, self._remaining(r))
                    )
                break
            except NoFreeBlocksError:
                if not self._preempt_one():
                    raise  # single running request can't fit: cache too small
        batch = list(self.running)
        B = len(batch)
        B_pad = self._pad_to_bucket(B, c.decode_buckets())
        num_slots = c.num_blocks * c.block_size
        a, seed_bases = assemble_batch_arrays(
            batch, B_pad, self._bt_width([len(r.seq.blocks) for r in batch])
        )

        if n_steps == 1:
            slot_mapping = np.full(B_pad, num_slots, np.int32)
            for i, r in enumerate(batch):
                slot_mapping[i] = r.seq.slot(int(a["positions"][i]))
            logits, self.cache = decode_step(
                self.params, self._tensor(a["tokens"]), self._tensor(a["positions"]),
                self._tensor(slot_mapping), self._tensor(a["bt"]),
                self._tensor(a["context_lens"]), self.cache, c.model,
                block_size=c.block_size, attn_impl=c.attn_impl,
            )
            tok, logprob = self._sample_batch(logits[:B], batch)
            return self._append_tokens(batch, tok, logprob)

        # multi-step chunk: decode+sample n_steps times on the device, one
        # sync. Seeds derive from (request seed base, absolute output
        # index): identical sampling however the chunks fall
        from ray_tpu_torch.llm.decode_loop import decode_chunk

        remaining = np.zeros(B_pad, np.int32)
        for i, r in enumerate(batch):
            remaining[i] = self._remaining(r)
        toks, logprobs, self.cache = decode_chunk(
            self.params, self._tensor(a["tokens"]), self._tensor(a["positions"]),
            self._tensor(a["bt"]), self._tensor(a["context_lens"]), self.cache,
            self._tensor(a["temps"]), self._tensor(a["top_ks"]),
            self._tensor(a["top_ps"]), seed_bases, a["starts"].tolist(),
            self._tensor(remaining), c.model, n_steps=n_steps,
            block_size=c.block_size, trash_slot=num_slots,
            attn_impl=c.attn_impl, sample_mode=self._sample_mode(batch),
        )
        # the chunk's one host sync
        return self._append_chunk(batch, toks.cpu().numpy(), logprobs.cpu().numpy())

    # -- sampling + bookkeeping ----------------------------------------------

    def _sample_batch(self, logits, batch: list) -> tuple[np.ndarray, np.ndarray]:
        B = len(batch)
        sps = [r.sampling_params for r in batch]
        # seed = f(request seed base, absolute output index): the same
        # request samples the same stream in any chunking, under any load
        seeds = [
            None if sp.greedy else row_seed(r.seed_base, len(r.output_token_ids))
            for r, sp in zip(batch, sps)
        ]
        toks, logprobs = sample_tokens(
            logits[:B],
            self._tensor(np.asarray([sp.temperature for sp in sps], np.float32)),
            self._tensor(np.asarray([sp.top_k for sp in sps], np.int64)),
            self._tensor(np.asarray([sp.top_p for sp in sps], np.float32)),
            seeds,
            mode=self._sample_mode(batch),
        )
        return toks.cpu().numpy(), logprobs.cpu().numpy()

    def _append_chunk(self, batch: list, toks, logprobs) -> list[RequestOutput]:
        """Host bookkeeping after a device-side chunk: walk each request's
        token column in order, keep until a stop condition fires, discard
        the overshoot (its KV sits in the request's own unsealed blocks,
        released with the sequence). One RequestOutput per request."""
        c = self.config
        outputs = []
        now = time.time()
        for i, r in enumerate(batch):
            sp = r.sampling_params
            new_toks: list[int] = []
            finished = False
            if r.t_first_token is None:
                r.t_first_token = now
            for s in range(toks.shape[0]):
                t = int(toks[s, i])
                lp = float(logprobs[s, i])
                new_toks.append(t)
                r.output_token_ids.append(t)
                r.cumulative_logprob += lp
                if sp.logprobs:
                    r.token_logprobs.append(lp)
                if not sp.ignore_eos and t == c.eos_token_id:
                    finished, r.finish_reason = True, "stop"
                elif t in sp.stop_token_ids:
                    finished, r.finish_reason = True, "stop"
                elif len(r.output_token_ids) >= sp.max_tokens:
                    finished, r.finish_reason = True, "length"
                elif r.num_tokens >= c.model.max_seq:
                    finished, r.finish_reason = True, "length"
                if finished:
                    break
            num_cached = r.seq.num_cached_tokens if r.seq else 0
            written = r.prompt_token_ids + r.output_token_ids[:-1]
            if c.enable_prefix_caching:
                # seals only blocks fully covered by `written`
                r.seq.seal_full_blocks(written)
            if finished:
                r.status = RequestStatus.FINISHED
                self.running.remove(r)
                r.seq.release()
                self.requests.pop(r.request_id, None)
            else:
                r.seq.num_tokens = r.num_tokens
            outputs.append(
                RequestOutput(
                    request_id=r.request_id,
                    new_token_ids=new_toks,
                    output_token_ids=list(r.output_token_ids),
                    finished=finished,
                    finish_reason=r.finish_reason,
                    num_cached_tokens=num_cached,
                )
            )
        return outputs

    def _append_tokens(self, batch: list, toks, logprobs) -> list[RequestOutput]:
        """Single-step bookkeeping: the n = 1 case of _append_chunk."""
        return self._append_chunk(
            batch, np.asarray(toks)[None, :], np.asarray(logprobs)[None, :]
        )
