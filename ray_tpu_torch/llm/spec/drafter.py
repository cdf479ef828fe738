"""Draft-token proposal sources for speculative decoding (counterpart of
``ray_tpu/llm/spec/drafter.py``).

Both drafters are deterministic (a proposal is a point distribution),
which keeps the acceptance math simple: accept token x with probability
p_target(x), resample on reject from the residual (accept.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.llm.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    NoFreeBlocksError,
    SequenceBlocks,
)


class Drafter:
    """Interface: propose up to k continuation tokens for a request.

    ``tokens`` is the request's full visible history (prompt + generated).
    ``release`` drops any per-request state (finish/abort/preempt)."""

    def propose(self, request_id: str, tokens: list, k: int) -> list:
        raise NotImplementedError

    def release(self, request_id: str) -> None:  # stateless by default
        return None


class PromptLookupDrafter(Drafter):
    """Model-free prompt-lookup (n-gram) drafting: find the longest suffix
    n-gram (max_ngram down to min_ngram) of the history that occurred
    earlier, and propose the k tokens that followed its most recent
    earlier occurrence."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_history: int = 4096):
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_history = max_history

    def propose(self, request_id: str, tokens: list, k: int) -> list:
        toks = tokens[-self.max_history:]
        n_tok = len(toks)
        if n_tok < 2:
            return []
        arr = np.asarray(toks, dtype=np.int64)
        for n in range(min(self.max_ngram, n_tok - 1), self.min_ngram - 1, -1):
            pat = arr[n_tok - n:]
            # windows over arr[:-1]: every occurrence strictly before the
            # suffix itself (overlapping it is fine: a short cycle)
            wins = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
            hits = np.flatnonzero((wins == pat).all(axis=1))
            if hits.size:
                # most recent earlier occurrence: recency beats frequency
                i = int(hits[-1])
                return [int(t) for t in toks[i + n : i + n + k]]
        return []


class DraftModelDrafter(Drafter):
    """Greedy drafting with a smaller model over its OWN paged KV cache:
    ``prefill`` ingests history deltas, ``decode_step`` (the paged kernel
    on the card) extends greedily, with a private BlockAllocator /
    SequenceBlocks per request. Sync with the target engine is by longest
    common prefix: a rejected or resampled token shows up as a history
    mismatch and rolls the draft sequence back with ``truncate_to``."""

    def __init__(
        self,
        model_config,
        params=None,
        *,
        kv: Optional[KVCacheConfig] = None,
        seed: int = 0,
        device="cuda",
    ):
        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.llama_decode import init_cache

        c = model_config
        self.config = c
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = llama.init_params(c, gen, self.device, dtype=c.dtype)
        self.params = llama.cast_params(params, c.dtype)
        kv = kv or KVCacheConfig()
        self.kv = KVCacheConfig(kv.num_blocks, kv.block_size, kv.dtype or c.dtype)
        self.allocator = BlockAllocator(self.kv.num_blocks, self.kv.block_size)
        self.cache = init_cache(
            c, self.kv.num_slots, dtype=self.kv.dtype,
            trash_slots=self.kv.block_size, device=self.device,
        )
        self._states: dict[str, dict] = {}  # rid -> {"seq", "hist"}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _bt(self, seq: SequenceBlocks) -> torch.Tensor:
        w = max(1, 1 << (max(1, len(seq.blocks)) - 1).bit_length())
        bt = np.zeros((1, w), np.int32)
        bt[0, : len(seq.blocks)] = seq.blocks
        return self._t(bt)

    def _feed_chunk(self, seq: SequenceBlocks, chunk: list, start: int):
        """Prefill ``chunk`` at absolute positions start.. -> last logits."""
        from ray_tpu_torch.models.llama_decode import prefill

        S_pad = max(8, 1 << (len(chunk) - 1).bit_length())
        tokens = np.zeros((1, S_pad), np.int32)
        tokens[0, : len(chunk)] = chunk
        positions = np.zeros((1, S_pad), np.int32)
        positions[0, : len(chunk)] = np.arange(start, start + len(chunk))
        slots = np.full((1, S_pad), self.kv.num_slots, np.int32)
        slots[0, : len(chunk)] = seq.slots_for_range(start, start + len(chunk))
        logits, self.cache = prefill(
            self.params, self._t(tokens), self._t(positions), self._t([len(chunk)]),
            self._t(slots), self._bt(seq), self._t([start + len(chunk)]), self.cache,
            self.config, block_size=self.kv.block_size,
        )
        return logits

    def propose(self, request_id: str, tokens: list, k: int) -> list:
        from ray_tpu_torch.models.llama_decode import decode_step

        c = self.config
        if len(tokens) + k >= c.max_seq:
            k = c.max_seq - 1 - len(tokens)
        if k <= 0:
            return []
        st = self._states.get(request_id)
        if st is None:
            st = {"seq": SequenceBlocks(self.allocator), "hist": []}
            self._states[request_id] = st
        seq, hist = st["seq"], st["hist"]

        # sync by longest common prefix: a rejected draft shows up here as
        # a mismatch and rolls the draft KV back with truncate_to
        common = 0
        for a, b in zip(hist, tokens):
            if a != b:
                break
            common += 1
        if common == len(tokens):
            # everything already fed: re-feed the last token for its logits
            common = len(tokens) - 1
        if common < len(hist):
            seq.truncate_to(common)
            del hist[common:]

        try:
            seq.ensure_capacity(len(tokens) + k)
        except NoFreeBlocksError:
            # draft cache full: drafting is best-effort, drop this request's state
            self.release(request_id)
            return []

        # feed the history delta (bounded chunks keep pad buckets small)
        logits = None
        pos = common
        missing = tokens[common:]
        while missing:
            chunk = missing[:128]
            logits = self._feed_chunk(seq, chunk, pos)
            hist.extend(chunk)
            pos += len(chunk)
            missing = missing[len(chunk):]
        seq.num_tokens = len(tokens)

        # greedy extension: k decode steps on the draft cache
        drafted: list = []
        tok = int(torch.argmax(logits[0]))
        for _ in range(k):
            drafted.append(tok)
            p = len(tokens) + len(drafted) - 1
            logits, self.cache = decode_step(
                self.params, self._t([tok]), self._t([p]), self._t([seq.slot(p)]),
                self._bt(seq), self._t([p + 1]), self.cache, c,
                block_size=self.kv.block_size,
            )
            tok = int(torch.argmax(logits[0]))
        hist.extend(drafted)
        seq.num_tokens = len(tokens) + len(drafted)
        return drafted

    def release(self, request_id: str) -> None:
        st = self._states.pop(request_id, None)
        if st is not None:
            st["seq"].release()
