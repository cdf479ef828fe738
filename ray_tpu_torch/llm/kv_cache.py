"""Paged KV cache bookkeeping: the host-side block allocator (a copy of
``ray_tpu/llm/kv_cache.py``'s ``BlockAllocator`` / ``SequenceBlocks``,
kept here so the port imports nothing from the JAX package).

 * the device cache is two tensors per model, K and V, each HEAD-MAJOR
   [n_layers, n_kv_heads, num_blocks * block_size + trash, head_dim]
   (``models/llama_decode.init_cache``) with flat slot addressing
   (slot = block_id * block_size + offset);
 * the allocator hands out blocks, refcounts them, and reuses full blocks
   across requests via content hashing (prefix caching: hash chains over
   block token contents).

Chains are salted per LoRA adapter slot (slot 0, the base model, roots
at 0), and ``drop_prefix_cache(salt=...)`` drops one slot's chains.

The allocator's handoff surface is the reference's too: the read-only
``probe_prefix`` (the disaggregated decode pick, ``llm/disagg``) and
``contains_hash`` probes, and the ``seal_listener`` / ``evict_listener`` /
``drop_listener`` hooks, fired where the reference fires them (their
reader there, the tiered cache ``llm/kvtier``, is not ported: ROADMAP.md
Queue 1, C3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class KVCacheConfig:
    """Capacity knobs of a paged cache (the draft model's, in speculative
    decoding; its layer and head dims follow the model). ``dtype`` None
    means the model's compute dtype; the reference defaults to bf16, but
    the CUDA kernels need the cache in the query's dtype."""

    num_blocks: int = 256
    block_size: int = 16  # tokens per block
    dtype: Any = None

    @property
    def num_slots(self) -> int:
        return self.num_blocks * self.block_size


class NoFreeBlocksError(Exception):
    pass


class BlockAllocator:
    """Refcounted block allocator with prefix caching.

    Full blocks are immutable once written and keyed by
    hash((parent_hash, tuple(block_tokens))); a request's trailing
    partial block is always private. Freed blocks with a hash linger in
    a reuse pool (LRU) until evicted by allocation pressure — a cache
    hit resurrects them without recompute.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._refcount: dict[int, int] = {}
        # content hash -> block_id for REUSABLE blocks (ref >= 0; 0 means
        # only the cache holds it)
        self._hash_to_block: dict[int, int] = {}
        self._block_hash: dict[int, int] = {}
        # content hash -> root salt of its chain (a chain's first block has
        # the salt as its parent hash, so the root propagates hash to
        # hash). Chain metadata, not residency: it survives eviction, so a
        # resurrected chain still resolves; cleared only by a full drop
        self._hash_salt: dict[int, int] = {}
        # LRU order of zero-ref cached blocks (eviction candidates)
        self._zero_ref_lru: list[int] = []
        # hooks: seal_listener(block_id, hash, parent_hash, tokens,
        # n_prefix_tokens) when a full block becomes canonical under its
        # hash; evict_listener(block_id, hash) just before a zero-ref cached
        # block is reused (its pages still intact); drop_listener(salt) on
        # drop_prefix_cache. A listener that raises never breaks the
        # allocator
        self.seal_listener = None
        self.evict_listener = None
        self.drop_listener = None

    # -- stats ---------------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._zero_ref_lru)

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    # -- core ops ------------------------------------------------------------

    def _pop_block(self) -> int:
        if self._free:
            return self._free.pop()
        if self._zero_ref_lru:
            victim = self._zero_ref_lru.pop(0)  # oldest cached block
            h = self._block_hash.pop(victim, None)
            if h is not None:
                self._hash_to_block.pop(h, None)
                if self.evict_listener is not None:
                    try:
                        self.evict_listener(victim, h)
                    except Exception:  # noqa: BLE001
                        pass
            return victim
        raise NoFreeBlocksError("KV cache exhausted")

    def allocate(self, n: int) -> list[int]:
        """n fresh private blocks (no hash)."""
        if self.num_free < n:
            raise NoFreeBlocksError(
                f"need {n} KV blocks, only {self.num_free} free"
            )
        out = []
        for _ in range(n):
            b = self._pop_block()
            self._refcount[b] = 1
            out.append(b)
        return out

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            rc = self._refcount.get(b, 0) - 1
            if rc > 0:
                self._refcount[b] = rc
                continue
            self._refcount.pop(b, None)
            if b in self._block_hash:
                # keep contents around for prefix reuse until evicted
                self._zero_ref_lru.append(b)
            else:
                self._free.append(b)

    # -- prefix caching -------------------------------------------------------

    @staticmethod
    def chain_hash(parent_hash: int, block_tokens: tuple) -> int:
        # hashes of ints and tuples of ints are not salted per process
        return hash((parent_hash, block_tokens))

    def drop_prefix_cache(self, salt: Optional[int] = None) -> None:
        """Invalidate cached prefixes: zero-ref cached blocks return to
        the free list, live blocks lose their hashes (they stay private to
        their sequences). With ``salt`` only the chains rooted at that salt
        go (one adapter slot's prefixes, when the slot is reused)."""
        if salt is None:
            for b in self._zero_ref_lru:
                self._free.append(b)
            self._zero_ref_lru.clear()
            self._hash_to_block.clear()
            self._block_hash.clear()
            self._hash_salt.clear()
        else:
            for h in [h for h, s in self._hash_salt.items() if s == salt]:
                del self._hash_salt[h]
                b = self._hash_to_block.pop(h, None)
                if b is None:
                    continue
                self._block_hash.pop(b, None)
                if b in self._zero_ref_lru:
                    self._zero_ref_lru.remove(b)
                    self._free.append(b)
        if self.drop_listener is not None:
            try:
                self.drop_listener(salt)
            except Exception:  # noqa: BLE001
                pass

    def register_full_block(self, block_id: int, content_hash: int,
                            parent_hash: Optional[int] = None,
                            tokens: Optional[tuple] = None,
                            n_prefix_tokens: int = 0) -> None:
        """Mark a just-written full block reusable under its content hash;
        ``parent_hash`` is the hash it chains from (the salt for a first
        block). ``tokens`` and ``n_prefix_tokens`` are the chain metadata
        the seal listener receives (a sealer passing no tokens fires none)."""
        existing = self._hash_to_block.get(content_hash)
        if existing is not None and existing != block_id:
            return  # another copy already canonical; keep ours private
        self._hash_to_block[content_hash] = block_id
        self._block_hash[block_id] = content_hash
        parent = 0 if parent_hash is None else parent_hash
        self._hash_salt[content_hash] = self._hash_salt.get(parent, parent)
        if self.seal_listener is not None and tokens is not None:
            try:
                self.seal_listener(block_id, content_hash, parent, tokens, n_prefix_tokens)
            except Exception:  # noqa: BLE001
                pass

    def contains_hash(self, content_hash: int) -> bool:
        """Read-only membership probe: no reference taken, no LRU motion."""
        return content_hash in self._hash_to_block

    def lookup(self, content_hash: int) -> Optional[int]:
        """Take a reference on a cached block if present."""
        b = self._hash_to_block.get(content_hash)
        if b is None:
            return None
        if b in self._zero_ref_lru:
            self._zero_ref_lru.remove(b)
        self._refcount[b] = self._refcount.get(b, 0) + 1
        return b

    def probe_prefix(self, tokens: list[int], salt: int = 0) -> int:
        """Tokens of ``tokens`` a prefix-cache hit would cover: a read-only
        ``match_prefix`` that takes no reference and moves no block (the
        disaggregated decode pick scores engines by it)."""
        h = salt
        n_full = len(tokens) // self.block_size
        matched = 0
        for i in range(n_full):
            blk = tuple(tokens[i * self.block_size : (i + 1) * self.block_size])
            h = self.chain_hash(h, blk)
            if self._hash_to_block.get(h) is None:
                break
            matched += 1
        return matched * self.block_size

    def probe_admission_need(self, tokens: list[int], salt: int = 0) -> int:
        """Blocks a full prefill of ``tokens`` must take FROM THE FREE
        POOL, accounting for the prefix cache: a matched block that is
        LIVE-shared (refcount > 0) is adopted by refcount alone and costs
        nothing, while a matched zero-ref cached block still consumes a
        ``num_free`` slot when resurrected. Read-only."""
        need = self.blocks_needed(len(tokens))
        h = salt
        n_full = len(tokens) // self.block_size
        for i in range(n_full):
            blk = tuple(tokens[i * self.block_size : (i + 1) * self.block_size])
            h = self.chain_hash(h, blk)
            b = self._hash_to_block.get(h)
            if b is None:
                break
            if self._refcount.get(b, 0) > 0:
                need -= 1  # live shared: adoption is a refcount bump
        return need

    def match_prefix(self, tokens: list[int],
                     salt: int = 0) -> tuple[list[int], int, int]:
        """Longest cached chain of FULL blocks prefixing ``tokens``.
        Returns (block_ids_with_refs_taken, num_tokens_matched, chain_hash).
        ``salt`` roots the chain (the LoRA adapter slot): sequences under
        different adapters hold different K/V for the same tokens, so their
        prefixes never cross-match."""
        matched: list[int] = []
        h = chain = salt
        n_full = len(tokens) // self.block_size
        for i in range(n_full):
            blk = tuple(tokens[i * self.block_size : (i + 1) * self.block_size])
            h = self.chain_hash(h, blk)
            b = self.lookup(h)
            if b is None:
                break
            matched.append(b)
            chain = h
        return matched, len(matched) * self.block_size, chain


@dataclasses.dataclass
class SequenceBlocks:
    """Per-request block bookkeeping (maps a token stream onto blocks)."""

    allocator: BlockAllocator
    blocks: list[int] = dataclasses.field(default_factory=list)
    num_tokens: int = 0
    # hash of the chain of sealed (hashed) full blocks (prefix-cache key)
    chain: int = 0
    num_sealed_tokens: int = 0  # tokens covered by sealed full blocks
    num_cached_tokens: int = 0  # prefix tokens reused from the cache

    def slot(self, pos: int) -> int:
        bs = self.allocator.block_size
        return self.blocks[pos // bs] * bs + pos % bs

    def slots_for_range(self, start: int, end: int) -> list[int]:
        return [self.slot(p) for p in range(start, end)]

    def ensure_capacity(self, num_tokens: int) -> None:
        need = self.allocator.blocks_needed(num_tokens) - len(self.blocks)
        if need > 0:
            self.blocks.extend(self.allocator.allocate(need))

    def seal_full_blocks(self, tokens: list[int]) -> None:
        """Register hashes for newly-completed full blocks. ``tokens`` is
        the COMPLETE token stream of the sequence so far."""
        bs = self.allocator.block_size
        n_full = len(tokens) // bs
        h = self.chain
        for i in range(self.num_sealed_tokens // bs, n_full):
            blk = tuple(tokens[i * bs : (i + 1) * bs])
            parent = h
            h = self.allocator.chain_hash(h, blk)
            self.allocator.register_full_block(self.blocks[i], h, parent_hash=parent,
                                               tokens=blk, n_prefix_tokens=(i + 1) * bs)
        self.chain = h
        self.num_sealed_tokens = n_full * bs

    def truncate_to(self, num_tokens: int) -> int:
        """Roll the sequence back to ``num_tokens``: whole blocks beyond
        the new length are freed (a freed block with a content hash stays
        resurrectable in the allocator's zero-ref pool). Rolling back INTO
        the sealed prefix is an error: those blocks may be shared via the
        prefix cache. Returns the number of blocks freed."""
        if num_tokens < self.num_sealed_tokens:
            raise ValueError(
                f"cannot truncate to {num_tokens} tokens: {self.num_sealed_tokens} "
                "tokens are sealed into the prefix cache (rollback must stay "
                "past the accepted/sealed prefix)"
            )
        keep = self.allocator.blocks_needed(num_tokens) if num_tokens > 0 else 0
        dropped = self.blocks[keep:]
        if dropped:
            self.allocator.free(dropped)
            del self.blocks[keep:]
        self.num_tokens = num_tokens
        return len(dropped)

    def adopt_prefix(self, blocks: list[int], chain: int, num_tokens: int) -> None:
        """Start from a prefix-cache hit (refs already taken by match_prefix)."""
        self.blocks = list(blocks)
        self.chain = chain
        self.num_sealed_tokens = num_tokens
        self.num_cached_tokens = num_tokens

    def release(self) -> None:
        self.allocator.free(self.blocks)
        self.blocks = []
        self.num_tokens = 0
        self.chain = 0
        self.num_sealed_tokens = 0
        self.num_cached_tokens = 0
