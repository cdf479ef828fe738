"""Pipelined decode: device-resident batch state, in-graph stop masks,
double-buffered chunks and an adaptive chunk length (counterpart of
``ray_tpu/llm/pipeline.py``).

 * ``DeviceBatchState`` — the decode batch's tokens / positions / context
   lengths / block tables / sampling knobs / seed bases / stop sets /
   LoRA adapter slots live
   on the device in the static buffers of ``llm/graphs.py`` across
   chunks, rewritten only at membership changes; between chunks the
   carry stays where the chunk wrote it;
 * ``decode_chunk_masked`` — up to ``n_steps`` decode+sample steps with
   the stop ladder on the device: finished rows freeze (trash-slot KV
   writes, no position advance, zero outputs), so chunk N+1 can be
   dispatched before the host has seen chunk N's tokens;
 * ``ChunkController`` — the chunk length, from the measured host gap
   and chunk wall, quantized to CHUNK_BUCKETS;
 * ``PipelineStats`` — the ``pipeline`` row of ``LLMEngine.stats()``.

The reference's while-loop leaves a chunk once every row is done. A
captured CUDA graph has a fixed length, so on the card every step of
the chunk runs (finished rows frozen) and ``steps_run`` is counted on
the device as the number of steps in which any row was active: the
controller reads the same signal, and ``steps_dispatched -
steps_executed`` counts the steps computed after every row was done.
To keep those few, the engine caps a chunk at the largest max_tokens
budget left after the chunk in flight, and dispatches none when every
row's budget ends inside it. Run eagerly on the CPU, the chunk does
leave early.

Not ported: the Prometheus histograms of host prep and sync wait (they
wait for the port's metrics registry).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch.llm.sampling import as_int64, row_seeds, sample_tokens
from ray_tpu_torch.models.llama_decode import decode_step

# the chunk lengths the engine runs: decode_chunk is clamped into this set
CHUNK_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# stop-id sets ride the device as a padded [B, stop_w] matrix; a request
# with more stop ids than the cap takes the sync decode path
STOP_WIDTHS = (1, 2, 4, 8)
STOP_WIDTH_CAP = STOP_WIDTHS[-1]


def chunk_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest CHUNK_BUCKETS entry >= n; with ``cap``, never larger than
    the smallest bucket covering the cap (steps past every row's budget
    are pure waste)."""
    pick = next((b for b in CHUNK_BUCKETS if b >= n), CHUNK_BUCKETS[-1])
    if cap is not None:
        capb = next(
            (b for b in CHUNK_BUCKETS if b >= max(1, cap)), CHUNK_BUCKETS[-1]
        )
        pick = min(pick, capb)
    return pick


def stop_width(n: int) -> int:
    """Smallest STOP_WIDTHS entry >= max(1, n); the caller checked
    n <= STOP_WIDTH_CAP."""
    for w in STOP_WIDTHS:
        if w >= max(1, n):
            return w
    raise ValueError(f"stop set width {n} exceeds STOP_WIDTH_CAP={STOP_WIDTH_CAP}")


@dataclasses.dataclass
class PipelineStats:
    """Pipelined-decode counters: chunk-size distribution, host/device
    time split, overlap ratio, and the steps run after every row was done."""

    dispatches: int = 0
    syncs: int = 0
    rebuilds: int = 0
    flushes: int = 0
    sync_fallbacks: int = 0           # wide-stop-set batches
    steps_dispatched: int = 0         # sum of n_steps over chunks
    steps_executed: int = 0           # sum of steps with a live row
    host_prep_ms: float = 0.0         # overlapped host work
    sync_wait_ms: float = 0.0         # un-hidden sync block
    chunk_ms: float = 0.0             # dispatch -> sync wall
    chunks_by_steps: dict = dataclasses.field(default_factory=dict)

    def record_dispatch(self, n_steps: int, host_prep_ms: float) -> None:
        self.dispatches += 1
        self.steps_dispatched += n_steps
        self.host_prep_ms += host_prep_ms
        self.chunks_by_steps[n_steps] = self.chunks_by_steps.get(n_steps, 0) + 1

    def record_sync(self, *, steps_run: int, sync_wait_ms: float,
                    chunk_ms: float) -> None:
        self.syncs += 1
        self.steps_executed += steps_run
        self.sync_wait_ms += sync_wait_ms
        self.chunk_ms += chunk_ms

    @property
    def overlap_ratio(self) -> float:
        """Fraction of per-round host time hidden under device compute:
        prep / (prep + un-hidden sync wait)."""
        total = self.host_prep_ms + self.sync_wait_ms
        return self.host_prep_ms / total if total > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "syncs": self.syncs,
            "rebuilds": self.rebuilds,
            "flushes": self.flushes,
            "sync_fallbacks": self.sync_fallbacks,
            "chunks_by_steps": dict(sorted(self.chunks_by_steps.items())),
            "steps_dispatched": self.steps_dispatched,
            "steps_executed": self.steps_executed,
            "steps_saved_by_early_exit": max(
                0, self.steps_dispatched - self.steps_executed
            ),
            "host_prep_ms": round(self.host_prep_ms, 3),
            "sync_wait_ms": round(self.sync_wait_ms, 3),
            "chunk_ms": round(self.chunk_ms, 3),
            "overlap_ratio": round(self.overlap_ratio, 4),
        }


@dataclasses.dataclass
class ChunkController:
    """Measured-gap-adaptive chunk length (a ratchet, not a formula): step
    up one bucket while the chunk wall is under ``target_ratio`` times the
    per-round host overhead; step down only on systematic early exit
    (under ``shrink_frac`` of the steps live on ``shrink_patience``
    consecutive chunks). A pure function of the fed measurements, so a
    fixed trace replays to the same bucket sequence."""

    initial: int = 8
    target_ratio: float = 2.0
    alpha: float = 0.3                 # EMA smoothing
    shrink_frac: float = 0.5           # early-exit threshold
    shrink_patience: int = 2           # consecutive short chunks to shrink
    chunk_ms_ema: Optional[float] = None
    overhead_ms_ema: Optional[float] = None
    _level: Optional[int] = None       # index into CHUNK_BUCKETS
    _short_rounds: int = 0

    def _lvl(self) -> int:
        if self._level is None:
            self._level = CHUNK_BUCKETS.index(chunk_bucket(max(1, self.initial)))
        return self._level

    def note_overhead(self, ms: float) -> None:
        ms = max(0.0, float(ms))
        self.overhead_ms_ema = (
            ms if self.overhead_ms_ema is None
            else (1 - self.alpha) * self.overhead_ms_ema + self.alpha * ms
        )

    def note_chunk(self, chunk_ms: float, n_steps: int,
                   steps_run: Optional[int] = None) -> None:
        if n_steps <= 0 or chunk_ms <= 0:
            return
        self.chunk_ms_ema = (
            chunk_ms if self.chunk_ms_ema is None
            else (1 - self.alpha) * self.chunk_ms_ema + self.alpha * chunk_ms
        )
        lvl = self._lvl()
        if (
            self.overhead_ms_ema is not None
            and self.chunk_ms_ema < self.target_ratio * self.overhead_ms_ema
        ):
            # device work too short to hide the host round: step up
            self._level = min(lvl + 1, len(CHUNK_BUCKETS) - 1)
            self._short_rounds = 0
            return
        if steps_run is not None and steps_run < self.shrink_frac * n_steps:
            self._short_rounds += 1
            if self._short_rounds >= self.shrink_patience:
                self._level = max(lvl - 1, 0)
                self._short_rounds = 0
        else:
            self._short_rounds = 0

    def next_steps(self, cap: Optional[int] = None) -> int:
        """Chunk length for the next dispatch, in CHUNK_BUCKETS; ``cap``
        bounds it (the batch's largest remaining token budget)."""
        return chunk_bucket(CHUNK_BUCKETS[self._lvl()], cap)


def assemble_batch_arrays(batch: list, B_pad: int, bt_width: int):
    """Per-row decode-batch assembly, shared by the sync path and
    ``DeviceBatchState.build`` (the two paths' token identity depends on
    it): fed token, position, context length, sampling knobs, absolute
    output index, max_tokens, LoRA adapter slot, block table.

    Returns (arrays dict of np arrays, [B_pad] int64 seed bases). Pad
    rows: context_lens 0 (the kernels' pad signal), temperature 1, top_p
    1, max_tokens INT32_MAX, adapter slot 0, seed base 0."""
    a = {
        "tokens": np.zeros(B_pad, np.int32),
        "positions": np.zeros(B_pad, np.int32),
        "context_lens": np.zeros(B_pad, np.int32),
        "temps": np.ones(B_pad, np.float32),
        "top_ks": np.zeros(B_pad, np.int32),
        "top_ps": np.ones(B_pad, np.float32),
        "starts": np.zeros(B_pad, np.int32),
        "max_toks": np.full(B_pad, np.iinfo(np.int32).max, np.int32),
        "lora_ids": np.zeros(B_pad, np.int32),
        "bt": np.zeros((B_pad, bt_width), np.int32),
    }
    seed_bases = np.zeros(B_pad, np.int64)
    for i, r in enumerate(batch):
        sp = r.sampling_params
        a["tokens"][i] = (
            r.output_token_ids[-1] if r.output_token_ids
            else r.prompt_token_ids[-1]
        )
        a["positions"][i] = r.num_tokens - 1  # position of the fed token
        a["context_lens"][i] = r.num_tokens
        a["temps"][i] = sp.temperature
        a["top_ks"][i] = sp.top_k
        a["top_ps"][i] = sp.top_p
        a["starts"][i] = len(r.output_token_ids)
        a["max_toks"][i] = sp.max_tokens
        a["lora_ids"][i] = r.lora_slot
        a["bt"][i, : len(r.seq.blocks)] = r.seq.blocks
        seed_bases[i] = as_int64(r.seed_base)
    return a, seed_bases


@dataclasses.dataclass
class DeviceBatchState:
    """The decode batch, resident on the device across chunks, in the
    static buffers (``graphs.ChunkBuffers``) that the captured chunks of
    its (B_pad, stop width, table width) bucket read and write.

    Written once per membership change; between chunks the chunk itself
    writes the carry back in place, and the block table is re-uploaded
    only when a row grew. Rows that finish stay as ``done`` columns
    until the next rebuild, which is what lets chunk N+1 be dispatched
    before chunk N's finishes are known on the host."""

    rids: list
    row_of: dict
    B: int
    B_pad: int
    bt_width: int
    stop_w: int
    sample_mode: str
    bufs: Any
    _bt_np: Any = None
    _nblocks: list = dataclasses.field(default_factory=list)

    @classmethod
    def build(cls, engine, batch: list) -> "DeviceBatchState":
        from ray_tpu_torch.llm.graphs import upload

        c = engine.config
        B = len(batch)
        B_pad = engine._pad_to_bucket(B, c.decode_buckets())
        btw = engine._bt_width([len(r.seq.blocks) for r in batch])
        sw = stop_width(max(
            (len(r.sampling_params.stop_token_ids) for r in batch), default=0
        ))
        a, seed_bases = assemble_batch_arrays(batch, B_pad, btw)
        # pipeline-only rows the sync path evaluates on the host instead:
        # the padded stop-id sets and the per-row EOS policy
        stop_ids = np.full((B_pad, sw), -1, np.int32)
        stop_on_eos = np.zeros(B_pad, bool)
        nblocks = [0] * B_pad
        for i, r in enumerate(batch):
            sp = r.sampling_params
            for j, t in enumerate(sp.stop_token_ids[:sw]):
                stop_ids[i, j] = t
            stop_on_eos[i] = not sp.ignore_eos
            nblocks[i] = len(r.seq.blocks)
        bufs = engine._graphs.buffers(B_pad, sw, btw)
        for name, arr in (
            ("tokens", a["tokens"]), ("positions", a["positions"]),
            ("context_lens", a["context_lens"]), ("done", np.zeros(B_pad, bool)),
            ("starts", a["starts"]), ("temps", a["temps"]),
            ("top_ks", a["top_ks"]), ("top_ps", a["top_ps"]),
            ("seed_bases", seed_bases), ("max_toks", a["max_toks"]),
            ("stop_ids", stop_ids), ("stop_on_eos", stop_on_eos),
            ("lora_ids", a["lora_ids"]), ("block_tables", a["bt"]),
        ):
            upload(getattr(bufs, name), arr)
        rids = [r.request_id for r in batch]
        return cls(
            rids=rids, row_of={rid: i for i, rid in enumerate(rids)},
            B=B, B_pad=B_pad, bt_width=btw, stop_w=sw,
            sample_mode=engine._sample_mode(batch), bufs=bufs,
            _bt_np=a["bt"], _nblocks=nblocks,
        )

    def refresh_block_tables(self, running: list) -> bool:
        """Fold newly allocated blocks into the device table (one upload,
        ordered on the stream after the chunk in flight, only when a row
        changed). Returns False when a row outgrew the padded width (the
        caller rebuilds)."""
        from ray_tpu_torch.llm.graphs import upload

        dirty = False
        for r in running:
            i = self.row_of.get(r.request_id)
            if i is None or r.seq is None:
                continue
            nb = len(r.seq.blocks)
            if nb != self._nblocks[i]:
                if nb > self.bt_width:
                    return False
                self._bt_np[i, :nb] = r.seq.blocks
                self._nblocks[i] = nb
                dirty = True
        if dirty:
            upload(self.bufs.block_tables, self._bt_np)
        return True


def decode_chunk_masked(
    params,
    tokens: torch.Tensor,        # [B] int32 current tokens (carry)
    positions: torch.Tensor,     # [B] int32 absolute positions of `tokens` (carry)
    block_tables: torch.Tensor,  # [B, MB] int32
    context_lens: torch.Tensor,  # [B] int32 INCLUDING the current token (carry)
    cache,
    temperatures: torch.Tensor,  # [B]
    top_ks: torch.Tensor,        # [B]
    top_ps: torch.Tensor,        # [B]
    seed_bases: torch.Tensor,    # [B] int64 per-request seed bases
    starts: torch.Tensor,        # [B] int32 absolute output index of step 0's token (carry)
    max_toks: torch.Tensor,      # [B] int32 max_tokens budget (absolute)
    done: torch.Tensor,          # [B] bool row already finished (carry)
    stop_ids: torch.Tensor,      # [B, S] int32 stop-token sets, -1 padded
    stop_on_eos: torch.Tensor,   # [B] bool: EOS finishes the row (~ignore_eos)
    config,
    *,
    n_steps: int,
    block_size: int,
    trash_slot: int,
    eos_id: int,
    attn_impl: str = "auto",
    sample_mode: str = "full",
    early_exit: bool = False,
    lora: "dict | None" = None,  # adapter ids [B] per row + stacks (llama_decode)
):
    """Decode up to ``n_steps`` tokens with the stop ladder on the device.

    Returns ``(tokens [n_steps, B] int32, logprobs [n_steps, B],
    n_emitted [B] int32, steps_run [] int32, carry, cache)``; carry is the
    next chunk's ``(tokens, positions, context_lens, done, starts)``.

    Per row, as the host ladder in ``LLMEngine._append_chunk``: a token is
    emitted, then the row goes done if it was EOS (unless ignored), in the
    stop set, reached max_tokens, or reached the max_seq wall. Done rows
    freeze: trash-slot KV writes, no position or context advance, 0 /
    0.0 outputs. ``steps_run`` counts the steps in which any row was live.
    Nothing here reads a value back to the host, so the chunk can be
    captured into a CUDA graph (the adapter ids and stacks are read by
    address, like every other input); ``early_exit`` (eager runs only)
    leaves once every row is done, which changes no output."""
    B = tokens.shape[0]
    MB = block_tables.shape[1]
    rows = torch.arange(B, device=tokens.device)
    bt = block_tables.long()
    dn = done | (context_lens <= 0)  # pad rows are born done
    tok, pos, ctx = tokens, positions, context_lens
    ne = torch.zeros_like(starts)
    steps_run = torch.zeros((), dtype=torch.int32, device=tokens.device)
    toks, lps = [], []
    for s in range(n_steps):
        if early_exit and bool(dn.all()):
            break
        active = ~dn
        steps_run = steps_run + active.any()
        # slot of the fed token straight from the block table; done and pad
        # rows write the trash page, never block 0. A frozen row's position
        # may sit past the table's width: its page index is clamped (the
        # slot is replaced by the trash slot anyway)
        page = torch.clamp(pos.long() // block_size, max=MB - 1)
        slot = bt[rows, page] * block_size + pos.long() % block_size
        slot = torch.where(active, slot, torch.full_like(slot, trash_slot))
        logits, cache = decode_step(
            params, tok, pos, slot, block_tables, ctx, cache, config,
            block_size=block_size, attn_impl=attn_impl, lora=lora,
        )
        # seed = f(request seed base, absolute output index): the sync
        # path's stream for every live row, whatever the chunking
        seeds = None if sample_mode == "greedy" else row_seeds(seed_bases, starts + s)
        nxt, lp = sample_tokens(
            logits, temperatures, top_ks, top_ps, seeds, mode=sample_mode, done=dn,
        )
        nxt = nxt.to(torch.int32)
        ne2 = ne + active.to(ne.dtype)
        # stop ladder, the same conditions as _append_chunk
        hit_stop = (stop_ids == nxt[:, None]).any(dim=-1)
        hit_eos = stop_on_eos & (nxt == eos_id)
        hit_len = (starts + ne2) >= max_toks
        hit_seq = (ctx + 1) >= config.max_seq
        dn2 = dn | (active & (hit_eos | hit_stop | hit_len | hit_seq))
        toks.append(torch.where(active, nxt, torch.zeros_like(nxt)))
        lps.append(torch.where(active, lp, torch.zeros_like(lp)))
        # frozen once done: token / position / context stop advancing
        tok = torch.where(active, nxt, tok)
        pos = torch.where(active, pos + 1, pos)
        ctx = torch.where(active, ctx + 1, ctx)
        dn, ne = dn2, ne2
    pad = n_steps - len(toks)
    if pad:
        toks.append(torch.zeros((pad, B), dtype=torch.int32, device=tokens.device))
        lps.append(torch.zeros((pad, B), dtype=torch.float32, device=tokens.device))
    toks_out = torch.cat([t.reshape(-1, B) for t in toks])
    lps_out = torch.cat([t.reshape(-1, B) for t in lps])
    carry = (tok, pos, ctx, dn, starts + ne)
    return toks_out, lps_out, ne, steps_run, carry, cache
