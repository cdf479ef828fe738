"""Mixed prefill+decode batching: ONE ragged dispatch per engine step (a
copy of ``ray_tpu/llm/mixed.py``, kept here so the port imports nothing
from the JAX package).

Queries are PACKED variable-length rows (``ops/ragged.py`` +
``models/llama_decode.ragged_forward``), so one program serves a batch
mixing in-flight prefill chunks (q_len up to the per-step budget) and
decode rows (q_len = 1). This module turns the engine's running set into
that program's arrays.

Discipline (LLMEngine._mixed_step):

 * admission reuses the split path's ladder (_admit_one: prefix match,
   capacity, accounting) but dispatches nothing — the request joins
   ``running`` with a prefill cursor in ``engine._mixed_prefills`` and its
   prompt streams through later mixed dispatches, ``mixed_prefill_chunk``
   tokens per step;
 * every step that has prefill work packs ALL decode rows into the same
   dispatch, so decode never starves behind a long prompt;
 * a step with no prefill work is the all-q_len=1 case and routes to the
   regular decode path;
 * every packed token carries its request's LoRA adapter slot
   (``lora_ids``; pad tokens take slot 0, the zero adapter);
 * the plan's arrays fill a packed-token bucket's static buffers in full
   (``fill``), which the engine's mixed-step graph of that bucket reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MixedBatchPlan", "MixedStats", "token_bucket"]


def token_bucket(n: int) -> int:
    """Packed-token-axis pad: the next power of two, floored at 16."""
    return 1 << max(4, (max(1, n) - 1).bit_length())


@dataclasses.dataclass
class MixedStats:
    """Padding-waste accounting for the mixed dispatch path: packed =
    real fed tokens, padded = the T_pad bucket total they shipped in."""

    dispatches: int = 0
    packed_tokens: int = 0
    padded_tokens: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    completed_prefills: int = 0

    @property
    def padding_waste(self) -> float:
        if not self.padded_tokens:
            return 0.0
        return 1.0 - self.packed_tokens / self.padded_tokens

    def to_dict(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "packed_tokens": self.packed_tokens,
            "padded_tokens": self.padded_tokens,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "completed_prefills": self.completed_prefills,
            "padding_waste_ratio": round(self.padding_waste, 4),
        }


@dataclasses.dataclass
class MixedBatchPlan:
    """One mixed dispatch's packed arrays + row bookkeeping.

    Row order: prefill rows (running order), then decode rows, then
    q_len-0 pad sequences up to the decode bucket. ``emit_rows`` are the
    rows whose last-position logits get sampled this step (decode rows +
    prefills whose final chunk lands); ``completes`` marks the finishing
    prefills among them."""

    reqs: list
    kinds: list            # "prefill" | "decode" per row
    starts: list           # prefill: chunk start; decode: fed position
    chunk_lens: list
    emit_rows: list
    completes: list
    tokens: np.ndarray       # [T_pad]
    positions: np.ndarray    # [T_pad]
    slots: np.ndarray        # [T_pad] (pad -> trash slot)
    lora_ids: np.ndarray     # [T_pad] adapter slot per token (pad -> 0)
    cu_q_lens: np.ndarray    # [B_pad + 1]
    context_lens: np.ndarray # [B_pad]
    bt: np.ndarray           # [B_pad, W]
    T: int
    B: int

    @classmethod
    def build(cls, engine) -> "MixedBatchPlan":
        c = engine.config
        budget = max(1, c.mixed_prefill_chunk)
        rows = []  # (req, kind, start, chunk_len)
        for r in engine.running:
            start = engine._mixed_prefills.get(r.request_id)
            if start is not None:
                prompt_len = len(r.prompt_token_ids) + len(r.output_token_ids)
                rows.append((r, "prefill", start,
                             min(budget, prompt_len - start)))
        for r in engine.running:
            if r.request_id not in engine._mixed_prefills:
                rows.append((r, "decode", r.num_tokens - 1, 1))

        B = len(rows)
        B_pad = engine._pad_to_bucket(B, c.decode_buckets())
        T = sum(cl for *_x, cl in rows)
        T_pad = token_bucket(T)
        num_slots = c.num_blocks * c.block_size

        tokens = np.zeros(T_pad, np.int32)
        positions = np.zeros(T_pad, np.int32)
        slots = np.full(T_pad, num_slots, np.int32)  # trash by default
        lora_ids = np.zeros(T_pad, np.int32)
        cu = np.zeros(B_pad + 1, np.int32)
        ctx = np.zeros(B_pad, np.int32)
        bt = np.zeros(
            (B_pad,
             engine._bt_width([len(r.seq.blocks) for r, *_x in rows] or [1])),
            np.int32,
        )
        emit_rows, completes = [], []
        reqs, kinds, starts, chunk_lens = [], [], [], []
        t = 0
        for i, (r, kind, start, clen) in enumerate(rows):
            if kind == "prefill":
                prompt = r.prompt_token_ids + r.output_token_ids
                fed = prompt[start : start + clen]
                ctx[i] = start + clen
                if start + clen == len(prompt):
                    # final chunk: this row's last-position logits are the
                    # request's first-token distribution
                    emit_rows.append(i)
                    completes.append(i)
            else:
                fed = [
                    r.output_token_ids[-1] if r.output_token_ids
                    else r.prompt_token_ids[-1]
                ]
                ctx[i] = r.num_tokens
                emit_rows.append(i)
            tokens[t : t + clen] = fed
            positions[t : t + clen] = np.arange(start, start + clen)
            for j in range(clen):
                slots[t + j] = r.seq.slot(start + j)
            lora_ids[t : t + clen] = r.lora_slot
            bt[i, : len(r.seq.blocks)] = r.seq.blocks
            t += clen
            cu[i + 1] = t
            reqs.append(r)
            kinds.append(kind)
            starts.append(start)
            chunk_lens.append(clen)
        cu[B + 1 :] = t  # pad sequences: q_len 0, ctx 0

        return cls(
            reqs=reqs, kinds=kinds, starts=starts, chunk_lens=chunk_lens,
            emit_rows=emit_rows, completes=completes,
            tokens=tokens, positions=positions, slots=slots, lora_ids=lora_ids,
            cu_q_lens=cu, context_lens=ctx, bt=bt, T=T, B=B,
        )

    @property
    def bucket(self) -> tuple:
        """(T_pad, B_pad, block-table width): the shapes of this step's
        arrays, which pick its captured graph on the card."""
        return len(self.tokens), len(self.context_lens), self.bt.shape[1]

    def fill(self, bufs) -> None:
        """Write this step into its bucket's static buffers
        (``llm/graphs.PackedBuffers``): every field of every row, the
        padded tail included (pad tokens 0 on the trash slot and adapter
        slot 0, ``cu_q_lens`` past the batch = T, pad contexts 0, table
        rows past the batch 0), so no step reads an earlier one's rows."""
        bufs.fill(tokens=self.tokens, positions=self.positions, slots=self.slots,
                  lora_ids=self.lora_ids, cu_q_lens=self.cu_q_lens,
                  context_lens=self.context_lens, block_tables=self.bt)

    def note(self, stats: MixedStats) -> None:
        stats.dispatches += 1
        stats.packed_tokens += self.T
        stats.padded_tokens += len(self.tokens)
        stats.prefill_tokens += sum(
            cl for k, cl in zip(self.kinds, self.chunk_lens) if k == "prefill"
        )
        stats.decode_tokens += sum(
            cl for k, cl in zip(self.kinds, self.chunk_lens) if k == "decode"
        )
        stats.completed_prefills += len(self.completes)
