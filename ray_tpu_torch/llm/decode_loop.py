"""Multi-step decode: N tokens per host round trip (counterpart of
``ray_tpu/llm/decode_loop.py``).

The reference keeps the decode-sample-feed loop on the device with a
``lax.scan``; here it is a Python loop over ``n_steps`` whose tensors all
stay on the device: slots come from the block tables on the device, the
sampled token feeds the next step directly, and the caller syncs once on
the returned [n_steps, B] tokens.

Overshoot semantics: stop conditions (EOS, stop ids, max_tokens) are
evaluated on the host after the chunk; tokens past a stop are discarded,
and steps at or past a row's ``remaining`` budget write the trash page
(their KV blocks were never reserved).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.llm.sampling import row_seeds, sample_tokens
from ray_tpu_torch.models.llama_decode import decode_step


def decode_chunk(
    params,
    tokens: torch.Tensor,        # [B] current tokens
    positions: torch.Tensor,     # [B] absolute positions of `tokens`
    block_tables: torch.Tensor,  # [B, MB] int32
    context_lens: torch.Tensor,  # [B] int32 INCLUDING the current token
    cache,
    temperatures: torch.Tensor,  # [B]
    top_ks: torch.Tensor,        # [B]
    top_ps: torch.Tensor,        # [B]
    seed_bases: torch.Tensor,    # [B] int64 per-request seed bases (sampling.as_int64)
    starts: torch.Tensor,        # [B] absolute output index of step 0's token
    remaining: torch.Tensor,     # [B] tokens each request can still KEEP
    config,
    *,
    n_steps: int,
    block_size: int,
    trash_slot: int,
    attn_impl: str = "auto",
    sample_mode: str = "full",
    lora: "dict | None" = None,  # adapter ids [B] per row + stacks (llama_decode)
):
    """Returns (tokens [n_steps, B], logprobs [n_steps, B], cache), on the
    device. The seed of step s for row i is row_seed(seed_bases[i],
    starts[i] + s), computed on the device: a pure function of the request
    and the token's absolute index, so seeded requests reproduce whatever
    the chunking."""
    B = tokens.shape[0]
    MB = block_tables.shape[1]
    rows = torch.arange(B, device=tokens.device)
    bt = block_tables.long()
    # pad-row mask decided ONCE from the chunk's entry state: ctx grows
    # every step, so a later `ctx > 0` check would turn a pad row valid
    # and its writes (block table row all zeros) would clobber block 0,
    # a real sequence's block
    valid = context_lens > 0
    tok, pos, ctx = tokens, positions.long(), context_lens
    toks, logprobs = [], []
    for s in range(n_steps):
        # slot for the fed token straight from the block table; pad rows
        # and unreserved overshoot steps write the trash page, not block 0.
        # An overshoot position may lie past the table's width: its page
        # index is clamped (the slot is discarded for the trash page anyway)
        page = torch.clamp(pos // block_size, max=MB - 1)
        slot = bt[rows, page] * block_size + pos % block_size
        slot = torch.where(valid & (s < remaining), slot, torch.full_like(slot, trash_slot))
        logits, cache = decode_step(
            params, tok, pos, slot, block_tables, ctx, cache, config,
            block_size=block_size, attn_impl=attn_impl, lora=lora,
        )
        seeds = None if sample_mode == "greedy" else row_seeds(seed_bases, starts + s)
        tok, logprob = sample_tokens(
            logits, temperatures, top_ks, top_ps, seeds, mode=sample_mode
        )
        toks.append(tok)
        logprobs.append(logprob)
        pos = pos + 1
        ctx = ctx + 1
    return torch.stack(toks), torch.stack(logprobs), cache
