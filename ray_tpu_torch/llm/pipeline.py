"""Decode-batch assembly and chunk-length buckets (the part of
``ray_tpu/llm/pipeline.py`` the sync decode path uses).

The pipelined decode path of the reference (``DeviceBatchState``,
``decode_chunk_masked``, the adaptive chunk controller) is not ported
yet; ``EngineConfig(pipeline_decode=True)`` raises until it is
(ROADMAP.md, Queue 1, B4).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# the chunk lengths the engine runs: decode_chunk is clamped into this set
CHUNK_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


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


def assemble_batch_arrays(batch: list, B_pad: int, bt_width: int):
    """Per-row decode-batch assembly: how a Request becomes batch-array
    rows (fed token, position, context length, sampling knobs, absolute
    output index, block table).

    Returns (arrays dict of np arrays, per-row seed bases). Pad rows:
    context_lens 0 (the kernels' pad signal), temperature 1, top_p 1,
    max_tokens INT32_MAX, seed base None (no noise)."""
    a = {
        "tokens": np.zeros(B_pad, np.int32),
        "positions": np.zeros(B_pad, np.int32),
        "context_lens": np.zeros(B_pad, np.int32),
        "temps": np.ones(B_pad, np.float32),
        "top_ks": np.zeros(B_pad, np.int32),
        "top_ps": np.ones(B_pad, np.float32),
        "starts": np.zeros(B_pad, np.int32),
        "bt": np.zeros((B_pad, bt_width), np.int32),
    }
    seed_bases: list = [None] * B_pad
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
        a["bt"][i, : len(r.seq.blocks)] = r.seq.blocks
        seed_bases[i] = None if sp.greedy else r.seed_base
    return a, seed_bases
