"""Full-sequence attention: the plain composite and the dispatch seam
(counterpart of ``ray_tpu/ops/attention.py``).

``attention_torch`` is the port of ``xla_attention``: grouped-query
attention with fp32 scores and softmax, probabilities cast to the value
dtype for the second product. ``attention(impl=)`` takes the config's
``attention_impl``: ``"xla"`` runs that composite (the reference's own
non-Pallas path), ``"flash"`` runs ``ops/flash.py`` (the hand-written
kernels on CUDA tensors).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _group(q: torch.Tensor, k: torch.Tensor) -> int:
    n_heads, n_kv = q.shape[2], k.shape[2]
    if n_heads % n_kv != 0:
        raise ValueError(f"n_heads {n_heads} not divisible by kv heads {n_kv}")
    return n_heads // n_kv


def attention_torch(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KVH, D]
    v: torch.Tensor,  # [B, Sk, KVH, D]
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,  # [B, S], the same for q and k (Sq == Sk)
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference GQA attention: fp32 softmax; a fully-masked row is a
    uniform softmax over Sk, as the reference's finite NEG_INF gives."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    group = _group(q, k)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)

    qg = q.reshape(B, Sq, K, group, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    mask = None
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = q_pos >= torch.arange(Sk, device=q.device)[None, :]  # [Sq, Sk]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    impl: str = "xla",
) -> torch.Tensor:
    if impl == "xla":
        return attention_torch(q, k, v, causal=causal, segment_ids=segment_ids,
                               q_offset=q_offset, softmax_scale=softmax_scale)
    if impl == "flash":
        from ray_tpu_torch.ops.flash import flash_attention

        return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                               q_offset=q_offset, softmax_scale=softmax_scale)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention(impl={impl!r}) needs a device mesh; context-parallel "
            "attention comes with the parallel-training slice"
        )
    raise ValueError(f"unknown attention impl {impl!r}")
