"""Ragged paged attention over a flat-slot KV cache (counterpart of
``ray_tpu/ops/ragged.py``): the one attention a MIXED prefill+decode
batch runs.

Queries arrive PACKED — variable-length rows concatenated along one token
axis, sequence b owning rows [cu_q_lens[b], cu_q_lens[b + 1]). Query
row j of sequence b sits at absolute position
context_lens[b] - q_len_b + j and attends kv positions <= that position
(and < context_lens[b]) over its own pages. A decode-only batch (all
q_len = 1) is exactly ``paged_attention``.

 * ``ragged_attention_torch`` — the plain PyTorch version, one gather +
   masked softmax per sequence (the reference's ``ragged_attention_xla``
   gathers [T, S, D] for the whole batch at once; per sequence keeps the
   gather at [S, D] on the card). Packed rows past cu_q_lens[B] are 0,
   as the Pallas kernel leaves them.
 * ``ragged_attention_cuda`` — launches ``csrc/ragged_attention.cu``
   (replacing the Pallas ``_ragged_attn_kernel``). Two kinds of sequence:
   q_len = 1 decode rows take the paged kernel's split-KV core (same split
   count, same bits as ``paged_attention_cuda``); q_len >= 2 chunks take
   the wgmma kernel in bf16 and the CUDA-core kernel in fp32. Each kernel
   reads q_len on the device and skips the other kind.
 * ``ragged_attention`` — dispatch as in ``ops/paged_attention.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops.paged_attention import (
    _DTYPE_CODES,
    check_kernel_args,
    count_launch,
    decode_workspace,
    pick_impl,
    raise_on_error,
)


def ragged_attention_torch(
    q: torch.Tensor,             # [T, n_heads, head_dim] packed query rows
    k_cache: torch.Tensor,       # [n_kv_heads, num_slots, head_dim]
    v_cache: torch.Tensor,       # [n_kv_heads, num_slots, head_dim]
    block_tables: torch.Tensor,  # [B, max_blocks] int32 block ids (padded w/ 0)
    cu_q_lens: torch.Tensor,     # [B+1] int32 exclusive prefix sums of q lens
    context_lens: torch.Tensor,  # [B] int32 valid kv tokens per sequence
    *,
    block_size: int,
) -> torch.Tensor:               # [T, n_heads, head_dim]
    T, H, D = q.shape
    KVH = k_cache.shape[0]
    G = H // KVH
    B = context_lens.shape[0]
    MB = block_tables.shape[1]
    S = MB * block_size  # padded kv length

    offs = torch.arange(S, device=q.device)
    page, within = offs // block_size, offs % block_size
    cu = cu_q_lens.tolist()
    ctx = context_lens.tolist()
    bt = block_tables.long()
    out = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        s0, s1 = cu[b], min(cu[b + 1], T)
        q_len = s1 - s0
        if q_len <= 0:
            continue
        slots = bt[b, page] * block_size + within  # [S]
        k = k_cache[:, slots].float()  # [KVH, S, D]
        v = v_cache[:, slots].float()
        qg = q[s0:s1].reshape(q_len, KVH, G, D).float()
        scores = torch.einsum("thgd,hsd->thgs", qg, k) * (1.0 / math.sqrt(D))
        q_pos = ctx[b] - (cu[b + 1] - cu[b]) + torch.arange(q_len, device=q.device)
        valid = (offs[None, :] <= q_pos[:, None]) & (offs[None, :] < ctx[b])  # [q_len, S]
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
        out[s0:s1] = torch.einsum("thgs,hsd->thgd", probs, v).reshape(q_len, H, D)
    return out.to(q.dtype)


def _ragged_lib():
    from ray_tpu_torch.ops import _build

    lib = _build.load("ragged_attention")
    fn = lib.ragged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def ragged_attention_cuda(q, k_cache, v_cache, block_tables, cu_q_lens, context_lens,
                          *, block_size: int, max_q_len: int) -> torch.Tensor:
    """Launch ``csrc/ragged_attention.cu`` on the current stream.
    ``max_q_len`` sizes the chunk grid; a longer sequence is still served
    in full (each CTA strides over its sequence's row tiles)."""
    T, H, D = q.shape
    B = context_lens.shape[0]
    if (context_lens.ndim != 1 or block_tables.ndim != 2 or block_tables.shape[0] != B
            or cu_q_lens.shape != (B + 1,)):
        raise ValueError(
            "ragged_attention: block_tables [B, MB], cu_q_lens [B+1] and "
            "context_lens [B] disagree on B"
        )
    if max_q_len < 1:
        raise ValueError(f"max_q_len must be >= 1, got {max_q_len}")
    check_kernel_args(
        "ragged_attention", q, k_cache, v_cache,
        {"block_tables": block_tables, "cu_q_lens": cu_q_lens,
         "context_lens": context_lens}, block_size,
    )
    KVH, MB = k_cache.shape[0], block_tables.shape[1]
    splits, ws = decode_workspace(q, H, KVH, D, B, MB * block_size)
    out = torch.zeros_like(q)  # rows past cu_q_lens[B] stay 0
    lib = _ragged_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ragged_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), cu_q_lens.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), B, H, KVH, D, k_cache.shape[1], MB, block_size, max_q_len, splits,
        None if ws is None else ws.data_ptr(), _DTYPE_CODES[q.dtype], stream,
    )
    raise_on_error(lib, "ragged_attention", rc)
    count_launch(ragged_attention_cuda, "ragged_attention")
    return out


ragged_attention_cuda.launches = 0  # kernel launches, for showing a path ran it


def ragged_attention(q, k_cache, v_cache, block_tables, cu_q_lens, context_lens, *,
                     block_size: int, max_q_len: int, impl: str = "auto") -> torch.Tensor:
    """impl: auto | torch | cuda (see ``ops.paged_attention.pick_impl``).
    ``max_q_len`` is the planner's bound on any sequence's q_len."""
    if max_q_len < 1:
        raise ValueError(f"max_q_len must be >= 1, got {max_q_len}")
    if pick_impl("ragged_attention", q.device, impl) == "torch":
        return ragged_attention_torch(
            q, k_cache, v_cache, block_tables, cu_q_lens, context_lens,
            block_size=block_size,
        )
    return ragged_attention_cuda(
        q, k_cache, v_cache, block_tables, cu_q_lens, context_lens,
        block_size=block_size, max_q_len=max_q_len,
    )
