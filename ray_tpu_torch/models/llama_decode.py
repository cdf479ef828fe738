"""Llama inference paths over the paged KV cache (counterpart of
``ray_tpu/models/llama_decode.py``).

 * ``prefill`` — run a batch of prompt suffixes, scatter their K/V into
   cache pages, attend over (cached prefix + suffix) via page gather,
   return last-position logits (the split path; plain torch, as the
   reference's is plain XLA).
 * ``mixed_step`` — one packed ragged program over prefill chunks and
   decode rows (``ops/ragged.py``).
 * ``decode_step`` — one token per running sequence, paged attention over
   its pages (``ops/paged_attention.py``).
 * ``verify_tokens`` / ``verify_tokens_ragged`` — speculative-decoding
   verification: logits at every position of a short drafted suffix,
   through the paged prefill path or the packed ragged one.

Every entry point takes ``lora=`` (LoRA multiplexing): ``{"ids": ...,
"<t>_A": [L, n_slots, d_model, r], "<t>_B": [L, n_slots, r, d_out]}`` for
targets t among wq / wk / wv, slot 0 the zero adapter. ``ids`` holds one
slot per row ([B]) on the paged paths and one per packed token ([T]) on
the ragged ones. Each row's delta is added to q / k / v after the
projections and before RoPE, as in the reference.

Cache layout: k/v [n_layers, n_kv_heads, num_slots + trash, head_dim],
head-major, so one page of one kv head is a contiguous block_size x
head_dim tile — the unit the CUDA kernels read. The extra trailing page
is the trash page that padding writes land in.

``mixed_step`` and ``verify_tokens_ragged`` on the card are what the
engine captures into a CUDA graph per packed-token bucket
(``llm/graphs.PackedGraphs``), so their card path must stay
capture-safe: no host sync (nothing read back, ``max_q_len`` a constant
of the engine), every allocation sized by shapes alone (the split-KV
workspace by the table width), the adapter stacks read by address.

The reference's jitted entry points DONATE the cache buffers so XLA
updates pages in place; here every path writes the new K/V into the
caller's cache tensors in place (``index_copy_``) and returns the same
dict, which is the torch equivalent. As in the reference, each layer
scatters its new K/V into the cache BEFORE its attention reads it.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, Params
from ray_tpu_torch.nn.layers import apply_rope, rms_norm, rope_frequencies, swiglu
from ray_tpu_torch.ops.paged_attention import paged_attention
from ray_tpu_torch.ops.ragged import ragged_attention

Cache = dict[str, torch.Tensor]

_rope_tables: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def init_cache(config: LlamaConfig, num_slots: int, dtype=None,
               trash_slots: int = 16, device="cuda") -> Cache:
    """num_slots = num_blocks * block_size, plus a TRASH PAGE (pad rows
    scatter to slot ``num_slots``) — a whole page, so the slot count stays
    a multiple of every block_size <= trash_slots."""
    c = config
    shape = (c.n_layers, c.n_kv_heads, num_slots + trash_slots, c.head_dim)
    dt = dtype or c.dtype
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _rope(c: LlamaConfig, device: torch.device):
    """cos/sin tables, built once per (shape, device)."""
    key = (c.head_dim, c.max_seq, c.rope_theta, str(device))
    tables = _rope_tables.get(key)
    if tables is None:
        tables = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=device)
        if device.type == "cuda":
            # written on this thread's stream and shared by every engine of
            # the process: ready before another thread's stream can read it
            torch.cuda.current_stream(device).synchronize()
        _rope_tables[key] = tables
    return tables


def _layer(params_layers: Params, i: int) -> Params:
    return {k: v[i] for k, v in params_layers.items()}


def _qkv(x, lp, c: LlamaConfig):
    B, S, _ = x.shape
    hd = c.head_dim
    q = (x @ lp["wq"]).reshape(B, S, c.n_heads, hd)
    k = (x @ lp["wk"]).reshape(B, S, c.n_kv_heads, hd)
    v = (x @ lp["wv"]).reshape(B, S, c.n_kv_heads, hd)
    return q, k, v


LORA_TARGETS = ("wq", "wk", "wv")


def _lora_layers(lora: dict) -> tuple[torch.Tensor, list[dict]]:
    """The adapter stacks in the form each layer's delta takes, built once
    per forward: every target's A of every slot side by side, so that one
    GEMM per layer makes all of a row's down-projections, and a column mask
    that keeps each row's own slot. Returns (mask [N, 1, K] bool, one
    {"A": [d, K], t: B [n_slots * r, d_out]} per layer), K = targets x
    slots x rank.

    The mask keeps the base GEMMs as they are and gathers no [N, d, r]
    copy of A per row (the reference's ``A[ids]``): a base row (slot 0,
    zeros) gets an all-zero down-projection and so exactly q + 0."""
    targets = [t for t in LORA_TARGETS if f"{t}_A" in lora]
    L, n, d, r = lora[f"{targets[0]}_A"].shape
    a = torch.stack([lora[f"{t}_A"] for t in targets], dim=1)  # [L, nt, n, d, r]
    a = a.permute(0, 3, 1, 2, 4).reshape(L, d, len(targets) * n * r)
    ids = lora["ids"].long()
    col_slot = torch.arange(n, device=ids.device).repeat_interleave(r).repeat(len(targets))
    mask = (col_slot[None, :] == ids[:, None])[:, None, :]
    a_l = a.unbind(0)
    b_l = {t: lora[f"{t}_B"].reshape(L, n * r, -1).unbind(0) for t in targets}
    return mask, [{"A": a_l[i], **{t: b[i] for t, b in b_l.items()}} for i in range(L)]


def _apply_lora(q, k, v, x, lora_l: dict, mask: torch.Tensor):
    """Add each row's adapter delta to the attention projections, in place
    (q / k / v are the projections' fresh outputs): x [B, S, d], q / k / v
    [B, S, heads, hd], ``lora_l`` one layer's entry of ``_lora_layers``,
    ``mask`` [B, 1, K] (one slot per row). One GEMM for every target's
    down-projection, then one accumulating GEMM (beta = 1) per target."""
    B, S, _ = x.shape
    u = torch.where(mask, x @ lora_l["A"], 0).reshape(B * S, -1)
    targets = [t for t in LORA_TARGETS if t in lora_l]
    w = u.shape[1] // len(targets)
    out = {"wq": q, "wk": k, "wv": v}
    for j, t in enumerate(targets):
        out[t].view(B * S, -1).addmm_(u[:, j * w : (j + 1) * w], lora_l[t])
    return q, k, v


def _apply_lora_packed(q, k, v, x, lora_l: dict, mask: torch.Tensor):
    """Per-TOKEN adapter deltas for packed ragged rows: x [1, T, d], q / k /
    v [1, T, heads, hd], ``mask`` [T, 1, K]. The packed token axis is viewed
    as the batch axis, so every packed token selects its own adapter."""
    T = x.shape[1]
    q, k, v = _apply_lora(
        *(y.reshape(T, 1, *y.shape[2:]) for y in (q, k, v)), x.reshape(T, 1, -1), lora_l, mask,
    )
    return tuple(y.reshape(1, T, *y.shape[2:]) for y in (q, k, v))


def _out_proj(o, lp, B, S, c: LlamaConfig):
    return o.reshape(B, S, c.n_heads * c.head_dim) @ lp["wo"]


def _write_kv(cache_l: torch.Tensor, slots: torch.Tensor, x: torch.Tensor) -> None:
    """Scatter x [N, KVH, D] into this layer's head-major cache [KVH, slots, D]
    at ``slots`` [N], in place."""
    cache_l.index_copy_(1, slots, x.transpose(0, 1).to(cache_l.dtype))


def _lm_head(params: Params, h: torch.Tensor, c: LlamaConfig) -> torch.Tensor:
    w_out = params.get("lm_head")
    if w_out is None:
        w_out = params["embed"].T
    return (h @ w_out.to(c.dtype)).float()


def _paged_forward(
    params: Params,
    tokens: torch.Tensor,        # [B, S_pad] suffix tokens (right-padded)
    positions: torch.Tensor,     # [B, S_pad] absolute positions (pad = 0)
    slot_mapping: torch.Tensor,  # [B, S_pad] cache slots (pad -> trash slot)
    block_tables: torch.Tensor,  # [B, MB]
    context_lens: torch.Tensor,  # [B] prefix + suffix length
    cache: Cache,
    config: LlamaConfig,
    *,
    block_size: int,
    lora: "dict | None" = None,  # ids [B] per row
) -> tuple[torch.Tensor, Cache]:
    """Multi-token transformer body over the paged cache: scatter the
    suffix K/V into pages, attend over (cached prefix + suffix) per layer,
    return the final hidden states [B, S, D] and the (updated) cache."""
    c = config
    B, S = tokens.shape
    if S > c.max_seq:
        raise ValueError(
            f"prefill chunk length {S} > max_seq={c.max_seq}; RoPE tables "
            "only cover max_seq positions"
        )
    cos, sin = _rope(c, tokens.device)
    positions = positions.long()
    h = params["embed"][tokens.long()]
    flat_slots = slot_mapping.reshape(-1).long()  # [B*S]
    lora_mask, lora_ls = _lora_layers(lora) if lora is not None else (None, None)
    for i in range(c.n_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["ln1"], c.rms_eps)
        q, k, v = _qkv(x, lp, c)
        if lora_ls is not None:
            q, k, v = _apply_lora(q, k, v, x, lora_ls[i], lora_mask)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        _write_kv(cache["k"][i], flat_slots, k.reshape(B * S, c.n_kv_heads, c.head_dim))
        _write_kv(cache["v"][i], flat_slots, v.reshape(B * S, c.n_kv_heads, c.head_dim))
        o = _page_attend_prefill(
            q, cache["k"][i], cache["v"][i], block_tables, context_lens, positions, c,
            block_size=block_size,
        )
        h = h + _out_proj(o, lp, B, S, c)
        x = rms_norm(h, lp["ln2"], c.rms_eps)
        h = h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    h = rms_norm(h, params["final_norm"], c.rms_eps)
    return h, cache


def prefill(
    params: Params,
    tokens: torch.Tensor,        # [B, S_pad] suffix tokens (right-padded)
    positions: torch.Tensor,     # [B, S_pad] absolute positions (pad = 0)
    suffix_lens: torch.Tensor,   # [B] valid suffix tokens per row
    slot_mapping: torch.Tensor,  # [B, S_pad] cache slots (pad -> trash slot)
    block_tables: torch.Tensor,  # [B, MB]
    context_lens: torch.Tensor,  # [B] prefix + suffix length
    cache: Cache,
    config: LlamaConfig,
    *,
    block_size: int,
    lora: "dict | None" = None,  # ids [B] per row
) -> tuple[torch.Tensor, Cache]:
    """Returns (last-valid-token logits [B, V] fp32, updated cache)."""
    h, cache = _paged_forward(
        params, tokens, positions, slot_mapping, block_tables, context_lens,
        cache, config, block_size=block_size, lora=lora,
    )
    S = tokens.shape[1]
    last = (suffix_lens.long() - 1).clamp(0, S - 1)  # [B]
    h_last = h[torch.arange(h.shape[0], device=h.device), last]  # [B, D]
    return _lm_head(params, h_last, config), cache


def verify_tokens(
    params: Params,
    tokens: torch.Tensor,        # [B, K+1] current token + K drafted (right-padded)
    positions: torch.Tensor,     # [B, K+1] absolute positions (pad = 0)
    slot_mapping: torch.Tensor,  # [B, K+1] cache slots (pad -> trash slot)
    block_tables: torch.Tensor,  # [B, MB]
    context_lens: torch.Tensor,  # [B] prefix + valid suffix length
    cache: Cache,
    config: LlamaConfig,
    *,
    block_size: int,
    lora: "dict | None" = None,  # ids [B] per row
) -> tuple[torch.Tensor, Cache]:
    """Speculative verification: score a drafted suffix in one pass
    through the paged prefill path -> (logits [B, K+1, V] fp32, cache);
    position j conditions on the fed tokens 0..j. A row with no draft is
    a plain decode step (pad columns write the trash slot)."""
    h, cache = _paged_forward(
        params, tokens, positions, slot_mapping, block_tables, context_lens,
        cache, config, block_size=block_size, lora=lora,
    )
    return _lm_head(params, h, config), cache


def _page_attend_prefill(
    q: torch.Tensor,             # [B, S, H, D] (rope'd)
    k_cache_l: torch.Tensor,     # [KVH, num_slots+trash, D]
    v_cache_l: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB]
    context_lens: torch.Tensor,  # [B]
    positions: torch.Tensor,     # [B, S] absolute query positions
    c: LlamaConfig,
    *,
    block_size: int,
) -> torch.Tensor:
    """Gather the full paged context and run masked attention.
    mask: kv_pos <= q_pos (causal, absolute) AND kv_pos < context_len."""
    B, S, H, D = q.shape
    KVH = c.n_kv_heads
    G = H // KVH
    MB = block_tables.shape[1]
    S_kv = MB * block_size

    offs = torch.arange(S_kv, device=q.device)
    slots = block_tables.long()[:, offs // block_size] * block_size + offs % block_size
    k = k_cache_l[:, slots].float()  # [KVH, B, S_kv, D] (head-major cache)
    v = v_cache_l[:, slots].float()

    qg = q.reshape(B, S, KVH, G, D).float()
    scores = torch.einsum("bshgd,hbtd->bhgst", qg, k) * (1.0 / D ** 0.5)
    kv_pos = offs[None, :]  # [1, S_kv]
    valid = kv_pos < context_lens.long()[:, None]  # [B, S_kv]
    causal = kv_pos[:, None, :] <= positions.long()[:, :, None]  # [B, S, S_kv]
    mask = (valid[:, None, :] & causal)[:, None, None, :, :]  # [B,1,1,S,S_kv]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)  # fully-masked pad rows
    out = torch.einsum("bhgst,hbtd->bshgd", probs, v)
    return out.reshape(B, S, H, D).to(q.dtype)


def ragged_forward(
    params: Params,
    tokens: torch.Tensor,        # [T] packed tokens (pad rows trail)
    positions: torch.Tensor,     # [T] absolute positions (pad = 0)
    slot_mapping: torch.Tensor,  # [T] cache slots (pad -> trash slot)
    block_tables: torch.Tensor,  # [B, MB]
    cu_q_lens: torch.Tensor,     # [B+1] exclusive prefix sums of row lengths
    context_lens: torch.Tensor,  # [B] prefix + suffix length (pad seq = 0)
    cache: Cache,
    config: LlamaConfig,
    *,
    block_size: int,
    max_q_len: int,
    attn_impl: str = "auto",
    lora: "dict | None" = None,  # ids [T] per packed token
) -> tuple[torch.Tensor, Cache]:
    """Packed ragged transformer body over the paged cache: prefill
    chunks and decode rows concatenated along one token axis, each
    sequence delimited by ``cu_q_lens``, attention via ``ops/ragged.py``.
    Returns final hidden states [T, D] and the (updated) cache."""
    c = config
    T = tokens.shape[0]
    if max_q_len > c.max_seq:
        raise ValueError(
            f"max_q_len {max_q_len} > max_seq={c.max_seq}; RoPE tables "
            "only cover max_seq positions"
        )
    cos, sin = _rope(c, tokens.device)
    h = params["embed"][tokens.long()][None]  # [1, T, D]
    pos2 = positions.long()[None]  # [1, T]
    slots = slot_mapping.long()
    lora_mask, lora_ls = _lora_layers(lora) if lora is not None else (None, None)
    for i in range(c.n_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["ln1"], c.rms_eps)
        q, k, v = _qkv(x, lp, c)
        if lora_ls is not None:
            q, k, v = _apply_lora_packed(q, k, v, x, lora_ls[i], lora_mask)
        q = apply_rope(q, cos, sin, pos2)
        k = apply_rope(k, cos, sin, pos2)
        _write_kv(cache["k"][i], slots, k[0])
        _write_kv(cache["v"][i], slots, v[0])
        o = ragged_attention(
            q[0].contiguous(), cache["k"][i], cache["v"][i], block_tables, cu_q_lens,
            context_lens, block_size=block_size, max_q_len=max_q_len, impl=attn_impl,
        )[None]  # [1, T, H, D]
        h = h + _out_proj(o, lp, 1, T, c)
        x = rms_norm(h, lp["ln2"], c.rms_eps)
        h = h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    h = rms_norm(h[0], params["final_norm"], c.rms_eps)  # [T, D]
    return h, cache


def mixed_step(
    params: Params,
    tokens: torch.Tensor,        # [T] packed tokens
    positions: torch.Tensor,     # [T]
    slot_mapping: torch.Tensor,  # [T]
    block_tables: torch.Tensor,  # [B, MB]
    cu_q_lens: torch.Tensor,     # [B+1]
    context_lens: torch.Tensor,  # [B]
    cache: Cache,
    config: LlamaConfig,
    *,
    block_size: int,
    max_q_len: int,
    attn_impl: str = "auto",
    lora: "dict | None" = None,  # ids [T] per packed token
) -> tuple[torch.Tensor, Cache]:
    """One mixed prefill+decode step -> (last-row logits [B, V], cache).
    Pad sequences (q_len 0) alias a neighbour's last row; their logits
    are discarded by the caller."""
    h, cache = ragged_forward(
        params, tokens, positions, slot_mapping, block_tables, cu_q_lens,
        context_lens, cache, config, block_size=block_size,
        max_q_len=max_q_len, attn_impl=attn_impl, lora=lora,
    )
    T = tokens.shape[0]
    last = (cu_q_lens[1:].long() - 1).clamp(0, T - 1)  # [B]
    return _lm_head(params, h[last], config), cache


def verify_tokens_ragged(
    params: Params,
    tokens: torch.Tensor,        # [T] packed (current token + draft) rows
    positions: torch.Tensor,     # [T]
    slot_mapping: torch.Tensor,  # [T]
    block_tables: torch.Tensor,  # [B, MB]
    cu_q_lens: torch.Tensor,     # [B+1]
    context_lens: torch.Tensor,  # [B]
    gather_idx: torch.Tensor,    # [B, K+1] packed row of each draft position
    cache: Cache,
    config: LlamaConfig,
    *,
    block_size: int,
    max_q_len: int,
    attn_impl: str = "auto",
    lora: "dict | None" = None,  # ids [T] per packed token
) -> tuple[torch.Tensor, Cache]:
    """Ragged speculative verification -> (logits [B, K+1, V], cache):
    each row packs exactly 1 + draft_len tokens (the ragged kernel on the
    card). ``gather_idx`` maps draft position j back to its packed row;
    positions past a row's draft repeat its last token and are masked by
    draft_lens downstream."""
    h, cache = ragged_forward(
        params, tokens, positions, slot_mapping, block_tables, cu_q_lens,
        context_lens, cache, config, block_size=block_size,
        max_q_len=max_q_len, attn_impl=attn_impl, lora=lora,
    )
    return _lm_head(params, h[gather_idx.long()], config), cache


def decode_step(
    params: Params,
    tokens: torch.Tensor,        # [B] current tokens
    positions: torch.Tensor,     # [B] absolute positions
    slot_mapping: torch.Tensor,  # [B] slot for the new K/V
    block_tables: torch.Tensor,  # [B, MB] int32
    context_lens: torch.Tensor,  # [B] int32 length INCLUDING current token
    cache: Cache,
    config: LlamaConfig,
    *,
    block_size: int,
    attn_impl: str = "auto",
    lora: "dict | None" = None,  # ids [B] per row
) -> tuple[torch.Tensor, Cache]:
    """One decode step for the running batch -> (logits [B, V], cache)."""
    c = config
    B = tokens.shape[0]
    cos, sin = _rope(c, tokens.device)
    h = params["embed"][tokens.long()][:, None]  # [B, 1, D]
    pos2 = positions.long()[:, None]  # [B, 1]
    slots = slot_mapping.long()
    lora_mask, lora_ls = _lora_layers(lora) if lora is not None else (None, None)
    for i in range(c.n_layers):
        lp = _layer(params["layers"], i)
        x = rms_norm(h, lp["ln1"], c.rms_eps)
        q, k, v = _qkv(x, lp, c)
        if lora_ls is not None:
            q, k, v = _apply_lora(q, k, v, x, lora_ls[i], lora_mask)
        q = apply_rope(q, cos, sin, pos2)
        k = apply_rope(k, cos, sin, pos2)
        _write_kv(cache["k"][i], slots, k[:, 0])
        _write_kv(cache["v"][i], slots, v[:, 0])
        o = paged_attention(
            q[:, 0].contiguous(), cache["k"][i], cache["v"][i], block_tables,
            context_lens, block_size=block_size, impl=attn_impl,
        )[:, None]  # [B, 1, H, D]
        h = h + _out_proj(o, lp, B, 1, c)
        x = rms_norm(h, lp["ln2"], c.rms_eps)
        h = h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    h = rms_norm(h[:, 0], params["final_norm"], c.rms_eps)  # [B, D]
    return _lm_head(params, h, c), cache
