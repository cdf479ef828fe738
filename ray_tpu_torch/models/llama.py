"""Llama-family decoder configuration and weights (counterpart of
``ray_tpu/models/llama.py``).

Weights use the reference's stacked-layer dict layout: every per-layer
weight carries a leading ``n_layers`` axis (``params["layers"]["wq"]`` is
[L, d_model, n_heads * head_dim]), so the decode paths walk layers by
indexing and a JAX checkpoint carries across key for key
(``params_from_numpy``).

Weights are made and loaded in ``config.param_dtype`` (fp32 master
weights by default, as in the reference) and cast per op to the compute
dtype ``config.dtype`` by the training forward. The serving engine asks
for its weights in the compute dtype instead (``init_params(...,
dtype=config.dtype)``): casting once at load gives the values a per-op
cast would, and halves the weight memory of a bf16 model.

Training (``hidden_states``, ``forward``, ``loss_fn``): a Python loop over
the stacked layers takes the place of ``lax.scan``; the stacked weights
are unbound once per call, so each leaf's gradient is gathered back into
the stacked leaf in one pass. Remat ``"full"`` checkpoints each block
(``torch.utils.checkpoint``); ``"dots"`` checkpoints it selectively,
saving the outputs of the projection matmuls and of the flash-attention
forward (the reference's dots policy plus its ``attn_out``/``attn_lse``
names), so the backward recomputes only elementwise work.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch import resolve_device
from ray_tpu_torch.nn.layers import (
    apply_rope,
    cross_entropy_loss,
    fused_cross_entropy_loss,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.flash import FLASH_FWD_OP

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute/activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # "full" recomputes the whole block in backward; "dots" saves the
    # matmul (and flash-attention) outputs and recomputes the rest
    remat_policy: str = "dots"
    attention_impl: str = "xla"
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def flops_per_token(self) -> float:
        """Approximate forward matmul FLOPs per token (2*params-style count)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim
        attn_proj = 2 * d * (self.n_heads * hd + 2 * self.n_kv_heads * hd + self.n_heads * hd)
        mlp = 2 * d * f * 3
        emb = 2 * d * self.vocab_size
        return L * (attn_proj + mlp) + emb

    def num_params(self) -> int:
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        hd = self.head_dim
        per_layer = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2) + 3 * d * f + 2 * d
        head = 0 if self.tie_embeddings else d * V
        return V * d + L * per_layer + d + head


LLAMA3_8B = LlamaConfig()
LLAMA3_1B = LlamaConfig(
    d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8, d_ff=8192, tie_embeddings=True
)
LLAMA_400M = LlamaConfig(
    vocab_size=32000, d_model=1024, n_layers=24, n_heads=16, n_kv_heads=8, d_ff=2816,
    max_seq=2048,
)
LLAMA_TINY = LlamaConfig(
    vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
    max_seq=128, remat=False,
)


def param_shapes(config: LlamaConfig) -> Params:
    """Shape of every weight, in the stacked-layer dict layout."""
    c = config
    hd, L = c.head_dim, c.n_layers
    shapes: Params = {
        "embed": (c.vocab_size, c.d_model),
        "layers": {
            "ln1": (L, c.d_model),
            "wq": (L, c.d_model, c.n_heads * hd),
            "wk": (L, c.d_model, c.n_kv_heads * hd),
            "wv": (L, c.d_model, c.n_kv_heads * hd),
            "wo": (L, c.n_heads * hd, c.d_model),
            "ln2": (L, c.d_model),
            "w_gate": (L, c.d_model, c.d_ff),
            "w_up": (L, c.d_model, c.d_ff),
            "w_down": (L, c.d_ff, c.d_model),
        },
        "final_norm": (c.d_model,),
    }
    if not c.tie_embeddings:
        shapes["lm_head"] = (c.d_model, c.vocab_size)
    return shapes


def _trunc_normal(out: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``out`` with a normal truncated at +-3 std (the reference's
    fan-in init), drawn in fp32 one leading slice at a time so a bf16 8B
    model never holds an fp32 copy of a whole weight stack."""
    slices = out if out.ndim == 3 else out[None]
    for dst in slices:
        tmp = torch.empty(dst.shape, dtype=torch.float32, device=out.device)
        torch.nn.init.trunc_normal_(tmp, std=std, a=-3 * std, b=3 * std,
                                    generator=generator)
        dst.copy_(tmp)


def init_params(config: LlamaConfig, generator: torch.Generator | None = None,
                device="cuda", dtype: torch.dtype | None = None) -> Params:
    """Random weights in ``dtype`` (default ``config.param_dtype``) on
    ``device``: truncated-normal fan-in init for the matrices (std 1 for
    the embedding), ones for the norms. ``generator`` must live on
    ``device``; None seeds one with 0."""
    dev = resolve_device(device)
    dtype = dtype or config.param_dtype
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def tensor(shape, init):
        t = torch.empty(shape, dtype=dtype, device=dev)
        if init == "ones":
            t.fill_(1.0)
        else:
            fan_in = shape[-2]
            std = 1.0 if init == "embed" else 1.0 / math.sqrt(fan_in)
            _trunc_normal(t, std, generator)
        return t

    shapes = param_shapes(config)
    params: Params = {
        "embed": tensor(shapes["embed"], "embed"),
        "layers": {
            k: tensor(s, "ones" if k.startswith("ln") else "dense")
            for k, s in shapes["layers"].items()
        },
        "final_norm": tensor(shapes["final_norm"], "ones"),
    }
    if "lm_head" in shapes:
        params["lm_head"] = tensor(shapes["lm_head"], "dense")
    return params


def params_from_numpy(tree: Mapping, config: LlamaConfig, device="cuda") -> Params:
    """The port's params from a reference params pytree given as nested
    dicts of numpy arrays (``jax.tree.map(np.asarray, params)``). Arrays
    are cast to ``config.param_dtype``. A tied-embedding config takes no
    ``lm_head`` (the head is ``embed.T``); an untied one requires it."""
    dev = resolve_device(device)
    shapes = param_shapes(config)

    def convert(name, arr, shape):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {arr.shape} != expected {shape}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=config.param_dtype
        )

    if config.tie_embeddings and "lm_head" in tree:
        raise ValueError("config ties embeddings but the tree has an lm_head")
    if not config.tie_embeddings and "lm_head" not in tree:
        raise ValueError("config has an untied lm_head but the tree has none")
    params: Params = {
        "embed": convert("embed", tree["embed"], shapes["embed"]),
        "layers": {
            k: convert(f"layers.{k}", tree["layers"][k], s)
            for k, s in shapes["layers"].items()
        },
        "final_norm": convert("final_norm", tree["final_norm"], shapes["final_norm"]),
    }
    if "lm_head" in shapes:
        params["lm_head"] = convert("lm_head", tree["lm_head"], shapes["lm_head"])
    return params


def params_to_numpy(params: Params) -> dict:
    """The reverse of ``params_from_numpy``: nested dicts of fp32 numpy
    arrays in the reference's pytree layout."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping)
                else v.detach().float().cpu().numpy())
            for k, v in params.items()}


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Every weight in ``dtype`` (a tensor already in it is kept, not copied)."""
    return {k: (cast_params(v, dtype) if isinstance(v, Mapping) else v.to(dtype))
            for k, v in params.items()}


def sorted_leaves(params: Mapping) -> list:
    """The leaves of a params tree with every dict's keys sorted: the order
    of ``jax.tree_util.tree_leaves`` on the reference's tree, so leaf i of
    one package's params is leaf i of the other's (the weight plane's wire
    order). ``train.step.param_leaves`` keeps insertion order instead."""
    out: list = []
    for k in sorted(params):
        v = params[k]
        out.extend(sorted_leaves(v) if isinstance(v, Mapping) else [v])
    return out


# ---------------------------------------------------------------------------
# training forward and loss (reference: ray_tpu/models/llama.py:155-341)
# ---------------------------------------------------------------------------


def packed_positions(segment_ids: Optional[torch.Tensor], seq_len: int,
                     device=None) -> torch.Tensor:
    """RoPE positions: arange normally; restart at 0 per segment when packing."""
    if segment_ids is None:
        return torch.arange(seq_len, device=device)
    idx = torch.arange(seq_len, device=segment_ids.device)[None, :]  # [1, S]
    changed = torch.cat(
        [torch.zeros_like(segment_ids[:, :1], dtype=torch.bool),
         segment_ids[:, 1:] != segment_ids[:, :-1]],
        dim=1,
    )
    seg_start = torch.cummax(torch.where(changed, idx, 0), dim=1).values  # [B, S]
    return idx - seg_start


def _block(h, lp, *, config: LlamaConfig, cos, sin, positions, segment_ids):
    c = config
    B, S, _ = h.shape
    hd = c.head_dim
    x = rms_norm(h, lp["ln1"], c.rms_eps)
    q = (x @ lp["wq"].to(x.dtype)).reshape(B, S, c.n_heads, hd)
    k = (x @ lp["wk"].to(x.dtype)).reshape(B, S, c.n_kv_heads, hd)
    v = (x @ lp["wv"].to(x.dtype)).reshape(B, S, c.n_kv_heads, hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    o = attention(q, k, v, causal=True, segment_ids=segment_ids, impl=c.attention_impl)
    h = h + o.reshape(B, S, c.n_heads * hd) @ lp["wo"].to(x.dtype)
    x = rms_norm(h, lp["ln2"], c.rms_eps)
    return h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": save the outputs of
    matmuls without batch dims (the reference's
    ``dots_with_no_batch_dims_saveable``) and of the flash forward (its
    ``attn_out``/``attn_lse`` names); recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, FLASH_FWD_OP):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block, config: LlamaConfig):
    if config.remat_policy == "full":
        return functools.partial(checkpoint, block, use_reentrant=False)
    if config.remat_policy == "dots":
        return functools.partial(
            checkpoint, block, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy),
        )
    raise ValueError(f"unknown remat_policy {config.remat_policy!r}; 'full' or 'dots'")


def hidden_states(
    params: Params,
    tokens: torch.Tensor,  # [B, S] int
    config: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence forward up to the final norm -> h [B, S, D] in the
    compute dtype. The training loss pairs it with
    ``nn.layers.fused_cross_entropy_loss``."""
    c = config
    B, S = tokens.shape
    if S > c.max_seq:
        raise ValueError(
            f"sequence length {S} exceeds config.max_seq={c.max_seq}; the RoPE "
            "table would index past its end — raise max_seq instead"
        )
    dev = tokens.device
    if positions is None:
        positions = packed_positions(segment_ids, S, device=dev)
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta, device=dev)
    h = params["embed"][tokens.long()].to(c.dtype)  # [B, S, D]

    block = functools.partial(_block, config=c, cos=cos, sin=sin, positions=positions.long(),
                              segment_ids=segment_ids)
    if c.remat and torch.is_grad_enabled():
        block = _remat(block, c)
    names = list(params["layers"])
    for weights in zip(*(params["layers"][n].unbind(0) for n in names)):
        h = block(h, dict(zip(names, weights)))
    return rms_norm(h, params["final_norm"], c.rms_eps)


def output_weight(params: Params) -> torch.Tensor:
    """[D, V] lm-head weight (the tied embedding's transpose when there is
    no lm_head)."""
    w_out = params.get("lm_head")
    return params["embed"].T if w_out is None else w_out


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig, *,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward -> logits [B, S, V] in the compute dtype."""
    h = hidden_states(params, tokens, config, positions=positions, segment_ids=segment_ids)
    return h @ output_weight(params).to(config.dtype)


def loss_fn(params: Params, batch: Mapping[str, torch.Tensor],
            config: LlamaConfig) -> torch.Tensor:
    loss, _ = loss_and_weight_fn(params, batch, config)
    return loss


def loss_and_weight_fn(params: Params, batch: Mapping[str, torch.Tensor],
                       config: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean_loss, valid_token_count), the weighted form grad accumulation
    needs. batch: tokens [B, S], targets [B, S], optional mask and
    segment_ids [B, S]. Uses the fused lm-head + cross entropy; setting
    RAY_TPU_NAIVE_CE (read at each call) takes the logits path instead,
    the reference's A/B switch."""
    seg = batch.get("segment_ids")
    if os.environ.get("RAY_TPU_NAIVE_CE"):
        logits = forward(params, batch["tokens"], config, segment_ids=seg)
        return cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
    h = hidden_states(params, batch["tokens"], config, segment_ids=seg)
    return fused_cross_entropy_loss(h, output_weight(params), batch["targets"],
                                    batch.get("mask"))
