"""Llama-family decoder configuration and weights (counterpart of
``ray_tpu/models/llama.py``).

Weights use the reference's stacked-layer dict layout: every per-layer
weight carries a leading ``n_layers`` axis (``params["layers"]["wq"]`` is
[L, d_model, n_heads * head_dim]), so the decode paths walk layers by
indexing and a JAX checkpoint carries across key for key
(``params_from_numpy``).

Unlike the reference, which keeps fp32 params and casts per op, weights
live in the compute dtype: casting once at load gives the same values
and halves the weight memory of a bf16 model. The training forward and
loss come with the training slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

from ray_tpu_torch import resolve_device

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
    dtype: torch.dtype = torch.bfloat16  # compute, activation and weight dtype
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


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
    max_seq=128,
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
                device="cuda") -> Params:
    """Random weights in ``config.dtype`` on ``device``: truncated-normal
    fan-in init for the matrices (std 1 for the embedding), ones for the
    norms. ``generator`` must live on ``device``; None seeds one with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def tensor(shape, init):
        t = torch.empty(shape, dtype=config.dtype, device=dev)
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
    are cast to ``config.dtype``. A tied-embedding config takes no
    ``lm_head`` (the head is ``embed.T``); an untied one requires it."""
    dev = resolve_device(device)
    shapes = param_shapes(config)

    def convert(name, arr, shape):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {arr.shape} != expected {shape}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=config.dtype
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
