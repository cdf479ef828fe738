"""Model registry: named presets + HuggingFace config mapping (counterpart
of ``ray_tpu/models/registry.py``).

Two entry points, as in the reference:

  * ``get_model_config("llama3-8b")`` — named presets (case-insensitive);
  * ``config_from_hf(json.load(open("config.json")))`` — map a HF
    transformers config dict onto a ``LlamaConfig`` (no downloads).

The Mixtral-style MoE decoder is not ported yet (ROADMAP.md, Queue 1, D3).
Its names stay listed, so ``list_models()`` is the reference's set, but
looking one up, or mapping a Mixtral config, raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.models import llama

_REGISTRY: dict[str, object] = {}

# a registered name whose decoder the port does not have yet
_MOE_UNPORTED = object()
_MOE_MESSAGE = (
    "the MoE decoder (models/moe.py) is not ported to ray_tpu_torch yet "
    "(ROADMAP.md, Queue 1, D3)"
)


def register_model(name: str, config) -> None:
    key = name.lower()
    if key in _REGISTRY:
        raise ValueError(f"model {name!r} already registered")
    _REGISTRY[key] = config


def get_model_config(name: str):
    """Named preset lookup (case-insensitive); returns a frozen config."""
    try:
        cfg = _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    if cfg is _MOE_UNPORTED:
        raise NotImplementedError(f"model {name!r}: {_MOE_MESSAGE}")
    return cfg


def list_models() -> list[str]:
    return sorted(_REGISTRY)


# -- presets (architecture hyperparameters from the public model cards) ------

for _name, _cfg in {
    "llama3-8b": llama.LLAMA3_8B,
    "llama3-1b": llama.LLAMA3_1B,
    "llama-400m": llama.LLAMA_400M,
    "llama-tiny": llama.LLAMA_TINY,
    "llama3-70b": dataclasses.replace(
        llama.LLAMA3_8B, d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        d_ff=28672,
    ),
    "mistral-7b": dataclasses.replace(
        llama.LLAMA3_8B, vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, rope_theta=10000.0,
        max_seq=32768,
    ),
    "qwen2-7b": dataclasses.replace(
        llama.LLAMA3_8B, vocab_size=152064, d_model=3584, n_layers=28,
        n_heads=28, n_kv_heads=4, d_ff=18944, rope_theta=1000000.0,
        max_seq=32768,
    ),
    "tinyllama-1.1b": dataclasses.replace(
        llama.LLAMA3_8B, vocab_size=32000, d_model=2048, n_layers=22,
        n_heads=32, n_kv_heads=4, d_ff=5632, rope_theta=10000.0,
        max_seq=2048,
    ),
    "mixtral-8x7b": _MOE_UNPORTED,
    "moe-tiny": _MOE_UNPORTED,
}.items():
    register_model(_name, _cfg)


# -- HF transformers config.json mapping -------------------------------------

_HF_LLAMA_ARCHS = {
    "LlamaForCausalLM", "MistralForCausalLM", "Qwen2ForCausalLM",
}
_HF_MOE_ARCHS = {"MixtralForCausalLM"}


def config_from_hf(hf: dict, **overrides):
    """Map a HF ``config.json`` dict to a ``LlamaConfig``.

    Only architecture hyperparameters travel; framework knobs (dtype,
    remat, attention_impl) keep their defaults unless overridden. Raises
    ValueError on architectures outside the llama/mixtral families rather
    than mis-mapping them, and NotImplementedError on a Mixtral config
    (the MoE decoder is not ported)."""
    archs = set(hf.get("architectures", ()))
    # the num_local_experts heuristic only applies to config dicts with NO
    # architectures field: other MoE configs also carry it and must be
    # rejected by the whitelist, not mapped onto Mixtral
    is_moe = bool(archs & _HF_MOE_ARCHS) or (
        not archs and "num_local_experts" in hf
    )
    if archs and not is_moe and not (archs & _HF_LLAMA_ARCHS):
        raise ValueError(
            f"unsupported architectures {sorted(archs)}; llama-family "
            f"({sorted(_HF_LLAMA_ARCHS)}) and mixtral-family "
            f"({sorted(_HF_MOE_ARCHS)}) map onto this framework's decoders"
        )
    scaling = hf.get("rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type")) != "default":
        # llama-3.1-style frequency rescaling changes every position's
        # rotation; mapping rope_theta alone would diverge silently
        raise ValueError(
            f"rope_scaling={scaling!r} is not supported; only default RoPE "
            "maps onto this decoder"
        )
    derived_hd = hf["hidden_size"] // hf["num_attention_heads"]
    if hf.get("head_dim") not in (None, derived_hd):
        raise ValueError(
            f"explicit head_dim={hf['head_dim']} != hidden_size/"
            f"num_attention_heads={derived_hd}; this decoder derives "
            "head_dim and would mis-shape the checkpoint"
        )
    if is_moe:
        raise NotImplementedError(f"a Mixtral-family config: {_MOE_MESSAGE}")
    common = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_ff=hf["intermediate_size"],
        max_seq=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    common.update(overrides)  # caller wins on collisions
    return llama.LlamaConfig(**common)
