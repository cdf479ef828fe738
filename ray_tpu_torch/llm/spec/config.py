"""SpecConfig: the EngineConfig.spec knob block (counterpart of
``ray_tpu/llm/spec/config.py``). Validation happens at engine
construction, not in the decode loop."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ray_tpu_torch.llm.kv_cache import KVCacheConfig

# the registry names a draft model may be given by (the reference's
# models/registry.py, restricted to the configs the port has)
_MODELS = {"llama3-8b": "LLAMA3_8B", "llama3-1b": "LLAMA3_1B",
           "llama-400m": "LLAMA_400M", "llama-tiny": "LLAMA_TINY"}


def get_model_config(name: str):
    from ray_tpu_torch.models import llama

    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; the port has {sorted(_MODELS)}")
    return getattr(llama, _MODELS[name])


@dataclasses.dataclass
class SpecConfig:
    # k: drafted tokens per verification pass
    num_draft_tokens: int = 4
    method: str = "prompt_lookup"  # "prompt_lookup" | "draft_model"

    # prompt-lookup drafting: the longest suffix n-gram of the history
    # that occurred earlier proposes the tokens that followed it
    max_ngram: int = 3
    min_ngram: int = 1
    max_history: int = 4096  # lookup window (host-side cost cap)

    # draft-model drafting: a smaller llama over the port's llama_decode
    # with its OWN paged cache (draft_kv sizes it)
    draft_model: Any = None          # LlamaConfig or registry name
    draft_params: Any = None         # torch params on the engine's device; random if None
    draft_kv: Optional[KVCacheConfig] = None
    draft_seed: int = 0

    def __post_init__(self):
        if self.num_draft_tokens < 1:
            raise ValueError(
                f"num_draft_tokens must be >= 1, got {self.num_draft_tokens}"
            )
        if self.method not in ("prompt_lookup", "draft_model"):
            raise ValueError(
                f"spec method must be 'prompt_lookup' or 'draft_model', "
                f"got {self.method!r}"
            )
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{self.min_ngram}/{self.max_ngram}"
            )
        if isinstance(self.draft_model, str):
            self.draft_model = get_model_config(self.draft_model)
        if self.method == "draft_model" and self.draft_model is None:
            raise ValueError("method='draft_model' requires draft_model")

    def build_drafter(self, target_config, device):
        """The drafter for an engine serving ``target_config`` on ``device``."""
        from ray_tpu_torch.llm.spec.drafter import DraftModelDrafter, PromptLookupDrafter

        if self.method == "prompt_lookup":
            return PromptLookupDrafter(
                max_ngram=self.max_ngram,
                min_ngram=self.min_ngram,
                max_history=self.max_history,
            )
        if self.draft_model.vocab_size != target_config.vocab_size:
            # drafted ids are fed straight to the target verifier
            raise ValueError(
                f"draft model vocab {self.draft_model.vocab_size} != target "
                f"vocab {target_config.vocab_size}"
            )
        return DraftModelDrafter(
            self.draft_model, params=self.draft_params, kv=self.draft_kv,
            seed=self.draft_seed, device=device,
        )
