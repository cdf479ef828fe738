"""Speculative decoding for the paged-KV engine (counterpart of
``ray_tpu/llm/spec``).

 * drafter.py — proposal sources: the model-free prompt-lookup drafter
   over the request's history, and a small draft model over the port's
   ``llama_decode`` with its own paged cache;
 * accept.py — distribution-preserving acceptance with the bonus /
   resample token, greedy short-circuit per row;
 * config.py — SpecConfig (EngineConfig.spec) and drafter construction;
 * stats.py — acceptance accounting for ``LLMEngine.stats()``.

The verify pass is ``models/llama_decode.verify_tokens`` (the paged
prefill path over k+1 tokens per row) or, with mixed batching,
``verify_tokens_ragged`` (packed rows through the ragged kernel).
Rejected positions roll back with ``SequenceBlocks.truncate_to``.
Not ported: the Prometheus counters and the timeline spans (they wait
for the port's metrics registry and profiler).
"""

from ray_tpu_torch.llm.spec.accept import accept_draft
from ray_tpu_torch.llm.spec.config import SpecConfig
from ray_tpu_torch.llm.spec.drafter import Drafter, DraftModelDrafter, PromptLookupDrafter
from ray_tpu_torch.llm.spec.stats import SpecStats

__all__ = [
    "Drafter",
    "DraftModelDrafter",
    "PromptLookupDrafter",
    "SpecConfig",
    "SpecStats",
    "accept_draft",
]
