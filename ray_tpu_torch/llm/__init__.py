"""LLM serving on the paged KV cache (counterpart of ``ray_tpu/llm``)."""

from ray_tpu_torch.llm.engine import AdapterSlotsExhausted, EngineConfig, LLMEngine
from ray_tpu_torch.llm.sampling import SamplingParams

__all__ = ["AdapterSlotsExhausted", "EngineConfig", "LLMEngine", "SamplingParams"]
