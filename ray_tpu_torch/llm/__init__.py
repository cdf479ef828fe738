"""LLM serving on the paged KV cache (counterpart of ``ray_tpu/llm``): the
engine, the OpenAI-compatible front end and the batch processor."""

from ray_tpu_torch.llm.batch import ProcessorConfig, build_processor
from ray_tpu_torch.llm.engine import (
    AdapterSlotsExhausted,
    EngineConfig,
    EnginePreempted,
    LLMEngine,
    Request,
    RequestOutput,
)
from ray_tpu_torch.llm.openai_api import ByteTokenizer, LLMConfig, LLMServer
from ray_tpu_torch.llm.sampling import SamplingParams

__all__ = [
    "AdapterSlotsExhausted",
    "ByteTokenizer",
    "EngineConfig",
    "EnginePreempted",
    "LLMConfig",
    "LLMEngine",
    "LLMServer",
    "ProcessorConfig",
    "Request",
    "RequestOutput",
    "SamplingParams",
    "build_processor",
]
