"""Batch LLM inference as a dataset stage (counterpart of
``ray_tpu/llm/batch.py``).

The processor is a ``map_batches`` stage holding one engine per worker:
rows in, rows + generated text out, continuous batching inside the stage.
``build_processor`` returns ``apply(dataset)``, which calls a
``ray_tpu_torch.data.Dataset``'s ``map_batches`` with the reference's
arguments: the stage class goes onto an actor pool of one (a thread of this
process, on the port's runtime), its engine on ``ProcessorConfig.device``.
The engine's graphs capture on that actor's thread. When the pool is
killed at the end of the stream the actor drops its instance, and with it
the engine's KV cache and graphs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine
from ray_tpu_torch.llm.openai_api import ByteTokenizer, default_chat_template
from ray_tpu_torch.llm.sampling import SamplingParams


@dataclass
class ProcessorConfig:
    """Reference analog: vLLMEngineProcessorConfig (batch/processor/)."""

    engine: EngineConfig = field(default_factory=EngineConfig)
    tokenizer: Any = None
    params: Any = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    prompt_column: str = "prompt"
    messages_column: Optional[str] = None  # chat mode if set
    output_column: str = "generated_text"
    seed: int = 0
    batch_size: int = 64
    # the port's entry-point rule: the card unless the caller asks for the CPU
    device: str = "cuda"


class _EngineStage:
    """Callable class for map_batches: one engine per worker, reused across
    blocks."""

    def __init__(self, config: ProcessorConfig):
        self.config = config
        self.tokenizer = config.tokenizer or ByteTokenizer(config.engine.model.vocab_size)
        config.engine.eos_token_id = getattr(self.tokenizer, "eos_token_id", 2)
        self.engine = LLMEngine(config.engine, params=config.params, seed=config.seed,
                                device=config.device)

    def __call__(self, batch: dict) -> dict:
        cfg = self.config
        if cfg.messages_column is not None:
            prompts = [default_chat_template(m) for m in batch[cfg.messages_column]]
        else:
            prompts = [str(p) for p in batch[cfg.prompt_column]]
        ids = [self.tokenizer.encode(p) for p in prompts]
        outs = self.engine.generate(ids, cfg.sampling)
        texts = []
        eos = self.engine.config.eos_token_id
        for toks in outs:
            if toks and toks[-1] == eos:
                toks = toks[:-1]
            texts.append(self.tokenizer.decode(toks))
        out = dict(batch)
        out[cfg.output_column] = texts
        return out


def build_processor(config: ProcessorConfig) -> Callable:
    """Returns dataset -> dataset (reference: build_llm_processor)."""

    def apply(dataset):
        return dataset.map_batches(
            _EngineStage,
            fn_constructor_args=(config,),
            batch_size=config.batch_size,
            concurrency=1,
        )

    return apply
