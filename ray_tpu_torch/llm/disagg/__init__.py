"""Disaggregated prefill/decode serving (counterpart of ``ray_tpu/llm/disagg``).

Prefill and decode run on separate engine pools; a request migrates once,
as a ``KVHandoff`` (KV pages + request state) over a ``KVConnector``
(in-process, RPC frames, or device tensors through ``ray_tpu_torch.fabric``,
chosen per prefill -> decode edge by the fabric topology).
The ``DisaggOrchestrator`` routes new requests to the prefill pool, picks
a decode engine by queue depth with prefix-cache tiebreaks, and
re-prefills on any transfer loss with delivered-token watermarks, so each
output position reaches the caller once. ``LLMConfig(disagg=DisaggConfig(
...))`` serves it behind the OpenAI routes (``llm/openai_api.py``).
"""

from ray_tpu_torch.llm.disagg.connector import (
    InProcessConnector,
    KVConnector,
    KVTransferError,
    RpcKVConnector,
    make_connector,
)
from ray_tpu_torch.llm.disagg.handoff import KVHandoff
from ray_tpu_torch.llm.disagg.orchestrator import DisaggConfig, DisaggOrchestrator

__all__ = [
    "DisaggConfig",
    "DisaggOrchestrator",
    "InProcessConnector",
    "KVConnector",
    "KVHandoff",
    "KVTransferError",
    "RpcKVConnector",
    "make_connector",
]
