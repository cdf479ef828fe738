"""Disaggregated prefill/decode serving (counterpart of ``ray_tpu/llm/disagg``).

Prefill and decode run on separate engine pools; a request migrates once,
as a ``KVHandoff`` (KV pages + request state) over a ``KVConnector`` (the
in-process one; the cluster-RPC and device connectors are not ported).
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
    "make_connector",
]
