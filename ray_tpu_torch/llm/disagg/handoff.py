"""KVHandoff: the unit a prefill engine exports and a decode engine imports
(counterpart of ``ray_tpu/llm/disagg/handoff.py``).

One handoff is one request's whole migration state: the KV pages the
prefill pass wrote, position-ordered ``[L, KVH, n_kv, D]`` (the layout
``SequenceBlocks.slots_for_range`` maps back onto any block assignment),
and what the decode side needs to continue the request bit for bit: the
request's sampling seed base (``sampling.request_seed_base``; the port's
streams depend only on (seed base, output index), so a seeded stream goes
on unchanged after the hop), the sampled-so-far outputs, logprob
accounting, the LoRA adapter, timestamps and the trace context.

The pages are ``torch.Tensor``s (numpy has no bfloat16): on the CPU, in
pinned memory when the export staged them from the card, for the host
planes; on the card for the device fabric. ``seal()`` stamps a CRC over
the pages' bytes and the token ids, read through zero-copy ``uint8``
views; ``verify()`` re-checks it where the handoff arrives, so a handoff
torn in flight is re-prefilled, never decoded from garbage K/V.

Device path (``ray_tpu_torch.fabric``): ``seal(device=True)`` reduces the
page sums ON the pages' device (``fabric.transport.device_checksum``: only
4-byte scalars cross to the host) and records
``checksum_kind="device_u32"``; ``verify()`` dispatches on the kind, so one
handoff flows through either plane and a bit flip is caught either way.
The device checksum equals the reference's for the same pages and tokens.
``to_host()`` turns a device handoff into CPU pages, CRC-sealed: the
orchestrator uses it when a device edge falls back to RPC.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional

import numpy as np
import torch


def _bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a uint8 array, without a copy when it is
    contiguous."""
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


@dataclasses.dataclass
class KVHandoff:
    request_id: str
    prompt_token_ids: list
    output_token_ids: list          # sampled so far (>= 1: the prefill token)
    sampling_params: Any            # llm.sampling.SamplingParams
    seed_base: int                  # sampling.request_seed_base of the request
    num_kv_tokens: int              # positions covered by the pages below
    k_pages: torch.Tensor           # [L, KVH, num_kv_tokens, D]: CPU (host planes) or card
    v_pages: torch.Tensor
    model_sig: tuple                # (n_layers, n_kv_heads, head_dim)
    lora_id: Optional[str] = None
    cumulative_logprob: float = 0.0
    token_logprobs: list = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0
    t_first_prefill: Optional[float] = None
    t_first_token: Optional[float] = None
    t_export: float = 0.0
    trace: Optional[dict] = None    # the TraceContext's fields
    # the prefill engine that exported it; advisory, not covered by the CRC
    src_engine: Optional[int] = None
    checksum: int = 0
    checksum_kind: str = "crc32"    # "crc32" (host) | "device_u32" (fabric)
    # milliseconds of each stage of this handoff (export: pin, gather, d2h,
    # seal; import: verify, h2d, scatter); advisory, not covered by the CRC
    timings: dict = dataclasses.field(default_factory=dict)

    def _token_bytes(self) -> bytes:
        return np.asarray(self.prompt_token_ids + self.output_token_ids, np.int64).tobytes()

    def _crc(self) -> int:
        crc = zlib.crc32(_bytes(self.k_pages))
        crc = zlib.crc32(_bytes(self.v_pages), crc)
        crc = zlib.crc32(self._token_bytes(), crc)
        return crc & 0xFFFFFFFF

    def _device_sum(self) -> int:
        # the page sums reduce on the pages' own device; the token ids are a
        # small host list, CRC'd on the host. The one chained fold
        # (ArrayBundle._sum, name-bound: K and V delivered swapped fail),
        # then the token CRC folded on top
        from ray_tpu_torch.fabric.transport import ArrayBundle

        crc = ArrayBundle("", {"k_pages": self.k_pages, "v_pages": self.v_pages})._sum()
        token_crc = zlib.crc32(self._token_bytes()) & 0xFFFFFFFF
        return zlib.crc32(token_crc.to_bytes(4, "big"), crc) & 0xFFFFFFFF

    def seal(self, device: bool = False) -> "KVHandoff":
        if device:
            self.checksum_kind = "device_u32"
            self.checksum = self._device_sum()
        else:
            self.checksum_kind = "crc32"
            self.checksum = self._crc()
        return self

    def verify(self) -> bool:
        if self.checksum_kind == "device_u32":
            return self.checksum == self._device_sum()
        return self.checksum == self._crc()

    def to_host(self) -> "KVHandoff":
        """A host copy (CPU pages, CRC-sealed): the form the pickling RPC
        and in-process connectors ship. A handoff already on the host is
        returned as it is."""
        if self.checksum_kind == "crc32" and self.k_pages.device.type == "cpu":
            return self
        return dataclasses.replace(
            self, k_pages=self.k_pages.cpu(), v_pages=self.v_pages.cpu(),
            timings=dict(self.timings),
        ).seal()

    @property
    def nbytes(self) -> int:
        return int(self.k_pages.numel() * self.k_pages.element_size()
                   + self.v_pages.numel() * self.v_pages.element_size())
