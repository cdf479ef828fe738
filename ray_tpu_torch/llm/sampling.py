"""Sampling: per-request params and one batched sampler on the device
(counterpart of ``ray_tpu/llm/sampling.py``).

Randomness: every sampled row draws its noise from its own
``torch.Generator`` seeded by ``row_seed(request seed base, absolute
output index)``, so a seeded request emits the same tokens however its
decode is chunked and whatever its batch-mates are. The streams differ
from the reference's threefry keys, so seeded outputs match the
reference in distribution, not bit for bit.

All modes sample by Gumbel-max over the same per-row noise: ``categorical``
takes argmax(logits / T + g) over the vocab; ``full`` and ``full_sort``
take the same argmax restricted to the top-k / top-p survivors. A row
with no filter therefore emits the same token in every mode.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Sequence

import torch


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 1.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1.0 = off
    stop_token_ids: tuple = ()
    ignore_eos: bool = False
    seed: Optional[int] = None
    logprobs: bool = False

    def __post_init__(self):
        # validate at admission, not inside the batched sampler: a bad knob
        # must fail the request, not a whole decode batch
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}"
            )
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        # top_p = 0 is accepted (OpenAI clients send it) and means the
        # smallest possible nucleus: the single most likely token
        if not (0.0 <= self.top_p <= 1.0):
            raise ValueError(
                f"top_p must be in [0, 1], got {self.top_p}"
            )

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def needs_full_sort(self) -> bool:
        """top_k beyond the TOP_CAP fast path: the capped sampler would
        silently clamp it, so the batch must take the full-sort path."""
        return self.top_k > TOP_CAP


# top-k/top-p filtering is applied on the TOP_CAP largest logits only;
# exact for top_k <= 256 and for any nucleus inside the top 256 tokens.
# Batches with a request whose top_k exceeds it take mode "full_sort".
TOP_CAP = 256

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_seed_base(seed: int, request_id: str) -> int:
    """Per-request seed base from the request (or engine) seed and the
    request id. The id is hashed with ``zlib.crc32``, not ``hash()``:
    Python salts ``str`` hashes per process, which would make a seeded
    request's stream differ from one process to the next."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ zlib.crc32(request_id.encode()))


def row_seed(base: int, index: int) -> int:
    """Generator seed for the token at absolute output ``index``."""
    return _splitmix64(base ^ index) >> 1  # 63 bits: any torch seed


def _gumbel(seeds: Sequence[Optional[int]], V: int, device) -> torch.Tensor:
    """[B, V] Gumbel noise, row i from a generator seeded with seeds[i];
    rows whose seed is None (greedy or pad rows) get zeros."""
    g = torch.zeros((len(seeds), V), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for i, s in enumerate(seeds):
        if s is None:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(s)
        u = torch.rand(V, generator=gen, device=device).clamp_min_(tiny)
        g[i] = -torch.log(-torch.log(u))
    return g


def sample_tokens(
    logits: torch.Tensor,        # [B, V] fp32
    temperatures: torch.Tensor,  # [B] (0 = greedy)
    top_ks: torch.Tensor,        # [B] int (0 = off)
    top_ps: torch.Tensor,        # [B] (1.0 = off)
    seeds: Sequence[Optional[int]],  # [B] per-row generator seeds (None: no noise)
    mode: str = "full",          # "greedy" | "categorical" | "full" | "full_sort"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B] int64, logprobs [B] fp32), on the logits' device.

    ``mode`` is the fast path the engine derives from the batch:
      * greedy: every row has temperature 0 — argmax only;
      * categorical: temperature sampling, no top-k/top-p — no sort;
      * full: top-k/top-p filtering on the TOP_CAP largest logits;
      * full_sort: exact filtering over the whole vocabulary."""
    greedy_tok = torch.argmax(logits, dim=-1)
    logp_all = torch.log_softmax(logits, dim=-1)
    if mode == "greedy":
        tok = greedy_tok
    else:
        V = logits.shape[-1]
        t = torch.where(temperatures <= 0.0, torch.ones_like(temperatures), temperatures)
        scaled = logits / t[:, None]
        g = _gumbel(seeds, V, logits.device)
        sampled = torch.argmax(scaled + g, dim=-1)
        if mode in ("full", "full_sort"):
            cap = V if mode == "full_sort" else min(TOP_CAP, V)
            if cap == V:
                top_vals, top_idx = torch.sort(scaled, dim=-1, descending=True)
            else:
                top_vals, top_idx = torch.topk(scaled, cap, dim=-1)  # descending
            pos = torch.arange(cap, device=logits.device)[None, :]
            # top-k: keep positions < k (k = 0/off or > cap keeps all)
            k = torch.where((top_ks <= 0) | (top_ks > cap), torch.full_like(top_ks, cap), top_ks)
            vals = top_vals.masked_fill(pos >= k[:, None], float("-inf"))
            # top-p: smallest prefix of the sorted probs with mass >= p;
            # the first token is always kept (top_p = 0 included)
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = ((cum - probs) < top_ps[:, None]) | (pos == 0)
            vals = vals.masked_fill(~keep, float("-inf"))
            choice = torch.argmax(vals + torch.gather(g, 1, top_idx), dim=-1)
            filtered = torch.gather(top_idx, 1, choice[:, None])[:, 0]
            needs = ((top_ks > 0) | (top_ps < 1.0)) & (temperatures > 0.0)
            sampled = torch.where(needs, filtered, sampled)
        tok = torch.where(temperatures <= 0.0, greedy_tok, sampled)
    logprob = torch.gather(logp_all, 1, tok[:, None])[:, 0]
    return tok, logprob
