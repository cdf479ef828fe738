"""Sampling: per-request params and one batched sampler on the device
(counterpart of ``ray_tpu/llm/sampling.py``).

Randomness is counter-based: the noise of output token ``index`` of a
request is a pure function of (request seed base, index, vocab id),
computed by int64 tensor ops on the logits' device (``noise_bits``, a
SplitMix64 stream per row). Nothing is seeded on the host per step, so a
decode chunk captured into a CUDA graph draws fresh noise at every
replay, and a seeded request emits the same tokens however its decode is
chunked and whatever its batch-mates are. The reference derives its keys
the same way (``fold_in(request key, index)``) but draws threefry bits,
so seeded outputs match it in distribution, not bit for bit.

All modes sample by Gumbel-max over the same per-row noise: ``categorical``
takes argmax(logits / T + g) over the vocab; ``full`` and ``full_sort``
take the same argmax restricted to the top-k / top-p survivors. A row
with no filter therefore emits the same token in every mode.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

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
_GAMMA = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _splitmix64(x: int) -> int:
    x = (x + _GAMMA) & _MASK64
    x = ((x ^ (x >> 30)) * _MIX1) & _MASK64
    x = ((x ^ (x >> 27)) * _MIX2) & _MASK64
    return x ^ (x >> 31)


def as_int64(u: int) -> int:
    """A 64-bit unsigned value as the int64 with the same bits."""
    u &= _MASK64
    return u - (1 << 64) if u >> 63 else u


def request_seed_base(seed: int, request_id: str) -> int:
    """Per-request seed base from the request (or engine) seed and the
    request id. The id is hashed with ``zlib.crc32``, not ``hash()``:
    Python salts ``str`` hashes per process, which would make a seeded
    request's stream differ from one process to the next."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ zlib.crc32(request_id.encode()))


def row_seed(base: int, index: int) -> int:
    """Seed of the token at absolute output ``index`` (63 bits, so it is
    a non-negative int64); ``row_seeds`` computes it on the device."""
    return _splitmix64(base ^ index) >> 1


# int64 tensor versions: torch's >> on int64 is arithmetic, so every
# shift is masked to a logical one; + and * wrap modulo 2**64
def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix64_t(x: torch.Tensor) -> torch.Tensor:
    x = x + as_int64(_GAMMA)
    x = (x ^ _srl(x, 30)) * as_int64(_MIX1)
    x = (x ^ _srl(x, 27)) * as_int64(_MIX2)
    return x ^ _srl(x, 31)


def row_seeds(bases: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``row_seed`` on the device: bases [B] int64 (``as_int64`` of the
    seed bases), indices [B] -> [B] int64 seeds."""
    return _srl(_splitmix64_t(bases ^ indices.long()), 1)


def stream_seeds(seeds: torch.Tensor, tag: int) -> torch.Tensor:
    """An independent stream per (row seed, tag): the speculative accept
    draws its uniforms (tag 0) and its resample (tag 1) from these, as the
    reference folds 0 and 1 into the row key."""
    return _srl(_splitmix64_t(seeds ^ (tag + 1)), 1)


def noise_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] int64: draw j of row b is the j-th output of SplitMix64
    seeded with seeds[b], i.e. splitmix64(seed + j * gamma)."""
    j = torch.arange(n, dtype=torch.int64, device=seeds.device)
    return _splitmix64_t(seeds.long()[:, None] + j[None, :] * as_int64(_GAMMA))


def uniforms(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] fp32 in (0, 1): the top 23 bits of each draw, centred (every
    value exact in fp32)."""
    return (_srl(noise_bits(seeds, n), 41).float() + 0.5) * (1.0 / (1 << 23))


def gumbel(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] fp32 standard Gumbel noise."""
    return -torch.log(-torch.log(uniforms(seeds, n)))


def sample_tokens(
    logits: torch.Tensor,        # [B, V] fp32
    temperatures: torch.Tensor,  # [B] (0 = greedy)
    top_ks: torch.Tensor,        # [B] int (0 = off)
    top_ps: torch.Tensor,        # [B] (1.0 = off)
    seeds: Optional[torch.Tensor],  # [B] int64 row seeds (row_seed); unused when greedy
    mode: str = "full",          # "greedy" | "categorical" | "full" | "full_sort"
    done: Optional[torch.Tensor] = None,  # [B] bool: finished-row mask
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B] int64, logprobs [B] fp32), on the logits' device.

    ``mode`` is the fast path the engine derives from the batch:
      * greedy: every row has temperature 0 — argmax only;
      * categorical: temperature sampling, no top-k/top-p — no sort;
      * full: top-k/top-p filtering on the TOP_CAP largest logits;
      * full_sort: exact filtering over the whole vocabulary.

    ``done`` (the pipelined chunk's stop mask): a finished row's logits
    are replaced by a one-hot before anything reads them and the row
    emits token 0 with logprob 0. The masking is a select, so live rows'
    draws are untouched whatever their batch-mates."""
    if done is not None:
        onehot = torch.zeros_like(logits)
        onehot[:, 0] = 1.0
        logits = torch.where(done[:, None], onehot, logits)
    greedy_tok = torch.argmax(logits, dim=-1)
    logp_all = torch.log_softmax(logits, dim=-1)
    if mode == "greedy":
        tok = greedy_tok
    else:
        V = logits.shape[-1]
        t = torch.where(temperatures <= 0.0, torch.ones_like(temperatures), temperatures)
        scaled = logits / t[:, None]
        g = gumbel(seeds, V)
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
    if done is not None:
        tok = torch.where(done, torch.zeros_like(tok), tok)
        logprob = torch.where(done, torch.zeros_like(logprob), logprob)
    return tok, logprob


def target_probs(
    logits: torch.Tensor,        # [B, V] fp32
    temperatures: torch.Tensor,  # [B] (<= 0 treated as 1.0)
    top_ks: torch.Tensor,        # [B] int (0 = off)
    top_ps: torch.Tensor,        # [B] (1.0 = off)
) -> torch.Tensor:
    """The normalized full-vocab distribution ``sample_tokens`` draws from,
    with temperature, top-k and top-p applied exactly (a descending sort
    over the whole vocab, no TOP_CAP): the speculative accept's view of
    the target."""
    V = logits.shape[-1]
    t = torch.where(temperatures <= 0.0, torch.ones_like(temperatures), temperatures)
    vals, idx = torch.sort(logits / t[:, None], dim=-1, descending=True)
    pos = torch.arange(V, device=logits.device)[None, :]
    k = torch.where((top_ks <= 0) | (top_ks > V), torch.full_like(top_ks, V), top_ks)
    vals = vals.masked_fill(pos >= k[:, None], float("-inf"))
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < top_ps[:, None]) | (pos == 0)
    p_sorted = torch.softmax(vals.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.zeros_like(p_sorted).scatter_(1, idx, p_sorted)
