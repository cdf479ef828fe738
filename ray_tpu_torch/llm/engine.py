"""Continuous-batching LLM engine (counterpart of ``ray_tpu/llm/engine.py``).

 * paged KV cache (``llm/kv_cache.py``) with prefix reuse;
 * scheduler: admit-prefill-then-decode with preemption by recompute and
   priority admission, host-side and O(batch);
 * mixed batching (``mixed_batch=True``): in-flight prefill chunks and
   every decode row in ONE ragged dispatch per step (``llm/mixed.py``,
   ``ops/ragged.py``); steps without prefill work take a decode round;
   on the card each mixed step, and each ragged spec verify pass, is a
   CUDA graph replay per packed-token bucket (``llm/graphs.py``
   ``PackedGraphs``), its logits sampled outside the graph;
 * decode rounds, as in the reference: pipelined (the default,
   ``llm/pipeline.py``: batch state on the device, stop ladder in the
   chunk, chunk N+1 dispatched before chunk N is synced, every chunk a
   CUDA graph replay on the card, ``llm/graphs.py``), speculative
   (``spec=SpecConfig(...)``, ``llm/spec``), or the sync chunked path
   (``pipeline_decode=False``, ``llm/decode_loop.py``);
 * LoRA multiplexing (``max_loras > 0``): up to ``max_loras`` adapters in
   slots of one set of stacks, every row of every program selecting its
   own (slot 0, the zero adapter, is the base model), prefix chains
   salted per slot;
 * the tiered prefix cache (``kvtier=``, ``llm/kvtier``, ``llm/kvfetch``):
   evicted full blocks spill to host memory and the object store, and
   admission (or the prefetch tick before it) scatters them back in place.

The API mirrors the reference (add_request / step / generate / stats /
recover / add_lora / remove_lora / evict_lru_lora, and the KV handoff of
disaggregated serving: export_request / import_handoff /
peek_prefix_tokens, ``llm/disagg``); ``EngineConfig.model`` takes a
registry name (``models/registry.py``). Not ported yet, and refused by
``EngineConfig`` with NotImplementedError so no caller silently gets a
different engine: tensor-parallel meshes and the profiling hooks
(ROADMAP.md, Queue 1).

Observability, as the reference's: every request carries a trace
(``obs/``) whose lifecycle spans tile arrival -> finish (queue_wait,
prefill, one span per decode round, the ``llm.request`` root), the SLO
histograms (``obs/slo.py``) record each finished request, the prefix,
preemption and utilization series live on ``util/metrics``, and the
``llm.engine.step`` chaos hook (``chaos/``) can preempt or slow a step.
The hooks read the host clock only: no device sync, nothing inside a
graph capture. Every observability error is swallowed (it must not break
decode).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.chaos import harness as _chaos
from ray_tpu_torch.chaos.harness import EnginePreempted
from ray_tpu_torch.llm import pipeline
from ray_tpu_torch.llm.graphs import ChunkGraphs, PackedGraphs
from ray_tpu_torch.llm.kv_cache import BlockAllocator, NoFreeBlocksError, SequenceBlocks
from ray_tpu_torch.llm.mixed import MixedBatchPlan, MixedStats, token_bucket
from ray_tpu_torch.llm.pipeline import CHUNK_BUCKETS, assemble_batch_arrays
from ray_tpu_torch.llm.sampling import (
    SamplingParams,
    request_seed_base,
    row_seed,
    sample_tokens,
)
from ray_tpu_torch.llm.spec import SpecConfig, SpecStats, accept_draft
from ray_tpu_torch.llm.spec.stats import export_spec_stats
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama_decode import (
    LORA_TARGETS,
    decode_step,
    init_cache,
    mixed_step,
    prefill,
    verify_tokens,
    verify_tokens_ragged,
)
from ray_tpu_torch.obs import context as trace_context
from ray_tpu_torch.obs import recorder as trace_recorder
from ray_tpu_torch.obs import slo
from ray_tpu_torch.obs.telemetry import cluster_counter, cluster_gauge
from ray_tpu_torch.ops.paged_attention import pick_impl
from ray_tpu_torch.util.metrics import Counter


def prefix_cache_hit_counter() -> Counter:
    """Prompt tokens served from the prefix cache instead of recomputed, by
    the tier that held them (``hbm``: the resident paged cache; ``host`` and
    ``object``: resurrected from the tiered cache, ``llm/kvtier``)."""
    return Counter(
        "llm_prefix_cache_hit_tokens_total",
        description="prompt tokens whose KV was reused from the prefix "
        "cache at prefill admission (no recompute), by serving tier "
        "(hbm/host/object)",
        tag_keys=("model", "tier"),
    )


def prefix_cache_lookup_counter() -> Counter:
    return Counter(
        "llm_prefix_cache_lookup_tokens_total",
        description="prompt tokens considered for prefix-cache reuse at "
        "prefill admission (hit_tokens / lookup_tokens = hit rate)",
        tag_keys=("model",),
    )


def record_prefix_lookup(model_tag: str, lookup_tokens: int, tier_counts: dict) -> None:
    try:
        prefix_cache_lookup_counter().inc(lookup_tokens, tags={"model": model_tag})
        for t, n in tier_counts.items():
            prefix_cache_hit_counter().inc(n, tags={"model": model_tag, "tier": t})
    except Exception:  # noqa: BLE001 — metrics must not break admission
        pass


def preemption_counter() -> Counter:
    """Requests kicked out of a running batch, by tenant and ``reason``:
    ``pressure`` (KV), ``priority`` (a higher-priority request displaced
    it) or ``recover`` (a crash-recovery re-enqueue)."""
    return cluster_counter(
        "llm_preemptions_total",
        description="requests preempted out of the decode batch, by "
        "model, tenant, and reason (pressure/priority/recover)",
        tag_keys=("model", "tenant", "reason"),
    )


def utilization_gauges() -> dict:
    """Per-engine utilization gauges; each aggregates by sum across engines."""
    return {
        "kv_pages_used": cluster_gauge(
            "llm_kv_pages_used",
            description="paged-KV blocks currently allocated in this "
            "engine (used = total - free)",
            tag_keys=("model",),
        ),
        "kv_pages_total": cluster_gauge(
            "llm_kv_pages_total",
            description="paged-KV blocks this engine was configured with",
            tag_keys=("model",),
        ),
        "kv_hbm_bytes": cluster_gauge(
            "llm_kv_hbm_bytes",
            description="bytes of accelerator memory held by this "
            "engine's paged KV cache (static allocation)",
            tag_keys=("model",),
        ),
        "queue_depth": cluster_gauge(
            "llm_queue_depth",
            description="requests waiting for prefill admission in this "
            "engine",
            tag_keys=("model",),
        ),
        "running": cluster_gauge(
            "llm_running_requests",
            description="requests in this engine's decode batch",
            tag_keys=("model",),
        ),
    }


def register_metrics() -> None:
    """Register the engine's lazily built metrics (a registry listing sees
    them before the first request)."""
    prefix_cache_hit_counter()
    prefix_cache_lookup_counter()
    preemption_counter()
    utilization_gauges()


class AdapterSlotsExhausted(ValueError):
    """Every LoRA adapter slot is loaded and none can be evicted (all are
    held by waiting or running requests, or eviction was not asked for).
    A ValueError, as the reference's."""


@dataclasses.dataclass
class EngineConfig:
    model: llama.LlamaConfig = dataclasses.field(default_factory=lambda: llama.LLAMA_TINY)
    num_blocks: int = 512
    block_size: int = 16
    max_num_seqs: int = 16          # decode batch ceiling
    max_prefill_len: int = 1024     # longest admitted prompt suffix
    attn_impl: str = "auto"         # auto | torch (CPU) | cuda
    cache_dtype: Any = None          # default: model dtype
    enable_prefix_caching: bool = True
    eos_token_id: int = 2
    mesh_spec: Any = None
    # LoRA multiplexing: up to max_loras adapters of rank lora_rank on the
    # lora_targets projections (a subset of wq / wk / wv), served from one
    # engine with mixed-adapter batches
    max_loras: int = 0
    lora_rank: int = 8
    lora_targets: tuple = ("wq", "wv")
    # decode+sample steps per host round trip (llm/decode_loop.py);
    # 1 = one sync per token. EOS overshoot is discarded host-side. With
    # pipeline_decode this is only the chunk controller's starting length
    decode_chunk: int = 8
    # pipelined decode (llm/pipeline.py, llm/graphs.py): batch state on the
    # device, stop ladder in the chunk, chunk N+1 dispatched before chunk N
    # is synced; token streams equal the sync path's. False keeps the sync
    # path (also taken for batches with > pipeline.STOP_WIDTH_CAP stop ids)
    pipeline_decode: bool = True
    profile: bool = False
    # speculative decoding (llm/spec): a SpecConfig (or a dict of one)
    # turns each decode round into draft -> one verify pass -> accept
    spec: Any = None
    # tiered prefix cache (llm/kvtier): evicted full blocks spill to host
    # memory and the object store, and admission resurrects them with a
    # verified scatter. True / a dict / a KVTierConfig; None keeps HBM only
    kvtier: Any = None
    # mixed ragged batching (llm/mixed.py over ops/ragged.py): prompts
    # stream mixed_prefill_chunk tokens per step, packed with every decode
    # row into one dispatch
    mixed_batch: bool = False
    mixed_prefill_chunk: int = 256

    def __post_init__(self):
        if isinstance(self.model, str):
            # registry name ("llama3-8b", "mistral-7b", ...); an MoE name
            # raises NotImplementedError (models/registry.py)
            from ray_tpu_torch.models.registry import get_model_config

            self.model = get_model_config(self.model)
        if not isinstance(self.model, llama.LlamaConfig):
            raise TypeError(
                f"EngineConfig.model must be a LlamaConfig or a registered model "
                f"name, got {type(self.model)}"
            )
        unported = (
            ("mesh_spec", self.mesh_spec is not None, "tensor-parallel serving (Queue 1, B4)"),
            ("profile", self.profile, "the decode profiling hooks (Queue 1, slice E)"),
        )
        for name, requested, item in unported:
            if requested:
                raise NotImplementedError(
                    f"EngineConfig.{name}: {item} is not ported to ray_tpu_torch "
                    "yet; see ROADMAP.md"
                )
        if self.attn_impl not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        self.lora_targets = tuple(self.lora_targets)
        if self.max_loras > 0 and (
            not self.lora_targets or not set(self.lora_targets) <= set(LORA_TARGETS)
        ):
            raise ValueError(
                f"lora_targets {self.lora_targets} must be a non-empty subset of {LORA_TARGETS}"
            )
        # a prefill bucket longer than the context window can never be used
        self.max_prefill_len = min(self.max_prefill_len, self.model.max_seq)
        self.decode_chunk = min(self.decode_chunk, CHUNK_BUCKETS[-1])
        self.mixed_prefill_chunk = max(
            1, min(self.mixed_prefill_chunk, self.max_prefill_len)
        )
        if self.spec is not None:
            if isinstance(self.spec, dict):
                self.spec = SpecConfig(**self.spec)
            if not isinstance(self.spec, SpecConfig):
                raise ValueError(
                    f"EngineConfig.spec must be a SpecConfig, got {type(self.spec)}"
                )
        if self.kvtier is not None:
            from ray_tpu_torch.llm.kvtier import KVTierConfig

            if self.kvtier is True:
                self.kvtier = KVTierConfig()
            elif isinstance(self.kvtier, dict):
                self.kvtier = KVTierConfig(**self.kvtier)
            if not isinstance(self.kvtier, KVTierConfig):
                raise ValueError(
                    f"EngineConfig.kvtier must be a KVTierConfig, True, or a dict, "
                    f"got {type(self.kvtier)}"
                )

    def prefill_buckets(self) -> list[int]:
        out, b = [], 16
        while b < self.max_prefill_len:
            out.append(b)
            b *= 2
        out.append(self.max_prefill_len)
        return out

    def decode_buckets(self) -> list[int]:
        out, b = [], 1
        while b < self.max_num_seqs:
            out.append(b)
            b *= 2
        out.append(self.max_num_seqs)
        return out

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.model.max_seq // self.block_size)


class RequestStatus:
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    ABORTED = "aborted"
    # exported to another engine by a KV handoff (disaggregated prefill/
    # decode); this engine no longer owns the request
    MIGRATED = "migrated"


class _Stages:
    """Milliseconds of named stages of device work: on the card CUDA events
    recorded on the stream each stage ran on (read once every stage is
    done), on the CPU the host clock, where the ops are synchronous."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._spans: list = []

    def start(self):
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()  # on the current stream
        return ev

    def stage(self, name: str, start) -> None:
        self._spans.append((name, start, self.start()))

    def done(self) -> dict:
        if self._cuda:
            for _, _, end in self._spans:
                end.synchronize()
            return {n: a.elapsed_time(b) for n, a, b in self._spans}
        return {n: (b - a) * 1e3 for n, a, b in self._spans}


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_token_ids: list
    sampling_params: SamplingParams
    output_token_ids: list = dataclasses.field(default_factory=list)
    status: str = RequestStatus.WAITING
    seq: Optional[SequenceBlocks] = None
    arrival: float = dataclasses.field(default_factory=time.time)
    finish_reason: Optional[str] = None
    num_preemptions: int = 0
    cumulative_logprob: float = 0.0
    token_logprobs: list = dataclasses.field(default_factory=list)
    # higher priority admits first and may preempt lower-priority requests
    priority: int = 0
    # seed of this request's sampling streams (sampling.request_seed_base)
    seed_base: int = 0
    # wall time the first output token was booked (survives preemption)
    t_first_token: Optional[float] = None
    # LoRA adapter slot (0 = base model); also the prefix-chain salt
    lora_slot: int = 0
    # fleet labels: tenant labels the preemption counter; slo_tag (when set)
    # records the request's SLO observations under a second series
    tenant: str = ""
    slo_tag: Optional[str] = None
    # request tracing (obs/): the submitter's TraceContext; every lifecycle
    # span records as its child. queue_start resets on preemption (each wait
    # is its own queue_wait span); first_prefill and first_token survive it
    # (they are the SLOs); span_cursor tiles the decode-round spans so they
    # cover arrival -> finish without gaps
    trace: Any = None
    t_queue_start: float = 0.0
    t_first_prefill: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_span_cursor: Optional[float] = None
    _prefill_cached: int = 0

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    new_token_ids: list
    output_token_ids: list
    finished: bool
    finish_reason: Optional[str] = None
    num_cached_tokens: int = 0


class LLMEngine:
    def __init__(
        self,
        config: EngineConfig,
        params: Optional[llama.Params] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.config = config
        c = config
        self.device = resolve_device(device)
        pick_impl("attn_impl", self.device, c.attn_impl)  # refuse a mismatch now, not mid-step
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = llama.init_params(c.model, gen, self.device, dtype=c.model.dtype)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on {self.device}"
            )
        # serving keeps its weights in the compute dtype (a no-op when they are)
        self.params = llama.cast_params(params, c.model.dtype)
        self.allocator = BlockAllocator(c.num_blocks, c.block_size)
        self.cache = init_cache(
            c.model, c.num_blocks * c.block_size, dtype=c.cache_dtype,
            trash_slots=c.block_size, device=self.device,
        )
        # static KV allocation for the llm_kv_hbm_bytes gauge (metadata only)
        self._kv_cache_nbytes = sum(t.numel() * t.element_size() for t in self.cache.values())
        self._telemetry_next = 0.0  # gauge-refresh throttle (monotonic s)
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.requests: dict[str, Request] = {}  # unfinished only
        self.num_preemptions = 0
        self._counter = itertools.count()
        self._seed = seed ^ 0x5EED
        # the SLO and metric label (llm_ttft_seconds{model=...}); the serving
        # front end sets it to its model_id
        self.model_tag = "engine"
        # the version of the last weight publish applied (train/weight_sync.py):
        # 0 until a subscriber writes new weights; stats() reports it
        self.weight_version = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        # hit tokens by serving tier: hbm resident, host / object resurrected
        self.tier_hit_tokens: dict[str, int] = {}
        self.num_prefill_batches = 0
        self.num_kv_imports = 0
        # mixed ragged batching: prefill cursors (request_id -> next
        # un-prefilled absolute token index; a request in here is RUNNING
        # but mid-prompt) and padding-waste stats. The cursor dict exists
        # unconditionally so preempt/abort never need a mode check.
        self._mixed_prefills: dict[str, int] = {}
        self._mixed_stats = MixedStats() if c.mixed_batch else None
        # pipelined decode: the device-resident batch state, the in-flight
        # chunk, the chunk controller, the captured graphs, and outputs
        # produced by internal flushes (returned by the next step(), so no
        # token or finish event is dropped)
        self._pipe_state = None
        self._pipe_inflight = None
        self._pipe_ctl = None
        self._pipe_stats = None
        self._pipe_last_sync_t = None
        self._pending_outputs: list[RequestOutput] = []
        self._graphs = ChunkGraphs(self.device)
        # the packed programs' graphs per packed-token bucket (the mixed
        # step; the ragged spec verifier), in the decode graphs' pool
        trash = c.num_blocks * c.block_size
        self._mixed_graphs = PackedGraphs(self.device, trash, shared_with=self._graphs)
        self._verify_graphs = PackedGraphs(self.device, trash, shared_with=self._graphs)
        # LoRA stacks: slot 0 is the zero adapter; per target A [L, n_slots,
        # d_model, r] and B [L, n_slots, r, d_out], in the model dtype.
        # Allocated once and written in place, never rebound: captured
        # graphs read them by address
        self._lora: Optional[dict] = None
        self._lora_slots: dict[str, int] = {}
        # lora_id -> tick of its last use (add_lora / add_request): the LRU
        # order of evict_lru_lora
        self._lora_last_used: dict[str, int] = {}
        self._lora_clock = itertools.count()
        # the KV handoff's host<->device copies run on a stream of their own,
        # so they overlap the kernels another engine queues on this device
        self._copy_stream = None
        if c.max_loras > 0:
            m = c.model
            out_dims = {"wq": m.n_heads * m.head_dim, "wk": m.n_kv_heads * m.head_dim,
                        "wv": m.n_kv_heads * m.head_dim}
            n = c.max_loras + 1
            self._lora = {}
            for t in c.lora_targets:
                self._lora[f"{t}_A"] = torch.zeros(
                    (m.n_layers, n, m.d_model, c.lora_rank), dtype=m.dtype, device=self.device)
                self._lora[f"{t}_B"] = torch.zeros(
                    (m.n_layers, n, c.lora_rank, out_dims[t]), dtype=m.dtype, device=self.device)
        # speculative decoding: drafter + stats
        self.drafter = None
        self.spec_stats = None
        if c.spec is not None:
            self.drafter = c.spec.build_drafter(c.model, self.device)
            self.spec_stats = SpecStats()
        # tiered prefix cache: the tier manager listens to the allocator's
        # seal / evict / drop events and runs the spill worker; the fetch
        # manager prefetches a queued request's spilled prefix (and pulls
        # other engines' blocks over the fetch plane once attached)
        self.kvtier = None
        self.kvfetch = None
        if c.kvtier is not None:
            from ray_tpu_torch.llm.kvfetch import KVFetchManager
            from ray_tpu_torch.llm.kvtier import KVTierManager

            self.kvtier = KVTierManager(self, c.kvtier)
            self.kvfetch = KVFetchManager(self)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    @staticmethod
    def _sample_mode(batch) -> str:
        """Sampler fast path for this batch: greedy and plain-temperature
        batches skip the top-k/top-p machinery; a request with top_k >
        TOP_CAP forces the exact full sort. Greedy requests' knobs are
        ignored (top-k/top-p cannot change an argmax)."""
        sampled = [r for r in batch if not r.sampling_params.greedy]
        if not sampled:
            return "greedy"
        if all(
            r.sampling_params.top_k <= 0 and r.sampling_params.top_p >= 1.0
            for r in sampled
        ):
            return "categorical"
        if any(r.sampling_params.needs_full_sort for r in sampled):
            return "full_sort"
        return "full"

    # -- LoRA multiplexing ----------------------------------------------------

    def add_lora(self, lora_id: str, adapters: dict, evict: bool = False) -> None:
        """Load an adapter, ``{target: (A [L, d_model, r], B [L, r, d_out])}``
        for targets among the configured lora_targets (numpy arrays or
        tensors), into the first free slot; requests select it by lora_id.
        With ``evict`` a full slot budget first evicts the least recently
        used adapter that no request holds; without it, or when every
        adapter is held, raises AdapterSlotsExhausted."""
        c = self.config
        if self._lora is None:
            raise ValueError("EngineConfig.max_loras is 0: LoRA disabled")
        if lora_id in self._lora_slots:
            raise ValueError(f"lora {lora_id!r} already loaded")
        # validate everything before evicting or writing
        for t, (A, B) in adapters.items():
            if t not in c.lora_targets:
                raise ValueError(f"adapter target {t!r} not in lora_targets={c.lora_targets}")
            sa, sb = self._lora[f"{t}_A"].shape, self._lora[f"{t}_B"].shape
            want_a, want_b = (sa[0], *sa[2:]), (sb[0], *sb[2:])
            if tuple(A.shape) != want_a or tuple(B.shape) != want_b:
                raise ValueError(
                    f"adapter {t!r} shapes {tuple(A.shape)}/{tuple(B.shape)} != "
                    f"expected {want_a}/{want_b}"
                )
        if len(self._lora_slots) >= c.max_loras:
            if not evict or self.evict_lru_lora() is None:
                raise AdapterSlotsExhausted(f"all {c.max_loras} adapter slots in use")
        used = set(self._lora_slots.values())
        slot = next(i for i in range(1, c.max_loras + 1) if i not in used)
        for t, (A, B) in adapters.items():
            for key, w in ((f"{t}_A", A), (f"{t}_B", B)):
                self._write_slot(self._lora[key][:, slot], w)
        self._lora_slots[lora_id] = slot
        self._lora_last_used[lora_id] = next(self._lora_clock)

    def _write_slot(self, dst: torch.Tensor, w) -> None:
        """Write an adapter's weights into its slot of a stack in place, on
        the stream the decode chunks run on: ordered after any chunk in
        flight, and seen by every captured graph, which reads the stack by
        address."""
        src = (w if torch.is_tensor(w) else torch.from_numpy(np.asarray(w))).to(dst.dtype)
        if src.device.type == "cpu" and dst.device.type == "cuda":
            src = src.pin_memory()  # kept by the caching host allocator until copied
        dst.copy_(src, non_blocking=True)

    def remove_lora(self, lora_id: str) -> None:
        """Unload an adapter: refused while a waiting or running request
        holds its slot; the slot is zeroed (in place, on the chunks' stream)
        and only its own prefix chains are dropped."""
        slot = self._lora_slots.get(lora_id)
        if slot is None:
            raise ValueError(f"unknown lora {lora_id!r}")
        in_flight = [r.request_id for r in list(self.waiting) + self.running
                     if r.lora_slot == slot]
        if in_flight:
            # zeroing the slot mid-generation would switch those sequences
            # to the base model
            raise ValueError(
                f"lora {lora_id!r} is in use by requests {in_flight[:4]}; "
                "abort or drain them first"
            )
        del self._lora_slots[lora_id]
        self._lora_last_used.pop(lora_id, None)
        for stack in self._lora.values():
            stack[:, slot].zero_()
        # cached K/V under this slot would serve the next adapter loaded
        # into it; other adapters' chains stay valid
        self.allocator.drop_prefix_cache(salt=slot)

    def evict_lru_lora(self) -> Optional[str]:
        """Remove the least recently used adapter that no waiting or
        running request holds; returns its lora_id, or None when every
        loaded adapter is held."""
        busy = {r.lora_slot for r in list(self.waiting) + self.running}
        candidates = sorted(
            (lid for lid, slot in self._lora_slots.items() if slot not in busy),
            key=lambda lid: self._lora_last_used.get(lid, -1),
        )
        if not candidates:
            return None
        self.remove_lora(candidates[0])
        return candidates[0]

    # -- weight swap (train/weight_sync.py, fleet/weights.py) -------------------

    def write_params(self, leaves: list) -> None:
        """Write a full set of weights into the engine's own tensors, in
        place: ``leaves`` in ``llama.sorted_leaves`` order, any float dtype
        (each is cast to the engine's in the copy). The tensors are never
        rebound, so every captured graph, which reads them by address,
        replays the new weights. The copies run on the current stream, the
        one the chunks and replays run on, so they are ordered after any
        chunk in flight; call between two steps. Every leaf's count, shape
        and dtype class is checked before the first copy, so a mismatch
        raises with nothing written."""
        dst = llama.sorted_leaves(self.params)
        if len(leaves) != len(dst):
            raise ValueError(f"{len(leaves)} weight leaves for an engine of {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, leaves)):
            if tuple(s.shape) != tuple(d.shape) or s.is_floating_point() != d.is_floating_point():
                raise ValueError(
                    f"weight leaf {i}: {tuple(s.shape)} {s.dtype} does not fit the engine's "
                    f"{tuple(d.shape)} {d.dtype}"
                )
        with torch.no_grad():
            for d, s in zip(dst, leaves):
                d.copy_(s)

    def drop_prefix_cache(self, salt: Optional[int] = None) -> None:
        """Invalidate the prefix cache in every tier: the allocator's reuse
        pool, and through its drop listener the host and object tiers and
        this engine's prefix-index rows. ``salt`` scopes the drop to one
        adapter's chains. The entry point of a weight swap: dropping HBM
        alone would let a deeper tier serve K/V of the old weights."""
        self.allocator.drop_prefix_cache(salt=salt)

    def _lora_slot(self, lora_id) -> int:
        if lora_id is None:
            return 0
        try:
            return self._lora_slots[lora_id]
        except KeyError:
            raise ValueError(f"unknown lora {lora_id!r}; add_lora first") from None

    def _lora_arg(self, ids) -> Optional[dict]:
        """The ``lora=`` argument of a decode program: adapter slots (per
        row or per packed token; host values, or a graph bucket's device
        buffer, taken as it is) and the stacks; None without LoRA."""
        if self._lora is None:
            return None
        if not torch.is_tensor(ids):
            ids = self._tensor(np.asarray(ids, np.int32))
        return {"ids": ids, **self._lora}

    # -- public API -----------------------------------------------------------

    def add_request(
        self,
        prompt_token_ids: list,
        sampling_params: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        lora_id: Optional[str] = None,
        trace: Any = None,
        priority: int = 0,
        tenant: str = "",
        slo_tag: Optional[str] = None,
    ) -> str:
        sp = sampling_params or SamplingParams()
        rid = request_id or f"req-{next(self._counter)}"
        lora_slot = self._lora_slot(lora_id)
        if lora_id is not None:
            self._lora_last_used[lora_id] = next(self._lora_clock)
        if len(prompt_token_ids) > self.config.max_prefill_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} exceeds "
                f"max_prefill_len={self.config.max_prefill_len}"
            )
        # must leave room for >= 1 generated token inside the RoPE tables
        if len(prompt_token_ids) >= self.config.model.max_seq:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} >= model max_seq="
                f"{self.config.model.max_seq}; prompts must be shorter than "
                "the model context window"
            )
        # a prompt the cache can NEVER hold would wedge the queue head
        need = self.allocator.blocks_needed(len(prompt_token_ids) + 1)
        if need > self.config.num_blocks:
            raise ValueError(
                f"prompt needs {need} KV blocks but the cache has only "
                f"{self.config.num_blocks}; raise num_blocks or shorten it"
            )
        req = Request(rid, list(map(int, prompt_token_ids)), sp)
        req.lora_slot = lora_slot
        req.priority = int(priority)
        req.tenant, req.slo_tag = tenant, slo_tag
        # every request is traced: the serving layer's context, the ambient
        # one (the submitter's thread), or a new root
        req.trace = trace or trace_context.current() or trace_context.new_context()
        req.t_queue_start = req.arrival
        req.seed_base = request_seed_base(
            self._seed if sp.seed is None else sp.seed, rid
        )
        self.requests[rid] = req
        self.waiting.append(req)
        if self.kvfetch is not None:
            # verify / fetch the spilled prefix while the request waits
            self.kvfetch.request_admitted(req)
        return rid

    def abort_request(self, request_id: str) -> None:
        req = self.requests.get(request_id)
        if req is None or req.status in (RequestStatus.FINISHED, RequestStatus.ABORTED):
            return
        if self.kvfetch is not None:
            # an abort mid-prefetch releases the reservation and staged chain
            self.kvfetch.cancel(request_id)
        if req in self.running:
            # removing a decode-batch row is a membership change: land the
            # in-flight chunk first (its outputs go out with the next
            # step()); the flush may finish this request normally
            self._pipe_flush(deliver=True)
            if req.status in (RequestStatus.FINISHED, RequestStatus.ABORTED):
                return
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        self._mixed_prefills.pop(request_id, None)
        if req.seq is not None:
            req.seq.release()
        req.status = RequestStatus.ABORTED
        req.finish_reason = "abort"
        now = time.time()
        self._obs_span(
            req, "llm.request", req.arrival, now,
            {"request_id": req.request_id, "finish_reason": "abort",
             "prompt_tokens": len(req.prompt_token_ids),
             "output_tokens": len(req.output_token_ids),
             "e2e_s": round(max(0.0, now - req.arrival), 6)},
        )
        self._obs_series(
            slo.record_request_slo, self.model_tag, ttft_s=None, tpot_s=None,
            queue_wait_s=None, e2e_s=max(0.0, now - req.arrival), finish_reason="abort",
        )
        self.requests.pop(request_id, None)
        if self.drafter is not None:
            self.drafter.release(request_id)

    def has_unfinished(self) -> bool:
        # pending flush outputs count: an abort's flush may have finished
        # the last running request, whose finish event still needs a step()
        return bool(self.waiting or self.running or self._pending_outputs)

    def step(self) -> list[RequestOutput]:
        """One engine iteration: admit + prefill waiting requests, else
        decode (or, with mixed batching, one mixed dispatch)."""
        if _chaos.ACTIVE is not None:
            for f in _chaos.fire(
                "llm.engine.step",
                kinds=(_chaos.PREEMPT_ENGINE, _chaos.KILL_WORKER, _chaos.DELAY_RPC),
                running=len(self.running), waiting=len(self.waiting),
            ):
                if f.kind in (_chaos.PREEMPT_ENGINE, _chaos.KILL_WORKER):
                    # the engine dies before mutating this round's state; its
                    # owner (the serving runner) recovers through recover()
                    raise EnginePreempted("chaos: engine preempted mid-step")
                if f.kind == _chaos.DELAY_RPC:
                    # a deterministic slowdown: overload builds real queue depth
                    time.sleep(f.delay_s)
        now_m = time.monotonic()
        if now_m >= self._telemetry_next:
            # throttled gauge refresh: a few dict writes per 0.2 s, not per step
            self._telemetry_next = now_m + 0.2
            self.update_telemetry_gauges()
        if self._pending_outputs:
            # outputs of an internal pipeline flush (abort) go out first
            out, self._pending_outputs = self._pending_outputs, []
            return out
        if self.kvfetch is not None:
            # land completed prefetches before admission: the scatter holds
            # reservation refs, so the head's prefix matches as resident
            self.kvfetch.tick()
        if self.waiting:
            # QoS admission order: the highest-priority waiting request
            # first (strictly FIFO when priorities are uniform)
            self._promote_priority()
            head = self.waiting[0]
            if head.priority > 0 and self.running and (
                len(self.running) >= self.config.max_num_seqs
                or self._admission_need(head) > self.allocator.num_free
            ):
                # priority preemption: a request blocked on batch-slot or
                # KV pressure displaces the lowest-priority running one,
                # which recomputes later
                victim = min(self.running, key=lambda r: (r.priority, -r.arrival))
                if victim.priority < head.priority:
                    flushed = self._pipe_flush()
                    if flushed:
                        return flushed
                    self._preempt_one(below_priority=head.priority, reason="priority")
                    self._promote_priority()
        if self.config.mixed_batch:
            return self._mixed_step()
        if (
            self.waiting
            and len(self.running) < self.config.max_num_seqs
            # read-only precheck: free blocks must cover the head's prompt
            # minus live-shared prefix-cache hits
            and self._admission_need(self.waiting[0]) <= self.allocator.num_free
        ):
            # admission is a membership change: the in-flight chunk
            # (dispatched for the old batch) lands first
            flushed = self._pipe_flush()
            if flushed:
                return flushed
            admitted: list = []  # (req, last-token logits [1, V]) pairs
            while self.waiting and len(self.running) < self.config.max_num_seqs:
                got = self._prefill_one()
                if got is None:
                    break  # no cache room: decode to free blocks
                admitted.append(got)
            if admitted:
                reqs = [r for r, _ in admitted]
                logits = torch.cat([lg for _, lg in admitted], dim=0)
                tok, logprob = self._sample_batch(logits, reqs)
                t1 = time.time()  # after the sampler's host sync: first tokens exist
                outputs = self._append_tokens(reqs, tok, logprob)
                self._obs_prefilled(reqs, t1)
                return outputs
        if self.running:
            return self._decode_step()
        return []

    def recover(self, *, rebuild_kv: bool = False) -> list[str]:
        """Crash/preemption recovery: push every RUNNING request back to the
        head of the waiting queue with its generated prefix intact.

        Re-admission prefills ``prompt + output_token_ids`` (the
        preemption-recompute contract), so nothing generated is lost and
        nothing re-emits. ``rebuild_kv=True`` also discards the allocator
        (and with it the prefix cache) and zeroes the KV cache, trash page
        included, IN PLACE: every captured graph of the three families
        reads the cache tensors by address, so a new cache would leave each
        later replay writing to a dead one. The LoRA stacks stay.

        Returns the re-enqueued request ids."""
        # the in-flight pipelined chunk may be what crashed: drop it
        # un-synced (its tokens were never booked)
        self._pipe_drop()
        # mid-prefill mixed cursors die with the batch: re-admission
        # recomputes each prompt from its cached prefix
        self._mixed_prefills.clear()
        now = time.time()
        victims = sorted(self.running, key=lambda r: r.arrival, reverse=True)
        self.running.clear()
        # orphan sweep: a crash inside admission (after waiting.popleft,
        # before running.append) leaves a live request in neither queue
        queued = {r.request_id for r in victims} | {r.request_id for r in self.waiting}
        victims += [
            r for r in self.requests.values()
            if r.request_id not in queued
            and r.status in (RequestStatus.WAITING, RequestStatus.RUNNING)
        ]
        if self.kvfetch is not None:
            # staged chains and reservations may reference the crashed
            # state; with rebuild_kv their block ids die with the allocator
            self.kvfetch.reset(forget_blocks=rebuild_kv)
        if rebuild_kv:
            c = self.config
            self.allocator = BlockAllocator(c.num_blocks, c.block_size)
            for t in self.cache.values():
                t.zero_()
            if self.kvtier is not None:
                # the new allocator's listeners; spilled copies stay usable
                self.kvtier.rebind_allocator()
            for r in victims:
                r.seq = None  # blocks died with the old allocator
        moved = []
        for r in victims:
            if r.seq is not None:
                r.seq.release()
            r.seq = None
            r.status = RequestStatus.WAITING
            r.num_preemptions += 1
            self.num_preemptions += 1
            self._count_preemption(r, "recover")
            r.t_queue_start = now
            r.t_span_cursor = None
            self.waiting.appendleft(r)  # reversed arrival: the oldest ends up first
            if self.drafter is not None:
                self.drafter.release(r.request_id)
            self._obs_span(r, "engine.recover", now, now,
                           {"rebuild_kv": rebuild_kv,
                            "output_tokens": len(r.output_token_ids)})
            moved.append(r.request_id)
        return moved

    def generate(
        self,
        prompts: list,
        sampling_params: "SamplingParams | list[SamplingParams] | None" = None,
    ) -> list:
        """Blocking batch generation; returns output token lists in order."""
        if sampling_params is None or isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params or SamplingParams()] * len(prompts)
        rids = [
            self.add_request(p, sp) for p, sp in zip(prompts, sampling_params)
        ]
        finals: dict[str, list] = {}
        while self.has_unfinished():
            for out in self.step():
                if out.finished:
                    finals[out.request_id] = out.output_token_ids
        return [finals[r] for r in rids]

    def update_telemetry_gauges(self) -> None:
        """Refresh this engine's utilization gauges (KV-page occupancy, KV
        bytes, queue depth, running requests) and the tiered cache's
        (resident bytes, spill queue) from host state, and publish the
        prefix-index snapshot on the same throttle. Called throttled from
        step(); never raises into serving."""
        try:
            g = utilization_gauges()
            tags = {"model": self.model_tag}
            c = self.config
            g["kv_pages_used"].set(c.num_blocks - self.allocator.num_free, tags=tags)
            g["kv_pages_total"].set(c.num_blocks, tags=tags)
            g["kv_hbm_bytes"].set(self._kv_cache_nbytes, tags=tags)
            g["queue_depth"].set(len(self.waiting), tags=tags)
            g["running"].set(len(self.running), tags=tags)
            if self.kvtier is not None:
                self.kvtier.update_gauges()
                self.kvtier.flush_index()
        except Exception:  # noqa: BLE001 — observability must not break serving
            pass

    def stats(self) -> dict:
        out = {
            "num_waiting": len(self.waiting),
            "num_running": len(self.running),
            "free_blocks": self.allocator.num_free,
            "total_blocks": self.config.num_blocks,
            "num_prefill_batches": self.num_prefill_batches,
            "num_preemptions": self.num_preemptions,
            "weight_version": self.weight_version,
            "prefix_cache": {
                "hit_tokens": self.prefix_hit_tokens,
                "lookup_tokens": self.prefix_lookup_tokens,
                "hit_rate": (
                    round(self.prefix_hit_tokens / self.prefix_lookup_tokens, 4)
                    if self.prefix_lookup_tokens else 0.0
                ),
                "by_tier": dict(self.tier_hit_tokens),
            },
        }
        if self.kvtier is not None:
            # the tier breakdown, with the prefetch / fetch rollup
            out["kv_tiers"] = self.kvtier.stats()
            out["kv_tiers"]["fetch"] = self.kvfetch.stats()
        if self.num_kv_imports:
            out["num_kv_imports"] = self.num_kv_imports
        if self.spec_stats is not None:
            # verify_graphs: the ragged verify passes (mixed batching), as
            # graph replays on the card ("replays") or eager on the CPU
            out["spec"] = {**self.spec_stats.to_dict(),
                           "verify_graphs": self._verify_graphs.stats()}
        if self._pipe_stats is not None and self._pipe_stats.dispatches:
            # chunk sizes, host/device split, overlap ratio, steps run
            # after every row was done, and the captured graphs
            out["pipeline"] = {**self._pipe_stats.to_dict(), "graphs": self._graphs.stats()}
        if self._mixed_stats is not None and self._mixed_stats.dispatches:
            out["mixed"] = {**self._mixed_stats.to_dict(), "graphs": self._mixed_graphs.stats()}
        return out

    # -- disaggregated prefill/decode (llm/disagg) -----------------------------
    # A prefill engine runs admission, prefill and the first token, then
    # EXPORTS the sequence (KV pages + request state) instead of decoding
    # it; a decode engine IMPORTS it with zero recompute. The invariant both
    # sides rely on: a request of num_tokens N has K/V written for positions
    # 0..N-2 (the newest token is fed, and its K/V written, by the next step).

    def peek_prefix_tokens(self, prompt_token_ids: list, lora_id: Optional[str] = None) -> int:
        """Read-only probe: prompt tokens a prefix-cache hit would cover on
        this engine (the disaggregated decode pick's tiebreak)."""
        return self.allocator.probe_prefix(
            list(map(int, prompt_token_ids)), self._lora_slot(lora_id)
        )

    def peek_prefix_tiered(self, prompt_token_ids: list, lora_id: Optional[str] = None) -> dict:
        """Read-only tiered probe: the longest contiguous prefix this engine
        can serve without recompute across every tier (HBM resident, host
        and object resurrectable), with the tier-discounted score the
        prefix-aware picks rank engines by. Returns {"n_tokens",
        "discounted", "by_tier"}."""
        tokens = list(map(int, prompt_token_ids))
        salt = self._lora_slot(lora_id)
        if self.kvtier is not None:
            return self.kvtier.probe_tiers(tokens, salt)
        n = self.allocator.probe_prefix(tokens, salt)
        return {"n_tokens": n, "discounted": float(n), "by_tier": ({"hbm": n} if n else {})}

    def close(self) -> None:
        """Stop the tiered cache's spill and prefetch workers (bounded
        joins); the engine stays usable, spilling inline from then on."""
        if self.kvfetch is not None:
            self.kvfetch.close()
        if self.kvtier is not None:
            self.kvtier.stop()

    def release(self) -> None:
        """Free the engine's device memory once nothing steps it any more
        (its serving loop has stopped): the tiered cache's workers, the
        paged KV cache, every captured graph with its pool and buffers, and
        the pipelined batch state. The weights stay: they are the caller's.
        The engine cannot step afterwards."""
        self.close()
        self.cache = None
        for fam in (self._graphs, self._mixed_graphs, self._verify_graphs):
            fam.release()
        self._pipe_state = self._pipe_inflight = None
        self._copy_stream = None

    def _copies(self) -> "torch.cuda.Stream":
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def kv_cache_device(self) -> torch.device:
        """The device this engine's paged KV cache lives on: the fabric
        endpoint of device-direct imports (registering the cache's own
        device makes the transfer's final hop a no-op)."""
        return self.cache["k"].device

    def export_request(self, request_id: str, keep_on_device: bool = False):
        """Export a RUNNING request as a sealed KVHandoff and drop local
        ownership: its blocks are released (full prompt blocks stay in this
        engine's prefix cache, so a re-prefill after a lost transfer hits
        them). The pages are gathered on the device in one index_select per
        cache tensor, on the current stream. On the card they are copied
        into pinned host memory on the engine's copy stream and CRC-sealed;
        with ``keep_on_device`` they stay device tensors, sealed on the
        device (``seal(device=True)``: two reductions and two 4-byte reads,
        no pinned pages, no copy to the host; ``handoff.to_host()`` if an
        RPC edge carries it after all). The handoff's ``timings`` split the
        export into pin (allocating the host pages), gather, d2h and seal
        (on the CPU, or on the device path: gather and seal)."""
        # the pages must hold every position the host has booked: land the
        # pipelined chunk in flight first
        self._pipe_flush(deliver=True)
        from ray_tpu_torch.llm.disagg.handoff import KVHandoff

        req = self.requests.get(request_id)
        if req is None or req.status != RequestStatus.RUNNING or req.seq is None:
            raise ValueError(
                f"request {request_id!r} is not RUNNING on this engine "
                "(only admitted, in-flight requests can be exported)"
            )
        if request_id in self._mixed_prefills:
            # mid-prompt mixed row: K/V exists only up to its cursor, not the
            # num_tokens - 1 positions the handoff promises
            raise ValueError(
                f"request {request_id!r} is mid-prefill in a mixed batch; "
                "export after its prompt chunks complete"
            )
        c = self.config
        n_kv = req.num_tokens - 1
        slots = self._tensor(np.asarray(req.seq.slots_for_range(0, n_kv), np.int64))
        stage_host = self.device.type == "cuda" and not keep_on_device
        timings = {}
        if stage_host:
            t0 = time.perf_counter()
            shape = (c.model.n_layers, c.model.n_kv_heads, n_kv, c.model.head_dim)
            hk = torch.empty(shape, dtype=self.cache["k"].dtype, pin_memory=True)
            hv = torch.empty(shape, dtype=self.cache["v"].dtype, pin_memory=True)
            timings["pin_ms"] = (time.perf_counter() - t0) * 1e3
        stages = _Stages(self.device)
        s0 = stages.start()
        k = self.cache["k"].index_select(2, slots)
        v = self.cache["v"].index_select(2, slots)
        stages.stage("gather_ms", s0)
        if stage_host:
            cs = self._copies()
            cs.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(cs):
                s0 = stages.start()
                hk.copy_(k, non_blocking=True)
                hv.copy_(v, non_blocking=True)
                stages.stage("d2h_ms", s0)
            k.record_stream(cs)
            v.record_stream(cs)
            k, v = hk, hv
        timings.update(stages.done())
        lora_id = None
        if req.lora_slot:
            lora_id = next((lid for lid, s in self._lora_slots.items() if s == req.lora_slot),
                           None)
        handoff = KVHandoff(
            request_id=req.request_id,
            prompt_token_ids=list(req.prompt_token_ids),
            output_token_ids=list(req.output_token_ids),
            sampling_params=req.sampling_params,
            seed_base=req.seed_base,
            num_kv_tokens=n_kv,
            k_pages=k,
            v_pages=v,
            model_sig=(c.model.n_layers, c.model.n_kv_heads, c.model.head_dim),
            lora_id=lora_id,
            cumulative_logprob=req.cumulative_logprob,
            token_logprobs=list(req.token_logprobs),
            t_arrival=req.arrival,
            t_first_prefill=req.t_first_prefill,
            t_first_token=req.t_first_token,
            # the llm.kv_transfer span starts where the prefill span ended,
            # so the request's spans stay gap-free across the hop
            t_export=req.t_span_cursor if req.t_span_cursor is not None else time.time(),
            trace=req.trace.to_dict() if isinstance(req.trace, trace_context.TraceContext)
            else None,
        )
        t0 = time.perf_counter()
        handoff.seal(device=keep_on_device)
        timings["seal_ms"] = (time.perf_counter() - t0) * 1e3
        handoff.timings = timings
        # drop local ownership; sealed full blocks stay in the prefix cache
        self.running.remove(req)
        req.seq.release()
        req.seq = None
        req.status = RequestStatus.MIGRATED
        self.requests.pop(request_id, None)
        if self.drafter is not None:
            self.drafter.release(request_id)
        return handoff

    def import_handoff(self, handoff, trace: Any = None) -> str:
        """Adopt an exported request: write its KV pages into this engine's
        cache and enqueue it RUNNING, with no prefill and no recompute
        (``num_cached_tokens`` covers every transferred position). Raises
        NoFreeBlocksError, before writing anything, when the cache cannot
        hold it now, and ValueError on a model mismatch, a request id
        already live here, or pages that disagree with the header.

        Host pages are copied to the device on the engine's copy stream;
        pages already on the cache's device (the fabric's device handoff,
        verified on the device where it was received) are used as they are,
        with no copy. Either way they are scattered with index_copy_ into
        the cache tensors IN PLACE, on the current stream (the one the graph
        replays run on): every captured decode, mixed and verify graph reads
        the cache by address, so it is never rebound. Adds h2d (host pages
        on the card) and scatter to the handoff's ``timings``."""
        # joining the decode batch is a membership change: land the chunk in
        # flight so the import sees settled state
        self._pipe_flush(deliver=True)
        c = self.config
        m = c.model
        sig = (m.n_layers, m.n_kv_heads, m.head_dim)
        if tuple(handoff.model_sig) != sig:
            raise ValueError(
                f"handoff model signature {tuple(handoff.model_sig)} != engine {sig}; "
                "prefill and decode pools must serve the same model"
            )
        rid = handoff.request_id
        if rid in self.requests:
            raise ValueError(f"request {rid!r} already live on this engine")
        n_kv = handoff.num_kv_tokens
        want = (m.n_layers, m.n_kv_heads, n_kv, m.head_dim)
        if tuple(handoff.k_pages.shape) != want or tuple(handoff.v_pages.shape) != want:
            raise ValueError(
                f"handoff KV pages {tuple(handoff.k_pages.shape)} / "
                f"{tuple(handoff.v_pages.shape)} disagree with the header's {n_kv} tokens "
                f"(expected {want})"
            )
        req = Request(rid, list(map(int, handoff.prompt_token_ids)), handoff.sampling_params)
        req.lora_slot = self._lora_slot(handoff.lora_id)
        req.output_token_ids = list(map(int, handoff.output_token_ids))
        req.cumulative_logprob = handoff.cumulative_logprob
        req.token_logprobs = list(handoff.token_logprobs)
        req.seed_base = int(handoff.seed_base)
        req.trace = (trace or trace_context.TraceContext.from_dict(handoff.trace)
                     or trace_context.new_context())
        req.arrival = handoff.t_arrival
        req.t_queue_start = handoff.t_arrival
        req.t_first_prefill = handoff.t_first_prefill
        req.t_first_token = handoff.t_first_token

        seq = SequenceBlocks(self.allocator)
        seq.chain = req.lora_slot  # salt the hash chain as admission does
        seq.ensure_capacity(req.num_tokens)  # may raise NoFreeBlocksError
        slots = self._tensor(np.asarray(seq.slots_for_range(0, n_kv), np.int64))
        dt = self.cache["k"].dtype
        stages = _Stages(self.device)
        if self.device.type == "cuda" and handoff.k_pages.device == self.device:
            # a device handoff: its seal's 4-byte read completed the writes
            # of the pages before they were sent. Recording this stream on
            # them keeps the allocator from handing their block to the
            # stream that made them while the scatter below still reads it
            cur = torch.cuda.current_stream(self.device)
            k, v = handoff.k_pages.to(dt), handoff.v_pages.to(dt)
            k.record_stream(cur)
            v.record_stream(cur)
        elif self.device.type == "cuda":
            cur, cs = torch.cuda.current_stream(self.device), self._copies()
            with torch.cuda.stream(cs):
                s0 = stages.start()
                k = handoff.k_pages.to(device=self.device, dtype=dt, non_blocking=True)
                v = handoff.v_pages.to(device=self.device, dtype=dt, non_blocking=True)
                stages.stage("h2d_ms", s0)
            cur.wait_stream(cs)
            k.record_stream(cur)
            v.record_stream(cur)
        else:
            k, v = handoff.k_pages.to(dt), handoff.v_pages.to(dt)
        s0 = stages.start()
        self.cache["k"].index_copy_(2, slots, k)
        self.cache["v"].index_copy_(2, slots, v)
        stages.stage("scatter_ms", s0)
        handoff.timings.update(stages.done())
        seq.num_tokens = req.num_tokens
        seq.num_cached_tokens = n_kv  # every transferred position: zero recompute
        if c.enable_prefix_caching:
            # imported full blocks serve later prompts sharing this prefix
            seq.seal_full_blocks(req.prompt_token_ids + req.output_token_ids[:-1])
        req.seq = seq
        req.status = RequestStatus.RUNNING
        self.requests[rid] = req
        self.running.append(req)
        self.num_kv_imports += 1
        req.t_span_cursor = time.time()  # decode rounds tile from the import
        return rid

    # -- admission -------------------------------------------------------------

    def _admission_need(self, req) -> int:
        """Free-pool blocks admitting ``req`` would consume (its prefix
        chains salted by its adapter slot)."""
        if not self.config.enable_prefix_caching:
            return self.allocator.blocks_needed(req.num_tokens)
        return self.allocator.probe_admission_need(
            req.prompt_token_ids + req.output_token_ids, req.lora_slot
        )

    def _pad_to_bucket(self, n: int, buckets: list) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _admit_one(self):
        """Admit the head of the waiting queue: prefix match, capacity
        reservation for the FULL recompute prompt, hit accounting —
        everything up to (not including) dispatch. Returns
        (req, seq, prompt, matched), or None when the cache has no room."""
        c = self.config
        req = self.waiting[0]
        seq = SequenceBlocks(self.allocator)
        # after a preemption the recompute covers prompt + generated tokens
        prompt = req.prompt_token_ids + req.output_token_ids
        matched_blocks: list = []
        matched = 0
        # adapters change K/V: the prefix chain is salted by the adapter
        # slot, so sequences under different adapters never share blocks
        # (a preemption recompute keeps its request's salt)
        salt = req.lora_slot
        seq.chain = salt
        tier_counts: dict[str, int] = {}
        if c.enable_prefix_caching:
            blocks, matched, chain = self.allocator.match_prefix(prompt, salt)
            if matched >= len(prompt):
                # whole prompt cached: leave >= 1 token to prefill so there
                # are next-token logits
                self.allocator.free(blocks)
                blocks, matched, chain = self.allocator.match_prefix(prompt[:-1], salt)
            if matched:
                tier_counts["hbm"] = matched
            if self.kvtier is not None:
                # blocks past the HBM match may be spilled: scatter them back
                # (verified) and extend the match
                rblocks, rtokens, chain, rcounts = self._resurrect_tiers(
                    prompt, matched, chain, salt
                )
                if rblocks:
                    blocks = list(blocks) + rblocks
                    matched += rtokens
                    for t, n in rcounts.items():
                        tier_counts[t] = tier_counts.get(t, 0) + n
            if blocks:
                seq.adopt_prefix(blocks, chain, matched)
                matched_blocks = blocks
        try:
            seq.ensure_capacity(len(prompt))
        except NoFreeBlocksError:
            if matched_blocks:
                seq.release()
            return None  # no room: fall through to decode; retry later
        self.waiting.popleft()
        self.num_prefill_batches += 1
        if self.kvfetch is not None and matched:
            # blocks the prefetch tick scattered match as HBM residents:
            # attribute their hits to the tier they were pulled from (taken
            # past the commit point, so a failed admission keeps it)
            for t, n in self.kvfetch.take_attribution(req.request_id).items():
                move = min(n, tier_counts.get("hbm", 0))
                if move <= 0:
                    continue
                tier_counts["hbm"] -= move
                tier_counts[t] = tier_counts.get(t, 0) + move
            if tier_counts.get("hbm") == 0:
                tier_counts.pop("hbm", None)
        # hit accounting over the ORIGINAL prompt only: a preemption
        # recompute re-matching its own sealed blocks is not a hit
        if req.num_preemptions == 0:
            self.prefix_lookup_tokens += len(req.prompt_token_ids)
            self.prefix_hit_tokens += min(matched, len(req.prompt_token_ids))
            for t, n in tier_counts.items():
                self.tier_hit_tokens[t] = self.tier_hit_tokens.get(t, 0) + n
            self._obs_series(record_prefix_lookup, self.model_tag,
                             len(req.prompt_token_ids), tier_counts)
        t_admit = time.time()
        self._obs_span(req, "engine.queue_wait", req.t_queue_start, t_admit,
                       {"recompute": req.num_preemptions > 0})
        req.t_prefill_start = t_admit
        if req.t_first_prefill is None:
            req.t_first_prefill = t_admit
        req._prefill_cached = matched
        return req, seq, prompt, matched

    def _prefill_one(self):
        """Prefill the head of the waiting queue (no host sync). Returns
        (req, last-token logits [1, V]) or None when the cache has no room."""
        got = self._admit_one()
        if got is None:
            return None
        req, seq, prompt, matched = got
        c = self.config
        num_slots = c.num_blocks * c.block_size
        bt = np.zeros((1, self._bt_width([len(seq.blocks)])), np.int32)
        bt[0, : len(seq.blocks)] = seq.blocks
        bt = self._tensor(bt)
        # chunked prefill: a preemption recompute can exceed max_prefill_len;
        # each chunk extends context_lens, only the last chunk's logits count
        logits = None
        for start in range(matched, len(prompt), c.max_prefill_len):
            chunk = prompt[start : start + c.max_prefill_len]
            S_pad = self._pad_to_bucket(len(chunk), c.prefill_buckets())
            tokens = np.zeros((1, S_pad), np.int32)
            tokens[0, : len(chunk)] = chunk
            positions = np.zeros((1, S_pad), np.int32)
            positions[0, : len(chunk)] = np.arange(start, start + len(chunk))
            slots = np.full((1, S_pad), num_slots, np.int32)  # trash by default
            slots[0, : len(chunk)] = seq.slots_for_range(start, start + len(chunk))
            logits, self.cache = prefill(
                self.params, self._tensor(tokens), self._tensor(positions),
                self._tensor([len(chunk)]), self._tensor(slots), bt,
                self._tensor(np.asarray([start + len(chunk)], np.int32)),
                self.cache, c.model, block_size=c.block_size,
                lora=self._lora_arg([req.lora_slot]),
            )
        seq.num_tokens = len(prompt)
        if c.enable_prefix_caching:
            seq.seal_full_blocks(prompt)
        req.seq = seq
        req.status = RequestStatus.RUNNING
        self.running.append(req)
        if self.kvfetch is not None:
            self.kvfetch.consumed(req.request_id)  # the sequence holds its own refs
        return req, logits

    def _resurrect_tiers(self, prompt: list, matched: int, chain: int, salt: int) -> tuple:
        """Pull spilled full blocks past the HBM match back into the cache:
        walk the prompt's chain hashes from ``chain``, take each verified
        block from the deep tiers (adopting blocks still resident past a
        spilled head by refcount), and scatter the deep ones in one
        ``_scatter_block_pages``. A corrupt entry or a miss stops the walk;
        allocation pressure aborts it. Returns (blocks, n_tokens, chain,
        {tier: tokens})."""
        mgr = self.kvtier
        bs = self.config.block_size
        # >= 1 token stays uncached so the prefill yields next-token logits
        limit = (len(prompt) - 1) // bs
        start = matched // bs
        entries: list = []  # (hash, tier | "hbm", SpilledBlock | block id)
        h = chain
        for i in range(start, limit):
            blk = tuple(prompt[i * bs:(i + 1) * bs])
            h2 = self.allocator.chain_hash(h, blk)
            got = mgr.take_verified(h2, blk)
            if got is None:
                # head-first eviction leaves later blocks resident past a
                # spilled head: adopt them instead of recomputing
                b = self.allocator.lookup(h2)
                if b is None:
                    break
                entries.append((h2, "hbm", b))
            else:
                entries.append((h2, got[0], got[1]))
            h = h2
        deep = [e for e in entries if e[1] != "hbm"]
        if not deep:
            # resident blocks adopted past a gap only ride a deep block
            if entries:
                self.allocator.free([b for _h, _t, b in entries])
            return [], 0, chain, {}
        try:
            new_blocks = self.allocator.allocate(len(deep))
        except NoFreeBlocksError:
            # the deep entries stay spilled; adopted refs go back
            self.allocator.free([b for _h, t, b in entries if t == "hbm"])
            return [], 0, chain, {}
        # the scatter changes cache membership: land a chunk in flight first
        self._pipe_flush(deliver=True)
        self._scatter_block_pages([sb for _h, _t, sb in deep], new_blocks)
        tier_counts: dict[str, int] = {}
        blocks: list = []
        it_new = iter(new_blocks)
        parent = chain
        for idx, (h2, tier, payload) in enumerate(entries):
            if tier == "hbm":
                blocks.append(payload)  # adopted resident block, ref held
            else:
                b = next(it_new)
                self.allocator.register_full_block(
                    b, h2, parent_hash=parent, tokens=payload.tokens,
                    n_prefix_tokens=(start + idx + 1) * bs,
                )
                mgr.promoted(h2, tier)
                blocks.append(b)
            tier_counts[tier] = tier_counts.get(tier, 0) + bs
            parent = h2
        for tier, n in tier_counts.items():
            if tier != "hbm":  # adopted residents are hits, not resurrections
                mgr.count_resurrected(tier, n)
        return blocks, len(entries) * bs, parent, tier_counts

    def _scatter_block_pages(self, spilled: list, blocks: list) -> None:
        """Write spilled blocks' pages into whole cache ``blocks``: on the
        card each block's K and V are copied host -> device on the engine's
        copy stream (from pinned slab slots when the host tier held them),
        the current stream waits for the copies, then one ``index_copy_``
        per cache tensor scatters them IN PLACE, as ``import_handoff`` does,
        so graphs captured before read them. The one recipe admission and
        the prefetch tick share. h2d and scatter times go to the tier
        manager, read once complete (the engine thread never waits)."""
        m = self.config.model
        bs = self.config.block_size
        n = len(blocks)
        L, KVH, D = m.n_layers, m.n_kv_heads, m.head_dim
        slots = self._tensor(np.concatenate(
            [np.arange(b * bs, (b + 1) * bs, dtype=np.int64) for b in blocks]))
        dt = self.cache["k"].dtype
        mgr = self.kvtier
        if self.device.type == "cuda":
            cur, cs = torch.cuda.current_stream(self.device), self._copies()
            with torch.cuda.stream(cs):
                a = mgr.mark()
                dev = torch.empty((n, 2, L, KVH, bs, D), dtype=dt, device=self.device)
                for i, sb in enumerate(spilled):
                    dev[i, 0].copy_(sb.handoff.k_pages, non_blocking=True)
                    dev[i, 1].copy_(sb.handoff.v_pages, non_blocking=True)
                b = mgr.mark()
            cur.wait_stream(cs)
            dev.record_stream(cur)
        else:
            a = mgr.mark()
            dev = torch.stack([torch.stack((sb.handoff.k_pages, sb.handoff.v_pages))
                               for sb in spilled]).to(dt)
            b = mgr.mark()
        mgr.note_span("h2d", a, b, n)
        a = mgr.mark()
        for j, name in enumerate(("k", "v")):
            src = dev[:, j].permute(1, 2, 0, 3, 4).reshape(L, KVH, n * bs, D)
            self.cache[name].index_copy_(2, slots, src)
        b = mgr.mark()
        mgr.note_span("scatter", a, b, n)

    # -- mixed ragged batching -------------------------------------------------

    def _mixed_admit(self):
        """Admit the queue head WITHOUT dispatching its prompt: the mixed
        dispatch feeds it chunk by chunk from the cursor this records."""
        got = self._admit_one()
        if got is None:
            return None
        req, seq, prompt, matched = got
        # seq.num_tokens tracks positions with K/V WRITTEN: the matched
        # prefix until chunks land
        seq.num_tokens = matched
        req.seq = seq
        req.status = RequestStatus.RUNNING
        self.running.append(req)
        self._mixed_prefills[req.request_id] = matched
        if self.kvfetch is not None:
            self.kvfetch.consumed(req.request_id)
        return req

    def _mixed_step(self) -> list[RequestOutput]:
        """One mixed-batch iteration: admit waiting requests, then serve
        every in-flight prefill chunk plus every decode row in ONE ragged
        dispatch. Steps with no prefill work take the regular decode path."""
        c = self.config
        if (
            self.waiting
            and len(self.running) < c.max_num_seqs
            and self._admission_need(self.waiting[0]) <= self.allocator.num_free
        ):
            # admission is a membership change for the pipelined carry
            flushed = self._pipe_flush()
            if flushed:
                return flushed
            while self.waiting and len(self.running) < c.max_num_seqs:
                if self._mixed_admit() is None:
                    break  # no cache room: decode to free blocks
        if not self._mixed_prefills:
            return self._decode_step() if self.running else []
        # prefill chunks in flight: the mixed dispatch replaces the decode
        # round this step, so the pipelined carry lands first
        flushed = self._pipe_flush()
        if flushed:
            return flushed
        wall0 = time.time()
        # KV for this step's writes: mid-prompt rows reserved their full
        # recompute prompt at admission; decode rows grow one position
        while True:
            try:
                for r in self.running:
                    if r.request_id not in self._mixed_prefills:
                        r.seq.ensure_capacity(r.num_tokens + 1)
                break
            except NoFreeBlocksError:
                if not self._preempt_one():
                    raise  # single running request can't fit: cache too small
        plan = MixedBatchPlan.build(self)
        bufs = self._mixed_graphs.buffers("mixed", *plan.bucket, lora=self._lora is not None)
        plan.fill(bufs)
        # logits [B_pad, V] in the graph's pool: sampled below, before the
        # bucket replays again
        logits = self._mixed_graphs.run(self._mixed_program, bufs)
        plan.note(self._mixed_stats)

        # advance prefill cursors; a finishing prompt seals its full blocks
        # and becomes a decode row
        done_set = set(plan.completes)
        prompt_done: list = []
        for row in range(plan.B):
            if plan.kinds[row] != "prefill":
                continue
            r = plan.reqs[row]
            end = plan.starts[row] + plan.chunk_lens[row]
            r.seq.num_tokens = end
            if row in done_set:
                if c.enable_prefix_caching:
                    r.seq.seal_full_blocks(r.prompt_token_ids + r.output_token_ids)
                del self._mixed_prefills[r.request_id]
                prompt_done.append(r)
            else:
                self._mixed_prefills[r.request_id] = end

        if not plan.emit_rows:
            return []
        emit_reqs = [plan.reqs[i] for i in plan.emit_rows]
        tok, logprob = self._sample_batch(
            logits[self._tensor(np.asarray(plan.emit_rows, np.int64))], emit_reqs
        )
        t1 = time.time()  # after the sampler's host sync
        outputs = self._append_tokens(emit_reqs, tok, logprob)
        self._obs_prefilled(prompt_done, t1, mixed=True)
        dec = [j for j, i in enumerate(plan.emit_rows) if plan.kinds[i] == "decode"]
        if dec:
            self._obs_decode_round([emit_reqs[j] for j in dec], [outputs[j] for j in dec],
                                   wall0, "engine.mixed_round", 1)
        return outputs

    def _mixed_program(self, bufs) -> torch.Tensor:
        """One mixed step on a bucket's static buffers -> logits [B_pad, V]
        (what ``PackedGraphs`` captures and replays)."""
        c = self.config
        logits, self.cache = mixed_step(
            self.params, bufs.tokens, bufs.positions, bufs.slots, bufs.block_tables,
            bufs.cu_q_lens, bufs.context_lens, self.cache, c.model, block_size=c.block_size,
            max_q_len=c.mixed_prefill_chunk, attn_impl=c.attn_impl,
            lora=self._lora_arg(bufs.lora_ids),
        )
        return logits

    def _verify_program(self, bufs) -> torch.Tensor:
        """One ragged verify pass on a bucket's static buffers -> logits
        [B_pad, K+1, V] (what ``PackedGraphs`` captures and replays)."""
        c = self.config
        logits, self.cache = verify_tokens_ragged(
            self.params, bufs.tokens, bufs.positions, bufs.slots, bufs.block_tables,
            bufs.cu_q_lens, bufs.context_lens, bufs.gather_idx, self.cache, c.model,
            block_size=c.block_size, max_q_len=c.spec.num_draft_tokens + 1,
            attn_impl=c.attn_impl, lora=self._lora_arg(bufs.lora_ids),
        )
        return logits

    # -- scheduling ------------------------------------------------------------

    def _promote_priority(self) -> None:
        """Move the highest-priority waiting request to the queue head
        (stable: FIFO within a priority class)."""
        w = self.waiting
        if len(w) < 2:
            return
        best_i = max(range(len(w)), key=lambda i: (w[i].priority, -i))
        if best_i:
            req = w[best_i]
            del w[best_i]
            w.appendleft(req)

    def _preempt_one(self, below_priority: Optional[int] = None,
                     reason: str = "pressure") -> bool:
        """Kick a running request back to waiting (recompute). The victim
        is the lowest-priority, newest-arrival request. ``below_priority``
        only preempts a victim strictly below it and may empty the batch;
        the KV-pressure path keeps a batch of one running. ``reason`` labels
        the preemption counter (pressure / priority)."""
        if not self.running:
            return False
        if below_priority is None and len(self.running) <= 1:
            return False
        victim = min(self.running, key=lambda r: (r.priority, -r.arrival))
        if below_priority is not None and victim.priority >= below_priority:
            return False
        self._count_preemption(victim, reason)
        self.running.remove(victim)
        # a mid-prefill mixed row re-queues like any victim
        self._mixed_prefills.pop(victim.request_id, None)
        victim.seq.release()
        victim.seq = None
        # outputs are kept; re-admission prefills prompt + outputs
        victim.status = RequestStatus.WAITING
        victim.num_preemptions += 1
        self.num_preemptions += 1
        self.waiting.appendleft(victim)
        now = time.time()
        self._obs_span(victim, "engine.preempt", now, now,
                       {"num_preemptions": victim.num_preemptions, "reason": reason})
        victim.t_queue_start = now  # the next queue_wait span starts here
        victim.t_span_cursor = None
        if self.drafter is not None:
            # re-admission recomputes; stale draft-cache state would desync
            self.drafter.release(victim.request_id)
        return True

    def _bt_width(self, page_counts) -> int:
        """Block-table width for this call: the batch's real page count
        rounded up to a power of two (floor 16 blocks), capped at the
        model maximum."""
        w = max(list(page_counts) or [1])
        w = 1 << max(0, (w - 1)).bit_length()
        w = max(w, min(16, self.config.max_blocks_per_seq))
        return min(w, self.config.max_blocks_per_seq)

    def _chunk_steps(self) -> int:
        """Device-side steps this round: the configured chunk, shrunk only
        by the HARD max_seq wall (positions past it index off the RoPE
        table), floored to a power of two."""
        c = self.config
        n = max(1, c.decode_chunk)
        for r in self.running:
            n = min(n, max(1, c.model.max_seq - r.num_tokens))
        return 1 << (n.bit_length() - 1)

    def _remaining(self, r) -> int:
        """Output tokens this request can still KEEP (max_tokens budget)."""
        return max(1, r.sampling_params.max_tokens - len(r.output_token_ids))

    def _decode_step(self) -> list[RequestOutput]:
        if self.config.spec is not None:
            return self._spec_decode_step()
        if self.config.pipeline_decode:
            return self._pipelined_decode_step()
        return self._plain_decode_step()

    # -- pipelined decode (llm/pipeline.py over llm/graphs.py) ----------------
    # Chunk N+1 is dispatched from the device-resident carry BEFORE chunk N's
    # tokens are synced, so host bookkeeping overlaps device work.
    # Membership changes (admission, abort, preemption) flush first; rows
    # that finish during the overlap are already done on the device, so the
    # early-dispatched chunk computes the same stream for live rows and
    # nothing for finished ones. Token identity with the sync path is the
    # contract.

    def _masked_chunk(self, bufs, n_steps: int, mode: str, early_exit: bool):
        """One masked chunk on a bucket's static buffers, carry written
        back in place (what ``ChunkGraphs`` captures and replays)."""
        c = self.config
        toks, lps, n_emit, steps_run, carry, self.cache = pipeline.decode_chunk_masked(
            self.params, bufs.tokens, bufs.positions, bufs.block_tables,
            bufs.context_lens, self.cache, bufs.temps, bufs.top_ks, bufs.top_ps,
            bufs.seed_bases, bufs.starts, bufs.max_toks, bufs.done, bufs.stop_ids,
            bufs.stop_on_eos, c.model, n_steps=n_steps, block_size=c.block_size,
            trash_slot=c.num_blocks * c.block_size, eos_id=c.eos_token_id,
            attn_impl=c.attn_impl, sample_mode=mode, early_exit=early_exit,
            lora=self._lora_arg(bufs.lora_ids),
        )
        for dst, src in zip(bufs.carry(), carry):
            dst.copy_(src)
        return toks, lps, n_emit, steps_run

    def _pipe_flush(self, deliver: bool = False) -> list[RequestOutput]:
        """Land the in-flight chunk (if any) and drop the device-resident
        state (callers flush because membership is about to change).
        Returns the synced outputs; with ``deliver`` they are queued for
        the next step() instead."""
        rec, self._pipe_inflight = self._pipe_inflight, None
        self._pipe_state = None
        # the gap to the next dispatch spans a membership change, which
        # does not amortize with chunk length: keep it out of the
        # controller's per-round overhead signal (also when nothing is in
        # flight: the last chunk of a batch may have been synced already)
        self._pipe_last_sync_t = None
        if rec is None:
            return []
        self._pipe_stats.flushes += 1
        outs = self._pipe_sync(rec)
        self._pipe_last_sync_t = None
        if deliver and outs:
            self._pending_outputs.extend(outs)
            return []
        return outs

    def _pipe_drop(self) -> None:
        """Discard the in-flight chunk without syncing it. Its tokens were
        never booked into output_token_ids, so a recompute from the
        requests' prefixes stays correct."""
        self._pipe_inflight = None
        self._pipe_state = None
        self._pipe_last_sync_t = None

    def _pipelined_decode_step(self) -> list[RequestOutput]:
        c = self.config
        if self._pipe_ctl is None:
            self._pipe_ctl = pipeline.ChunkController(initial=max(1, c.decode_chunk))
            self._pipe_stats = pipeline.PipelineStats()
        if any(
            len(r.sampling_params.stop_token_ids) > pipeline.STOP_WIDTH_CAP
            for r in self.running
        ):
            # a stop set wider than the padded device matrix: serve this
            # batch on the sync path (identical tokens)
            self._pipe_stats.sync_fallbacks += 1
            outs = self._pipe_flush()
            return outs if outs else self._plain_decode_step()

        t_prep0 = time.perf_counter()
        wall0 = time.time()  # the decode_chunk span's dispatch stamp
        prev = self._pipe_inflight
        self._pipe_inflight = None
        # chunk length: adaptive from the measured host round overhead vs
        # chunk wall, capped by the batch's largest remaining budget
        gap_ms = (
            (t_prep0 - self._pipe_last_sync_t) * 1e3
            if self._pipe_last_sync_t is not None else 0.0
        )
        pending = prev["n_steps"] if prev is not None else 0
        left = max((self._remaining(r) for r in self.running), default=1) - pending
        if prev is not None and left <= 0:
            # every row's max_tokens budget ends inside the chunk in flight:
            # another chunk would only compute frozen rows (the reference's
            # while-loop leaves such a chunk at once; a graph runs it whole)
            return self._pipe_sync(prev)
        n_steps = self._pipe_ctl.next_steps(cap=max(1, left))

        # reserve KV for the chunk's writes, per row clamped to its budget
        # and the max_seq wall. The horizon includes the un-synced chunk in
        # flight: this dispatch continues from the device carry, up to
        # prev_steps tokens past the host's num_tokens, and a write past the
        # reserved blocks would read table padding (0) and clobber another
        # sequence's block 0
        try:
            for r in self.running:
                r.seq.ensure_capacity(
                    r.num_tokens + max(1, min(
                        pending + n_steps, self._remaining(r),
                        c.model.max_seq - r.num_tokens,
                    ))
                )
        except NoFreeBlocksError:
            # real cache pressure: preemption is a membership change — land
            # the in-flight chunk first so its tokens aren't lost, then
            # preempt and let the next round rebuild
            if prev is not None:
                self._pipe_inflight = prev
                return self._pipe_flush()
            self._pipe_state = None
            if not self._preempt_one():
                raise  # single running request can't fit: cache too small
            return []

        state = self._pipe_state
        if state is None:
            state = pipeline.DeviceBatchState.build(self, self.running)
            self._pipe_state = state
            if prev is None:
                self._pipe_stats.rebuilds += 1
        elif not state.refresh_block_tables(self.running):
            # a row outgrew the padded block-table width: flush + rebuild
            if prev is not None:
                self._pipe_inflight = prev
                return self._pipe_flush()
            state = pipeline.DeviceBatchState.build(self, self.running)
            self._pipe_state = state
            self._pipe_stats.rebuilds += 1

        # dispatch chunk N+1 from the device-resident carry (a graph replay
        # on the card: it does not wait for chunk N)
        t_dispatch = time.perf_counter()
        host_prep_ms = (t_dispatch - t_prep0) * 1e3
        capture_s0 = self._graphs.capture_s
        inflight = self._graphs.run(self._masked_chunk, state.bufs, n_steps, state.sample_mode)
        # a first use of a bucket captures its graph: neither host prep nor
        # chunk time
        t_dispatch += self._graphs.capture_s - capture_s0
        self._pipe_stats.record_dispatch(n_steps, host_prep_ms)
        self._obs_series(pipeline.record_host_prep, host_prep_ms)
        self._pipe_inflight = {
            "batch": list(self.running), "row_of": dict(state.row_of),
            "inflight": inflight, "n_steps": n_steps,
            "t_dispatch": t_dispatch, "wall0": wall0, "gap_ms": gap_ms,
        }
        if prev is None:
            # cold start: nothing to overlap with yet; the next step()
            # dispatches chunk 2 and syncs this one
            return []
        return self._pipe_sync(prev)

    def _pipe_sync(self, rec) -> list[RequestOutput]:
        """Sync one dispatched chunk's tokens and run the host ladder for
        the rows still alive."""
        t0 = time.perf_counter()
        toks, lps, n_emit, steps_run = rec["inflight"].wait()  # the host sync
        t1 = time.perf_counter()
        self._pipe_last_sync_t = t1
        sync_wait_ms = (t1 - t0) * 1e3
        chunk_ms = (t1 - rec["t_dispatch"]) * 1e3
        self._pipe_ctl.note_overhead(rec["gap_ms"] + sync_wait_ms)
        self._pipe_ctl.note_chunk(chunk_ms, rec["n_steps"], steps_run)
        self._pipe_stats.record_sync(
            steps_run=steps_run, sync_wait_ms=sync_wait_ms, chunk_ms=chunk_ms
        )
        self._obs_series(pipeline.record_sync_wait, sync_wait_ms)
        # rows that finished in an earlier sync are done on the device and
        # emitted nothing; only live rows get bookkeeping
        live = [
            r for r in rec["batch"]
            if r.status == RequestStatus.RUNNING and r.seq is not None
        ]
        if not live:
            return []
        cols = [rec["row_of"][r.request_id] for r in live]
        outputs = self._append_chunk(
            live, toks[:, cols], lps[:, cols], row_counts=[int(n_emit[j]) for j in cols],
        )
        return self._obs_decode_round(live, outputs, rec["wall0"], "engine.decode_chunk",
                                      rec["n_steps"])

    # -- speculative decoding (llm/spec) ---------------------------------------

    def _spec_decode_step(self) -> list[RequestOutput]:
        """One speculative round: draft -> one batched verify pass ->
        distribution-preserving accept -> KV rollback. A row whose drafter
        proposed nothing feeds only its current token (its column-0 logits
        are a decode step's) and emits one token; only when no row has a
        draft does the round take the sync decode path. With mixed
        batching the verify pass is packed (1 + draft length tokens a row)
        and, on the card, a graph replay of its packed-token bucket; the
        split verify pass (``verify_tokens``) and the acceptance run
        eagerly."""
        c = self.config
        wall0 = time.time()
        k = c.spec.num_draft_tokens
        batch = list(self.running)

        # draft first (host-side): capacity needs depend on draft lengths
        draft_by_rid: dict[str, list] = {}
        for r in batch:
            # positions fed this round reach num_tokens-1+L and the pass
            # emits up to L+1 tokens: cap L by the max_tokens budget and the
            # max_seq wall
            cap = min(k, self._remaining(r) - 1, c.model.max_seq - r.num_tokens)
            d = (
                self.drafter.propose(
                    r.request_id, r.prompt_token_ids + r.output_token_ids, cap
                )
                if cap > 0 else []
            )
            draft_by_rid[r.request_id] = list(d)
        t_drafted = time.time()
        if not any(draft_by_rid.values()):
            return self._plain_decode_step()

        # reserve KV for the drafted positions; preempt on real pressure only
        while True:
            try:
                for r in self.running:
                    r.seq.ensure_capacity(r.num_tokens + len(draft_by_rid[r.request_id]))
                break
            except NoFreeBlocksError:
                if not self._preempt_one():
                    raise

        batch = list(self.running)
        drafts = [draft_by_rid[r.request_id] for r in batch]
        B = len(batch)
        B_pad = self._pad_to_bucket(B, c.decode_buckets())
        K1 = k + 1
        num_slots = c.num_blocks * c.block_size

        context_lens = np.zeros(B_pad, np.int32)
        draft_tokens = np.zeros((B_pad, k), np.int32)
        draft_lens = np.zeros(B_pad, np.int32)
        bt = np.zeros((B_pad, self._bt_width([len(r.seq.blocks) for r in batch])), np.int32)
        rows = []  # (fed token + draft, position of the fed token) per row
        for i, r in enumerate(batch):
            d = drafts[i]
            context_lens[i] = r.num_tokens + len(d)
            draft_tokens[i, : len(d)] = d
            draft_lens[i] = len(d)
            bt[i, : len(r.seq.blocks)] = r.seq.blocks
            last = r.output_token_ids[-1] if r.output_token_ids else r.prompt_token_ids[-1]
            rows.append(([last] + d, r.num_tokens - 1))

        if c.mixed_batch:
            # ragged verify: pack only the real 1 + draft_len tokens per row;
            # gather_idx recovers the [B, K+1] logits layout accept_draft
            # expects (positions past a row's draft repeat its last token and
            # are masked by draft_lens)
            T_pad = token_bucket(sum(len(row) for row, _ in rows))
            p_tokens = np.zeros(T_pad, np.int32)
            p_positions = np.zeros(T_pad, np.int32)
            p_slots = np.full(T_pad, num_slots, np.int32)
            p_lora = np.zeros(T_pad, np.int32)  # adapter slot per token
            cu = np.zeros(B_pad + 1, np.int32)
            gather = np.zeros((B_pad, K1), np.int32)
            t = 0
            for i, (r, (row, pos0)) in enumerate(zip(batch, rows)):
                n = len(row)
                p_tokens[t : t + n] = row
                p_positions[t : t + n] = np.arange(pos0, pos0 + n)
                p_slots[t : t + n] = r.seq.slots_for_range(pos0, pos0 + n)
                p_lora[t : t + n] = r.lora_slot
                gather[i] = t + np.minimum(np.arange(K1), n - 1)
                t += n
                cu[i + 1] = t
            cu[B + 1 :] = t  # pad sequences: q_len 0
            bufs = self._verify_graphs.buffers("verify", T_pad, B_pad, bt.shape[1], k1=K1,
                                               lora=self._lora is not None)
            bufs.fill(tokens=p_tokens, positions=p_positions, slots=p_slots, lora_ids=p_lora,
                      cu_q_lens=cu, context_lens=context_lens, block_tables=bt,
                      gather_idx=gather)
            # logits [B_pad, K+1, V] in the graph's pool: accepted below,
            # before the bucket replays again
            logits = self._verify_graphs.run(self._verify_program, bufs)
        else:
            tokens = np.zeros((B_pad, K1), np.int32)
            positions = np.zeros((B_pad, K1), np.int32)
            slots = np.full((B_pad, K1), num_slots, np.int32)  # trash by default
            for i, (r, (row, pos0)) in enumerate(zip(batch, rows)):
                n = len(row)
                tokens[i, :n] = row
                positions[i, :n] = np.arange(pos0, pos0 + n)
                slots[i, :n] = r.seq.slots_for_range(pos0, pos0 + n)
            lora_ids = np.zeros(B_pad, np.int32)
            lora_ids[:B] = [r.lora_slot for r in batch]
            logits, self.cache = verify_tokens(
                self.params, self._tensor(tokens), self._tensor(positions),
                self._tensor(slots), self._tensor(bt), self._tensor(context_lens),
                self.cache, c.model, block_size=c.block_size,
                lora=self._lora_arg(lora_ids),
            )

        # acceptance follows the batch's sampler mode: greedy -> argmax
        # comparisons; categorical -> tempered softmax; else exact filtering
        batch_mode = self._sample_mode(batch)
        mode = batch_mode if batch_mode in ("greedy", "categorical") else "sample"
        pad = B_pad - B
        sps = [r.sampling_params for r in batch]
        out_toks, out_lps, accepted = accept_draft(
            logits, self._tensor(draft_tokens), self._tensor(draft_lens),
            self._tensor(np.asarray([sp.temperature for sp in sps] + [1.0] * pad, np.float32)),
            self._tensor(np.asarray([sp.top_k for sp in sps] + [0] * pad, np.int64)),
            self._tensor(np.asarray([sp.top_p for sp in sps] + [1.0] * pad, np.float32)),
            self._row_seeds(batch, B_pad), mode=mode,
        )
        out_toks = out_toks.cpu().numpy()  # the host sync
        out_lps = out_lps.cpu().numpy()
        accepted = accepted.cpu().numpy()
        t_verified = time.time()

        # keep accepted + 1 tokens per row through the usual stop ladder
        counts = (accepted[:B] + 1).tolist()
        outputs = self._append_chunk(batch, out_toks[:B].T, out_lps[:B].T, row_counts=counts)
        # KV rollback: blocks reserved for rejected draft positions go back;
        # their stale K/V is masked by context_lens and rewritten later
        for r in batch:
            if r.status == RequestStatus.RUNNING and r.seq is not None:
                r.seq.truncate_to(r.num_tokens)

        st = self.spec_stats
        n_drafted, n_accepted = int(draft_lens[:B].sum()), int(accepted[:B].sum())
        n_emitted = sum(len(o.new_token_ids) for o in outputs)
        st.steps += 1
        st.rows += B
        st.drafted += n_drafted
        st.accepted += n_accepted
        st.emitted += n_emitted
        self._obs_series(export_spec_stats, st, n_drafted, n_accepted, n_emitted)
        draft_ms = round((t_drafted - wall0) * 1e3, 3)
        verify_ms = round((t_verified - t_drafted) * 1e3, 3)
        extra = {
            r.request_id: {"k": k, "drafted": int(draft_lens[i]), "accepted": int(accepted[i]),
                           "draft_ms": draft_ms, "verify_ms": verify_ms}
            for i, r in enumerate(batch)
        }
        return self._obs_decode_round(batch, outputs, wall0, "engine.spec_round", k,
                                      extra=extra)

    # -- sync decode ----------------------------------------------------------

    def _plain_decode_step(self) -> list[RequestOutput]:
        c = self.config
        wall0 = time.time()
        n_steps = self._chunk_steps()
        # grow each sequence by the chunk's slots it can USE: overshoot
        # steps past max_tokens write the trash page (decode_loop
        # `remaining`). Preempt on real cache pressure only.
        while True:
            try:
                for r in self.running:
                    r.seq.ensure_capacity(
                        r.num_tokens + min(n_steps, self._remaining(r))
                    )
                break
            except NoFreeBlocksError:
                if not self._preempt_one():
                    raise  # single running request can't fit: cache too small
        batch = list(self.running)
        B = len(batch)
        B_pad = self._pad_to_bucket(B, c.decode_buckets())
        num_slots = c.num_blocks * c.block_size
        a, seed_bases = assemble_batch_arrays(
            batch, B_pad, self._bt_width([len(r.seq.blocks) for r in batch])
        )

        if n_steps == 1:
            slot_mapping = np.full(B_pad, num_slots, np.int32)
            for i, r in enumerate(batch):
                slot_mapping[i] = r.seq.slot(int(a["positions"][i]))
            logits, self.cache = decode_step(
                self.params, self._tensor(a["tokens"]), self._tensor(a["positions"]),
                self._tensor(slot_mapping), self._tensor(a["bt"]),
                self._tensor(a["context_lens"]), self.cache, c.model,
                block_size=c.block_size, attn_impl=c.attn_impl,
                lora=self._lora_arg(a["lora_ids"]),
            )
            tok, logprob = self._sample_batch(logits[:B], batch)
            return self._obs_decode_round(batch, self._append_tokens(batch, tok, logprob),
                                          wall0, "engine.decode_chunk", 1)

        # multi-step chunk: decode+sample n_steps times on the device, one
        # sync. Seeds derive from (request seed base, absolute output
        # index): identical sampling however the chunks fall
        from ray_tpu_torch.llm.decode_loop import decode_chunk

        remaining = np.zeros(B_pad, np.int32)
        for i, r in enumerate(batch):
            remaining[i] = self._remaining(r)
        toks, logprobs, self.cache = decode_chunk(
            self.params, self._tensor(a["tokens"]), self._tensor(a["positions"]),
            self._tensor(a["bt"]), self._tensor(a["context_lens"]), self.cache,
            self._tensor(a["temps"]), self._tensor(a["top_ks"]),
            self._tensor(a["top_ps"]), self._tensor(seed_bases), self._tensor(a["starts"]),
            self._tensor(remaining), c.model, n_steps=n_steps,
            block_size=c.block_size, trash_slot=num_slots,
            attn_impl=c.attn_impl, sample_mode=self._sample_mode(batch),
            lora=self._lora_arg(a["lora_ids"]),
        )
        # the chunk's one host sync
        outputs = self._append_chunk(batch, toks.cpu().numpy(), logprobs.cpu().numpy())
        return self._obs_decode_round(batch, outputs, wall0, "engine.decode_chunk", n_steps)

    # -- observability (host clock only; every error swallowed) ---------------

    def _obs_series(self, record, *args, **kw) -> None:
        """The registry writes outside the span hooks go through here
        (``record`` swallows its own errors): one seam per instance."""
        record(*args, **kw)

    def _count_preemption(self, req, reason: str) -> None:
        try:
            preemption_counter().inc(1, tags={"model": self.model_tag,
                                              "tenant": req.tenant or "", "reason": reason})
        except Exception:  # noqa: BLE001 — accounting, not correctness
            pass

    def _obs_span(self, req, name: str, t0: float, t1: float,
                  attrs: Optional[dict] = None, status: str = "ok") -> None:
        try:
            trace_recorder.get_recorder().record(
                name, t0, t1, ctx=req.trace, attrs=attrs, status=status
            )
        except Exception:  # noqa: BLE001
            pass

    def _obs_prefilled(self, reqs: list, t1: float, mixed: bool = False) -> None:
        """``engine.prefill`` spans for requests whose first token (or
        recompute's next token) was just sampled at ``t1``; decode spans
        tile from there."""
        for r in reqs:
            attrs = {"prompt_tokens": len(r.prompt_token_ids),
                     "cached_tokens": r._prefill_cached,
                     "recompute": r.num_preemptions > 0}
            if mixed:
                attrs["mixed"] = True
            self._obs_span(r, "engine.prefill",
                           r.t_prefill_start if r.t_prefill_start is not None else t1, t1, attrs)
            if r.t_first_token is None:
                r.t_first_token = t1
            r.t_span_cursor = t1
        if reqs:
            self._obs_finalize(reqs, t1)

    def _obs_decode_round(self, batch: list, outputs: list, wall0: float,
                          name: str, n_steps: int, extra: Optional[dict] = None) -> list:
        """Record one decode round for every participating request, then
        finalize the ones that finished. A span starts at the request's
        cursor (the end of its previous span), so pipelined rounds, which
        overlap on the device, still tile arrival -> finish. ``extra`` maps
        request_id -> more span attrs (a spec round's draft/accept counts)."""
        try:
            t1 = time.time()
            active_ms = round((t1 - wall0) * 1e3, 3)
            by_rid = {o.request_id: o for o in outputs}
            for r in batch:
                out = by_rid.get(r.request_id)
                start = r.t_span_cursor if r.t_span_cursor is not None else wall0
                start = min(start, wall0)
                attrs = {
                    "n_steps": n_steps,
                    "new_tokens": len(out.new_token_ids) if out else 0,
                    "active_ms": active_ms,
                }
                gap_ms = (wall0 - start) * 1e3
                if gap_ms > 0.05:
                    attrs["sched_gap_ms"] = round(gap_ms, 3)
                if extra:
                    attrs.update(extra.get(r.request_id, ()))
                self._obs_span(r, name, start, t1, attrs)
                r.t_span_cursor = t1
            self._obs_finalize(batch, t1)
        except Exception:  # noqa: BLE001
            pass
        return outputs

    def _obs_finalize(self, reqs: list, t_end: float) -> None:
        """The ``llm.request`` root span and the SLO observations of the
        requests that just finished (a second SLO record under a request's
        own ``slo_tag``)."""
        for r in reqs:
            if r.status != RequestStatus.FINISHED:
                continue
            try:
                n_out = len(r.output_token_ids)
                e2e = max(0.0, t_end - r.arrival)
                ttft = (max(0.0, r.t_first_token - r.arrival)
                        if r.t_first_token is not None else None)
                tpot = ((t_end - r.t_first_token) / (n_out - 1)
                        if r.t_first_token is not None and n_out > 1 else None)
                queue_wait = (max(0.0, r.t_first_prefill - r.arrival)
                              if r.t_first_prefill is not None else None)
                prefill_span = (max(0.0, r.t_first_token - r.t_first_prefill)
                                if r.t_first_token is not None
                                and r.t_first_prefill is not None else None)
                attrs = {
                    "request_id": r.request_id,
                    "finish_reason": r.finish_reason,
                    "prompt_tokens": len(r.prompt_token_ids),
                    "output_tokens": n_out,
                    "num_preemptions": r.num_preemptions,
                    "e2e_s": round(e2e, 6),
                }
                if ttft is not None:
                    attrs["ttft_s"] = round(ttft, 6)
                if tpot is not None:
                    attrs["tpot_s"] = round(tpot, 6)
                if queue_wait is not None:
                    attrs["queue_wait_s"] = round(queue_wait, 6)
                self._obs_span(r, "llm.request", r.arrival, t_end, attrs)
                tags = [self.model_tag]
                if r.slo_tag and r.slo_tag != self.model_tag:
                    # the same observation under the request's own tag (a
                    # tenant or a canary), graded in isolation
                    tags.append(r.slo_tag)
                for tag in tags:
                    slo.record_request_slo(
                        tag, ttft_s=ttft, tpot_s=tpot, queue_wait_s=queue_wait,
                        e2e_s=e2e, finish_reason=r.finish_reason or "",
                        prefill_span_s=prefill_span,
                    )
            except Exception:  # noqa: BLE001
                pass

    # -- sampling + bookkeeping ----------------------------------------------

    def _row_seeds(self, batch: list, n: int) -> torch.Tensor:
        """[n] int64 seeds of each request's next token (pad rows 0): a pure
        function of (request seed base, absolute output index), so the same
        request samples the same stream in any chunking, under any load."""
        seeds = np.zeros(n, np.int64)
        for i, r in enumerate(batch):
            seeds[i] = row_seed(r.seed_base, len(r.output_token_ids))
        return self._tensor(seeds)

    def _sample_batch(self, logits, batch: list) -> tuple[np.ndarray, np.ndarray]:
        B = len(batch)
        sps = [r.sampling_params for r in batch]
        toks, logprobs = sample_tokens(
            logits[:B],
            self._tensor(np.asarray([sp.temperature for sp in sps], np.float32)),
            self._tensor(np.asarray([sp.top_k for sp in sps], np.int64)),
            self._tensor(np.asarray([sp.top_p for sp in sps], np.float32)),
            self._row_seeds(batch, B),
            mode=self._sample_mode(batch),
        )
        return toks.cpu().numpy(), logprobs.cpu().numpy()

    def _append_chunk(self, batch: list, toks, logprobs,
                      row_counts: Optional[list] = None) -> list[RequestOutput]:
        """Host bookkeeping after a device-side chunk: walk each request's
        token column in order, keep until a stop condition fires, discard
        the overshoot (its KV sits in the request's own unsealed blocks,
        released with the sequence). One RequestOutput per request.
        ``row_counts`` caps the walk per row (the pipelined chunk's
        n_emitted; a spec round's accepted + 1)."""
        c = self.config
        outputs = []
        now = time.time()
        n = toks.shape[0]
        for i, r in enumerate(batch):
            sp = r.sampling_params
            new_toks: list[int] = []
            finished = False
            if r.t_first_token is None:
                r.t_first_token = now
            for s in range(n if row_counts is None else min(n, row_counts[i])):
                t = int(toks[s, i])
                lp = float(logprobs[s, i])
                new_toks.append(t)
                r.output_token_ids.append(t)
                r.cumulative_logprob += lp
                if sp.logprobs:
                    r.token_logprobs.append(lp)
                if not sp.ignore_eos and t == c.eos_token_id:
                    finished, r.finish_reason = True, "stop"
                elif t in sp.stop_token_ids:
                    finished, r.finish_reason = True, "stop"
                elif len(r.output_token_ids) >= sp.max_tokens:
                    finished, r.finish_reason = True, "length"
                elif r.num_tokens >= c.model.max_seq:
                    finished, r.finish_reason = True, "length"
                if finished:
                    break
            num_cached = r.seq.num_cached_tokens if r.seq else 0
            written = r.prompt_token_ids + r.output_token_ids[:-1]
            if c.enable_prefix_caching:
                # seals only blocks fully covered by `written`
                r.seq.seal_full_blocks(written)
            if finished:
                r.status = RequestStatus.FINISHED
                self.running.remove(r)
                r.seq.release()
                self.requests.pop(r.request_id, None)
                if self.drafter is not None:
                    self.drafter.release(r.request_id)
            else:
                r.seq.num_tokens = r.num_tokens
            outputs.append(
                RequestOutput(
                    request_id=r.request_id,
                    new_token_ids=new_toks,
                    output_token_ids=list(r.output_token_ids),
                    finished=finished,
                    finish_reason=r.finish_reason,
                    num_cached_tokens=num_cached,
                )
            )
        return outputs

    def _append_tokens(self, batch: list, toks, logprobs) -> list[RequestOutput]:
        """Single-step bookkeeping: the n = 1 case of _append_chunk."""
        return self._append_chunk(
            batch, np.asarray(toks)[None, :], np.asarray(logprobs)[None, :]
        )
