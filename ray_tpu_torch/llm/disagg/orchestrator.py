"""Disaggregated prefill/decode orchestration over engine pools (counterpart
of ``ray_tpu/llm/disagg/orchestrator.py``).

A colocated engine time-slices prefill and decode on one device; here they
run on separate engine pools and a request migrates once:

    submit -> [prefill pool] --KVHandoff over a KVConnector--> [decode pool]

 * prefill engines run admission, prefill and the first token, then export
   the sequence (``LLMEngine.export_request``); they never decode;
 * a transfer thread picks a decode engine per handoff (queue depth first,
   ``peek_prefix_tokens`` and the prefix hit rate as tiebreaks) and sends
   the handoff through the connector;
 * decode engines verify and import it (``LLMEngine.import_handoff``, zero
   recompute) and run decode rounds.

A handoff that is dropped, times out or arrives corrupt is re-prefilled
under a per-request budget (``max_handoff_retries``), with the request id,
its sampling seed base and its delivered-token watermark kept, so callers
see each output position once. A prefill engine that fails mid-step has
its requests re-homed the same way; a decode engine that fails climbs the
ladder recover -> recover(rebuild_kv) -> evacuate through the budget.

Threads. The reference calls ``add_request`` / ``abort_request`` from the
caller's, the transfer and the decode threads under a per-engine lock.
Here each engine is touched only by its own loop thread (on the card it
captures and replays its CUDA graphs on that thread's stream): submits,
aborts, re-prefills and state reads are posted to a per-engine inbox that
the loop drains at every step boundary, and imports run on the decode
loop itself. The picks read the host-side allocator, the tier tables and
the counters of each engine without waiting (read-only dict lookups under
the tier manager's lock, no device work). Captures of two engines never
collide (``llm/graphs.py``).

With the tiered cache (``engine.kvtier``) every pool engine publishes into
one prefix index and registers with one fetch registry of this
orchestrator (``llm/kvtier``, ``llm/kvfetch``, in-process): the
prefix-aware picks see the host and object tiers, and with
``fetch_cost_routing`` an engine holding nothing scores ``fetch_weight``
times the best holder, since its prefetch worker can pull the prefix.

Not ported, and refused by ``DisaggConfig``: the cluster-RPC and device
connectors (ROADMAP.md Queue 1, C5/B8 and C1) and the fabric topology (C1).

Observability, as the reference's: each engine's ``model_tag`` is
``<model_tag>-prefill<i>`` / ``-decode<i>``; an imported handoff records an
``llm.kv_transfer`` span (from the end of its prefill span to the end of
the import, so the request's spans tile across the hop) and the
``llm_kv_transfer_seconds`` / ``_bytes_total`` series under the
orchestrator's ``model_tag``; a lost one an ``llm.kv_transfer_failed`` event.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import logging
import queue
import threading
import time
import uuid
from typing import Any, Callable, Optional

from ray_tpu_torch import obs
from ray_tpu_torch.llm.disagg.connector import (
    InProcessConnector,
    KVConnector,
    KVTransferError,
    make_connector,
)
from ray_tpu_torch.llm.disagg.handoff import KVHandoff
from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine, RequestOutput
from ray_tpu_torch.llm.kv_cache import NoFreeBlocksError
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.obs import slo
from ray_tpu_torch.obs.context import TraceContext

logger = logging.getLogger("ray_tpu_torch.llm.disagg.orchestrator")

_INPROC = ("inproc", "in_process", "inprocess")


@dataclasses.dataclass
class DisaggConfig:
    """Pool shape and transfer plane of one disaggregated deployment.

    Divergence from the reference, on purpose: with mixed batching
    (``engine.mixed_batch``) the reference's prefill loop exports every
    RUNNING request after each step, and ``export_request`` refuses a row
    still mid-prompt, so such a prompt is "recovered" until the re-prefill
    budget runs out (``EngineConfig(mixed_batch=True,
    mixed_prefill_chunk=8)``, two 30-token greedy prompts: KVTransferError
    "handoff failed 3 times (last: prefill_death:ValueError); budget
    exhausted"). The port's prefill loop exports only rows whose prompt is
    complete; rows still mid-prompt stay and finish in later mixed steps,
    and the tokens equal the colocated engine's. ``export_request`` keeps
    the reference's refusal. Pinned by
    ``tests/test_torch_disagg.py::test_mixed_prefill_export_divergence``.
    With ``mixed_batch=False`` the port matches the reference token for
    token."""

    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    num_prefill: int = 1
    num_decode: int = 1
    connector: str = "inproc"
    transfer_timeout_s: float = 30.0
    # re-prefill budget per request across transfer losses and engine
    # failures; past it the request fails loudly
    max_handoff_retries: int = 2
    # decode pick: queue depth first, the prefix cache as tiebreak
    cache_aware_pick: bool = True
    # among engines within depth_slack of the least loaded, prefer the one
    # holding the longest tier-discounted prefix of the prompt
    prefix_aware_routing: bool = True
    depth_slack: int = 4
    # with the tiered cache and its prefetch: an engine holding nothing
    # scores fetch_weight x the best holder (it pulls the prefix over the
    # fetch plane), so a holder past the slack spreads instead
    fetch_cost_routing: bool = True
    fabric: Any = None

    def __post_init__(self):
        if isinstance(self.engine, dict):
            self.engine = EngineConfig(**self.engine)
        if self.num_prefill < 1 or self.num_decode < 1:
            raise ValueError("num_prefill and num_decode must be >= 1")
        if self.connector not in _INPROC:
            make_connector(self.connector)  # "rpc" / "device" raise NotImplementedError
            raise ValueError(f"unknown KV connector {self.connector!r}")
        if self.fabric is not None:
            raise NotImplementedError(
                "DisaggConfig.fabric: the multi-slice device fabric is not ported to "
                "ray_tpu_torch yet (ROADMAP.md, Queue 1, C1)"
            )


class _PoolEngine:
    """One engine, the loop thread that alone touches it, and the inbox that
    loop drains at every step boundary."""

    def __init__(self, engine: LLMEngine, index: int, role: str):
        self.engine = engine
        self.index = index
        self.role = role
        self.wake = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self._inbox: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._closed = False
        # requests posted but not yet added, and handoffs sent to this engine
        # but not yet imported: both count in its depth
        self.pending_adds = 0
        self.in_transit = 0

    def depth(self) -> int:
        """Queue depth for the picks: the engine's waiting and running
        requests plus what was posted or sent to it and has not landed. A
        posted add stays counted until ``fn()`` has added it, so a pick
        never sees the engine lighter than it is."""
        e = self.engine
        with self._lock:
            posted = self.pending_adds
        return len(e.waiting) + len(e.running) + posted + self.in_transit

    def post(self, fn: Callable[[], None], adds: int = 0) -> bool:
        """Queue ``fn`` for the loop thread; False once the loop has ended."""
        with self._lock:
            if self._closed:
                return False
            self._inbox.append((fn, adds))
            self.pending_adds += adds
        self.wake.set()
        return True

    def call(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` run on the loop thread between two steps (here, once the
        loop has ended or when called from the loop itself)."""
        if threading.current_thread() is self.thread:
            return fn()
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — the caller's error
                fut.set_exception(e)

        if not self.post(run):
            return fn()
        return fut.result()

    def drain(self) -> None:
        while True:
            with self._lock:
                if not self._inbox:
                    return
                fn, adds = self._inbox.popleft()
            try:
                fn()
            finally:
                # lowered only once fn() has added the request to the engine
                with self._lock:
                    self.pending_adds -= adds

    def close(self) -> None:
        """The loop is ending: refuse later posts, run what was posted."""
        with self._lock:
            self._closed = True
        self.drain()


class DisaggOrchestrator:
    """Prefill pool + decode pool + KV transfer plane, for one model."""

    def __init__(
        self,
        config: DisaggConfig,
        params: Any = None,
        seed: int = 0,
        model_tag: str = "disagg",
        connector: Optional[KVConnector] = None,
        device="cuda",
    ):
        self.config = config
        self.model_tag = model_tag
        if params is None:
            import torch

            from ray_tpu_torch import resolve_device
            from ray_tpu_torch.models import llama

            dev = resolve_device(device)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            m = config.engine.model
            params = llama.init_params(m, gen, dev, dtype=m.dtype)
        # one copy of the weights for every engine (engines in the model's
        # dtype keep the tensors as they are)
        self.params = params
        self._prefill = [
            _PoolEngine(LLMEngine(config.engine, params=params, seed=seed, device=device),
                        i, "prefill")
            for i in range(config.num_prefill)
        ]
        self._decode = [
            _PoolEngine(LLMEngine(config.engine, params=params, seed=seed, device=device),
                        i, "decode")
            for i in range(config.num_decode)
        ]
        for p in self._prefill:
            p.engine.model_tag = f"{model_tag}-prefill{p.index}"
        for d in self._decode:
            d.engine.model_tag = f"{model_tag}-decode{d.index}"
        # a namespace of its own: two orchestrators with one model_tag in a
        # process never take each other's handoffs off the global queues
        self._ns = f"{model_tag}-{uuid.uuid4().hex[:8]}"
        self.connector = connector if connector is not None else InProcessConnector(self._ns)
        self._target_ids = [f"{model_tag}-decode{i}" for i in range(config.num_decode)]
        self._targets = [self.connector.register_target(t) for t in self._target_ids]
        # the fetch plane: every pool engine meets on one prefix index and
        # fetch registry of this orchestrator
        self._fetch_enabled = False
        self._registry = None
        if config.engine.kvtier is not None:
            from ray_tpu_torch.llm.kvfetch import LocalFetchClient, get_local_fetch_registry
            from ray_tpu_torch.llm.kvtier import get_local_index

            index = get_local_index(self._ns)
            self._registry = get_local_fetch_registry(self._ns)
            for pe in self._prefill + self._decode:
                key = f"{pe.role}{pe.index}"
                pe.engine.kvtier.attach_index(index, engine_key=key)
                self._registry.register(key, pe.engine.kvtier)
                pe.engine.kvfetch.attach(LocalFetchClient(self._registry))
            self._fetch_enabled = config.fetch_cost_routing

        self._lock = threading.Lock()
        # orchestrator-minted ids: every engine counts its own "req-N"
        self._counter = itertools.count()
        self._queues: dict[str, Any] = {}
        # rid -> {"prompt_ids", "sp", "trace", "tokens" (the delivered
        # watermark), "attempts", "seed_base"}: enough to re-prefill anywhere
        self._inflight: dict[str, dict] = {}
        self.num_transfers = 0
        self.num_reprefills = 0
        self.num_transfer_failures = 0
        # per imported handoff: its request, decode engine, size and the
        # milliseconds of each stage (export and import)
        self.handoffs: collections.deque = collections.deque(maxlen=4096)
        self._stop = False
        # the sender thread: a slow transfer never stalls a prefill step
        self._transfer_q: "queue.Queue[KVHandoff]" = queue.Queue()
        self._threads: list[threading.Thread] = []
        loops = [(self._transfer_loop, (), "disagg-transfer", None)]
        loops += [(self._prefill_loop, (p,), f"disagg-prefill-{p.index}", p) for p in self._prefill]
        loops += [(self._decode_loop, (d,), f"disagg-decode-{d.index}", d) for d in self._decode]
        for target, args, name, pe in loops:
            t = threading.Thread(target=target, args=args, name=name, daemon=True)
            if pe is not None:
                pe.thread = t
            t.start()
            self._threads.append(t)

    # -- public API -----------------------------------------------------------

    def submit_future(
        self,
        prompt_token_ids: list,
        sampling_params: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        trace: Any = None,
        sink: Any = None,
    ) -> concurrent.futures.Future:
        """Post one request to the least-loaded prefill engine; the future
        resolves, at that engine's next step boundary, to ``(request_id,
        sink)`` or to ``add_request``'s error. ``sink`` (default a
        ``queue.Queue``) receives RequestOutputs (watermarked: each output
        position once), an exception on terminal failure, or None after an
        abort."""
        sp = sampling_params or SamplingParams()
        trace = trace or obs.current()
        rid = request_id or f"dreq-{next(self._counter)}"
        sink = queue.Queue() if sink is None else sink
        prompt = list(prompt_token_ids)
        pe = self._pick_prefill(prompt)
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def add():
            if not fut.set_running_or_notify_cancel():
                return  # the caller went away first
            try:
                pe.engine.add_request(prompt, sp, request_id=rid, trace=trace)
            except Exception as e:  # noqa: BLE001 — the caller's error
                fut.set_exception(e)
                return
            with self._lock:
                self._queues[rid] = sink
                self._inflight[rid] = {"prompt_ids": prompt, "sp": sp, "trace": trace,
                                       "tokens": [], "attempts": 0}
            fut.set_result((rid, sink))

        if not pe.post(add, adds=1):
            raise RuntimeError("the orchestrator is shut down")
        return fut

    def submit(self, prompt_token_ids: list, sampling_params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None, trace: Any = None) -> tuple:
        """Blocking submit: ``(request_id, output queue)``, within one step
        of the prefill engine."""
        return self.submit_future(prompt_token_ids, sampling_params, request_id, trace).result()

    def generate(
        self,
        prompts: list,
        sampling_params: "SamplingParams | list[SamplingParams] | None" = None,
        timeout_s: float = 300.0,
    ) -> list:
        """Blocking batch helper: output token lists in order."""
        if sampling_params is None or isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params or SamplingParams()] * len(prompts)
        subs = [self.submit(p, sp) for p, sp in zip(prompts, sampling_params)]
        finals = []
        deadline = time.time() + timeout_s
        for rid, q in subs:
            toks = None
            while True:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"request {rid} did not finish in time")
                try:
                    out = q.get(timeout=remaining)
                except queue.Empty:
                    raise TimeoutError(f"request {rid} did not finish within {timeout_s}s") from None
                if isinstance(out, BaseException):
                    raise out
                if out is None:
                    break
                if out.finished:
                    toks = out.output_token_ids
                    break
            finals.append(toks)
        return finals

    def abort(self, request_id: str) -> None:
        """Abort wherever the request lives (waiting on a prefill engine, in
        flight as a handoff, or decoding)."""
        with self._lock:
            self._inflight.pop(request_id, None)
            q = self._queues.pop(request_id, None)
        for pe in self._prefill + self._decode:
            pe.post(lambda e=pe.engine: e.abort_request(request_id))
        if q is not None:
            q.put(None)

    def queue_depths(self) -> dict:
        return {
            "prefill": [p.depth() for p in self._prefill],
            "decode": [d.depth() for d in self._decode],
        }

    def has_unfinished(self) -> bool:
        with self._lock:
            return bool(self._inflight)

    def num_inflight(self) -> int:
        """Requests not finished anywhere: queued, decoding, or in transit as
        a handoff (which ``queue_depths`` misses)."""
        with self._lock:
            return len(self._inflight)

    def stats(self) -> dict:
        """Each engine's stats (read on its loop thread, between two steps),
        the transfer plane's counts and the pools' prefix cache."""
        pre = [p.call(p.engine.stats) for p in self._prefill]
        dec = [d.call(d.engine.stats) for d in self._decode]
        hit = sum(s["prefix_cache"]["hit_tokens"] for s in pre + dec)
        lookup = sum(s["prefix_cache"]["lookup_tokens"] for s in pre + dec)
        with self._lock:
            transfer = {
                **self.connector.stats(),
                "kv_transfers": self.num_transfers,
                "reprefills": self.num_reprefills,
                "transfer_failures": self.num_transfer_failures,
            }
            done = list(self.handoffs)
        stages = ("pin_ms", "gather_ms", "d2h_ms", "seal_ms", "verify_ms", "h2d_ms",
                  "scatter_ms")
        transfer["imported"] = len(done)
        transfer["bytes_imported"] = sum(h["bytes"] for h in done)
        transfer["mean_ms"] = {s: (sum(h.get(s, 0.0) for h in done) / len(done) if done else 0.0)
                               for s in stages}
        return {
            "prefill": pre,
            "decode": dec,
            "transfer": transfer,
            "prefix_cache": {
                "hit_tokens": hit,
                "lookup_tokens": lookup,
                "hit_rate": round(hit / lookup, 4) if lookup else 0.0,
            },
        }

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Stop every loop and wait (bounded) for it to finish its step."""
        self._stop = True
        for pe in self._prefill + self._decode:
            pe.wake.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=timeout_s)
        self.connector.close()
        for pe in self._prefill + self._decode:
            pe.engine.close()  # the tier workers, bounded joins
            if self._registry is not None:
                self._registry.unregister(f"{pe.role}{pe.index}")

    # -- delivery (watermarked, idempotent across re-prefills) ----------------

    def _deliver(self, out: RequestOutput) -> None:
        with self._lock:
            rec = self._inflight.get(out.request_id)
            sink = self._queues.get(out.request_id)
            if rec is None:
                return
            new = list(out.output_token_ids[len(rec["tokens"]):])
            rec["tokens"].extend(new)
            if out.finished:
                self._inflight.pop(out.request_id, None)
                self._queues.pop(out.request_id, None)
        if sink is not None and (new or out.finished):
            sink.put(dataclasses.replace(out, new_token_ids=new))

    def _fail_request(self, rid: str, exc: BaseException) -> None:
        with self._lock:
            self._inflight.pop(rid, None)
            sink = self._queues.pop(rid, None)
        if sink is not None:
            sink.put(exc)

    # -- prefill side ---------------------------------------------------------

    def _prefill_loop(self, pe: _PoolEngine) -> None:
        consec_failures = 0
        try:
            while not self._stop:
                pe.drain()
                eng = pe.engine
                if not eng.has_unfinished():
                    pe.wake.wait(timeout=0.05)
                    pe.wake.clear()
                    continue
                outputs, handoffs, err = [], [], None
                try:
                    outputs = eng.step()
                    # a prompt complete after this step is exported before it
                    # ever decodes; a row still mid-prompt in a mixed batch
                    # stays and finishes its prompt in later mixed steps (the
                    # DisaggConfig docstring's divergence)
                    for req in list(eng.running):
                        if req.request_id in eng._mixed_prefills:
                            continue
                        h = eng.export_request(req.request_id)
                        h.src_engine = pe.index
                        handoffs.append(h)
                except Exception as e:  # noqa: BLE001 — re-home in-flight work
                    err = e
                for out in outputs:
                    self._deliver(out)  # first tokens (TTFT), finished-at-prefill
                for h in handoffs:
                    self._transfer_q.put(h)
                if err is None:
                    consec_failures = 0
                    continue
                if self._stop:
                    return
                consec_failures += 1
                # a deterministic failure must not spin: after 3 in a row
                # every request leaves through the bounded re-prefill path
                self._recover_prefill(pe, err, drain_all=consec_failures >= 3)
        finally:
            pe.close()

    def _recover_prefill(self, pe: _PoolEngine, exc: BaseException,
                         drain_all: bool = False) -> None:
        """A prefill engine failed mid-step (on its own loop thread): requeue
        its requests through the bounded ``_requeue`` path, on another
        prefill engine when there is one. ``drain_all`` also evacuates the
        waiting requests."""
        logger.warning("prefill engine %d failed: %r; re-homing", pe.index, exc)
        eng = pe.engine
        try:
            rids = eng.recover()
            if drain_all:
                rids = list(dict.fromkeys(rids + list(eng.requests)))
            for rid in rids:
                req = eng.requests.pop(rid, None)
                if req is not None and req in eng.waiting:
                    eng.waiting.remove(req)
        except Exception:  # noqa: BLE001 — the engine is torn beyond recover
            logger.exception("prefill engine %d unrecoverable", pe.index)
            rids = list(eng.requests)
            for rid in rids:
                try:
                    eng.abort_request(rid)
                except Exception:  # noqa: BLE001
                    eng.requests.pop(rid, None)
        exclude = pe.index if len(self._prefill) > 1 else None
        for rid in rids:
            self._requeue(rid, exclude_index=exclude,
                          reason=f"prefill_death:{type(exc).__name__}")

    def _prefix_discounted(self, pe: _PoolEngine, prompt_token_ids: list, lora_id=None) -> float:
        """Tier-discounted prefix score of the prompt on one engine (a
        read-only probe across HBM, host and object tiers)."""
        try:
            return float(pe.engine.peek_prefix_tiered(prompt_token_ids, lora_id)["discounted"])
        except ValueError:
            return 0.0  # adapter not loaded there

    def _fetch_weight(self) -> float:
        """The fetch-cost discount (0.0: an engine holding nothing is never
        preferred). Needs the prefetch worker, which does the pulling."""
        kvt = self.config.engine.kvtier
        if not self._fetch_enabled or kvt is None or not kvt.prefetch:
            return 0.0
        return float(kvt.fetch_weight)

    def _pick_prefill(self, prompt_token_ids: list) -> _PoolEngine:
        """The engine holding the longest tier-discounted prefix of the
        prompt within ``depth_slack`` of the least loaded, else the least
        loaded. With fetch-cost routing an engine holding nothing scores
        ``fetch_weight`` times the best holder."""
        if len(self._prefill) == 1:
            return self._prefill[0]
        depths = {p.index: p.depth() for p in self._prefill}
        if self.config.prefix_aware_routing:
            floor = min(depths.values())
            fw = self._fetch_weight()
            discs = {}
            for p in self._prefill:
                # engines past the slack matter only as fetch sources
                if fw <= 0.0 and depths[p.index] > floor + self.config.depth_slack:
                    continue
                discs[p.index] = self._prefix_discounted(p, prompt_token_ids)
            best_disc = max(discs.values(), default=0.0)
            best = None
            for p in self._prefill:
                if depths[p.index] > floor + self.config.depth_slack:
                    continue
                eff = max(discs.get(p.index, 0.0), fw * best_disc)
                if eff <= 0.0:
                    continue
                cand = (eff, -depths[p.index], -p.index)
                if best is None or cand > best[0]:
                    best = (cand, p)
            if best is not None:
                return best[1]
        return min(self._prefill, key=lambda p: depths[p.index])

    # -- transfer + decode pick -----------------------------------------------

    def _pick_decode(self, handoff: KVHandoff) -> int:
        """Among engines within ``depth_slack`` of the least loaded, the one
        holding the longest prefix of the prompt; when none holds any, the
        ladder: queue depth, then the prefix peek and the hit rate."""
        scores, discounted = [], []
        for d in self._decode:
            depth = d.depth()
            peek, hit_rate, disc = 0, 0.0, 0.0
            if self.config.cache_aware_pick:
                try:
                    peek = d.engine.peek_prefix_tokens(handoff.prompt_token_ids, handoff.lora_id)
                except ValueError:
                    peek = 0  # adapter not loaded there
                lk = d.engine.prefix_lookup_tokens
                hit_rate = d.engine.prefix_hit_tokens / lk if lk else 0.0
            if self.config.prefix_aware_routing:
                disc = self._prefix_discounted(d, handoff.prompt_token_ids, handoff.lora_id)
            scores.append((depth, -peek, -hit_rate, d.index))
            discounted.append((disc, depth, d.index))
        if self.config.prefix_aware_routing:
            floor = min(depth for _, depth, _ in discounted)
            fw = self._fetch_weight()
            best_disc = max((disc for disc, _, _ in discounted), default=0.0)
            best = max(((max(disc, fw * best_disc), -depth, -i) for disc, depth, i in discounted
                        if depth <= floor + self.config.depth_slack), default=None)
            if best is not None and best[0] > 0.0:
                return -best[2]
        return min(scores)[-1]

    def _transfer_loop(self) -> None:
        """The sender thread of the transfer plane."""
        while not self._stop:
            try:
                h = self._transfer_q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self._transfer(h)
            except Exception as e:  # noqa: BLE001 — the sender must survive
                logger.exception("transfer of %r failed unexpectedly", h.request_id)
                self._transfer_failed(h, e)

    def _transfer(self, handoff: KVHandoff) -> None:
        idx = self._pick_decode(handoff)
        de = self._decode[idx]
        with self._lock:
            de.in_transit += 1
        try:
            self.connector.send(self._targets[idx], handoff,
                                timeout_s=self.config.transfer_timeout_s)
        except Exception as e:
            with self._lock:
                de.in_transit -= 1
            if not isinstance(e, KVTransferError):
                raise
            self._transfer_failed(handoff, e)
            return
        with self._lock:
            self.num_transfers += 1

    def _transfer_failed(self, handoff: KVHandoff, exc: BaseException) -> None:
        self._obs_transfer_event(handoff, error=str(exc))
        with self._lock:
            self.num_transfer_failures += 1
            rec = self._inflight.get(handoff.request_id)
            if rec is not None:
                # the seed base rides the retry: the re-prefilled request
                # continues the stream the lost handoff carried
                rec["seed_base"] = handoff.seed_base
        self._requeue(handoff.request_id, reason=f"transfer:{exc}")

    def _requeue(self, rid: str, exclude_index: Optional[int] = None, reason: str = "") -> None:
        """Re-prefill a request whose handoff (or engine) was lost, bounded
        by ``max_handoff_retries``. Its delivered tokens are restored, so
        re-admission recomputes prompt + outputs and the continuation
        extends exactly what the caller already saw."""
        with self._lock:
            rec = self._inflight.get(rid)
            if rec is None:
                return  # finished, failed or aborted meanwhile
            rec["attempts"] += 1
            attempts = rec["attempts"]
        if attempts > self.config.max_handoff_retries:
            self._fail_request(rid, KVTransferError(
                f"request {rid!r}: handoff failed {attempts} times (last: {reason}); "
                "budget exhausted"
            ))
            return
        with self._lock:
            self.num_reprefills += 1
        candidates = [p for p in self._prefill if p.index != exclude_index]
        pe = min(candidates or self._prefill, key=lambda p: p.depth())

        def readd():
            with self._lock:
                rec = self._inflight.get(rid)
                if rec is None:
                    return  # aborted before the loop got here
                tokens, seed_base = list(rec["tokens"]), rec.get("seed_base")
            try:
                pe.engine.add_request(rec["prompt_ids"], rec["sp"], request_id=rid,
                                      trace=rec["trace"])
            except Exception as e:  # noqa: BLE001
                self._fail_request(rid, e)
                return
            req = pe.engine.requests[rid]
            req.output_token_ids = tokens
            # a recompute, as after a preemption: re-matching the blocks the
            # first attempt sealed is no prefix-cache hit
            req.num_preemptions += 1
            if seed_base is not None:
                req.seed_base = seed_base

        logger.warning("re-prefilling %s on prefill engine %d (attempt %d: %s)",
                       rid, pe.index, attempts, reason)
        if not pe.post(readd, adds=1):
            self._fail_request(rid, KVTransferError(f"request {rid!r}: the prefill pool is shut down"))

    # -- decode side ----------------------------------------------------------

    def _decode_loop(self, de: _PoolEngine) -> None:
        target_id = self._target_ids[de.index]
        pending: list = []  # (handoff, deadline)
        consec_failures = 0
        try:
            while not self._stop:
                de.drain()
                eng = de.engine
                busy = eng.has_unfinished()
                # bounded receive (poll fast while decoding, park briefly
                # idle), then every handoff already here: a burst joins the
                # batch at one step boundary, one pipeline flush for all
                timeout = 0.001 if (busy or pending) else 0.05
                while (h := self.connector.recv(target_id, timeout_s=timeout)) is not None:
                    timeout = 0.0
                    t0 = time.perf_counter()
                    ok = h.verify()
                    h.timings["verify_ms"] = (time.perf_counter() - t0) * 1e3
                    if ok:
                        pending.append((h, time.time() + self.config.transfer_timeout_s))
                        continue
                    with self._lock:
                        de.in_transit -= 1
                    self._transfer_failed(h, KVTransferError(
                        f"handoff {h.request_id!r} failed its checksum on {target_id} "
                        "(corrupt in flight)"
                    ))
                if pending:
                    pending = self._try_imports(de, pending)
                if not busy:
                    continue
                try:
                    outputs = eng.step()
                except Exception as e:  # noqa: BLE001
                    if self._stop:
                        return
                    consec_failures += 1
                    if self._recover_decode(de, e, consec_failures):
                        consec_failures = 0
                    continue
                consec_failures = 0
                for out in outputs:
                    self._deliver(out)
        finally:
            de.close()

    def _recover_decode(self, de: _PoolEngine, exc: BaseException, attempt: int) -> bool:
        """The ladder, bounded: recover, then recover with a rebuilt KV cache
        and allocator, then evacuate every request through the re-prefill
        budget (a deterministic failure ends loudly, never spins). True when
        it evacuated."""
        logger.warning("decode engine %d failed: %r; recovering (attempt %d)",
                       de.index, exc, attempt)
        eng = de.engine
        if attempt <= 2:
            try:
                eng.recover(rebuild_kv=attempt == 2)
                return False
            except Exception:  # noqa: BLE001
                logger.exception("decode engine %d recover failed", de.index)
        rids = list(eng.requests)
        for rid in rids:
            try:
                eng.abort_request(rid)
            except Exception:  # noqa: BLE001
                eng.requests.pop(rid, None)
        for rid in rids:
            self._requeue(rid, reason=f"decode_death:{type(exc).__name__}")
        return True

    def _try_imports(self, de: _PoolEngine, pending: list) -> list:
        """Import received handoffs (on the decode loop). A full cache
        retries until decode frees blocks, bounded by the transfer
        deadline; then the request re-prefills."""
        still = []
        for h, deadline in pending:
            with self._lock:
                live = h.request_id in self._inflight
            if not live:
                with self._lock:
                    de.in_transit -= 1
                continue  # aborted or failed meanwhile
            t_import0 = time.time()
            try:
                de.engine.import_handoff(h)
            except NoFreeBlocksError:
                if time.time() < deadline:
                    still.append((h, deadline))
                    continue
                with self._lock:
                    de.in_transit -= 1
                self._transfer_failed(h, KVTransferError(
                    f"decode engine {de.index} had no KV room for {h.request_id!r} "
                    "within the transfer deadline"
                ))
                continue
            except Exception as e:  # noqa: BLE001 — a bad handoff
                with self._lock:
                    de.in_transit -= 1
                self._transfer_failed(h, e)
                continue
            with self._lock:
                de.in_transit -= 1
                self.handoffs.append({"request_id": h.request_id, "decode_engine": de.index,
                                      "kv_tokens": h.num_kv_tokens, "bytes": h.nbytes,
                                      **h.timings})
            self._obs_transfer_span(h, de.index, t_import0, time.time())
        return still

    # -- observability ----------------------------------------------------------

    def _obs_transfer_span(self, h: KVHandoff, decode_index: int,
                           t_import0: float, t_done: float) -> None:
        """``llm.kv_transfer``: prefill-span end -> import complete, between
        ``engine.prefill`` and the first decode round."""
        try:
            obs.get_recorder().record(
                "llm.kv_transfer", min(h.t_export, t_done), t_done,
                ctx=TraceContext.from_dict(h.trace),
                attrs={
                    "request_id": h.request_id,
                    "backend": self.connector.name,
                    "decode_engine": decode_index,
                    "kv_tokens": h.num_kv_tokens,
                    "bytes": h.nbytes,
                    "import_ms": round((t_done - t_import0) * 1e3, 3),
                },
            )
            slo.record_kv_transfer(self.model_tag, self.connector.name,
                                   seconds=max(0.0, t_done - h.t_export), nbytes=h.nbytes)
        except Exception:  # noqa: BLE001 — tracing must not break serving
            pass

    def _obs_transfer_event(self, h: KVHandoff, error: str) -> None:
        try:
            now = time.time()
            obs.get_recorder().record(
                "llm.kv_transfer_failed", now, now, ctx=TraceContext.from_dict(h.trace),
                attrs={"request_id": h.request_id, "error": error[:200],
                       "backend": self.connector.name},
                status="error",
            )
        except Exception:  # noqa: BLE001
            pass
