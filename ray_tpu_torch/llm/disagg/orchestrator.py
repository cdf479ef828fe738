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

The transfer plane is chosen per (prefill engine, decode engine) edge
(``ray_tpu_torch/fabric``): the topology (``DisaggConfig.fabric``, a
``FabricTopology`` or its dict; by default one shared slice when the
primary connector is ``"device"``, distinct slices otherwise) says which
pools share a device mesh. A device edge exports the pages as device
tensors sealed on the device (``export_request(keep_on_device=True)``),
ships them by reference through ``DeviceKVConnector`` to an endpoint at the
decode engine's ``kv_cache_device()``, and the decode engine verifies them
on the device and scatters them in place: no handoff byte is staged
through host memory. Under a device primary an RPC connector stays warm as
the fallback plane: a device-transfer fault (dropped, or caught corrupt by
the device checksum) degrades that one edge to RPC (``to_host()``, pickled
over loopback TCP, CRC'd), counted once, and the request re-prefills under
the budget; the pool-level topology is marked only when no device edge is
left. ``stats()["fabric"]`` shows the edges, the transfers by backend, the
fallbacks and the topology, as the reference's does.

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
    # the fabric topology (fabric.FabricTopology or its dict): which slice
    # each pool is pinned to and which pool pairs share a device mesh. The
    # orchestrator consults it per (prefill -> decode) edge: device-direct
    # where meshes are shared, RPC elsewhere, a device fault degrades that
    # edge to RPC under the re-prefill budget. None with connector="device"
    # assumes one shared slice (one card, or one peer-to-peer domain).
    fabric: Any = None

    def __post_init__(self):
        if isinstance(self.engine, dict):
            self.engine = EngineConfig(**self.engine)
        if self.num_prefill < 1 or self.num_decode < 1:
            raise ValueError("num_prefill and num_decode must be >= 1")
        if self.connector not in _INPROC + ("rpc", "device"):
            raise ValueError(f"unknown KV connector {self.connector!r}; one of: inproc, rpc, "
                             "device")


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
        self._lock = threading.Lock()
        self._init_fabric(config, connector)
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

    def _init_fabric(self, config: DisaggConfig, connector: Optional[KVConnector]) -> None:
        """The topology, the transfer planes, each edge's backend and each
        plane's targets."""
        from ray_tpu_torch.fabric.topology import FabricTopology

        # the EFFECTIVE primary plane: an injected connector outranks
        # config.connector (which may sit at its "inproc" default), and the
        # degenerate topology keys on it too, or an injected device plane
        # would route every edge over the RPC fallback
        self._primary = connector.name if connector is not None else (
            "inproc" if config.connector in _INPROC else config.connector)
        topo = config.fabric
        if isinstance(topo, dict):
            topo = FabricTopology.from_dict(topo)
        if topo is None:
            # a device primary with no map assumes one shared slice; the host
            # planes get distinct slices, so the map says "no shared mesh"
            topo = FabricTopology()
            topo.add_pool("prefill", "prefill", "slice0", config.num_prefill)
            topo.add_pool("decode", "decode",
                          "slice0" if self._primary == "device" else "slice1", config.num_decode)
        self.topology = topo
        self._prefill_pool = topo.pool_of_role("prefill") or "prefill"
        self._decode_pool = topo.pool_of_role("decode") or "decode"
        self.connectors: dict[str, KVConnector] = {
            self._primary: connector if connector is not None
            else self._build_connector(self._primary)}
        if self._primary == "device":
            # the RPC fallback stays warm: a faulted device edge degrades to
            # it instead of retrying a broken device path
            self.connectors.setdefault("rpc", self._build_connector("rpc"))
            pool_edge = topo.edge_backend(self._prefill_pool, self._decode_pool)
            # an override may name a plane not built yet (an explicit
            # "inproc" edge): build it, or that edge's sends would fail
            if pool_edge not in self.connectors:
                self.connectors[pool_edge] = self._build_connector(pool_edge)
        else:
            pool_edge = self._primary
        # the primary plane, as stats() and the tests address it
        self.connector = self.connectors[self._primary]
        # (prefill engine, decode engine) -> backend; device edges exist only
        # under a device primary whose topology shares the mesh, and each
        # degrades on its own
        self._edge_backend: dict[tuple, str] = {
            (p.index, d.index): pool_edge for p in self._prefill for d in self._decode}
        self.num_fallbacks = 0
        self.transfers_by_backend: dict[str, int] = {}
        self._target_ids = [f"{self.model_tag}-decode{i}" for i in range(config.num_decode)]
        self._targets: dict[str, list] = {}
        for name, conn in self.connectors.items():
            if name == "device":
                # the endpoint is the decode engine's own cache device, so the
                # transport's move is the final hop (a no-op on one card)
                self._targets[name] = [
                    conn.register_target(t, device=d.engine.kv_cache_device())
                    for t, d in zip(self._target_ids, self._decode)]
            else:
                self._targets[name] = [conn.register_target(t) for t in self._target_ids]
        self._update_fabric_gauges()

    def _build_connector(self, kind: str) -> KVConnector:
        if kind == "inproc":
            return InProcessConnector(namespace=self._ns)
        if kind == "device":
            from ray_tpu_torch.fabric.device_connector import DeviceKVConnector
            from ray_tpu_torch.fabric.transport import DeviceTransport

            devices = [d.engine.kv_cache_device() for d in self._decode]
            return DeviceKVConnector(transport=DeviceTransport(namespace=self._ns, devices=devices))
        return make_connector(kind)

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
        the transfer planes' counts (``connector`` names the primary, the
        totals span every plane), the fabric's edges, and the pools' prefix
        cache."""
        pre = [p.call(p.engine.stats) for p in self._prefill]
        dec = [d.call(d.engine.stats) for d in self._decode]
        hit = sum(s["prefix_cache"]["hit_tokens"] for s in pre + dec)
        lookup = sum(s["prefix_cache"]["lookup_tokens"] for s in pre + dec)
        xfer = self.connector.stats()
        if len(self.connectors) > 1:
            snaps = [c.stats() for c in self.connectors.values()]
            for field in ("num_sent", "num_received", "num_dropped", "bytes_sent"):
                xfer[field] = sum(s.get(field, 0) for s in snaps)
        with self._lock:
            transfer = {
                **xfer,
                "kv_transfers": self.num_transfers,
                "reprefills": self.num_reprefills,
                "transfer_failures": self.num_transfer_failures,
            }
            done = list(self.handoffs)
            fabric = {
                "edges": [{"src": f"prefill{s}", "dst": f"decode{d}", "backend": b}
                          for (s, d), b in sorted(self._edge_backend.items())],
                "backends": dict(self.transfers_by_backend),
                "fallbacks": self.num_fallbacks,
            }
        fabric["topology"] = self.topology.to_dict()
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
            "fabric": fabric,
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
        for conn in self.connectors.values():
            conn.close()
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
                # device-resident export when any edge out of this engine is
                # device-direct (an RPC edge picked later calls to_host())
                with self._lock:
                    export_dev = any(self._edge_backend.get((pe.index, d.index)) == "device"
                                     for d in self._decode)
                try:
                    outputs = eng.step()
                    # a prompt complete after this step is exported before it
                    # ever decodes; a row still mid-prompt in a mixed batch
                    # stays and finishes its prompt in later mixed steps (the
                    # DisaggConfig docstring's divergence)
                    for req in list(eng.running):
                        if req.request_id in eng._mixed_prefills:
                            continue
                        h = eng.export_request(req.request_id, keep_on_device=export_dev)
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
        src = handoff.src_engine if handoff.src_engine is not None else 0
        with self._lock:
            backend = self._edge_backend.get((src, idx), self._primary)
            de.in_transit += 1
        try:
            if backend != "device":
                # a host edge (or a degraded device edge): the pickling
                # planes take CPU pages, CRC-sealed
                handoff = handoff.to_host()
            self.connectors[backend].send(self._targets[backend][idx], handoff,
                                          timeout_s=self.config.transfer_timeout_s)
        except Exception as e:
            with self._lock:
                de.in_transit -= 1
            if not isinstance(e, KVTransferError):
                raise
            self._transfer_failed(handoff, e, backend=backend, edge=(src, idx))
            return
        with self._lock:
            self.num_transfers += 1
            self.transfers_by_backend[backend] = self.transfers_by_backend.get(backend, 0) + 1

    def _fallback_edge(self, edge: tuple, reason: str) -> None:
        """Degrade one faulted device edge to its RPC fallback (counted once
        per edge); later transfers on it, this request's re-prefill
        included, ride the wire."""
        src, dst = edge
        with self._lock:
            if self._edge_backend.get((src, dst)) != "device":
                return
            self._edge_backend[(src, dst)] = "rpc"
            self.num_fallbacks += 1
            # the pool-level topology degrades only when NO engine edge
            # between the pools still rides the device plane; otherwise its
            # edges would contradict the per-engine edge list
            pool_degraded = all(b != "device" for b in self._edge_backend.values())
        if pool_degraded:
            self.topology.mark_fallback(self._prefill_pool, self._decode_pool, reason)
        logger.warning("fabric edge prefill%d->decode%d degraded to rpc (%s)", src, dst,
                       reason[:120])
        try:
            from ray_tpu_torch.fabric import metrics as fabric_metrics

            fabric_metrics.transfer_fallbacks_counter().inc(
                1, tags={"model": self.model_tag, "edge": f"prefill{src}->decode{dst}"})
        except Exception:  # noqa: BLE001 — observability never breaks serving
            pass
        self._update_fabric_gauges()

    def _update_fabric_gauges(self) -> None:
        try:
            from ray_tpu_torch.fabric import metrics as fabric_metrics

            g = fabric_metrics.edges_active_gauge()
            with self._lock:
                counts: dict[str, int] = {}
                for b in self._edge_backend.values():
                    counts[b] = counts.get(b, 0) + 1
            for b in ("device", "rpc", "inproc"):
                if counts.get(b) or b == self._primary:
                    g.set(counts.get(b, 0), tags={"model": self.model_tag, "backend": b})
        except Exception:  # noqa: BLE001
            pass

    def _transfer_failed(self, handoff: KVHandoff, exc: BaseException,
                         backend: Optional[str] = None, edge: Optional[tuple] = None) -> None:
        self._obs_transfer_event(handoff, error=str(exc), backend=backend)
        if backend == "device" and edge is not None:
            self._fallback_edge(edge, reason=f"{type(exc).__name__}: {exc}")
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
        pending: list = []  # (handoff, deadline, the backend that delivered it)
        consec_failures = 0
        conns = list(self.connectors.items())
        try:
            while not self._stop:
                de.drain()
                eng = de.engine
                busy = eng.has_unfinished()
                # bounded receive across every plane (poll fast while
                # decoding, park briefly idle), then every handoff already
                # here: a burst joins the batch at one step boundary, one
                # pipeline flush for all. A device handoff verifies on the
                # device: two reductions and two 4-byte reads
                timeout = (0.001 if (busy or pending) else 0.05) / len(conns)
                for backend, conn in conns:
                    while (h := conn.recv(target_id, timeout_s=timeout)) is not None:
                        timeout = 0.0
                        t0 = time.perf_counter()
                        ok = h.verify()
                        h.timings["verify_ms"] = (time.perf_counter() - t0) * 1e3
                        if ok:
                            pending.append((h, time.time() + self.config.transfer_timeout_s,
                                            backend))
                            continue
                        with self._lock:
                            de.in_transit -= 1
                        edge = (h.src_engine, de.index) if h.src_engine is not None else None
                        self._transfer_failed(h, KVTransferError(
                            f"handoff {h.request_id!r} failed its checksum on {target_id} "
                            "(corrupt in flight)"
                        ), backend=backend, edge=edge)
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
        for h, deadline, backend in pending:
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
                    still.append((h, deadline, backend))
                    continue
                with self._lock:
                    de.in_transit -= 1
                self._transfer_failed(h, KVTransferError(
                    f"decode engine {de.index} had no KV room for {h.request_id!r} "
                    "within the transfer deadline"
                ), backend=backend)
                continue
            except Exception as e:  # noqa: BLE001 — a bad handoff
                with self._lock:
                    de.in_transit -= 1
                self._transfer_failed(h, e, backend=backend)
                continue
            with self._lock:
                de.in_transit -= 1
                self.handoffs.append({"request_id": h.request_id, "decode_engine": de.index,
                                      "backend": backend, "kv_tokens": h.num_kv_tokens,
                                      "bytes": h.nbytes, **h.timings})
            self._obs_transfer_span(h, de.index, t_import0, time.time(), backend=backend)
        return still

    # -- observability ----------------------------------------------------------

    def _obs_transfer_span(self, h: KVHandoff, decode_index: int,
                           t_import0: float, t_done: float, backend: Optional[str] = None) -> None:
        """``llm.kv_transfer``: prefill-span end -> import complete, between
        ``engine.prefill`` and the first decode round, labelled by the plane
        that carried it."""
        backend = backend or self._primary
        try:
            obs.get_recorder().record(
                "llm.kv_transfer", min(h.t_export, t_done), t_done,
                ctx=TraceContext.from_dict(h.trace),
                attrs={
                    "request_id": h.request_id,
                    "backend": backend,
                    "decode_engine": decode_index,
                    "kv_tokens": h.num_kv_tokens,
                    "bytes": h.nbytes,
                    "import_ms": round((t_done - t_import0) * 1e3, 3),
                },
            )
            slo.record_kv_transfer(self.model_tag, backend,
                                   seconds=max(0.0, t_done - h.t_export), nbytes=h.nbytes)
        except Exception:  # noqa: BLE001 — tracing must not break serving
            pass

    def _obs_transfer_event(self, h: KVHandoff, error: str, backend: Optional[str] = None) -> None:
        try:
            now = time.time()
            obs.get_recorder().record(
                "llm.kv_transfer_failed", now, now, ctx=TraceContext.from_dict(h.trace),
                attrs={"request_id": h.request_id, "error": error[:200],
                       "backend": backend or self._primary},
                status="error",
            )
        except Exception:  # noqa: BLE001
            pass
