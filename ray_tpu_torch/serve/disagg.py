"""Disaggregated prefill/decode serving as Serve deployments (counterpart
of ``ray_tpu/serve/disagg.py``).

The multi-deployment variant of ``ray_tpu_torch.llm.disagg``: prefill and
decode engines live in SEPARATE deployments (role-tagged "prefill" /
"decode"), scaled and health-checked independently by the Serve
controller, with the ingress reusing the colocated app's serving machinery:

 * new requests go to the prefill pool through an ordinary
   power-of-two-choices dispatch (replica death before the handoff is
   retried by the handle's system_retries failover: the prefill call is
   idempotent, same completion id, nothing delivered yet);
 * the exported KV ships over the app's ``KVConnector`` to a decode
   replica the ingress picks with queue-depth + prefix-cache-hit-rate
   awareness (decode stats are polled with a short TTL);
 * the decode-side wait is PINNED (``options(pin_replica=...)``): an
   imported KV sequence lives on exactly one replica, so a dead pin
   surfaces as ``ReplicaPinError`` and the ingress re-prefills under a
   bounded budget instead of silently landing on a replica without the
   state;
 * admission control (llm/admission.py) sheds load at the ingress exactly
   as the colocated OpenAI app does.

Each engine is stepped by one loop thread of its replica, and only that
thread touches it (CUDA graphs and the current stream are per thread):
``PrefillServer.prefill`` posts the request to its loop and waits for the
first token and the export, where the reference steps the engine from
whichever replica thread calls it, under a lock. The prefill loop exports
only rows whose prompt is complete: a row still mid-prompt in a mixed
batch stays and finishes its prompt in later steps, where the reference
exports every running row and ``export_request`` refuses the mid-prompt
one (ROADMAP.md Queue 3, "Mixed-batch prefill in disaggregated serving").

On one card the connector is ``"device"`` (the decode replica registers
its endpoint on its KV cache's device); on a cluster, where replicas are
separate processes, it is ``"rpc"``, and the ingress can take an injected
``index=GcsPrefixIndex(...)``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
import uuid
from typing import Any, Callable, Optional

from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("ray_tpu_torch.serve.disagg")


def _is_transfer_failure(exc: BaseException) -> bool:
    """Is this (or anything in its cause chain) a transfer-plane loss, a
    lost/corrupt handoff, a dead pinned replica or one that refused the call
    because its drain had begun? Matched by type name because user
    exceptions cross the actor plane wrapped in TaskError/ClusterTaskError
    with the original as `.cause`."""
    names = {"KVTransferError", "ReplicaPinError", "ActorUnavailableError"}
    seen: set = set()
    stack: list = [exc]
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        if type(e).__name__ in names:
            return True
        stack.append(getattr(e, "cause", None))
        stack.append(e.__cause__)
    return False


def _build_engine(llm_config):
    from ray_tpu_torch.llm.engine import LLMEngine

    return LLMEngine(llm_config.engine, params=llm_config.params, seed=llm_config.seed,
                     device=llm_config.device)


def _make_connector(kind: str, namespace: str):
    from ray_tpu_torch.llm.disagg.connector import make_connector

    if kind in ("inproc", "in_process", "inprocess", "device"):
        # namespaced planes: replicas of one app share endpoints through
        # the process-global maps without cross-delivering another app's
        return make_connector(kind, namespace=namespace)
    return make_connector(kind)


def _attach_tiers(engine, key: str, namespace: str) -> None:
    """Prefix-aware routing and cross-engine resurrection (llm/kvtier,
    llm/kvfetch): publish this replica's resident chains into the app's
    prefix index under ``key``, SERVE its spilled blocks to the app's
    other replicas and PULL prefixes the ingress routed here."""
    if engine.kvtier is None:
        return
    from ray_tpu_torch.llm.kvfetch import LocalFetchClient, get_local_fetch_registry
    from ray_tpu_torch.llm.kvtier import get_local_index

    engine.kvtier.attach_index(get_local_index(namespace), engine_key=key)
    registry = get_local_fetch_registry(namespace)
    registry.register(key, engine.kvtier)
    if engine.kvfetch is not None:
        engine.kvfetch.attach(LocalFetchClient(registry))


class _EngineLoop:
    """The one thread that touches a replica's engine: it runs posted
    callables at every step boundary, then ``step_fn`` (which returns True
    when it did work; the loop idles ``idle_s`` otherwise)."""

    def __init__(self, step_fn: Callable[[], bool], name: str, idle_s: float = 0.05):
        self._step_fn = step_fn
        self._idle_s = idle_s
        self._inbox: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def post(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if self._stop:
                raise RuntimeError(f"{self.thread.name}: engine loop stopped")
            self._inbox.append(fn)
        self._wake.set()

    def call(self, fn: Callable[[], Any], timeout_s: float = 60.0) -> Any:
        """``fn()`` run on the loop thread between two steps (here, once the
        loop has ended: nothing steps the engine any more)."""
        if threading.current_thread() is self.thread or not self.thread.is_alive():
            return fn()
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — the caller's error
                fut.set_exception(e)

        self.post(run)
        return fut.result(timeout=timeout_s)

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._inbox:
                    return
                fn = self._inbox.popleft()
            fn()

    def _run(self) -> None:
        while not self._stop:
            self._drain()
            if not self._step_fn():
                self._wake.wait(timeout=self._idle_s)
                self._wake.clear()
        self._drain()

    def stop(self, timeout_s: float = 30.0) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        self.thread.join(timeout=timeout_s)


class PrefillServer:
    """One prefill-role engine per replica: admission + prefill + first
    token, then export + send; it never decodes."""

    def __init__(self, llm_config, connector_kind: str = "inproc",
                 namespace: str = "disagg"):
        self.engine = _build_engine(llm_config)
        self.engine.model_tag = f"{llm_config.model_id}-prefill"
        # a stable key the ingress maps back to a replica id
        self._index_key = f"prefill-{uuid.uuid4().hex[:12]}"
        _attach_tiers(self.engine, self._index_key, namespace)
        self.connector = _make_connector(connector_kind, namespace)
        # device plane: export device-resident + device-sealed, so the
        # pages go gather -> device move without ever staging through
        # host memory (and without a host CRC + device reseal round trip)
        self._export_dev = getattr(self.connector, "name", "") == "device"
        # loop-thread state: rid -> the caller's future, and the outputs
        # and exports of this step not yet handed to a waiter
        self._waiters: dict[str, concurrent.futures.Future] = {}
        self._outs: dict[str, Any] = {}
        self._handoffs: dict[str, Any] = {}
        self._loop = _EngineLoop(self._step, name=f"disagg-{self._index_key}")

    def _step(self) -> bool:
        eng = self.engine
        if not eng.has_unfinished():
            return False
        try:
            for out in eng.step():
                self._outs[out.request_id] = out
            # a prompt complete after this step is exported before it ever
            # decodes; a row still mid-prompt in a mixed batch stays and
            # finishes its prompt in later steps
            for r in list(eng.running):
                if r.request_id in eng._mixed_prefills:
                    continue
                self._handoffs[r.request_id] = eng.export_request(
                    r.request_id, keep_on_device=self._export_dev)
        except Exception as e:  # noqa: BLE001 — fail the callers, not the loop
            logger.exception("prefill engine step failed")
            for rid, fut in list(self._waiters.items()):
                try:
                    eng.abort_request(rid)
                except Exception:  # noqa: BLE001
                    pass
                fut.set_exception(e)
            self._waiters.clear()
            self._outs.clear()
            self._handoffs.clear()
            return True
        for rid in [r for r in self._waiters if r in self._outs]:
            self._waiters.pop(rid).set_result(
                (self._outs.pop(rid), self._handoffs.pop(rid, None)))
        if not eng.has_unfinished():
            for rid, fut in list(self._waiters.items()):
                fut.set_exception(RuntimeError(
                    f"request {rid!r} vanished from the prefill engine without an output"))
            self._waiters.clear()
        return True

    def prefill(self, prompt_ids: list, sampling: dict, request_id: str,
                target: Any) -> dict:
        """Prefill one request and ship its KV to ``target``. Returns the
        first sampled token(s); raises KVTransferError when the handoff
        was lost (the ingress re-prefills, same completion id)."""
        from ray_tpu_torch import obs
        from ray_tpu_torch.llm.sampling import SamplingParams

        sp = SamplingParams(**sampling)
        trace = obs.current()
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def add():
            try:
                self.engine.add_request(list(prompt_ids), sp, request_id=request_id,
                                        trace=trace)
            except Exception as e:  # noqa: BLE001 — the caller's error
                fut.set_exception(e)
                return
            self._waiters[request_id] = fut

        self._loop.post(add)
        try:
            out, handoff = fut.result(timeout=120.0)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(f"prefill of {request_id!r} timed out") from None
        if handoff is not None:
            # KVTransferError propagates to the ingress as a user
            # exception, deliberately: transfer loss is NOT a replica
            # death, the handle must not blind-retry it (the ingress owns
            # the budgeted re-prefill)
            self.connector.send(target, handoff)
        return {
            "token_ids": list(out.output_token_ids),
            "finished": out.finished,
            "finish_reason": out.finish_reason,
            "handed_off": handoff is not None,
        }

    def index_key(self) -> str:
        """This replica's key in the app's prefix index (the ingress
        reverse-maps lookup winners onto replica ids)."""
        return self._index_key

    def stats(self) -> dict:
        return {**self._loop.call(self.engine.stats), "connector": self.connector.stats()}

    def shutdown(self):
        """Stop the loop, then free the engine's device memory (its KV
        cache and captured graphs; the weights are the caller's)."""
        self._loop.stop()
        self.connector.close()
        if not self._loop.thread.is_alive():
            self.engine.release()


class DecodeServer:
    """One decode-role engine per replica: imports handoffs from its
    connector target and runs pure decode rounds on a loop thread."""

    POLL_S = 0.02

    def __init__(self, llm_config, connector_kind: str = "inproc",
                 namespace: str = "disagg"):
        self.engine = _build_engine(llm_config)
        self.engine.model_tag = f"{llm_config.model_id}-decode"
        self.connector = _make_connector(connector_kind, namespace)
        self._target_id = f"decode-{uuid.uuid4().hex[:12]}"
        _attach_tiers(self.engine, self._target_id, namespace)
        if getattr(self.connector, "name", "") == "device":
            # device plane: pin the endpoint to this engine's KV-cache
            # device so the sender's move IS the final hop
            self._target = self.connector.register_target(
                self._target_id, device=self.engine.kv_cache_device())
        else:
            self._target = self.connector.register_target(self._target_id)
        self._lock = threading.Lock()  # guards _done and _failed only
        self._done: dict[str, Any] = {}     # rid -> final RequestOutput
        self._failed: dict[str, str] = {}   # rid -> reason (corrupt/no room)
        # the loop idles in connector.recv, so it needs no idle wait
        self._loop = _EngineLoop(self._step, name=f"disagg-{self._target_id}", idle_s=0.0)

    # -- control plane --------------------------------------------------------

    def kv_target(self) -> Any:
        """Opaque connector address of THIS replica (the ingress maps
        replica_id -> target for pinned KV-affinity dispatch)."""
        return self._target

    def index_key(self) -> str:
        """This replica's key in the app's prefix index (same id the kv
        target rides, so one poll covers both)."""
        return self._target_id

    def stats(self) -> dict:
        s = self._loop.call(self.engine.stats)
        s["connector"] = self.connector.stats()
        return s

    # -- data plane -----------------------------------------------------------

    def _step(self) -> bool:
        from ray_tpu_torch.llm.kv_cache import NoFreeBlocksError

        busy = self.engine.has_unfinished()
        h = self.connector.recv(self._target_id, timeout_s=0.001 if busy else self.POLL_S)
        if h is not None:
            fail = None
            if not h.verify():
                fail = "checksum failed (corrupt)"
            else:
                try:
                    self.engine.import_handoff(h)
                except NoFreeBlocksError:
                    fail = "no KV room"
                except Exception as e:  # noqa: BLE001
                    fail = f"import failed: {e}"
            if fail is not None:
                with self._lock:
                    self._failed[h.request_id] = fail
        if busy:
            try:
                finished = [out for out in self.engine.step() if out.finished]
                with self._lock:
                    for out in finished:
                        self._done[out.request_id] = out
            except Exception:  # noqa: BLE001
                logger.exception("decode engine step failed; recovering")
                try:
                    self.engine.recover()
                except Exception:  # noqa: BLE001
                    logger.exception("decode engine unrecoverable")
        return True

    def wait_finish(self, request_id: str, timeout_s: float = 120.0) -> dict:
        """Block until ``request_id`` (imported via a prior handoff to this
        replica) finishes; bounded: a handoff that never arrived fails the
        wait instead of hanging the ingress."""
        from ray_tpu_torch.llm.disagg.connector import KVTransferError

        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                out = self._done.pop(request_id, None)
                fail = self._failed.pop(request_id, None)
            if fail is not None:
                raise KVTransferError(
                    f"handoff of {request_id!r} unusable on this replica: {fail}")
            if out is not None:
                return {
                    "token_ids": list(out.output_token_ids),
                    "finish_reason": out.finish_reason,
                    "num_cached_tokens": out.num_cached_tokens,
                }
            time.sleep(0.005)
        raise KVTransferError(
            f"request {request_id!r} did not finish on this replica within "
            f"{timeout_s}s (handoff lost?)")

    def shutdown(self):
        """Stop the loop, then free the engine's device memory."""
        self._loop.stop()
        self.connector.close()
        if not self._loop.thread.is_alive():
            self.engine.release()


class DisaggIngress:
    """OpenAI-style ingress over the two pools (reference shape:
    llm/openai_api.LLMServer, minus streaming)."""

    STATS_TTL_S = 0.5
    MAX_RETRIES = 2

    def __init__(self, llm_config, prefill_handle, decode_handle,
                 namespace: str = "disagg", index=None):
        from ray_tpu_torch.llm.admission import AdmissionConfig, AdmissionController
        from ray_tpu_torch.llm.openai_api import ByteTokenizer

        self.config = llm_config
        self.tokenizer = llm_config.tokenizer or ByteTokenizer(
            llm_config.engine.model.vocab_size)
        self.prefill_handle = prefill_handle
        self.decode_handle = decode_handle
        # prefix-aware routing (llm/kvtier): the index the pool replicas
        # publish their resident chains into. In-process serving shares the
        # app-namespaced LocalPrefixIndex; a cluster deployment injects a
        # GcsPrefixIndex. Either way a dark/stale index makes the picks
        # below degrade to the queue-depth/p2c ladder (no hang, no
        # wrong-replica pin).
        self.index = index
        if self.index is None and llm_config.engine.kvtier is not None:
            from ray_tpu_torch.llm.kvtier import get_local_index

            self.index = get_local_index(namespace)
        acfg = llm_config.admission
        if isinstance(acfg, dict):
            acfg = AdmissionConfig(**acfg)
        self.admission = AdmissionController(acfg or AdmissionConfig(),
                                             model_tag=llm_config.model_id)
        self._lock = threading.Lock()
        self._targets: dict[str, Any] = {}   # decode replica_id -> kv target
        self._stats: dict[str, dict] = {}    # decode replica_id -> stats
        self._stats_at = 0.0
        # replica_id -> prefix-index key, per pool (polled with the same
        # TTL discipline as targets/stats)
        self._decode_keys: dict[str, str] = {}
        self._prefill_keys: dict[str, str] = {}
        self._prefill_at = 0.0
        self.num_reprefills = 0
        self.num_prefix_routed = 0

    # -- decode-pool discovery + pick -----------------------------------------

    def _decode_router(self):
        return self.decode_handle._get_router()

    def _refresh_decode(self) -> list[str]:
        """Poll decode replica ids, kv targets, and stats with a TTL."""
        rids = self._decode_router().replica_ids()
        now = time.time()
        with self._lock:
            fresh = now - self._stats_at < self.STATS_TTL_S
            known = set(self._targets)
        if fresh and known >= set(rids):
            return rids
        # fire every poll before collecting any: the waits overlap, so a
        # hung (not yet evicted) replica costs one timeout window, not one
        # per replica, on the request path that called us
        target_futs, stat_futs, key_futs = {}, {}, {}
        for rid in rids:
            try:
                pinned = self.decode_handle.options(pin_replica=rid)
                if rid not in known:
                    target_futs[rid] = pinned.kv_target.remote()
                    if self.index is not None:
                        key_futs[rid] = pinned.index_key.remote()
                stat_futs[rid] = pinned.stats.remote()
            except Exception:  # noqa: BLE001 — replica racing startup/death
                continue
        for rid, fut in target_futs.items():
            try:
                target = fut.result(timeout_s=10)
            except Exception:  # noqa: BLE001
                continue
            with self._lock:
                self._targets[rid] = target
        for rid, fut in key_futs.items():
            try:
                key = fut.result(timeout_s=10)
            except Exception:  # noqa: BLE001
                continue
            with self._lock:
                self._decode_keys[rid] = key
        stats = {}
        for rid, fut in stat_futs.items():
            try:
                stats[rid] = fut.result(timeout_s=10)
            except Exception:  # noqa: BLE001
                continue
        with self._lock:
            self._stats = stats
            self._stats_at = now
            for rid in set(self._targets) - set(rids):
                self._targets.pop(rid, None)
                self._decode_keys.pop(rid, None)
        return rids

    def _refresh_prefill(self) -> dict:
        """Prefill replica_id -> index key, with the same TTL (the prefer
        hint needs a replica id, the index speaks in keys)."""
        if self.index is None:
            return {}
        now = time.time()
        with self._lock:
            if now - self._prefill_at < self.STATS_TTL_S and self._prefill_keys:
                return dict(self._prefill_keys)
            known = dict(self._prefill_keys)
        try:
            rids = self.prefill_handle._get_router().replica_ids()
        except Exception:  # noqa: BLE001 — controller refresh racing death
            return {}
        futs = {}
        for rid in rids:
            if rid in known:
                continue
            try:
                futs[rid] = self.prefill_handle.options(pin_replica=rid).index_key.remote()
            except Exception:  # noqa: BLE001
                continue
        for rid, fut in futs.items():
            try:
                known[rid] = fut.result(timeout_s=10)
            except Exception:  # noqa: BLE001
                continue
        with self._lock:
            self._prefill_keys = {r: k for r, k in known.items() if r in rids}
            self._prefill_at = now
            return dict(self._prefill_keys)

    def _prefix_hashes(self, prompt_ids: list) -> list:
        from ray_tpu_torch.llm.kvtier import chain_hashes

        return chain_hashes(prompt_ids, self.config.engine.block_size)

    def _index_lookup(self, prompt_ids: list):
        """ONE index lookup per attempt, shared by the prefill prefer and
        the decode pick (hashing the prompt and hitting the index, two
        RPCs on the GCS-backed path, must not happen twice per request).
        None = index off/dark = no information."""
        if self.index is None:
            return None
        try:
            return self.index.lookup(self._prefix_hashes(prompt_ids))
        except Exception:  # noqa: BLE001 — dark index = no information
            return None

    def _fetch_weight(self) -> float:
        """The fetch-cost discount the app's engines route with (0.0 when
        the tiered cache or prefetch plane is off)."""
        kvt = self.config.engine.kvtier
        if kvt is None or not kvt.prefetch:
            return 0.0
        return float(kvt.fetch_weight)

    def _prefer_prefill(self, lookup):
        """Prefill replica already holding this prompt's longest
        tier-discounted prefix, or None (-> plain p2c). Deliberately NO
        fetch-cost discount here: the ingress has no prefill queue depths
        (every candidate scores depth 0), so a fetch score would tie EVERY
        replica and pin all no-holder traffic to one fixed id; None keeps
        those requests on the router's p2c ladder, and whichever replica
        wins still prefetches via its own engine."""
        if lookup is None:
            return None
        from ray_tpu_torch.llm.kvtier.index import best_prefix_replica

        keys = self._refresh_prefill()
        if not keys:
            return None
        got = best_prefix_replica(lookup, {rid: 0 for rid in keys}, key_of=keys)
        if got is not None:
            with self._lock:
                self.num_prefix_routed += 1
        return got

    def _pick_decode(self, lookup=None) -> tuple[str, Any]:
        """Prefix-aware first (the replica already holding this prompt's
        longest tier-discounted prefix, via the app's prefix index, bounded
        by depth slack), then the ladder (queue depth with prefix-cache hit
        rate as tiebreak) whenever the index is dark, stale, or holds
        nothing for this prompt. The Serve-mode mirror of
        DisaggOrchestrator._pick_decode."""
        from ray_tpu_torch.serve.router import ReplicaPinError

        rids = self._refresh_decode()
        with self._lock:
            scored = []
            depths = {}
            for rid in rids:
                if rid not in self._targets:
                    continue
                s = self._stats.get(rid, {})
                depth = s.get("num_waiting", 0) + s.get("num_running", 0)
                hit = s.get("prefix_cache", {}).get("hit_rate", 0.0)
                depths[rid] = depth
                scored.append((depth, -hit, rid))
            if not scored:
                raise ReplicaPinError("no decode replicas available")
            key_of = dict(self._decode_keys)
        if lookup is not None and key_of:
            from ray_tpu_torch.llm.kvtier.index import best_prefix_replica

            got = best_prefix_replica(lookup, depths, key_of=key_of,
                                      fetch_weight=self._fetch_weight())
            if got is not None:
                with self._lock:
                    target = self._targets.get(got)
                    if target is not None:
                        self.num_prefix_routed += 1
                        return got, target
        with self._lock:
            _, _, rid = min(scored)
            return rid, self._targets[rid]

    # -- request path ---------------------------------------------------------

    def _sampling_from_body(self, body: dict) -> dict:
        return {
            "max_tokens": int(body.get("max_tokens", 64)),
            "temperature": float(body.get("temperature", 1.0)),
            "top_k": int(body.get("top_k", 0)),
            "top_p": float(body.get("top_p", 1.0)),
            "seed": body.get("seed"),
            "logprobs": bool(body.get("logprobs", False)),
        }

    def _generate(self, prompt_ids: list, sampling: dict, rid: str) -> dict:
        """prefill -> handoff -> pinned decode wait, with the bounded
        re-prefill ladder on any transfer-plane loss."""
        last: Optional[BaseException] = None
        for attempt in range(self.MAX_RETRIES + 1):
            if attempt > 0:
                with self._lock:
                    self.num_reprefills += 1
            try:
                lookup = self._index_lookup(prompt_ids)
                decode_rid, target = self._pick_decode(lookup)
                prefill_handle = self.prefill_handle
                prefer = self._prefer_prefill(lookup)
                if prefer is not None:
                    # soft prefix affinity: the handle's router honors it
                    # only while the replica is healthy and not overloaded
                    prefill_handle = prefill_handle.options(prefer_replica=prefer)
                pre = prefill_handle.prefill.remote(
                    prompt_ids, sampling, rid, target).result(timeout_s=180)
                if pre["finished"]:
                    return {"token_ids": pre["token_ids"],
                            "finish_reason": pre["finish_reason"]}
                return self.decode_handle.options(
                    pin_replica=decode_rid).wait_finish.remote(rid).result(timeout_s=180)
            except BaseException as e:  # noqa: BLE001 — filtered below
                if not _is_transfer_failure(e):
                    raise
                # lost handoff / dead pinned replica: re-prefill under the
                # budget; the completion id is stable and nothing beyond
                # the prefill token was delivered, so the retry is
                # idempotent from the client's point of view
                last = e
                logger.warning("disagg request %s attempt %d failed (%s); re-prefilling",
                               rid, attempt + 1, e)
                with self._lock:
                    self._stats_at = 0.0  # force re-discovery
        raise RuntimeError(
            f"request {rid!r}: transfer plane failed {self.MAX_RETRIES + 1} times"
        ) from last

    async def completions(self, body: dict) -> dict:
        import asyncio

        from ray_tpu_torch import obs

        rej = self._admission_check()
        if rej is not None:
            return rej
        prompts = body.get("prompt", "")
        if not isinstance(prompts, list):
            prompts = [prompts]
        sampling = self._sampling_from_body(body)
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        with obs.span("api.completions", attrs={
            "request_id": rid,
            "model": body.get("model", self.config.model_id),
            "endpoint": "/v1/completions", "disagg": True,
        }) as ctx:
            loop = asyncio.get_running_loop()
            results = []
            n_prompt = 0
            for i, p in enumerate(prompts):
                ids = self.tokenizer.encode(str(p))
                n_prompt += len(ids)
                erid = rid if len(prompts) == 1 else f"{rid}-{i}"
                out = await loop.run_in_executor(None, self._generate, ids, sampling, erid)
                toks = out["token_ids"]
                if toks and toks[-1] == self.config.engine.eos_token_id:
                    toks = toks[:-1]
                results.append((self.tokenizer.decode(toks), toks, out["finish_reason"]))
        n_out = sum(len(t) for _, t, _ in results)
        return {
            "id": rid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": body.get("model", self.config.model_id),
            "trace_id": ctx.trace_id,
            "choices": [
                {"index": i, "text": text, "finish_reason": reason, "logprobs": None}
                for i, (text, _t, reason) in enumerate(results)
            ],
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": n_out,
                "total_tokens": n_prompt + n_out,
            },
        }

    def _admission_check(self) -> Optional[dict]:
        with self._lock:
            stats = dict(self._stats)
        waiting = sum(s.get("num_waiting", 0) for s in stats.values())
        running = sum(s.get("num_running", 0) for s in stats.values())
        return self.admission.check(num_waiting=waiting, num_running=running)

    def stats(self) -> dict:
        self._refresh_decode()
        with self._lock:
            return {
                "model_id": self.config.model_id,
                "mode": "disagg",
                "decode": dict(self._stats),
                "admission": self.admission.stats(),
                "reprefills": self.num_reprefills,
                "prefix_routed": self.num_prefix_routed,
            }

    async def __call__(self, request):
        path, method = request.path, request.method
        if path.rstrip("/") == "/v1/stats" and method == "GET":
            return self.stats()
        if path.rstrip("/") == "/v1/completions" and method == "POST":
            return await self.completions(request.json())
        return {"error": {"message": f"no route {method} {path}", "code": 404}}


def build_disagg_openai_app(
    llm_config,
    *,
    num_prefill: int = 1,
    num_decode: int = 1,
    connector: str = "inproc",
    name: str = "llm-disagg",
    route_prefix: str = "/disagg",
):
    """Deploy prefill pool + decode pool + ingress; returns the ingress
    handle. Pools are role-tagged so serve.status and replica listings
    show the topology."""
    from ray_tpu_torch import serve

    prefill_dep = serve.deployment(PrefillServer, name=f"Prefill:{llm_config.model_id}",
                                   num_replicas=num_prefill, role="prefill")
    decode_dep = serve.deployment(DecodeServer, name=f"Decode:{llm_config.model_id}",
                                  num_replicas=num_decode, role="decode")
    ingress_dep = serve.deployment(DisaggIngress, name=f"DisaggIngress:{llm_config.model_id}",
                                   num_replicas=1)
    app = ingress_dep.bind(
        llm_config,
        prefill_dep.bind(llm_config, connector, name),
        decode_dep.bind(llm_config, connector, name),
        name,
    )
    return serve.run(app, name=name, route_prefix=route_prefix)
