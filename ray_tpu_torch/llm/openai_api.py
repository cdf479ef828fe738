"""OpenAI-compatible serving front end over the torch engine (counterpart of
``ray_tpu/llm/openai_api.py``).

``LLMServer`` hosts one ``LLMEngine`` behind a dedicated engine-loop thread
doing continuous batching, or, with ``LLMConfig(disagg=DisaggConfig(...))``,
prefill and decode engine pools behind a ``DisaggOrchestrator``
(``llm/disagg``); requests are asyncio coroutines fed as the loop emits
tokens. It is driven directly with any request object that has
``method``, ``path`` and ``json()``: ``await server(request)`` returns the
payload dict (or, with ``stream``, the SSE transcript string).

Endpoints: /v1/models, /v1/completions (one prompt or a list; ``stream``),
/v1/chat/completions (``stream``), /v1/stats, /v1/drain, the request-tracing
surface (/v1/requests and /v1/requests/{id}/trace: the ``api.*`` spans
and, under them, the engine's lifecycle spans), and ``generate_stream``
for token-level text deltas. The engine's ``model_tag`` is the model_id,
so its SLO histograms and series carry that label; a chaos
``PREEMPT_ENGINE`` at ``llm.engine.step`` drives the runner's crash
recovery.

Not ported: ``build_openai_app`` and ``build_disagg_openai_app`` (they
deploy through ``ray_tpu.serve``, which has no counterpart here, ROADMAP.md
Queue 1 B8).

The engine runner differs from the reference's in one way: callers never
wait behind a running step. ``submit``, ``abort`` and state reads are
posted to an inbox that the loop thread drains, in order, at every step
boundary, so only the loop thread touches the engine (and, on the card,
captures and replays its CUDA graphs, whose current stream is per thread).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import json
import logging
import queue
import threading
import time
import uuid
from typing import Any, Callable, Optional

from ray_tpu_torch import obs
from ray_tpu_torch.llm.admission import AdmissionConfig, AdmissionController
from ray_tpu_torch.llm.engine import EngineConfig, EnginePreempted, LLMEngine, RequestOutput
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.util.metrics import snapshot_meta

logger = logging.getLogger("ray_tpu_torch.llm.openai_api")


def _noop() -> None:
    """Release placeholder for rejected admissions (nothing reserved)."""


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


class ByteTokenizer:
    """Self-contained fallback tokenizer: UTF-8 bytes + specials. Lets the
    stack run hermetically (no downloaded vocabulary); swap in any object
    with encode/decode/eos_token_id for a real model."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.eos_token_id = self.EOS

    def encode(self, text: str) -> list:
        return [self.BOS] + [
            min(b + self.OFFSET, self.vocab_size - 1) for b in text.encode()
        ]

    def decode(self, ids: list) -> str:
        bs = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < 256 + self.OFFSET
        )
        return bs.decode(errors="replace")


def default_chat_template(messages: list) -> str:
    """Minimal chat rendering (role-tagged turns + assistant cue)."""
    parts = []
    for m in messages:
        parts.append(f"<|{m['role']}|>\n{m['content']}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


# ---------------------------------------------------------------------------
# engine runner: continuous-batching loop + per-request output sinks
# ---------------------------------------------------------------------------


class _EngineRunner:
    """Continuous-batching loop + per-request output queues + crash
    recovery.

    Only the loop thread touches the engine. Other threads post commands
    to an inbox (submit, abort, call) that the loop drains in FIFO order
    before every step, so a submit waits at most for the step in progress
    and never behind a lock the loop retakes.

    Delivery is gated by a per-request watermark over the request's FULL
    output prefix (not the engine's per-round new_token_ids): after a crash
    the engine re-enqueues in-flight requests and recomputes their prefix
    (``LLMEngine.recover``), so consumers see each output position exactly
    once, whatever the engine died and recovered underneath them."""

    # recovery budget: more than MAX_RECOVERIES engine deaths inside
    # RECOVERY_WINDOW_S is a crash loop, not a preemption: fail loudly
    MAX_RECOVERIES = 3
    RECOVERY_WINDOW_S = 30.0

    def __init__(self, engine: LLMEngine, engine_factory=None):
        self.engine = engine
        self._engine_factory = engine_factory  # full-rebuild fallback
        # the inbox lock is held only to append or pop a command, never
        # across an engine call
        self._inbox: collections.deque = collections.deque()
        self._inbox_lock = threading.Lock()
        # loop-thread state: rid -> output sink; rid -> {"prompt_ids", "sp",
        # "trace", "tokens", "kwargs"}, enough to re-create the request on
        # a fresh engine and to dedupe delivery
        self._queues: dict[str, Any] = {}
        self._inflight: dict[str, dict] = {}
        self._recoveries: list[float] = []
        self.num_recoveries = 0
        self._wake = threading.Event()
        self._stop = False
        self._dead: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, name="llm-engine-loop", daemon=True)
        self._thread.start()

    # -- the caller side ------------------------------------------------------

    def _post(self, cmd: tuple) -> None:
        with self._inbox_lock:
            # checked under the lock: the death handler sets _dead under it
            # before failing the inbox, so a command appended after that
            # would never be answered
            if self._dead is not None:
                raise RuntimeError(f"engine loop died: {self._dead!r}") from self._dead
            if self._stop:
                raise RuntimeError("engine loop stopped")
            self._inbox.append(cmd)
        self._wake.set()

    def submit_future(self, prompt_ids: list, sp: SamplingParams,
                      request_id: Optional[str] = None, trace=None, sink=None,
                      **add_kwargs) -> concurrent.futures.Future:
        """Post a request; the future resolves, at the loop's next step
        boundary, to ``(rid, sink)`` or to ``engine.add_request``'s error.
        ``sink`` (default a ``queue.Queue``) receives RequestOutputs, then
        None after an abort, or the exception that killed the loop.
        ``add_kwargs`` pass through to ``engine.add_request`` (lora_id,
        priority, tenant, slo_tag) and are replayed by the full-rebuild
        recovery rung."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        sink = queue.Queue() if sink is None else sink
        self._post(("submit", fut, sink, list(prompt_ids), sp, request_id, trace,
                    dict(add_kwargs)))
        return fut

    def submit(self, prompt_ids: list, sp: SamplingParams, request_id: Optional[str] = None,
               trace=None, **add_kwargs) -> tuple:
        """Blocking submit: ``(rid, queue)``; raises what ``add_request``
        raises (a prompt too long, an unknown adapter). Returns within the
        step in progress."""
        return self.submit_future(prompt_ids, sp, request_id=request_id, trace=trace,
                                  **add_kwargs).result()

    def abort(self, rid: str) -> None:
        """Abort a request (its sink gets None); a no-op once it finished
        or after the loop stopped."""
        try:
            self._post(("abort", rid))
        except RuntimeError:
            pass

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` on the loop thread between two steps and return its
        result (or, once the loop has ended, run it here: nothing steps the
        engine any more)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            self._post(("call", fut, fn))
        except RuntimeError:
            return fn()
        return fut.result()

    def depths(self) -> tuple[int, int]:
        """(waiting, running) of the engine, read without waiting for the
        loop (a deque's and a list's length are read atomically)."""
        eng = self.engine
        return len(eng.waiting), len(eng.running)

    def busy(self) -> bool:
        """Work in the inbox or in the engine."""
        with self._inbox_lock:
            queued = bool(self._inbox)
        return queued or self.engine.has_unfinished()

    # -- the loop thread ------------------------------------------------------

    def _drain_inbox(self) -> None:
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    return
                cmd = self._inbox.popleft()
            kind = cmd[0]
            if kind != "abort" and not cmd[1].set_running_or_notify_cancel():
                continue  # the caller cancelled (an abandoned coroutine): drop it
            if kind == "submit":
                _, fut, sink, prompt_ids, sp, request_id, trace, kwargs = cmd
                try:
                    rid = self.engine.add_request(prompt_ids, sp, request_id=request_id,
                                                  trace=trace, **kwargs)
                except Exception as e:  # noqa: BLE001 — the caller's error
                    fut.set_exception(e)
                    continue
                self._queues[rid] = sink
                # "tokens" holds the DELIVERED output prefix: the full-rebuild
                # rung seeds the fresh engine's request with it
                self._inflight[rid] = {"prompt_ids": prompt_ids, "sp": sp, "trace": trace,
                                       "tokens": [], "kwargs": kwargs}
                fut.set_result((rid, sink))
            elif kind == "abort":
                rid = cmd[1]
                self.engine.abort_request(rid)
                sink = self._queues.pop(rid, None)
                self._inflight.pop(rid, None)
                if sink is not None:
                    sink.put(None)
            else:  # "call"
                _, fut, fn = cmd
                try:
                    fut.set_result(fn())
                except Exception as e:  # noqa: BLE001 — the caller's error
                    fut.set_exception(e)

    def _deliver(self, out: RequestOutput) -> None:
        """Idempotent delivery: only output positions past the request's
        delivered watermark ship."""
        sink = self._queues.get(out.request_id)
        rec = self._inflight.get(out.request_id)
        if rec is not None:
            new = list(out.output_token_ids[len(rec["tokens"]):])
            rec["tokens"].extend(new)
            out = dataclasses.replace(out, new_token_ids=new)
        if sink is None:
            return
        if out.new_token_ids or out.finished:
            sink.put(out)
        if out.finished:
            self._queues.pop(out.request_id, None)
            self._inflight.pop(out.request_id, None)

    def _loop(self) -> None:
        try:
            while not self._stop:
                self._drain_inbox()
                if not self.engine.has_unfinished():
                    self._wake.wait(timeout=0.2)
                    self._wake.clear()
                    continue
                try:
                    outputs = self.engine.step()
                except Exception as e:  # a failed step must not hang callers
                    if not self._stop and self._try_recover(e):
                        continue
                    logger.exception("engine loop failed; failing all in-flight requests")
                    self._die(e)
                    return
                for out in outputs:
                    self._deliver(out)
            self._die(RuntimeError("engine loop stopped"))
        except BaseException as e:
            self._die(e)
            raise

    def _die(self, exc: BaseException) -> None:
        """Fail every waiting caller (posted commands and open streams) and
        refuse later posts."""
        with self._inbox_lock:
            if self._dead is None:
                self._dead = exc
            pending = list(self._inbox)
            self._inbox.clear()
        for cmd in pending:
            if cmd[0] in ("submit", "call"):
                cmd[1].set_exception(RuntimeError(f"engine loop ended: {exc!r}"))
        sinks = list(self._queues.values())
        self._queues.clear()
        self._inflight.clear()
        for sink in sinks:
            sink.put(exc)

    def _try_recover(self, exc: Exception) -> bool:
        """Recovery ladder: (1) requeue in-flight requests on the surviving
        engine (a clean preemption), (2) requeue them with a zeroed KV cache
        and a new allocator (a crash of unknown provenance), (3) a fresh
        engine from the factory with every request re-created with its
        delivered prefix (``recover`` itself failed). Bounded by the
        recovery budget, so a deterministic crash loop still fails fast."""
        now = time.time()
        self._recoveries = [t for t in self._recoveries if now - t < self.RECOVERY_WINDOW_S]
        if len(self._recoveries) >= self.MAX_RECOVERIES:
            return False
        self._recoveries.append(now)
        self.num_recoveries += 1
        clean = isinstance(exc, EnginePreempted)
        try:
            requeued = self.engine.recover(rebuild_kv=not clean)
        except Exception:  # noqa: BLE001 — the engine object itself is torn
            logger.exception("engine.recover failed; trying a full rebuild")
            if self._engine_factory is None:
                return False
            try:
                fresh = self._engine_factory()
                # the request-id counter carries over: a later submit without
                # an id must not be named like a request re-created below
                fresh._counter = self.engine._counter
                torn, self.engine = self.engine, fresh
                try:
                    torn.close()  # its tiered cache's workers, bounded joins
                except Exception:  # noqa: BLE001
                    pass
                # re-create every in-flight request WITH its delivered prefix:
                # admission prefills prompt + outputs, so the continuation
                # extends exactly what the consumer already received
                for rid, rec in self._inflight.items():
                    self.engine.add_request(rec["prompt_ids"], rec["sp"], request_id=rid,
                                            trace=rec["trace"], **rec["kwargs"])
                    self.engine.requests[rid].output_token_ids = list(rec["tokens"])
                requeued = list(self._inflight)
            except Exception:  # noqa: BLE001
                logger.exception("engine rebuild failed")
                return False
        logger.warning("engine loop recovered from %r (%d request(s) re-enqueued)",
                       exc, len(requeued))
        obs.get_recorder().record(
            "engine.runner_recover", now, time.time(),
            attrs={"cause": f"{type(exc).__name__}: {exc}"[:200], "requeued": len(requeued),
                   "clean_preemption": clean},
            status="error",
        )
        return True

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Stop the loop and wait (bounded) for it to finish its step: a
        loop thread left inside a torch op at interpreter exit aborts the
        process."""
        self._stop = True
        self._wake.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=timeout_s)
        self.engine.close()  # the tiered cache's workers, bounded joins


class _AsyncSink:
    """An output sink that hands each item to an asyncio queue on its event
    loop: the coroutine awaiting a request needs no thread blocked on it."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self.queue: asyncio.Queue = asyncio.Queue()

    def put(self, item) -> None:
        try:
            self._loop.call_soon_threadsafe(self.queue.put_nowait, item)
        except RuntimeError:
            pass  # the consumer's event loop is closed: nobody is listening


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LLMConfig:
    """Reference analog: ray.llm LLMConfig (server_models.py)."""

    model_id: str = "llama-tiny"
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    tokenizer: Any = None  # encode/decode/eos_token_id; ByteTokenizer default
    params: Any = None     # the engine's params dict of tensors; random if None
    seed: int = 0
    # admission control / load shedding (llm/admission.py); None = an
    # unbounded controller that still supports graceful drain
    admission: Any = None
    # disaggregated prefill/decode (llm/disagg): a DisaggConfig (or a dict
    # of one) replaces the single engine with prefill and decode pools
    # behind the same routes; its engine defaults to ``engine`` above
    disagg: Any = None
    # the port's entry-point rule: the card unless the caller asks for the CPU
    device: str = "cuda"

    def __post_init__(self):
        if isinstance(self.disagg, dict):
            from ray_tpu_torch.llm.disagg import DisaggConfig

            self.disagg = DisaggConfig(**{"engine": self.engine, **self.disagg})


class LLMServer:
    """Hosts one engine behind the OpenAI routes (reference: VLLMDeployment)."""

    def __init__(self, config: LLMConfig):
        self.config = config
        self.tokenizer = config.tokenizer or ByteTokenizer(config.engine.model.vocab_size)
        config.engine.eos_token_id = getattr(self.tokenizer, "eos_token_id", 2)
        self.orchestrator = None
        self.runner = None
        if config.disagg is not None:
            # disaggregated: submit, abort, depths, drain and stats route
            # through the orchestrator, whose engines each have a loop thread
            from ray_tpu_torch.llm.disagg import DisaggOrchestrator

            config.disagg.engine.eos_token_id = config.engine.eos_token_id
            self.orchestrator = DisaggOrchestrator(
                config.disagg, params=config.params, seed=config.seed,
                model_tag=config.model_id, device=config.device,
            )
        else:
            def _build_engine():
                # also the crash-recovery fallback: fresh engine, same weights/seed
                eng = LLMEngine(config.engine, params=config.params, seed=config.seed,
                                device=config.device)
                eng.model_tag = config.model_id  # the SLO and metric label
                return eng

            self.runner = _EngineRunner(_build_engine(), engine_factory=_build_engine)
        acfg = config.admission
        if isinstance(acfg, dict):
            acfg = AdmissionConfig(**acfg)
        # admission reservation state: see _admission_check
        self._admit_lock = threading.Lock()
        self._admit_reserved = 0
        self.admission = AdmissionController(acfg or AdmissionConfig(),
                                             model_tag=config.model_id)

    @property
    def engine(self) -> LLMEngine:
        if self.orchestrator is not None:
            # configuration reads (eos, max_seq): the pools share one config
            return self.orchestrator._decode[0].engine
        # via the runner: crash recovery may have swapped in a rebuilt one
        return self.runner.engine

    def __del__(self):
        try:
            self._stop_engines()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def _stop_engines(self) -> None:
        if self.orchestrator is not None:
            self.orchestrator.shutdown()
        if self.runner is not None:
            self.runner.shutdown()

    def shutdown(self):
        """Graceful shutdown: stop admission, give the engines a short
        drain, stop the loops."""
        try:
            self.drain(timeout_s=5.0)
        finally:
            self._stop_engines()

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Maintenance drain: new requests get 503 + Retry-After while
        in-flight requests run to completion (bounded wait)."""
        self.admission.start_drain()
        deadline = time.time() + timeout_s
        if self.orchestrator is not None:
            while time.time() < deadline and self.orchestrator.has_unfinished():
                time.sleep(0.05)
            # the orchestrator's in-flight set, not engine depths: a handoff
            # in transit sits on no engine
            left = self.orchestrator.num_inflight()
            return {"drained": left == 0, "inflight": left}
        while time.time() < deadline and self.runner.busy():
            time.sleep(0.05)
        left = sum(self.runner.depths())
        return {"drained": left == 0, "inflight": left}

    def _abort(self, rid: str) -> None:
        (self.orchestrator or self.runner).abort(rid)

    # -- request plumbing -----------------------------------------------------

    def _sampling_from_body(self, body: dict) -> SamplingParams:
        return SamplingParams(
            max_tokens=int(body.get("max_tokens", 64)),
            temperature=float(body.get("temperature", 1.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            seed=body.get("seed"),
            logprobs=bool(body.get("logprobs", False)),
        )

    async def _run(self, prompt_ids: list, sp: SamplingParams,
                   request_id: Optional[str] = None,
                   on_enqueued: Optional[Callable[[], None]] = None):
        """Async generator of RequestOutput. The ambient TraceContext is
        captured here (the caller's asyncio task) and handed to the engine
        explicitly: the engine loop is a separate thread."""
        sink = _AsyncSink(asyncio.get_running_loop())
        try:
            submitted = (self.orchestrator or self.runner).submit_future(
                prompt_ids, sp, request_id=request_id, trace=obs.current(), sink=sink)
            rid, _ = await asyncio.wrap_future(submitted)
        except asyncio.CancelledError:
            # the caller went away; if the loop had already taken the submit,
            # the request runs with nobody reading it: abort it once it lands
            submitted.add_done_callback(self._abort_if_submitted)
            raise
        finally:
            # the admission reservation hands over to the real queue entry
            # here (or dies with a failed submit): never held past this
            if on_enqueued is not None:
                on_enqueued()
        try:
            while True:
                out = await sink.queue.get()
                if out is None:
                    return
                if isinstance(out, BaseException):  # the engine loop died
                    raise RuntimeError("engine loop failed") from out
                yield out
                if out.finished:
                    return
        finally:
            self._abort(rid)

    def _abort_if_submitted(self, submitted: concurrent.futures.Future) -> None:
        if not submitted.cancelled() and submitted.exception() is None:
            self._abort(submitted.result()[0])

    async def _generate_text(self, prompt_ids: list, sp: SamplingParams,
                             request_id: Optional[str] = None,
                             on_enqueued: Optional[Callable[[], None]] = None):
        toks, reason = [], None
        async for out in self._run(prompt_ids, sp, request_id=request_id,
                                   on_enqueued=on_enqueued):
            toks = out.output_token_ids
            reason = out.finish_reason
        # strip the eos token from the visible text
        if toks and toks[-1] == self.engine.config.eos_token_id:
            toks = toks[:-1]
        return self.tokenizer.decode(toks), toks, reason

    # -- token-level streaming (text deltas) ----------------------------------

    async def generate_stream(self, prompt: str, **kwargs):
        """Async generator of text deltas.

        Admission applies here too: a draining or overloaded server must
        not keep admitting through the streaming side door. Streams cannot
        return an error payload, so a rejection raises."""
        rej, admit_done = self._admission_check()
        if rej is not None:
            err = rej["error"]
            raise RuntimeError(
                f"admission rejected ({err['code']}): {err['message']}; "
                f"retry after {err['retry_after']}s"
            )
        try:
            sp = self._sampling_from_body(kwargs)
            ids = self.tokenizer.encode(prompt)
        except BaseException:
            admit_done()  # the reservation must not outlive a dead arrival
            raise
        try:
            async for delta in self._stream_deltas(ids, sp, admit_done):
                yield delta
        finally:
            # idempotent backstop: a generator abandoned before its first
            # iteration reached _run's submit
            admit_done()

    async def _stream_deltas(self, ids, sp, admit_done):
        sent = ""
        first_mark = False
        async for out in self._run(ids, sp, on_enqueued=admit_done):
            toks = out.output_token_ids
            if toks and toks[-1] == self.engine.config.eos_token_id:
                toks = toks[:-1]
            text = self.tokenizer.decode(toks)
            # hold back a trailing replacement char: usually half of a
            # multi-byte sequence whose tail arrives with the next token
            if not out.finished:
                text = text.rstrip("�")
            if text.startswith(sent) and len(text) > len(sent):
                if not first_mark:
                    # the client-visible first-token mark
                    first_mark = True
                    if obs.current() is not None:
                        now = time.time()
                        obs.get_recorder().record("api.stream_first_token", now, now,
                                                  attrs={"tokens": len(toks)})
                yield text[len(sent):]
                sent = text

    # -- HTTP surface ---------------------------------------------------------

    async def __call__(self, request):
        path, method = request.path, request.method
        if path.rstrip("/") == "/v1/models" and method == "GET":
            return self.models()
        if path.rstrip("/") == "/v1/stats" and method == "GET":
            return self.stats()
        if path.rstrip("/") == "/v1/requests" and method == "GET":
            return self.list_requests()
        parts = [p for p in path.split("/") if p]
        if (len(parts) == 4 and parts[:2] == ["v1", "requests"]
                and parts[3] == "trace" and method == "GET"):
            return self.request_trace(parts[2])
        if path.rstrip("/") == "/v1/completions" and method == "POST":
            return await self.completions(request.json())
        if path.rstrip("/") == "/v1/chat/completions" and method == "POST":
            return await self.chat_completions(request.json())
        if path.rstrip("/") == "/v1/drain" and method == "POST":
            # off the event loop: drain() polls for up to timeout_s, and
            # blocking the loop would freeze the very in-flight responses
            # the drain waits for
            body = request.json() or {}
            timeout_s = float(body.get("timeout_s", 30.0))
            return await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.drain(timeout_s=timeout_s)
            )
        return {"error": {"message": f"no route {method} {path}", "code": 404}}

    # -- flight recorder surface ----------------------------------------------

    def list_requests(self, limit: int = 100) -> dict:
        """The last N traced requests (newest first) with trace ids, root
        span, e2e, span counts."""
        rec = obs.get_recorder()
        return {
            "object": "list",
            "data": rec.traces(limit=limit),
            "dropped_traces": rec.num_dropped_traces,
            "dropped_spans": rec.num_dropped_spans,
        }

    # span cap for one trace response
    TRACE_MAX_SPANS = 2048

    def request_trace(self, request_id: str, max_spans: Optional[int] = None) -> dict:
        """The span tree of one request (by completion request id, or by
        trace id), with e2e and span coverage; at most ``max_spans`` spans
        (earliest first) with a ``truncated`` flag."""
        cap = self.TRACE_MAX_SPANS if max_spans is None else int(max_spans)
        rec = obs.get_recorder()
        trace_id = rec.find_by_request(request_id) or request_id
        spans = rec.get(trace_id)
        if not spans:
            return {"error": {
                "message": f"no recorded trace for request {request_id!r} "
                "(evicted from the flight recorder, or never traced)",
                "type": "not_found_error",
                "code": 404,
            }}
        summary = rec.summary(trace_id) or {}
        total = len(spans)
        truncated = total > cap
        if truncated:
            spans = sorted(spans, key=lambda s: s.start)[:cap]
        return {
            "request_id": request_id,
            "trace_id": trace_id,
            **{k: v for k, v in summary.items() if k != "trace_id"},
            "spans": [s.to_dict() for s in spans],
            "truncated": truncated,
            "total_spans": total,
        }

    def stats(self) -> dict:
        """The engine's scheduling/KV state (read between two steps), the
        admission counters, the runner's recoveries and the snapshot
        header; disaggregated, the per-pool and transfer-plane view."""
        if self.orchestrator is not None:
            out = {"model_id": self.config.model_id, "mode": "disagg",
                   **self.orchestrator.stats()}
            out["admission"] = self.admission.stats()
            out["telemetry"] = snapshot_meta()
            return out
        out = self.runner.call(lambda: {"model_id": self.config.model_id,
                                        **self.engine.stats()})
        out["admission"] = self.admission.stats()
        out["engine_recoveries"] = self.runner.num_recoveries
        out["telemetry"] = snapshot_meta()
        return out

    def _admission_check(self) -> tuple[Optional[dict], Callable[[], None]]:
        """Load-shedding decision for one arriving request.

        Returns ``(rejection, release)``. On admit a RESERVATION counts
        against the queue depth until ``release()`` runs (idempotent; _run
        fires it once the request is in the engine queue, the handler's
        finally is the backstop), so N concurrent arrivals cannot all pass
        the depth check before any of them enqueues. The depths are read
        without waiting for the engine loop."""
        with self._admit_lock:
            if self.orchestrator is not None:
                depths = self.orchestrator.queue_depths()
                num_waiting, num_running = sum(depths["prefill"]), sum(depths["decode"])
            else:
                num_waiting, num_running = self.runner.depths()
            rej = self.admission.check(num_waiting=num_waiting + self._admit_reserved,
                                       num_running=num_running)
            if rej is not None:
                return rej, _noop
            self._admit_reserved += 1

        released = [False]

        def release() -> None:
            if not released[0]:
                released[0] = True
                with self._admit_lock:
                    self._admit_reserved -= 1

        return None, release

    def models(self) -> dict:
        return {
            "object": "list",
            "data": [
                {
                    "id": self.config.model_id,
                    "object": "model",
                    "owned_by": "ray_tpu",
                    "max_model_len": self.engine.config.model.max_seq,
                }
            ],
        }

    @staticmethod
    def _invalid_request(e: Exception) -> dict:
        """OpenAI-style 400 payload for bad sampling knobs."""
        return {
            "error": {
                "message": str(e),
                "type": "invalid_request_error",
                "code": 400,
            }
        }

    async def completions(self, body: dict) -> Any:
        rej, admit_done = self._admission_check()
        if rej is not None:
            return rej
        try:
            return await self._completions_admitted(body, admit_done)
        finally:
            # idempotent backstop: a no-op once _run handed the reservation
            # to the engine queue
            admit_done()

    async def _completions_admitted(self, body: dict, admit_done) -> Any:
        try:
            sp = self._sampling_from_body(body)
        except (ValueError, TypeError) as e:
            return self._invalid_request(e)
        prompts = body.get("prompt", "")
        if not isinstance(prompts, list):
            prompts = [prompts]
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        # request root span: engine request ids derive from the completion
        # id, so GET /v1/requests/{id}/trace resolves the whole trace
        with obs.span("api.completions", attrs={
            "request_id": rid,
            "model": body.get("model", self.config.model_id),
            "endpoint": "/v1/completions",
            "num_prompts": len(prompts),
        }) as ctx:
            id_lists = [self.tokenizer.encode(str(p)) for p in prompts]
            # one choice per prompt, generated concurrently; the single
            # admission reservation rides the first submit
            results = await asyncio.gather(
                *[
                    self._generate_text(
                        ids, sp,
                        request_id=rid if len(id_lists) == 1 else f"{rid}-{i}",
                        on_enqueued=admit_done if i == 0 else None,
                    )
                    for i, ids in enumerate(id_lists)
                ]
            )
            n_prompt = sum(len(ids) for ids in id_lists)
            n_out = sum(len(toks) for _, toks, _ in results)
            payload = {
                "id": rid,
                "object": "text_completion",
                "created": int(time.time()),
                "model": body.get("model", self.config.model_id),
                "trace_id": ctx.trace_id,
                "choices": [
                    {
                        "index": i,
                        "text": text,
                        "finish_reason": reason,
                        "logprobs": None,
                    }
                    for i, (text, _toks, reason) in enumerate(results)
                ],
                "usage": {
                    "prompt_tokens": n_prompt,
                    "completion_tokens": n_out,
                    "total_tokens": n_prompt + n_out,
                },
            }
        if body.get("stream"):
            return _sse_transcript(payload, "text_completion")
        return payload

    async def chat_completions(self, body: dict) -> Any:
        rej, admit_done = self._admission_check()
        if rej is not None:
            return rej
        try:
            return await self._chat_completions_admitted(body, admit_done)
        finally:
            admit_done()  # idempotent backstop, see completions()

    async def _chat_completions_admitted(self, body: dict, admit_done) -> Any:
        try:
            sp = self._sampling_from_body(body)
        except (ValueError, TypeError) as e:
            return self._invalid_request(e)
        messages = body.get("messages", [])
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        with obs.span("api.chat_completions", attrs={
            "request_id": rid,
            "model": body.get("model", self.config.model_id),
            "endpoint": "/v1/chat/completions",
        }) as ctx:
            prompt = default_chat_template(messages)
            ids = self.tokenizer.encode(prompt)
            text, toks, reason = await self._generate_text(
                ids, sp, request_id=rid, on_enqueued=admit_done
            )
            payload = {
                "id": rid,
                "object": "chat.completion",
                "created": int(time.time()),
                "model": body.get("model", self.config.model_id),
                "trace_id": ctx.trace_id,
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": reason,
                    }
                ],
                "usage": {
                    "prompt_tokens": len(ids),
                    "completion_tokens": len(toks),
                    "total_tokens": len(ids) + len(toks),
                },
            }
        if body.get("stream"):
            return _sse_transcript(payload, "chat.completion.chunk")
        return payload


def _sse_transcript(payload: dict, obj: str) -> str:
    """Full-assembly SSE body (token-level streaming: generate_stream)."""
    choice = payload["choices"][0]
    text = choice.get("text", choice.get("message", {}).get("content", ""))
    events = []
    chunk = dict(payload, object=obj)
    if obj.startswith("chat"):
        chunk = dict(chunk)
        chunk["choices"] = [
            {"index": 0, "delta": {"role": "assistant", "content": text},
             "finish_reason": choice["finish_reason"]}
        ]
    events.append(f"data: {json.dumps(chunk)}")
    events.append("data: [DONE]")
    return "\n\n".join(events) + "\n\n"
