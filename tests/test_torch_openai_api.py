"""The OpenAI-compatible front end of ray_tpu_torch held against ray_tpu's.

One reference LLMServer and one port LLMServer (module-scoped, the same
fp32 LLAMA_TINY-shaped weights) are fed the same request objects
(``ray_tpu.serve.proxy.Request``); every payload must be the reference's
with ``id``, ``created`` and ``trace_id`` left out, so greedy fp32 tokens,
usage counts and the 400/404/429/503 codes all agree. Admission is driven
on both (a burst past max_queue_depth, drain, the reservation). The engine
runner's recovery ladder, its crash-loop bound, abort and the fairness the
reference's lock lacks (a submit answered within one step) are held on the
port alone, against a fault-free run.
"""

import asyncio
import dataclasses
import json
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.admission import AdmissionConfig as JAdmissionConfig
from ray_tpu.llm.admission import AdmissionController as JAdmissionController
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.openai_api import LLMConfig as JLLMConfig
from ray_tpu.llm.openai_api import LLMServer as JLLMServer
from ray_tpu.models import llama as jllama
from ray_tpu.serve.proxy import Request
from ray_tpu_torch.llm import EngineConfig, EnginePreempted, LLMConfig, LLMEngine, LLMServer
from ray_tpu_torch.llm import SamplingParams
from ray_tpu_torch.llm.admission import (
    AdmissionConfig,
    AdmissionController,
    rejected_counter,
    retry_after_header,
)
from ray_tpu_torch.llm.openai_api import _EngineRunner
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a task, a response or a future fails past this

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_llm.py's serving engine
ENGINE_KW = dict(num_blocks=64, block_size=4, max_num_seqs=4, max_prefill_len=64)
VOLATILE = ("id", "created", "trace_id")


def _req(method, path, body=None):
    return Request(method, path, {}, {}, b"" if body is None else json.dumps(body).encode())


def _strip(payload):
    if isinstance(payload, str):  # an SSE transcript: compare its events
        events = [e[len("data: "):] for e in payload.strip().split("\n\n")]
        return [e if e == "[DONE]" else _strip(json.loads(e)) for e in events]
    return {k: v for k, v in payload.items() if k not in VOLATILE}


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


@pytest.fixture(scope="module")
def servers(weights):
    ref = JLLMServer(JLLMConfig(model_id="tiny", engine=JEngineConfig(model=J_FP32_TINY,
                                                                      **ENGINE_KW),
                                params=weights[0]))
    port = LLMServer(LLMConfig(model_id="tiny", engine=EngineConfig(model=FP32_TINY, **ENGINE_KW),
                               params=weights[1], device="cpu"))
    yield ref, port
    ref.shutdown()
    port.shutdown()


def _both(servers, method, path, body=None):
    async def go():
        return await asyncio.gather(*[s(_req(method, path, body)) for s in servers])
    return asyncio.run(go())


def test_models_route(servers):
    ref, got = _both(servers, "GET", "/v1/models")
    assert got == ref
    assert got["data"][0]["max_model_len"] == 128


COMPLETIONS = {
    "one_prompt": {"prompt": "hello world", "max_tokens": 12, "temperature": 0.0},
    "prompt_list": {"prompt": ["a", "bcd", "the quick brown fox"], "max_tokens": 8,
                    "temperature": 0.0},
    "stream": {"prompt": "The cat", "max_tokens": 10, "temperature": 0.0, "stream": True},
    "model_named": {"prompt": "x", "max_tokens": 5, "temperature": 0.0, "model": "other"},
}


@pytest.mark.parametrize("case", sorted(COMPLETIONS))
def test_completions_equal_reference(servers, case):
    ref, got = _both(servers, "POST", "/v1/completions", COMPLETIONS[case])
    assert _strip(got) == _strip(ref)
    if case != "stream":
        assert got["id"].startswith("cmpl-") and len(got["trace_id"]) == 32
        assert got["usage"]["completion_tokens"] > 0


CHATS = {
    "plain": {"messages": [{"role": "system", "content": "be brief"},
                           {"role": "user", "content": "hello"}],
              "max_tokens": 9, "temperature": 0.0},
    "stream": {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
               "temperature": 0.0, "stream": True},
}


@pytest.mark.parametrize("case", sorted(CHATS))
def test_chat_completions_equal_reference(servers, case):
    ref, got = _both(servers, "POST", "/v1/chat/completions", CHATS[case])
    assert _strip(got) == _strip(ref)


# tests/test_llm.py::test_sampling_params_validation's bad knobs, plus a
# knob that is no number
BAD_KNOBS = {"max_tokens_0": {"max_tokens": 0}, "temperature_neg": {"temperature": -0.1},
             "top_k_neg": {"top_k": -1}, "top_p_neg": {"top_p": -0.1},
             "top_p_big": {"top_p": 1.5}, "temperature_text": {"temperature": "NaNsense"}}


@pytest.mark.parametrize("knob", sorted(BAD_KNOBS))
@pytest.mark.parametrize("route", ["/v1/completions", "/v1/chat/completions"])
def test_bad_knobs_give_the_reference_400(servers, knob, route):
    body = {"prompt": "p", "messages": [{"role": "user", "content": "p"}], **BAD_KNOBS[knob]}
    ref, got = _both(servers, "POST", route, body)
    assert got == ref
    assert got["error"]["code"] == 400 and got["error"]["type"] == "invalid_request_error"
    assert servers[1]._admit_reserved == 0


@pytest.mark.parametrize("method,path", [("GET", "/v1/nope"), ("POST", "/v1/models"),
                                         ("DELETE", "/v1/completions")])
def test_unknown_route_404(servers, method, path):
    ref, got = _both(servers, method, path, {})
    assert got == ref and got["error"]["code"] == 404


def test_stats_keys_equal_reference(servers):
    _both(servers, "POST", "/v1/completions", {"prompt": "s", "max_tokens": 4,
                                               "temperature": 0.0})
    ref, got = _both(servers, "GET", "/v1/stats")
    # the port reports its preemptions (recoveries bump them)
    assert set(got) == set(ref) | {"num_preemptions"}
    assert got["weight_version"] == ref["weight_version"] == 0
    assert set(got["admission"]) == set(ref["admission"])
    assert set(got["telemetry"]) == set(ref["telemetry"])
    assert set(got["prefix_cache"]) == set(ref["prefix_cache"])
    assert got["model_id"] == "tiny" and got["engine_recoveries"] == 0
    assert got["free_blocks"] == got["total_blocks"] == ENGINE_KW["num_blocks"]


def test_generate_stream_deltas_join_to_the_text(servers):
    ref_srv, port = servers

    async def go():
        out = {}
        for name, srv in (("ref", ref_srv), ("port", port)):
            deltas = [d async for d in srv.generate_stream("hello world", max_tokens=10,
                                                           temperature=0.0)]
            full = await srv(_req("POST", "/v1/completions",
                                  {"prompt": "hello world", "max_tokens": 10, "temperature": 0.0}))
            out[name] = (deltas, full["choices"][0]["text"])
        return out

    out = asyncio.run(go())
    deltas, text = out["port"]
    assert deltas and all(deltas) and "".join(deltas) == text
    assert "".join(out["ref"][0]) == text == out["ref"][1]


def test_request_trace_resolves_the_completion_id(servers):
    ref, got = _both(servers, "POST", "/v1/completions", {"prompt": "trace me",
                                                          "max_tokens": 4, "temperature": 0.0})
    traces = [s.request_trace(p["id"]) for s, p in zip(servers, (ref, got))]
    assert set(traces[1]) == set(traces[0])
    assert traces[1]["trace_id"] == got["trace_id"] and traces[1]["root"] == "api.completions"
    names = {s["name"] for s in traces[1]["spans"]}
    # the api span and, under it, the engine's lifecycle spans, as the reference's
    assert names == {s["name"] for s in traces[0]["spans"]}
    assert {"api.completions", "engine.queue_wait", "engine.prefill", "llm.request"} <= names
    # the engine's spans leave no gap in its llm.request span (the api
    # span's own coverage also counts the runner inbox's wait, which a
    # loaded host stretches)
    spans = sorted((s for s in traces[1]["spans"] if s["name"].startswith("engine.")),
                   key=lambda s: s["start"])
    root = next(s for s in traces[1]["spans"] if s["name"] == "llm.request")
    reach = root["start"]
    for s in spans:
        assert s["start"] <= reach
        reach = max(reach, s["end"])
    assert reach == root["end"]
    # the same route through __call__, the listing, and an unknown id
    routed = asyncio.run(servers[1](_req("GET", f"/v1/requests/{got['id']}/trace")))
    assert routed["trace_id"] == got["trace_id"]
    ref_list, port_list = _both(servers, "GET", "/v1/requests")
    assert set(port_list) == set(ref_list)
    assert set(port_list["data"][0]) == set(ref_list["data"][0])
    missing = [s.request_trace("cmpl-none") for s in servers]
    assert missing[1] == missing[0] and missing[1]["error"]["code"] == 404


@pytest.fixture()
def admission(servers):
    """Both servers behind AdmissionConfig(max_queue_depth=3); restored after."""
    saved = [s.admission for s in servers]
    servers[0].admission = JAdmissionController(JAdmissionConfig(max_queue_depth=3),
                                                model_tag="tiny")
    servers[1].admission = AdmissionController(AdmissionConfig(max_queue_depth=3),
                                               model_tag="tiny")
    yield servers
    for s, a in zip(servers, saved):
        s.admission = a


def test_burst_sheds_429_with_retry_after(admission):
    """24 arrivals on one event loop: each admission check runs before any
    of them enqueues, so the reservations admit exactly max_queue_depth and
    shed the rest on both servers; every admitted request finishes."""
    bodies = [{"prompt": f"p{i}", "max_tokens": 6, "temperature": 0.0} for i in range(24)]

    async def burst(srv):
        return await asyncio.gather(*[srv.completions(b) for b in bodies])

    ref = asyncio.run(burst(admission[0]))
    got = asyncio.run(burst(admission[1]))
    assert [("choices" in o) for o in got] == [("choices" in o) for o in ref]
    accepted = [o for o in got if "choices" in o]
    rejected = [o for o in got if "error" in o]
    assert len(accepted) == 3 and len(rejected) == 21
    for o, r in zip(got, ref):
        if "choices" in o:
            assert _strip(o) == _strip(r)
        else:
            assert o["error"]["code"] == r["error"]["code"] == 429
            assert o["error"]["type"] == r["error"]["type"] == "rate_limit_error"
            assert o["error"]["message"] == r["error"]["message"]
            assert o["error"]["retry_after"] >= 0.1
            assert retry_after_header(o) == str(int(np.ceil(o["error"]["retry_after"])))
    assert admission[1].admission.stats()["rejected_429"] == 21
    assert rejected_counter().series()[("tiny", "429", "")] >= 21
    assert admission[1]._admit_reserved == 0


def test_reservation_never_leaks(admission):
    """tests/test_chaos.py::test_admission_reservation_never_leaks on both
    servers: success, invalid-request and chat paths release it."""
    for srv in admission:
        for i in range(5):  # > max_queue_depth: a leak would start 429ing
            out = asyncio.run(srv.completions({"prompt": f"p{i}", "max_tokens": 4,
                                               "temperature": 0.0}))
            assert "choices" in out, out
            assert srv._admit_reserved == 0
        bad = asyncio.run(srv.completions({"prompt": "p", "max_tokens": 4,
                                           "temperature": "NaNsense"}))
        assert bad["error"]["code"] == 400 and srv._admit_reserved == 0
        out = asyncio.run(srv.chat_completions({"messages": [{"role": "user", "content": "hi"}],
                                                "max_tokens": 4}))
        assert "choices" in out and srv._admit_reserved == 0


def test_drain_then_503(admission):
    ref, got = _both(admission, "POST", "/v1/drain", {"timeout_s": 5.0})
    assert got == ref == {"drained": True, "inflight": 0}
    ref, got = _both(admission, "POST", "/v1/completions", {"prompt": "late", "max_tokens": 4})
    assert got == ref and got["error"]["code"] == 503
    assert retry_after_header(got) == "5"

    async def stream():
        return [d async for d in admission[1].generate_stream("late", max_tokens=4)]

    with pytest.raises(RuntimeError, match="503"):
        asyncio.run(stream())
    assert admission[1]._admit_reserved == 0


def test_refusals():
    # the queue-wait SLO trigger is ported: the reference's fields and defaults
    kw = {"target_queue_wait_s": 0.5, "min_queue_depth": 3, "window_s": 5.0}
    assert dataclasses.asdict(AdmissionConfig(**kw)) == dataclasses.asdict(JAdmissionConfig(**kw))
    assert dataclasses.asdict(AdmissionConfig()) == dataclasses.asdict(JAdmissionConfig())
    # disaggregated serving is ported (llm/disagg) with the reference's
    # transfer planes: in-process, RPC frames and the device fabric
    assert LLMConfig(disagg={"num_prefill": 1}).disagg.num_prefill == 1
    for kind in ("rpc", "device"):
        assert LLMConfig(disagg={"connector": kind}).disagg.connector == kind
    with pytest.raises(ValueError, match="unknown KV connector"):
        LLMConfig(disagg={"connector": "carrier-pigeon"})


# ---------------------------------------------------------------------------
# the engine runner (port only)
# ---------------------------------------------------------------------------


PROMPTS = [[1, 5, 9, 13], [1, 7, 7, 7, 7, 7, 2 + 1], [1] + list(range(20, 40))]
MAX_TOKENS = 12


def _engine(weights, **kw):
    cfg = EngineConfig(model=FP32_TINY, **{**ENGINE_KW, **kw})
    return LLMEngine(cfg, params=weights[1], device="cpu")


def _collect(runner, prompts, timeout=60.0):
    """Submit every prompt, read every queue to its finish: the positions
    delivered per request and the final outputs."""
    sp = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0, ignore_eos=True)
    subs = [runner.submit(p, sp) for p in prompts]
    delivered, finals = {}, {}
    for rid, q in subs:
        toks = []
        while True:
            out = q.get(timeout=timeout)
            if isinstance(out, BaseException):
                raise out
            toks += out.new_token_ids
            if out.finished:
                finals[rid] = out.output_token_ids
                break
        delivered[rid] = toks
    return [delivered[r] for r, _ in subs], [finals[r] for r, _ in subs]


def _faulty(engine, at: int, exc, after_step: bool):
    """Wrap engine.step to raise ``exc`` on its ``at``-th call: before the
    step runs (a preemption) or after it ran, its outputs lost (a crash)."""
    step, calls = engine.step, [0]

    def faulty_step():
        calls[0] += 1
        if calls[0] != at:
            return step()
        if after_step:
            step()
        raise exc

    engine.step = faulty_step
    return calls


@pytest.fixture(scope="module")
def fault_free(weights):
    return _engine(weights).generate(
        PROMPTS, SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0, ignore_eos=True))


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
@pytest.mark.parametrize("rung", ["preempted", "crash", "rebuild"])
def test_runner_recovery_rungs_deliver_each_position_once(weights, fault_free, rung, mixed):
    kw = dict(mixed_batch=mixed, mixed_prefill_chunk=8)
    engine = _engine(weights, **kw)
    # the third step: after admission, with a pipelined chunk in flight
    if rung == "preempted":
        _faulty(engine, 3, EnginePreempted("injected"), after_step=False)
    else:
        _faulty(engine, 3, RuntimeError("injected device fault"), after_step=True)
    late = []
    if rung == "rebuild":
        def torn(**_):
            # a request posted now reaches the rebuilt engine without an id:
            # it must not be named like a request re-created there
            late.append(runner.submit_future(PROMPTS[0], SamplingParams(
                max_tokens=MAX_TOKENS, temperature=0.0, ignore_eos=True)))
            raise RuntimeError("recover failed: engine torn")
        engine.recover = torn
    rebuilt = []

    def factory():
        rebuilt.append(_engine(weights, **kw))
        return rebuilt[-1]

    runner = _EngineRunner(engine, engine_factory=factory)
    try:
        delivered, finals = _collect(runner, PROMPTS)
        if late:
            rid, q = late[0].result(timeout=60)
            out = q.get(timeout=60)
            while not out.finished:
                out = q.get(timeout=60)
            assert out.output_token_ids == fault_free[0]
    finally:
        runner.shutdown()
    assert runner.num_recoveries == 1
    assert len(rebuilt) == (1 if rung == "rebuild" else 0)
    assert delivered == finals == fault_free  # each position exactly once
    assert all(len(d) == MAX_TOKENS for d in delivered)
    live = runner.engine
    assert live.allocator.num_free == ENGINE_KW["num_blocks"]
    if rung != "rebuild":
        assert live.num_preemptions >= 1


def test_runner_crash_loop_fails_every_caller(weights):
    engine = _engine(weights)
    step = engine.step
    calls = [0]

    def always_failing():
        calls[0] += 1
        step()
        raise RuntimeError("deterministic fault")

    engine.step = always_failing
    runner = _EngineRunner(engine)
    sp = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0, ignore_eos=True)
    subs = [runner.submit(p, sp) for p in PROMPTS]
    for _, q in subs:
        out = q.get(timeout=60)
        while not isinstance(out, BaseException):
            out = q.get(timeout=60)
        assert "deterministic fault" in str(out)
    assert runner.num_recoveries == _EngineRunner.MAX_RECOVERIES
    assert calls[0] == _EngineRunner.MAX_RECOVERIES + 1
    with pytest.raises(RuntimeError, match="died"):
        runner.submit(PROMPTS[0], sp)
    runner._thread.join(timeout=10)
    assert not runner._thread.is_alive()


def test_submit_during_a_step_returns_within_one_step(weights):
    """The reference's loop retakes its lock straight after each step, so
    a submit can wait many steps; here it is answered at the next step
    boundary. Every step is held on a gate: a submit posted while step N is
    held is answered by the time step N + 1 starts, with no clock read."""
    engine = _engine(weights)
    step, entered, free = engine.step, queue.Queue(), threading.Event()

    def gated_step():
        if not free.is_set():
            gate = threading.Event()
            entered.put(gate)
            assert gate.wait(timeout=60)
        return step()

    engine.step = gated_step
    runner = _EngineRunner(engine)
    sp = SamplingParams(max_tokens=40, temperature=0.0, ignore_eos=True)
    gate = None
    try:
        queues = [runner.submit(PROMPTS[0], sp)[1]]
        gate = entered.get(timeout=30)  # step 1 runs, held
        for p in PROMPTS[1:] * 2:
            fut = runner.submit_future(p, sp)
            assert not fut.done()  # the loop is inside the held step
            # the engine's depths are read without waiting for the loop
            depths = []
            reader = threading.Thread(target=lambda: depths.append(runner.depths()))
            reader.start()
            reader.join(timeout=30)
            assert depths and sum(depths[0]) >= 1
            gate.set()
            gate = entered.get(timeout=30)  # the next step runs, held
            assert fut.done()  # answered at the step boundary in between
            queues.append(fut.result(timeout=WAIT_S)[1])
        free.set()
        gate.set()
        with pytest.raises(ValueError, match="max_prefill_len"):
            runner.submit(list(range(1, 100)), sp)  # the caller's error, synchronously
        for q in queues:
            out = q.get(timeout=60)
            while not out.finished:
                out = q.get(timeout=60)
            assert len(out.output_token_ids) == 40
        assert runner.num_recoveries == 0
    finally:
        free.set()
        if gate is not None:
            gate.set()
        runner.shutdown()


def test_cancel_after_the_loop_took_the_submit_aborts_it(servers):
    """A caller cancelled after the loop added its request but before the
    answer reached the caller's event loop: the request is aborted, not
    decoded to max_tokens into a sink nobody reads."""
    port = servers[1]
    engine, runner = port.engine, port.runner
    step, in_step, release = engine.step, threading.Event(), threading.Event()

    def gated_step():
        in_step.set()
        assert release.wait(timeout=60)
        return step()

    sp = SamplingParams(max_tokens=48, temperature=0.0, ignore_eos=True)

    async def go():
        task = asyncio.ensure_future(port._run([1, 5, 9, 13], sp, request_id="orphan").__anext__())
        await asyncio.sleep(0)  # the task posts its submit and awaits the answer
        # block this event loop until the loop thread has added the request
        # and stepped: the answer is queued here, not yet delivered
        assert in_step.wait(timeout=30)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    engine.step = gated_step
    try:
        asyncio.run(go())
    finally:
        release.set()
        del engine.step
    assert runner.call(lambda: ("orphan" in engine.requests, "orphan" in runner._queues)) == (
        False, False)
    assert runner.call(lambda: engine.allocator.num_free) == ENGINE_KW["num_blocks"]


def test_cancelled_submit_is_dropped(weights):
    """A submit whose caller went away before the loop reached it (its
    future cancelled, as an abandoned coroutine's is) adds no request, and
    the loop goes on serving."""
    engine = _engine(weights)
    step, in_step, release = engine.step, threading.Event(), threading.Event()

    def gated_step():
        in_step.set()
        assert release.wait(timeout=30)
        return step()

    engine.step = gated_step
    runner = _EngineRunner(engine)
    sp = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
    try:
        _, q0 = runner.submit(PROMPTS[0], sp)
        assert in_step.wait(timeout=10)  # the loop is inside a step
        fut = runner.submit_future(PROMPTS[1], sp, request_id="gone")
        assert fut.cancel()
        release.set()
        _, q1 = runner.submit(PROMPTS[2], sp)
        for q in (q0, q1):
            out = q.get(timeout=30)
            while not out.finished:
                out = q.get(timeout=30)
        assert runner.call(lambda: "gone" not in engine.requests and runner._dead is None)
    finally:
        release.set()
        runner.shutdown()


def test_runner_abort(weights):
    engine = _engine(weights, max_num_seqs=1)
    runner = _EngineRunner(engine)
    sp = SamplingParams(max_tokens=60, temperature=0.0, ignore_eos=True)
    try:
        rid, q = runner.submit(PROMPTS[2], sp)
        queued, q2 = runner.submit(PROMPTS[0], sp)  # waits behind it (one slot)
        first = q.get(timeout=30)
        assert first.new_token_ids and not first.finished
        runner.abort(rid)
        runner.abort(queued)
        for queue_ in (q, q2):
            out = queue_.get(timeout=30)
            while out is not None:
                assert not isinstance(out, BaseException)
                out = queue_.get(timeout=30)
        assert runner.call(lambda: (engine.has_unfinished(), engine.allocator.num_free)) == (
            False, ENGINE_KW["num_blocks"])
        runner.abort(rid)  # a second abort is a no-op
    finally:
        runner.shutdown()
    assert not runner._thread.is_alive()  # shutdown joins the loop
