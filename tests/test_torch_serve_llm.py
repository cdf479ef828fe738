"""``build_openai_app`` of the port held against ray_tpu's, over HTTP and
through the app handle.

Both packages deploy an OpenAI app (LLMServer as a Serve deployment) on
LLAMA_TINY fp32 with the same weights (``params_from_numpy``), each on its
own runtime, proxy and free port. Over HTTP, ``/v1/models``,
``/v1/completions`` and ``/v1/chat/completions`` (streamed too: the whole
SSE transcript is the body) must give the reference's payloads and
statuses with ``id``, ``created`` and ``trace_id`` left out, so fp32 greedy
tokens are identical; the handle's ``generate_stream`` deltas must join to
the reference's text. A burst past ``max_queue_depth`` must give the
reference's 429 with a ``Retry-After`` header, and after
``serve.shutdown()`` the port's engine loop has stopped and its KV cache
is released.
"""

import concurrent.futures
import dataclasses
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu.llm.admission import AdmissionConfig as JAdmissionConfig
from ray_tpu.llm.admission import AdmissionController as JAdmissionController
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.openai_api import LLMConfig as JLLMConfig
from ray_tpu.llm.openai_api import build_openai_app as jbuild_openai_app
from ray_tpu.models import llama as jllama
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.llm import EngineConfig, LLMConfig, build_openai_app
from ray_tpu_torch.llm.admission import AdmissionConfig, AdmissionController
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a task, a response or a future fails past this

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_llm.py's serving engine
ENGINE_KW = dict(num_blocks=64, block_size=4, max_num_seqs=4, max_prefill_len=64)
VOLATILE = ("id", "created", "trace_id")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(method: str, url: str, body=None, timeout: float = 60.0) -> tuple:
    """(status, headers, body bytes); an HTTP error status is a result."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _strip(body: bytes):
    """A JSON payload without its volatile keys, or an SSE transcript as
    its stripped events."""
    text = body.decode()
    if text.startswith("data: "):
        events = [e[len("data: "):] for e in text.strip().split("\n\n")]
        return [e if e == "[DONE]" else _strip(e.encode()) for e in events]
    return {k: v for k, v in json.loads(text).items() if k not in VOLATILE}


def _replica_servers(runtime_mod) -> list:
    """The LLMServer instances inside one package's Serve replicas."""
    out = []
    for actor in runtime_mod.get_runtime().gcs.list_actors():
        inst = actor.instance
        if type(inst).__name__ == "Replica" and inst._callable is not None:
            out.append(inst._callable)
    return out


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


def _start(api, serve, runtime):
    _stop(serve, runtime)
    api.init(num_cpus=16)
    port = free_port()
    serve.start(host="127.0.0.1", port=port)
    return f"http://127.0.0.1:{port}"


def _stop(serve, runtime):
    """Serve down, then the runtime (Serve's controller belongs to the
    runtime it was started on)."""
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()


@pytest.fixture(scope="module")
def apps(weights):
    """{"ref": (base url, handle), "port": (base url, handle)}: one OpenAI
    app per package on the same weights."""
    jbase = _start(ray_tpu, jserve, jrt)
    tbase = _start(ray_tpu_torch, tserve, trt)
    try:
        jh = jbuild_openai_app(JLLMConfig(model_id="tiny", engine=JEngineConfig(
            model=J_FP32_TINY, **ENGINE_KW), params=weights[0]), name="llm", route_prefix="/")
        th = build_openai_app(LLMConfig(model_id="tiny", engine=EngineConfig(
            model=FP32_TINY, **ENGINE_KW), params=weights[1], device="cpu"),
            name="llm", route_prefix="/")
        yield {"ref": (jbase, jh), "port": (tbase, th)}
    finally:
        _stop(tserve, trt)
        _stop(jserve, jrt)


def _both(apps, method, path, body=None) -> tuple:
    """The two packages' (status, headers, body) for one request, sent one
    after the other (each alone on its engine)."""
    return tuple(http(method, apps[k][0] + path, body) for k in ("ref", "port"))


def test_replica_engine_serves_the_callers_weights(apps, weights):
    (server,) = _replica_servers(trt)
    got = server.engine.params
    for name, t in weights[1].items():
        if isinstance(t, dict):
            assert all(got[name][k].data_ptr() == v.data_ptr() for k, v in t.items()), name
        else:
            assert got[name].data_ptr() == t.data_ptr(), name


def test_models_route(apps):
    ref, got = _both(apps, "GET", "/v1/models")
    assert got[0] == ref[0] == 200
    assert json.loads(got[2]) == json.loads(ref[2])
    assert json.loads(got[2])["data"][0]["max_model_len"] == 128


COMPLETIONS = {
    "one_prompt": {"prompt": "hello world", "max_tokens": 12, "temperature": 0.0},
    "prompt_list": {"prompt": ["a", "bcd", "the quick brown fox"], "max_tokens": 8,
                    "temperature": 0.0},
    "stream": {"prompt": "The cat", "max_tokens": 10, "temperature": 0.0, "stream": True},
    "bad_knob": {"prompt": "x", "max_tokens": 4, "temperature": -1.0},
}


@pytest.mark.parametrize("case", sorted(COMPLETIONS))
def test_completions_equal_reference(apps, case):
    ref, got = _both(apps, "POST", "/v1/completions", COMPLETIONS[case])
    assert got[0] == ref[0]
    assert _strip(got[2]) == _strip(ref[2])
    if case != "bad_knob":
        assert got[0] == 200
    if case == "one_prompt":
        payload = json.loads(got[2])
        assert payload["id"].startswith("cmpl-") and payload["usage"]["completion_tokens"] > 0


CHATS = {
    "plain": {"messages": [{"role": "system", "content": "be brief"},
                           {"role": "user", "content": "hello"}],
              "max_tokens": 9, "temperature": 0.0},
    "stream": {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
               "temperature": 0.0, "stream": True},
}


@pytest.mark.parametrize("case", sorted(CHATS))
def test_chat_equal_reference(apps, case):
    ref, got = _both(apps, "POST", "/v1/chat/completions", CHATS[case])
    assert got[0] == ref[0] == 200
    assert _strip(got[2]) == _strip(ref[2])


def test_unknown_route_and_proxy_paths(apps):
    ref, got = _both(apps, "GET", "/v1/nothing")
    assert got[0] == ref[0] == 404
    assert json.loads(got[2]) == json.loads(ref[2])
    ref, got = _both(apps, "GET", "/-/healthz")
    assert (got[0], got[2]) == (ref[0], ref[2]) == (200, b"success")
    ref, got = _both(apps, "GET", "/-/routes")
    assert json.loads(got[2]) == json.loads(ref[2]) == {"/": "llm"}


def test_handle_stream_joins_to_reference_text(apps):
    kw = dict(max_tokens=10, temperature=0.0)
    texts = {}
    for k in ("ref", "port"):
        gen = apps[k][1].options(method_name="generate_stream", stream=True).remote("The cat", **kw)
        texts[k] = "".join(gen)
    assert texts["port"] == texts["ref"]
    # the handle's unary path gives the same payload as HTTP
    body = {"prompt": "The cat", **kw}
    via_handle = apps["port"][1].completions.remote(body).result(timeout_s=WAIT_S)
    assert via_handle["choices"][0]["text"] == texts["ref"]


def test_a_waiting_stats_call_leaves_the_replica_loop_free(apps):
    """/v1/stats reads the engine between two steps; with the engine loop
    parked, that read waits off the replica's event loop, so another route
    of the same replica still answers."""
    (server,) = _replica_servers(trt)
    gate, parked = threading.Event(), concurrent.futures.Future()
    server.runner._post(("call", parked, lambda: gate.wait(30)))
    base = apps["port"][0]
    try:
        with ThreadPoolExecutor(1) as pool:
            stats = pool.submit(http, "GET", base + "/v1/stats")
            time.sleep(0.2)
            st, _, raw = http("GET", base + "/v1/models", timeout=10)
            assert st == 200 and json.loads(raw)["data"][0]["id"] == "tiny"
            assert not stats.done()
            gate.set()
            st, _, raw = stats.result(timeout=30)
    finally:
        gate.set()
    assert st == 200 and json.loads(raw)["model_id"] == "tiny"
    assert parked.result(timeout=30) is True


def test_burst_past_max_queue_depth_gives_429(apps):
    """24 concurrent completions against max_queue_depth 1 (4 running rows):
    both packages shed with 429, the reference's payload type and a
    Retry-After header, and admit the rest."""
    servers = {"ref": _replica_servers(jrt)[0], "port": _replica_servers(trt)[0]}
    saved = {k: s.admission for k, s in servers.items()}
    servers["ref"].admission = JAdmissionController(JAdmissionConfig(max_queue_depth=1),
                                                    model_tag="tiny")
    servers["port"].admission = AdmissionController(AdmissionConfig(max_queue_depth=1),
                                                    model_tag="tiny")
    body = {"prompt": "the quick brown fox jumps", "max_tokens": 16, "temperature": 0.0}
    results = {}
    try:
        for k in ("ref", "port"):
            with ThreadPoolExecutor(24) as pool:
                results[k] = list(pool.map(
                    lambda _: http("POST", apps[k][0] + "/v1/completions", body), range(24)))
    finally:
        for k, s in servers.items():
            s.admission = saved[k]
    for k, res in results.items():
        statuses = [st for st, _, _ in res]
        assert set(statuses) == {200, 429}, (k, statuses)
        for st, headers, raw in res:
            payload = json.loads(raw)
            if st == 429:
                assert payload["error"]["type"] == "rate_limit_error"
                assert int(headers["Retry-After"]) >= 1
            else:
                assert payload["usage"]["completion_tokens"] == 16
    texts = {k: {json.loads(raw)["choices"][0]["text"] for st, _, raw in res if st == 200}
             for k, res in results.items()}
    assert len(texts["port"]) == 1 and texts["port"] == texts["ref"]


def test_shutdown_stops_the_engine_and_frees_its_cache(weights):
    """A second app on the port: serve.shutdown() returns after the
    replica's shutdown hook ran, so the engine loop has stopped and the KV
    cache and graphs are released (the weights stay the caller's)."""
    _stop(tserve, trt)  # the module's apps, if they are up, go first
    ray_tpu_torch.init(num_cpus=8)
    try:
        h = build_openai_app(LLMConfig(model_id="tiny2", engine=EngineConfig(
            model=FP32_TINY, **ENGINE_KW), params=weights[1], device="cpu"),
            name="llm2", route_prefix=None)
        out = h.completions.remote({"prompt": "hi", "max_tokens": 3,
                                    "temperature": 0.0}).result(timeout_s=WAIT_S)
        assert out["usage"]["completion_tokens"] == 3
        (server,) = _replica_servers(trt)
        thread, eng = server.runner._thread, server.engine
        assert thread.is_alive() and eng.cache is not None
        tserve.shutdown()
        assert not thread.is_alive()
        assert eng.cache is None and not eng._graphs._graphs
        assert eng.params["embed"].data_ptr() == weights[1]["embed"].data_ptr()
        assert not [t for t in threading.enumerate() if t.name.startswith("serve-drain")]
    finally:
        _stop(tserve, trt)
