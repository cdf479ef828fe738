"""The port's RPC and gRPC front doors into Serve held against ray_tpu's.

- The reference scenarios ``tests/test_serve.py:240`` (the framed-RPC
  ingress: structured calls routed by app, a named method, the single-app
  default) and ``:262`` (the gRPC ingress with no protoc step: metadata
  selects the app, the gRPC method name the deployment method, ``Call``
  goes to ``__call__``, an unknown app is ``NOT_FOUND``) give the same
  answers on both packages.
- One ingress of each kind: asking for another address raises on both.
- Status codes: ``NOT_FOUND`` for an unknown app, ``DEADLINE_EXCEEDED``
  when the server's wait or the client's deadline runs out, ``INTERNAL``
  for a result that is not bytes, on both packages.
- ``build_openai_app`` at ``LLAMA_TINY`` fp32 with the same weights
  (``params_from_numpy``) on both packages, through the RPC ingress
  (``LLMServer.completions``) and the gRPC ingress (a bytes-in/bytes-out
  deployment around it): the payloads, greedy tokens included, equal the
  reference's with ``id``, ``created`` and ``trace_id`` left out (band:
  exact).
- ``serve.shutdown()`` stops both ingresses: a fresh bind to each address
  succeeds.

Every app is deployed with ``_start_proxy=False``: no HTTP proxy is
started, so no test binds a fixed port. Each test runs each package on a
fresh runtime of 16 CPUs and tears it down after, Serve first.
"""

import dataclasses
import importlib
import json
import socket

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.openai_api import LLMConfig as JLLMConfig
from ray_tpu.llm.openai_api import build_openai_app as jbuild_openai_app
from ray_tpu.models import llama as jllama
from ray_tpu.serve.rpc_ingress import rpc_ingress_call as jrpc_ingress_call
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.llm import EngineConfig, LLMConfig, build_openai_app
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.rpc_ingress import rpc_ingress_call as trpc_ingress_call

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a call or a response fails past this

PACKAGES = {"ref": (ray_tpu, jserve, jrt, jrpc_ingress_call),
            "port": (ray_tpu_torch, tserve, trt, trpc_ingress_call)}


def _down(serve, runtime):
    """Serve down, then the runtime (Serve's controller belongs to the
    runtime it was started on)."""
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()


@pytest.fixture(scope="module", autouse=True)
def no_runtime_left():
    """Any runtime an earlier file left up goes first; none is left after."""
    for _, serve, runtime, _ in PACKAGES.values():
        _down(serve, runtime)
    yield
    for _, serve, runtime, _ in PACKAGES.values():
        _down(serve, runtime)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    api, serve, runtime, call = PACKAGES[request.param]
    _down(serve, runtime)
    api.init(num_cpus=16)
    yield serve, call
    _down(serve, runtime)


def _unary(chan, method):
    return chan.unary_unary(method, request_serializer=lambda b: b,
                            response_deserializer=lambda b: b)


def _code(fn) -> str:
    try:
        fn()
    except grpc.RpcError as e:
        return e.code().name
    return "OK"


def _free(addr) -> bool:
    """A fresh bind to ``addr`` succeeds: nothing listens there."""
    with socket.socket() as s:
        try:
            s.bind(tuple(addr))
            return True
        except OSError:
            return False


class Calc:
    def __call__(self, x):
        return {"doubled": x * 2}

    def add(self, a, b):
        return a + b


def test_rpc_ingress_binary_front_door(pkg):
    """``tests/test_serve.py:240``: structured calls over the framed-RPC
    plane, routed through the controller's route table."""
    serve, call = pkg
    serve.run(serve.deployment(Calc).bind(), name="rpcapp", route_prefix="/calc",
              _start_proxy=False)
    ingress = serve.start_rpc_ingress(port=0)
    assert call(ingress.addr, 21, app="rpcapp", timeout=WAIT_S) == {"doubled": 42}
    assert call(ingress.addr, 2, 3, app="rpcapp", method="add", timeout=WAIT_S) == 5
    # one app deployed: it is the default
    assert call(ingress.addr, 5, timeout=WAIT_S)["doubled"] == 10
    serve.delete("rpcapp")


class Infer:
    def __call__(self, data: bytes) -> bytes:
        return b"default:" + data

    def Predict(self, data: bytes) -> bytes:
        return data.upper()


def test_grpc_ingress_standards_front_door(pkg):
    """``tests/test_serve.py:262``: a plain grpc channel and a generated
    stub's method path reach the deployment, which exchanges serialized
    message bytes; metadata selects the app, the method name the
    deployment method."""
    serve, _ = pkg
    serve.run(serve.deployment(Infer).bind(), name="grpcapp", route_prefix="/grpc",
              _start_proxy=False)
    ingress = serve.start_grpc_ingress(port=0)
    chan = grpc.insecure_channel(f"{ingress.addr[0]}:{ingress.addr[1]}")
    try:
        out = _unary(chan, "/user.Inference/Predict")(
            b"hello", metadata=(("application", "grpcapp"),), timeout=WAIT_S)
        assert out == b"HELLO"
        assert _unary(chan, "/user.Inference/Call")(b"x", timeout=WAIT_S) == b"default:x"
        assert _code(lambda: _unary(chan, "/user.Inference/Predict")(
            b"x", metadata=(("application", "ghost"),), timeout=30)) == "NOT_FOUND"
    finally:
        chan.close()
    serve.delete("grpcapp")


def test_one_ingress_of_each_kind_and_rebind_conflict(pkg):
    serve, _ = pkg
    for start in (serve.start_rpc_ingress, serve.start_grpc_ingress):
        first = start(port=0)
        assert start() is first  # the default address: the live ingress
        assert start(host=first.addr[0], port=first.addr[1]) is first
        taken = first.addr[1] + 1 if first.addr[1] < 65535 else first.addr[1] - 1
        with pytest.raises(RuntimeError, match="already bound"):
            start(host="127.0.0.1", port=taken)


class Statuses:
    def __call__(self, data: bytes) -> bytes:
        return data

    def Slow(self, data: bytes) -> bytes:
        import time

        time.sleep(2.0)
        return data

    def NotBytes(self, data: bytes):
        return {"not": "bytes"}

    def Boom(self, data: bytes) -> bytes:
        raise KeyError("a deployment's own KeyError")


def test_grpc_status_codes(pkg):
    """NOT_FOUND only for routing; DEADLINE_EXCEEDED when the server's
    wait (``request_timeout_s``) or the client's deadline runs out;
    INTERNAL for a result that is not bytes and for a deployment's own
    error."""
    serve, _ = pkg
    serve.run(serve.deployment(Statuses).bind(), name="codes", route_prefix="/codes",
              _start_proxy=False)
    serve.run(serve.deployment(Infer).bind(), name="other", route_prefix="/other",
              _start_proxy=False)
    ingress = serve.start_grpc_ingress(port=0)
    chan = grpc.insecure_channel(f"{ingress.addr[0]}:{ingress.addr[1]}")
    app = (("application", "codes"),)
    try:
        codes = {
            "two_apps_no_selection": _code(lambda: _unary(chan, "/s.S/Call")(b"x", timeout=30)),
            "unknown_app": _code(lambda: _unary(chan, "/s.S/Call")(
                b"x", metadata=(("application", "ghost"),), timeout=30)),
            "server_wait": _code(lambda: _unary(chan, "/s.S/Slow")(
                b"x", metadata=app + (("request_timeout_s", "0.3"),), timeout=30)),
            "client_deadline": _code(lambda: _unary(chan, "/s.S/Slow")(
                b"x", metadata=app, timeout=0.5)),
            "not_bytes": _code(lambda: _unary(chan, "/s.S/NotBytes")(
                b"x", metadata=app, timeout=30)),
            "own_key_error": _code(lambda: _unary(chan, "/s.S/Boom")(
                b"x", metadata=app, timeout=30)),
            "ok": _code(lambda: _unary(chan, "/s.S/Call")(b"x", metadata=app, timeout=30)),
        }
    finally:
        chan.close()
    assert codes == {"two_apps_no_selection": "NOT_FOUND", "unknown_app": "NOT_FOUND",
                     "server_wait": "DEADLINE_EXCEEDED", "client_deadline": "DEADLINE_EXCEEDED",
                     "not_bytes": "INTERNAL", "own_key_error": "INTERNAL", "ok": "OK"}


def test_shutdown_frees_both_ports(pkg):
    serve, _ = pkg
    addrs = [serve.start_rpc_ingress(port=0).addr, serve.start_grpc_ingress(port=0).addr]
    assert not any(_free(a) for a in addrs)
    serve.shutdown()
    assert all(_free(a) for a in addrs)
    # and a new ingress of each kind starts after it
    assert serve.start_rpc_ingress(port=0).addr[1] > 0


# -- the slice: an OpenAI app through the two front doors --------------------------

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(num_blocks=64, block_size=4, max_num_seqs=4, max_prefill_len=64)
VOLATILE = ("id", "created", "trace_id")
BODIES = [{"prompt": "hello world", "max_tokens": 12, "temperature": 0.0},
          {"prompt": ["a", "bcd", "the quick brown fox"], "max_tokens": 8, "temperature": 0.0}]


class JsonGateway:
    """Bytes in, bytes out: a JSON completion body -> the app's
    ``LLMServer.completions`` -> its JSON payload."""

    def __init__(self, serve_module: str, app: str):
        self._serve = importlib.import_module(serve_module)
        self._app = app

    def Completions(self, data: bytes) -> bytes:
        h = self._serve.get_app_handle(self._app)
        return json.dumps(h.completions.remote(json.loads(data)).result(timeout_s=60)).encode()


def _strip(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k not in VOLATILE}


def _front_doors(name: str, weights) -> dict:
    """One package's OpenAI app on the given weights, each body through
    the RPC ingress and through the gRPC ingress."""
    api, serve, runtime, call = PACKAGES[name]
    _down(serve, runtime)
    api.init(num_cpus=16)
    try:
        if name == "ref":
            jbuild_openai_app(JLLMConfig(model_id="tiny", engine=JEngineConfig(
                model=J_FP32_TINY, **ENGINE_KW), params=weights[0]), name="llm",
                route_prefix="/llm")
        else:
            build_openai_app(LLMConfig(model_id="tiny", engine=EngineConfig(
                model=FP32_TINY, **ENGINE_KW), params=weights[1], device="cpu"),
                name="llm", route_prefix="/llm")
        serve.run(serve.deployment(JsonGateway).bind(serve.__name__, "llm"), name="gateway",
                  route_prefix="/gateway", _start_proxy=False)
        rpc = serve.start_rpc_ingress(port=0)
        gr = serve.start_grpc_ingress(port=0)
        via_rpc = [_strip(call(rpc.addr, b, app="llm", method="completions", timeout=WAIT_S))
                   for b in BODIES]
        chan = grpc.insecure_channel(f"{gr.addr[0]}:{gr.addr[1]}")
        try:
            via_grpc = [_strip(json.loads(_unary(chan, "/openai.Gateway/Completions")(
                json.dumps(b).encode(), metadata=(("application", "gateway"),),
                timeout=WAIT_S))) for b in BODIES]
        finally:
            chan.close()
        return {"rpc": via_rpc, "grpc": via_grpc}
    finally:
        _down(serve, runtime)


def test_openai_app_through_rpc_and_grpc_equals_reference():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    weights = (jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY,
                                            device="cpu"))
    ref, port = _front_doors("ref", weights), _front_doors("port", weights)
    assert port == ref
    assert port["rpc"] == port["grpc"]
    one = port["rpc"][0]
    assert one["object"] == "text_completion" and one["usage"]["completion_tokens"] == 12
    assert len(port["rpc"][1]["choices"]) == 3
