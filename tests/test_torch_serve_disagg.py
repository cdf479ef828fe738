"""Disaggregated Serve (``ray_tpu_torch/serve/disagg.py``) and the handle's
pinned and preferred dispatch, held against ``ray_tpu.serve`` on the CPU.

Every scenario runs on both packages, each on its own in-process runtime and
Serve controller, with LLAMA_TINY fp32 and one set of weights (the JAX
package's, copied into the port with ``params_from_numpy``):

 * pinned dispatch routes to exactly one replica and a pin to a replica that
   never was raises ``ReplicaPinError`` (``tests/test_llm_disagg.py:434``);
 * the router's ``prefer`` is soft (``tests/test_llm_kvtier.py:537``);
 * ``build_disagg_openai_app`` end to end: the completion's text equals the
   reference's colocated ``LLMServer``, the pools are role-tagged in
   ``serve.status()``, and the ingress's ``stats()`` keys equal the
   reference ingress's (``tests/test_llm_disagg.py:464``);
 * the prefix-aware ingress routes a repeat of a prompt by the app's index
   (``tests/test_llm_kvtier.py:607``);
 * the mixed-batch export: two prompts longer than the mixed chunk, served
   concurrently through a prefill replica with mixed batching on. The
   reference's ``PrefillServer`` exports every running row, and
   ``export_request`` refuses the one still mid-prompt, so a request fails
   with that ValueError; the port exports complete prompts only and
   returns the colocated engine's tokens (ROADMAP.md Queue 3, "Mixed-batch
   prefill in disaggregated serving", second site).

Every wait on a response has its own limit. The apps deploy with
``route_prefix=None``: no HTTP proxy, so no port is bound.
"""

import asyncio
import concurrent.futures
import dataclasses
import threading
import time
import uuid

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
from ray_tpu.llm.openai_api import LLMServer as JLLMServer
from ray_tpu.models import llama as jllama
from ray_tpu.serve.disagg import build_disagg_openai_app as jbuild_disagg
from ray_tpu.serve.router import ReplicaPinError as JReplicaPinError
from ray_tpu.serve.router import Router as JRouter
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMEngine, LLMServer, SamplingParams
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.disagg import build_disagg_openai_app
from ray_tpu_torch.serve.router import ReplicaPinError, Router

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a response fails past this

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_llm_disagg.py's engine_config
ENGINE_KW = dict(num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=64)
# tests/test_llm_kvtier.py's tiered engine (16-token blocks, 16 of them)
KVT_KW = dict(num_blocks=16, block_size=16, max_num_seqs=4, max_prefill_len=128)
PKG = {
    "ref": dict(serve=jserve, runtime=jrt, api=ray_tpu, build=jbuild_disagg,
                pin_error=JReplicaPinError, router=JRouter),
    "port": dict(serve=tserve, runtime=trt, api=ray_tpu_torch, build=build_disagg_openai_app,
                 pin_error=ReplicaPinError, router=Router),
}


class Req:
    def __init__(self, path, method, body=None):
        self.path, self.method, self._b = path, method, body

    def json(self):
        return self._b


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


def _llm_config(pkg, weights, model_id, **kw):
    if pkg == "ref":
        return JLLMConfig(model_id=model_id, engine=JEngineConfig(model=J_FP32_TINY, **kw),
                          params=weights[0])
    return LLMConfig(model_id=model_id, engine=EngineConfig(model=FP32_TINY, **kw),
                     params=weights[1], device="cpu")


def _stop(pkg):
    """Serve down, then the runtime (the controller belongs to the runtime
    it was started on)."""
    PKG[pkg]["serve"].shutdown()
    if PKG[pkg]["runtime"].is_initialized():
        PKG[pkg]["runtime"].shutdown_runtime()


@pytest.fixture(scope="module")
def runtimes():
    for pkg in PKG:
        _stop(pkg)
        PKG[pkg]["api"].init(num_cpus=32)
    yield
    for pkg in PKG:
        _stop(pkg)


@pytest.fixture
def serve_instance(runtimes):
    yield
    for pkg in PKG:
        PKG[pkg]["serve"].shutdown()


def _ask(handle, body) -> dict:
    return handle.remote(Req("/v1/completions", "POST", dict(body))).result(timeout_s=WAIT_S)


def _roles(serve) -> dict:
    return {name: dep.get("role") for app in serve.status()["applications"].values()
            for name, dep in app["deployments"].items()}


# ---------------------------------------------------------------------------
# the router and the handle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_pinned_dispatch_routes_and_fails_loudly(serve_instance, pkg):
    serve = PKG[pkg]["serve"]

    @serve.deployment(num_replicas=2)
    class Who:
        def __init__(self):
            self.me = uuid.uuid4().hex

        def whoami(self):
            return self.me

    handle = serve.run(Who.bind(), name=f"pin-test-{pkg}", route_prefix=None)
    rids = handle._get_router().replica_ids()
    assert len(rids) == 2
    # pinning routes to exactly the chosen replica, repeatably
    by_rid = {rid: handle.options(pin_replica=rid).whoami.remote().result(timeout_s=WAIT_S)
              for rid in rids}
    assert len(set(by_rid.values())) == 2
    for rid, who in by_rid.items():
        for _ in range(3):
            assert handle.options(pin_replica=rid).whoami.remote().result(
                timeout_s=WAIT_S) == who
    with pytest.raises(PKG[pkg]["pin_error"]):
        handle.options(pin_replica="replica-that-never-was").whoami.remote()
    # a pinned call never failover-retries; an unpinned one keeps its budget
    pinned = handle.options(pin_replica=rids[0]).whoami.remote()
    assert pinned._retry is None and pinned.result(timeout_s=WAIT_S) == by_rid[rids[0]]
    assert handle.whoami.remote()._retry is not None


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_router_prefer_is_soft(pkg):
    """Router._pick honors a healthy, un-overloaded preferred replica and
    silently ignores a dead/suspect/overloaded one: prefer can never fail
    a dispatch the way pin does."""
    cls = PKG[pkg]["router"]
    r = cls.__new__(cls)
    r._lock = threading.Lock()
    r._replicas = [("a", None, 8), ("b", None, 8)]
    r._inflight = {"a": 0, "b": 0}
    r._suspect = {}
    assert cls.PREFER_SLACK == 4
    assert r._pick(prefer="b")[0] == "b"
    assert r._pick(prefer="gone") is not None            # unknown -> p2c
    r._inflight = {"a": 0, "b": cls.PREFER_SLACK + 1}
    assert r._pick(prefer="b")[0] == "a"                 # overloaded -> p2c
    r._inflight = {"a": 0, "b": cls.PREFER_SLACK}
    assert r._pick(prefer="b")[0] == "b"                 # at the slack -> kept
    r._inflight = {"a": 0, "b": 0}
    r._suspect = {"b": time.time() + 60}
    assert r._pick(prefer="b")[0] == "a"                 # suspect -> avoided
    r._suspect = {}
    assert r._pick(exclude={"b"}, prefer="b")[0] == "a"  # excluded -> hard no


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def colocated_text(weights):
    """The reference's colocated LLMServer's completion of BODY."""
    srv = JLLMServer(_llm_config("ref", weights, "t-ref", **ENGINE_KW))
    try:
        return asyncio.run(srv.completions(dict(BODY)))["choices"][0]["text"]
    finally:
        srv.shutdown()


BODY = {"prompt": "serve disagg", "max_tokens": 6, "temperature": 0.0}


def test_serve_disagg_app_end_to_end(serve_instance, weights, colocated_text):
    """Each package's app on one prefill and two decode replicas: text equal
    to the reference's colocated LLMServer (fp32 greedy), and to the port's
    own LLMServer; role-tagged pools; the ingress's stats keys equal."""
    port_srv = LLMServer(_llm_config("port", weights, "t-port", **ENGINE_KW))
    try:
        port_text = asyncio.run(port_srv.completions(dict(BODY)))["choices"][0]["text"]
    finally:
        port_srv.shutdown()
    assert port_text == colocated_text
    stats, texts = {}, {}
    for pkg in ("ref", "port"):
        handle = PKG[pkg]["build"](_llm_config(pkg, weights, "t-serve", **ENGINE_KW),
                                   num_prefill=1, num_decode=2, name=f"disagg-e2e-{pkg}",
                                   route_prefix=None)
        resp = _ask(handle, BODY)
        texts[pkg] = resp["choices"][0]["text"]
        assert resp["usage"]["completion_tokens"] == BODY["max_tokens"]
        stats[pkg] = handle.stats.remote().result(timeout_s=WAIT_S)
        assert stats[pkg]["mode"] == "disagg" and len(stats[pkg]["decode"]) == 2
        assert stats[pkg]["reprefills"] == 0
        roles = _roles(PKG[pkg]["serve"])
        assert roles.get("Prefill:t-serve") == "prefill"
        assert roles.get("Decode:t-serve") == "decode"
        # /v1/stats is the same surface over the route
        got = handle.remote(Req("/v1/stats", "GET")).result(timeout_s=WAIT_S)
        assert set(got) == set(stats[pkg])
        PKG[pkg]["serve"].shutdown()
    assert texts["port"] == texts["ref"] == colocated_text
    assert set(stats["port"]) == set(stats["ref"])
    assert {k: v for k, v in stats["port"].items() if k not in ("decode", "admission")} == {
        k: v for k, v in stats["ref"].items() if k not in ("decode", "admission")}
    assert set(stats["port"]["admission"]) == set(stats["ref"]["admission"])


def test_serve_mode_ingress_prefix_aware(serve_instance, weights):
    """A disagg app whose engines have the tiered cache publishes into the
    app's local prefix index, and the ingress routes a repeat same-prefix
    request by it (prefix_routed counts), on both packages, with the same
    text."""
    body = {"prompt": "hello kv tiers " * 8, "max_tokens": 4, "temperature": 0.0}
    texts = {}
    for pkg in ("ref", "port"):
        handle = PKG[pkg]["build"](
            _llm_config(pkg, weights, "kvt-serve", kvtier=True if pkg == "ref" else {},
                        **KVT_KW),
            num_prefill=1, num_decode=1, name=f"kvt-serve-app-{pkg}",
            route_prefix=None)
        out1 = _ask(handle, body)
        out2 = _ask(handle, body)
        assert out1["choices"][0]["text"] == out2["choices"][0]["text"]
        texts[pkg] = out1["choices"][0]["text"]
        stats = handle.stats.remote().result(timeout_s=WAIT_S)
        assert stats["prefix_routed"] >= 1  # the repeat rode the index
        PKG[pkg]["serve"].shutdown()
    assert texts["port"] == texts["ref"]


def test_mixed_batch_prefill_export(serve_instance, weights):
    """Two 30-token prompts, mixed batching with 8-token chunks, sent at
    once to one prefill replica. The port returns the colocated engine's
    tokens; the reference's PrefillServer exports a row still mid-prompt,
    which export_request refuses, and the request fails."""
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(3, 120, 30)] for _ in range(2)]
    kw = dict(ENGINE_KW, mixed_batch=True, mixed_prefill_chunk=8)
    sampling = {"max_tokens": 8, "temperature": 0.0}
    colocated = LLMEngine(EngineConfig(model=FP32_TINY, **kw), params=weights[1],
                          device="cpu").generate(prompts, SamplingParams(**sampling))
    outcomes = {}
    for pkg in ("ref", "port"):
        handle = PKG[pkg]["build"](_llm_config(pkg, weights, "t-mixed", **kw),
                                   num_prefill=1, num_decode=1, name=f"mixed-{pkg}",
                                   route_prefix=None)
        ingress = _ingress(pkg)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(ingress._generate, p, dict(sampling), f"m{i}")
                    for i, p in enumerate(prompts)]
            got = []
            for f in futs:
                try:
                    got.append(f.result(timeout=WAIT_S)["token_ids"])
                except Exception as e:  # noqa: BLE001 — the outcome under test
                    got.append(type(e).__name__ + ": " + str(e))
        outcomes[pkg] = got
        assert handle is not None
        PKG[pkg]["serve"].shutdown()
    assert outcomes["port"] == colocated
    assert outcomes["ref"] != colocated
    assert any(isinstance(o, str) and "mid-prefill" in o for o in outcomes["ref"]), outcomes["ref"]


def _ingress(pkg):
    """The DisaggIngress instance inside one package's ingress replica
    (actors are threads of this process)."""
    for actor in PKG[pkg]["runtime"].get_runtime().gcs.list_actors():
        inst = getattr(actor, "instance", None)
        if type(inst).__name__ == "Replica" and type(inst._callable).__name__ == "DisaggIngress":
            return inst._callable
    raise AssertionError(f"no DisaggIngress replica in {pkg}")
