"""The pool autoscaler driving Serve: the controller's pool surface on both
packages, and the closed loop on the port.

 * **The pool surface** (``ServeController.set_pool_target`` /
   ``pool_state``), driven through each package's ``ServePoolActuator`` over
   its controller's actor handle: role-tagged deployments, one of them with
   its own ``autoscaling_config``. The answers of ``set_pool_target``, the
   converged ``pool_state`` and the targets in ``serve.status()`` are equal
   on both packages, and the deployment with its own ``autoscaling_config``
   is skipped on both.
 * **The closed loop**: LLAMA_TINY fp32, ``build_disagg_openai_app(1, 1)`` on
   the port's in-process runtime, a ``TelemetryReporter`` pushing the
   process's registry to a port ``GcsServer``, and a ``PoolAutoscaler``
   reading it through the real ``autoscale_signals`` RPC and acting through
   a ``ServePoolActuator``. A burst whose prefill engine is slowed (each of
   its steps waits 0.6 s before it runs, so the requests queue: a TTFT over
   the 0.25 s threshold while the prefill span stays short) breaches TTFT;
   the pool goes 1 -> 2, then quiet requests one at a time turn the grade
   green and the pool drains back to 1. No request is lost, and every
   greedy text equals the reference ``LLMServer``'s on the same weights.

Every wait has its own bound, named in its failure. The apps deploy with
``route_prefix=None``: no HTTP proxy, so no port is bound.
"""

import asyncio
import concurrent.futures
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import autoscale as jautoscale
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.openai_api import LLMConfig as JLLMConfig
from ray_tpu.llm.openai_api import LLMServer as JLLMServer
from ray_tpu.models import llama as jllama
from ray_tpu.serve.config import AutoscalingConfig as JAutoscalingConfig
from ray_tpu_torch import autoscale as tautoscale
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.llm import EngineConfig, LLMConfig
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.config import AutoscalingConfig
from ray_tpu_torch.serve.disagg import build_disagg_openai_app

pytestmark = [pytest.mark.torch_port, pytest.mark.autoscale]
torch.set_num_threads(2)
WAIT_S = 60  # every wait fails past this

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=64)
PKG = {
    "ref": dict(serve=jserve, runtime=jrt, api=ray_tpu, A=jautoscale,
                Autoscaling=JAutoscalingConfig),
    "port": dict(serve=tserve, runtime=trt, api=ray_tpu_torch, A=tautoscale,
                 Autoscaling=AutoscalingConfig),
}


class Req:
    def __init__(self, path, method, body=None):
        self.path, self.method, self._b = path, method, body

    def json(self):
        return self._b


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


def _wait(cond, what: str, timeout_s: float = WAIT_S, poll_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"waited {timeout_s} s for {what}")
        time.sleep(poll_s)


# ---------------------------------------------------------------------------
# the controller's pool surface, on both packages
# ---------------------------------------------------------------------------


def _pool_app(pkg):
    serve = PKG[pkg]["serve"]

    class Worker:
        def __call__(self, x=None):
            return x

    pre = serve.deployment(Worker, name="P", num_replicas=1, role="prefill")
    dec = serve.deployment(Worker, name="D", num_replicas=1, role="decode")
    # its own queue-depth loop owns its target: the pool surface skips it
    own = serve.deployment(Worker, name="Q", role="prefill",
                           autoscaling_config=PKG[pkg]["Autoscaling"](
                               min_replicas=1, max_replicas=3, initial_replicas=1))
    for dep, app in ((pre, "pool-p"), (dec, "pool-d"), (own, "pool-q")):
        serve.run(dep.bind(), name=app, route_prefix=None)


def _converged(act, prefill: int):
    """pool_state once the prefill pool runs ``prefill`` replicas and each
    pool runs its target."""
    st = act.pool_state()
    if st.get("prefill", {}).get("replicas_running") != prefill:
        return None
    if any(p["replicas_running"] != p["replicas_target"] for p in st.values()):
        return None
    return st


def test_serve_pool_surface_matches_reference(runtimes):
    got = {}
    for pkg in ("ref", "port"):
        serve, A = PKG[pkg]["serve"], PKG[pkg]["A"]
        try:
            _pool_app(pkg)
            act = A.ServePoolActuator(serve.api._get_controller_handle())
            steps = [_wait(lambda: _converged(act, 2), f"{pkg}: the pools to come up")]
            out = act._call("set_pool_target", "prefill", 3)
            steps.append(_wait(lambda: _converged(act, 4), f"{pkg}: prefill to reach 3 + 1"))
            act.apply(A.Decision("prefill", A.ACTION_SCALE_DOWN, target=1, reason="test"))
            steps.append(_wait(lambda: _converged(act, 2), f"{pkg}: prefill to drain to 1 + 1"))
            # a decision the policy holds on changes nothing
            act.apply(A.Decision("decode", A.ACTION_HOLD, target=None, reason="test"))
            steps.append(act.pool_state())
            only = act._call("pool_state", "decode")
            status = {app: {d: (s["target_replicas"], s.get("role"))
                            for d, s in v["deployments"].items()}
                      for app, v in serve.status()["applications"].items()}
            got[pkg] = (out, steps, only, status)
        finally:
            for app in ("pool-p", "pool-d", "pool-q"):
                serve.delete(app)
    assert got["port"] == got["ref"]
    out, steps, only, status = got["port"]
    assert out == {"role": "prefill", "target": 3, "deployments": ["pool-p/P"]}
    assert [s["prefill"]["replicas_target"] for s in steps] == [2, 4, 2, 2]
    assert list(only) == ["decode"] and status["pool-q"]["Q"] == (1, "prefill")


def test_draining_replica_refuses_and_the_handle_reroutes(runtimes):
    """A router may hold a replica for one refresh period after its drain
    began. On both packages: two replicas, one of them past
    ``prepare_shutdown``, 20 calls through the handle, all answered. The
    reference's draining replica serves its share; the port's refuses a
    new call with ``ActorUnavailableError`` and the handle's failover serves
    it on the other replica (ROADMAP Queue 3, pinned divergence)."""
    served = {}
    for pkg in ("ref", "port"):
        serve, rt = PKG[pkg]["serve"], PKG[pkg]["runtime"]

        class Echo:
            def __call__(self, x):
                return x

        h = serve.run(serve.deployment(Echo, num_replicas=2, graceful_shutdown_timeout_s=1.0)
                      .bind(), name="drain-refuse", route_prefix=None)
        try:
            reps = _wait(lambda: (lambda r: r if len(r) == 2 else None)(
                [a.instance for a in rt.get_runtime().gcs.list_actors()
                 if type(a.instance).__name__ == "Replica"
                 and type(a.instance._callable).__name__ == "Echo"]), f"{pkg}: two replicas")
            _wait(lambda: len(h._get_router().replica_ids()) == 2,
                  f"{pkg}: the router to see both replicas")
            draining = reps[0]
            asyncio.run(draining.prepare_shutdown(0.1))
            if pkg == "port":
                import ray_tpu_torch.core.errors as errors

                with pytest.raises(errors.ActorUnavailableError):
                    asyncio.run(draining.handle_request(None, (1,), {}))
            before = draining._num_processed
            assert [h.remote(i).result(timeout_s=WAIT_S) for i in range(20)] == list(range(20))
            served[pkg] = draining._num_processed - before
        finally:
            serve.delete("drain-refuse")
    assert served["port"] == 0 and served["ref"] > 0, served


# ---------------------------------------------------------------------------
# the closed loop on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


def _replicas(cls_name: str) -> list:
    out = []
    for a in trt.get_runtime().gcs.list_actors():
        inst = a.instance
        if type(inst).__name__ == "Replica" and type(inst._callable).__name__ == cls_name:
            out.append(inst._callable)
    return out


def _ask(handle, prompt: str) -> dict:
    body = {"prompt": prompt, "max_tokens": 6, "temperature": 0.0}
    return handle.remote(Req("/v1/completions", "POST", body)).result(timeout_s=WAIT_S)


def test_closed_loop_scales_prefill_pool_1_2_1(runtimes, weights):
    from ray_tpu_torch.cluster.gcs_service import GcsServer
    from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient
    from ray_tpu_torch.obs.telemetry import TelemetryReporter
    from ray_tpu_torch.util.metrics import clear_registry

    A = tautoscale
    # the grades are the worst over every model tag the GCS holds: start
    # from a registry with no other test's serving series
    clear_registry()
    cfg = LLMConfig(model_id="loop", engine=EngineConfig(model=FP32_TINY, **ENGINE_KW),
                    params=weights[1], device="cpu")
    handle = build_disagg_openai_app(cfg, num_prefill=1, num_decode=1, name="as-loop",
                                     route_prefix=None)
    server = GcsServer(port=0)
    addr = server.start()
    reporter = TelemetryReporter(addr, reporter_id="serve", kind="engine", interval_s=0.1)
    gcs = ReconnectingRpcClient(*addr, timeout=5).connect()
    act = A.ServePoolActuator(tserve.api._get_controller_handle())
    auto = A.PoolAutoscaler(
        A.AutoscaleConfig(pools={A.POOL_PREFILL: A.PoolLimits(1, 2),
                                 A.POOL_DECODE: A.PoolLimits(1, 1)},
                          breach_ticks=2, green_ticks=2, scale_up_cooldown_s=0.0,
                          scale_down_cooldown_s=1.0, interval_s=0.2),
        act, gcs=gcs, thresholds={"ttft_p_s": 0.25, "percentile": 50, "min_count": 4})
    sent, texts = [], []
    try:
        reporter.start()
        auto.start()
        (first,) = _replicas("PrefillServer")
        # the burst: every prefill step waits 0.6 s before it runs
        real_step = first.engine.step

        def slow_step():
            time.sleep(0.6)
            return real_step()

        first.engine.step = slow_step
        burst = [f"burst request {i}" for i in range(6)]
        with concurrent.futures.ThreadPoolExecutor(len(burst)) as pool:
            outs = list(pool.map(lambda p: _ask(handle, p), burst))
        del first.engine.step
        sent += burst
        texts += [o["choices"][0]["text"] for o in outs]
        _wait(lambda: act.pool_state()["prefill"]["replicas_running"] == 2,
              "the prefill pool to run 2 replicas")
        ups = [e for e in auto.decision_log() if e["action"] == A.ACTION_SCALE_UP]
        assert [(e["pool"], e["target"]) for e in ups] == [("prefill", 2)], ups
        assert "breach" in ups[0]["reason"] or "span-sized" in ups[0]["reason"]
        added = [s for s in _replicas("PrefillServer") if s is not first]
        assert len(added) == 1
        # the added replica's engine holds the caller's tensors
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(
            tllama.sorted_leaves(added[0].engine.params), tllama.sorted_leaves(weights[1])))
        # quiet traffic, one request at a time, until the pool drained to 1
        deadline = time.monotonic() + WAIT_S
        i = 0
        while act.pool_state()["prefill"]["replicas_running"] != 1 or i < 8:
            assert time.monotonic() < deadline, \
                f"waited {WAIT_S} s for the prefill pool to drain to 1 ({i} quiet requests)"
            prompt = f"quiet request {i}"
            out = _ask(handle, prompt)
            sent.append(prompt)
            texts.append(out["choices"][0]["text"])
            i += 1
            time.sleep(0.02)
        downs = [e for e in auto.decision_log() if e["action"] == A.ACTION_SCALE_DOWN]
        assert [(e["pool"], e["target"]) for e in downs] == [("prefill", 1)], downs
        # the victim (either replica: the controller stops the least loaded)
        # ran its drain: its loop exited; the other still serves
        victims = _wait(lambda: [s for s in (first, added[0]) if not s._loop.thread.is_alive()],
                        "the drained replica's loop to exit")
        assert len(victims) == 1
        assert not any(e["pool"] == "decode" and e["action"] != A.ACTION_HOLD
                       for e in auto.decision_log())
        _wait(lambda: _health_ok(gcs), "the GCS's autoscale block to show 1 up, 1 down, "
              "a prefill target of 1")
    finally:
        auto.stop()
        reporter.stop()
        gcs.close()
        server.stop()
        tserve.delete("as-loop")
    assert len(texts) == len(sent)  # no request lost
    srv = JLLMServer(JLLMConfig(model_id="loop-ref",
                                engine=JEngineConfig(model=J_FP32_TINY, **ENGINE_KW),
                                params=weights[0]))
    try:
        want = [asyncio.run(srv.completions({"prompt": p, "max_tokens": 6,
                                             "temperature": 0.0}))["choices"][0]["text"]
                for p in sent]
    finally:
        srv.shutdown()
    assert texts == want


def _health_ok(gcs) -> bool:
    st = gcs.call("telemetry_status", {}, timeout=5)["autoscale"]
    return (st["scale_ups_total"] or 0) >= 1 and (st["scale_downs_total"] or 0) >= 1 \
        and st["pool_targets"].get("prefill") == 1
