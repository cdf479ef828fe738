"""The port's Serve held against ray_tpu's.

The scenarios of ``tests/test_serve.py`` (deploy, replicas and methods,
composition, responses as arguments, user config, status and delete,
autoscaling, streaming, a broken deployment, the shutdown hook, the HTTP
proxy end to end) run on both packages, each on its own in-process
runtime: results and HTTP statuses must be equal.
The port's proxy is the standard library's ``ThreadingHTTPServer``, the
reference's aiohttp; both are driven with ``urllib.request`` on a free
port. A ``KILL_REPLICA`` fault at the replica's ``serve.replica`` site
must be failed over by the router on both, and a replica the chaos runner
kills through the controller's ``kill_replica`` must be replaced. The RPC
and gRPC ingresses answer a call equally on both; their reference
scenarios are in ``tests/test_torch_serve_ingress.py``.
"""

import importlib
import json
import os
import socket
import tempfile
import time
import urllib.error
import urllib.request

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import chaos as jchaos
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu_torch import chaos as tchaos
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a task, a response or a future fails past this

PACKAGES = {"ref": (ray_tpu, jserve, jrt), "port": (ray_tpu_torch, tserve, trt)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(core API, serve) of one package on a fresh runtime; Serve and the
    runtime are torn down after."""
    api, serve, runtime = PACKAGES[request.param]
    _reset(serve, runtime)
    api.init(num_cpus=32)
    yield api, serve
    _reset(serve, runtime)


def _reset(serve, runtime):
    """Serve down, then the runtime: Serve's controller belongs to the
    runtime it was started on, so a runtime restarted under a live Serve
    would leave serve.run talking to a controller of a dead runtime."""
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(method: str, url: str, body=None, timeout: float = 30.0) -> tuple:
    """(status, headers, body bytes) of one request; an HTTP error status is
    a result here, not an exception."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_deploy_function_and_call(pkg):
    _, serve = pkg

    @serve.deployment
    def double(x: int) -> int:
        return 2 * x

    handle = serve.run(double.bind(), name="fn_app", route_prefix=None)
    assert handle.remote(21).result(timeout_s=WAIT_S) == 42


def test_deploy_class_replicas_and_methods(pkg):
    _, serve = pkg

    @serve.deployment(num_replicas=2)
    class Counter:
        def __init__(self, start: int):
            self.start = start

        def __call__(self, x):
            return self.start + x

        def which(self):
            return id(self)

    handle = serve.run(Counter.bind(100), name="cls_app", route_prefix=None)
    assert handle.remote(5).result(timeout_s=WAIT_S) == 105
    ids = {handle.which.remote().result(timeout_s=WAIT_S) for _ in range(20)}
    assert 1 <= len(ids) <= 2
    st = serve.status()["applications"]["cls_app"]["deployments"]["Counter"]
    assert st["replica_states"]["RUNNING"] == 2 and st["target_replicas"] == 2


def test_composition_handle_in_constructor(pkg):
    _, serve = pkg

    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result(timeout_s=WAIT_S) * 10

    handle = serve.run(Model.bind(Preprocess.bind()), name="comp", route_prefix=None)
    assert handle.remote(4).result(timeout_s=WAIT_S) == 50


def test_response_passed_as_argument(pkg):
    _, serve = pkg

    @serve.deployment
    def stage1(x):
        return x * 2

    @serve.deployment
    def stage2(x):
        return x + 1

    h1 = serve.run(stage1.bind(), name="s1", route_prefix=None)
    h2 = serve.run(stage2.bind(), name="s2", route_prefix=None)
    assert h2.remote(h1.remote(10)).result(timeout_s=WAIT_S) == 21


def test_args_reach_the_replica_by_reference(pkg):
    """A tensor bound as a constructor argument and one passed in a call
    are the caller's objects inside the replica."""
    _, serve = pkg
    weights = torch.ones(16)

    @serve.deployment
    class Holder:
        def __init__(self, w):
            self.w = w

        def ptrs(self, x):
            return self.w.data_ptr(), x.data_ptr()

    h = serve.run(Holder.bind(weights), name="byref", route_prefix=None)
    x = torch.zeros(8)
    assert h.ptrs.remote(x).result(timeout_s=WAIT_S) == (weights.data_ptr(), x.data_ptr())


def test_user_config_reconfigure(pkg):
    _, serve = pkg

    @serve.deployment(user_config={"threshold": 5})
    class Thresholder:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self):
            return self.threshold

    handle = serve.run(Thresholder.bind(), name="ucfg", route_prefix=None)
    assert handle.remote().result(timeout_s=WAIT_S) == 5
    serve.run(Thresholder.options(user_config={"threshold": 9}).bind(), name="ucfg",
              route_prefix=None)
    deadline = time.time() + 10
    while time.time() < deadline and handle.remote().result(timeout_s=WAIT_S) != 9:
        time.sleep(0.05)
    assert handle.remote().result(timeout_s=WAIT_S) == 9


def test_status_and_delete(pkg):
    _, serve = pkg

    @serve.deployment
    def f():
        return "ok"

    serve.run(f.bind(), name="stapp", route_prefix=None)
    st = serve.status()
    assert st["applications"]["stapp"]["status"] == "RUNNING"
    assert st["applications"]["stapp"]["deployments"]["f"]["replica_states"]["RUNNING"] >= 1
    assert serve.get_app_handle("stapp").remote().result(timeout_s=WAIT_S) == "ok"
    assert serve.get_deployment_handle("f", "stapp").remote().result(timeout_s=WAIT_S) == "ok"
    serve.delete("stapp")
    assert "stapp" not in serve.status()["applications"]
    with pytest.raises(ValueError):
        serve.get_app_handle("stapp")


def test_autoscaling_scales_up(pkg):
    _, serve = pkg

    @serve.deployment(
        autoscaling_config={"min_replicas": 1, "max_replicas": 4, "target_ongoing_requests": 1,
                            "look_back_period_s": 0.6, "downscale_delay_s": 1.0,
                            "metrics_interval_s": 0.1},
        max_ongoing_requests=2,
    )
    class Slow:
        def __call__(self):
            time.sleep(0.2)
            return "done"

    handle = serve.run(Slow.bind(), name="auto", route_prefix=None)
    responses = [handle.remote() for _ in range(24)]
    deadline = time.time() + 20
    scaled_up = False
    while time.time() < deadline and not scaled_up:
        dep = serve.status()["applications"]["auto"]["deployments"]["Slow"]
        scaled_up = dep["target_replicas"] > 1
        time.sleep(0.05)
    assert [r.result(timeout_s=60) for r in responses] == ["done"] * 24
    assert scaled_up, "autoscaler never scaled up under load"


def test_streaming_handle(pkg):
    _, serve = pkg

    @serve.deployment
    class Streamer:
        def stream(self, n):
            for i in range(n):
                yield i * i

        async def astream(self, n):
            for i in range(n):
                yield -i

    handle = serve.run(Streamer.bind(), name="stream", route_prefix=None)
    assert list(handle.options(method_name="stream", stream=True).remote(4)) == [0, 1, 4, 9]
    assert list(handle.options(method_name="astream", stream=True).remote(3)) == [0, -1, -2]


def test_broken_deployment_reports_failure(pkg):
    _, serve = pkg

    @serve.deployment(graceful_shutdown_timeout_s=0.1)
    class Broken:
        def __init__(self):
            raise RuntimeError("boom in ctor")

        def __call__(self):
            return "never"

    with pytest.raises(RuntimeError) as exc_info:
        serve.run(Broken.bind(), name="broken", route_prefix=None,
                  wait_for_ingress_timeout_s=30)
    assert "failed to deploy" in str(exc_info.value) and "boom in ctor" in str(exc_info.value)
    serve.delete("broken")


def test_user_error_is_not_retried(pkg):
    api, serve = pkg
    calls = []

    @serve.deployment
    def flaky(x):
        calls.append(x)
        raise KeyError(x)

    h = serve.run(flaky.bind(), name="uerr", route_prefix=None)
    with pytest.raises(api.TaskError) as ei:
        h.remote("k").result(timeout_s=WAIT_S)
    assert type(ei.value.cause).__name__ == "KeyError" and calls == ["k"]


def test_shutdown_hook_runs_on_delete(pkg):
    _, serve = pkg
    marker = tempfile.mktemp()

    @serve.deployment(graceful_shutdown_timeout_s=1.0)
    class WithCleanup:
        def __call__(self):
            return "ok"

        def __del__(self):
            with open(marker, "w") as f:
                f.write("cleaned")

    h = serve.run(WithCleanup.bind(), name="cleanup", route_prefix=None)
    assert h.remote().result(timeout_s=WAIT_S) == "ok"
    serve.delete("cleanup")
    deadline = time.time() + 10
    while time.time() < deadline and not os.path.exists(marker):
        time.sleep(0.05)
    assert os.path.exists(marker), "__del__ cleanup hook never ran on teardown"
    os.unlink(marker)


def test_http_proxy_end_to_end(pkg):
    _, serve = pkg

    @serve.deployment
    class Echo:
        def __call__(self, request):
            if request.method == "POST":
                data = request.json()
                return {"sum": data["a"] + data["b"]}
            if request.path == "/text":
                return "plain"
            if request.path == "/fail":
                raise ValueError("bad input")
            if request.path == "/teapot":
                return {"error": {"message": "busy", "code": 429, "retry_after": 1.2}}
            return {"path": request.path, "q": request.query.get("name")}

    port = free_port()
    serve.start(host="127.0.0.1", port=port)
    serve.run(Echo.bind(), name="httpapp", route_prefix="/echo")
    base = f"http://127.0.0.1:{port}"
    st, _, body = http("GET", f"{base}/-/healthz")
    assert (st, body) == (200, b"success")
    st, _, body = http("GET", f"{base}/-/routes")
    assert st == 200 and json.loads(body) == {"/echo": "httpapp"}
    st, _, body = http("GET", f"{base}/echo/sub?name=gpu")
    assert st == 200 and json.loads(body) == {"path": "/sub", "q": "gpu"}
    st, _, body = http("GET", f"{base}/echo")
    assert st == 200 and json.loads(body) == {"path": "/", "q": None}
    st, _, body = http("POST", f"{base}/echo", {"a": 2, "b": 3})
    assert st == 200 and json.loads(body) == {"sum": 5}
    st, _, body = http("GET", f"{base}/echo/text")
    assert (st, body) == (200, b"plain")
    st, _, body = http("GET", f"{base}/echo/fail")
    assert st == 500 and body.decode().startswith("TaskError: ") and "bad input" in body.decode()
    st, headers, body = http("GET", f"{base}/echo/teapot")
    assert st == 429 and headers["Retry-After"] == "2"
    assert json.loads(body)["error"]["message"] == "busy"
    st, _, body = http("GET", f"{base}/nope")
    assert st == 404 and body == b"no route for /nope"


def test_unported_ingresses_raise():
    """Ported since: both front doors start on both packages and answer a
    deployment's call equally (``tests/test_torch_serve_ingress.py`` holds
    the reference scenarios)."""
    import grpc

    from ray_tpu.serve.rpc_ingress import rpc_ingress_call as jcall
    from ray_tpu_torch.serve.rpc_ingress import rpc_ingress_call as tcall

    answers = {}
    for name, call in (("ref", jcall), ("port", tcall)):
        api, serve, runtime = PACKAGES[name]
        _reset(serve, runtime)
        api.init(num_cpus=4)
        try:
            @serve.deployment
            def echo(x):
                return x if isinstance(x, bytes) else {"echo": x}

            serve.run(echo.bind(), name="echo", route_prefix="/echo", _start_proxy=False)
            rpc, gr = serve.start_rpc_ingress(), serve.start_grpc_ingress()
            chan = grpc.insecure_channel(f"{gr.addr[0]}:{gr.addr[1]}")
            try:
                via_grpc = chan.unary_unary("/e.E/Call", request_serializer=lambda b: b,
                                            response_deserializer=lambda b: b)(
                    b"ping", timeout=WAIT_S)
            finally:
                chan.close()
            answers[name] = (call(rpc.addr, 7, timeout=WAIT_S), via_grpc)
        finally:
            _reset(serve, runtime)
    assert answers["port"] == answers["ref"] == ({"echo": 7}, b"ping")


CHAOS = {"ref": jchaos, "port": tchaos}


def test_kill_replica_fails_over(pkg):
    """KILL_REPLICA at ``serve.replica`` crashes the first request on its
    replica; the handle's failover re-dispatches it to the other one."""
    api, serve = pkg
    chaos = CHAOS["ref" if api is ray_tpu else "port"]

    @serve.deployment(num_replicas=2)
    class Who:
        def __call__(self, x):
            return x * 3

    h = serve.run(Who.bind(), name="chaosapp", route_prefix=None)
    sched = chaos.FaultSchedule(seed=3, faults=[
        chaos.FaultSpec(chaos.KILL_REPLICA, site="serve.replica", max_fires=1)])
    chaos.install(sched)
    try:
        assert h.remote(7).result(timeout_s=WAIT_S) == 21
        assert [h.remote(i).result(timeout_s=WAIT_S) for i in range(4)] == [0, 3, 6, 9]
    finally:
        chaos.uninstall()
    assert sched.decisions() == [(chaos.KILL_REPLICA, "serve.replica", 0)]
    # without failover the crash reaches the caller as the replica's death
    sched = chaos.FaultSchedule(seed=3, faults=[
        chaos.FaultSpec(chaos.KILL_REPLICA, site="serve.replica", max_fires=1)])
    chaos.install(sched)
    try:
        with pytest.raises(api.TaskError) as ei:
            h.options(system_retries=0).remote(1).result(timeout_s=WAIT_S)
    finally:
        chaos.uninstall()
    assert type(ei.value.cause).__name__ == "ReplicaCrashed"


def test_orchestrated_kill_replica_controller_replaces_it(pkg):
    """The scenario of ``tests/test_chaos.py``'s controller replacement:
    the chaos runner's KILL_REPLICA kills a replica through the
    controller's ``kill_replica``; requests keep completing, and the health
    sweep swaps the corpse for a fresh replica (back to 2 running)."""
    api, serve = pkg
    name = "ref" if api is ray_tpu else "port"
    chaos = CHAOS[name]
    runner_mod = importlib.import_module(f"{'ray_tpu' if name == 'ref' else 'ray_tpu_torch'}"
                                         ".chaos.runner")

    @serve.deployment(num_replicas=2)
    class Sq:
        def __call__(self, x):
            return x * x

    h = serve.run(Sq.bind(), name="chaos_failover", route_prefix=None)
    assert [h.remote(i).result(timeout_s=WAIT_S) for i in range(4)] == [0, 1, 4, 9]
    ctrl = serve.api._get_controller_handle()
    sched = chaos.FaultSchedule(7, [chaos.FaultSpec(chaos.KILL_REPLICA,
                                                    target="chaos_failover/Sq", at_s=0.05)])
    runner = runner_mod.ChaosRunner(sched, controller_handle=ctrl).start()
    runner.join(timeout=WAIT_S)
    runner.stop()
    assert [f.kind for f in runner.executed] == [chaos.KILL_REPLICA]
    killed = runner.executed[0].attrs["replica_id"]
    assert killed
    assert [h.remote(i).result(timeout_s=WAIT_S) for i in range(10)] == [i * i for i in range(10)]
    deadline = time.time() + 30
    ids = []
    while time.time() < deadline:
        info = api.get(ctrl.get_running_replicas.remote("chaos_failover", "Sq"), timeout=WAIT_S)
        ids = [x[0] for x in info["replicas"]]
        if killed not in ids and len(ids) >= 2:
            break
        time.sleep(0.2)
    assert killed not in ids and len(ids) >= 2, ids
    # an unknown deployment kills nothing
    assert api.get(ctrl.kill_replica.remote("chaos_failover", "Nope"), timeout=WAIT_S) is None
