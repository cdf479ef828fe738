"""The port's in-process core runtime held against ray_tpu's.

Every scenario of ``tests/test_core_api.py`` (tasks, chaining, error
propagation, put/get, ``num_returns``, wait, resources, streaming
generators, actors, named, killed and restarted actors, async actors) runs
on both packages, each with its own process-global runtime started and
torn down by the fixture: the values must be equal and the error types
must have the same names. Then what is the port's own: tensors through
``put``/``get`` by reference, the ``"GPU"`` resource, and the parts that
once raised ``NotImplementedError`` naming their ROADMAP item, each ported
since: ``worker_mode="process"`` and ``init(address=...)`` run a task in a
worker process, and ``.bind`` on a remote function and an actor method
builds the reference's DAG nodes (the actor method's compiled and run on
both packages).
"""

import asyncio
import os
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a task, a response or a future fails past this

PACKAGES = {"ref": (ray_tpu, jrt, jserve), "port": (ray_tpu_torch, trt, tserve)}


def _reset(runtime, serve):
    """Serve down, then the runtime: Serve's controller belongs to the
    runtime it was started on, so a runtime restarted under a live Serve
    would leave serve.run talking to a controller of a dead runtime."""
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()


@pytest.fixture(params=sorted(PACKAGES))
def rt(request):
    """One package's API with its runtime started (4 CPUs), torn down after."""
    api, runtime, serve = PACKAGES[request.param]
    _reset(runtime, serve)
    api.init(num_cpus=4)
    yield api
    _reset(runtime, serve)


def _raises(fn) -> tuple:
    """(error type name, message) of what ``fn()`` raises."""
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__, str(e)
    raise AssertionError("nothing raised")


def test_task_basic(rt):
    f = rt.remote(lambda x: x + 1)
    assert rt.get(f.remote(1), timeout=WAIT_S) == 2
    assert rt.get([f.remote(i) for i in range(10)], timeout=WAIT_S) == list(range(1, 11))


def test_task_chaining_and_deps(rt):
    @rt.remote
    def f(x):
        return x * 2

    r = f.remote(1)
    for _ in range(5):
        r = f.remote(r)
    assert rt.get(r, timeout=WAIT_S) == 64


def test_task_error_propagates(rt):
    @rt.remote
    def boom():
        raise ValueError("kapow")

    name, msg = _raises(lambda: rt.get(boom.remote(), timeout=WAIT_S))
    assert name == "TaskError" and "kapow" in msg
    with pytest.raises(rt.TaskError) as ei:
        rt.get(boom.remote(), timeout=WAIT_S)
    assert isinstance(ei.value.cause, ValueError)


def test_error_propagates_through_deps(rt):
    @rt.remote
    def boom():
        raise ValueError("root cause")

    @rt.remote
    def g(x):
        return x

    name, msg = _raises(lambda: rt.get(g.remote(boom.remote()), timeout=WAIT_S))
    assert name == "TaskError" and "root cause" in msg


def test_put_get_by_reference(rt):
    arr = np.arange(1000)
    assert rt.get(rt.put(arr), timeout=WAIT_S) is arr
    t = torch.arange(1000, dtype=torch.float32)
    out = rt.get(rt.put(t), timeout=WAIT_S)
    assert out is t and out.data_ptr() == t.data_ptr()


def test_task_args_by_reference(rt):
    """A tensor handed to a task arrives as the caller's object."""
    t = torch.ones(64)
    ptr = rt.remote(lambda x: x.data_ptr())
    assert rt.get(ptr.remote(t), timeout=WAIT_S) == t.data_ptr()
    assert rt.get(ptr.remote(rt.put(t)), timeout=WAIT_S) == t.data_ptr()


def test_num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c], timeout=WAIT_S) == [1, 2, 3]

    @rt.remote(num_returns=2)
    def wrong():
        return 1, 2, 3

    name, msg = _raises(lambda: rt.get(wrong.remote()[0], timeout=WAIT_S))
    assert name == "TaskError" and "num_returns=2" in msg


def test_wait(rt):
    gate = threading.Event()

    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        gate.wait(30)
        return "slow"

    s, f = slow.remote(), fast.remote()
    ready, not_ready = rt.wait([s, f], num_returns=1, timeout=10)
    assert ready == [f] and not_ready == [s]
    gate.set()
    assert rt.get(s, timeout=30) == "slow"
    name, _ = _raises(lambda: rt.wait([f, f]))
    assert name == "ValueError"


def test_get_timeout(rt):
    gate = threading.Event()
    blocked = rt.remote(lambda: gate.wait(30)).remote()
    name, _ = _raises(lambda: rt.get(blocked, timeout=0.05))
    gate.set()
    assert name == "GetTimeoutError" and issubclass(rt.GetTimeoutError, TimeoutError)


def test_options_override(rt):
    f = rt.remote(lambda: 1)
    assert rt.get(f.options(num_cpus=2).remote(), timeout=WAIT_S) == 1
    assert _raises(lambda: f.options(bogus_option=1))[0] == "TypeError"


def test_resource_limits_concurrency(rt):
    running, peak = [], []
    lock = threading.Lock()

    @rt.remote(num_cpus=2)
    def task(i):
        with lock:
            running.append(i)
            peak.append(len(running))
        time.sleep(0.1)
        with lock:
            running.remove(i)
        return i

    assert sorted(rt.get([task.remote(i) for i in range(6)], timeout=WAIT_S)) == list(range(6))
    assert max(peak) <= 2  # 4 CPUs / 2 per task


def test_streaming_generator(rt):
    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    assert [rt.get(ref, timeout=WAIT_S) for ref in gen.remote(5)] == [0, 10, 20, 30, 40]

    @rt.remote(num_returns="streaming")
    def broken():
        yield 1
        raise RuntimeError("mid-stream")

    refs = list(broken.remote())
    assert rt.get(refs[0], timeout=WAIT_S) == 1
    name, msg = _raises(lambda: rt.get(refs[1], timeout=WAIT_S))
    assert name == "TaskError" and "mid-stream" in msg


def test_actor_counter(rt):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote()
    # in order
    assert rt.get([c.incr.remote() for _ in range(10)], timeout=WAIT_S) == list(range(1, 11))


def test_actor_error_and_survives(rt):
    @rt.remote
    class A:
        def bad(self):
            raise RuntimeError("oops")

        def good(self):
            return "ok"

    a = A.remote()
    assert _raises(lambda: rt.get(a.bad.remote(), timeout=WAIT_S))[0] == "TaskError"
    assert rt.get(a.good.remote(), timeout=WAIT_S) == "ok"
    assert _raises(lambda: a.missing)[0] == "AttributeError"


def test_actor_ctor_failure(rt):
    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("ctor boom")

        def m(self):
            return 1

    b = Broken.remote()
    name, msg = _raises(lambda: rt.get(b.m.remote(), timeout=WAIT_S))
    assert name == "ActorDiedError" and "ctor boom" in msg


def test_named_actor(rt):
    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    svc = Svc.options(name="svc1").remote()  # noqa: F841 — the handle keeps it alive
    assert rt.get(rt.get_actor("svc1").ping.remote(), timeout=WAIT_S) == "pong"
    assert _raises(lambda: Svc.options(name="svc1").remote())[0] == "ValueError"
    got = Svc.options(name="svc1", get_if_exists=True).remote()
    assert rt.get(got.ping.remote(), timeout=WAIT_S) == "pong"
    assert _raises(lambda: rt.get_actor("nobody"))[0] == "ValueError"


def test_kill_actor(rt):
    @rt.remote
    class A:
        def m(self):
            return 1

    a = A.remote()
    assert rt.get(a.m.remote(), timeout=WAIT_S) == 1
    rt.kill(a)
    time.sleep(0.1)
    assert _raises(lambda: rt.get(a.m.remote(), timeout=WAIT_S))[0] == "ActorDiedError"


def test_actor_restart(rt):
    @rt.remote(max_restarts=1)
    class A:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    a = A.remote()
    assert rt.get([a.incr.remote(), a.incr.remote()], timeout=WAIT_S) == [1, 2]
    rt.kill(a, no_restart=False)
    time.sleep(0.2)
    assert rt.get(a.incr.remote(), timeout=WAIT_S) == 1  # the constructor ran again


def test_async_actor(rt):
    @rt.remote(max_concurrency=8)
    class AsyncSvc:
        async def slow_echo(self, x):
            await asyncio.sleep(0.2)
            return x

        async def loop_id(self):
            return id(asyncio.get_running_loop())

    svc = AsyncSvc.remote()
    t0 = time.monotonic()
    assert rt.get([svc.slow_echo.remote(i) for i in range(8)], timeout=WAIT_S) == list(range(8))
    assert time.monotonic() - t0 < 1.2  # 8 x 0.2 s of sleep overlap
    # every call runs on the actor's own event loop
    assert len(set(rt.get([svc.loop_id.remote() for _ in range(4)], timeout=WAIT_S))) == 1


def test_actor_resource_released_on_death(rt):
    @rt.remote(num_cpus=4)
    class Big:
        def m(self):
            return 1

    b = Big.remote()
    assert rt.get(b.m.remote(), timeout=WAIT_S) == 1
    assert rt.available_resources().get("CPU", 0) == 0
    rt.kill(b)
    time.sleep(0.3)
    assert rt.available_resources().get("CPU", 0) == 4


def test_cluster_resources(rt):
    res = rt.cluster_resources()
    assert res["CPU"] == 4 and "TPU" not in res


def test_actor_handle_in_task(rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v
            return True

        def get(self, k):
            return self.v.get(k)

    @rt.remote
    def writer(store, k, v):
        return rt.get(store.set.remote(k, v), timeout=WAIT_S)

    s = Store.remote()
    assert rt.get(writer.remote(s, "a", 1), timeout=WAIT_S) is True
    assert rt.get(s.get.remote("a"), timeout=WAIT_S) == 1


def test_placement_group(rt):
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=10)
    f = rt.remote(lambda: "in bundle").options(
        scheduling_strategy=rt.PlacementGroupSchedulingStrategy(pg, 1))
    assert rt.get(f.remote(), timeout=WAIT_S) == "in bundle"
    assert rt.available_resources()["CPU"] == 2
    assert "CREATED" in repr(pg)
    rt.remove_placement_group(pg)
    deadline = time.time() + 10
    while rt.available_resources()["CPU"] != 4 and time.time() < deadline:
        time.sleep(0.02)
    assert rt.available_resources()["CPU"] == 4


def test_task_events_record_lifecycle(rt):
    from importlib import import_module

    runtime = import_module(f"{rt.__name__}.core.runtime").get_runtime()
    rt.get(rt.remote(lambda: 1).options(name="probe").remote(), timeout=WAIT_S)
    states = [e.state for e in runtime.task_events.events() if e.name.startswith("probe")]
    assert states == ["SUBMITTED", "RUNNING", "FINISHED"]


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


@pytest.fixture
def port_rt():
    _reset(trt, tserve)
    yield ray_tpu_torch
    _reset(trt, tserve)


def test_estimate_nbytes_of_a_tensor():
    from ray_tpu_torch.core.object_store import ObjectStore, _estimate_nbytes

    t = torch.zeros(4, 8, dtype=torch.bfloat16)
    assert _estimate_nbytes(t) == 64
    assert _estimate_nbytes(t[1]) == 64  # a view keeps its whole storage
    assert _estimate_nbytes(np.zeros(10, np.float32)) == 40
    store, oid = ObjectStore(), ray_tpu_torch.utils.ObjectID.from_random()
    store.put(oid, t)
    assert store.stats()["used_bytes"] == 64 and store.get(oid) is t
    store.remove_ref(oid)
    assert store.stats()["num_objects"] == 0


def test_gpu_resource(port_rt):
    port_rt.init(num_cpus=2, num_gpus=1)
    res = port_rt.cluster_resources()
    assert res["GPU"] == 1 and "TPU" not in res

    @port_rt.remote(num_gpus=1)
    def on_card():
        return port_rt.available_resources().get("GPU", 0)

    assert port_rt.get(on_card.remote()) == 0
    assert port_rt.available_resources()["GPU"] == 1
    assert _raises(lambda: port_rt.remote(num_tpus=1)(lambda: 0))[0] == "TypeError"


@pytest.mark.parametrize("env,count", [("0,1", 2), ("", 0), ("0,-1,2", 1), (None, 0)])
def test_detect_gpus(monkeypatch, env, count):
    """CUDA_VISIBLE_DEVICES as CUDA reads it; unset, torch's count (0 on a
    CPU build)."""
    if env is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        count = torch.cuda.device_count()
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
    assert trt._detect_gpus() == count


def test_default_resources_have_no_tpu(port_rt):
    port_rt.init(num_cpus=2)
    assert "TPU" not in port_rt.cluster_resources()
    assert port_rt.cluster_resources().get("GPU", 0) == trt._detect_gpus()


@pytest.mark.parametrize("case", ["worker_mode", "address", "task_bind", "method_bind"])
def test_unported_parts_raise(port_rt, case):
    if case == "worker_mode":
        # ported since: process mode starts and runs a task in a worker process
        port_rt.init(num_cpus=2, worker_mode="process")
        assert trt.get_runtime().worker_mode == "process"
        pid = port_rt.get(port_rt.remote(lambda: os.getpid()).remote(), timeout=WAIT_S)
        assert pid != os.getpid()
        return
    if case == "address":
        # ported since: an attach to a GCS runs a task in a worker process
        from ray_tpu_torch.cluster import LocalCluster

        c = LocalCluster(node_death_timeout_s=2.0)
        try:
            c.start()
            c.add_node({"num_cpus": 1}, node_id="head")
            c.wait_for_nodes(1, timeout=WAIT_S)
            port_rt.init(address=c.address)
            node, pid = port_rt.get(port_rt.remote(
                lambda: (os.environ.get("RAY_TPU_NODE_ID"), os.getpid())).remote(),
                timeout=WAIT_S)
            assert node == "head" and pid != os.getpid()
        finally:
            port_rt.shutdown()
            c.shutdown()
        assert c.leftovers() == {"processes": [], "store_files": []}
        return
    # ported since: .bind builds the same DAG nodes as the reference's, and
    # an actor method's node compiles and runs there
    answers = {}
    for name, (api, runtime, serve) in PACKAGES.items():
        _reset(runtime, serve)
        api.init(num_cpus=2)
        try:
            answers[name] = _bind_case(api, case)
        finally:
            _reset(runtime, serve)
    assert answers["port"] == answers["ref"]


def _bind_case(api, case: str) -> tuple:
    if case == "task_bind":
        def double(x, y=0):
            return 2 * x + y

        node = api.remote(double).bind(3, y=1)
        return type(node).__name__, node.args, node.kwargs, node.task_name, node.upstream

    import importlib

    class A:
        def m(self, x, y=0):
            return x + y

    dag = importlib.import_module(f"{api.__name__}.dag")
    with dag.InputNode() as inp:
        node = api.remote(A).remote().m.bind(inp, y=1)
    compiled = node.experimental_compile()
    try:
        out = [compiled.execute(i).get(timeout=WAIT_S) for i in range(3)]
    finally:
        compiled.teardown()
    return type(node).__name__, node.method_name, node.kwargs, out


def test_two_runtimes_in_one_process(port_rt):
    """Each package has its own process-global runtime: starting and
    stopping one leaves the other as it was."""
    _reset(jrt, jserve)
    ray_tpu.init(num_cpus=3)
    try:
        port_rt.init(num_cpus=2)
        assert ray_tpu.cluster_resources()["CPU"] == 3
        assert port_rt.cluster_resources()["CPU"] == 2
        trt.shutdown_runtime()
        assert jrt.is_initialized() and not trt.is_initialized()
        assert ray_tpu.get(ray_tpu.put(7)) == 7
    finally:
        _reset(jrt, jserve)


def test_task_runs_under_the_submitters_trace(rt):
    """The submitter's TraceContext rides the task spec (``to_dict``) and is
    attached around the execution (``use_from``): the task sees the same
    trace, and its events carry it."""
    from importlib import import_module

    obs = import_module(f"{rt.__name__}.obs")
    runtime = import_module(f"{rt.__name__}.core.runtime").get_runtime()
    ctx = obs.new_context()
    with obs.use(ctx):
        ref = rt.remote(lambda: (obs.current().trace_id, obs.current().span_id)).options(
            name="traced").remote()
    assert rt.get(ref, timeout=WAIT_S) == (ctx.trace_id, ctx.span_id)
    assert {e.trace_id for e in runtime.task_events.events()
            if e.name.startswith("traced")} == {ctx.trace_id}
