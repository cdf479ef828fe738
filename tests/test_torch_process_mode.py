"""Process-mode tasks on the port held against ray_tpu's.

The scenarios of ``tests/test_process_mode.py`` (a task, an exception, a
crash retried to success, retries exhausted, big arrays through the
shared-memory store, a crash's store refs reclaimed, isolation), the
nested refs of ``tests/test_core_regressions.py`` and the chaos
``KILL_WORKER`` at ``process_pool.task`` of ``tests/test_chaos.py`` run on
both packages, each under its own ``init(worker_mode="process")``: each
must give what the reference's own test asserts (``EXPECTED``), error type
names included, so the two give equal results.

Then what is the port's own: CPU tensors of every dtype through the store
both ways, bit for bit; a worker's ``CUDA_VISIBLE_DEVICES`` from its
task's card grant; the parent never initializing CUDA; the two packages'
stores side by side; and the serializer's by-value cases against
cloudpickle in the reference's pool. Every wait has its own limit.
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import chaos as jchaos
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu_torch import chaos as tchaos
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import process_pool as tpp
from ray_tpu_torch.core import runtime as trt

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a task fails past this

PACKAGES = {
    "ref": types.SimpleNamespace(api=ray_tpu, rt=jrt, serve=jserve, chaos=jchaos),
    "port": types.SimpleNamespace(api=ray_tpu_torch, rt=trt, serve=tserve, chaos=tchaos),
}


def _reset(pkg):
    pkg.serve.shutdown()
    if pkg.rt.is_initialized():
        pkg.rt.shutdown_runtime()


def _started(pkg, num_cpus=4, **kw):
    _reset(pkg)
    pkg.api.init(num_cpus=num_cpus, worker_mode="process", **kw)
    return pkg.api


def _outcome(fn):
    """("ok", value) or ("raised", error type name, cause type name)."""
    try:
        return ("ok", fn())
    except BaseException as e:  # noqa: BLE001 — the type is what is compared
        cause = getattr(e, "cause", None)
        return ("raised", type(e).__name__, type(cause).__name__ if cause is not None else None)


def _square(x):
    return x * x


# -- the reference's scenarios: each returns a value both packages must give --


def sc_basic(pkg, tmp):
    api = _started(pkg)
    f = api.remote(_square)  # importable: goes by reference
    return _outcome(lambda: api.get(f.remote(7), timeout=WAIT_S))


def sc_exception(pkg, tmp):
    api = _started(pkg)

    @api.remote
    def boom():
        raise KeyError("nope")

    return _outcome(lambda: api.get(boom.remote(), timeout=WAIT_S))


def sc_crash_retries_then_succeeds(pkg, tmp):
    api = _started(pkg)
    marker = tmp / "attempts"

    @api.remote(max_retries=2)
    def flaky():
        # Crash the whole worker process on the first two attempts.
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 2:
            os._exit(9)
        return "survived"

    out = _outcome(lambda: api.get(flaky.remote(), timeout=WAIT_S))
    return out, marker.read_text()


def sc_crash_exhausts_retries(pkg, tmp):
    api = _started(pkg)

    @api.remote(max_retries=1)
    def die():
        os._exit(9)

    return _outcome(lambda: api.get(die.remote(), timeout=WAIT_S))


def sc_large_arrays_ride_shm_store(pkg, tmp):
    api = _started(pkg)
    big = np.arange(1 << 18, dtype=np.float64)  # 2 MiB >> threshold

    @api.remote
    def double(arr):
        return arr * 2.0

    out = api.get(double.remote(big), timeout=WAIT_S)
    channel = pkg.rt.get_runtime().process_pool._get_channel()
    assert channel.store is not None  # the store carried it, not the pipe fallback
    return bool(np.array_equal(out, big * 2.0)), channel.store.stats()["num_objects"]


def sc_crash_reclaims_shm_refs(pkg, tmp):
    api = _started(pkg)
    big = np.zeros(1 << 17, dtype=np.float64)  # 1 MiB arg via shm

    @api.remote(max_retries=0)
    def crash(arr):
        os._exit(9)

    out = _outcome(lambda: api.get(crash.remote(big), timeout=WAIT_S))
    store = pkg.rt.get_runtime().process_pool._get_channel().store
    assert store is not None
    return out, store.stats()["num_objects"], store.stats()["used"]


def sc_isolation(pkg, tmp):
    api = _started(pkg)
    leak = {"seen": False}

    @api.remote
    def mutate():
        leak["seen"] = True
        return leak["seen"]

    return api.get(mutate.remote(), timeout=WAIT_S), leak["seen"]


def sc_nested_refs(pkg, tmp):
    api = _started(pkg, num_cpus=2)
    inner = api.put({"x": 41})

    @api.remote
    def f(payload):
        return payload["ref"]["x"] + 1

    return _outcome(lambda: api.get(f.remote({"ref": inner}), timeout=WAIT_S))


def sc_chaos_kill_worker(pkg, tmp):
    api = _started(pkg)
    ch = pkg.chaos
    try:
        sched = ch.install(ch.FaultSchedule(17, [
            ch.FaultSpec(ch.KILL_WORKER, site="process_pool.task", max_fires=1),
        ]))

        @api.remote(max_retries=2)
        def work(x):
            return x + 1

        # first attempt's worker is killed mid-task; the retry completes
        out = _outcome(lambda: api.get(work.remote(41), timeout=WAIT_S))
        return out, sched.fired_kinds()
    finally:
        ch.uninstall()


SCENARIOS = {fn.__name__[3:]: fn for fn in (
    sc_basic, sc_exception, sc_crash_retries_then_succeeds, sc_crash_exhausts_retries,
    sc_large_arrays_ride_shm_store, sc_crash_reclaims_shm_refs, sc_isolation,
    sc_nested_refs, sc_chaos_kill_worker)}
EXPECTED = {  # what the reference's own tests assert, scenario by scenario
    "basic": ("ok", 49),
    "exception": ("raised", "TaskError", "KeyError"),
    "crash_retries_then_succeeds": (("ok", "survived"), "3"),
    "crash_exhausts_retries": ("raised", "WorkerCrashedError", None),
    "large_arrays_ride_shm_store": (True, 0),
    "crash_reclaims_shm_refs": (("raised", "WorkerCrashedError", None), 0, 0),
    "isolation": (True, False),
    "nested_refs": ("ok", 42),
    "chaos_kill_worker": (("ok", 42), ["kill_worker"]),
}


@pytest.mark.parametrize("side", ["ref", "port"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, side, tmp_path):
    """Both packages give what the reference's own test asserts, so the
    port's result equals the reference's."""
    pkg = PACKAGES[side]
    try:
        got = SCENARIOS[name](pkg, tmp_path)
    finally:
        _reset(pkg)
    assert got == EXPECTED[name]


# -- the port's own -------------------------------------------------------------


@pytest.fixture
def port():
    pkg = PACKAGES["port"]
    yield pkg
    _reset(pkg)


def _tensors():
    g = torch.Generator().manual_seed(0)
    big = torch.randn(256, 160, generator=g)  # 160 KiB in fp32: rides the store
    return {
        "fp32": big,
        "bf16": big.to(torch.bfloat16),
        "int64": torch.randint(-2**62, 2**62, (96, 64), generator=g, dtype=torch.int64),
        "fp32_t": big.t(),  # not contiguous
        "bf16_slice": big.to(torch.bfloat16)[:, ::3],  # not contiguous
        "small": torch.arange(7, dtype=torch.int64),  # inline, under the threshold
        "scalar": torch.tensor(2.5, dtype=torch.bfloat16),
    }


def test_cpu_tensors_cross_the_store_bit_for_bit_both_ways(port):
    api = _started(port)
    ts = _tensors()

    @api.remote
    def echo(d):
        # the worker sees what was sent, and sends back a new tensor per key
        return {k: (v.dtype, tuple(v.shape), v.clone() + 0) for k, v in d.items()}

    def bits(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    out = api.get(echo.remote(ts), timeout=WAIT_S)
    for k, t in ts.items():
        dtype, shape, back = out[k]
        assert dtype == t.dtype and shape == tuple(t.shape) and back.dtype == t.dtype
        assert torch.equal(bits(back), bits(t)), k
    channel = port.rt.get_runtime().process_pool._get_channel()
    assert channel.store is not None and channel.moved["shm"] >= 2 * ts["fp32"].nbytes
    assert channel.store.stats()["num_objects"] == 0
    assert not torch.cuda.is_initialized()


def test_bf16_bits_cross_exactly(port):
    api = _started(port)
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    t = bits.view(torch.bfloat16)  # every bf16 pattern, NaNs and infinities included

    @api.remote
    def back(x):
        return x.view(torch.int16).clone(), x

    as_int, same = api.get(back.remote(t), timeout=WAIT_S)
    assert torch.equal(as_int, bits) and torch.equal(same.view(torch.int16), bits)


@pytest.mark.parametrize("parent_env,num_gpus,task_gpus,want", [
    (None, 1, 1, "0"),
    (None, 1, 0.5, "0"),
    (None, 1, 0, ""),
    (None, 0, 0, ""),
    ("3,5", 2, 2, "3,5"),
])
def test_worker_pinned_to_its_card_grant(port, monkeypatch, parent_env, num_gpus, task_gpus,
                                         want):
    if parent_env is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", parent_env)
    api = _started(port, num_gpus=num_gpus)

    @api.remote(num_gpus=task_gpus)
    def visible():
        return os.environ["CUDA_VISIBLE_DEVICES"]

    assert api.get(visible.remote(), timeout=WAIT_S) == want
    assert not torch.cuda.is_initialized()


def test_two_gpu_tasks_get_two_cards_and_cpu_tasks_their_own_workers(port, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    api = _started(port, num_gpus=2)
    gate = port.api.put(None)

    @api.remote(num_gpus=1)
    def hold(_):
        import time

        time.sleep(0.5)  # both in flight at once
        return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

    @api.remote
    def cpu():
        return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

    a, b = api.get([hold.remote(gate), hold.remote(gate)], timeout=WAIT_S)
    assert sorted([a[0], b[0]]) == ["0", "1"]
    env, pid = api.get(cpu.remote(), timeout=WAIT_S)
    assert env == "" and pid not in (a[1], b[1])
    pool = port.rt.get_runtime().process_pool
    assert set(pool._free) == {"0", "1", ""}


def test_both_packages_pools_use_their_own_store_files():
    ref, prt = PACKAGES["ref"], PACKAGES["port"]
    try:
        _started(ref)
        _started(prt)
        paths = []
        for pkg in (ref, prt):
            f = pkg.api.remote(lambda a: float(a.sum()))
            assert pkg.api.get(f.remote(np.ones(1 << 16)), timeout=WAIT_S) == float(1 << 16)
            pool = pkg.rt.get_runtime().process_pool
            assert pool._get_channel().store is not None
            paths.append(pool._shm_path)
        assert paths[0] != paths[1] and all(map(os.path.exists, paths))
    finally:
        _reset(prt)
        _reset(ref)


def test_store_file_removed_at_exit_without_shutdown(tmp_path):
    """A process that never shuts its runtime down still removes its
    store's file from the shm directory at exit."""
    import subprocess
    import sys

    code = """
import numpy as np, ray_tpu_torch
from ray_tpu_torch.core import runtime
ray_tpu_torch.init(num_cpus=2, worker_mode="process")
f = ray_tpu_torch.remote(lambda a: a * 2)
assert ray_tpu_torch.get(f.remote(np.ones(1 << 16)), timeout=60)[0] == 2
print(runtime.get_runtime().process_pool._shm_path)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=WAIT_S, env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0, res.stderr[-2000:]
    path = res.stdout.strip().splitlines()[-1]
    assert path.endswith(".shm") and not os.path.exists(path)


# -- the serializer: by-value cases, against cloudpickle in the reference's pool --


def _main_style():
    """Functions as ``__main__`` defines them: module globals (a constant,
    a module, a helper function) looked up by name."""
    src = (
        "import numpy as np\n"
        "K = 3\n"
        "def helper(x):\n"
        "    return x * K\n"
        "def entry(n):\n"
        "    return float(np.sum(np.arange(n))) + helper(n)\n"
    )
    g = {"__name__": "__main__"}
    exec(compile(src, "<main-style>", "exec"), g)
    assert g["entry"].__module__ == "__main__"
    return g["entry"], 10


def _closure():
    base = {"k": 5}

    def add(x):
        return x + base["k"]

    return add, 2


def _lambda():
    return (lambda x, y=4: x * y), 3


def _recursive():
    def fib(n):
        return n if n < 2 else fib(n - 1) + fib(n - 2)

    return fib, 15


def _local_class():
    class Acc:
        start = 10

        def __init__(self):
            self.items = []

        def add(self, v):
            self.items.append(v)
            return self

        @property
        def total(self):
            return self.start + sum(self.items)

    class Twice(Acc):
        def add(self, v):
            return super().add(2 * v)

    def run(n):
        acc = Twice()
        for i in range(n):
            acc.add(i)
        return acc.total, type(acc).__name__, acc.items

    return run, 5


def _local_dataclass():
    import dataclasses

    @dataclasses.dataclass
    class Cfg:
        n: int
        scale: float = 2.0
        tags: list = dataclasses.field(default_factory=list)

    def run(n):
        c = dataclasses.replace(Cfg(n), tags=["a"])
        return c.n * c.scale, c.tags, [f.name for f in dataclasses.fields(c)], Cfg(1) == Cfg(1)

    return run, 4


SERIALIZER_CASES = {"main_style": _main_style, "closure": _closure, "lambda": _lambda,
                    "recursive": _recursive, "local_class": _local_class,
                    "local_dataclass": _local_dataclass}


@pytest.mark.parametrize("case", list(SERIALIZER_CASES))
def test_by_value_function_runs_in_a_worker_as_cloudpickle_ships_it(case):
    fn, arg = SERIALIZER_CASES[case]()
    out = {}
    for side in ("ref", "port"):
        pkg = PACKAGES[side]
        try:
            api = _started(pkg, num_cpus=2)
            out[side] = _outcome(lambda: api.get(api.remote(fn).remote(arg), timeout=WAIT_S))
        finally:
            _reset(pkg)
    assert out["port"] == out["ref"] == ("ok", fn(arg))


def test_by_value_rules():
    import dataclasses

    from ray_tpu_torch.core import serialization as ser

    assert ser.by_reference(_square) and ser.by_reference(np.sum)
    for case in SERIALIZER_CASES.values():
        assert not ser.by_reference(case()[0])
    # a local class's instance, returned from a worker, is rebuilt as one
    fn, _ = _local_class()
    bufs = []
    payload = ser.dumps(fn, buffer_callback=bufs.append)
    assert pickle.loads(payload, buffers=bufs)(3) == fn(3)
    # a by-value dataclass keeps its fields' sentinels (cloudpickle does not:
    # its copy of a field without a default no longer holds MISSING)
    cls = pickle.loads(ser.dumps(dataclasses.make_dataclass("D", [("x", int)])))
    assert dataclasses.fields(cls)[0].default is dataclasses.MISSING


def test_an_actor_handle_cannot_cross(port):
    api = _started(port)

    @api.remote
    class A:
        def m(self):
            return 1

    a = A.remote()

    @api.remote
    def use(h):
        return h

    assert _outcome(lambda: api.get(use.remote(a), timeout=WAIT_S)) == (
        "raised", "TaskError", "TypeError")


def test_a_cuda_tensor_needs_a_card_on_the_receiving_side(port):
    """The receiver rebuilds a CUDA tensor on its own card; one that sees
    no card raises TypeError naming the rule, never a CPU tensor. Without
    a card here, the payload is built by hand: what a CUDA tensor reduces to."""
    from ray_tpu_torch.core import serialization as ser

    raw = torch.arange(4, dtype=torch.float32).view(torch.uint8).numpy().tobytes()
    with pytest.raises(TypeError, match="sees no card"):
        ser._rebuild_tensor(raw, "float32", (4,), True, False, False)

    class CudaMarked:
        def __reduce__(self):
            return ser._rebuild_tensor, (raw, "float32", (4,), True, False, False)

    api = _started(port)

    @api.remote
    def take(t):
        return t

    assert _outcome(lambda: api.get(take.remote(CudaMarked()), timeout=WAIT_S)) == (
        "raised", "TaskError", "TypeError")


def test_visible_devices_maps_grants_to_the_parents_entries(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,7")
    assert tpp.visible_devices((1,)) == "7" and tpp.visible_devices(None) == ""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert tpp.visible_devices((0, 1)) == "0,1"
