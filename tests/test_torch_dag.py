"""The port's compiled DAGs (``ray_tpu_torch.dag``) held against ray_tpu's.

The ten scenarios of ``tests/test_dag.py`` (chains, fan-out and fan-in,
input fields, several outputs, pipelining, a host allreduce, errors that
unblock the driver, the in-flight bound, teardown freeing the actor) and
the six of ``tests/test_dag_chaos.py`` (bounded reads, ``DROP_CHANNEL``
and ``STALL_CHANNEL`` at the ``dag.channel`` sites, seeded fault traces, a
value dropped mid-iteration poisoning the pipeline) run on both packages,
each on its own in-process runtime: values are equal, error type names
are equal, and the seeded fault traces are equal (band: exact).

The module shuts down any ``ray_tpu`` runtime an earlier file left up,
starts both packages' runtimes with 32 CPUs, and shuts both down at the
end, Serve first.
"""

import queue
import time

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import chaos as jchaos
from ray_tpu import serve as jserve
from ray_tpu.core import runtime as jrt
from ray_tpu.dag import InputNode as JInputNode
from ray_tpu.dag import MultiOutputNode as JMultiOutputNode
from ray_tpu.dag import channels as jchannels
from ray_tpu.dag import compiled as jcompiled
from ray_tpu.dag.nodes import allreduce_bind as jallreduce_bind
from ray_tpu_torch import chaos as tchaos
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.dag import InputNode as TInputNode
from ray_tpu_torch.dag import MultiOutputNode as TMultiOutputNode
from ray_tpu_torch.dag import channels as tchannels
from ray_tpu_torch.dag import compiled as tcompiled
from ray_tpu_torch.dag.nodes import allreduce_bind as tallreduce_bind

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 30  # every get of a compiled DAG's result and of an actor call fails past this


class Pkg:
    """One package's pieces, so a scenario runs on either."""

    def __init__(self, name, api, chaos, channels, compiled, input_node, multi, allreduce):
        self.name, self.api, self.chaos, self.channels, self.compiled = (
            name, api, chaos, channels, compiled)
        self.InputNode, self.MultiOutputNode, self.allreduce_bind = input_node, multi, allreduce


PKGS = (Pkg("ref", ray_tpu, jchaos, jchannels, jcompiled, JInputNode, JMultiOutputNode,
            jallreduce_bind),
        Pkg("port", ray_tpu_torch, tchaos, tchannels, tcompiled, TInputNode, TMultiOutputNode,
            tallreduce_bind))


def _down(serve, runtime):
    serve.shutdown()
    if runtime.is_initialized():
        runtime.shutdown_runtime()


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    """Any runtime an earlier file left up goes; each package gets a fresh
    one of 32 CPUs; both go at the end, Serve first."""
    for serve, runtime in ((jserve, jrt), (tserve, trt)):
        _down(serve, runtime)
    ray_tpu.init(num_cpus=32)
    ray_tpu_torch.init(num_cpus=32)
    yield
    for serve, runtime in ((jserve, jrt), (tserve, trt)):
        _down(serve, runtime)


@pytest.fixture(autouse=True)
def no_chaos():
    yield
    jchaos.uninstall()
    tchaos.uninstall()


class Worker:
    def __init__(self, scale=1):
        self.scale = scale
        self.calls = 0

    def mul(self, x):
        self.calls += 1
        return x * self.scale

    def add(self, x, y):
        return x + y

    def slow(self, x):
        time.sleep(0.05)
        return x + 1

    def boom(self, x):
        raise ValueError("kaboom")

    def num_calls(self):
        return self.calls


def _workers(p, *scales):
    cls = p.api.remote(Worker)
    return [cls.remote(*s) for s in scales]


def _both(scenario):
    """Run ``scenario(pkg)`` on the reference, then the port: the answers
    must be equal."""
    got = {p.name: scenario(p) for p in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


def _compiled(dag, fn, **kw):
    c = dag.experimental_compile(**kw)
    try:
        return fn(c)
    finally:
        c.teardown()


def _error_name(ref) -> str:
    try:
        ref.get(timeout=10)
    except Exception as e:  # noqa: BLE001 — the type's name is the answer
        return type(e).__name__
    return "no error"


# -- tests/test_dag.py ----------------------------------------------------------


def test_linear_chain():
    def run(p):
        a, b = _workers(p, (2,), (10,))
        with p.InputNode() as inp:
            dag = b.mul.bind(a.mul.bind(inp))
        return _compiled(dag, lambda c: [c.execute(3).get(WAIT_S), c.execute(5).get(WAIT_S)])

    assert _both(run) == [60, 100]


def test_fan_out_fan_in_same_and_cross_actor():
    def run(p):
        a, b = _workers(p, (2,), (3,))
        with p.InputNode() as inp:
            dag = a.add.bind(a.mul.bind(inp), b.mul.bind(inp))
        return _compiled(dag, lambda c: c.execute(4).get(WAIT_S))

    assert _both(run) == 8 + 12


def test_input_attributes():
    def run(p):
        (a,) = _workers(p, (1,))
        with p.InputNode() as inp:
            dag = a.add.bind(inp["x"], inp["y"])
        return _compiled(dag, lambda c: c.execute({"x": 7, "y": 8}).get(WAIT_S))

    assert _both(run) == 15


def test_multi_output():
    def run(p):
        a, b = _workers(p, (2,), (5,))
        with p.InputNode() as inp:
            dag = p.MultiOutputNode([a.mul.bind(inp), b.mul.bind(inp)])
        return _compiled(dag, lambda c: c.execute(3).get(WAIT_S))

    assert _both(run) == [6, 15]


def test_pipelining_multiple_in_flight():
    def run(p):
        (a,) = _workers(p, ())
        with p.InputNode() as inp:
            dag = a.slow.bind(inp)

        def go(c):
            t0 = time.perf_counter()
            refs = [c.execute(i) for i in range(4)]
            out = [r.get(WAIT_S) for r in refs]
            # streamed through one loop: ordered and all there, well inside 5 s
            return out, time.perf_counter() - t0 < 5

        return _compiled(dag, go)

    assert _both(run) == ([1, 2, 3, 4], True)


def test_collective_allreduce_node():
    def run(p):
        workers = _workers(p, (1,), (2,), (3,))
        with p.InputNode() as inp:
            reduced = p.allreduce_bind([w.mul.bind(inp) for w in workers])
            dag = p.MultiOutputNode([w.mul.bind(r) for w, r in zip(workers, reduced)])
        # inp 2 -> parts (2, 4, 6), sum 12 -> (12, 24, 36)
        return _compiled(dag, lambda c: c.execute(2).get(WAIT_S))

    assert _both(run) == [12, 24, 36]


def test_error_propagates_and_unblocks():
    def run(p):
        (a,) = _workers(p, ())
        with p.InputNode() as inp:
            dag = a.boom.bind(inp)
        return _compiled(dag, lambda c: _error_name(c.execute(1)))

    assert _both(run) != "no error"


def test_midpipeline_failure_unblocks_driver():
    """The poison crosses the intermediate loops to the driver."""
    def run(p):
        a, b, c3 = _workers(p, (), (2,), (3,))
        with p.InputNode() as inp:
            dag = c3.mul.bind(b.mul.bind(a.boom.bind(inp)))
        return _compiled(dag, lambda c: _error_name(c.execute(1)))

    assert _both(run) != "no error"


def test_execute_overflow_raises_not_deadlocks():
    def run(p):
        (a,) = _workers(p, (2,))
        with p.InputNode() as inp:
            dag = a.slow.bind(inp)

        def go(c):
            refs = [c.execute(i) for i in range(2)]
            with pytest.raises(RuntimeError, match="in.flight") as ei:
                c.execute(99)
            got = [r.get(WAIT_S) for r in refs]
            return str(ei.value), got, c.execute(3).get(WAIT_S)  # drained: works again

        return _compiled(dag, go, max_in_flight=2)

    assert _both(run)[1:] == ([1, 2], 4)


def test_teardown_frees_actor():
    def run(p):
        (a,) = _workers(p, (2,))
        with p.InputNode() as inp:
            dag = a.mul.bind(inp)
        c = dag.experimental_compile()
        first = c.execute(2).get(WAIT_S)
        c.teardown()
        # the loop returned: the actor takes calls again
        calls = p.api.get(a.num_calls.remote(), timeout=10)
        with pytest.raises(RuntimeError) as ei:
            c.execute(1)
        return first, calls, str(ei.value)

    assert _both(run)[:2] == (4, 1)


# -- tests/test_dag_chaos.py ----------------------------------------------------


def test_read_bounded_by_default_typed_error():
    """read(timeout=None) parks at most the default bound and raises the
    typed error; an explicit timeout raises queue.Empty."""
    def run(p):
        ch = p.channels.Channel(num_readers=1, default_timeout=0.1)
        t0 = time.monotonic()
        out = []
        for kw in ({}, {"timeout": 0.05}):
            try:
                ch.read(0, **kw)
            except Exception as e:  # noqa: BLE001 — the type's name is the answer
                out.append(type(e).__name__)
        out.append(time.monotonic() - t0 < 5.0)
        ch.close()
        try:
            ch.read(0)
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
        return out

    assert _both(run) == ["ChannelTimeoutError", "Empty", True, "ChannelClosedError"]


def test_drop_channel_lost_in_flight():
    """A dropped write never reaches the reader (its bounded read times
    out); the next write does."""
    def run(p):
        c = p.chaos
        sched = c.install(c.FaultSchedule(5, [
            c.FaultSpec(c.DROP_CHANNEL, site="dag.channel.send", max_fires=1)]))
        ch = p.channels.Channel(num_readers=1, default_timeout=0.2)
        ch.write("lost")
        with pytest.raises(p.channels.ChannelTimeoutError):
            ch.read(0)
        ch.write("kept")
        return ch.read(0), sched.fired_kinds(), sched.decisions()

    assert _both(run)[:2] == ("kept", ["drop_channel"])


def test_stall_channel_delays_not_drops():
    def run(p):
        c = p.chaos
        sched = c.install(c.FaultSchedule(5, [
            c.FaultSpec(c.STALL_CHANNEL, site="dag.channel.send", delay_s=0.15, max_fires=1)]))
        ch = p.channels.Channel(num_readers=1)
        t0 = time.monotonic()
        ch.write("v")
        waited = time.monotonic() - t0 >= 0.15
        return waited, ch.read(0, timeout=1.0), sched.decisions()

    assert _both(run)[:2] == (True, "v")


def test_drop_not_eligible_at_recv():
    """A DROP spec never spends its budget at a recv site."""
    def run(p):
        c = p.chaos
        sched = c.install(c.FaultSchedule(5, [
            c.FaultSpec(c.DROP_CHANNEL, site="dag.channel.*", max_fires=1)]))
        ch = p.channels.Channel(num_readers=1)
        ch.write("a")  # the drop fires here
        ch.write("b")  # budget spent: delivered
        return ch.read(0, timeout=1.0), [f.site for f in sched.log]

    assert _both(run) == ("b", ["dag.channel.send"])


def test_same_seed_reproduces_channel_fault_trace():
    def drive(p, seed):
        c = p.chaos
        sched = c.install(c.FaultSchedule(seed, [
            c.FaultSpec(c.DROP_CHANNEL, site="dag.channel.send", p=0.5),
            c.FaultSpec(c.STALL_CHANNEL, site="dag.channel.*", p=0.3, delay_s=0.0)]))
        try:
            ch = p.channels.Channel(num_readers=1, default_timeout=0.05)
            for i in range(6):
                ch.write(i)
                try:
                    ch.read(0, timeout=0.2)
                except queue.Empty:
                    pass
            return sched.decisions()
        finally:
            c.uninstall()

    def run(p):
        t1, t2 = drive(p, 77), drive(p, 77)
        assert t1 == t2 and len(t1) > 0
        return t1

    _both(run)


class Stage:
    def __init__(self, scale=1):
        self.scale = scale

    def mul(self, x):
        return x * self.scale

    def add(self, x, y):
        return x + y


def test_exec_loop_poisons_and_tears_down_on_dropped_edge(monkeypatch):
    """A value dropped on the edge between two actors mid-iteration (the
    consumer has this round's input) is a bounded typed read timeout in
    its exec loop, which closes its out channels; teardown() returns
    instead of hanging on a parked loop."""
    def run(p):
        monkeypatch.setattr(p.compiled, "EXEC_READ_TIMEOUT_S", 0.5)
        cls = p.api.remote(Stage)
        a, b = cls.remote(2), cls.remote(10)
        with p.InputNode() as inp:
            # b takes the input and a's output: once b's round has begun,
            # the a -> b read is bounded and fatal
            dag = b.add.bind(inp, a.mul.bind(inp))
        c = dag.experimental_compile()
        clean = c.execute(3).get(timeout=WAIT_S)
        # sends after the install: #0 the driver's input, #1 the a -> b edge
        ch = p.chaos
        sched = ch.install(ch.FaultSchedule(9, [
            ch.FaultSpec(ch.DROP_CHANNEL, site="dag.channel.send", start_after=1,
                         max_fires=1)]))
        failed = _error_name(c.execute(5)) != "no error"
        t0 = time.monotonic()
        c.teardown()
        quick = time.monotonic() - t0 < 30
        return clean, failed, quick, sched.fired_kinds()

    assert _both(run) == (9, True, True, ["drop_channel"])


def test_collective_entry_still_raises_naming_item_10():
    """The DAG's exec loop is a framework method of in-process and cluster
    actors now; the collective group's setup call still raises on both,
    naming the item that will port it."""
    from ray_tpu_torch.cluster.worker_main import _framework_actor_method

    cls = ray_tpu_torch.remote(Worker)
    a = cls.remote(2)
    assert ray_tpu_torch.get(a.mul.remote(1), timeout=WAIT_S) == 2  # constructed
    actor = a._actor
    for lookup in (lambda n: actor._framework_method(n),
                   lambda n: _framework_actor_method(actor.instance, n)):
        assert callable(lookup("__ray_tpu_dag_exec_loop__"))
        assert lookup("mul") is None
        with pytest.raises(NotImplementedError, match=r"ROADMAP.md Queue 1, item 10"):
            lookup("__ray_tpu_collective_init__")
