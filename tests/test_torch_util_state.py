"""The port's state API, ActorPool, Queue, cluster_utils and bounded Chrome
trace export (``ray_tpu_torch.util``, ``ray_tpu_torch.cluster_utils``,
``obs/recorder.py``) held against ray_tpu's on the in-process runtimes.

Each scenario of ``tests/test_observability.py`` but the metrics and the
dashboard ones (those are ``tests/test_torch_dashboard.py``), the two
``cluster_utils`` scenarios of ``tests/test_autoscaler.py`` and two of
``tests/test_obs_trace.py`` runs on both packages, each on its own
runtime: the rows carry the same keys, the values that are not ids or
clocks are equal, and the reference's assertions hold on both (band:
exact).

The module shuts down any runtime an earlier file left up and shuts both
down at the end; the cluster_utils scenarios run on fresh 4-CPU runtimes,
as the reference's do.
"""

import dataclasses
import time

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import obs as jobs
from ray_tpu import serve as jserve
from ray_tpu.cluster_utils import Cluster as JCluster
from ray_tpu.core import runtime as jrt
from ray_tpu.obs.recorder import Span as JSpan
from ray_tpu.obs.recorder import SpanRecorder as JSpanRecorder
from ray_tpu.util import ActorPool as JActorPool
from ray_tpu.util import Empty as JEmpty
from ray_tpu.util import Queue as JQueue
from ray_tpu.util import state as jstate
from ray_tpu_torch import obs as tobs
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.cluster_utils import Cluster as TCluster
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.obs.recorder import Span as TSpan
from ray_tpu_torch.obs.recorder import SpanRecorder as TSpanRecorder
from ray_tpu_torch.util import ActorPool as TActorPool
from ray_tpu_torch.util import Empty as TEmpty
from ray_tpu_torch.util import Queue as TQueue
from ray_tpu_torch.util import state as tstate

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every get of a task, an actor call or a queue op fails past this


@dataclasses.dataclass
class Pkg:
    api: object
    runtime: object
    serve: object
    state: object
    ActorPool: type
    Queue: type
    Empty: type
    obs: object
    Cluster: type
    Span: type
    SpanRecorder: type


PKGS = {
    "ref": Pkg(ray_tpu, jrt, jserve, jstate, JActorPool, JQueue, JEmpty, jobs, JCluster, JSpan,
               JSpanRecorder),
    "port": Pkg(ray_tpu_torch, trt, tserve, tstate, TActorPool, TQueue, TEmpty, tobs, TCluster,
                TSpan, TSpanRecorder),
}


def _down():
    for p in PKGS.values():
        p.serve.shutdown()
        if p.runtime.is_initialized():
            p.runtime.shutdown_runtime()


@pytest.fixture(scope="module", autouse=True)
def _module_runtimes():
    """Any runtime an earlier file left up goes; both go at the end."""
    _down()
    yield
    _down()


@pytest.fixture
def both():
    """Both packages with a runtime up (16 CPUs, kept across scenarios)."""
    for p in PKGS.values():
        if not p.runtime.is_initialized():
            p.api.init(num_cpus=16)
    return PKGS


@pytest.fixture
def fresh():
    """Both packages on fresh 4-CPU runtimes, torn down after: the
    cluster_utils scenarios register capacity rows that must not leak."""
    _down()
    for p in PKGS.values():
        p.api.init(num_cpus=4)
    yield PKGS
    _down()


def _on_both(scenario, pkgs, *args) -> dict:
    return {name: scenario(p, *args) for name, p in pkgs.items()}


# ---------------------------------------------------------------------------
# state API + timeline (tests/test_observability.py)
# ---------------------------------------------------------------------------


def _state_lists(p: Pkg) -> dict:
    api = p.api

    def traced_task(x):
        return x + 1

    class StateActor:
        def ping(self):
            return "pong"

    assert api.get(api.remote(traced_task).remote(1), timeout=WAIT_S) == 2
    a = api.remote(StateActor).remote()
    assert api.get(a.ping.remote(), timeout=WAIT_S) == "pong"

    tasks = p.state.list_tasks()
    assert any("traced_task" in t.name for t in tasks)
    assert any(t.kind == "actor_task" for t in tasks)
    assert p.state.list_tasks(state="FINISHED")
    actors = p.state.list_actors()
    assert any(r["class_name"] == "StateActor" for r in actors)
    ref = api.put([1, 2, 3])
    objs = p.state.list_objects()
    assert any(o["ready"] for o in objs)
    summary = p.state.summarize_tasks()
    assert summary.get("FINISHED", 0) >= 2
    nodes = p.state.list_nodes()
    assert len(nodes) == 1 and nodes[0]["resources_total"].get("CPU")
    pg = api.placement_group([{"CPU": 1}])
    pgs = p.state.list_placement_groups()
    api.remove_placement_group(pg)
    del ref
    row = next(t for t in tasks if "traced_task" in t.name)
    mine = next(r for r in actors if r["class_name"] == "StateActor")
    return {
        "task_fields": [f.name for f in dataclasses.fields(row)],
        "task_row": (row.state, row.kind, row.actor_id, row.error, row.trace_id),
        "actor_keys": sorted(mine),
        "actor_row": (mine["state"], mine["name"], mine["num_restarts"]),
        "object_keys": sorted(objs[0]),
        "node_keys": sorted(nodes[0]),
        "node_cpu": nodes[0]["resources_total"]["CPU"],
        "pg_keys": sorted(pgs[0]),
        "pg_row": (pgs[-1]["strategy"], pgs[-1]["state"]),
        "summary_keys": sorted(summary),
    }


def test_state_api_lists_tasks_actors_objects(both):
    got = _on_both(_state_lists, both)
    assert got["port"] == got["ref"]
    assert got["port"]["task_fields"] == ["task_id", "name", "state", "kind", "actor_id", "ts",
                                          "error", "trace_id"]


def _timeline(p: Pkg, path) -> dict:
    api = p.api

    def spanned():
        time.sleep(0.01)
        return 1

    api.get([api.remote(spanned).remote() for _ in range(3)], timeout=WAIT_S)
    trace = p.state.timeline(str(path))
    spans = [t for t in trace if "spanned" in t["name"]]
    assert len(spans) >= 3
    assert all(t["ph"] == "X" and t["dur"] > 0 for t in spans)
    assert path.exists()
    return {"keys": sorted(spans[0]), "args": sorted(spans[0]["args"]),
            "cat": spans[0]["cat"], "state": spans[0]["args"]["state"]}


def test_timeline_chrome_trace(both, tmp_path):
    got = {name: _timeline(p, tmp_path / f"{name}.json") for name, p in both.items()}
    assert got["port"] == got["ref"]


def _failed(p: Pkg) -> dict:
    api = p.api

    def boom():
        raise ValueError("nope")

    with pytest.raises(Exception):
        api.get(api.remote(max_retries=0)(boom).remote(), timeout=WAIT_S)
    failed = [t for t in p.state.list_tasks(state="FAILED") if "boom" in t.name]
    assert failed and all(t.error for t in failed)
    return {"kind": failed[0].kind, "has_nope": "nope" in failed[0].error,
            "summary_failed": p.state.summarize_tasks().get("FAILED", 0) >= 1}


def test_failed_task_recorded(both):
    got = _on_both(_failed, both)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# util: ActorPool + Queue
# ---------------------------------------------------------------------------


class Sq:
    def f(self, x):
        return x * x

    def slow(self, x):
        time.sleep(x)
        return x


def _actor_pool(p: Pkg) -> dict:
    pool = p.ActorPool([p.api.remote(Sq).remote() for _ in range(2)])
    ordered = list(pool.map(lambda a, v: a.f.remote(v), range(5)))
    unordered = sorted(pool.map_unordered(lambda a, v: a.f.remote(v), range(5)))
    assert ordered == [0, 1, 4, 9, 16] and unordered == [0, 1, 4, 9, 16]
    # idle bookkeeping: pop_idle / push and the pending queue behind it
    pool = p.ActorPool([p.api.remote(Sq).remote() for _ in range(2)])
    a = pool.pop_idle()
    b = pool.pop_idle()
    assert pool.pop_idle() is None
    pool.push(a)
    pool.submit(lambda act, v: act.f.remote(v), 6)
    pool.submit(lambda act, v: act.f.remote(v), 7)  # waits for an idle actor
    assert pool.has_next()
    first = pool.get_next(timeout=WAIT_S)
    pool.push(b)
    second = pool.get_next(timeout=WAIT_S)
    with pytest.raises(StopIteration):
        pool.get_next()
    return {"ordered": ordered, "unordered": unordered, "pending": [first, second]}


def test_actor_pool_ordered_and_unordered(both):
    got = _on_both(_actor_pool, both)
    assert got["port"] == got["ref"]


def _pool_timeout(p: Pkg) -> dict:
    """A get_next that times out leaves its slot: the retry returns it."""
    pool = p.ActorPool([p.api.remote(Sq).remote()])
    pool.submit(lambda a, v: a.slow.remote(v), 1.0)
    try:
        pool.get_next(timeout=0.05)
        raised = None
    except Exception as e:  # noqa: BLE001 — the type name is compared
        raised = type(e).__name__
    return {"raised": raised, "retry": pool.get_next(timeout=WAIT_S)}


def test_actor_pool_get_next_timeout_keeps_the_slot(both):
    got = _on_both(_pool_timeout, both)
    assert got["port"] == got["ref"] == {"raised": "GetTimeoutError", "retry": 1.0}


def _queue(p: Pkg) -> list:
    q = p.Queue(maxsize=2)
    out = []
    q.put("a")
    q.put("b")
    out.append((q.qsize(), q.full(), q.empty()))
    out.append(q.get())
    out.append(q.get_nowait())
    with pytest.raises(p.Empty):
        q.get_nowait()
    with pytest.raises(p.Empty):
        q.get(timeout=0.1)
    q.put_nowait("c")
    q.put_nowait("d")
    with pytest.raises(Exception) as full:
        q.put_nowait("e")
    out.append(type(full.value).__name__)
    with pytest.raises(Exception) as full_t:
        q.put("e", timeout=0.1)
    out.append(type(full_t.value).__name__)
    out.append([q.get(timeout=WAIT_S), q.get(timeout=WAIT_S)])
    q.shutdown()
    return out


def test_queue_blocking_and_nonblocking(both):
    got = _on_both(_queue, both)
    assert got["port"] == got["ref"]
    assert got["port"][:3] == [(2, True, False), "a", "b"]
    assert got["port"][3:5] == ["Full", "Full"]


def test_util_exports_equal_the_references():
    assert ray_tpu_torch.util.__all__ == ray_tpu.util.__all__
    assert [f.name for f in dataclasses.fields(tstate.TaskRow)] == \
        [f.name for f in dataclasses.fields(jstate.TaskRow)]


# ---------------------------------------------------------------------------
# obs: task events carry trace ids; the bounded Chrome-trace export
# (tests/test_obs_trace.py)
# ---------------------------------------------------------------------------


def _trace_ids(p: Pkg) -> dict:
    api = p.api

    def traced(x):
        return x + 1

    with p.obs.span("test.root") as ctx:
        assert api.get(api.remote(traced).remote(1), timeout=WAIT_S) == 2
    rows = [t for t in p.state.list_tasks() if "traced" in t.name]
    assert rows, "task not recorded"
    assert any(t.trace_id == ctx.trace_id for t in rows)
    spans = [e for e in p.state.timeline() if "traced" in e["name"]]
    assert any(e.get("args", {}).get("trace_id") == ctx.trace_id for e in spans), \
        "timeline span lost the trace id"
    ev = next(e for e in spans if e.get("args", {}).get("trace_id") == ctx.trace_id)
    return {"args": sorted(ev["args"]), "len": len(ctx.trace_id)}


def test_task_events_carry_trace_id(both):
    got = _on_both(_trace_ids, both)
    assert got["port"] == got["ref"]


def _bounded(p: Pkg) -> dict:
    rec = p.SpanRecorder(max_traces=8, max_spans_per_trace=100)
    tid = "a" * 32
    for j in range(50):
        rec.add(p.Span(trace_id=tid, span_id=f"{j:016x}", parent_id=None, name=f"s{j}",
                       start=float(j), end=float(j) + 1, attrs={"j": j},
                       status="ok" if j % 7 else "error"))
    bounded = rec.chrome_trace_bounded(max_events=10)
    assert bounded["truncated"] is True and bounded["total_spans"] == 50
    assert len(bounded["events"]) == 10
    assert [e["ts"] for e in bounded["events"]] == sorted(e["ts"] for e in bounded["events"])
    assert bounded["events"][0]["ts"] == 0.0
    free = rec.chrome_trace_bounded(max_events=1000)
    assert free["truncated"] is False and len(free["events"]) == 50
    assert len(rec.chrome_trace(max_events=10)) == 10
    only = rec.chrome_trace_bounded(trace_id=tid, max_events=5)
    assert only["truncated"] and len(only["events"]) == 5
    return {"bounded": bounded, "free": free, "only": only,
            "none": rec.chrome_trace_bounded(trace_id="b" * 32),
            "default_cap": rec.DEFAULT_EXPORT_MAX_EVENTS}


def test_chrome_trace_export_is_bounded_with_truncated_flag():
    got = _on_both(_bounded, PKGS)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# cluster_utils (tests/test_autoscaler.py)
# ---------------------------------------------------------------------------


def _multi_node(p: Pkg) -> dict:
    cluster = p.Cluster()
    try:
        cluster.add_node(num_cpus=4, resources={"accel": 2})
        cluster.add_node(num_cpus=4, resources={"accel": 2})
        # STRICT_SPREAD across 3 nodes (head + 2 added)
        pg = p.api.placement_group([{"CPU": 1}, {"CPU": 1, "accel": 1}, {"accel": 1}],
                                   strategy="STRICT_SPREAD")
        assert pg.ready()
        node_ids = {b.node_id for b in pg.bundles}
        on_head = sum(b.node_id == cluster.head_node.node_id for b in pg.bundles)
        p.api.remove_placement_group(pg)
        return {"nodes": len(node_ids), "on_head": on_head, "listed": len(p.state.list_nodes()),
                "total": p.api.cluster_resources()}
    finally:
        cluster.shutdown()


def test_cluster_utils_multi_node_placement(fresh):
    got = _on_both(_multi_node, fresh)
    for g in got.values():
        g["total"].pop("memory", None)
    assert got["port"] == got["ref"]
    assert got["port"]["nodes"] == 3 and got["port"]["listed"] == 3


def _pending_pg(p: Pkg) -> dict:
    cluster = p.Cluster()
    try:
        pg = p.api.placement_group([{"special": 1}], strategy="PACK")
        with pytest.raises(Exception) as infeasible:
            pg.ready(timeout=0.2)  # infeasible now
        node = cluster.add_node(num_cpus=1, resources={"special": 2})
        assert pg.ready()
        placed = pg.bundles[0].node_id == node.node_id
        p.api.remove_placement_group(pg)
        return {"raised": type(infeasible.value).__name__, "placed_on_added": placed,
                "nodes_after": len(cluster.nodes)}
    finally:
        cluster.shutdown()


def test_pending_pg_satisfied_by_added_node(fresh):
    got = _on_both(_pending_pg, fresh)
    assert got["port"] == got["ref"]
    assert got["port"]["placed_on_added"] is True


def test_cluster_utils_gpu_node_divergence(fresh):
    """Pinned divergence: the accelerator argument of ``add_node`` is
    ``num_gpus`` ("GPU") on the port, ``num_tpus`` ("TPU") on the reference;
    the rest of the node's row is equal."""
    jc, tc = JCluster(), TCluster()
    try:
        jn = jc.add_node(num_cpus=2, num_tpus=4)
        tn = tc.add_node(num_cpus=2, num_gpus=4)
        assert dict(jn.resources.total) == {"CPU": 2, "TPU": 4}
        assert dict(tn.resources.total) == {"CPU": 2, "GPU": 4}
        with pytest.raises(TypeError):
            tc.add_node(num_cpus=1, num_tpus=1)
    finally:
        jc.shutdown()
        tc.shutdown()
