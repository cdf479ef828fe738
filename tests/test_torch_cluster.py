"""The port's cluster runtime: real GCS + node-daemon + worker processes.

The cases of ``tests/test_cluster.py`` that share one three-node cluster,
on ``ray_tpu_torch.cluster``, to those tests' expectations: tasks in
worker processes, spillback across nodes, put/get and the pull between
nodes, dependencies, errors, custom resources, actors (named, passed
through tasks, killed on a remote node), placement groups, node affinity,
the driver's spans and the trace context, task returns sealed in shared
memory. The four cases that start clusters of their own (node death, the
spilling store, the GCS restarted from its snapshot, the memory monitor)
are in ``tests/test_torch_cluster_faults.py``, so each file runs in well
under a minute. Every wait has its own deadline, and the cluster is
checked to leave no process and no store file (``LocalCluster.leftovers``).
"""

import os
import sys
import time

import numpy as np
import pytest

from ray_tpu_torch.cluster import ClusterTaskError, LocalCluster
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port


def assert_no_cluster_left(c):
    """No process of ``c`` (GCS, daemons, workers) and no store file of its
    daemons outlived its shutdown."""
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left


# test functions/classes must travel by value: the worker processes have
# no tests/ on their import path
register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def cluster():
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="head")
        c.add_node({"num_cpus": 2}, node_id="n1")
        c.add_node({"num_cpus": 2, "magic": 1}, node_id="n2")
        c.wait_for_nodes(3)
        yield c
    finally:
        c.shutdown()
        assert_no_cluster_left(c)


def _whoami():
    import os

    return (os.environ.get("RAY_TPU_NODE_ID"), os.getpid())


def test_tasks_execute_in_worker_processes(cluster):
    client = cluster.client()
    ref = client.submit(_whoami)
    node_id, pid = client.get(ref, timeout=60)
    assert node_id in ("head", "n1", "n2")
    assert pid != os.getpid()  # really another process


def test_tasks_spread_across_nodes(cluster):
    client = cluster.client()
    # 6 concurrent 2-cpu tasks cannot fit one 2-cpu node: they must spill

    def hold(t):
        import os
        import time

        time.sleep(t)
        return os.environ.get("RAY_TPU_NODE_ID")

    # 5.0s holds: under a loaded host the third lease can take seconds to land
    # (queued locally until the 0.5s spillback probe fires), and a task
    # that FINISHES before the next one leases frees its node for reuse —
    # the assertion needs all three genuinely overlapping
    refs = [
        client.submit(hold, (5.0,), resources={"num_cpus": 2}) for _ in range(3)
    ]
    nodes = {client.get(r, timeout=120) for r in refs}
    assert len(nodes) == 3, f"expected all 3 nodes used, got {nodes}"


def test_put_get_roundtrip_and_cross_node_transfer(cluster):
    client = cluster.client()
    arr = np.arange(100_000, dtype=np.float32)

    def produce():
        import numpy as np

        return np.ones(200_000, dtype=np.float64)

    # put/get through the head daemon
    ref = client.put({"a": arr, "n": 7})
    out = client.get(ref)
    np.testing.assert_array_equal(out["a"], arr)
    # result produced on SOME node, pulled through the head daemon
    big = client.get(client.submit(produce), timeout=60)
    assert big.shape == (200_000,) and big[0] == 1.0


def test_task_dependencies_cross_node(cluster):
    client = cluster.client()

    def make():
        return list(range(100))

    def consume(xs, scale):
        return sum(xs) * scale

    ref = client.submit(make)
    # magic resource forces consume onto n2 while make ran anywhere
    out = client.submit(
        consume, (ref, 2), resources={"num_cpus": 1, "magic": 1}
    )
    assert client.get(out, timeout=60) == sum(range(100)) * 2


def test_error_propagation(cluster):
    client = cluster.client()

    def boom():
        raise ValueError("kaboom")

    with pytest.raises(ClusterTaskError, match="kaboom"):
        client.get(client.submit(boom), timeout=60)


def test_custom_resource_routing(cluster):
    client = cluster.client()
    refs = [
        client.submit(_whoami, resources={"num_cpus": 1, "magic": 1})
        for _ in range(2)
    ]
    for r in refs:
        node_id, _ = client.get(r, timeout=60)
        assert node_id == "n2"  # only n2 has `magic`


class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def where(self):
        import os

        return os.environ.get("RAY_TPU_NODE_ID")


def test_actor_create_call_named(cluster):
    client = cluster.client()
    h = client.create_actor(Counter, (10,), name="counter0")
    assert client.get(h.incr.remote(), timeout=60) == 11
    assert client.get(h.incr.remote(5), timeout=60) == 16
    # lookup by name, state shared
    h2 = client.get_named_actor("counter0")
    assert client.get(h2.incr.remote(), timeout=60) == 17
    h.kill()


def test_actor_handle_travels_through_task(cluster):
    client = cluster.client()
    h = client.create_actor(Counter, (0,))

    def poke(counter_handle):
        r = counter_handle.incr.remote(100)
        return r.get(timeout=30)

    out = client.get(client.submit(poke, (h,)), timeout=60)
    assert out == 100
    h.kill()


def test_placement_group_strict_spread(cluster):
    client = cluster.client()
    info = client.create_placement_group(
        [{"num_cpus": 1}, {"num_cpus": 1}], strategy="STRICT_SPREAD"
    )
    nodes = [b["node_id"] for b in info["bundles"]]
    assert len(set(nodes)) == 2
    # tasks in the pg land on the reserved nodes
    r0 = client.submit(
        _whoami, resources={"num_cpus": 1}, pg_id=info["pg_id"], bundle_index=0
    )
    r1 = client.submit(
        _whoami, resources={"num_cpus": 1}, pg_id=info["pg_id"], bundle_index=1
    )
    got = {client.get(r0, timeout=60)[0], client.get(r1, timeout=60)[0]}
    assert got == set(nodes)
    client.remove_placement_group(info["pg_id"])


def test_node_affinity_routing(cluster):
    client = cluster.client()
    # hard affinity: lands exactly on the named node
    for target in ("head", "n1", "n2"):
        ref = client.submit(_whoami, affinity_node_id=target)
        node_id, _ = client.get(ref, timeout=60)
        assert node_id == target
    # hard affinity to a nonexistent node: the task fails, not silently runs
    ref = client.submit(_whoami, affinity_node_id="no-such-node", max_retries=0)
    with pytest.raises(ClusterTaskError, match="not alive"):
        client.get(ref, timeout=60)
    # soft affinity to a dead node: falls back to any node
    ref = client.submit(
        _whoami, affinity_node_id="no-such-node", affinity_soft=True
    )
    node_id, _ = client.get(ref, timeout=60)
    assert node_id in ("head", "n1", "n2")


def test_kill_remote_actor_releases_lease(cluster):
    """Killing an actor on a REMOTE node must release its lease there:
    the node's availability is restored and its dedicated worker reaped
    (regression: release used to always go to the driver's local daemon)."""
    client = cluster.client()
    h = client.create_actor(Counter, (0,), resources={"num_cpus": 1, "magic": 1})
    assert client.get(h.where.remote(), timeout=60) == "n2"  # only n2 has magic
    nodes = {n["node_id"]: tuple(n["addr"]) for n in client.nodes()}
    stats = client.pool.get(nodes["n2"]).call("stats", None)
    assert stats["available"].get("magic", 0) == 0  # lease holds the resource
    h.kill()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        stats = client.pool.get(nodes["n2"]).call("stats", None)
        if stats["available"].get("magic", 0) == 1 and stats["num_leases"] == 0:
            break
        time.sleep(0.2)
    assert stats["available"].get("magic", 0) == 1, stats
    assert stats["num_leases"] == 0, stats


def test_cluster_task_tracing(cluster):
    """Driver-side spans for cluster tasks: lease + exec slices per task,
    exported Chrome-trace (reference: `ray timeline` via GcsTaskManager
    task events)."""
    client = cluster.client()
    client.get([client.submit(_whoami) for _ in range(5)], timeout=60)
    stats = client.task_stats()
    assert stats["tasks"] >= 5
    assert stats["exec_ms_p50"] > 0
    events = client.timeline()
    assert len(events) >= 10  # lease + exec per task
    assert {e["cat"] for e in events} == {"lease", "exec"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)


@pytest.mark.trace
def test_trace_context_rides_task_envelope(cluster):
    """ray_tpu_torch.obs: a TraceContext active at submit time travels inside
    the task envelope — the worker process executes under (a child of)
    the caller's trace, and the driver-side timeline spans carry the
    trace id so cluster work nests under the originating request."""
    from ray_tpu_torch import obs

    client = cluster.client()

    def traced_work():
        from ray_tpu_torch.obs import context as tc

        cur = tc.current()
        return cur.trace_id if cur else None

    with obs.span("cluster.request_root") as ctx:
        got = client.get(client.submit(traced_work), timeout=60)
    assert got == ctx.trace_id, "worker executed outside the caller's trace"
    # the driver span lands on the submitter thread's finally AFTER the
    # return object is readable: poll briefly
    deadline = time.time() + 5
    events = []
    while time.time() < deadline and not events:
        events = [
            e for e in client.timeline()
            if e.get("args", {}).get("trace_id") == ctx.trace_id
        ]
        if not events:
            time.sleep(0.05)
    assert events, "driver lease/exec spans lost the trace id"


def test_task_returns_ride_shared_memory(cluster):
    """Task results are sealed into the C++ shared-memory store by the
    WORKER and adopted (pinned) by the daemon — the bytes never cross the
    put RPC (reference: plasma client seal + raylet adoption)."""
    client = cluster.client()

    def blob():
        return b"z" * 200_000  # above the 64KB shm threshold

    refs = [client.submit(blob) for _ in range(4)]
    for r in refs:
        assert client.get(r, timeout=60) == b"z" * 200_000
    shm_objects = 0
    for n in client.nodes():
        st = client.pool.get(tuple(n["addr"])).call("stats", None)["objects"]
        held = st.get("shm_objects", 0)
        shm_objects += held
        if held:  # a node holding shm objects must show shm bytes in use
            assert st["shm"]["used"] > 0
    assert shm_objects >= 4, "results did not land in the shm tier"


