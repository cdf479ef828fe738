"""The port's cluster runtime under faults: the cases of
``tests/test_cluster.py`` that start clusters of their own, on
``ray_tpu_torch.cluster``, to those tests' expectations: the only compute
node killed mid-flight (a task retried, an actor restarted by the GCS on
the node that joined), the store's byte cap spilling to disk and a dropped
ref freeing cluster-wide, the GCS killed and restarted from its snapshot,
and the memory monitor killing a runaway worker whose task is retried.
Every wait has its own deadline, and every cluster is checked to leave no
process and no store file (``LocalCluster.leftovers``).
"""

import os
import sys
import time

import pytest

from ray_tpu_torch.cluster import ClusterTaskError, LocalCluster
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port

# test functions/classes must travel by value: the worker processes have
# no tests/ on their import path
register_pickle_by_value(sys.modules[__name__])

_GUARDED: list = []


def _guard(c):
    """Register ``c`` for the reap check that runs after its ``with``."""
    _GUARDED.append(c)


@pytest.fixture(autouse=True)
def _reaped():
    """A cluster a test started in a ``with`` block left no process and no
    store file."""
    yield
    while _GUARDED:
        left = _GUARDED.pop().leftovers()
        assert left == {"processes": [], "store_files": []}, left


def _whoami():
    import os

    return (os.environ.get("RAY_TPU_NODE_ID"), os.getpid())


class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def where(self):
        import os

        return os.environ.get("RAY_TPU_NODE_ID")


@pytest.mark.parametrize("mode", ["task_retry", "actor_restart"])
def test_node_death_recovery(mode):
    """Kill the only compute node mid-flight; a rescue node joins and the
    work recovers (task re-executed / actor restarted by the GCS)."""
    with LocalCluster(node_death_timeout_s=1.5) as c:
        _guard(c)
        c.start()
        # head is a driver-only node (no compute): all work lands on victim
        c.add_node({"num_cpus": 0}, node_id="head")
        c.add_node({"num_cpus": 2}, node_id="victim")
        c.wait_for_nodes(2)
        client = c.client()

        if mode == "task_retry":

            def slow():
                import time

                time.sleep(8)
                return "done"

            ref = client.submit(slow, max_retries=3)
            doomed_ref = client.submit(slow, max_retries=0, desc="no-retries")
            time.sleep(2.0)  # both running on victim
            c.kill_node("victim")
            c.add_node({"num_cpus": 2}, node_id="rescue")
            c.wait_node_dead("victim", timeout=15)
            # retryable task re-executes on the rescue node
            assert client.get(ref, timeout=120) == "done"
            # non-retryable task surfaces the loss
            with pytest.raises(ClusterTaskError, match="lost"):
                client.get(doomed_ref, timeout=120)
        else:
            h = client.create_actor(Counter, (0,), max_restarts=2)
            assert client.get(h.incr.remote(), timeout=60) == 1
            c.kill_node("victim")
            c.add_node({"num_cpus": 2}, node_id="rescue")
            c.wait_node_dead("victim", timeout=15)
            # GCS restarts the actor on the rescue node (fresh state)
            deadline = time.monotonic() + 60
            val = None
            while time.monotonic() < deadline:
                try:
                    val = client.get(h.incr.remote(), timeout=20)
                    break
                except ClusterTaskError:
                    time.sleep(0.5)
            assert val == 1  # restarted from scratch
            assert client.get(h.where.remote(), timeout=30) == "rescue"



def test_object_store_spills_over_capacity_and_frees_on_ref_drop():
    """Byte-capped LRU memory tier + disk spill (reference: plasma
    eviction_policy.h:105 + local_object_manager.h:41 spilling), and
    driver ref-drop freeing objects cluster-wide."""
    import gc

    with LocalCluster(node_death_timeout_s=2.0) as c:
        _guard(c)
        c.start()
        c.add_node(
            {"num_cpus": 1}, node_id="s0", object_capacity_bytes=1 << 20
        )
        c.wait_for_nodes(1)
        client = c.client()

        # 12 x 256 KiB = 3 MiB through a 1 MiB memory tier
        blobs = [os.urandom(256 << 10) for _ in range(12)]
        refs = [client.put(b) for b in blobs]
        addr = tuple(client.nodes()[0]["addr"])
        stats = client.pool.get(addr).call("stats", None)["objects"]
        assert stats["bytes"] <= (1 << 20) + (256 << 10), stats  # capped
        assert stats["spilled"] > 0, stats  # over-capacity spilled, not lost
        # every object still readable (spilled ones reload from disk)
        for ref, blob in zip(refs, blobs):
            assert client.get(ref, timeout=30) == blob

        # dropping the last driver handle frees cluster-wide
        freed_id = refs[0].id
        del refs[0]
        gc.collect()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            locs = client.gcs.call("locate_object", {"object_id": freed_id})
            if not locs:
                break
            time.sleep(0.1)
        assert not client.gcs.call("locate_object", {"object_id": freed_id})
        # the survivors are untouched
        assert client.get(refs[0], timeout=30) == blobs[1]



def test_gcs_fault_tolerance(tmp_path_factory):
    """kill -9 the GCS mid-workload; restart it at the same address with
    the snapshot: nodes re-register by heartbeat, the named actor is
    still resolvable, objects are re-locatable, and new tasks run
    (reference: Redis-backed GCS restart, redis_store_client.h:107 +
    gcs_init_data.cc replay)."""
    persist = str(tmp_path_factory.mktemp("gcsft") / "gcs.snap")
    with LocalCluster(node_death_timeout_s=2.0, gcs_persist_path=persist) as c:
        _guard(c)
        c.start()
        c.add_node({"num_cpus": 2}, node_id="ft0")
        c.wait_for_nodes(1)
        client = c.client()

        h = client.create_actor(Counter, (7,), name="survivor")
        assert client.get(h.incr.remote(), timeout=60) == 8
        ref = client.put({"payload": 123})
        time.sleep(0.8)  # let the debounced snapshot land

        c.kill_gcs()
        time.sleep(0.5)
        c.restart_gcs()

        # nodes re-register on their next heartbeat after the restart
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            try:
                alive = [n for n in client.nodes() if n["alive"]]
                if alive:
                    break
            except Exception:
                pass
            time.sleep(0.2)
        assert [n for n in client.nodes() if n["alive"]], "node did not re-register"

        # named actor survived (state intact: the worker process never died)
        h2 = client.get_named_actor("survivor")
        assert client.get(h2.incr.remote(), timeout=60) == 9
        # object directory rebuilt from node inventory
        assert client.get(ref, timeout=30) == {"payload": 123}
        # and fresh work schedules
        assert client.get(client.submit(_whoami), timeout=60)[0] == "ft0"
        h2.kill()



def test_memory_monitor_kills_runaway_worker_and_task_retries(tmp_path):
    """Reference: raylet worker_killing_policy.cc — a worker blowing the
    RSS cap is killed by the daemon's memory monitor; the task's pusher
    sees the connection drop and RE-LEASES it (max_retries), and the
    retry (which no longer over-allocates: transient pressure) completes.
    """
    marker = str(tmp_path / "attempt.marker")

    def greedy(marker_path):
        import os as _os
        import time as _t

        if not _os.path.exists(marker_path):
            with open(marker_path, "w") as f:
                f.write("1")
            # ~600MB over-allocation, far over the cap; park until killed
            hog = bytearray(600 << 20)
            hog[::4096] = b"x" * len(hog[::4096])  # touch pages
            _t.sleep(60)
            return "survived-over-limit"  # must never happen
        return "completed-on-retry"

    with LocalCluster(node_death_timeout_s=5.0) as cluster:
        _guard(cluster)
        cluster.start()
        # cap must clear a worker's BASELINE footprint but sit far under
        # the hog's allocation
        cluster.add_node({"num_cpus": 1}, node_id="memnode",
                         worker_rss_limit_mb=400)
        cluster.wait_for_nodes(1)
        client = cluster.client()
        ref = client.submit(
            greedy, (marker,), resources={"num_cpus": 1}, max_retries=3
        )
        out = client.get(ref, timeout=120)
        assert out == "completed-on-retry"
        # the daemon recorded the OOM kill
        stats = client.local_daemon.call("stats", None)
        assert stats["num_oom_kills"] >= 1, stats
