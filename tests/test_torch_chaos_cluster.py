"""Cluster chaos on the port: seeded node kills, a heartbeat partition
carried to the daemon by the environment, and a graceful drain, against a
real GCS + node-daemon + worker-process cluster.

The four scenarios of ``tests/test_chaos_cluster.py`` on
``ray_tpu_torch.cluster`` and ``ray_tpu_torch.chaos.runner.ChaosRunner``,
to those tests' expectations. Every wait has its own deadline, and every
cluster is checked to leave no process and no store file
(``LocalCluster.leftovers``).
"""

import os
import sys
import time

import pytest

from ray_tpu_torch import chaos
from ray_tpu_torch.chaos.runner import ChaosRunner
from ray_tpu_torch.cluster import ClusterTaskError, LocalCluster
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port

# test functions/classes travel by value: worker processes have no tests/
register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    chaos.uninstall()


class Counter:
    def __init__(self, start):
        self.v = start

    def incr(self):
        self.v += 1
        return self.v

    def where(self):
        import os

        return os.environ.get("RAY_TPU_NODE_ID")


def _tracked(path, hold_s):
    import os
    import time

    with open(path, "a") as f:
        f.write(f"{os.environ.get('RAY_TPU_NODE_ID')}:{os.getpid()}\n")
    time.sleep(hold_s)
    return "done"


def _assert_left_nothing(c):
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left


def test_node_kill_task_exactly_once_actor_restart_pg_reschedule(tmp_path):
    """One orchestrated PREEMPT_NODE: the leased task is resubmitted
    exactly once, the max_restarts actor is rebuilt on the surviving node,
    and the placement group's bundle is rescheduled and re-reserved."""
    marker = str(tmp_path / "chaos_kill")
    sched = chaos.FaultSchedule(21, [
        chaos.FaultSpec(chaos.PREEMPT_NODE, target="victim", at_s=0.3),
    ])
    with LocalCluster(node_death_timeout_s=1.5) as c:
        c.start()
        c.add_node({"num_cpus": 0}, node_id="head")  # driver-only
        c.add_node({"num_cpus": 4}, node_id="victim")
        c.wait_for_nodes(2)
        client = c.client()

        h = client.create_actor(Counter, (0,), max_restarts=2, resources={"num_cpus": 1})
        assert client.get(h.incr.remote(), timeout=60) == 1
        pg = client.create_placement_group([{"num_cpus": 1}], strategy="PACK")
        assert pg["bundles"][0]["node_id"] == "victim"

        ref = client.submit(_tracked, (marker, 2.5), max_retries=3)
        deadline = time.time() + 60
        while time.time() < deadline:
            if os.path.exists(marker) and open(marker).read().count("\n"):
                break
            time.sleep(0.05)
        assert open(marker).read().startswith("victim:"), "task never started on victim"

        runner = ChaosRunner(sched, cluster=c).start()
        try:
            time.sleep(0.6)
            c.add_node({"num_cpus": 4}, node_id="rescue")
            c.wait_node_dead("victim", timeout=30)

            assert client.get(ref, timeout=120) == "done"
            lines = open(marker).read().splitlines()
            assert len(lines) == 2, lines
            assert lines[0].startswith("victim:")
            assert lines[1].startswith("rescue:")

            deadline = time.time() + 60
            val = None
            while time.time() < deadline:
                try:
                    val = client.get(h.incr.remote(), timeout=20)
                    break
                except ClusterTaskError:
                    time.sleep(0.5)
            assert val == 1
            assert client.get(h.where.remote(), timeout=30) == "rescue"

            deadline = time.time() + 30
            info = None
            while time.time() < deadline:
                info = client.gcs.call("get_pg", {"pg_id": pg["pg_id"]})
                if info["state"] == "CREATED" and info["bundles"][0]["node_id"] == "rescue":
                    break
                time.sleep(0.2)
            assert info and info["bundles"][0]["node_id"] == "rescue", info
            r = client.submit(lambda: 42, resources={"num_cpus": 1}, pg_id=pg["pg_id"],
                              bundle_index=0)
            assert client.get(r, timeout=60) == 42
        finally:
            runner.stop()
        assert [f.kind for f in runner.executed] == [chaos.PREEMPT_NODE]
    _assert_left_nothing(c)


def test_heartbeat_partition_late_reply_no_double_execution(tmp_path):
    """A transient STALL_HEARTBEAT, handed to the daemon through the
    environment, gets the node declared dead while its task runs on: the
    late completion wins, the node re-registers, and the task ran once."""
    marker = str(tmp_path / "chaos_partition")
    sched = chaos.FaultSchedule(13, [
        # stall 6 beats (~3 s) after the first 4: past the 2 s death verdict
        chaos.FaultSpec(chaos.STALL_HEARTBEAT, site="node.heartbeat",
                        match={"node_id": "victim"}, start_after=4, max_fires=6),
    ])
    chaos.install(sched, propagate_env=True)  # before add_node: the env is copied
    with LocalCluster(node_death_timeout_s=2.0) as c:
        c.start()
        c.add_node({"num_cpus": 0}, node_id="head")
        c.add_node({"num_cpus": 2}, node_id="victim")
        c.wait_for_nodes(2)
        client = c.client()
        ref = client.submit(_tracked, (marker, 7.0), affinity_node_id="victim", max_retries=3)
        time.sleep(1.0)
        c.wait_node_dead("victim", timeout=30)  # the partition's verdict
        assert client.get(ref, timeout=120) == "done"
        lines = open(marker).read().splitlines()
        assert len(lines) == 1 and lines[0].startswith("victim:"), lines
        alive = {n["node_id"]: n["alive"] for n in client.nodes()}
        assert alive["victim"] is True
    _assert_left_nothing(c)


def test_node_drain_stops_admission_and_deregisters():
    with LocalCluster(node_death_timeout_s=5.0) as c:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="head")
        c.add_node({"num_cpus": 2}, node_id="n1")
        c.wait_for_nodes(2)
        client = c.client()
        n1_addr = tuple(c.nodes["n1"].addr)
        r = client.pool.get(n1_addr).call("drain", {"timeout_s": 15.0}, timeout=10)
        assert r["ok"]
        deadline = time.time() + 30
        while time.time() < deadline:
            n1 = next(n for n in client.nodes() if n["node_id"] == "n1")
            if not n1["alive"] or n1.get("draining"):
                break
            time.sleep(0.1)
        assert (not n1["alive"]) or n1.get("draining"), n1

        def whereami():
            import os

            return os.environ.get("RAY_TPU_NODE_ID")

        refs = [client.submit(whereami) for _ in range(4)]
        assert {client.get(r, timeout=60) for r in refs} == {"head"}
        deadline = time.time() + 30
        while time.time() < deadline:
            n1 = next(n for n in client.nodes() if n["node_id"] == "n1")
            if not n1["alive"]:
                break
            time.sleep(0.2)
        assert not n1["alive"], n1
    _assert_left_nothing(c)


def test_chaos_soak_repeated_node_kills():
    """Two kill/rescue rounds with retriable work in flight: every task
    completes despite losing its node mid-run."""
    with LocalCluster(node_death_timeout_s=1.5) as c:
        c.start()
        c.add_node({"num_cpus": 0}, node_id="head")
        c.add_node({"num_cpus": 4}, node_id="gen0")
        c.wait_for_nodes(2)
        client = c.client()

        def hold(i):
            import time

            time.sleep(2.0)
            return i * 10

        for round_i in range(2):
            refs = [client.submit(hold, (i,), max_retries=4) for i in range(3)]
            time.sleep(0.8)  # the leases land on the doomed node
            c.kill_node(f"gen{round_i}")
            c.add_node({"num_cpus": 4}, node_id=f"gen{round_i + 1}")
            assert [client.get(r, timeout=180) for r in refs] == [0, 10, 20]
    _assert_left_nothing(c)
