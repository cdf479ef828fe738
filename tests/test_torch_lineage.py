"""Lineage reconstruction on the port's cluster: a task return lost with
its node is re-executed from the driver's task record (the 2 cases of
``tests/test_lineage.py`` on ``ray_tpu_torch.cluster``, to those tests'
expectations).

Reference analog: object recovery via lineage re-execution driven by
the ownership table (src/ray/core_worker object_recovery_manager).
Depth-1 semantics: the producing task reruns; tasks whose args were
also lost fail over to the normal task-lost error.
"""

import sys
import time

import pytest

from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port

register_pickle_by_value(sys.modules[__name__])


def assert_no_cluster_left(c):
    """No process of ``c`` (GCS, daemons, workers) and no store file of its
    daemons outlived its shutdown."""
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left


def _produce(tag):
    import os

    return {"tag": tag, "node": os.environ.get("RAY_TPU_NODE_ID")}


def _sleep_produce(tag):
    import os
    import time as _t

    _t.sleep(0.2)
    return {"tag": tag, "node": os.environ.get("RAY_TPU_NODE_ID")}


@pytest.fixture()
def cluster():
    c = LocalCluster(node_death_timeout_s=1.5)
    try:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="head")
        c.add_node({"num_cpus": 2, "target": 1}, node_id="victim")
        c.wait_for_nodes(2)
        yield c
    finally:
        c.shutdown()
        assert_no_cluster_left(c)


def test_lost_object_is_reconstructed(cluster):
    client = cluster.client()
    # force the task onto the victim node, result stored there. Do NOT
    # get() before the kill: a fetch would cache a copy on the driver's
    # daemon, and an object with a live copy (correctly) never rebuilds.
    ref = client.submit(_produce, args=("x",),
                        resources={"num_cpus": 1, "target": 1})
    ready, _ = client.wait([ref], num_returns=1, timeout=60)
    assert ready
    locs = client.gcs.call("locate_object", {"object_id": ref.id})
    assert locs, "object never registered a location"

    cluster.kill_node("victim")
    cluster.wait_node_dead("victim", timeout=30)
    # spare capacity for the re-execution: must satisfy the ORIGINAL
    # task spec (resources travel with the lineage record)
    cluster.add_node({"num_cpus": 2, "target": 1}, node_id="spare")
    cluster.wait_for_nodes(2)

    # the stored copy died with the node; get() must re-execute the task
    again = client.get(ref, timeout=90)
    assert again["tag"] == "x"
    assert again["node"] == "spare"  # re-executed, not a stale copy


def test_wait_triggers_reconstruction(cluster):
    client = cluster.client()
    ref = client.submit(_sleep_produce, args=("y",),
                        resources={"num_cpus": 1, "target": 1})
    ready, _ = client.wait([ref], num_returns=1, timeout=60)
    assert ready
    cluster.kill_node("victim")
    cluster.wait_node_dead("victim", timeout=30)
    cluster.add_node({"num_cpus": 2, "target": 1}, node_id="spare2")
    cluster.wait_for_nodes(2)

    deadline = time.monotonic() + 90
    ready, pending = [], [ref]
    while not ready and time.monotonic() < deadline:
        ready, pending = client.wait([ref], num_returns=1, timeout=5.0)
    assert ready, "wait() never saw the reconstructed object"
    assert client.get(ref, timeout=30)["tag"] == "y"
