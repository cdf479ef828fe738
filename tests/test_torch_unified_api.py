"""The port's PUBLIC api (init/remote/get/put/wait/actors/PGs) running
against a multi-process LocalCluster — one runtime surface, two backends.

The 9 cases of ``tests/test_unified_api.py`` on ``ray_tpu_torch``, to
those tests' expectations: ``ray_tpu_torch.init(address=...)`` attaches
the driver to a GCS, and the same user program runs cluster-wide.
"""

import os
import sys

import pytest

from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.core import api
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port

register_pickle_by_value(sys.modules[__name__])


def assert_no_cluster_left(c):
    """No process of ``c`` (GCS, daemons, workers) and no store file of its
    daemons outlived its shutdown."""
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left


@pytest.fixture(scope="module")
def attached_cluster():
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="head")
        c.add_node({"num_cpus": 2, "gold": 1}, node_id="n1")
        c.wait_for_nodes(2)
        api.init(address=c.address)
        yield c
    finally:
        api.shutdown()
        c.shutdown()
        assert_no_cluster_left(c)


@api.remote
def where():
    return os.environ.get("RAY_TPU_NODE_ID"), os.getpid()


@api.remote
def add(a, b):
    return a + b


@api.remote
class Accum:
    def __init__(self, start=0):
        self.total = start

    def add(self, x):
        self.total += x
        return self.total

    def node(self):
        return os.environ.get("RAY_TPU_NODE_ID")


def test_remote_task_runs_in_worker_process(attached_cluster):
    node, pid = api.get(where.remote())
    assert node in ("head", "n1")
    assert pid != os.getpid()


def test_put_get_wait(attached_cluster):
    ref = api.put({"x": 41})
    assert api.get(ref) == {"x": 41}
    refs = [add.remote(i, i) for i in range(4)]
    ready, pending = api.wait(refs, num_returns=4, timeout=60)
    assert len(ready) == 4 and not pending
    assert sorted(api.get(refs)) == [0, 2, 4, 6]


def test_task_options_resources(attached_cluster):
    node, _ = api.get(where.options(num_cpus=1, resources={"gold": 1}).remote())
    assert node == "n1"  # only n1 has `gold`


def test_ref_as_argument(attached_cluster):
    a = add.remote(1, 2)
    b = add.remote(a, 10)  # ClusterObjectRef flows as an arg
    assert api.get(b) == 13


def test_actor_lifecycle_and_naming(attached_cluster):
    h = Accum.options(name="acc", num_cpus=1).remote(100)
    assert api.get(h.add.remote(1)) == 101
    h2 = api.get_actor("acc")
    assert api.get(h2.add.remote(1)) == 102
    api.kill(h)


def test_actor_on_named_node(attached_cluster):
    h = Accum.options(resources={"gold": 1}).remote()
    assert api.get(h.node.remote()) == "n1"
    api.kill(h)


def test_placement_group_strategy(attached_cluster):
    pg = api.placement_group(
        [{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD", name="gang"
    )
    assert pg.ready(timeout=30)
    nodes = set()
    for i in range(2):
        strat = api.PlacementGroupSchedulingStrategy(pg, i)
        node, _ = api.get(where.options(scheduling_strategy=strat, num_cpus=1).remote())
        nodes.add(node)
    assert nodes == {"head", "n1"}
    api.remove_placement_group(pg)


def test_cluster_resources_visible(attached_cluster):
    total = api.cluster_resources()
    assert total.get("num_cpus") == 4.0
    assert total.get("gold") == 1.0


def test_nested_task_submission(attached_cluster):
    def inner(x):
        return x * 2

    def outer():
        # a task submitting a task from inside a worker process
        from ray_tpu_torch.core import api as inner_api

        f = inner_api.remote(inner)
        return inner_api.get(f.remote(21))

    assert api.get(api.remote(outer).remote()) == 42
