"""Datasets over the port's cluster runtime: the same Dataset code path that
runs on in-process threads executes in worker PROCESSES when the driver is
attached to a cluster, and each exchange's merge runs on the node holding
most of its partition's split outputs.

The three scenarios of ``tests/test_data_cluster.py`` on
``ray_tpu_torch`` (map in workers, a shuffle's sum, the placed reduces),
``_majority_holder`` held against the reference's on seeded holder maps,
and each merge placed (soft affinity) on the node that holds most of its
partition.
Every wait has its own limit, and the cluster is checked to leave no
process and no store file.
"""

import os
import sys
import time

import numpy as np
import pytest

from ray_tpu.data.executor import _majority_holder as j_majority_holder
from ray_tpu_torch import data as tdata
from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.core import api
from ray_tpu_torch.core.serialization import register_pickle_by_value
from ray_tpu_torch.data.executor import _majority_holder

pytestmark = pytest.mark.torch_port

# test functions must travel by value: the worker processes have no tests/
# on their import path
register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module")
def attached_cluster():
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        c.add_node({"num_cpus": 4}, node_id="head")
        c.add_node({"num_cpus": 4}, node_id="n1")
        c.wait_for_nodes(2)
        api.init(address=c.address, ignore_reinit_error=True)
        yield c
    finally:
        api.shutdown()
        c.shutdown()
        left = c.leftovers()
        assert left == {"processes": [], "store_files": []}, left


def test_dataset_map_executes_in_worker_processes(attached_cluster):
    driver_pid = os.getpid()

    def tag(batch):
        import os as _os

        vals = [int(v) for v in batch["item"]]
        return {
            "x2": [v * 2 for v in vals],
            "pid": [_os.getpid()] * len(vals),
            "node": [_os.environ.get("RAY_TPU_NODE_ID", "?")] * len(vals),
        }

    ds = tdata.range(32, parallelism=4).map_batches(tag)
    rows = sorted(ds.take_all(), key=lambda r: r["x2"])
    assert [int(r["x2"]) for r in rows] == [2 * i for i in range(32)]
    pids = {r["pid"] for r in rows}
    assert driver_pid not in pids, "map ran in the driver, not workers"
    assert {r["node"] for r in rows} <= {"head", "n1"}


def test_dataset_shuffle_and_reduce_over_cluster(attached_cluster):
    ds = tdata.range(64, parallelism=4).random_shuffle(seed=7)
    total = sum(int(r) for r in ds.take_all())
    assert total == sum(range(64))


def _merge_nodes(n: int) -> list:
    client = api._cluster().client
    spans = [s for s in client._spans if s.get("desc", "").startswith("_exec_merge")]
    return [s["node"] for s in spans[-n:]]


def test_shuffle_reduces_placed_on_block_holders(attached_cluster):
    """Locality-aware exchange (upstream: push_based_shuffle_task_
    scheduler.py:400): reduce tasks run with soft affinity to the node
    holding most of their partition's split outputs, and partition bytes
    flow holder -> reducer through the object plane: the DRIVER process
    never touches a block during the exchange."""
    driver_pid = os.getpid()

    def tag(batch):
        import os as _os

        return {
            "item": list(batch["item"]),
            "pid": [_os.getpid()] * len(batch["item"]),
            "node": [_os.environ.get("RAY_TPU_NODE_ID", "?")] * len(batch["item"]),
        }

    ds = (
        tdata.range(160, parallelism=8)
        .random_shuffle(seed=3)
        .map_batches(tag)  # tags the POST-reduce blocks with their host
    )
    rows = ds.take_all()
    assert sorted(int(r["item"]) for r in rows) == list(range(160))
    pids = {int(r["pid"]) for r in rows}
    assert driver_pid not in pids, "exchange blocks transited the driver"
    nodes = {r["node"] for r in rows}
    assert nodes <= {"head", "n1"} and nodes, nodes
    # placement telemetry: reduce spans ran on real nodes
    span_nodes = set(_merge_nodes(8))
    assert span_nodes <= {"head", "n1"} and span_nodes, span_nodes


def test_merges_follow_the_data(attached_cluster):
    """Each merge of a shuffle is placed on the node that holds most of its
    partition's split outputs in the exchange's one locality snapshot (or
    left unplaced when the directory names no holder yet), a node that ran
    some of the exchange's split tasks, through a soft
    ``NodeAffinitySchedulingStrategy`` (a merge whose node is full runs
    elsewhere, so where each ran is not asserted, only that it ran on a
    node of the cluster)."""
    from ray_tpu_torch.data import executor

    placed, strategies = [], []
    real_holder, real_affinity = executor._majority_holder, api.NodeAffinitySchedulingStrategy

    def spy(refs, holder_map):
        node = real_holder(refs, holder_map)
        locs, addr_node = holder_map
        counts = {}
        for r in refs:
            for a in locs.get(r.id) or ():
                counts[addr_node[tuple(a)]] = counts.get(addr_node[tuple(a)], 0) + 1
        # None: no holder of this partition's outputs in the directory yet
        # (the merge goes unplaced, as in the reference)
        assert (not counts) if node is None else counts[node] == max(counts.values()), (
            node, counts)
        placed.append(node)
        return node

    def affinity(node_id, soft=False):
        strategies.append((node_id, soft))
        return real_affinity(node_id, soft=soft)

    client = api._cluster().client
    before = len(_merge_nodes(10000))
    executor._majority_holder = spy
    api.NodeAffinitySchedulingStrategy = affinity
    try:
        def pin(batch):
            import time as _t

            _t.sleep(0.2)  # overlap the map tasks so both nodes take some
            return {"item": list(batch["item"])}

        ds = tdata.range(128, parallelism=8).map_batches(pin, num_cpus=2).random_shuffle(
            seed=5)
        # a one-column "item" row comes back as its value
        assert sorted(int(r) for r in ds.take_all()) == list(range(128))
    finally:
        executor._majority_holder = real_holder
        api.NodeAffinitySchedulingStrategy = real_affinity
    # a task's span is recorded by its submit thread after the push returns,
    # which may be after its result was read
    deadline = time.monotonic() + 10
    while len(_merge_nodes(10000)) < before + 8 and time.monotonic() < deadline:
        time.sleep(0.02)
    split_nodes = {s["node"] for s in client._spans
                   if s.get("desc", "").startswith("_exec_split")}
    nodes = [p for p in placed if p is not None]
    assert len(placed) == 8 and nodes and set(nodes) <= split_nodes <= {"head", "n1"}, placed
    assert strategies == [(node, True) for node in nodes]
    assert set(_merge_nodes(8)) <= {"head", "n1"}


def _holder_maps():
    """Seeded locality snapshots: (refs, (object id -> holder addrs,
    addr -> node_id)), as ``_holder_map`` returns them."""
    rng = np.random.default_rng(20)
    addrs = [("10.0.0.%d" % i, 7000 + i) for i in range(4)]
    addr_node = {a: f"node{i}" for i, a in enumerate(addrs)}
    cases = []

    class Ref:
        def __init__(self, oid):
            self.id = oid

    for _ in range(6):
        refs = [Ref(bytes(rng.integers(0, 256, 8, dtype=np.uint8))) for _ in range(6)]
        locs = {}
        for r in refs:
            k = int(rng.integers(0, 3))
            idx = rng.choice(len(addrs), size=k, replace=False)
            locs[r.id] = [list(addrs[i]) for i in sorted(idx)]
        cases.append((refs, (locs, addr_node)))
    # no snapshot, and holders on no known node
    cases.append((cases[0][0], None))
    cases.append((cases[0][0], ({}, addr_node)))
    return cases


@pytest.mark.parametrize("case", range(8))
def test_majority_holder_equals_reference(case):
    refs, holder_map = _holder_maps()[case]
    got = _majority_holder(refs, holder_map)
    assert got == j_majority_holder(refs, holder_map)
    if holder_map is None or not holder_map[0]:
        assert got is None

