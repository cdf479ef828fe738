"""ActorPool and Queue over a cluster, the port against ray_tpu.

Each package's cluster (a GCS and two node daemons, ``head`` and ``n1``,
two CPUs each) is attached with ``init(address=)``:

- ``ActorPool`` over two ``ClusterActorHandle``s maps in order and out of
  order; the values are equal on both packages (band: exact).
- A ``Queue`` filled by the driver is drained by a cluster actor that was
  handed the queue: its handle crosses into the actor's worker, which
  reaches the queue's actor through its own client; what each side saw is
  equal on both packages.
- Pinned divergence: ``ActorPool.get_next(timeout=)`` over a cluster
  future. The cluster client raises its own ``GetTimeoutError``, which
  the reference's pool does not recognise, so it consumes the slot and
  the retry meets ``StopIteration``; the port's keeps the slot, so the
  retry returns the value, as both do in process.

The module shuts down any in-process runtime an earlier file left up and
shuts both packages' clusters down at the end; no process or store file of
the port's cluster outlives it.
"""

import sys
import time

import cloudpickle
import pytest
import torch

import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.cluster import LocalCluster as JLocalCluster
from ray_tpu.core import api as japi
from ray_tpu.core import runtime as jrt
from ray_tpu.util import ActorPool as JActorPool
from ray_tpu.util import Empty as JEmpty
from ray_tpu.util import Queue as JQueue
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.cluster import LocalCluster as TLocalCluster
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.core.serialization import register_pickle_by_value
from ray_tpu_torch.util import ActorPool as TActorPool
from ray_tpu_torch.util import Empty as TEmpty
from ray_tpu_torch.util import Queue as TQueue

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

# the workers are spawned clean: this module's classes go by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])
register_pickle_by_value(sys.modules[__name__])

WAIT_S = 60  # every get of an actor call fails past this

PKGS = {"ref": (japi, JLocalCluster, JActorPool, JQueue, JEmpty),
        "port": (ray_tpu_torch, TLocalCluster, TActorPool, TQueue, TEmpty)}


def _down_in_process():
    for serve, runtime in ((jserve, jrt), (tserve, trt)):
        serve.shutdown()
        if runtime.is_initialized():
            runtime.shutdown_runtime()


@pytest.fixture(scope="module")
def clusters():
    """Each package's cluster, started on its first use and attached; both
    shut down after the module."""
    _down_in_process()
    up: dict = {}

    def get(name):
        if name not in up:
            api, cluster_cls = PKGS[name][:2]
            c = cluster_cls(node_death_timeout_s=2.0)
            up[name] = c
            c.start()
            c.add_node({"num_cpus": 2}, node_id="head")
            c.add_node({"num_cpus": 2}, node_id="n1")
            c.wait_for_nodes(2)
            api.init(address=c.address)
        return up[name]

    yield get
    for name, c in up.items():
        try:
            PKGS[name][0].shutdown()
        finally:
            c.shutdown()
    if "port" in up:
        left = up["port"].leftovers()
        assert left == {"processes": [], "store_files": []}, left
    _down_in_process()


class Sq:
    def f(self, x):
        return x * x

    def slow(self, x):
        time.sleep(x)
        return x


class Drainer:
    """Handed a queue: drains it from its own worker process."""

    def drain(self, q, empty_type_name: str) -> dict:
        import os

        got = []
        while True:
            try:
                got.append(q.get_nowait())
            except Exception as e:  # noqa: BLE001 — the queue's Empty ends the drain
                if type(e).__name__ != empty_type_name:
                    raise
                break
        q.put("from-the-actor")
        return {"got": got, "pid": os.getpid(), "qsize": q.qsize()}


def test_actor_pool_over_cluster_handles(clusters):
    out = {}
    for name in ("ref", "port"):
        clusters(name)
        api, _, pool_cls, _, _ = PKGS[name]
        pool = pool_cls([api.remote(Sq).remote() for _ in range(2)])
        ordered = list(pool.map(lambda a, v: a.f.remote(v), range(6)))
        pool = pool_cls(pool._idle)
        unordered = sorted(pool.map_unordered(lambda a, v: a.f.remote(v), range(6)))
        out[name] = (ordered, unordered)
    assert out["port"] == out["ref"] == ([0, 1, 4, 9, 16, 25], [0, 1, 4, 9, 16, 25])


def test_queue_handle_crosses_into_a_cluster_actor(clusters):
    import os

    out = {}
    for name in ("ref", "port"):
        clusters(name)
        api, _, _, queue_cls, empty = PKGS[name]
        q = queue_cls()
        for i in range(12):
            q.put({"i": i, "prompt": list(range(i))})
        drainer = api.remote(Drainer).remote()
        got = api.get(drainer.drain.remote(q, empty.__name__), timeout=WAIT_S)
        assert got["pid"] != os.getpid()
        back = q.get(timeout=WAIT_S)
        with pytest.raises(empty):
            q.get_nowait()
        q.shutdown()
        out[name] = (got["got"], got["qsize"], back)
    assert out["port"] == out["ref"]
    assert [x["i"] for x in out["port"][0]] == list(range(12))


def test_actor_pool_cluster_timeout_divergence(clusters):
    """Pinned: a timed-out ``get_next`` over a cluster future keeps its slot
    on the port (the retry returns 1.0) and loses it on the reference (the
    retry raises StopIteration)."""
    out = {}
    for name in ("ref", "port"):
        clusters(name)
        api, _, pool_cls, _, _ = PKGS[name]
        pool = pool_cls([api.remote(Sq).remote()])
        pool.submit(lambda a, v: a.slow.remote(v), 1.0)
        with pytest.raises(Exception) as first:
            pool.get_next(timeout=0.05)
        try:
            retry = pool.get_next(timeout=WAIT_S)
        except StopIteration:
            retry = "StopIteration"
        out[name] = (type(first.value).__name__, retry)
    assert out["ref"] == ("GetTimeoutError", "StopIteration")
    assert out["port"] == ("GetTimeoutError", 1.0)
