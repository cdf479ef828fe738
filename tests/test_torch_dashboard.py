"""The port's dashboard (``ray_tpu_torch.dashboard``) held against ray_tpu's.

The reference serves on aiohttp; the port on the standard library's
``ThreadingHTTPServer`` (the card's host has no aiohttp). Compared like
with like (band: exact):

- the local view: ``tests/test_observability.py``'s dashboard scenario
  on both packages' in-process runtimes; every route answers on both with
  the same status and content type, and each JSON answer carries the
  reference's keys; ``/api/trace`` is bounded with the same flags;
- the cluster view: ``tests/test_cluster_dashboard.py``'s scenario over
  each package's ``LocalCluster`` (``head`` and ``n1``): the same node
  ids, live per-daemon stats, the worker span of a task in the merged
  timeline, and every cluster route's JSON with the reference's keys;
- the port binds port 0 and reads the bound port back; a taken port is a
  ``RuntimeError`` naming it.

The reference's dashboard binds a free port picked here (its ``port``
reads back what it was given). The module shuts down any in-process
runtime an earlier file left up and everything it started.
"""

import json
import socket
import sys
import time
import urllib.error
import urllib.request

import cloudpickle
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import dashboard as jdash
from ray_tpu import obs as jobs
from ray_tpu import serve as jserve
from ray_tpu.cluster import LocalCluster as JLocalCluster
from ray_tpu.core import runtime as jrt
from ray_tpu_torch import dashboard as tdash
from ray_tpu_torch import obs as tobs
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.cluster import LocalCluster as TLocalCluster
from ray_tpu_torch.core import runtime as trt
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

cloudpickle.register_pickle_by_value(sys.modules[__name__])
register_pickle_by_value(sys.modules[__name__])

WAIT_S = 60  # every HTTP request, task get and poll fails past this

LOCAL_ROUTES = ("/healthz", "/api/tasks", "/api/tasks?state=FINISHED", "/api/actors",
                "/api/objects", "/api/nodes", "/api/placement_groups", "/api/summary",
                "/api/cluster_status", "/metrics", "/timeline", "/api/trace",
                "/api/trace?limit=1", "/api/requests")
CLUSTER_ROUTES = ("/api/cluster/nodes", "/api/cluster/actors", "/api/cluster/placement_groups",
                  "/api/cluster/demand", "/api/cluster/timeline", "/api/metrics/cluster",
                  "/api/slo", "/api/perf", "/metrics/cluster")


def _down():
    for serve, runtime in ((jserve, jrt), (tserve, trt)):
        serve.shutdown()
        if runtime.is_initialized():
            runtime.shutdown_runtime()


@pytest.fixture(scope="module", autouse=True)
def _module_runtimes():
    _down()
    yield
    _down()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str) -> tuple:
    """(status, content type without parameters, body bytes)."""
    try:
        with urllib.request.urlopen(url, timeout=WAIT_S) as r:
            return r.status, r.headers.get_content_type(), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get_content_type(), e.read()


def _shape(ctype: str, body: bytes):
    """What is compared of an answer: a JSON dict's keys, a list's element
    keys (union over dict rows), or the type of a text body."""
    if ctype != "application/json":
        return "text"
    obj = json.loads(body)
    if isinstance(obj, dict):
        return ("dict", sorted(obj))
    if isinstance(obj, list):
        keys = sorted({k for row in obj if isinstance(row, dict) for k in row})
        return ("list", keys)
    return type(obj).__name__


def _keys_cover(ref_shape, port_shape) -> bool:
    """The port's answer carries every key of the reference's."""
    if ref_shape == "text" or port_shape == "text":
        return ref_shape == port_shape
    if ref_shape[0] != port_shape[0]:
        return False
    return set(ref_shape[1]) <= set(port_shape[1])


def _dash_task():
    return 42


class _DashActor:
    def ping(self):
        return "pong"


def test_dashboard_endpoints():
    """The reference's scenario on both packages, then every local route's
    status, content type and JSON keys compared."""
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    answers = {}
    try:
        for name, api, dash_mod, obs in (("ref", ray_tpu, jdash, jobs),
                                         ("port", ray_tpu_torch, tdash, tobs)):
            assert api.get(api.remote(_dash_task).remote(), timeout=WAIT_S) == 42
            actor = api.remote(_DashActor).remote()
            assert api.get(actor.ping.remote(), timeout=WAIT_S) == "pong"
            obj = api.put([1, 2, 3])
            pg = api.placement_group([{"CPU": 1}])
            with obs.span("test.dash_root"):
                pass
            port = _free_port() if name == "ref" else 0
            d = dash_mod.start_dashboard(port=port)
            try:
                base = f"http://127.0.0.1:{d.port}"
                assert d.port != 0
                assert _get(f"{base}/healthz")[2] == b"success"
                tasks = json.loads(_get(f"{base}/api/tasks")[2])
                assert any("_dash_task" in t["name"] for t in tasks)
                assert len(json.loads(_get(f"{base}/api/nodes")[2])) == 1
                assert "cluster_resources" in json.loads(_get(f"{base}/api/cluster_status")[2])
                assert isinstance(json.loads(_get(f"{base}/timeline")[2]), list)
                one = json.loads(_get(f"{base}/api/trace?limit=1")[2])
                assert len(one["events"]) == 1 and one["truncated"] is True
                answers[name] = {}
                for route in LOCAL_ROUTES + ("/no/such/route",):
                    status, ctype, body = _get(base + route)
                    answers[name][route] = (status, ctype, _shape(ctype, body) if status == 200
                                            else None)
            finally:
                dash_mod.shutdown_dashboard()
                api.remove_placement_group(pg)
                del obj
    finally:
        _down()
    for route, (status, ctype, shape) in answers["ref"].items():
        p_status, p_ctype, p_shape = answers["port"][route]
        assert (p_status, p_ctype) == (status, ctype), route
        if status == 200:
            assert _keys_cover(shape, p_shape), (route, shape, p_shape)


def test_port_zero_reads_back_and_a_taken_port_is_refused():
    d = tdash.Dashboard(port=0)
    try:
        assert d.port > 0
        assert _get(f"http://127.0.0.1:{d.port}/healthz") == (200, "text/plain", b"success")
        with pytest.raises(RuntimeError, match=f"dashboard failed to bind 127.0.0.1:{d.port}"):
            tdash.Dashboard(port=d.port)
    finally:
        d.shutdown()
    assert not d._thread.is_alive()


@pytest.fixture(scope="module")
def clusters():
    """Each package's cluster (``head`` and ``n1``, two CPUs each), started
    on first use; both shut down after the module."""
    up: dict = {}

    def get(name):
        if name not in up:
            cls = JLocalCluster if name == "ref" else TLocalCluster
            c = cls(node_death_timeout_s=2.0)
            up[name] = c
            c.start()
            c.add_node({"num_cpus": 2}, node_id="head")
            c.add_node({"num_cpus": 2}, node_id="n1")
            c.wait_for_nodes(2)
        return up[name]

    yield get
    for c in up.values():
        c.shutdown()
    if "port" in up:
        left = up["port"].leftovers()
        assert left == {"processes": [], "store_files": []}, left


def _answer():
    return 42


def test_cluster_dashboard_routes(clusters):
    answers = {}
    for name, dash_mod in (("ref", jdash), ("port", tdash)):
        cluster = clusters(name)
        client = cluster.client()
        assert client.get(client.submit(_answer), timeout=WAIT_S) == 42
        actor = client.create_actor(_DashActor, (), {}, resources={"num_cpus": 1},
                                    name=f"dash-{name}")
        assert client.get(actor.ping.remote(), timeout=WAIT_S) == "pong"
        pg = client.create_placement_group([{"num_cpus": 1}], strategy="PACK")
        port = _free_port() if name == "ref" else 0
        dash = dash_mod.Dashboard(port=port, gcs_address=cluster.address)
        try:
            base = f"http://127.0.0.1:{dash.port}"
            nodes = json.loads(_get(f"{base}/api/cluster/nodes")[2])
            assert {n["node_id"] for n in nodes} == {"head", "n1"}
            for n in nodes:  # live agent stats pulled from each daemon
                assert "stats" in n, n
                assert "available" in n["stats"] and "objects" in n["stats"]
            demand = json.loads(_get(f"{base}/api/cluster/demand")[2])
            assert "pending" in demand and "nodes" in demand
            # worker-side execution spans flow worker -> daemon -> dashboard
            deadline = time.time() + WAIT_S
            events = []
            while time.time() < deadline:
                events = json.loads(_get(f"{base}/api/cluster/timeline")[2])
                if any(e["name"] == "_answer" for e in events):
                    break
                time.sleep(0.5)
            ev = next(e for e in events if e["name"] == "_answer")
            assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["pid"] in ("head", "n1")
            answers[name] = {"event": sorted(ev), "node_stats": sorted(nodes[0]["stats"])}
            for route in CLUSTER_ROUTES + LOCAL_ROUTES[:1]:
                status, ctype, body = _get(base + route)
                answers[name][route] = (status, ctype, _shape(ctype, body))
        finally:
            dash.shutdown()
            actor.kill()
            client.remove_placement_group(pg["pg_id"])
    assert answers["port"]["event"] == answers["ref"]["event"]
    assert set(answers["ref"]["node_stats"]) <= set(answers["port"]["node_stats"])
    for route in CLUSTER_ROUTES + LOCAL_ROUTES[:1]:
        status, ctype, shape = answers["ref"][route]
        p_status, p_ctype, p_shape = answers["port"][route]
        assert (p_status, p_ctype) == (status, ctype), route
        assert status == 200, route
        assert _keys_cover(shape, p_shape), (route, shape, p_shape)
