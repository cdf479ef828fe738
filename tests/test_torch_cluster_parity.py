"""The port's cluster runtime held against the reference in one process,
and the slice as a whole on a port cluster.

- The same sequence of operations on both packages' in-process
  ``GcsService`` (nodes, heartbeats, KV with ``kv_wait``, actors,
  placement groups, the object directory, drain, ``events_since``, the
  ``--persist`` snapshot replayed) gives equal results, and so do the
  RPCs later parts brought (the KV prefix index, the autoscaler's
  inputs).
- Frames written by ``ray_tpu/native``'s ``libframing`` are read by the
  port's, and the reverse.
- The slice: ``LLAMA_TINY`` in fp32 on ``device="cpu"``, served by an
  actor of a port cluster in a worker process, its weights the reference
  engine's own (carried over by ``params_from_numpy``, shipped through the
  cluster's store), gives the reference ``LLMEngine``'s greedy tokens in
  this process, token for token. The GCS and the daemons never load
  torch; the worker does.
- The card rule on the CPU: a GPU lease's worker sees exactly its
  daemon's card, a CPU lease's worker sees none (``CUDA_VISIBLE_DEVICES``
  ""), the two never share a worker, and a GPU lease on a node that sees
  no card fails instead of running on the CPU.
"""

import dataclasses
import os
import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.cluster.gcs_service import GcsService as JGcsService
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.native import framing as jframing
from ray_tpu_torch.cluster import ClusterTaskError, LocalCluster
from ray_tpu_torch.cluster.gcs_service import GcsService as TGcsService
from ray_tpu_torch.core.serialization import register_pickle_by_value
from ray_tpu_torch.native import framing as tframing

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

register_pickle_by_value(sys.modules[__name__])

WAIT_S = 60  # every wait on a task or an actor fails past this


def assert_no_cluster_left(c):
    """No process of ``c`` (GCS, daemons, workers) and no store file of its
    daemons outlived its shutdown."""
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left


def _loads_libtorch(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


# ---------------------------------------------------------------------------
# the GCS tables
# ---------------------------------------------------------------------------


def _gcs_script(gcs) -> list:
    """One sequence of GCS operations; every answer, in order."""
    out = []
    call = lambda m, p=None: out.append((m, getattr(gcs, f"rpc_{m}")(p, None)))  # noqa: E731
    for nid, port, res in (("n0", 1, {"num_cpus": 2.0}),
                           ("n1", 2, {"num_cpus": 2.0, "GPU": 1.0}),
                           ("n2", 3, {"num_cpus": 1.0})):
        call("register_node", {"node_id": nid, "addr": ("127.0.0.1", port), "resources": res,
                               "labels": {"zone": nid[-1]}})
    call("heartbeat", {"node_id": "n0", "available": {"num_cpus": 1.0}, "pending": []})
    call("heartbeat", {"node_id": "ghost", "available": {}})
    call("heartbeat", {"node_id": "n1", "available": {"num_cpus": 2.0}})
    call("heartbeat", {"node_id": "n2", "draining": True})
    call("kv_put", {"ns": "a", "key": b"k1", "value": b"v1"})
    call("kv_put", {"ns": "a", "key": b"k1", "value": b"v2", "nx": True})
    call("kv_put", {"ns": "a", "key": b"k2", "value": b"v3"})
    call("kv_get", {"ns": "a", "key": b"k1"})
    call("kv_keys", {"ns": "a", "prefix": b"k"})
    call("kv_wait", {"ns": "a", "key": b"k2", "wait": 0.05})
    call("kv_wait", {"ns": "a", "key": b"absent", "wait": 0.05})
    call("kv_del", {"ns": "a", "key": b"k2"})
    call("kv_keys", {"ns": "a"})
    for i, name in enumerate(("alpha", None)):
        call("register_actor", {"actor_id": bytes([i]) * 16, "name": name, "namespace": "ns",
                                "node_id": "n0", "worker_addr": ("127.0.0.1", 10 + i),
                                "state": "ALIVE", "max_restarts": i, "creation_spec": b"spec",
                                "lease": {"resources": {"num_cpus": 1}}, "lease_id": f"L{i}",
                                "node_addr": ("127.0.0.1", 1)})
    call("register_actor", {"actor_id": b"\x09" * 16, "name": "alpha", "namespace": "ns"})
    call("get_named_actor", {"name": "alpha", "namespace": "ns"})
    call("update_actor", {"actor_id": b"\x00" * 16, "state": "DEAD"})
    call("get_actor", {"actor_id": b"\x00" * 16})
    call("list_actors")
    for j, (strategy, bundles) in enumerate((("PACK", [{"num_cpus": 1.0}] * 2),
                                             ("STRICT_SPREAD", [{"num_cpus": 1.0}] * 2),
                                             ("STRICT_PACK", [{"num_cpus": 5.0}]))):
        call("create_pg", {"pg_id": bytes([j]) * 16, "bundles": bundles, "strategy": strategy,
                           "name": f"pg{j}"})
    call("get_pg", {"pg_id": b"\x02" * 16})
    call("list_pgs")
    call("remove_pg", {"pg_id": b"\x00" * 16})
    call("list_nodes")
    for oid, nid in ((b"o1", "n0"), (b"o1", "n1"), (b"o2", "n2")):
        call("add_object_location", {"object_id": oid, "node_id": nid})
    call("locate_object", {"object_id": b"o1"})
    call("locate_many", {"object_ids": [b"o1", b"o2", b"o3"]})
    call("remove_object_location", {"object_id": b"o1", "node_id": "n0"})
    call("drain_node", {"node_id": "n1"})
    call("locate_many", {"object_ids": [b"o1", b"o2"]})
    call("list_actors")
    call("list_nodes")
    call("gcs_ft")
    call("events_since", {"cursor": 0})
    call("events_since", {"cursor": 3, "wait": 0.05})
    return out


def test_gcs_tables_equal_reference():
    ref, port = _gcs_script(JGcsService()), _gcs_script(TGcsService())
    assert [m for m, _ in port] == [m for m, _ in ref]
    for (method, want), (_, got) in zip(ref, port):
        assert got == want, method


def test_kv_wait_and_events_long_poll_wake_on_both():
    """A parked ``kv_wait`` and a parked ``events_since`` wake on a put and
    a registration, on both packages, with the same answers."""
    answers = {}
    for name, cls in (("ref", JGcsService), ("port", TGcsService)):
        gcs, got = cls(), {}
        waiter = threading.Thread(target=lambda: got.setdefault(
            "kv", gcs.rpc_kv_wait({"ns": "t", "key": b"k", "wait": 5.0}, None)))
        poller = threading.Thread(target=lambda: got.setdefault(
            "ev", gcs.rpc_events_since({"cursor": 0, "wait": 5.0}, None)))
        waiter.start()
        poller.start()
        time.sleep(0.2)
        gcs.rpc_kv_put({"ns": "t", "key": b"k", "value": b"v"}, None)
        gcs.rpc_register_node({"node_id": "n", "addr": ("h", 1), "resources": {}}, None)
        waiter.join(timeout=10)
        poller.join(timeout=10)
        assert not waiter.is_alive() and not poller.is_alive()
        answers[name] = got
    assert answers["port"] == answers["ref"]
    assert answers["port"]["kv"] == b"v"


def test_gcs_snapshot_replays_after_restart(tmp_path):
    """The ``--persist`` snapshot: a GCS built on the same path comes back
    with the actors, placement groups and KV, and its nodes as claims
    asked to re-register (the reference's restore, on the port)."""
    outs = {}
    for name, cls in (("ref", JGcsService), ("port", TGcsService)):
        path = str(tmp_path / f"{name}.snap")
        gcs = cls(persist_path=path)
        gcs.rpc_register_node({"node_id": "n0", "addr": ("h", 1),
                               "resources": {"num_cpus": 2.0}}, None)
        gcs.rpc_register_actor({"actor_id": b"a" * 16, "name": "keep", "namespace": "ns",
                                "node_id": "n0", "state": "ALIVE"}, None)
        gcs.rpc_create_pg({"pg_id": b"p" * 16, "bundles": [{"num_cpus": 1.0}]}, None)
        gcs.rpc_kv_put({"ns": "d", "key": b"k", "value": b"v"}, None)
        gcs.persist_if_dirty()
        back = cls(persist_path=path)
        outs[name] = (back.rpc_get_named_actor({"name": "keep", "namespace": "ns"}, None),
                      back.rpc_list_pgs(None, None), back.rpc_kv_get({"ns": "d", "key": b"k"},
                                                                     None),
                      back.rpc_heartbeat({"node_id": "n0"}, None), back.ft["gcs_restarts_total"])
    assert outs["port"] == outs["ref"]
    assert outs["port"][3] == {"ok": False, "reregister": True}


KVTIER_PAYLOADS = {
    "kvtier_update": {"engine": "e0", "epoch": 1, "seq": 1, "rows": [[11, 0, 8], [12, 1, 16]]},
    "kvtier_drop": {"engine": "e0"},
    "kvtier_stats": None,
    "kvtier_lookup": {"hashes": [11, 12, 13]},
}


def _hist(name, tags, obs, bounds=(0.01, 0.05, 0.1, 0.5, 1.0)):
    import bisect

    series = []
    for tag, vals in obs.items():
        buckets = [0] * (len(bounds) + 1)
        for v in vals:
            buckets[bisect.bisect_left(bounds, v)] += 1
        series.append({"tags": [tag], "buckets": buckets, "sum": sum(vals), "count": len(vals)})
    return {"name": name, "type": "histogram", "description": "d", "tag_keys": list(tags),
            "boundaries": list(bounds), "agg": "merge", "series": series}


def _gauge(name, tag_keys, series, agg="sum"):
    return {"name": name, "type": "gauge", "description": "d", "tag_keys": list(tag_keys),
            "agg": agg, "series": [{"tags": list(t), "value": v} for t, v in series]}


# the autoscaler's inputs: two live nodes and a dead one, each beat with
# parked lease specs, and one engine's push (TTFT over the threshold, a
# role-tagged pool, queue depth, the prefill-span distribution)
AUTOSCALE_PUSH = {"reporter_id": "eng0", "kind": "engine", "role": "prefill", "snapshot": {
    "epoch": "eng0-e1", "seq": 1, "ts_monotonic": 1.0, "ts_wall": 1.0, "metrics": [
        _hist("ray_tpu_llm_ttft_seconds", ("model",), {"m": [0.02, 0.4, 0.6, 0.7]}),
        _hist("ray_tpu_llm_tpot_seconds", ("model",), {"m": [0.01, 0.02]}),
        _hist("ray_tpu_llm_prefill_span_seconds", ("model",), {"m": [0.02, 0.3, 0.4]}),
        _gauge("ray_tpu_llm_queue_depth", ("model",), [(("m",), 3.0)]),
        _gauge("ray_tpu_serve_replicas_running", ("app", "deployment", "role"),
               [(("a", "P", "prefill"), 1.0), (("a", "D", "decode"), 1.0)]),
        _gauge("ray_tpu_serve_replicas_target", ("app", "deployment", "role"),
               [(("a", "P", "prefill"), 2.0), (("a", "D", "decode"), 1.0)]),
    ]}}


def _autoscale_inputs(gcs) -> None:
    for node in ("n0", "n1", "n2"):
        gcs.rpc_register_node({"node_id": node, "addr": ("127.0.0.1", 0),
                               "resources": {"CPU": 4, "GPU": 1}, "labels": {}}, None)
    gcs.rpc_heartbeat({"node_id": "n0", "available": {"CPU": 1, "GPU": 0},
                       "pending": [{"GPU": 1}, {"CPU": 2}]}, None)
    gcs.rpc_heartbeat({"node_id": "n1", "available": {"CPU": 4, "GPU": 1},
                       "pending": [{"CPU": 8}]}, None)
    gcs.rpc_heartbeat({"node_id": "n2", "pending": [{"GPU": 4}]}, None)
    gcs.rpc_drain_node({"node_id": "n2"}, None)
    gcs.rpc_telemetry_push(AUTOSCALE_PUSH, None)


def _strip_wall(obj):
    """The answer without its wall-clock fields: ``ts_wall`` dropped, every
    ``staleness`` map's values (seconds since a push) dropped."""
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "staleness" and isinstance(v, dict) else _strip_wall(v))
                for k, v in obj.items() if k != "ts_wall"}
    if isinstance(obj, list):
        return [_strip_wall(v) for v in obj]
    return obj


@pytest.mark.parametrize("method", ["kvtier_update", "kvtier_drop", "kvtier_stats",
                                    "kvtier_lookup", "autoscale_signals", "cluster_demand"])
def test_later_parts_raise_naming_their_part(method):
    """The GCS RPCs later parts brought answer as the reference GCS's do:
    the KV prefix index's (part 3c), after one engine's snapshot, and the
    autoscaler's inputs (part 8), after the same node registrations,
    heartbeats with parked lease specs, a drain and one telemetry push, with
    the wall-clock fields set aside."""
    answers = {}
    for name, cls in (("ref", JGcsService), ("port", TGcsService)):
        gcs = cls()
        if not method.startswith("kvtier_"):
            _autoscale_inputs(gcs)
            payload = {"thresholds": {"ttft_p_s": 0.1, "min_count": 1}}
            answers[name] = _strip_wall(getattr(gcs, f"rpc_{method}")(payload, None))
            continue
        gcs.rpc_kvtier_update({"engine": "e1", "epoch": 1, "seq": 1,
                               "rows": [[11, 0, 8]]}, None)
        got = getattr(gcs, f"rpc_{method}")(KVTIER_PAYLOADS[method], None)
        if method == "kvtier_lookup":
            for row in got["engines"].values():
                row.pop("age_s")
        answers[name] = (got, gcs.rpc_kvtier_stats(None, None))
    assert answers["port"] == answers["ref"]
    if method == "autoscale_signals":
        got = answers["port"]
        assert got["pending_demand"] == 3  # the drained node's spec is not counted
        assert got["slo"]["model_tags"]["m"]["autoscaler_hints"]["scale_prefill"] is True
        assert got["pools"]["prefill"]["replicas_target"] == 2
        assert got["prefill_span"]["count"] == 3
    elif method == "cluster_demand":
        assert sorted(map(str, answers["port"]["pending"])) == sorted(
            map(str, [{"GPU": 1}, {"CPU": 2}, {"CPU": 8}]))


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_frames_cross_between_the_two_libraries(writer, reader):
    libs = {"ref": jframing, "port": tframing}
    wlib = libs[writer].load_library()
    a, b = socket.socketpair()
    try:
        rd = libs[reader].FrameReader(b.fileno(), timeout_ms=5000)
        rng = np.random.default_rng(0)
        for n in (0, 1, 4096, 3 << 20):
            body = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            done = threading.Thread(target=lambda: wlib.frame_write(a.fileno(), body, len(body),
                                                                    5000))
            done.start()
            got = rd.read_frame()
            done.join(timeout=10)
            assert got == body, (writer, reader, n)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the slice: LLAMA_TINY fp32 in a cluster actor = the reference engine
# ---------------------------------------------------------------------------

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
ENGINE = dict(num_blocks=128, block_size=4, max_num_seqs=8, max_prefill_len=64)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in [5, 37, 9, 52, 14, 23]]


class TinyServer:
    """A port engine on the worker's CPU, built from a reference params
    tree (nested dicts of numpy arrays) that arrived through the store."""

    def __init__(self, tree):
        import dataclasses
        import os
        import sys

        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMEngine
        from ray_tpu_torch.models import llama

        torch.set_num_threads(2)
        cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
        params = llama.params_from_numpy(tree, cfg, device="cpu")
        self.eng = LLMEngine(EngineConfig(model=cfg, **ENGINE), params=params, device="cpu")
        self.where = {"node": os.environ.get("RAY_TPU_NODE_ID"), "pid": os.getpid(),
                      "torch": "torch" in sys.modules,
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def generate(self, prompts, max_tokens):
        from ray_tpu_torch.llm import SamplingParams

        return self.eng.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                                         ignore_eos=True))

    def info(self):
        return self.where


def test_tiny_llama_in_a_cluster_actor_equals_the_reference_engine():
    import ray_tpu_torch

    ref = JLLMEngine(JEngineConfig(model=J_FP32_TINY, **ENGINE), seed=0)
    want = ref.generate(_prompts(), JSamplingParams(max_tokens=16, temperature=0.0,
                                                    ignore_eos=True))
    tree = jax.tree.map(np.asarray, ref.params)
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="head")
        c.wait_for_nodes(1)
        ray_tpu_torch.init(address=c.address)
        try:
            server = ray_tpu_torch.remote(TinyServer).remote(ray_tpu_torch.put(tree))
            got = ray_tpu_torch.get(server.generate.remote(_prompts(), 16), timeout=WAIT_S)
            info = ray_tpu_torch.get(server.info.remote(), timeout=WAIT_S)
        finally:
            ray_tpu_torch.shutdown()
        assert got == want
        assert info["node"] == "head" and info["pid"] != os.getpid()
        assert info["torch"] and info["visible"] == ""
        assert _loads_libtorch(info["pid"])
        for pid in c.pids():  # the GCS and the daemon
            assert not _loads_libtorch(pid), pid
    finally:
        c.shutdown()
        assert_no_cluster_left(c)


# ---------------------------------------------------------------------------
# the card rule, on the CPU
# ---------------------------------------------------------------------------


def _env_probe():
    import os
    import sys

    return {"node": os.environ.get("RAY_TPU_NODE_ID"), "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "torch": "torch" in sys.modules}


def test_card_grants_pin_workers_and_a_node_without_a_card_refuses(monkeypatch):
    c = LocalCluster(node_death_timeout_s=2.0)
    try:
        c.start()
        # each daemon's own CUDA_VISIBLE_DEVICES is the cards it sees
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
        c.add_node({"num_cpus": 2, "GPU": 1}, node_id="card")
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        c.add_node({"num_cpus": 1, "GPU": 1, "blind": 1}, node_id="nocard")
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
        c.wait_for_nodes(2)
        client = c.client()
        gpu = client.get(client.submit(_env_probe, resources={"GPU": 1},
                                       affinity_node_id="card"), timeout=WAIT_S)
        cpu = client.get(client.submit(_env_probe, resources={"num_cpus": 1},
                                       affinity_node_id="card"), timeout=WAIT_S)
        again = client.get(client.submit(_env_probe, resources={"GPU": 1},
                                         affinity_node_id="card"), timeout=WAIT_S)
        assert gpu["visible"] == "3" and cpu["visible"] == ""
        assert gpu["pid"] != cpu["pid"]  # pooled by the card grant
        assert again["pid"] == gpu["pid"]  # and reused within it
        assert not gpu["torch"] and not cpu["torch"]
        with pytest.raises(ClusterTaskError, match="sees 0 card"):
            client.get(client.submit(_env_probe, resources={"GPU": 1, "blind": 1},
                                     max_retries=0), timeout=WAIT_S)
        stats = {n["node_id"]: client.pool.get(tuple(n["addr"])).call("stats", None)
                 for n in client.nodes()}
        assert stats["nocard"]["available"]["GPU"] == 1.0  # the refused lease gave it back
        assert stats["nocard"]["num_leases"] == 0
    finally:
        c.shutdown()
        assert_no_cluster_left(c)


# ---------------------------------------------------------------------------
# the RPC plane the cluster runs on
# ---------------------------------------------------------------------------


class _Handler:
    def rpc_echo(self, payload, peer):
        return payload

    async def rpc_aecho(self, payload, peer):
        return payload

    def rpc_unpicklable(self, payload, peer):
        class Local(Exception):
            pass

        raise Local("a local class does not pickle")

    def rpc_value(self, payload, peer):
        raise ValueError("bad value")


@pytest.mark.parametrize("native", ["0", "1"], ids=["python", "native"])
def test_rpc_handler_objects_remote_type_names_and_framing(monkeypatch, native):
    """Handler objects' ``rpc_<method>`` (plain and async), a 12 MiB frame
    each way, the remote type's name on ``RemoteError`` (a stand-in for an
    exception that does not pickle), the per-method latency histogram, on
    the Python and the native framing path."""
    from ray_tpu_torch.cluster.rpc import RemoteError, RemoteFailure, RpcClient, RpcError, RpcServer
    from ray_tpu_torch.util.metrics import prometheus_text

    monkeypatch.setenv("RAY_TPU_NATIVE_FRAMING", native)
    srv = RpcServer(_Handler())
    addr = srv.start()
    c = RpcClient(*addr, timeout=10.0).connect()
    try:
        assert (c._native is not None) == (native == "1")
        big = bytes(range(256)) * (48 << 10)
        assert c.call("echo", big) == big
        assert c.call("aecho", {"k": [1, 2]}) == {"k": [1, 2]}
        with pytest.raises(RemoteError) as ei:
            c.call("unpicklable")
        assert ei.value.type_name == "Local" and isinstance(ei.value.cause, RemoteFailure)
        with pytest.raises(RemoteError) as ei:
            c.call("value")
        assert ei.value.type_name == "ValueError" and isinstance(ei.value.cause, ValueError)
        with pytest.raises(RpcError, match="no route"):
            c.call("absent")
    finally:
        c.close()
        srv.stop()
    text = prometheus_text()
    assert 'controlplane_rpc_latency_ms_count{method="echo"}' in text


def test_reconnecting_client_redials_a_server_restarted_at_the_same_address():
    from ray_tpu_torch.cluster.rpc import (ReconnectingRpcClient, RpcServer, format_gcs_addr,
                                           parse_gcs_addr)

    srv = RpcServer(_Handler())
    host, port = srv.start()
    assert parse_gcs_addr(format_gcs_addr((host, port))) == (host, port)
    c = ReconnectingRpcClient(*parse_gcs_addr(f"{host}:{port}"), timeout=10.0).connect(retries=5)
    try:
        assert c.call("echo", 1) == 1
        srv.stop()
        srv = RpcServer(_Handler(), host=host, port=port)
        srv.start()
        assert c.call("echo", 2) == 2  # the dead connection re-dialed
    finally:
        c.close()
        srv.stop()
    # a primary and its standby: an ordered pair of endpoints
    assert parse_gcs_addr("h:1,h:2") == (("h", 1), ("h", 2))
