"""The port's control plane through a blackout: write-ahead-acked
registrations, reconcile on restart, the status block, STALL_GCS.

The scenarios of ``tests/test_gcs_chaos.py`` but the trainer supervisor's
(ROADMAP.md Queue 1, item 10) and the two that read ``benchmarks/``
captures, on ``ray_tpu_torch.cluster``, to those tests' expectations.
Every wait has its own deadline, and every cluster is checked to leave no
process and no store file (``LocalCluster.leftovers``).
"""

import os
import sys
import time

import pytest

from ray_tpu_torch import chaos
from ray_tpu_torch.cluster import LocalCluster
from ray_tpu_torch.cluster.gcs_service import GcsService
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port

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


def _named(client, name, wait_s):
    """The named actor's handle once the restarted GCS resolves it."""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            return client.get_named_actor(name)
        except Exception:  # noqa: BLE001 — the GCS is still coming back
            time.sleep(0.2)
    return None


def _assert_left_nothing(c):
    left = c.leftovers()
    assert left == {"processes": [], "store_files": []}, left


# -- the write-ahead ack ------------------------------------------------------------


def test_write_ahead_ack_survives_crash_window(tmp_path):
    """kill -9 the GCS right after an actor registration's ack: the
    registration was persisted before the ack, so the restarted GCS still
    resolves the actor, whose worker (and state) never died."""
    persist = str(tmp_path / "gcs.snap")
    with LocalCluster(node_death_timeout_s=2.0, gcs_persist_path=persist) as c:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="wa0")
        c.wait_for_nodes(1)
        client = c.client()
        h = client.create_actor(Counter, (100,), name="acked")
        assert client.get(h.incr.remote(), timeout=60) == 101
        c.kill_gcs()  # no sleep: before any debounced sweep could run
        c.restart_gcs()
        h2 = _named(client, "acked", 20)
        assert h2 is not None, "write-ahead-acked actor lost across restart"
        assert client.get(h2.incr.remote(), timeout=60) == 102
        assert client.gcs.call("gcs_ft", {}, timeout=10)["gcs_restarts_total"] >= 1
        h2.kill()
    _assert_left_nothing(c)


def test_stale_snapshot_reconcile_resurrects_actor(tmp_path):
    """The snapshot is deleted between crash and restart (the GCS boots
    empty): the node's re-registration report resurrects the live actor,
    name and state."""
    persist = str(tmp_path / "gcs.snap")
    with LocalCluster(node_death_timeout_s=2.0, gcs_persist_path=persist) as c:
        c.start()
        c.add_node({"num_cpus": 2}, node_id="rs0")
        c.wait_for_nodes(1)
        client = c.client()
        h = client.create_actor(Counter, (5,), name="phoenix")
        assert client.get(h.incr.remote(), timeout=60) == 6
        c.kill_gcs()
        os.unlink(persist)  # the snapshot never happened
        c.restart_gcs()
        h2 = _named(client, "phoenix", 25)
        assert h2 is not None, "daemon re-report did not resurrect the actor"
        assert client.get(h2.incr.remote(), timeout=60) == 7
        ft = client.gcs.call("gcs_ft", {}, timeout=10)
        assert ft["reconcile_actors_resurrected"] >= 1
        assert ft["reconcile_nodes_reregistered"] >= 1
        h2.kill()
    _assert_left_nothing(c)


# -- reconcile semantics on the service alone ------------------------------------------


def _mk_service(tmp_path, name="svc.snap"):
    return GcsService(node_death_timeout_s=5.0, persist_path=str(tmp_path / name))


def test_reconcile_unit_confirm_lost_and_tombstone(tmp_path):
    svc = _mk_service(tmp_path)
    svc.rpc_register_node({"node_id": "n1", "addr": ("127.0.0.1", 1),
                           "resources": {"num_cpus": 4}}, None)
    for i, name in enumerate(("kept", "gone", "dead")):
        svc.rpc_register_actor({
            "actor_id": bytes([i]) * 16, "name": name, "namespace": "default",
            "node_id": "n1", "worker_addr": ("127.0.0.1", 100 + i),
            "state": "ALIVE", "max_restarts": 0,
        }, None)
    svc.rpc_update_actor({"actor_id": b"\x02" * 16, "state": "DEAD"}, None)

    svc2 = _mk_service(tmp_path)  # restart: loads the snapshot
    assert svc2.ft["gcs_restarts_total"] == 1
    assert svc2.rpc_heartbeat({"node_id": "n1"}, None).get("reregister")
    svc2.rpc_register_node({
        "node_id": "n1", "addr": ("127.0.0.1", 1), "resources": {"num_cpus": 4},
        "actors": [
            {"actor_id": b"\x00" * 16, "name": "kept", "namespace": "default",
             "worker_addr": ("127.0.0.1", 100)},
            # a stale report of the tombstoned actor: not resurrected
            {"actor_id": b"\x02" * 16, "name": "dead", "namespace": "default",
             "worker_addr": ("127.0.0.1", 102)},
        ],
        "bundles": [], "leases": [],
    }, None)
    assert svc2._actors[b"\x00" * 16].state == "ALIVE"
    assert svc2._actors[b"\x01" * 16].state == "DEAD"  # unreported, 0 restarts
    assert svc2._actors[b"\x02" * 16].state == "DEAD"  # the tombstone wins
    assert svc2.ft["reconcile_actors_confirmed"] == 1
    assert svc2.ft["reconcile_actors_lost"] == 1
    assert svc2.ft["reconcile_nodes_reregistered"] == 1


def test_reconcile_unit_resurrects_unknown_actor(tmp_path):
    svc = _mk_service(tmp_path)
    svc.rpc_register_node({"node_id": "n1", "addr": ("127.0.0.1", 1),
                           "resources": {"num_cpus": 4}}, None)
    svc2 = _mk_service(tmp_path)
    svc2.rpc_register_node({
        "node_id": "n1", "addr": ("127.0.0.1", 1), "resources": {"num_cpus": 4},
        "actors": [{"actor_id": b"\x09" * 16, "name": "late", "namespace": "default",
                    "worker_addr": ("127.0.0.1", 109), "max_restarts": 2, "lease_id": "L1"}],
        "bundles": [], "leases": [],
    }, None)
    info = svc2.rpc_get_named_actor({"name": "late"}, None)
    assert info is not None and info["state"] == "ALIVE"
    assert info["max_restarts"] == 2
    assert svc2.ft["reconcile_actors_resurrected"] == 1


def test_reconcile_unit_adopts_bundles_and_orphans(tmp_path):
    svc = _mk_service(tmp_path)
    svc.rpc_register_node({"node_id": "n1", "addr": ("127.0.0.1", 1),
                           "resources": {"num_cpus": 8}}, None)
    pg = svc.rpc_create_pg({"pg_id": b"pg1", "bundles": [{"num_cpus": 2}]}, None)
    assert pg["state"] == "CREATED"
    svc2 = _mk_service(tmp_path)
    svc2.rpc_register_node({
        "node_id": "n1", "addr": ("127.0.0.1", 1), "resources": {"num_cpus": 8},
        "actors": [],
        "bundles": [
            {"pg_id": b"pg1", "bundle_index": 0, "resources": {"num_cpus": 2}},
            {"pg_id": b"zombie", "bundle_index": 0, "resources": {"num_cpus": 1}},
        ],
        "leases": [],
    }, None)
    assert svc2.ft["reconcile_bundles_adopted"] == 1
    assert svc2.ft["reconcile_bundles_orphaned"] == 1
    assert svc2._pgs[b"pg1"]["bundles"][0]["node_id"] == "n1"
    assert len(svc2._orphan_bundles) == 1


def test_status_renders_control_plane_block(tmp_path):
    from ray_tpu_torch.obs.telemetry import format_status

    svc = _mk_service(tmp_path)
    svc.rpc_register_node({"node_id": "n1", "addr": ("127.0.0.1", 1),
                           "resources": {"num_cpus": 1}}, None)
    svc2 = _mk_service(tmp_path)
    text = format_status(svc2.rpc_telemetry_status({}, None))
    assert "== control plane ==" in text
    assert "gcs restarts 1" in text


# -- STALL_GCS: an outage without a process death --------------------------------------


def test_stall_gcs_fires_at_gcs_call_only():
    """STALL_GCS fails every GCS-bound call in its seeded window, and the
    same seed over the same call order gives the same fault trace."""
    from ray_tpu_torch.cluster.gcs_service import GcsServer
    from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient, RpcError

    server = GcsServer(port=0)
    host, port = server.start()
    try:
        client = ReconnectingRpcClient(host, port, timeout=5).connect()
        try:
            assert client.call("list_nodes", None, timeout=5) == []
            sched = chaos.install(chaos.FaultSchedule(11, [
                chaos.FaultSpec(chaos.STALL_GCS, site="gcs.call", start_after=1, max_fires=2),
            ]))
            assert client.call("list_nodes", None, timeout=5) == []
            for _ in range(2):
                with pytest.raises(RpcError):
                    client.call("list_nodes", None, timeout=5)
            assert client.call("list_nodes", None, timeout=5) == []
            trace = sched.decisions()
            assert trace == [("stall_gcs", "gcs.call", 0)] * 2
            chaos.uninstall()

            sched2 = chaos.FaultSchedule(11, [
                chaos.FaultSpec(chaos.STALL_GCS, site="gcs.call", start_after=1, max_fires=2),
            ])
            for _ in range(4):
                sched2.fire("gcs.call", kinds=(chaos.STALL_GCS,), method="list_nodes", peer="x")
            assert sched2.decisions() == trace
        finally:
            client.close()
    finally:
        server.stop()


def test_kill_gcs_spec_validation():
    with pytest.raises(ValueError):
        chaos.FaultSpec(chaos.DROP_RPC, restart_after_s=1.0)
    spec = chaos.FaultSpec(chaos.KILL_GCS, at_s=1.0, restart_after_s=2.0)
    sched = chaos.FaultSchedule(1, [spec])
    assert sched.orchestrated() == [(0, spec)]
    assert sched.fire("gcs.call", kinds=(chaos.KILL_GCS,)) == []


def test_propagated_schedule_rides_the_ports_own_variable(monkeypatch):
    """Pinned divergence: ``install(propagate_env=True)`` exports the
    schedule in ``RAY_TPU_TORCH_CHAOS`` where the reference uses
    ``RAY_TPU_CHAOS``, so neither package's processes adopt the other's
    schedule. The wire form is the reference's: each package reads the
    other's JSON back to an equal schedule."""
    from ray_tpu import chaos as jchaos
    from ray_tpu_torch.chaos import harness

    monkeypatch.delenv("RAY_TPU_CHAOS", raising=False)
    spec = dict(site="rpc.call", match={"method": "telemetry_push"}, every_n=2)
    sched = chaos.FaultSchedule(5, [chaos.FaultSpec(chaos.DROP_RPC, **spec)])
    jsched = jchaos.FaultSchedule(5, [jchaos.FaultSpec(jchaos.DROP_RPC, **spec)])
    chaos.install(sched, propagate_env=True)
    try:
        assert chaos.ENV_VAR == "RAY_TPU_TORCH_CHAOS" and jchaos.ENV_VAR == "RAY_TPU_CHAOS"
        assert os.environ[chaos.ENV_VAR] == sched.to_wire() == jsched.to_wire()
        assert "RAY_TPU_CHAOS" not in os.environ
        harness.ACTIVE = None  # a fresh process: adopt from the environment
        adopted = chaos.install_from_env()
        assert adopted is not None and adopted.to_wire() == sched.to_wire()
        assert jchaos.FaultSchedule.from_wire(sched.to_wire()).to_wire() == sched.to_wire()
    finally:
        chaos.uninstall()
    assert chaos.ENV_VAR not in os.environ and chaos.install_from_env() is None


def test_status_payload_lacks_the_prefix_index_until_part_3c():
    """Pinned divergence: the reference's ``telemetry_status`` carries
    ``kvtier_index`` (its GCS prefix index); the port's GCS has none until
    ROADMAP.md Queue 1, item 6, part 3c, so the key is absent and
    ``format_status`` prints no index line. Every other key is the
    reference's."""
    from ray_tpu.cluster.gcs_service import GcsService as JGcsService

    ref = JGcsService().rpc_telemetry_status({}, None)
    port = GcsService().rpc_telemetry_status({}, None)
    assert set(ref) - set(port) == {"kvtier_index"}
    assert set(port) <= set(ref)
