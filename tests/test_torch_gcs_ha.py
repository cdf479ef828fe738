"""The port's control-plane high availability: warm-standby replication,
lease-based fenced failover, durability ordering, split-brain containment.

The scenarios of ``tests/test_gcs_ha.py`` but its two that read
``benchmarks/`` captures, on ``ray_tpu_torch.cluster``, to those tests'
expectations. Then the plain data against the reference, in one process:
the same writes on both packages' ``GcsService`` give equal replication
entries, and a standby of each that applies them ends with equal tables;
one term sequence gets equal fencing verdicts; the address helpers agree.
Every wait has its own deadline, and every server is stopped in
``finally``.
"""

import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import pytest

from ray_tpu.cluster import rpc as jrpc
from ray_tpu.cluster.gcs_service import GcsService as JGcsService
from ray_tpu_torch import chaos
from ray_tpu_torch.cluster.gcs_service import GcsServer, GcsService
from ray_tpu_torch.cluster.ha import StandbyGcsServer
from ray_tpu_torch.cluster.rpc import (
    NotPrimaryError,
    ReconnectingRpcClient,
    RemoteError,
    RpcClient,
    RpcError,
    RpcServer,
    StaleTermError,
    TermTracker,
    format_gcs_addr,
    parse_gcs_addr,
)
from ray_tpu_torch.core.serialization import register_pickle_by_value

pytestmark = pytest.mark.torch_port

register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    chaos.uninstall()


def _wait_for(pred, timeout=10.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# -- durability: fsync before replace -----------------------------------------


def test_write_snapshot_fsyncs_before_replace(tmp_path, monkeypatch):
    """Write the tmp file, fsync it, replace, fsync the directory."""
    calls: list = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(("fsync", fd)), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (calls.append(("replace", a)), real_replace(a, b))[1])
    svc = GcsService(node_death_timeout_s=5.0, persist_path=str(tmp_path / "gcs.snap"))
    svc.rpc_register_actor({"actor_id": "a1", "name": "durable", "node_id": "n0"}, None)
    assert os.path.exists(str(tmp_path / "gcs.snap"))
    kinds = [k for k, _ in calls]
    assert "replace" in kinds, "snapshot never installed"
    ri = kinds.index("replace")
    assert "fsync" in kinds[:ri], "tmp file not fsynced before os.replace"
    assert "fsync" in kinds[ri + 1:], "directory not fsynced after replace"


def test_fenced_service_rejects_persist(tmp_path):
    """A deposed primary installs no snapshot."""
    path = str(tmp_path / "gcs.snap")
    svc = GcsService(node_death_timeout_s=5.0, persist_path=path)
    svc.rpc_register_actor({"actor_id": "a1", "node_id": "n0"}, None)
    mtime = os.path.getmtime(path)
    verdict = svc.ha_fence(7, "register_actor")
    assert isinstance(verdict, NotPrimaryError)
    with svc._lock:
        svc._mark_dirty()
    svc.persist_critical()
    assert os.path.getmtime(path) == mtime, "fenced persist hit the disk"
    st = svc.rpc_ha_status(None, None)
    assert st["fenced"] is True
    assert st["fenced_persists_total"] >= 1
    assert st["fenced_writes_total"] >= 1


# -- gaps in the event feed and the replication log ---------------------------


def test_events_since_resync_verdict():
    svc = GcsService(node_death_timeout_s=5.0)
    svc.rpc_register_actor({"actor_id": "a1", "node_id": "n0"}, None)
    for _ in range(10001):  # past the ring's trim threshold
        svc.rpc_update_actor({"actor_id": "a1", "state": "ALIVE"}, None)
    r = svc.rpc_events_since({"cursor": 1}, None)
    assert r["resync"] is True
    assert r["events"] == []
    assert r["cursor"] > 1
    r2 = svc.rpc_events_since({"cursor": r["cursor"]}, None)
    assert r2["resync"] is False
    assert r2["events"]


def test_repl_since_resync_verdict():
    svc = GcsService(node_death_timeout_s=5.0)
    for i in range(20001):  # past the log's trim threshold
        svc.rpc_kv_put({"ns": "spam", "key": f"k{i}", "value": b"x"}, None)
    r = svc.rpc_repl_since({"cursor": 1}, None)
    assert r["resync"] is True
    snap = svc.rpc_repl_snapshot({}, None)
    r2 = svc.rpc_repl_since({"cursor": snap["cursor"]}, None)
    assert r2.get("resync") is not True


# -- the replication log: tail and apply ---------------------------------------


def _primary_writes(pri, sby, more: bool = False):
    """Pre-snapshot writes, the snapshot installed on ``sby``, then writes
    that ride the log (``more``: a kill, a removed and a new placement group
    too); returns the snapshot and the log read since it."""
    pri.rpc_register_node({"node_id": "n1", "addr": ("h", 1), "resources": {"CPU": 8.0}}, None)
    pri.rpc_register_actor({"actor_id": "a1", "name": "alpha", "node_id": "n1"}, None)
    pri.rpc_kv_put({"ns": "app", "key": "k1", "value": b"v1"}, None)
    snap = pri.rpc_repl_snapshot({}, None)
    sby.repl_install_snapshot(snap["doc"], snap["cursor"], snap["term"])
    pri.rpc_register_actor({"actor_id": "a2", "name": "beta", "node_id": "n1"}, None)
    pri.rpc_create_pg({"pg_id": "pg1", "bundles": [{"CPU": 2.0}], "strategy": "PACK"}, None)
    pri.rpc_kv_put({"ns": "app", "key": "k2", "value": b"v2"}, None)
    pri.rpc_kv_del({"ns": "app", "key": "k1"}, None)
    # ephemeral collective state does not replicate
    pri.rpc_kv_put({"ns": "__collective__", "key": "big", "value": b"x" * 64}, None)
    if more:
        pri.rpc_update_actor({"actor_id": "a2", "state": "DEAD"}, None)
        pri.rpc_remove_pg({"pg_id": "pg1"}, None)
        pri.rpc_create_pg({"pg_id": "pg2", "bundles": [{"CPU": 1.0}], "strategy": "PACK"}, None)
    return snap, pri.rpc_repl_since({"cursor": snap["cursor"]}, None)


def test_repl_tail_apply_reaches_identical_tables():
    pri = GcsService(node_death_timeout_s=5.0)
    sby = GcsService(node_death_timeout_s=5.0, role="standby")
    _snap, r = _primary_writes(pri, sby)
    assert r.get("resync") is not True
    applied = sby.repl_apply(r["entries"])
    assert applied == len(r["entries"]) > 0
    with pri._lock, sby._lock:
        assert set(sby._actors) == set(pri._actors) == {"a1", "a2"}
        assert sby._named == pri._named
        assert set(sby._pgs) == {"pg1"}
        assert sby._pgs["pg1"]["bundles"][0]["node_id"] == \
            pri._pgs["pg1"]["bundles"][0]["node_id"]
        assert sby._kv.get("app") == pri._kv.get("app") == {"k2": b"v2"}
        assert "__collective__" not in sby._kv
        # replicated nodes arrive as reconcile claims, not trusted rows
        assert sby._nodes["n1"].pending_reconcile is True


def _tables(svc) -> dict:
    with svc._lock:
        return {
            "actors": {k: svc._actor_info(a) for k, a in svc._actors.items()},
            "named": dict(svc._named),
            "pgs": {k: svc._pg_repl(pg) for k, pg in svc._pgs.items()},
            "kv": {ns: dict(kv) for ns, kv in svc._kv.items()},
            "nodes": {k: (e.addr, e.resources, e.available, e.labels, e.alive, e.draining,
                          e.pending_reconcile) for k, e in svc._nodes.items()},
            "term": svc.ha_term(),
        }


def test_replication_entries_and_applied_tables_equal_the_reference():
    """The same writes on both packages' services: equal snapshots, equal
    log entries, and standbys that apply them end with equal tables."""
    out = {}
    for name, cls in (("ref", JGcsService), ("port", GcsService)):
        pri, sby = cls(node_death_timeout_s=5.0), cls(node_death_timeout_s=5.0, role="standby")
        snap, r = _primary_writes(pri, sby, more=True)
        sby.repl_apply(r["entries"])
        doc = dict(snap["doc"], actors={k: dataclasses.asdict(a)
                                        for k, a in snap["doc"]["actors"].items()})
        out[name] = (doc, snap["cursor"], snap["term"], r["entries"], r["cursor"],
                     r["head"], _tables(sby), _tables(pri)["actors"])
    assert out["port"] == out["ref"]
    assert out["port"][3], "no log entries compared"


# -- the RPC term envelope ------------------------------------------------------


def test_rpc_client_raises_stale_term_on_low_ack():
    class OldTermHandler:
        def ha_term(self):
            return 3

        def rpc_echo(self, payload, peer):
            return payload

    server = RpcServer(OldTermHandler(), port=0)
    host, port = server.start()
    try:
        c = RpcClient(host, port, timeout=5.0).connect()
        try:
            assert c.call("echo", {"x": 1}, hterm=3) == {"x": 1}
            with pytest.raises(StaleTermError):
                c.call("echo", {"x": 2}, hterm=5)
        finally:
            c.close()
    finally:
        server.stop()


def test_gcs_fences_on_higher_term_rpc(tmp_path):
    server = GcsServer(port=0, persist_path=str(tmp_path / "gcs.snap"))
    host, port = server.start()
    try:
        c = RpcClient(host, port, timeout=5.0).connect()
        try:
            c.call("register_actor", {"actor_id": "a1", "node_id": "n0"}, hterm=0)
            with pytest.raises((NotPrimaryError, RemoteError)):
                c.call("register_actor", {"actor_id": "a2", "node_id": "n0"}, hterm=9)
            st = c.call("ha_status", {}, timeout=5.0)
            assert st["fenced"] is True
            assert st["fenced_writes_total"] >= 1
            # diagnostics stay readable on a fenced plane
            assert c.call("gcs_ft", {}, timeout=5.0)["gcs_fenced_writes_total"] >= 1
        finally:
            c.close()
    finally:
        server.stop()


def test_fencing_verdicts_equal_the_reference():
    """One sequence of (term, method) calls against each package's
    service: the same admissions, refusals and counters."""
    seq = [(0, "kv_put"), (0, "get_actor"), (2, "ha_status"), (2, "list_nodes"),
           (2, "register_actor"), (1, "kv_get"), (3, "repl_since"), (3, "create_pg"),
           (0, "telemetry_status"), (5, "telemetry_slo"), (5, "heartbeat")]
    out = {}
    for name, cls in (("ref", JGcsService), ("port", GcsService)):
        svc = cls()
        verdicts = []
        for hterm, method in seq:
            v = svc.ha_fence(hterm, method)
            verdicts.append(None if v is None else (type(v).__name__, v.term, str(v)))
        st = svc.rpc_ha_status(None, None)
        out[name] = (verdicts, {k: st[k] for k in ("role", "term", "fenced", "fenced_writes_total")})
    assert out["port"] == out["ref"]
    assert out["port"][0][4] is not None and out["port"][0][0] is None


def test_addr_helpers_roundtrip():
    assert format_gcs_addr(("h", 1)) == "h:1"
    assert format_gcs_addr((("a", 1), ("b", 2))) == "a:1,b:2"
    assert parse_gcs_addr("h:1") == ("h", 1)
    assert parse_gcs_addr("a:1,b:2") == (("a", 1), ("b", 2))
    assert parse_gcs_addr(format_gcs_addr((("a", 1), ("b", 2)))) == (("a", 1), ("b", 2))


@pytest.mark.parametrize("addr", [("h", 1), (("a", 1), ("b", 2)), [("a", 1)],
                                  (("a", 1), ("b", 2), ("c", 3))])
def test_addr_helpers_equal_the_reference(addr):
    s = jrpc.format_gcs_addr(addr)
    assert format_gcs_addr(addr) == s
    assert parse_gcs_addr(s) == jrpc.parse_gcs_addr(s)
    assert jrpc._normalize_endpoints(addr) == \
        __import__("ray_tpu_torch.cluster.rpc", fromlist=["x"])._normalize_endpoints(addr)


# -- standby promotion ----------------------------------------------------------


def test_standby_promotes_within_lease_bound():
    primary = GcsServer(port=0)
    paddr = primary.start()
    sb = StandbyGcsServer(paddr, lease_timeout_s=1.0, poll_wait_s=0.2)
    try:
        c = RpcClient(*paddr, timeout=5.0).connect()
        c.call("register_actor", {"actor_id": "a1", "name": "keep", "node_id": "n0"})
        c.call("kv_put", {"ns": "app", "key": "k", "value": b"v"})
        saddr = sb.start()
        _wait_for(lambda: sb._synced_once, msg="standby snapshot sync")
        # an unpromoted standby does not serve the data plane
        sc = RpcClient(*saddr, timeout=5.0).connect()
        with pytest.raises((NotPrimaryError, RemoteError)):
            sc.call("get_actor", {"actor_id": "a1"})
        sc.close()
        c.close()

        t0 = time.monotonic()
        primary.stop()
        assert sb.promoted.wait(timeout=5.0), "standby never promoted"
        gap = time.monotonic() - t0
        assert gap < 3.0, f"promotion took {gap:.2f}s against a 1.0s lease"

        rc = ReconnectingRpcClient(paddr, saddr, timeout=5.0).connect(retries=5)
        try:
            st = rc.call("ha_status", {})
            assert st["role"] == "primary"
            assert st["term"] >= 1
            assert st["failovers_total"] == 1
            a = rc.call("get_actor", {"actor_id": "a1"})
            assert a is not None and a["actor_id"] == "a1"
            assert rc.call("kv_get", {"ns": "app", "key": "k"}) == b"v"
            assert rc.call("gcs_ft", {})["gcs_failovers_total"] == 1
        finally:
            rc.close()
    finally:
        sb.stop()
        primary.stop()


def test_unsynced_standby_never_promotes():
    sb = StandbyGcsServer(("127.0.0.1", 1), lease_timeout_s=0.3, poll_wait_s=0.1)
    sb.start()
    try:
        assert not sb.promoted.wait(timeout=1.5)
        assert sb.service.ha_term() == 0
    finally:
        sb.stop()


# -- exactly once across a promotion ----------------------------------------------


def test_exactly_once_registrations_across_promotion():
    """The primary dies mid-burst; the client re-sends every registration
    to the promoted standby: no duplicate, no lost actor, the bundle
    deducted once."""
    primary = GcsServer(port=0)
    paddr = primary.start()
    sb = StandbyGcsServer(paddr, lease_timeout_s=0.8, poll_wait_s=0.1)
    saddr = sb.start()
    rc = ReconnectingRpcClient(paddr, saddr, timeout=3.0).connect(retries=5)
    try:
        rc.call("register_node", {"node_id": "n1", "addr": ("h", 1),
                                  "resources": {"CPU": 64.0}})
        _wait_for(lambda: sb._synced_once, msg="standby snapshot sync")
        _wait_for(lambda: "n1" in sb.service._nodes, msg="the node on the standby")
        n = 24
        for i in range(n // 2):
            rc.call("register_actor", {"actor_id": f"actor-{i}", "name": f"name-{i}",
                                       "node_id": "n1"})
        pg_first = rc.call("create_pg", {"pg_id": "pg-once", "bundles": [{"CPU": 4.0}],
                                         "strategy": "PACK"})
        assert pg_first["state"] == "CREATED"
        primary.stop()  # the kill lands mid-burst

        def retry(method, payload):
            deadline = time.monotonic() + 30
            while True:
                try:
                    return rc.call(method, payload, timeout=3.0)
                except (RpcError, RemoteError):
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)

        for i in range(n):
            r = retry("register_actor", {"actor_id": f"actor-{i}", "name": f"name-{i}",
                                         "node_id": "n1"})
            assert r.get("ok", True)
        pg_retry = retry("create_pg", {"pg_id": "pg-once", "bundles": [{"CPU": 4.0}],
                                       "strategy": "PACK"})
        assert pg_retry["state"] == "CREATED"
        assert sb.promoted.is_set()
        ids = [a["actor_id"] for a in retry("list_actors", None)]
        assert len(ids) == len(set(ids)), "duplicate actor ids after failover"
        assert set(ids) >= {f"actor-{i}" for i in range(n)}, "actors lost across failover"
        for i in range(n):
            a = retry("get_named_actor", {"name": f"name-{i}"})
            assert a is not None and a["actor_id"] == f"actor-{i}"
        nodes = {x["node_id"]: x for x in retry("list_nodes", None)}
        assert nodes["n1"]["available"]["CPU"] == 60.0, \
            f"PG bundle double-reserved: {nodes['n1']['available']}"
    finally:
        rc.close()
        sb.stop()
        primary.stop()


def test_zombie_primary_late_persist_is_fenced(tmp_path):
    path = str(tmp_path / "gcs.snap")
    primary = GcsServer(port=0, persist_path=path)
    paddr = primary.start()
    try:
        c = RpcClient(*paddr, timeout=5.0).connect()
        try:
            c.call("register_actor", {"actor_id": "a1", "node_id": "n0"})
            mtime = os.path.getmtime(path)
            with pytest.raises((NotPrimaryError, RemoteError)):
                c.call("register_actor", {"actor_id": "a2", "node_id": "n0"}, hterm=1)
            with primary.service._lock:
                primary.service._mark_dirty()
            primary.service.persist_critical()
            assert os.path.getmtime(path) == mtime, \
                "zombie primary's late persist reached the snapshot"
            st = c.call("ha_status", {})
            assert st["fenced"] is True and st["fenced_persists_total"] >= 1
        finally:
            c.close()
    finally:
        primary.stop()


# -- the split-brain window (PARTITION_GCS_PAIR) ------------------------------------


def test_partition_gcs_pair_single_term_winner():
    """Cut the pair while both live: the standby promotes behind the
    partition; at the heal the old primary is fenced by the first
    term-stamped call. One term wins; the zombie write lands nowhere."""
    from ray_tpu_torch.chaos import harness
    from ray_tpu_torch.chaos.runner import ChaosRunner

    primary = GcsServer(port=0)
    paddr = primary.start()
    sb = StandbyGcsServer(paddr, lease_timeout_s=0.6, poll_wait_s=0.1)
    saddr = sb.start()
    tracker = TermTracker()
    rc = ReconnectingRpcClient(paddr, saddr, timeout=2.0, term_tracker=tracker).connect(retries=5)
    runner = None
    try:
        rc.call("kv_put", {"ns": "app", "key": "pre", "value": b"1"})
        _wait_for(lambda: sb._synced_once, msg="standby snapshot sync")
        _wait_for(lambda: sb.service.rpc_kv_get({"ns": "app", "key": "pre"}, None) == b"1",
                  msg="the write on the standby")
        sched = chaos.FaultSchedule(23, [
            chaos.FaultSpec(chaos.PARTITION_GCS_PAIR, at_s=0.05, window_s=2.0),
        ])
        chaos.install(sched)
        runner = ChaosRunner(
            sched, cluster=SimpleNamespace(gcs_addr=paddr, standby_addr=saddr)).start()
        assert sb.promoted.wait(timeout=5.0), "standby did not promote inside the window"
        deadline = time.monotonic() + 5.0
        while tracker.current < 1:
            assert time.monotonic() < deadline, "driver never observed the bumped term"
            try:
                rc.call("ha_status", {})
            except (RpcError, RemoteError):
                pass
            time.sleep(0.05)
        rc.call("kv_put", {"ns": "app", "key": "post", "value": b"2"})
        runner.join(timeout=10)
        runner.stop()

        zc = RpcClient(*paddr, timeout=2.0).connect()
        try:
            with pytest.raises((NotPrimaryError, RemoteError)):
                zc.call("kv_put", {"ns": "app", "key": "zombie", "value": b"3"},
                        hterm=tracker.current)
            old_st = zc.call("ha_status", {})
        finally:
            zc.close()
        new_st = rc.call("ha_status", {})
        assert old_st["fenced"] is True
        assert new_st["fenced"] is False
        assert new_st["role"] == "primary"
        assert new_st["term"] > old_st["term"]
        assert old_st["fenced_writes_total"] >= 1
        assert rc.call("kv_get", {"ns": "app", "key": "pre"}) == b"1"
        assert rc.call("kv_get", {"ns": "app", "key": "post"}) == b"2"
        assert rc.call("kv_get", {"ns": "app", "key": "zombie"}) is None
        assert not harness.BLOCKED_PEERS, "partition heal leaked a block"
        assert [f.kind for f in runner.executed] == [chaos.PARTITION_GCS_PAIR]
    finally:
        if runner is not None:
            runner.stop()
        rc.close()
        sb.stop()
        primary.stop()


def test_ha_spec_validation_and_determinism():
    with pytest.raises(ValueError):
        chaos.FaultSpec(chaos.KILL_GCS_PRIMARY, restart_after_s=1.0)
    with pytest.raises(ValueError):
        chaos.FaultSpec(chaos.PARTITION_GCS_PAIR)  # no window
    with pytest.raises(ValueError):
        chaos.FaultSpec(chaos.DROP_RPC, window_s=1.0)
    kill = chaos.FaultSpec(chaos.KILL_GCS_PRIMARY, at_s=1.0)
    part = chaos.FaultSpec(chaos.PARTITION_GCS_PAIR, at_s=2.0, window_s=0.5)
    sched = chaos.FaultSchedule(1, [kill, part])
    assert sched.orchestrated() == [(0, kill), (1, part)]
    assert sched.fire("gcs.call", kinds=(chaos.KILL_GCS_PRIMARY, chaos.PARTITION_GCS_PAIR)) == []


# -- the status text --------------------------------------------------------------


def test_status_renders_ha_rows():
    from ray_tpu_torch.obs.telemetry import format_status

    text = format_status({
        "nodes": [], "pools": {},
        "gcs_ha": {"role": "primary", "term": 2, "fenced": False,
                   "failovers_total": 1, "fenced_writes_total": 3,
                   "replication_lag_s": 0.004},
    })
    assert "== control plane ==" in text
    assert "role primary" in text and "term 2" in text
    assert "failovers 1" in text and "fenced writes 3" in text
    assert "replication lag 0.004s" in text


def test_promoted_standby_stops_its_threads_and_clients():
    """Pinned divergence: the port's ``StandbyGcsServer.stop`` joins the
    tail loop and, once promoted, the serving sweeper it started, and
    closes that sweeper's client pool; the reference's only signals them
    (its sweeper's pool is never closed). After ``stop`` no thread of the
    standby is left."""
    import threading

    primary = GcsServer(port=0)
    paddr = primary.start()
    sb = StandbyGcsServer(paddr, lease_timeout_s=0.5, poll_wait_s=0.1)
    sb.start()
    try:
        _wait_for(lambda: sb._synced_once, msg="standby snapshot sync")
        primary.stop()
        assert sb.promoted.wait(timeout=5.0)
        assert sb._sweeper is not None and sb._sweeper.is_alive()
    finally:
        sb.stop()
        primary.stop()
    assert not sb._sweeper.is_alive() and not sb._tail.is_alive()
    assert sb._pool._clients == {}
    assert not [t for t in threading.enumerate()
                if t in (sb._sweeper, sb._tail)]
