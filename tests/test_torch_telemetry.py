"""The port's cluster metrics plane (``ray_tpu_torch.obs.telemetry``).

The scenarios of ``tests/test_telemetry.py`` but its two that read or write
``benchmarks/`` captures, on the port, to those tests' expectations: the
snapshot's epoch and sequence, merged-histogram percentiles against the
union of the observations, counter resets across process epochs, expiry,
tag escaping, Serve's role-tagged gauges, the SLO grades, the aggregation
rule of the metrics lint applied to the port's own registry, seeded
DROP/DELAY of ``telemetry_push``, and a GCS with two in-process node
daemons whose status text grades two pools.

Then the plain data against the reference: one seeded sequence of
snapshots (several reporters, two epochs, a stale re-send, counters,
sum/max gauges, histograms over model tags) fed to both packages' GCS
gives equal ``cluster_metrics()``, ``slo_report()``, status payloads and
``format_status`` text, once the wall-clock fields are set aside.
"""

import dataclasses
import importlib
import math
import random
import time
from bisect import bisect_right

import numpy as np
import pytest

from ray_tpu.cluster.gcs_service import GcsService as JGcsService
from ray_tpu.obs import telemetry as jtelemetry
from ray_tpu_torch.obs import telemetry
from ray_tpu_torch.obs.telemetry import (
    SLOThresholds,
    TelemetryReporter,
    TelemetryStore,
    bucket_percentile,
    bucket_percentile_band,
    evaluate_slo,
    merge_bucket_vectors,
)
from ray_tpu_torch.cluster.gcs_service import GcsService
from ray_tpu_torch.util import metrics as metrics_mod

pytestmark = pytest.mark.torch_port

BOUNDS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0]
TTFT = "ray_tpu_llm_ttft_seconds"
TPOT = "ray_tpu_llm_tpot_seconds"
QWAIT = "ray_tpu_llm_queue_wait_seconds"


def _buckets(observations):
    b = [0] * (len(BOUNDS) + 1)
    for v in observations:
        b[bisect_right(BOUNDS, v)] += 1
    return b


def _snap(seq, epoch, metrics, ts=None):
    return {"epoch": epoch, "seq": seq, "ts_monotonic": time.monotonic(),
            "ts_wall": time.time() if ts is None else ts, "metrics": metrics}


def _hist_metric(name, series, boundaries=None):
    return {
        "name": name, "type": "histogram", "description": "d",
        "tag_keys": ["model"], "boundaries": list(boundaries or BOUNDS), "agg": "merge",
        "series": [{"tags": [tag], "buckets": _buckets(obs), "sum": sum(obs),
                    "count": len(obs)} for tag, obs in series.items()],
    }


def _counter_metric(name, total, tags=()):
    return {"name": name, "type": "counter", "description": "d", "tag_keys": [],
            "agg": "sum", "series": [{"tags": list(tags), "value": total}]}


def _gauge_metric(name, value, agg="sum"):
    return {"name": name, "type": "gauge", "description": "d", "tag_keys": [], "agg": agg,
            "series": [{"tags": [], "value": value}]}


# -- the snapshot -----------------------------------------------------------------


def test_snapshot_carries_timestamp_epoch_and_seq():
    s1 = metrics_mod.snapshot_registry()
    s2 = metrics_mod.snapshot_registry()
    for s in (s1, s2):
        assert s["epoch"] == metrics_mod.PROCESS_EPOCH
        assert s["ts_monotonic"] > 0 and s["ts_wall"] > 0
    assert s2["seq"] > s1["seq"]
    assert s2["ts_monotonic"] >= s1["ts_monotonic"]


def test_annotated_snapshot_carries_aggregation_kinds():
    telemetry.cluster_gauge("llm_test_annot_gauge", "test gauge", agg=telemetry.AGG_MAX).set(1.0)
    entries = {m["name"]: m for m in telemetry.annotated_snapshot()["metrics"]}
    assert entries["ray_tpu_llm_test_annot_gauge"]["agg"] == "max"


# -- merged histograms --------------------------------------------------------------


def test_merged_histogram_percentiles_match_union_of_observations():
    rng = random.Random(1234)
    replicas = [
        [rng.uniform(0.0002, 0.004) for _ in range(300)],
        [rng.uniform(0.004, 0.09) for _ in range(120)],
        [min(rng.expovariate(2.0), 4.9) for _ in range(57)],
        [rng.uniform(0.05, 0.6) for _ in range(11)],
    ]
    store = TelemetryStore()
    for i, obs in enumerate(replicas):
        store.ingest(f"rep{i}", _snap(1, f"e{i}", [_hist_metric(TTFT, {"m": obs})]))
    merged = store.cluster_metrics()["histograms"][TTFT]["series"]["model=m"]
    union = sorted(v for obs in replicas for v in obs)
    assert merged["buckets"] == merge_bucket_vectors([_buckets(obs) for obs in replicas])
    assert merged["count"] == len(union)
    for q in (10.0, 25.0, 50.0, 75.0, 90.0, 95.0, 99.0):
        rank = max(1, math.ceil(q / 100.0 * len(union)))
        true_value = union[rank - 1]
        band = bucket_percentile_band(BOUNDS, merged["buckets"], q)
        est = bucket_percentile(BOUNDS, merged["buckets"], q)
        assert band is not None and est is not None
        lo, hi = band
        assert lo < true_value <= hi or (hi == float("inf") and true_value > lo), \
            f"p{q}: union value {true_value} outside merged bucket {band}"
        assert est == (BOUNDS[-1] if hi == float("inf") else hi)


def test_merge_rejects_boundary_mismatch():
    with pytest.raises(ValueError):
        merge_bucket_vectors([[1, 2], [1, 2, 3]])


# -- counters across epochs, re-sends and expiry ---------------------------------------

CTR = "ray_tpu_llm_restart_test_total"


def _ctr_total(store):
    return store.cluster_metrics()["counters"][CTR]["total"]


def test_counter_reset_across_restart_never_negative_or_double():
    store = TelemetryStore()
    observed = []
    for seq, epoch, total in ((1, "epoch_a", 10.0), (2, "epoch_a", 10.0), (1, "epoch_a", 7.0),
                              (1, "epoch_b", 3.0), (3, "epoch_b", 5.0), (2, "epoch_b", 4.0)):
        store.ingest("r1", _snap(seq, epoch, [_counter_metric(CTR, total)]))
        observed.append(_ctr_total(store))
    assert observed == [10.0, 10.0, 10.0, 13.0, 15.0, 15.0]
    assert store.num_ignored_stale == 2


def test_delayed_push_from_dead_epoch_never_double_counts():
    store = TelemetryStore()
    store.ingest("r1", _snap(9, "epoch_a", [_counter_metric(CTR, 10.0)]))
    store.ingest("r1", _snap(1, "epoch_b", [_counter_metric(CTR, 3.0)]))
    assert _ctr_total(store) == 13.0
    res = store.ingest("r1", _snap(8, "epoch_a", [_counter_metric(CTR, 8.0)]))
    assert res.get("ignored") == "stale_epoch"
    assert _ctr_total(store) == 13.0
    store.ingest("r1", _snap(2, "epoch_b", [_counter_metric(CTR, 5.0)]))
    assert _ctr_total(store) == 15.0
    store.ingest("r1", _snap(3, "epoch_b", [_counter_metric(CTR, 5.0)]))
    assert _ctr_total(store) == 15.0


def test_expired_reporter_series_leave_the_aggregate():
    store = TelemetryStore(expire_after_s=0.2)
    g = [_gauge_metric("ray_tpu_llm_depth_expire_test", 4.0, agg="sum")]
    store.ingest("dead-node", _snap(1, "e1", g))
    store.ingest("live-node", _snap(1, "e2", g))
    assert store.cluster_metrics()["gauges"]["ray_tpu_llm_depth_expire_test"]["value"] == 8.0
    time.sleep(0.25)
    store.ingest("live-node", _snap(2, "e2", g))
    agg = store.cluster_metrics()
    assert "dead-node" not in agg["reporters"]
    assert "dead-node" not in agg["staleness"]
    assert agg["gauges"]["ray_tpu_llm_depth_expire_test"]["value"] == 4.0
    assert store.num_expired == 1
    assert all(k[0] != "dead-node" for k in store._series)


def test_tag_values_with_separators_survive_rollups():
    store = TelemetryStore()
    tag = "llama,8b=v2"
    store.ingest("r1", _snap(1, "e1", [_hist_metric(TTFT, {tag: [0.02, 0.03, 0.04]})]))
    per_tag = store.slo_histograms()[TTFT]
    assert list(per_tag) == [tag]
    assert per_tag[tag]["count"] == 3
    assert 'model="llama,8b=v2"' in store.prometheus_text()
    skey = store._tags_key(["model"], (tag,))
    assert store._parse_tags_key(skey) == {"model": tag}
    two = store._tags_key(["a", "b"], ("x=1,y", "z\\w"))
    assert store._parse_tags_key(two) == {"a": "x=1,y", "b": "z\\w"}


def test_deleted_deployment_retracts_replica_gauges():
    from ray_tpu_torch.serve.config import DeploymentConfig, ReplicaConfig
    from ray_tpu_torch.serve.controller import ServeController, replica_gauges

    ctl = ServeController(reconcile_interval_s=0.05)
    try:
        ctl.deploy_application(
            "phantom-app", "/p", "D",
            [("D", DeploymentConfig(num_replicas=0, role="decode"),
              ReplicaConfig(callable_factory=lambda: None))],
        )
        ctl._export_replica_gauges(ctl._apps["phantom-app"].deployments["D"])
        key = ("phantom-app", "D", "decode")
        assert key in replica_gauges()["running"].series()
        ctl.delete_application("phantom-app")
        assert key not in replica_gauges()["running"].series()
        assert key not in replica_gauges()["target"].series()
    finally:
        ctl.shutdown()


def test_histogram_epoch_reset_banks_dead_epoch():
    store = TelemetryStore()
    obs_a, obs_b = [0.002, 0.02, 0.2], [0.5, 0.5]
    store.ingest("r1", _snap(1, "ea", [_hist_metric(TTFT, {"m": obs_a})]))
    store.ingest("r1", _snap(1, "eb", [_hist_metric(TTFT, {"m": obs_b})]))
    merged = store.cluster_metrics()["histograms"][TTFT]["series"]["model=m"]
    assert merged["count"] == 5
    assert merged["buckets"] == merge_bucket_vectors([_buckets(obs_a), _buckets(obs_b)])
    assert abs(merged["sum"] - (sum(obs_a) + sum(obs_b))) < 1e-9


def test_gauge_sum_and_max_rollups():
    store = TelemetryStore()
    for rid, v in (("r1", 3.0), ("r2", 5.0)):
        store.ingest(rid, _snap(1, f"e{rid}", [
            _gauge_metric("ray_tpu_llm_depth_test", v, agg="sum"),
            _gauge_metric("ray_tpu_llm_worst_test", v, agg="max"),
        ]))
    agg = store.cluster_metrics()
    assert agg["gauges"]["ray_tpu_llm_depth_test"]["value"] == 8.0
    assert agg["gauges"]["ray_tpu_llm_worst_test"]["value"] == 5.0


# -- the SLO evaluator ---------------------------------------------------------------


def _slo_hists(ttft_obs, tpot_obs, qwait_obs, tag="m"):
    def mk(obs):
        return {tag: {"boundaries": BOUNDS, "buckets": _buckets(obs), "sum": sum(obs),
                      "count": len(obs)}}

    return {TTFT: mk(ttft_obs), TPOT: mk(tpot_obs), QWAIT: mk(qwait_obs)}


def test_slo_evaluator_grades_green_yellow_red():
    th = SLOThresholds(ttft_p_s=0.1, tpot_p_s=0.01, queue_wait_p_s=0.1, yellow_factor=2.0)
    e = evaluate_slo(_slo_hists([0.002] * 50, [0.002] * 50, [0.002] * 50), th)["model_tags"]["m"]
    assert e["grade"] == "green"
    assert e["autoscaler_hints"] == {"scale_prefill": False, "scale_decode": False,
                                     "shed_or_add_capacity": False}
    e = evaluate_slo(_slo_hists([0.002] * 50, [0.4] * 50, [0.002] * 50), th)["model_tags"]["m"]
    assert e["tpot"]["grade"] == "red"
    assert e["grade"] == "red"
    assert e["autoscaler_hints"]["scale_decode"] is True
    assert e["autoscaler_hints"]["scale_prefill"] is False
    th2 = SLOThresholds(ttft_p_s=0.4, tpot_p_s=1.0, queue_wait_p_s=1.0, yellow_factor=2.0)
    e = evaluate_slo(_slo_hists([0.3] * 50, [0.002] * 50, [0.002] * 50), th2)["model_tags"]["m"]
    assert e["ttft"]["grade"] == "yellow"
    assert e["grade"] == "yellow"
    assert e["autoscaler_hints"]["scale_prefill"] is True


def test_slo_evaluator_no_data():
    assert evaluate_slo({})["model_tags"] == {}
    assert evaluate_slo(_slo_hists([], [], []))["model_tags"]["m"]["grade"] == "no_data"


# -- the aggregation rule of the metrics lint, on the port's registry --------------------

# the port's modules that register metrics, and the hook that forces their
# lazily built metrics to register (the reference's lint lists its own)
PORT_INSTRUMENTED = [
    ("ray_tpu_torch.obs.slo", "register_all"),
    ("ray_tpu_torch.obs.telemetry", "register_metrics"),
    ("ray_tpu_torch.llm.pipeline", "register_metrics"),
    ("ray_tpu_torch.llm.spec.stats", "_spec_metrics"),
    ("ray_tpu_torch.llm.admission", "register_metrics"),
    ("ray_tpu_torch.llm.engine", "register_metrics"),
    ("ray_tpu_torch.cluster.node_daemon", "register_metrics"),
    ("ray_tpu_torch.cluster.gcs_service", "register_metrics"),
    ("ray_tpu_torch.serve.controller", "replica_gauges"),
    ("ray_tpu_torch.fabric.metrics", "register_metrics"),
    ("ray_tpu_torch.llm.kvtier.metrics", "register_metrics"),
    ("ray_tpu_torch.llm.kvfetch.metrics", "register_metrics"),
    ("ray_tpu_torch.autoscale.metrics", "register_metrics"),
    ("ray_tpu_torch.fleet.metrics", "register_metrics"),
    ("ray_tpu_torch.cluster.lockstats", "register_metrics"),
]


def _port_check_aggregations() -> list:
    """The reference lint's rule over the port's registry: every gauge and
    counter under the aggregated prefixes resolves to a valid kind."""
    problems = []
    for m in metrics_mod.registry_snapshot():
        if m.TYPE == "histogram" or not m.name.startswith(telemetry.AGGREGATED_PREFIXES):
            continue
        kind = telemetry.aggregation_kind(m.name, m.TYPE)
        if kind is None:
            problems.append(f"{m.name}: telemetry-plane {m.TYPE} with no declared aggregation")
        elif kind not in telemetry.VALID_AGGREGATIONS:
            problems.append(f"{m.name}: invalid aggregation kind {kind!r}")
    return problems


def test_check_metrics_requires_aggregation_kind_for_plane_gauges():
    for mod, hook in PORT_INSTRUMENTED:
        getattr(importlib.import_module(mod), hook)()
    metrics_mod.Gauge("llm_undeclared_rollup_gauge", description="no agg kind")
    try:
        problems = _port_check_aggregations()
        assert any("llm_undeclared_rollup_gauge" in p and "aggregation" in p
                   for p in problems), problems
    finally:
        with metrics_mod._REGISTRY_LOCK:
            metrics_mod._REGISTRY.pop("ray_tpu_llm_undeclared_rollup_gauge", None)
    # the port's own metrics are clean
    assert _port_check_aggregations() == []


def test_engine_utilization_gauges_registered_with_kinds():
    from ray_tpu_torch.llm import engine as engine_mod

    engine_mod.register_metrics()
    for name in ("llm_kv_pages_used", "llm_kv_pages_total", "llm_kv_hbm_bytes",
                 "llm_queue_depth", "llm_running_requests"):
        assert telemetry.aggregation_kind(name, "gauge") == "sum"


# -- chaos: seeded DROP/DELAY of telemetry_push ------------------------------------------


def test_chaos_dropped_telemetry_pushes_cost_only_staleness():
    from ray_tpu_torch.chaos import harness
    from ray_tpu_torch.chaos.schedule import DELAY_RPC, DROP_RPC, FaultSchedule, FaultSpec
    from ray_tpu_torch.cluster.gcs_service import GcsServer

    server = GcsServer(port=0)
    addr = server.start()
    ctr = telemetry.cluster_counter("llm_chaos_ticks_total",
                                    "ground-truth ticks for the chaos test")
    reporter = TelemetryReporter(addr, reporter_id="chaos-driver", kind="engine",
                                 interval_s=60.0,
                                 series_filter=lambda n, t: n == "ray_tpu_llm_chaos_ticks_total")
    store = server.service.telemetry
    base = ctr.series().get((), 0.0)  # this process may have ticked it before

    def observed():
        acc = store.cluster_metrics()["counters"].get("ray_tpu_llm_chaos_ticks_total")
        return acc["total"] - base if acc else 0.0

    schedule = FaultSchedule(31337, [
        FaultSpec(kind=DROP_RPC, site="rpc.call", match={"method": "telemetry_push"}, every_n=2),
        FaultSpec(kind=DELAY_RPC, site="rpc.call", match={"method": "telemetry_push"}, p=0.3,
                  delay_s=0.02),
    ])
    try:
        harness.install(schedule)
        ground_truth = 0
        totals = []
        dropped_any = False
        try:
            for _ in range(10):
                ctr.inc(1)
                ground_truth += 1
                ok = reporter.push_once()
                dropped_any = dropped_any or not ok
                got = observed()
                totals.append(got)
                assert got <= ground_truth  # never double counted
            assert dropped_any, "the schedule should have dropped some pushes"
            assert any(k == DROP_RPC for k in schedule.fired_kinds())
            assert all(b >= a for a, b in zip(totals, totals[1:])), totals
            stale_during = store.staleness().get("chaos-driver")
            assert stale_during is not None and stale_during >= 0.0
        finally:
            harness.uninstall()
        time.sleep(0.25)
        spiked = store.staleness()["chaos-driver"]
        assert spiked >= 0.25
        assert reporter.push_once()
        assert observed() == float(ground_truth)
        assert store.staleness()["chaos-driver"] < spiked
        assert reporter.num_dropped >= 1 and reporter.num_ok >= 1
    finally:
        reporter.stop(final_push=False)
        server.stop()


def test_chaos_determinism_same_seed_same_drops():
    from ray_tpu_torch.chaos.schedule import DROP_RPC, FaultSchedule, FaultSpec

    def run(seed):
        sched = FaultSchedule(seed, [FaultSpec(kind=DROP_RPC, site="rpc.call",
                                               match={"method": "telemetry_push"}, p=0.5)])
        return [bool(sched.fire("rpc.call", kinds=(DROP_RPC,), method="telemetry_push",
                                peer="x")) for _ in range(20)]

    assert run(99) == run(99)


# -- two nodes and two pools, graded from the GCS's aggregation -----------------------


def test_status_two_nodes_two_pools_end_to_end():
    """An in-process GCS, two in-process node daemons (their heartbeats
    carry the node gauges) and a driver reporter carrying two role-tagged
    pools' SLO histograms: the one-query status grades each pool from the
    GCS's aggregation alone."""
    from ray_tpu_torch.cluster.gcs_service import GcsServer
    from ray_tpu_torch.cluster.node_daemon import NodeDaemon
    from ray_tpu_torch.cluster.rpc import RpcClient
    from ray_tpu_torch.obs import slo as slo_mod
    from ray_tpu_torch.serve.controller import replica_gauges

    server = GcsServer(port=0)
    addr = server.start()
    daemons = []
    reporter = None
    try:
        for i in range(2):
            d = NodeDaemon(addr, {"num_cpus": 1}, node_id=f"telem-n{i}",
                           heartbeat_interval_s=0.1, telemetry_interval_s=0.15,
                           memory_monitor_interval_s=0)
            d.start()
            daemons.append(d)
        for _ in range(20):
            slo_mod.record_request_slo("status-prefill-pool", ttft_s=0.003, tpot_s=0.002,
                                       queue_wait_s=0.001, e2e_s=0.05, finish_reason="stop")
            slo_mod.record_request_slo("status-decode-pool", ttft_s=0.003, tpot_s=3.0,
                                       queue_wait_s=0.001, e2e_s=3.0, finish_reason="stop")
        g = replica_gauges()
        for role, dep in (("prefill", "PrefillPool"), ("decode", "DecodePool")):
            tags = {"app": "llm", "deployment": dep, "role": role}
            g["running"].set(2, tags=tags)
            g["target"].set(2, tags=tags)
        reporter = TelemetryReporter(addr, reporter_id="status-driver", kind="engine",
                                     series_filter=lambda n, t: not n.startswith("ray_tpu_node_"))
        assert reporter.push_once()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            reps = server.service.telemetry.cluster_metrics()["reporters"]
            if "telem-n0" in reps and "telem-n1" in reps:
                break
            time.sleep(0.05)
        reps = server.service.telemetry.cluster_metrics()["reporters"]
        assert "telem-n0" in reps and "telem-n1" in reps, reps
        assert reps["telem-n0"]["kind"] == "node"
        agg = server.service.telemetry.cluster_metrics()
        workers = agg["gauges"].get("ray_tpu_node_workers", {"series": {}})
        assert set(workers["series"]) >= {"node=telem-n0", "node=telem-n1"}
        c = RpcClient(*addr, timeout=10.0).connect(retries=2)
        try:
            text = telemetry.format_status(c.call("telemetry_status", {}, timeout=10.0))
        finally:
            c.close()
        assert "telem-n0" in text and "telem-n1" in text
        assert "role=prefill" in text and "role=decode" in text
        assert "status-prefill-pool" in text and "status-decode-pool" in text
        p_line = next(ln for ln in text.splitlines() if "status-prefill-pool" in ln)
        d_line = next(ln for ln in text.splitlines() if "status-decode-pool" in ln)
        assert "GREEN" in p_line, text
        assert "RED" in d_line, text
    finally:
        if reporter is not None:
            reporter.stop(final_push=False)
        for d in daemons:
            d.stop()
        server.stop()


# -- the store's aggregates against the reference --------------------------------------


def _seeded_pushes(seed: int) -> list:
    """(reporter_id, snapshot, meta) in push order: three reporters, one of
    them restarting (a new epoch), one stale re-send, counters, sum and max
    gauges, and TTFT/TPOT/queue-wait histograms over two model tags."""
    rng = np.random.default_rng(seed)
    out = []
    totals: dict = {}
    for step in range(6):
        for r in range(3):
            rid = f"rep{r}"
            epoch = "e1" if not (r == 2 and step >= 3) else "e2"
            if r == 2 and step == 3:
                totals[rid] = 0.0  # the restarted process counts from zero
            totals[rid] = totals.get(rid, 0.0) + float(rng.integers(1, 9))
            hists = []
            for name, scale in ((TTFT, 0.05), (TPOT, 0.01), (QWAIT, 0.02)):
                series = {tag: list(rng.exponential(scale, size=int(rng.integers(1, 6)) + step))
                          for tag in ("m-a", "m-b")}
                hists.append(_hist_metric(name, series))
            metrics = [_counter_metric("ray_tpu_llm_kv_transfer_bytes_total", totals[rid]),
                       _gauge_metric("ray_tpu_llm_queue_depth", float(rng.integers(0, 7))),
                       _gauge_metric("ray_tpu_llm_worst_seen", float(rng.random()), agg="max")]
            seq = step + 1 if epoch == "e1" else step - 2
            out.append((rid, _snap(seq, epoch, metrics + hists, ts=1000.0 + step),
                        {"kind": "engine", "role": ("prefill", "decode", "")[r]}))
    out.append(("rep0", _snap(2, "e1", [_counter_metric(
        "ray_tpu_llm_kv_transfer_bytes_total", 1.0)], ts=999.0), {"kind": "engine"}))
    return out


def _timeless(x):
    """The aggregate with its wall-clock fields (push times, staleness,
    windowed rates, measured at arrival) set to a constant."""
    if isinstance(x, dict):
        return {k: ({r: 0.0 for r in v} if k in ("staleness", "rate_per_s") and isinstance(v, dict)
                    else 0.0 if k in ("ts_wall", "last_push_wall", "staleness_s",
                                      "kv_transfer_bytes_per_s")
                    else _timeless(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [_timeless(v) for v in x]
    return x


def test_store_aggregates_slo_and_status_equal_the_reference():
    th = {"ttft_p_s": 0.08, "tpot_p_s": 0.02, "queue_wait_p_s": 0.03}
    out = {}
    for name, cls, tmod in (("ref", JGcsService, jtelemetry), ("port", GcsService, telemetry)):
        gcs = cls()
        for nid in ("n0", "n1"):
            gcs.rpc_register_node({"node_id": nid, "addr": ("h", 1),
                                   "resources": {"num_cpus": 2.0}}, None)
        for rid, snap, meta in _seeded_pushes(5):
            gcs.rpc_telemetry_push({"reporter_id": rid, "snapshot": snap, **meta}, None)
        gcs.rpc_heartbeat({"node_id": "n0", "telemetry": _snap(1, "d0", [
            _gauge_metric("ray_tpu_node_workers", 3.0)], ts=1000.0)}, None)
        gcs.rpc_heartbeat_batch({"heartbeats": [{"node_id": "n1", "telemetry": _snap(
            1, "d1", [_gauge_metric("ray_tpu_node_workers", 2.0)], ts=1000.0)}]}, None)
        gcs.rpc_kvtier_update({"engine": "e0", "epoch": 1, "seq": 1,
                               "rows": [[11, 0, 16], [12, 1, 32]]}, None)
        status = _timeless(gcs.rpc_telemetry_status({"thresholds": th}, None))
        out[name] = {
            "cluster": _timeless(gcs.telemetry.cluster_metrics()),
            "slo": _timeless(gcs.rpc_telemetry_slo({"thresholds": th}, None)),
            "status": status,
            "text": tmod.format_status(status),
            "prometheus": [ln for ln in gcs.rpc_telemetry_prometheus(None, None).splitlines()
                           if "staleness" not in ln],
        }
    for key in ("cluster", "slo", "status", "text", "prometheus"):
        assert out["port"][key] == out["ref"][key], key
    assert out["port"]["cluster"]["ignored_stale"] == 1
    assert out["port"]["slo"]["model_tags"].keys() == {"m-a", "m-b"}
    assert "m-a" in out["port"]["text"] and "m-b" in out["port"]["text"]


def test_slo_thresholds_round_trip_equals_the_reference():
    th = SLOThresholds(ttft_p_s=0.3, percentile=90.0)
    assert th.to_dict() == dataclasses.asdict(jtelemetry.SLOThresholds(ttft_p_s=0.3,
                                                                       percentile=90.0))
    assert SLOThresholds.from_dict({**th.to_dict(), "bogus": 1}) == th
