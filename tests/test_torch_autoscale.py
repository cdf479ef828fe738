"""The pool autoscaler's closed loop on both packages (``ray_tpu.autoscale``
against ``ray_tpu_torch.autoscale``).

The 34 scenarios of ``tests/test_autoscale.py`` but its two capture gates
(which read the JAX package's captured files under ``benchmarks/``), each run
on both packages with the same inputs and held to that file's expectations
on each. Then the two runs must agree: every decision (action, target,
reason), the decision logs, ``status()``, the actuators' counters and the
``ray_tpu_autoscale_*`` series each package's registry recorded. Each
scenario runs against a fresh registry per package (the module's registry
dict swapped for the scenario and put back after, so the reference's cached
metric objects elsewhere in the process are untouched). The STALL_GCS
scenario runs each package over its own ``GcsServer``, with the same seeded
schedule installed in each package's own chaos harness.

The reference's ``rpc_batch`` scenario has no ``batch`` frame to call on the
port (no client of either package sends one, so the port has none): its ops
go to the port's GCS one by one and their answers must equal the answers of
the reference's batch.
"""

import types

import pytest

pytestmark = [pytest.mark.torch_port, pytest.mark.autoscale]


def _pkg(name: str) -> types.SimpleNamespace:
    """One package's surface under one set of names."""
    import importlib

    root = "ray_tpu" if name == "ref" else "ray_tpu_torch"

    def mod(rel):
        return importlib.import_module(f"{root}.{rel}")

    return types.SimpleNamespace(
        name=name,
        A=mod("autoscale"),
        metrics=mod("autoscale.metrics"),
        policy=mod("autoscale.policy"),
        chaos=mod("chaos"),
        harness=mod("chaos.harness"),
        reg=mod("util.metrics"),
        telemetry=mod("obs.telemetry"),
        slo=mod("obs.slo"),
        gcs=mod("cluster.gcs_service"),
        rpc=mod("cluster.rpc"),
    )


PKGS = {"ref": _pkg("ref"), "port": _pkg("port")}


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    for P in PKGS.values():
        P.chaos.uninstall()


def _cfg(P, **kw):
    A = P.A
    kw.setdefault("pools", {
        A.POOL_PREFILL: A.PoolLimits(min_replicas=0, max_replicas=4),
        A.POOL_DECODE: A.PoolLimits(min_replicas=0, max_replicas=4),
    })
    kw.setdefault("breach_ticks", 2)
    kw.setdefault("green_ticks", 3)
    kw.setdefault("scale_up_cooldown_s", 0.0)
    kw.setdefault("scale_down_cooldown_s", 0.0)
    kw.setdefault("idle_to_zero_s", 10.0)
    return A.AutoscaleConfig(**kw)


def _d(d) -> tuple:
    """A decision as plain data."""
    return (d.pool, d.action, d.target, d.reason)


def _series(P) -> dict:
    """Every ``ray_tpu_autoscale_*`` series of the package's registry:
    {(name, tags): value} (histograms as (buckets, sum, count))."""
    out = {}
    for m in P.reg.snapshot_registry()["metrics"]:
        if not m["name"].startswith("ray_tpu_autoscale_"):
            continue
        for s in m.get("series", ()):
            key = (m["name"], tuple(s["tags"]))
            out[key] = (tuple(s["buckets"]), s["sum"], s["count"]) if "buckets" in s \
                else s["value"]
    return out


def _run(scenario) -> dict:
    """The scenario on each package against a fresh registry; returns
    {"ref": record, "port": record} after asserting they agree."""
    out = {}
    for name, P in PKGS.items():
        saved = P.reg._REGISTRY
        P.reg._REGISTRY = {}
        try:
            rec = scenario(P)
            series = _series(P)
        finally:
            P.reg._REGISTRY = saved
            P.chaos.uninstall()
        out[name] = {"record": rec, "series": series}
    assert out["port"] == out["ref"]
    return out


# ---------------------------------------------------------------------------
# hint -> pool mapping
# ---------------------------------------------------------------------------


def _slo_entry(ttft="green", tpot="green", qw="green"):
    def _hint(g):
        return g in ("yellow", "red")

    return {
        "ttft": {"grade": ttft},
        "tpot": {"grade": tpot},
        "queue_wait": {"grade": qw},
        "autoscaler_hints": {
            "scale_prefill": _hint(ttft),
            "scale_decode": _hint(tpot),
            "shed_or_add_capacity": _hint(qw),
        },
    }


def _payload(ttft="green", tpot="green", qw="green", **kw):
    out = {
        "staleness": {"n1": 0.01},
        "slo": {"model_tags": {"m": _slo_entry(ttft, tpot, qw)}},
        "pools": {},
        "utilization": {"queue_depth": kw.pop("queue_depth", 0.0)},
        "prefill_span": {
            "mean_s": kw.pop("span_mean_s", None),
            "arrival_rate_per_s": kw.pop("arrival", 0.0),
        },
        "pending_demand": kw.pop("pending_demand", 0),
    }
    out.update(kw)
    return out


def _sigs(sigs) -> dict:
    import dataclasses

    return {k: dataclasses.asdict(v) for k, v in sigs.items()}


def test_hint_mapping_ttft_prices_prefill():
    def scenario(P):
        A = P.A
        sigs = A.signals_from_payload(_payload(ttft="red"))
        assert sigs[A.POOL_PREFILL].breach is True
        assert sigs[A.POOL_PREFILL].grade == "red"
        assert sigs[A.POOL_DECODE].breach is False
        return _sigs(sigs)

    _run(scenario)


def test_hint_mapping_tpot_and_queue_wait_price_decode():
    def scenario(P):
        A = P.A
        out = []
        for kw in ({"tpot": "yellow"}, {"qw": "red"}):
            sigs = A.signals_from_payload(_payload(**kw))
            assert sigs[A.POOL_DECODE].breach is True, kw
            assert sigs[A.POOL_PREFILL].breach is False, kw
            out.append(_sigs(sigs))
        return out

    _run(scenario)


def test_hint_mapping_worst_grade_across_tags_wins():
    def scenario(P):
        A = P.A
        p = _payload()
        p["slo"]["model_tags"]["m2"] = _slo_entry(ttft="yellow", tpot="red")
        sigs = A.signals_from_payload(p)
        assert sigs[A.POOL_PREFILL].grade == "yellow"
        assert sigs[A.POOL_PREFILL].breach is True
        assert sigs[A.POOL_DECODE].grade == "red"
        return _sigs(sigs)

    _run(scenario)


def test_span_and_demand_ride_the_signals():
    def scenario(P):
        A = P.A
        p = _payload(span_mean_s=0.5, arrival=2.0, pending_demand=3, queue_depth=7.0)
        sigs = A.signals_from_payload(p)
        assert sigs[A.POOL_PREFILL].span_mean_s == 0.5
        assert sigs[A.POOL_DECODE].span_mean_s is None
        for s in sigs.values():
            assert s.arrival_rate_per_s == 2.0
            assert s.pending_demand == 3
            assert s.queue_depth == 7.0
            assert s.has_traffic
        return _sigs(sigs)

    _run(scenario)


# ---------------------------------------------------------------------------
# hysteresis / cooldown windows
# ---------------------------------------------------------------------------


def test_breach_streak_gates_scale_up():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P))
        sig = A.PoolSignals(grade="yellow", breach=True, running=1, target=1,
                            arrival_rate_per_s=1.0)
        d1 = pol.decide(A.POOL_DECODE, sig, now=0.0)
        assert d1.action == A.ACTION_HOLD and "1/2" in d1.reason
        d2 = pol.decide(A.POOL_DECODE, A.PoolSignals(grade="green", running=1, target=1,
                                                     arrival_rate_per_s=1.0), now=1.0)
        assert d2.action == A.ACTION_HOLD
        d3 = pol.decide(A.POOL_DECODE, sig, now=2.0)
        assert d3.action == A.ACTION_HOLD
        d4 = pol.decide(A.POOL_DECODE, sig, now=3.0)
        assert d4.action == A.ACTION_SCALE_UP and d4.target == 2
        return [_d(d) for d in (d1, d2, d3, d4)]

    _run(scenario)


def test_scale_up_cooldown_spaces_actions():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P, scale_up_cooldown_s=5.0))
        sig = A.PoolSignals(grade="red", breach=True, running=1, target=1,
                            arrival_rate_per_s=1.0)
        ds = [pol.decide(A.POOL_DECODE, sig, now=0.0)]
        assert ds[-1].action == A.ACTION_HOLD
        ds.append(pol.decide(A.POOL_DECODE, sig, now=1.0))
        assert ds[-1].action == A.ACTION_SCALE_UP
        sig2 = A.PoolSignals(grade="red", breach=True, running=2, target=2,
                             arrival_rate_per_s=1.0)
        ds.append(pol.decide(A.POOL_DECODE, sig2, now=2.0))
        ds.append(pol.decide(A.POOL_DECODE, sig2, now=3.0))
        assert ds[-1].action == A.ACTION_HOLD and "cooldown" in ds[-1].reason
        ds.append(pol.decide(A.POOL_DECODE, sig2, now=6.5))
        assert ds[-1].action == A.ACTION_SCALE_UP and ds[-1].target == 3
        return [_d(d) for d in ds]

    _run(scenario)


def test_green_streak_gates_scale_down_and_respects_floor():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P, green_ticks=3))
        sig = A.PoolSignals(grade="green", running=3, target=3, arrival_rate_per_s=1.0)
        ds = [pol.decide(A.POOL_DECODE, sig, now=0.0), pol.decide(A.POOL_DECODE, sig, now=1.0)]
        assert all(d.action == A.ACTION_HOLD for d in ds)
        ds.append(pol.decide(A.POOL_DECODE, sig, now=2.0))
        assert ds[-1].action == A.ACTION_SCALE_DOWN and ds[-1].target == 2
        sig1 = A.PoolSignals(grade="green", running=1, target=1, arrival_rate_per_s=1.0)
        for t in range(3, 9):
            ds.append(pol.decide(A.POOL_DECODE, sig1, now=float(t)))
            assert ds[-1].action == A.ACTION_HOLD
        return [_d(d) for d in ds]

    _run(scenario)


def test_min_replicas_floor_blocks_scale_down():
    def scenario(P):
        A = P.A
        cfg = _cfg(P, pools={A.POOL_DECODE: A.PoolLimits(min_replicas=2, max_replicas=4)},
                   green_ticks=1)
        d = A.PoolPolicy(cfg).decide(A.POOL_DECODE,
                                     A.PoolSignals(grade="green", running=2, target=2), now=0.0)
        assert d.action == A.ACTION_HOLD
        return _d(d)

    _run(scenario)


def test_config_validation_errors_match():
    """The same bounds refused with the same messages (the reference's
    ``PoolLimits`` / ``AutoscaleConfig`` ``__post_init__``)."""
    bad = [("limits", {"min_replicas": -1}), ("limits", {"min_replicas": 3, "max_replicas": 2}),
           ("limits", {"min_replicas": 0, "max_replicas": 0}), ("cfg", {"breach_ticks": 0}),
           ("cfg", {"green_ticks": 0}), ("cfg", {"prefill_target_utilization": 0.0}),
           ("cfg", {"prefill_target_utilization": 1.5}), ("cfg", {"max_step": 0})]

    def scenario(P):
        A = P.A
        msgs = []
        for kind, kw in bad:
            with pytest.raises(ValueError) as ei:
                (A.PoolLimits if kind == "limits" else A.AutoscaleConfig)(**kw)
            msgs.append(str(ei.value))
        cfg = A.AutoscaleConfig()
        return msgs, (cfg.limits("nope").max_replicas, sorted(cfg.pools))

    _run(scenario)


# ---------------------------------------------------------------------------
# prefill sizing from the measured span distribution
# ---------------------------------------------------------------------------


def test_size_prefill_pool_littles_law():
    def scenario(P):
        A = P.A
        got = [A.size_prefill_pool(4.0, 0.9, 0.6), A.size_prefill_pool(4.0, 0.9, 0.6, 4),
               A.size_prefill_pool(0.1, 0.1, 0.6), A.size_prefill_pool(0.0, 0.9, 0.6),
               A.size_prefill_pool(4.0, None, 0.6)]
        assert got == [6, 4, 1, None, None]
        return got

    _run(scenario)


def test_span_mean_from_histogram():
    def scenario(P):
        A = P.A
        got = [A.span_mean_from_histogram({"sum": 4.5, "count": 9}),
               A.span_mean_from_histogram({"sum": 0.0, "count": 0}),
               A.span_mean_from_histogram(None)]
        assert got == [0.5, None, None]
        return got

    _run(scenario)


def test_prefill_scale_up_jumps_to_sized_target():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P))
        sig = A.PoolSignals(grade="red", breach=True, running=1, target=1,
                            arrival_rate_per_s=2.0, span_mean_s=0.9)
        d0 = pol.decide(A.POOL_PREFILL, sig, now=0.0)
        d = pol.decide(A.POOL_PREFILL, sig, now=1.0)
        assert d.action == A.ACTION_SCALE_UP and d.target == 3
        return [_d(d0), _d(d)]

    _run(scenario)


def test_prefill_feedforward_scales_to_sized_without_breach():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P))
        sig = A.PoolSignals(grade="green", running=1, target=1,
                            arrival_rate_per_s=4.0, span_mean_s=0.9)
        d1 = pol.decide(A.POOL_PREFILL, sig, now=0.0)
        assert d1.action == A.ACTION_HOLD
        d2 = pol.decide(A.POOL_PREFILL, sig, now=1.0)
        assert d2.action == A.ACTION_SCALE_UP and d2.target == 4
        assert "feedforward" in d2.reason
        return [_d(d1), _d(d2)]

    _run(scenario)


def test_prefill_sized_floor_blocks_over_drain():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P, green_ticks=1))
        sig = A.PoolSignals(grade="green", running=3, target=3,
                            arrival_rate_per_s=2.0, span_mean_s=0.9)
        d = pol.decide(A.POOL_PREFILL, sig, now=0.0)
        assert d.action == A.ACTION_HOLD
        return _d(d)

    _run(scenario)


# ---------------------------------------------------------------------------
# scale-to-zero eligibility + cold start
# ---------------------------------------------------------------------------


def test_scale_to_zero_requires_idle_window():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P, idle_to_zero_s=10.0))
        idle = A.PoolSignals(grade="no_data", running=1, target=1)
        ds = [pol.decide(A.POOL_PREFILL, idle, now=t) for t in (0.0, 5.0, 10.0)]
        assert [d.action for d in ds[:2]] == [A.ACTION_HOLD] * 2
        assert ds[2].action == A.ACTION_SCALE_TO_ZERO and ds[2].target == 0
        return [_d(d) for d in ds]

    _run(scenario)


def test_traffic_resets_idle_clock():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P, idle_to_zero_s=10.0))
        idle = A.PoolSignals(grade="no_data", running=1, target=1)
        busy = A.PoolSignals(grade="no_data", running=1, target=1, queue_depth=2.0)
        ds = [pol.decide(A.POOL_PREFILL, idle, now=0.0),
              pol.decide(A.POOL_PREFILL, busy, now=9.0),
              pol.decide(A.POOL_PREFILL, idle, now=12.0)]
        assert ds[-1].action == A.ACTION_HOLD
        ds.append(pol.decide(A.POOL_PREFILL, idle, now=22.0))
        assert ds[-1].action == A.ACTION_SCALE_TO_ZERO
        return [_d(d) for d in ds]

    _run(scenario)


def test_nonzero_min_never_scales_to_zero():
    def scenario(P):
        A = P.A
        cfg = _cfg(P, pools={A.POOL_DECODE: A.PoolLimits(min_replicas=1, max_replicas=4)},
                   idle_to_zero_s=1.0)
        pol = A.PoolPolicy(cfg)
        idle = A.PoolSignals(grade="no_data", running=1, target=1)
        ds = [pol.decide(A.POOL_DECODE, idle, now=float(t)) for t in range(0, 20, 2)]
        assert all(d.action == A.ACTION_HOLD for d in ds)
        return [_d(d) for d in ds]

    _run(scenario)


def test_cold_start_fires_on_traffic_at_zero():
    def scenario(P):
        A = P.A
        d = A.PoolPolicy(_cfg(P)).decide(
            A.POOL_PREFILL, A.PoolSignals(running=0, target=0, queue_depth=1.0), now=0.0)
        assert d.action == A.ACTION_COLD_START and d.target == 1
        d2 = A.PoolPolicy(_cfg(P)).decide(
            A.POOL_PREFILL,
            A.PoolSignals(running=0, target=0, arrival_rate_per_s=2.0, span_mean_s=0.9),
            now=0.0)
        assert d2.action == A.ACTION_COLD_START and d2.target == 3
        return [_d(d), _d(d2)]

    _run(scenario)


def test_pending_demand_counts_as_traffic():
    def scenario(P):
        A = P.A
        d = A.PoolPolicy(_cfg(P)).decide(
            A.POOL_DECODE, A.PoolSignals(running=0, target=0, pending_demand=2), now=0.0)
        assert d.action == A.ACTION_COLD_START
        return _d(d)

    _run(scenario)


# ---------------------------------------------------------------------------
# dark GCS: blackout is never evidence
# ---------------------------------------------------------------------------


def test_gcs_dark_holds_and_resets_streaks():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P))
        breach = A.PoolSignals(grade="red", breach=True, running=1, target=1,
                               arrival_rate_per_s=1.0)
        ds = [pol.decide(A.POOL_DECODE, breach, now=0.0),
              pol.decide(A.POOL_DECODE, breach, now=1.0, gcs_dark=True)]
        assert ds[1].action == A.ACTION_HOLD and "gcs-dark" in ds[1].reason
        ds.append(pol.decide(A.POOL_DECODE, breach, now=2.0))
        assert ds[-1].action == A.ACTION_HOLD
        ds.append(pol.decide(A.POOL_DECODE, breach, now=3.0))
        assert ds[-1].action == A.ACTION_SCALE_UP
        return [_d(d) for d in ds]

    _run(scenario)


def test_gcs_dark_freezes_idle_clock():
    def scenario(P):
        A = P.A
        pol = A.PoolPolicy(_cfg(P, idle_to_zero_s=5.0))
        idle = A.PoolSignals(grade="no_data", running=1, target=1)
        ds = [pol.decide(A.POOL_PREFILL, idle, now=0.0),
              pol.decide(A.POOL_PREFILL, idle, now=4.0, gcs_dark=True),
              pol.decide(A.POOL_PREFILL, idle, now=6.0)]
        assert ds[-1].action == A.ACTION_HOLD
        ds.append(pol.decide(A.POOL_PREFILL, idle, now=11.5))
        assert ds[-1].action == A.ACTION_SCALE_TO_ZERO
        return [_d(d) for d in ds]

    _run(scenario)


# ---------------------------------------------------------------------------
# controller: signals -> decisions -> actuator
# ---------------------------------------------------------------------------


class RecordingActuator:
    def __init__(self, state=None):
        self.applied = []
        self.state = state if state is not None else {}

    def apply(self, decision):
        self.applied.append(decision)

    def pool_state(self):
        return self.state


def _both_one(P):
    return {P.A.POOL_PREFILL: {"replicas_running": 1, "replicas_target": 1},
            P.A.POOL_DECODE: {"replicas_running": 1, "replicas_target": 1}}


def _controller_record(auto, act, ticks) -> dict:
    return {"ticks": [{p: _d(d) for p, d in t.items()} for t in ticks],
            "log": auto.decision_log(), "status": auto.status(),
            "applied": [_d(d) for d in act.applied],
            "counts": (auto.num_ticks, auto.num_dark_ticks, auto.num_scale_actions,
                       auto.gcs_dark)}


def test_controller_tick_scales_prefill_independently():
    def scenario(P):
        A = P.A
        act = RecordingActuator(_both_one(P))
        auto = A.PoolAutoscaler(_cfg(P), act,
                                fetch_signals=lambda: _payload(ttft="red", arrival=1.0))
        ticks = [auto.tick(now=0.0), auto.tick(now=1.0)]
        d = ticks[-1]
        assert d[A.POOL_PREFILL].action == A.ACTION_SCALE_UP
        assert d[A.POOL_DECODE].action == A.ACTION_HOLD
        assert [a.pool for a in act.applied] == [A.POOL_PREFILL]
        assert auto.num_scale_actions == 1
        return _controller_record(auto, act, ticks)

    _run(scenario)


def test_controller_fetch_failure_degrades_to_hold():
    def boom():
        raise ConnectionError("gcs is gone")

    def scenario(P):
        A = P.A
        act = RecordingActuator()
        auto = A.PoolAutoscaler(_cfg(P), act, fetch_signals=boom)
        d = auto.tick(now=0.0)
        assert all(x.action == A.ACTION_HOLD for x in d.values())
        assert all("gcs-dark" in x.reason for x in d.values())
        assert auto.gcs_dark and auto.num_dark_ticks == 1
        assert act.applied == []
        return _controller_record(auto, act, [d])

    _run(scenario)


def test_controller_stale_signals_are_dark():
    def scenario(P):
        A = P.A
        p = _payload(ttft="red")
        p["staleness"] = {"n1": 99.0, "n2": 120.0}
        act = RecordingActuator()
        auto = A.PoolAutoscaler(_cfg(P, max_signal_age_s=30.0), act, fetch_signals=lambda: p)
        ticks = [auto.tick(now=0.0)]
        assert all(x.action == A.ACTION_HOLD for x in ticks[0].values())
        assert auto.gcs_dark
        p["staleness"]["n1"] = 0.5
        ticks.append(auto.tick(now=1.0))
        assert not auto.gcs_dark
        return _controller_record(auto, act, ticks)

    _run(scenario)


def test_controller_decision_log_and_status():
    def scenario(P):
        A = P.A
        act = RecordingActuator()
        auto = A.PoolAutoscaler(_cfg(P), act, fetch_signals=lambda: _payload())
        ticks = [auto.tick(now=0.0)]
        log = auto.decision_log()
        assert len(log) == 2 and {e["pool"] for e in log} == {A.POOL_PREFILL, A.POOL_DECODE}
        st = auto.status()
        assert st["num_ticks"] == 1 and st["num_scale_actions"] == 0
        return _controller_record(auto, act, ticks)

    _run(scenario)


def test_controller_loop_thread_runs_and_stop_joins():
    """``start()`` runs ``tick`` on a named daemon thread at
    ``interval_s``; ``stop()`` joins it within its bound. Tick times are
    wall clock here, so the records compare the decision sequence (one
    scale-up, then holds), not the times."""
    import threading
    import time

    def scenario(P):
        A = P.A
        act = RecordingActuator(_both_one(P))
        auto = A.PoolAutoscaler(_cfg(P, interval_s=0.02), act,
                                fetch_signals=lambda: _payload(ttft="red", arrival=1.0))
        assert auto.start() is auto
        deadline = time.monotonic() + 30
        while auto.num_ticks < 4:
            assert time.monotonic() < deadline, "the loop never ticked 4 times"
            time.sleep(0.01)
        loop = auto._thread
        assert loop.daemon and loop.name.endswith("-pool-autoscaler")
        t0 = time.monotonic()
        auto.stop()
        assert time.monotonic() - t0 < 6.0
        assert auto._thread is None and not loop.is_alive()
        assert loop not in threading.enumerate()
        first = [(e["pool"], e["action"], e["target"]) for e in auto.decision_log()[:4]]
        assert first[2] == (A.POOL_PREFILL, A.ACTION_SCALE_UP, 2)
        return first, [_d(d) for d in act.applied][:1]

    _run(scenario)


# ---------------------------------------------------------------------------
# actuators: graceful drain, re-target, zero lost
# ---------------------------------------------------------------------------


class FakeReplica:
    """A replica for drain tests: holds queued items, completes them on a
    graceful drain, surrenders them when dead. Named by its pool and its
    spawn order, so a seeded ``pick`` (which sorts by ``str``) chooses the
    same replica on both packages."""

    def __init__(self, name):
        self.name = name
        self.items = []
        self.done = []
        self.dead = False
        self.closed = False
        self.on_drain = None

    def submit(self, item):
        if self.dead or self.closed:
            raise RuntimeError(f"{self.name} is dead")
        self.items.append(item)

    def pending(self):
        left, self.items = self.items, []
        return left

    def drain(self, timeout_s):
        if self.on_drain is not None:
            cb, self.on_drain = self.on_drain, None
            cb(self)
        if self.dead:
            return self.pending()
        self.done.extend(self.items)
        self.items = []
        return []

    def kill(self):
        self.dead = True

    def close(self):
        self.closed = True

    def __repr__(self):
        return f"FakeReplica({self.name})"


def _spawner():
    """``spawn`` for an actuator: replicas named ``<pool>-<n>``."""
    import itertools

    n = itertools.count()
    return lambda pool: FakeReplica(f"{pool}-{next(n)}")


def _grow(P, act, pool, n):
    act.apply(P.A.Decision(pool, P.A.ACTION_SCALE_UP, target=n))
    return act.replicas(pool)


def _act_record(act, reps) -> dict:
    return {"state": act.pool_state(),
            "counters": (act.num_drained, act.num_drain_killed, act.num_retargeted),
            "replicas": [(r.name, r.items, r.done, r.dead, r.closed) for r in reps]}


def test_actuator_graceful_drain_completes_work():
    def scenario(P):
        A = P.A
        act = A.EnginePoolActuator(spawn=_spawner())
        reps = _grow(P, act, A.POOL_DECODE, 2)
        reps[1].submit("a")
        reps[1].submit("b")
        act.apply(A.Decision(A.POOL_DECODE, A.ACTION_SCALE_DOWN, target=1))
        assert act.pool_state()[A.POOL_DECODE]["replicas_running"] == 1
        assert reps[1].done == ["a", "b"] and reps[1].closed
        assert act.num_drained == 1 and act.num_retargeted == 0
        return _act_record(act, reps)

    _run(scenario)


def test_chaos_drain_kill_retargets_pending():
    def scenario(P):
        A, C = P.A, P.chaos
        C.install(C.FaultSchedule(3, [
            C.FaultSpec(C.KILL_REPLICA, site="autoscale.drain", max_fires=1),
        ]))
        act = A.EnginePoolActuator(spawn=_spawner())
        reps = _grow(P, act, A.POOL_DECODE, 2)
        for item in ("a", "b", "c"):
            reps[1].submit(item)
        act.apply(A.Decision(A.POOL_DECODE, A.ACTION_SCALE_DOWN, target=1))
        assert act.num_drain_killed == 1
        assert act.num_retargeted == 3
        assert reps[0].items == ["a", "b", "c"]
        fired = P.harness.ACTIVE.fired_kinds()
        C.uninstall()
        return _act_record(act, reps), fired

    _run(scenario)


def test_chaos_preempt_node_mid_scale_down_zero_lost():
    def scenario(P):
        A, C = P.A, P.chaos
        sched = C.FaultSchedule(7, [C.FaultSpec(C.PREEMPT_NODE, at_s=0.0, target="decode")])
        orch = sched.orchestrated()
        assert len(orch) == 1
        assert sched.fire("autoscale.drain", kinds=(C.PREEMPT_NODE,)) == []
        act = A.EnginePoolActuator(spawn=_spawner())
        reps = _grow(P, act, A.POOL_DECODE, 3)
        submitted = []
        for i, r in enumerate(reps):
            for j in range(2):
                item = f"req-{i}-{j}"
                r.submit(item)
                submitted.append(item)
        idx, _spec = orch[0]
        victim = sched.pick(idx, reps[1:])
        victim.on_drain = lambda rep: rep.kill()
        act.apply(A.Decision(A.POOL_DECODE, A.ACTION_SCALE_TO_ZERO, target=1))
        survivor = reps[0]
        completed = [x for r in reps for x in r.done]
        assert sorted(completed + survivor.items) == sorted(submitted)
        assert act.num_retargeted == 2
        vi = reps.index(victim)
        assert survivor.items[-2:] == [f"req-{vi}-0", f"req-{vi}-1"]
        return _act_record(act, reps), vi

    _run(scenario)


# ---------------------------------------------------------------------------
# chaos: STALL_GCS mid-decision over a real GCS
# ---------------------------------------------------------------------------


def test_chaos_stall_gcs_mid_decision_holds_then_no_flap():
    """Each package over its own ``GcsServer``: a breached fleet pushed
    once, the same seeded STALL_GCS schedule on ``autoscale_signals``
    installed in each package's harness for three ticks."""
    def scenario(P):
        A, C = P.A, P.chaos
        server = P.gcs.GcsServer(port=0)
        host, port = server.start()
        try:
            push = P.rpc.ReconnectingRpcClient(host, port, timeout=5).connect()
            for _ in range(4):
                P.slo.ttft_histogram().observe(0.5, tags={"model": "m"})
            P.telemetry.cluster_gauge("llm_queue_depth", tag_keys=("model",)).set(
                3.0, tags={"model": "m"})
            push.call("telemetry_push", {
                "reporter_id": "host0", "kind": "engine", "role": "prefill",
                "snapshot": P.telemetry.annotated_snapshot(),
            }, timeout=5)
            act = RecordingActuator(_both_one(P))
            gcs = P.rpc.ReconnectingRpcClient(host, port, timeout=5).connect()
            auto = A.PoolAutoscaler(_cfg(P), act, gcs=gcs,
                                    thresholds={"ttft_p_s": 0.01, "min_count": 1})
            ticks = [auto.tick(now=0.0)]
            assert ticks[0][A.POOL_PREFILL].action == A.ACTION_HOLD and not auto.gcs_dark
            C.install(C.FaultSchedule(11, [
                C.FaultSpec(C.STALL_GCS, site="gcs.call",
                            match={"method": "autoscale_signals"}, max_fires=3),
            ]))
            for t in (1.0, 2.0, 3.0):
                ticks.append(auto.tick(now=t))
                assert all(x.action == A.ACTION_HOLD for x in ticks[-1].values())
                assert auto.gcs_dark
            assert auto.num_dark_ticks == 3
            assert auto.num_scale_actions == 0 and act.applied == []
            fired = P.harness.ACTIVE.fired_kinds()
            C.uninstall()
            ticks.append(auto.tick(now=4.0))
            assert not auto.gcs_dark
            assert ticks[-1][A.POOL_PREFILL].action == A.ACTION_HOLD
            ticks.append(auto.tick(now=5.0))
            assert ticks[-1][A.POOL_PREFILL].action == A.ACTION_SCALE_UP
            assert [a.pool for a in act.applied] == [A.POOL_PREFILL]
            push.close()
            gcs.close()
            rec = _controller_record(auto, act, ticks)
            # the dark ticks' reasons name the blackout; the log's grades
            # and actions are compared whole
            return rec, fired
        finally:
            server.stop()

    _run(scenario)


# ---------------------------------------------------------------------------
# metrics + status surface
# ---------------------------------------------------------------------------


def test_autoscale_metrics_and_status_block():
    def scenario(P):
        A = P.A
        act = RecordingActuator(_both_one(P))
        auto = A.PoolAutoscaler(_cfg(P), act,
                                fetch_signals=lambda: _payload(tpot="red", arrival=1.0))
        for t in range(3):
            auto.tick(now=float(t))
        store = P.telemetry.TelemetryStore()
        store.ingest("ctl", P.telemetry.annotated_snapshot(), {"kind": "controller"})
        health = store.autoscale_health()
        assert health["decisions_total"] >= 6
        assert health["scale_ups_total"] == 1
        assert health["decisions_by_action"].get("scale_up") == 1
        assert health["pool_targets"].get(A.POOL_DECODE) == 2
        assert health["gcs_dark"] == 0.0
        text = P.telemetry.format_status(store.status_payload())
        assert "== autoscaler ==" in text
        assert "up 1" in text
        block = text[text.index("== autoscaler =="):].split("\n==")[0]
        return health, block

    _run(scenario)


def test_register_metrics_declares_aggregations():
    def scenario(P):
        P.metrics.register_metrics()
        kinds = [P.telemetry.aggregation_kind(f"ray_tpu_autoscale_{n}", t)
                 for n, t in (("pool_target", "gauge"), ("gcs_dark", "gauge"),
                              ("decisions_total", "counter"),
                              ("cold_start_seconds", "histogram"))]
        assert kinds[0] is not None and kinds[1] is not None
        meta = {m.name: (m.TYPE, m.description, m.tag_keys, getattr(m, "boundaries", None))
                for m in P.reg.registry_snapshot() if m.name.startswith("ray_tpu_autoscale_")}
        assert len(meta) == 7
        return kinds, meta

    _run(scenario)


# ---------------------------------------------------------------------------
# control-plane frames (GCS hot paths)
# ---------------------------------------------------------------------------


def _register(svc, node_id):
    svc.rpc_register_node({
        "node_id": node_id, "addr": ("127.0.0.1", 0),
        "resources": {"CPU": 4}, "labels": {},
    }, None)


def _snap(node, seq, total, epoch="e1"):
    return {
        "epoch": f"{node}-{epoch}", "seq": seq,
        "ts_monotonic": float(seq), "ts_wall": float(seq),
        "metrics": [{
            "name": "ray_tpu_bench_ops_total", "type": "counter",
            "description": "", "tag_keys": ["node"], "agg": "sum",
            "series": [{"tags": [node], "value": float(total)}],
        }],
    }


def _agg(gcs) -> dict:
    agg = gcs.telemetry.cluster_metrics()
    return {"counters": agg["counters"], "reporters": sorted(agg["reporters"])}


def test_heartbeat_batch_matches_individual_semantics():
    def scenario(P):
        gcs = P.gcs.GcsService()
        _register(gcs, "n0")
        _register(gcs, "n1")
        out = gcs.rpc_heartbeat_batch({"heartbeats": [
            {"node_id": "n0", "available": {"CPU": 3}, "telemetry": _snap("n0", 1, 10)},
            {"node_id": "n1", "available": {"CPU": 4}, "telemetry": _snap("n1", 1, 5)},
            {"node_id": "ghost"},
        ]}, None)
        assert out["ok"]
        assert [r.get("ok") for r in out["results"]] == [True, True, False]
        assert out["results"][2].get("reregister") is True
        agg = gcs.telemetry.cluster_metrics()
        assert agg["counters"]["ray_tpu_bench_ops_total"]["total"] == 15.0
        assert set(agg["reporters"]) == {"n0", "n1"}
        return out, _agg(gcs)

    _run(scenario)


BATCH_OPS = [
    {"method": "kv_put", "payload": {"key": "k", "value": 1}},
    {"method": "heartbeat", "payload": {"node_id": "n0", "telemetry": _snap("n0", 1, 7)}},
    {"method": "telemetry_push", "payload": {
        "reporter_id": "svc0", "kind": "engine", "snapshot": _snap("svc0", 1, 3)}},
    {"method": "kv_get", "payload": {"key": "k"}},
]


def test_rpc_batch_dispatches_and_isolates():
    """The reference's batch frame against the same ops one by one on the
    port's GCS (the port has no ``batch`` frame: nothing sends one)."""
    ref = PKGS["ref"].gcs.GcsService()
    _register(ref, "n0")
    out = ref.rpc_batch({"ops": BATCH_OPS + [
        {"method": "kv_wait", "payload": {"key": "k"}}]}, None)
    assert out["ok"]
    res = out["results"]
    assert res[1]["ok"] is True and res[2]["ok"] is True
    assert "not batchable" in res[4]["error"]
    assert ref.telemetry.cluster_metrics()["counters"]["ray_tpu_bench_ops_total"]["total"] \
        == 10.0
    assert ref.rpc_kv_get({"key": "k"}, None) == res[3]

    port = PKGS["port"].gcs.GcsService()
    _register(port, "n0")
    assert not hasattr(port, "rpc_batch")
    one_by_one = [getattr(port, f"rpc_{op['method']}")(op["payload"], None)
                  for op in BATCH_OPS]
    assert one_by_one == res[:4]
    assert _agg(port) == _agg(ref)


def test_batch_rejected_heartbeat_never_ingests_telemetry():
    def scenario(P):
        gcs = P.gcs.GcsService()
        out = gcs.rpc_heartbeat_batch({"heartbeats": [
            {"node_id": "ghost", "telemetry": _snap("ghost", 1, 99)},
        ]}, None)
        assert out["results"][0].get("reregister") is True
        assert "ghost" not in gcs.telemetry.cluster_metrics()["reporters"]
        return out, _agg(gcs)

    _run(scenario)


def test_ingest_batch_converges_exactly_after_drops_and_restart():
    def scenario(P):
        a, b = P.telemetry.TelemetryStore(), P.telemetry.TelemetryStore()
        frames = [
            _snap("n0", 1, 5), _snap("n0", 2, 9),
            _snap("n0", 4, 20),
            _snap("n0", 1, 4, epoch="e2"),
            _snap("n0", 1, 4, epoch="e2"),
            _snap("n0", 2, 6, epoch="e2"),
        ]
        for f in frames:
            a.ingest("n0", f, {"kind": "node"})
        results = b.ingest_batch([("n0", f, {"kind": "node"}) for f in frames])
        assert results[4].get("ignored") == "stale_seq"
        totals = []
        for store in (a, b):
            agg = store.cluster_metrics()
            totals.append(agg["counters"]["ray_tpu_bench_ops_total"]["total"])
        assert totals == [26, 26]
        return results, totals

    _run(scenario)
