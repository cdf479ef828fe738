"""ray_tpu_torch's metrics registry, utilization gauges, prefix-cache stats
and admission shedding, held against the reference on the CPU.

 * every metric both packages register has the reference's name, type,
   tag keys, boundaries, description and aggregation kind, and the same
   observations render the same Prometheus lines;
 * ``update_telemetry_gauges`` and ``stats()["prefix_cache"]`` read equal
   values from both engines on one trace (ROADMAP Queue 3's recorded
   trace for ``by_tier``);
 * both AdmissionControllers, fed the same queue-wait history, return the
   same ``check()`` payloads; a DELAY_RPC-slowed burst through the port's
   LLMServer sheds with 429s on the queue-wait trigger;
 * a priority-2 submit through LLMServer preempts a priority-0 row at the
   next step boundary (the reference's runner, which retakes its lock
   after every step, starves it: ROADMAP Queue 3).
"""

import asyncio
import dataclasses
import json
import queue
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import admission as jadmission
from ray_tpu.llm import engine as jengine_mod
from ray_tpu.llm import pipeline as jpipeline
from ray_tpu.llm.spec import stats as jspec_stats
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.obs import slo as jslo
from ray_tpu.obs import telemetry as jtelemetry
from ray_tpu.serve.proxy import Request
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch import chaos
from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMEngine, LLMServer, SamplingParams
from ray_tpu_torch.llm import admission as tadmission
from ray_tpu_torch.llm import engine as tengine_mod
from ray_tpu_torch.llm import pipeline as tpipeline
from ray_tpu_torch.llm.spec import stats as tspec_stats
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.obs import slo as tslo
from ray_tpu_torch.obs import telemetry as ttelemetry
from ray_tpu_torch.util import metrics as tmetrics

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)
WAIT_S = 60  # every wait on a task, a response or a future fails past this

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)

# what each module registers (the reference's lists, by its register hooks)
REGISTERED = {
    "engine": ["llm_prefix_cache_hit_tokens_total", "llm_prefix_cache_lookup_tokens_total",
               "llm_preemptions_total", "llm_kv_pages_used", "llm_kv_pages_total",
               "llm_kv_hbm_bytes", "llm_queue_depth", "llm_running_requests"],
    "pipeline": ["llm_decode_host_prep_ms", "llm_decode_sync_wait_ms"],
    "slo": ["llm_ttft_seconds", "llm_tpot_seconds", "llm_prefill_span_seconds",
            "llm_queue_wait_seconds", "llm_e2e_seconds", "serve_router_dispatch_seconds",
            "llm_kv_transfer_seconds", "llm_kv_transfer_bytes_total"],
    "admission": ["llm_admission_rejected_total"],
    "spec": ["llm_spec_drafted_tokens_total", "llm_spec_accepted_tokens_total",
             "llm_spec_emitted_tokens_total", "llm_spec_acceptance_rate",
             "llm_spec_mean_accepted_len"],
}
HOOKS = {
    "engine": (jengine_mod.register_metrics, tengine_mod.register_metrics),
    "pipeline": (jpipeline.register_metrics, tpipeline.register_metrics),
    "slo": (jslo.register_all, tslo.register_all),
    "admission": (jadmission.register_metrics, tadmission.register_metrics),
    "spec": (jspec_stats._spec_metrics, tspec_stats._spec_metrics),
}
# each module's metric objects, from its own constructors (the reference's
# registry may have been cleared by a test of the reference in this process)
BUILT = {
    "engine": lambda m: [m.prefix_cache_hit_counter(), m.prefix_cache_lookup_counter(),
                         m.preemption_counter(), *m.utilization_gauges().values()],
    "pipeline": lambda m: [m.host_prep_histogram(), m.sync_wait_histogram()],
    "slo": lambda m: [m.ttft_histogram(), m.tpot_histogram(), m.prefill_span_histogram(),
                      m.queue_wait_histogram(), m.e2e_histogram(),
                      m.router_dispatch_histogram(), m.kv_transfer_histogram(),
                      m.kv_transfer_bytes_counter()],
    "admission": lambda m: [m.rejected_counter()],
    "spec": lambda m: list(m._spec_metrics().values()),
}
PACKAGES = {"engine": (jengine_mod, tengine_mod), "pipeline": (jpipeline, tpipeline),
            "slo": (jslo, tslo), "admission": (jadmission, tadmission),
            "spec": (jspec_stats, tspec_stats)}


def _registry(mod) -> dict:
    return {m.name: m for m in mod.registry_snapshot()}


def _meta(m, telemetry) -> dict:
    return {"type": m.TYPE, "tag_keys": m.tag_keys, "description": m.description,
            "boundaries": getattr(m, "boundaries", None),
            "agg": telemetry.aggregation_kind(m.name, m.TYPE)}


@pytest.mark.parametrize("module", sorted(REGISTERED))
def test_registered_metrics_equal_reference(module):
    jmod, tmod = PACKAGES[module]
    ref = {m.name: _meta(m, jtelemetry) for m in BUILT[module](jmod)}
    got = {m.name: _meta(m, ttelemetry) for m in BUILT[module](tmod)}
    assert set(ref) == {f"ray_tpu_{n}" for n in REGISTERED[module]}
    assert got == ref
    # the port's register hook registers them
    HOOKS[module][1]()
    assert set(got) <= set(_registry(tmetrics))


def test_the_port_registers_exactly_these():
    """On an empty port registry the hooks register the listed metrics and
    nothing else (the port builds every metric per call, so clearing its
    registry strands nothing)."""
    tmetrics.clear_registry()
    for _, thook in HOOKS.values():
        thook()
    want = {f"ray_tpu_{n}" for names in REGISTERED.values() for n in names}
    assert set(_registry(tmetrics)) == want


def _observe(mods, tag: str) -> None:
    """The same observations through each package's own entry points."""
    for slo_mod, engine_mod, pipeline_mod in mods:
        slo_mod.record_request_slo(tag, ttft_s=0.03, tpot_s=0.004, queue_wait_s=0.0,
                                   e2e_s=0.2, finish_reason="length", prefill_span_s=0.02)
        slo_mod.record_request_slo(tag, ttft_s=None, tpot_s=None, queue_wait_s=None,
                                   e2e_s=7.0, finish_reason="abort")
        slo_mod.record_kv_transfer(tag, "inproc", seconds=0.003, nbytes=4096)
        slo_mod.record_dispatch(tag, "dep", 0.0002)
        engine_mod.prefix_cache_hit_counter().inc(16, tags={"model": tag, "tier": "hbm"})
        engine_mod.prefix_cache_lookup_counter().inc(40, tags={"model": tag})
        engine_mod.preemption_counter().inc(1, tags={"model": tag, "tenant": 'a"b\\c\nd',
                                                     "reason": "priority"})
        g = engine_mod.utilization_gauges()
        g["kv_pages_used"].set(5, tags={"model": tag})
        g["queue_depth"].set(3, tags={"model": tag})
        pipeline_mod.host_prep_histogram().observe(0.7)


def _lines(text: str, tag: str) -> list:
    return sorted(line for line in text.splitlines() if tag in line)


def test_prometheus_text_lines_equal_reference():
    tag = f"prom-{uuid.uuid4().hex[:8]}"
    _observe([(jslo, jengine_mod, jpipeline), (tslo, tengine_mod, tpipeline)], tag)
    jtext, ttext = jmetrics.prometheus_text(), tmetrics.prometheus_text()
    got = _lines(ttext, tag)
    assert got == _lines(jtext, tag)
    # 2 TTFT buckets series (+Inf), the escaped label, the gauge value
    assert f'ray_tpu_llm_ttft_seconds_count{{model="{tag}"}} 1' in got
    assert f'ray_tpu_llm_e2e_seconds_count{{model="{tag}",finish_reason="abort"}} 1' in got
    assert any('tenant="a\\"b\\\\c\\nd"' in line for line in got)
    assert f'ray_tpu_llm_kv_pages_used{{model="{tag}"}} 5.0' in got
    # the HELP and TYPE lines of every metric both registries hold (a test
    # of the reference may have cleared its registry in this process)
    for jhook, thook in HOOKS.values():
        jhook()
        thook()
    jtext, ttext = jmetrics.prometheus_text(), tmetrics.prometheus_text()
    both = set(_registry(tmetrics)) & set(_registry(jmetrics))
    assert {f"ray_tpu_{n}" for n in REGISTERED["slo"]} <= both
    for name in both:
        for kind in ("HELP", "TYPE"):
            want = [ln for ln in jtext.splitlines() if ln.startswith(f"# {kind} {name} ")]
            assert [ln for ln in ttext.splitlines()
                    if ln.startswith(f"# {kind} {name} ")] == want


def test_snapshot_registry_carries_histograms_and_filters():
    tag = f"snap-{uuid.uuid4().hex[:8]}"
    tslo.record_request_slo(tag, ttft_s=0.3, tpot_s=None, queue_wait_s=None, e2e_s=1.0,
                            finish_reason="stop")
    snap = tmetrics.snapshot_registry()
    assert {"epoch", "seq", "ts_monotonic", "ts_wall"} <= set(snap)
    # this test's series, filtered by the model tag as a consumer would
    ours = {}
    for m in snap["metrics"]:
        series = [s for s in m["series"]
                  if dict(zip(m["tag_keys"], s["tags"])).get("model") == tag]
        if series:
            ours[m["name"]] = {**m, "series": series}
    ttft = ours["ray_tpu_llm_ttft_seconds"]
    assert ttft["boundaries"] == tslo.ttft_histogram().boundaries
    assert ttft["series"] == [{"tags": [tag], "buckets": [0] * 8 + [1] + [0] * 6,
                               "sum": 0.3, "count": 1}]
    assert set(ours) == {"ray_tpu_llm_ttft_seconds", "ray_tpu_llm_e2e_seconds"}


def test_metric_storage_is_shared_and_locked_across_threads():
    """Instances built per call share one series; concurrent observers on
    several threads lose no update."""
    import sys

    tag = f"thr-{uuid.uuid4().hex[:8]}"
    n_threads, n_obs = 8, 300

    def work():
        for _ in range(n_obs):
            tslo.ttft_histogram().observe(0.01, tags={"model": tag})
            tengine_mod.prefix_cache_lookup_counter().inc(1, tags={"model": tag})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    _b, total, count = tslo.ttft_histogram().hist_data()[(tag,)]
    assert count == n_threads * n_obs
    assert tengine_mod.prefix_cache_lookup_counter().series()[(tag,)] == n_threads * n_obs
    with pytest.raises(ValueError, match="already registered"):
        tmetrics.Gauge("llm_ttft_seconds")


# ---------------------------------------------------------------------------
# the engines' gauges and prefix-cache stats on one trace
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jax.tree.map(np.asarray, jp)


def _engines(tree, **kw):
    jeng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, **kw), params=jax.tree.map(jnp.asarray, tree))
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    teng = LLMEngine(EngineConfig(model=FP32_TINY, **kw), params=params, device="cpu")
    return jeng, teng


def test_prefix_cache_stats_equal_reference_on_the_recorded_trace(tree):
    """ROADMAP Queue 3's recorded trace: one 40-token prompt sent twice,
    greedy, max_tokens 2; both engines return the same prefix_cache dict,
    ``by_tier`` included."""
    jeng, teng = _engines(tree, num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=64)
    prompt = np.random.RandomState(0).randint(3, 200, 40).tolist()
    for eng, sp in ((jeng, JSamplingParams), (teng, SamplingParams)):
        for _ in range(2):
            eng.generate([prompt], sp(max_tokens=2, temperature=0.0))
    want = {"hit_tokens": 32, "lookup_tokens": 80, "hit_rate": 0.4, "by_tier": {"hbm": 32}}
    assert jeng.stats()["prefix_cache"] == want
    assert teng.stats()["prefix_cache"] == want


def test_telemetry_gauges_equal_reference(tree):
    jeng, teng = _engines(tree, num_blocks=32, block_size=4, max_num_seqs=2, max_prefill_len=32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (9, 14, 6, 11, 7)]
    tag = f"gauges-{uuid.uuid4().hex[:8]}"
    values = []
    for eng, sp, mod in ((jeng, JSamplingParams, jengine_mod), (teng, SamplingParams, tengine_mod)):
        eng.model_tag = tag
        for p in prompts:
            eng.add_request(p, sp(max_tokens=8, temperature=0.0, ignore_eos=True))
        eng.step()
        eng.step()
        eng.update_telemetry_gauges()
        g = mod.utilization_gauges()
        values.append({k: m.series()[(tag,)] for k, m in g.items()})
        # the gauges read the engine's own state
        assert values[-1]["queue_depth"] == len(eng.waiting)
        assert values[-1]["running"] == len(eng.running)
        assert values[-1]["kv_pages_used"] == 32 - eng.allocator.num_free
    assert values[1] == values[0]
    assert values[1]["queue_depth"] == 3 and values[1]["running"] == 2
    assert values[1]["kv_pages_total"] == 32 and values[1]["kv_hbm_bytes"] > 0


def test_step_refreshes_the_gauges_at_most_every_200ms(tree):
    _, teng = _engines(tree, num_blocks=32, block_size=4, max_num_seqs=2, max_prefill_len=32)
    teng.model_tag = tag = f"throttle-{uuid.uuid4().hex[:8]}"
    calls = []
    teng.update_telemetry_gauges = lambda: calls.append(1)
    teng.add_request([5, 6, 7], SamplingParams(max_tokens=4))
    teng.step()
    teng.step()
    assert len(calls) == 1  # the second step falls inside the throttle
    teng._telemetry_next = 0.0
    teng.step()
    assert len(calls) == 2
    # the stub replaced the only writer of the gauges
    assert (tag,) not in tengine_mod.utilization_gauges()["queue_depth"].series()


# ---------------------------------------------------------------------------
# admission: the queue-wait trigger
# ---------------------------------------------------------------------------

SHED_CASES = {
    # name: (config, queue-wait observations, (num_waiting, num_running), drain)
    "depth": (dict(max_queue_depth=3), [], (3, 2), False),
    "slo_burning": (dict(target_queue_wait_s=0.1, min_queue_depth=2), [0.5, 0.3, 0.25],
                    (4, 2), False),
    "slo_under_target": (dict(target_queue_wait_s=1.0), [0.5, 0.3], (4, 2), False),
    "below_min_depth": (dict(target_queue_wait_s=0.1, min_queue_depth=5), [0.5], (4, 1), False),
    "no_history": (dict(target_queue_wait_s=0.1), [], (4, 1), False),
    "depth_priced_by_history": (dict(max_queue_depth=2, retry_after_cap_s=2.0), [0.4, 0.9],
                                (6, 3), False),
    "draining": (dict(), [0.2], (0, 0), True),
}


@pytest.mark.parametrize("case", sorted(SHED_CASES))
def test_admission_payloads_equal_reference(case):
    cfg, waits, (num_waiting, num_running), drain = SHED_CASES[case]
    tag = f"adm-{case}-{uuid.uuid4().hex[:8]}"
    payloads, stats = [], []
    for adm, slo_mod in ((jadmission, jslo), (tadmission, tslo)):
        for w in waits:
            slo_mod.queue_wait_histogram().observe(w, tags={"model": tag})
        ctl = adm.AdmissionController(adm.AdmissionConfig(**cfg), model_tag=tag)
        if drain:
            ctl.start_drain()
        payloads.append(ctl.check(num_waiting=num_waiting, num_running=num_running))
        stats.append(ctl.stats())
    assert payloads[1] == payloads[0]
    assert stats[1] == stats[0]
    if case in ("slo_burning", "depth", "depth_priced_by_history"):
        assert payloads[1]["error"]["code"] == 429
    if case == "slo_burning":
        assert "queue_wait" in payloads[1]["error"]["message"]
        assert stats[1]["recent_queue_wait_mean_s"] == pytest.approx(1.05 / 3)


def _req(body):
    return Request("POST", "/v1/completions", {}, {}, json.dumps(body).encode())


@pytest.fixture
def chaos_off():
    yield
    chaos.uninstall()


def test_delay_slowed_burst_sheds_on_queue_wait(tree, chaos_off):
    """Steps slowed by an injected DELAY_RPC build real queue depth; once
    finished requests have booked queue waits over the target, arrivals
    meeting a queue at least ``min_queue_depth`` deep get 429s whose
    Retry-After is priced from that history."""
    model_id = f"shed-{uuid.uuid4().hex[:8]}"
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    server = LLMServer(LLMConfig(
        model_id=model_id, params=params, device="cpu",
        engine=EngineConfig(model=FP32_TINY, num_blocks=64, block_size=4, max_num_seqs=1,
                            max_prefill_len=32),
        admission={"target_queue_wait_s": 0.02, "min_queue_depth": 2}))
    chaos.install(chaos.FaultSchedule(3, [
        chaos.FaultSpec(chaos.DELAY_RPC, site="llm.engine.step", delay_s=0.02)]))
    body = {"prompt": "slow", "max_tokens": 4, "temperature": 0.0}

    async def go():
        wave = [asyncio.ensure_future(server(_req(body))) for _ in range(16)]
        # wait (bounded) until two finished requests booked their waits
        for _ in range(600):
            data = tslo.queue_wait_histogram().hist_data().get((model_id,))
            if data is not None and data[2] >= 2:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(server.admission.MEAN_CACHE_TTL_S + 0.05)
        late = await server(_req(body))
        return late, await asyncio.gather(*wave)

    try:
        late, first = asyncio.run(go())
    finally:
        chaos.uninstall()
        server.shutdown()
    assert all("choices" in r for r in first)
    assert late["error"]["code"] == 429 and "queue_wait" in late["error"]["message"]
    assert late["error"]["retry_after"] > 0.02
    assert server.admission.stats()["rejected_429"] >= 1
    series = tadmission.rejected_counter().series()
    assert series[(model_id, "429", "")] >= 1


# ---------------------------------------------------------------------------
# priority preemption through LLMServer (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


def test_priority_submit_preempts_at_the_next_step_boundary(tree):
    """While ``max_num_seqs`` priority-0 rows run, a priority-2 request
    posted during a held step preempts one of them at the next step:
    ``num_preemptions`` and ``llm_preemptions_total{reason="priority"}``."""
    model_id = f"prio-{uuid.uuid4().hex[:8]}"
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    server = LLMServer(LLMConfig(
        model_id=model_id, params=params, device="cpu",
        # the sync decode path: a pipelined one lands its chunk in flight at
        # step 3 and preempts at step 4
        engine=EngineConfig(model=FP32_TINY, num_blocks=64, block_size=4, max_num_seqs=2,
                            max_prefill_len=32, pipeline_decode=False)))
    engine, runner = server.engine, server.runner
    step, entered, free = engine.step, queue.Queue(), threading.Event()

    def gated_step():
        if not free.is_set():
            gate = threading.Event()
            entered.put(gate)
            assert gate.wait(timeout=60)
        return step()

    engine.step = gated_step
    sp = SamplingParams(max_tokens=40, temperature=0.0, ignore_eos=True)
    gate = None
    try:
        futs = [runner.submit_future(p, sp, tenant="batch") for p in ([1, 5, 9, 13], [1, 7, 7])]
        gate = entered.get(timeout=30)
        # step until both rows run (read while a step is held: the loop is parked)
        while not (all(f.done() for f in futs) and len(engine.running) == 2):
            gate.set()
            gate = entered.get(timeout=30)
        assert engine.num_preemptions == 0
        fut = runner.submit_future([1, 2, 3], sp, priority=2, tenant="gold")
        assert not fut.done()
        gate.set()
        gate = entered.get(timeout=30)  # the next step held: the submit was taken between
        assert fut.done() and engine.num_preemptions == 0
        sinks = [f.result(timeout=WAIT_S)[1] for f in futs + [fut]]
        gate.set()
        gate = entered.get(timeout=30)  # that step preempted a priority-0 row
        assert engine.num_preemptions == 1
        assert engine.waiting[0].tenant == "batch"
        free.set()
        gate.set()
        for q in sinks:
            out = q.get(timeout=60)
            while not out.finished:
                out = q.get(timeout=60)
            assert len(out.output_token_ids) == 40
    finally:
        free.set()
        if gate is not None:
            gate.set()
        server.shutdown()
    assert engine.num_preemptions == 1
    series = tengine_mod.preemption_counter().series()
    assert series[(model_id, "batch", "priority")] == 1.0
    assert (model_id, "gold", "priority") not in series
