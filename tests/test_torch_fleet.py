"""The multi-tenant fleet of ray_tpu_torch (``fleet/``, the SLO grading of
``obs/telemetry.py``) held against ray_tpu.fleet on the CPU.

Mirrors the engine-backed tests of tests/test_fleet.py with the same spec
and seed 7, on LLAMA_TINY in fp32 (the reference's weights carried over
with ``params_from_numpy``): the spec and the QoS units; the adapter slots,
LRU eviction and scoped invalidation; routing and adapter refs;
``FleetServer``'s payloads; and
``evaluate_slo`` on the same histograms. Then, on the port alone: the
noisy neighbour (the reference's runner starves priority submits, ROADMAP
Queue 3), replicas owning their weight storages, and a replica rebuilt by
the runner's last rung keeping the canary's version. The canary ladder is
in tests/test_torch_fleet_canary.py (promote, a seeded ``PREEMPT_ENGINE``,
``set_pool_target``) and tests/test_torch_fleet_rollback.py.
"""

import asyncio
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import fleet as jfleet
from ray_tpu.fleet.qos import TenantQoSController as JTenantQoSController
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.obs.telemetry import SLOThresholds as JSLOThresholds
from ray_tpu.obs.telemetry import evaluate_slo as j_evaluate_slo
from ray_tpu.serve.proxy import Request as HttpRequest
from ray_tpu_torch import fleet as tfleet
from ray_tpu_torch.fleet.qos import TenantQoSController
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.engine import AdapterSlotsExhausted
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.obs.telemetry import SLOThresholds, evaluate_slo

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet]
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
PROMPT = [5, 9, 17, 3]
SEED = 7
LOOSE = dict(ttft_p_s=120, tpot_p_s=120, queue_wait_p_s=120)
PKG = {
    "ref": dict(fleet=jfleet, Engine=JLLMEngine, Config=JEngineConfig, SP=JSamplingParams,
                model=J_FP32_TINY, SLO=JSLOThresholds),
    "port": dict(fleet=tfleet, Engine=LLMEngine, Config=EngineConfig, SP=SamplingParams,
                 model=FP32_TINY, SLO=SLOThresholds),
}


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(J_FP32_TINY, jax.random.key(SEED))


def _params(pkg, jp):
    if pkg == "ref":
        return jp
    return tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


def _cfg(pkg, **kw):
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_num_seqs", 4)
    kw.setdefault("max_loras", 2)
    kw.setdefault("lora_rank", 4)
    return PKG[pkg]["Config"](model=PKG[pkg]["model"], **kw)


def _greedy(pkg, n=6):
    return PKG[pkg]["SP"](max_tokens=n, temperature=0.0)


def _adapters(seed, scale=0.5, rank=4):
    m = tllama.LLAMA_TINY
    rng = np.random.RandomState(seed)
    mk = lambda *shape: (rng.randn(*shape) * scale).astype(np.float32)  # noqa: E731
    return {
        "wq": (mk(m.n_layers, m.d_model, rank), mk(m.n_layers, rank, m.n_heads * m.head_dim)),
        "wv": (mk(m.n_layers, m.d_model, rank), mk(m.n_layers, rank, m.n_kv_heads * m.head_dim)),
    }


def _spec(pkg, replicas=None, **kw):
    f = PKG[pkg]["fleet"]
    if replicas is None:
        kw.setdefault("models", (f.ModelSpec("tiny", replicas=1,
                                             adapters=(f.AdapterSpec("styleA", rank=4),)),))
    else:
        kw.setdefault("models", (f.ModelSpec("tiny", replicas=replicas),))
    kw.setdefault("tenants", (f.TenantSpec("gold", priority=2, weight=3.0),
                              f.TenantSpec("batch", priority=0, weight=1.0)))
    return f.FleetSpec(**kw)


def _manager(pkg, jp, replicas=None, cfg=None, thresholds=None, spec_kw=None):
    kw = dict(engine_config=cfg or _cfg(pkg), params={"tiny": _params(pkg, jp)}, seed=SEED,
              thresholds=thresholds or PKG[pkg]["SLO"](**LOOSE))
    if pkg == "port":
        kw["device"] = "cpu"
    return PKG[pkg]["fleet"].FleetManager(_spec(pkg, replicas, **(spec_kw or {})), **kw)


def _run(mgr, pkg, model, prompt=PROMPT, n=6):
    return list(mgr.collect(mgr.submit("gold", model, prompt, _greedy(pkg, n)),
                            timeout_s=120).output_token_ids)


def _both(fn):
    """Run ``fn(pkg)`` for the reference, then the port."""
    return fn("ref"), fn("port")


# ---------------------------------------------------------------------------
# spec + QoS units (:100, :118) and the SLO grading
# ---------------------------------------------------------------------------


def test_spec_parse_shares_and_lookups():
    def run(pkg):
        f = PKG[pkg]["fleet"]
        spec = _spec(pkg, total_queue_budget=8)
        out = [f.FleetSpec.parse_model_ref("tiny"), f.FleetSpec.parse_model_ref("tiny:styleA"),
               spec.queue_depth_for(spec.tenant("gold")),
               spec.queue_depth_for(spec.tenant("batch")), spec.to_dict()]
        with pytest.raises(f.UnknownTenantError):
            spec.tenant("nobody")
        with pytest.raises(f.UnknownModelError):
            spec.model("other")
        lax = _spec(pkg, allow_unknown_tenants=True)
        out += [lax.tenant("nobody").priority, lax.tenant("").tenant_id]
        with pytest.raises(ValueError, match="':'-free"):
            f.AdapterSpec("a:b")
        return out

    ref, got = _both(run)
    assert got == ref
    assert got[:4] == [("tiny", None), ("tiny", "styleA"), 6, 2] and got[-2:] == [0, "anon"]


def test_qos_flood_exhausts_own_share_only():
    def run(pkg):
        spec = _spec(pkg, total_queue_budget=8)
        qos = (JTenantQoSController if pkg == "ref" else TenantQoSController)(spec)
        batch, gold = spec.tenant("batch"), spec.tenant("gold")
        results = [qos.admit(batch) for _ in range(10)]
        golds = [qos.admit(gold) for _ in range(6)]
        waiting = qos.waiting_by_tenant()
        qos.release("batch")
        return results, golds, waiting, qos.admit(batch), qos.stats()["waiting_by_tenant"]

    ref, got = _both(run)
    assert got == ref
    results, golds, waiting, _, _ = got
    assert sum(r is None for r in results) == 2 and results[2]["error"]["code"] in (429, 503)
    assert golds == [None] * 6 and waiting == {"batch": 2, "gold": 6}


def _hist(boundaries, values):
    b = [0] * (len(boundaries) + 1)
    for v in values:
        b[int(np.searchsorted(boundaries, v, side="right"))] += 1
    return {"boundaries": boundaries, "buckets": b, "sum": float(sum(values)),
            "count": len(values)}


def test_evaluate_slo_equals_reference():
    from ray_tpu_torch.obs.telemetry import SLO_HISTOGRAMS

    rng = np.random.default_rng(SEED)
    bounds = [0.001, 0.01, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30]
    hists = {name: {tag: _hist(bounds, list(rng.exponential(scale, 20)))
                    for tag, scale in (("tiny@r0", 0.05), ("tiny@r1", 3.0),
                                       ("tenant:gold", 0.4))}
             for name in SLO_HISTOGRAMS.values()}
    hists[SLO_HISTOGRAMS["tpot"]].pop("tenant:gold")  # a signal without data
    for th in ({}, {"ttft_p_s": 0.1, "yellow_factor": 3.0, "percentile": 50.0},
               {"min_count": 50}):
        ref = j_evaluate_slo(hists, JSLOThresholds(**th))
        got = evaluate_slo(hists, SLOThresholds(**th))
        assert got == ref
    assert {e["grade"] for e in got["model_tags"].values()} == {"no_data"}
    assert evaluate_slo(hists)["model_tags"]["tiny@r1"]["grade"] == "red"


# ---------------------------------------------------------------------------
# adapter residency (:148-200)
# ---------------------------------------------------------------------------


def _engine(pkg, jp, **kw):
    if pkg == "ref":
        return JLLMEngine(_cfg(pkg, **kw), params=jp, seed=SEED)
    return LLMEngine(_cfg(pkg, **kw), params=_params(pkg, jp), seed=SEED, device="cpu")


def test_adapter_slots_exhausted_typed_and_lru_evict(jparams):
    def run(pkg):
        eng = _engine(pkg, jparams)
        eng.add_lora("a", _adapters(1))
        eng.add_lora("b", _adapters(2))
        with pytest.raises(ValueError, match="slots in use"):
            eng.add_lora("c", _adapters(3))
        rid = eng.add_request(PROMPT, _greedy(pkg), lora_id="a")
        toks = None
        while eng.has_unfinished():
            for o in eng.step():
                toks = o.output_token_ids if o.finished else toks
        eng.abort_request(rid)
        eng.add_lora("c", _adapters(3), evict=True)
        return set(eng._lora_slots), list(toks)

    ref, got = _both(run)
    assert got == ref and got[0] == {"a", "c"}
    assert isinstance(AdapterSlotsExhausted("x"), ValueError)


def test_lru_evict_refuses_inflight_adapter(jparams):
    def run(pkg):
        eng = _engine(pkg, jparams, max_loras=1)
        eng.add_lora("a", _adapters(1))
        eng.add_request(PROMPT, PKG[pkg]["SP"](max_tokens=32), lora_id="a")
        eng.step()  # "a" now has an in-flight sequence
        assert eng.evict_lru_lora() is None
        with pytest.raises(ValueError, match="slots in use"):
            eng.add_lora("b", _adapters(2), evict=True)
        return set(eng._lora_slots)

    ref, got = _both(run)
    assert got == ref == {"a"}


def test_adapter_swap_scoped_prefix_invalidation(jparams):
    def run(pkg):
        eng = _engine(pkg, jparams, enable_prefix_caching=True, block_size=4)
        eng.add_lora("a", _adapters(1))
        eng.add_lora("b", _adapters(2))
        prompt = list(range(3, 19))  # 16 tokens = 4 full blocks
        for lid in ("a", "b"):
            eng.add_request(prompt, _greedy(pkg), lora_id=lid)
            while eng.has_unfinished():
                eng.step()
        slot_a, slot_b = eng._lora_slots["a"], eng._lora_slots["b"]
        probes = [eng.allocator.probe_prefix(prompt, s) for s in (slot_a, slot_b)]
        eng.remove_lora("a")
        probes += [eng.allocator.probe_prefix(prompt, s) for s in (slot_a, slot_b)]
        eng.add_lora("a", _adapters(9))
        probes.append(eng.allocator.probe_prefix(prompt, eng._lora_slots["a"]))
        return probes

    ref, got = _both(run)
    assert got == ref
    assert got[0] > 0 and got[1] > 0 and got[2] == 0 and got[3] > 0 and got[4] == 0


# ---------------------------------------------------------------------------
# routing (:204)
# ---------------------------------------------------------------------------


def test_fleet_routes_and_serves_adapter_refs(jparams):
    def run(pkg):
        mgr = _manager(pkg, jparams, replicas=2)
        try:
            mgr.register_adapter("tiny", "styleA", _adapters(1))
            base = _run(mgr, pkg, "tiny")
            tuned = _run(mgr, pkg, "tiny:styleA")
            resident = [r.tag for r in mgr.replicas("tiny") if "styleA" in r.engine._lora_slots]
            with pytest.raises(Exception, match="not registered"):
                mgr.submit("gold", "tiny:ghost", PROMPT, _greedy(pkg))
            tags = {mgr.route("tiny", None, PROMPT).tag for _ in range(4)}
            st = mgr.stats()
            return base, tuned, len(resident), len(tags), sorted(st), st["weights"]
        finally:
            mgr.close()

    ref, got = _both(run)
    assert got == ref
    base, tuned, resident, tags, _, _ = got
    assert base != tuned and resident >= 1 and tags == 2


def _perturbed(params, factor=1.01):
    """Every leaf x factor, as numpy (both packages take numpy trees)."""
    if isinstance(tllama.sorted_leaves(params)[0], torch.Tensor):
        params = tllama.params_to_numpy(params)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) * np.asarray(factor, np.asarray(x).dtype), params)


# ---------------------------------------------------------------------------
# FleetServer payloads
# ---------------------------------------------------------------------------

VOLATILE = ("id", "created")


def _req(method, path, body=None, tenant="gold"):
    headers = {"x-tenant-id": tenant} if tenant else {}
    return HttpRequest(method, path, {}, headers, json.dumps(body).encode() if body else b"")


def test_fleet_server_payloads(jparams):
    def run(pkg):
        f = PKG[pkg]["fleet"]
        spec = _spec(pkg)
        kw = dict(engine_config=_cfg(pkg), params={"tiny": _params(pkg, jparams)}, seed=SEED,
                  thresholds=PKG[pkg]["SLO"](**LOOSE))
        if pkg == "port":
            kw["device"] = "cpu"
        srv = f.FleetServer(spec, **kw)
        try:
            srv.manager.register_adapter("tiny", "styleA", _adapters(1))
            body = {"prompt": "hello", "max_tokens": 6, "temperature": 0.0}

            async def go():
                return [
                    await srv(_req("GET", "/v1/models")),
                    await srv(_req("POST", "/v1/completions", body)),
                    await srv(_req("POST", "/v1/completions", {**body, "model": "tiny:styleA"})),
                    await srv(_req("POST", "/v1/completions", body, tenant="nobody")),
                    await srv(_req("POST", "/v1/completions", {**body, "model": "other"})),
                    await srv(_req("POST", "/v1/chat/completions",
                                   {"messages": [{"role": "user", "content": "hi"}],
                                    "max_tokens": 4, "temperature": 0.0})),
                    await srv(_req("GET", "/v1/nope")),
                    await srv(_req("GET", "/v1/stats")),
                ]
            out = asyncio.run(go())
            stats = out.pop()
            return ([{k: v for k, v in p.items() if k not in VOLATILE} for p in out],
                    sorted(stats), sorted(stats["qos"]), sorted(stats["weights"]),
                    sorted(stats["models"]["tiny"]["replicas"][0]))
        finally:
            srv.shutdown()

    ref, got = _both(run)
    assert got == ref
    payloads = got[0]
    assert [m["id"] for m in payloads[0]["data"]] == ["tiny", "tiny:styleA"]
    assert payloads[1]["choices"][0]["finish_reason"] in ("length", "stop")
    assert payloads[3]["error"]["code"] == 401 and payloads[4]["error"]["code"] == 404


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_noisy_neighbor_paying_tenant_green(jparams):
    """A batch tenant floods; the paying tenant's requests finish, its SLO
    series grades green, the batch tenant is shed, and a priority
    preemption is attributed to the batch tenant. Not compared with the
    reference, whose runner starves priority submits."""
    from ray_tpu_torch.llm.engine import preemption_counter

    mgr = _manager("port", jparams, cfg=_cfg("port", max_num_seqs=2),
                   spec_kw=dict(total_queue_budget=8))
    try:
        _run(mgr, "port", "tiny")
        baseline = tfleet.local_slo_histograms()
        stop, shed = threading.Event(), [0]

        def flood():
            while not stop.is_set():
                try:
                    t = mgr.submit("batch", "tiny", PROMPT, SamplingParams(max_tokens=24))
                except tfleet.FleetAdmissionRejected:
                    shed[0] += 1
                    time.sleep(0.005)
                    continue
                try:
                    mgr.collect(t, timeout_s=120)
                except Exception:  # noqa: BLE001 — a shed or aborted flood request
                    pass

        threads = [threading.Thread(target=flood) for _ in range(4)]
        for th in threads:
            th.start()
        time.sleep(0.5)
        try:
            for _ in range(3):
                assert len(_run(mgr, "port", "tiny")) == 6
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=120)
        grades = evaluate_slo(tfleet.local_slo_histograms(baseline=baseline),
                              SLOThresholds(ttft_p_s=60, tpot_p_s=60, queue_wait_p_s=60))
        assert grades["model_tags"]["tenant:gold"]["grade"] == "green", grades
        assert shed[0] >= 1
        pre = {k: v for k, v in preemption_counter().series().items() if k[2] == "priority"}
        assert pre and any(k[1] == "batch" for k in pre), pre
    finally:
        mgr.close()


def test_replicas_own_their_weights(jparams):
    params = _params("port", jparams)
    mgr = tfleet.FleetManager(_spec("port", 2), engine_config=_cfg("port"),
                              params={"tiny": params}, seed=SEED, device="cpu")
    try:
        r0, r1 = mgr.replicas("tiny")
        assert r0.engine.params["embed"] is params["embed"]  # the first takes the tree
        assert not tfleet.shares_storage(r0.engine.params, r1.engine.params)
        assert tfleet.bitwise_equal(r1.engine.params, r0.engine.params)
        # an alias fails the gates: equal bytes, shared storage
        assert tfleet.shares_storage(r0.engine.params, params)
        new = _perturbed(r0.engine.params)
        ptrs = {t.data_ptr() for t in tllama.sorted_leaves(r1.engine.params)}
        mgr.weights.begin_canary("tiny", params=new)
        # the canary wrote in place: same tensors, new bytes; r0 untouched
        assert {t.data_ptr() for t in tllama.sorted_leaves(r1.engine.params)} == ptrs
        assert tfleet.bitwise_equal(r1.engine.params, new)
        assert not tfleet.bitwise_equal(r0.engine.params, new)
        # the retained previous weights are a copy, not the canary's tensors
        prev = mgr.weights._canary["prev"]
        assert not tfleet.shares_storage(prev, r1.engine.params)
        assert tfleet.bitwise_equal(prev, r0.engine.params)
        assert mgr.weights.rollback()["outcome"] == "rolled_back"
        assert tfleet.bitwise_equal(r1.engine.params, r0.engine.params)
    finally:
        mgr.close()


def test_rebuilt_replica_keeps_the_canary_version(jparams):
    """The runner's last rung (a fresh engine from the factory) mid-canary:
    the rebuilt canary serves the canary's weights and version, not the
    spawn-time tree, so the promote still lands bitwise."""
    mgr = _manager("port", jparams, replicas=2)
    try:
        new = _perturbed(mgr.replicas("tiny")[0].engine.params)
        info = mgr.weights.begin_canary("tiny", params=new)
        canary = mgr.replicas("tiny")[-1]
        torn = canary.engine

        def fail_once():
            del torn.step
            raise RuntimeError("injected step failure")

        def broken_recover(**_kw):
            del torn.recover
            raise RuntimeError("injected recover failure")

        torn.step, torn.recover = fail_once, broken_recover
        out = _run(mgr, "port", "tiny")  # routed round robin: lands on a replica
        outs = [out] + [_run(mgr, "port", "tiny") for _ in range(3)]
        assert canary.runner.num_recoveries == 1 and canary.engine is not torn
        assert canary.engine.weight_version == info["version"]
        assert tfleet.bitwise_equal(canary.engine.params, new)
        assert mgr.weights.promote()["outcome"] == "promoted"
        assert all(tfleet.bitwise_equal(r.engine.params, new) for r in mgr.replicas("tiny"))
        assert len({tuple(o) for o in outs}) <= 2
    finally:
        mgr.close()
