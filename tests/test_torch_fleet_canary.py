"""The fleet's canary promote in ray_tpu_torch (``fleet/weights.py``) held
against ray_tpu.fleet on the CPU.

Mirrors tests/test_fleet.py:306-335, :405-447 and :450 with the same spec
and seed 7, on LLAMA_TINY in fp32 (the reference's weights carried over
with ``params_from_numpy``): a base canary graded green and promoted
bitwise to every replica, with the greedy tokens, versions and payloads of
the reference; a seeded ``PREEMPT_ENGINE`` mid-canary that loses no
request while the promote still lands bitwise, in both packages; and
``set_pool_target`` with a base publish reaching every replica and a late
joiner, driven directly and through each package's ``FleetPoolActuator``.
Rollbacks are in tests/test_torch_fleet_rollback.py, the other fleet cases
in tests/test_torch_fleet.py.
"""

import concurrent.futures
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu import fleet as jfleet
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.obs.telemetry import SLOThresholds as JSLOThresholds
from ray_tpu_torch import chaos
from ray_tpu_torch import fleet as tfleet
from ray_tpu_torch.llm import EngineConfig, SamplingParams
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.obs.telemetry import SLOThresholds

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet]
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
PROMPT = [5, 9, 17, 3]
SEED = 7
LOOSE = dict(ttft_p_s=120, tpot_p_s=120, queue_wait_p_s=120)
PKG = {
    "ref": dict(fleet=jfleet, Config=JEngineConfig, SP=JSamplingParams, model=J_FP32_TINY,
                SLO=JSLOThresholds, chaos=jchaos),
    "port": dict(fleet=tfleet, Config=EngineConfig, SP=SamplingParams, model=FP32_TINY,
                 SLO=SLOThresholds, chaos=chaos),
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


def _manager(pkg, jp, replicas=None, cfg=None, thresholds=None):
    f = PKG[pkg]["fleet"]
    model = (f.ModelSpec("tiny", replicas=1, adapters=(f.AdapterSpec("styleA", rank=4),))
             if replicas is None else f.ModelSpec("tiny", replicas=replicas))
    spec = f.FleetSpec(models=(model,), tenants=(f.TenantSpec("gold", priority=2, weight=3.0),
                                                 f.TenantSpec("batch", priority=0, weight=1.0)))
    kw = dict(engine_config=cfg or _cfg(pkg), params={"tiny": _params(pkg, jp)}, seed=SEED,
              thresholds=thresholds or PKG[pkg]["SLO"](**LOOSE))
    if pkg == "port":
        kw["device"] = "cpu"
    return f.FleetManager(spec, **kw)


def _run(mgr, pkg, model, prompt=PROMPT, n=6):
    return list(mgr.collect(mgr.submit("gold", model, prompt, _greedy(pkg, n)),
                            timeout_s=120).output_token_ids)


def _both(fn):
    """Run ``fn(pkg)`` for the reference, then the port."""
    return fn("ref"), fn("port")


def _perturbed(params, factor=1.01):
    """Every leaf x factor, as numpy (both packages take numpy trees)."""
    if isinstance(tllama.sorted_leaves(params)[0], torch.Tensor):
        params = tllama.params_to_numpy(params)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) * np.asarray(factor, np.asarray(x).dtype), params)


def test_canary_base_promote_bitwise(jparams):
    def run(pkg):
        bitwise_equal = PKG[pkg]["fleet"].bitwise_equal
        mgr = _manager(pkg, jparams, replicas=3)
        try:
            reps = mgr.replicas("tiny")
            new = _perturbed(reps[0].engine.params)
            info = mgr.weights.begin_canary("tiny", params=new)
            canary = next(r for r in reps if r.tag == info["replica"])
            others = [r for r in reps if r.tag != info["replica"]]
            one = (bitwise_equal(canary.engine.params, new),
                   [bitwise_equal(r.engine.params, new) for r in others])
            outs = [_run(mgr, pkg, "tiny") for _ in range(6)]
            g = mgr.weights.canary_grade()
            rep = mgr.weights.decide(g["grade"])
            after = [bitwise_equal(r.engine.params, new) for r in reps]
            return (info, one, sorted(map(tuple, outs)), g["grade"], rep, after,
                    mgr.weights.versions[("tiny", None)], _run(mgr, pkg, "tiny"))
        finally:
            mgr.close()

    ref, got = _both(run)
    assert got == ref
    info, one, _, grade, rep, after, version, _ = got
    assert one == (True, [False, False]) and grade == "green"
    assert rep["outcome"] == "promoted" and after == [True] * 3 and version == info["version"]


def test_preempt_engine_mid_canary_zero_lost(jparams):
    def run(pkg):
        harness = PKG[pkg]["chaos"]
        mgr = _manager(pkg, jparams, replicas=2)
        sched = harness.install(harness.FaultSchedule(13, [
            harness.FaultSpec(harness.PREEMPT_ENGINE, site="llm.engine.step", start_after=6,
                              every_n=25, max_fires=2),
        ]))
        try:
            new = _perturbed(mgr.replicas("tiny")[0].engine.params)
            info = mgr.weights.begin_canary("tiny", params=new)

            def one(i):
                t = mgr.submit("gold", "tiny", PROMPT + [i], _greedy(pkg, 8))
                return mgr.collect(t, timeout_s=180)

            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                outs = list(ex.map(one, range(8)))
            fired = harness.PREEMPT_ENGINE in sched.fired_kinds()
            recoveries = sum(r.runner.num_recoveries for r in mgr.replicas("tiny"))
            rep = mgr.weights.promote()
            same = [PKG[pkg]["fleet"].bitwise_equal(r.engine.params, new)
                    for r in mgr.replicas("tiny")]
            return (info, fired, recoveries >= 1, len(outs),
                    all(o.finished and len(o.output_token_ids) == 8 for o in outs), rep, same)
        finally:
            harness.uninstall()
            mgr.close()

    ref, got = _both(run)
    assert got == ref
    assert got[1:5] == (True, True, 8, True)
    assert got[5]["outcome"] == "promoted" and got[6] == [True, True]


def test_set_pool_target_and_late_join(jparams):
    def run(pkg):
        mgr = _manager(pkg, jparams, replicas=1)
        try:
            assert mgr.pool_state()["tiny"]["replicas_running"] == 1
            assert mgr.set_pool_target("tiny", 3) == 3
            new = _perturbed(mgr.replicas("tiny")[0].engine.params)
            v = mgr.weights.publish_base("tiny", new)
            same = [PKG[pkg]["fleet"].bitwise_equal(r.engine.params, new)
                    for r in mgr.replicas("tiny")]
            # a late joiner streams the current version before serving
            assert mgr.set_pool_target("tiny", 4) == 4
            late = mgr.replicas("tiny")[-1]
            same.append(PKG[pkg]["fleet"].bitwise_equal(late.engine.params, new))
            assert mgr.set_pool_target("tiny", 1) == 1
            out = _run(mgr, pkg, "tiny")
            rows = mgr.stats()["models"]["tiny"]["replicas"]
            return v, same, late.engine.weight_version, out, [r["weight_version"] for r in rows]
        finally:
            mgr.close()

    ref, got = _both(run)
    assert got == ref
    assert got[1] == [True] * 4 and got[2] == 1


def test_set_pool_target_and_actuator(jparams):
    """tests/test_fleet.py:450 on both packages: ``FleetPoolActuator``
    grows the pool 1 -> 3, a base publish reaches all three, a scale-down
    decision drains it to 1, and the survivor serves the reference's greedy
    tokens."""
    def run(pkg):
        A = importlib.import_module("ray_tpu.autoscale" if pkg == "ref" else
                                    "ray_tpu_torch.autoscale")
        mgr = _manager(pkg, jparams, replicas=1)
        try:
            act = A.FleetPoolActuator(mgr)
            states = [act.pool_state()]
            act.apply(A.Decision(pool="tiny", action="scale_up", target=3, reason="test"))
            states.append(act.pool_state())
            new = _perturbed(mgr.replicas("tiny")[0].engine.params)
            mgr.weights.publish_base("tiny", new)
            same = [PKG[pkg]["fleet"].bitwise_equal(r.engine.params, new)
                    for r in mgr.replicas("tiny")]
            act.apply(A.Decision(pool="tiny", action="scale_down", target=1, reason="test"))
            states.append(act.pool_state())
            # a scale-to-zero decision keeps the fleet model's last replica
            act.apply(A.Decision(pool="tiny", action="scale_to_zero", target=0, reason="test"))
            states.append(act.pool_state())
            return states, same, _run(mgr, pkg, "tiny")
        finally:
            mgr.close()

    ref, got = _both(run)
    assert got == ref
    states, same, out = got
    assert [s["tiny"]["replicas_running"] for s in states] == [1, 3, 1, 1]
    assert same == [True] * 3 and len(out) == 6
