"""The fleet's canary rollbacks in ray_tpu_torch (``fleet/weights.py``)
held against ray_tpu.fleet on the CPU.

Mirrors tests/test_fleet.py:338-400 with the same spec and seed 7, on
LLAMA_TINY in fp32 (the reference's weights carried over with
``params_from_numpy``): a red canary rolled back bitwise to the retained
weights, and an adapter canary whose swap drops only its own prefix chains
and whose rollback restores the v1 adapter, each with the greedy tokens,
grades, versions and payloads of the reference. Promotes are in
tests/test_torch_fleet_canary.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import fleet as jfleet
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.obs.telemetry import SLOThresholds as JSLOThresholds
from ray_tpu_torch import fleet as tfleet
from ray_tpu_torch.llm import EngineConfig, SamplingParams
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.obs.telemetry import SLOThresholds
from ray_tpu_torch.train.weight_sync import snapshot

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet]
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
PROMPT = [5, 9, 17, 3]
SEED = 7
LOOSE = dict(ttft_p_s=120, tpot_p_s=120, queue_wait_p_s=120)
PKG = {
    "ref": dict(fleet=jfleet, Config=JEngineConfig, SP=JSamplingParams, model=J_FP32_TINY,
                SLO=JSLOThresholds),
    "port": dict(fleet=tfleet, Config=EngineConfig, SP=SamplingParams, model=FP32_TINY,
                 SLO=SLOThresholds),
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


def test_canary_red_rolls_back_bitwise(jparams):
    red = dict(ttft_p_s=1e-9, tpot_p_s=1e-9, queue_wait_p_s=1e-9, yellow_factor=1.0)

    def run(pkg):
        bitwise_equal = PKG[pkg]["fleet"].bitwise_equal
        mgr = _manager(pkg, jparams, replicas=2, thresholds=PKG[pkg]["SLO"](**red))
        try:
            reps = mgr.replicas("tiny")
            old = (jax.tree_util.tree_map(np.asarray, reps[0].engine.params) if pkg == "ref"
                   else snapshot(reps[0].engine.params))
            ref_out = _run(mgr, pkg, "tiny")
            mgr.weights.begin_canary("tiny", params=_perturbed(old, 1.5))
            for _ in range(4):
                _run(mgr, pkg, "tiny")
            rep = mgr.weights.decide()
            back = [bitwise_equal(r.engine.params, old) for r in reps]
            outs = {tuple(_run(mgr, pkg, "tiny")) for _ in range(4)}
            return rep, back, outs, ref_out
        finally:
            mgr.close()

    ref, got = _both(run)
    assert got == ref
    rep, back, outs, ref_out = got
    assert rep["outcome"] == "rolled_back" and back == [True, True] and outs == {tuple(ref_out)}


def test_canary_adapter_rollback_scoped_drop(jparams):
    def run(pkg):
        mgr = _manager(pkg, jparams, cfg=_cfg(pkg, enable_prefix_caching=True, block_size=4))
        try:
            mgr.register_adapter("tiny", "styleA", _adapters(1))
            prompt = list(range(3, 19))
            base_out = _run(mgr, pkg, "tiny", prompt)
            v1_out = _run(mgr, pkg, "tiny:styleA", prompt)
            eng = mgr.replicas("tiny")[0].engine
            probes = [eng.allocator.probe_prefix(prompt, 0)]
            info = mgr.weights.begin_canary("tiny", adapter_id="styleA", payload=_adapters(2))
            probes.append(eng.allocator.probe_prefix(prompt, 0))  # base chains survive
            v2_out = _run(mgr, pkg, "tiny:styleA", prompt)
            rb = mgr.weights.rollback()
            probes.append(eng.allocator.probe_prefix(prompt, 0))
            back = _run(mgr, pkg, "tiny:styleA", prompt)
            base_again = _run(mgr, pkg, "tiny", prompt)
            return (base_out, v1_out, v2_out, back, base_again, info, rb, probes,
                    mgr.weights.stats())
        finally:
            mgr.close()

    ref, got = _both(run)
    assert got == ref
    base_out, v1_out, v2_out, back, base_again, _, rb, probes, _ = got
    assert v2_out != v1_out and back == v1_out and base_again == base_out
    assert rb["outcome"] == "rolled_back" and min(probes) > 0
