"""Weight publishing of ray_tpu_torch (``train/weight_sync.py``,
``LLMEngine.write_params`` / ``drop_prefix_cache`` / ``weight_version``,
``autoscale/coldstart.py``) held against the reference on the CPU.

On LLAMA_TINY in fp32, the reference's params carried over with
``params_from_numpy``, both packages run the same publishes: the leaf order
is ``jax.tree_util.tree_leaves``'; the greedy tokens before and after a
publish, after a stale and a corrupt drop, and across a swap between two
``step()`` calls with a request running, equal the reference's; the swap
leaves no pre-swap block in any tier (the reference's regression of
tests/test_llm_kvtier.py); ``stats()["weight_version"]`` and the cold
start's report equal the reference's. The port alone: the aliasing guard
(a publish of live params that the learner then steps is refused; a
snapshot is applied; a learner write that lands after the bundle was
received, before or during the copy, is refused too) and a mismatched bundle that raises before any byte
is written. Both chunk controllers are held at their initial length (their
choice follows host timing).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu.autoscale.coldstart import cold_start_engine as j_cold_start_engine
from ray_tpu.fabric.transport import _ENDPOINT_QUEUES as J_ENDPOINT_QUEUES
from ray_tpu.fabric.transport import DeviceTransport as JDeviceTransport
from ray_tpu.llm import pipeline as jpipeline
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.kvtier import KVTierConfig as JKVTierConfig
from ray_tpu.llm.kvtier import LocalPrefixIndex as JLocalPrefixIndex
from ray_tpu.llm.kvtier import chain_hashes as j_chain_hashes
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.train.weight_sync import WeightPublisher as JWeightPublisher
from ray_tpu.train.weight_sync import WeightSubscriber as JWeightSubscriber
from ray_tpu_torch import chaos
from ray_tpu_torch.autoscale import cold_start_engine, params_bitwise_equal
from ray_tpu_torch.fabric.transport import _ENDPOINT_QUEUES, DeviceTransport
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import pipeline as tpipeline
from ray_tpu_torch.llm.kvtier import KVTierConfig, LocalPrefixIndex, chain_hashes
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.train import TrainState, adamw, make_train_step
from ray_tpu_torch.train.weight_sync import (
    WeightPublisher,
    WeightSubscriber,
    WeightSyncError,
    snapshot,
    tree_leaves,
)

pytestmark = [pytest.mark.torch_port, pytest.mark.fabric]
torch.set_num_threads(2)

CPU = torch.device("cpu")
J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_llm_kvtier.py's configuration, for every engine here (one set
# of the reference's compiled programs)
BS = 16
ENGINE_KW = dict(num_blocks=16, block_size=BS, max_num_seqs=4, max_prefill_len=128)


@pytest.fixture(autouse=True)
def _pinned_chunk_controller(monkeypatch):
    for mod in (jpipeline, tpipeline):
        monkeypatch.setattr(mod.ChunkController, "note_chunk", lambda self, *a, **k: None)


def _greedy(cls=SamplingParams, n=10):
    return cls(max_tokens=n, temperature=0.0, ignore_eos=True)


def _jparams(key):
    return jllama.init_params(J_FP32_TINY, jax.random.key(key))


def _tparams(jp):
    """The port's params for a reference tree: a fresh copy each call (an
    engine writes its weights in place, so no two engines share one)."""
    return tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


@pytest.fixture(scope="module")
def trees():
    """Old and new weights of both packages (jax keys 0 and 42)."""
    return {"old": _jparams(0), "new": _jparams(42)}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [[int(x) for x in rng.integers(3, 120, rng.integers(8, 24))] for _ in range(4)]


def _engines(jp, **kw):
    cfg = {**ENGINE_KW, **kw}
    jeng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, **cfg), params=jp, seed=0)
    teng = LLMEngine(EngineConfig(model=FP32_TINY, **cfg), params=_tparams(jp), device="cpu")
    return jeng, teng


def _planes(ns):
    """A reference and a port publisher with a subscriber each, on one
    endpoint "e0" of each package's engine device."""
    jpub = JWeightPublisher(namespace=f"j-{ns}")
    tpub = WeightPublisher(namespace=f"t-{ns}", devices=[CPU])
    jtgt, ttgt = jpub.register_rollout("e0"), tpub.register_rollout("e0", device=CPU)
    return (jpub, jtgt, JWeightSubscriber(jpub.transport, "e0"),
            tpub, ttgt, WeightSubscriber(tpub.transport, "e0"))


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves_np(params):
    return [t.detach().numpy().copy() for t in tllama.sorted_leaves(params)]


# ---------------------------------------------------------------------------
# leaf order
# ---------------------------------------------------------------------------


def test_leaf_order_equals_jax_tree_leaves(trees):
    jp = trees["old"]
    ref = _leaves_np(jp)
    got = [t.numpy() for t in tree_leaves(_tparams(jp))]
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    # the insertion order of the train step's leaves is a different one
    from ray_tpu_torch.train.step import param_leaves

    shapes = [tuple(t.shape) for t in param_leaves(_tparams(jp))]
    assert shapes != [b.shape for b in ref]


# ---------------------------------------------------------------------------
# publish, stale drop, close (tests/test_fabric.py:705)
# ---------------------------------------------------------------------------


def test_publish_serves_new_weights_bitwise(trees, prompts):
    prompt = prompts[0]
    jeng, teng = _engines(trees["old"])
    fresh = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=_tparams(trees["new"]),
                      device="cpu").generate([prompt], _greedy())
    out = {}
    jpub, jtgt, jsub, tpub, ttgt, tsub = _planes("wsync")
    for pkg, eng, pub, tgt, sub, new in (
            ("ref", jeng, jpub, jtgt, jsub, trees["new"]),
            ("port", teng, tpub, ttgt, tsub, _tparams(trees["new"]))):
        sp = _greedy(JSamplingParams if pkg == "ref" else SamplingParams)
        before = eng.generate([prompt], sp)  # also warms the prefix cache
        assert pub.publish(new, [tgt]) == 1
        assert sub.apply_to_engine(eng) == 1
        after = eng.generate([prompt], sp)
        # an older (or equal) version landing late is dropped, never applied
        pub.publish(trees["old"] if pkg == "ref" else _tparams(trees["old"]), [tgt], version=1)
        assert sub.apply_to_engine(eng) is None
        late = eng.generate([prompt], sp)
        out[pkg] = (before, after, late, sub.num_stale_dropped, sub.num_applied, sub.version)
    assert out["port"] == out["ref"]
    assert out["port"][1] == fresh and out["port"][0] != fresh
    # bitwise residency: the engine holds the published leaves exactly
    for a, b in zip(_port_leaves_np(teng.params), _leaves_np(trees["new"])):
        np.testing.assert_array_equal(a, b)
    # close() removes the endpoints from the process-global plane
    for pub, sub in ((jpub, jsub), (tpub, tsub)):
        sub.close()
        pub.close()
    assert not any(ns == "j-wsync" for ns, _ in J_ENDPOINT_QUEUES)
    assert not any(ns == "t-wsync" for ns, _ in _ENDPOINT_QUEUES)


# ---------------------------------------------------------------------------
# corrupt bundle (tests/test_fabric.py:744)
# ---------------------------------------------------------------------------


def test_corrupt_bundle_dropped_not_applied(trees, prompts):
    jeng, teng = _engines(trees["old"])
    old = _port_leaves_np(teng.params)
    jpub, jtgt, jsub, tpub, ttgt, tsub = _planes("wsync-chaos")
    got = {}
    for pkg, eng, pub, tgt, sub, harness, new in (
            ("ref", jeng, jpub, jtgt, jsub, jchaos, trees["new"]),
            ("port", teng, tpub, ttgt, tsub, chaos, _tparams(trees["new"]))):
        sched = harness.install(harness.FaultSchedule(11, [
            harness.FaultSpec("corrupt_device_transfer", site="disagg.kv_transfer", max_fires=1),
        ]))
        try:
            pub.publish(new, [tgt])
            assert sub.apply_to_engine(eng) is None
            counts = (sub.num_corrupt_dropped, sub.num_applied)
            if pkg == "port":  # the engine keeps serving the old weights
                for a, b in zip(_port_leaves_np(teng.params), old):
                    np.testing.assert_array_equal(a, b)
            # the retry (fault budget burned) applies cleanly
            v = pub.publish(new, [tgt])
            assert sub.apply_to_engine(eng) == v
            got[pkg] = (counts, v, sched.fired_kinds(),
                        eng.generate([prompts[1]], _greedy(
                            JSamplingParams if pkg == "ref" else SamplingParams)))
        finally:
            harness.uninstall()
            pub.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == (1, 0)


# ---------------------------------------------------------------------------
# the swap invalidates every tier (tests/test_llm_kvtier.py:304)
# ---------------------------------------------------------------------------

SYS = [int(x) for x in np.random.RandomState(0).randint(3, 200, size=5 * BS)]


def _suffix(seed, n=BS):
    return [int(x) for x in np.random.RandomState(seed).randint(3, 200, size=n)]


def _gen(eng, prompt, sp, rid):
    eng.add_request(prompt, sp, request_id=rid)
    if getattr(eng, "kvfetch", None) is not None:
        assert eng.kvfetch.wait_idle(30)
    toks = cached = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished and o.request_id == rid:
                toks, cached = list(o.output_token_ids), o.num_cached_tokens
    return toks, cached


def _tier_scenario(pkg, trees):
    if pkg == "ref":
        eng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, kvtier=JKVTierConfig(), **ENGINE_KW),
                         params=trees["old"], seed=0)
        idx, hashes, sp_cls = JLocalPrefixIndex(), j_chain_hashes, JSamplingParams
        pub = JWeightPublisher(transport=JDeviceTransport(namespace="j-swap-tiers"))
        new = trees["new"]
    else:
        eng = LLMEngine(EngineConfig(model=FP32_TINY, kvtier=KVTierConfig(), **ENGINE_KW),
                        params=_tparams(trees["old"]), device="cpu")
        idx, hashes, sp_cls = LocalPrefixIndex(), chain_hashes, SamplingParams
        pub = WeightPublisher(transport=DeviceTransport(namespace="t-swap-tiers", devices=[CPU]))
        new = _tparams(trees["new"])
    sp = sp_cls(max_tokens=8, temperature=0.0)
    try:
        eng.kvtier.attach_index(idx, engine_key="e0")
        _gen(eng, SYS + _suffix(1), sp, "warm")
        for i in range(4):  # push the shared prefix out of HBM
            _gen(eng, [int(x) for x in np.random.RandomState(100 + i).randint(3, 200, size=112)],
                 sp_cls(max_tokens=4, temperature=0.0), f"fill-{i}")
        assert eng.kvtier.flush_spills()
        assert eng.kvtier.stats()["host"]["entries"] > 0
        eng.kvtier.flush_index(force=True)
        assert idx.lookup(hashes(SYS, BS))["engines"]  # indexed pre-swap
        target = pub.register_rollout("e0")
        sub = (JWeightSubscriber if pkg == "ref" else WeightSubscriber)(pub.transport, "e0")
        pub.publish(new, [target])
        assert sub.apply_to_engine(eng) == 1
        st = eng.kvtier.stats()
        indexed = bool(idx.lookup(hashes(SYS, BS))["engines"])
        before = dict(eng.kvtier.resurrected_tokens)
        toks, cached = _gen(eng, SYS + _suffix(2), sp, "post-swap")
        return {"host": st["host"]["entries"], "object": st["object"]["entries"],
                "indexed": indexed, "resurrected": dict(eng.kvtier.resurrected_tokens) == before,
                "tokens": toks, "cached": cached, "by_tier": eng.stats()["prefix_cache"]["by_tier"]}
    finally:
        pub.close()
        if pkg == "ref":
            eng.kvfetch.close()
            eng.kvtier.stop()
        else:
            eng.close()


def test_swap_invalidates_every_tier(trees):
    ref, got = _tier_scenario("ref", trees), _tier_scenario("port", trees)
    assert got == ref
    assert got["host"] == got["object"] == 0 and not got["indexed"]
    assert got["resurrected"] and got["cached"] == 0
    fresh = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=_tparams(trees["new"]),
                      device="cpu")
    assert _gen(fresh, SYS + _suffix(2), SamplingParams(max_tokens=8, temperature=0.0),
                "post-swap")[0] == got["tokens"]


# ---------------------------------------------------------------------------
# weight_version (tests/test_rl_post_train.py:271); a swap mid-request
# ---------------------------------------------------------------------------


def test_weight_version_in_stats(trees):
    jeng, teng = _engines(trees["old"])
    jpub, jtgt, jsub, tpub, ttgt, tsub = _planes("wv")
    try:
        assert teng.stats()["weight_version"] == jeng.stats()["weight_version"] == 0
        assert jpub.publish(trees["new"], [jtgt], version=5) == 5
        assert tpub.publish(_tparams(trees["new"]), [ttgt], version=5) == 5
        assert jsub.apply_to_engine(jeng) == tsub.apply_to_engine(teng) == 5
        assert teng.stats()["weight_version"] == jeng.stats()["weight_version"] == 5
        assert tsub.stats() == {**jsub.stats(), "num_mutated_dropped": 0}
    finally:
        jpub.close()
        tpub.close()


@pytest.mark.parametrize("pipelined", [True, False])
def test_swap_between_steps_with_a_request_running(trees, prompts, pipelined):
    jeng, teng = _engines(trees["old"], pipeline_decode=pipelined)
    jpub, jtgt, jsub, tpub, ttgt, tsub = _planes(f"mid-{pipelined}")
    got = {}
    try:
        for pkg, eng, pub, tgt, sub, new, sp_cls in (
                ("ref", jeng, jpub, jtgt, jsub, trees["new"], JSamplingParams),
                ("port", teng, tpub, ttgt, tsub, _tparams(trees["new"]), SamplingParams)):
            for i, p in enumerate(prompts[:3]):
                eng.add_request(p, _greedy(sp_cls, 16), request_id=f"m{i}")
            finals, steps = {}, 0
            while eng.has_unfinished():
                for o in eng.step():
                    if o.finished:
                        finals[o.request_id] = list(o.output_token_ids)
                steps += 1
                if steps == 3:
                    pub.publish(new, [tgt])
                    assert sub.apply_to_engine(eng) == 1
            got[pkg] = finals
    finally:
        jpub.close()
        tpub.close()
    assert got["port"] == got["ref"] and len(got["port"]) == 3


# ---------------------------------------------------------------------------
# the port alone: the aliasing guard, a mismatched bundle
# ---------------------------------------------------------------------------


def _trainer(jp):
    params = _tparams(jp)
    state = TrainState.create(params, adamw(1e-2))
    step = make_train_step(lambda p, b: tllama.loss_and_weight_fn(p, b, FP32_TINY), None)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, FP32_TINY.vocab_size, size=(2, 17)).astype(np.int64))
    return state, step, {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _port_engine(jp):
    return LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=_tparams(jp), device="cpu")


def test_live_publish_then_step_is_refused_snapshot_is_applied(trees):
    teng = _port_engine(trees["new"])
    state, step, batch = _trainer(trees["old"])
    pub = WeightPublisher(namespace="t-alias", devices=[CPU])
    try:
        tgt = pub.register_rollout("e0", device=CPU)
        sub = WeightSubscriber(pub.transport, "e0")
        before = _port_leaves_np(teng.params)
        # the live tree, then a step that writes it in place: refused
        pub.publish(state.params, [tgt])
        state, _ = step(state, batch)
        assert sub.apply_to_engine(teng) is None
        assert sub.num_mutated_dropped == 1 and sub.num_applied == 0
        for a, b in zip(_port_leaves_np(teng.params), before):
            np.testing.assert_array_equal(a, b)
        # a snapshot is the learner's own copy: the next step leaves it whole
        snap = snapshot(state.params)
        pub.publish(snap, [tgt])
        state, _ = step(state, batch)
        assert sub.apply_to_engine(teng) == 2
        assert params_bitwise_equal(snap, teng.params)
        assert not params_bitwise_equal(state.params, teng.params)
        assert sub.num_mutated_dropped == 1 and sub.num_corrupt_dropped == 0
    finally:
        pub.close()


@pytest.mark.parametrize("when", ["before_copy", "during_copy"])
def test_learner_write_after_receipt_is_refused(trees, monkeypatch, when):
    """A learner on another thread writes a published leaf after the
    subscriber drained and verified the bundle: just before the copy (the
    apply is refused, the engine untouched) or while the copy runs (the
    apply raises, nothing reports the new version). Both are counted, and
    the next publish of a snapshot applies whole."""
    teng = _port_engine(trees["old"])
    live = _tparams(trees["new"])
    pub = WeightPublisher(namespace=f"t-race-{when}", devices=[CPU])
    try:
        tgt = pub.register_rollout("e0", device=CPU)
        sub = WeightSubscriber(pub.transport, "e0")
        before = _port_leaves_np(teng.params)

        def learner_writes():
            with torch.no_grad():
                tree_leaves(live)[0].add_(1.0)

        if when == "before_copy":
            poll = sub._poll_bundle

            def poll_then_write(timeout_s):
                b = poll(timeout_s)
                learner_writes()
                return b

            monkeypatch.setattr(sub, "_poll_bundle", poll_then_write)
        else:
            write = teng.write_params

            def write_racing_learner(leaves):
                write(leaves)
                learner_writes()

            monkeypatch.setattr(teng, "write_params", write_racing_learner)
        pub.publish(live, [tgt])
        if when == "before_copy":
            assert sub.apply_to_engine(teng) is None
            for a, b in zip(_port_leaves_np(teng.params), before):
                np.testing.assert_array_equal(a, b)
        else:
            with pytest.raises(WeightSyncError, match="while it was copied"):
                sub.apply_to_engine(teng)
        assert sub.num_mutated_dropped == 1 and sub.num_applied == 0
        assert sub.version == 0 and teng.weight_version == 0
        monkeypatch.undo()
        snap = snapshot(live)
        pub.publish(snap, [tgt])
        assert sub.apply_to_engine(teng) == 2
        assert params_bitwise_equal(snap, teng.params)
        assert sub.num_mutated_dropped == 1 and teng.weight_version == 2
    finally:
        pub.close()


@pytest.mark.parametrize("fault", ["count", "shape"])
def test_mismatched_bundle_raises_before_any_write(trees, fault):
    jeng, teng = _engines(trees["old"])
    before = _port_leaves_np(teng.params)
    jnew = _leaves_np(trees["new"])
    tnew = tree_leaves(_tparams(trees["new"]))
    if fault == "count":
        jnew, tnew = jnew[:-1], tnew[:-1]
    else:  # the last leaf alone has the wrong shape
        tnew[-1] = tnew[-1][..., :-1].contiguous()
    jpub, jtgt, jsub, tpub, ttgt, tsub = _planes(f"bad-{fault}")
    try:
        tpub.publish(tnew, [ttgt])
        with pytest.raises(WeightSyncError):
            tsub.apply_to_engine(teng)
        for a, b in zip(_port_leaves_np(teng.params), before):
            np.testing.assert_array_equal(a, b)  # the first leaves untouched too
        assert teng.weight_version == 0
        if fault == "count":  # the reference raises on a count mismatch too
            jpub.publish(jnew, [jtgt])
            with pytest.raises(Exception, match="leaves"):
                jsub.apply_to_engine(jeng)
    finally:
        jpub.close()
        tpub.close()


# ---------------------------------------------------------------------------
# cold start
# ---------------------------------------------------------------------------


def test_cold_start_report_equals_reference(trees, prompts):
    jpub = JWeightPublisher(namespace="j-cold")
    tpub = WeightPublisher(namespace="t-cold", devices=[CPU])
    try:
        jpub.publish(trees["new"], [], version=3)
        tnew = _tparams(trees["new"])
        tpub.publish(tnew, [], version=3)
        jeng, jrep = j_cold_start_engine(
            lambda: JLLMEngine(JEngineConfig(model=J_FP32_TINY, **ENGINE_KW),
                               params=trees["old"], seed=0),
            jpub, "cold0", reference_params=trees["new"])
        teng, trep = cold_start_engine(
            lambda: LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW),
                              params=_tparams(trees["old"]), device="cpu"),
            tpub, "cold0", reference_params=tnew)
        assert (trep.weight_version, trep.bitwise_identical) == \
            (jrep.weight_version, jrep.bitwise_identical) == (3, True)
        assert trep.pool == jrep.pool and trep.seconds > 0
        assert teng.stats()["weight_version"] == jeng.stats()["weight_version"] == 3
        assert teng.generate(prompts[:2], _greedy()) == jeng.generate(
            prompts[:2], _greedy(JSamplingParams))
        # the verdict is on the engine's bytes: a different tree fails it
        assert not params_bitwise_equal(_tparams(trees["old"]), teng.params)
    finally:
        jpub.close()
        tpub.close()
