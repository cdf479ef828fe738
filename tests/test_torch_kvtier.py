"""The tiered KV cache of ray_tpu_torch (``llm/kvtier``) held against
ray_tpu.llm.kvtier on the CPU.

On LLAMA_TINY in fp32 with the reference's test configuration
(``tests/test_llm_kvtier.py``: 16 blocks of 16, an 80-token system prefix,
``_fill_to_evict``), both packages run the same prompts on the same weights:
greedy tokens, ``num_cached_tokens``, ``peek_prefix_tiered``,
``stats()["prefix_cache"]`` (with ``by_tier``) and the ``kv_tiers`` counts
equal the reference's, and a spilled block's pages equal the reference's
within 2e-5, for the host and the object tier, a corrupt and a dropped
spill, and mid-chain adoption. The other cases of the reference's file run
on the port alone (the GCS and serve ones wait for B8): seeded identity,
the mid-gather probe, re-spill accounting, the index flush retry,
invalidation, the index's staleness, ``best_prefix_replica``, the
orchestrator's prefix-aware picks (against the reference orchestrator's),
metrics, and the pinned-slab slot lifecycle.
"""

import dataclasses
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu.cluster.prefix_index import PrefixIndexStore as JPrefixIndexStore
from ray_tpu.llm.disagg import DisaggConfig as JDisaggConfig
from ray_tpu.llm.disagg import DisaggOrchestrator as JDisaggOrchestrator
from ray_tpu.llm.disagg.handoff import KVHandoff as JKVHandoff
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.kvtier import KVTierConfig as JKVTierConfig
from ray_tpu.llm.kvtier.index import best_prefix_replica as j_best_prefix_replica
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch import chaos
from ray_tpu_torch.core.object_store import ObjectStore, deserialize
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator, KVHandoff
from ray_tpu_torch.llm.kvtier import (
    GcsPrefixIndex,
    KVTierConfig,
    LocalPrefixIndex,
    PrefixIndexStore,
    best_prefix_replica,
    chain_hashes,
)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util.metrics import registry_snapshot

pytestmark = [pytest.mark.torch_port, pytest.mark.kvtier]
torch.set_num_threads(2)

BS = 16
SYS = [int(x) for x in np.random.RandomState(0).randint(3, 200, size=5 * BS)]  # 80 tokens
J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(num_blocks=16, block_size=BS, max_num_seqs=4, max_prefill_len=128)
BAND = 2e-5
# the kv_tiers counts held equal to the reference's (timings, the slab and
# the wall-time percentile are the port's own or host-timed)
COUNT_KEYS = ("host", "object", "spilled_bytes_total", "resurrected_tokens", "corrupt_dropped",
              "spills_dropped", "evicted_blocks", "fetch_served")
TIER_THREADS = ("kvtier-spill", "kvfetch")


def _suffix(seed, n=BS):
    return [int(x) for x in np.random.RandomState(seed).randint(3, 200, size=n)]


def _fill_prompts():
    return [[int(x) for x in np.random.RandomState(100 + i).randint(3, 200, size=112)]
            for i in range(4)]


@pytest.fixture(autouse=True)
def _no_tier_thread_outlives_a_test():
    # tier threads that an earlier test file left in this process (the
    # reference's engines name theirs alike) are not this test's to join
    before = set(threading.enumerate())
    yield
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(TIER_THREADS) and t.is_alive() and t not in before]
    assert not alive, alive


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


def _close(eng):
    # both packages' engines: the port's close(), the reference's two stops
    if isinstance(eng, LLMEngine):
        eng.close()
    elif getattr(eng, "kvtier", None) is not None:
        eng.kvfetch.close()
        eng.kvtier.stop()


@pytest.fixture
def engines(weights):
    """Factory of tiered engines of either package, each closed when the
    test ends."""
    made = []

    def make(pkg="port", kvtier=True, **kw):
        if pkg == "port":
            eng = LLMEngine(EngineConfig(model=FP32_TINY, kvtier=kvtier, **{**ENGINE_KW, **kw}),
                            params=weights[1], device="cpu")
        else:
            if isinstance(kvtier, KVTierConfig):
                kvtier = JKVTierConfig(**{f.name: getattr(kvtier, f.name)
                                          for f in dataclasses.fields(kvtier)})
            eng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, kvtier=kvtier, **{**ENGINE_KW, **kw}),
                             params=weights[0], seed=0)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        _close(eng)


def _sp(pkg, **kw):
    return (SamplingParams if pkg == "port" else JSamplingParams)(**kw)


def _gen(eng, prompt, sp, rid, wait=True):
    """One request to completion under a pinned id; with ``wait`` the
    prefetch worker drains first (the deterministic 'it waited in the queue')."""
    eng.add_request(prompt, sp, request_id=rid)
    if wait and getattr(eng, "kvfetch", None) is not None:
        assert eng.kvfetch.wait_idle(30)
    toks = cached = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished and o.request_id == rid:
                toks, cached = list(o.output_token_ids), o.num_cached_tokens
    assert toks is not None
    return toks, cached


def _settle(eng):
    """Every queued spill inserted: the pending queue drained and no gather
    in flight (the reference's ``flush_spills`` returns once the queue is
    empty, while its worker may still be inserting)."""
    mgr = eng.kvtier
    assert mgr.flush_spills(), "pending spills did not drain"
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        with mgr._lock:
            if not mgr._gathering and not mgr._pending:
                return
        time.sleep(0.002)
    raise AssertionError("a spill gather did not finish")


def _fill_to_evict(eng, pkg):
    for i, p in enumerate(_fill_prompts()):
        _gen(eng, p, _sp(pkg, max_tokens=4, temperature=0.0), f"fill-{i}")
    if eng.kvtier is not None:
        _settle(eng)


def _pages(eng, h):
    got = eng.kvtier.get(h)
    assert got is not None
    k, v = got[1].handoff.k_pages, got[1].handoff.v_pages
    # copies: a host-tier block's pages are views of a slab slot, valid while
    # the block is held
    as_np = (lambda t: t.numpy().copy()) if isinstance(k, torch.Tensor) else np.array
    return as_np(k), as_np(v)


def _counts(st):
    return {k: st[k] for k in COUNT_KEYS}


def _scenario(make, pkg, kvtier=True, schedule=None, evict=None):
    """Warm the shared prefix, push it out of HBM, then serve a prompt that
    shares it. Returns what the two packages must agree on."""
    eng = make(pkg, kvtier=kvtier)
    sp = _sp(pkg, max_tokens=8, temperature=0.0)
    harness = chaos if pkg == "port" else jchaos
    if schedule is not None:
        harness.install(schedule)
    try:
        _gen(eng, SYS + _suffix(1), sp, "warm")
        if evict is None:
            _fill_to_evict(eng, pkg)
        else:
            evict(eng)
        mgr = eng.kvtier
        with mgr._lock:
            first = next(iter(mgr._host), None) or next(iter(mgr._obj), None)
        pages = _pages(eng, first) if first is not None else None
        peek = eng.peek_prefix_tiered(SYS + _suffix(2))
        toks, cached = _gen(eng, SYS + _suffix(2), sp, "the-req")
        _settle(eng)  # the-req's own evictions spilled
    finally:
        if schedule is not None:
            harness.uninstall()
    st = eng.stats()
    return {"tokens": toks, "cached": cached, "peek": peek, "pages": pages, "first": first,
            "prefix_cache": st["prefix_cache"], "kv_tiers": _counts(st["kv_tiers"]),
            "prefetch": st["kv_tiers"]["fetch"]["prefetch"]}


def _two_evictions(eng):
    """Exactly two LRU evictions: the chain's head spills, its tail stays."""
    alloc = eng.allocator
    taken = alloc.allocate(len(alloc._free) + 2)
    alloc.free(taken)
    _settle(eng)


def _schedule(pkg, kind):
    mod = chaos if pkg == "port" else jchaos
    return mod.FaultSchedule(7, [mod.FaultSpec(kind, site="llm.kvtier.spill", max_fires=1000)])


CASES = {
    "host": dict(kvtier=True),
    "object": dict(kvtier=KVTierConfig(host_bytes=1, object_bytes=256 << 20)),
    "corrupt_spill": dict(schedule="corrupt_kv_transfer"),
    "dropped_spill": dict(schedule="drop_kv_transfer"),
    "mid_chain_adoption": dict(evict=_two_evictions),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spill_resurrect_parity_with_reference(engines, case):
    kw = dict(CASES[case])
    got = {}
    for pkg in ("ref", "port"):
        run = dict(kw)
        if "schedule" in run:
            run["schedule"] = _schedule(pkg, run["schedule"])
        got[pkg] = _scenario(engines, pkg, **run)
    ref, port = got["ref"], got["port"]
    assert port["tokens"] == ref["tokens"]
    assert port["cached"] == ref["cached"]
    assert port["peek"]["n_tokens"] == ref["peek"]["n_tokens"]
    assert port["peek"]["by_tier"] == ref["peek"]["by_tier"]
    assert port["peek"]["discounted"] == pytest.approx(ref["peek"]["discounted"])
    assert port["prefix_cache"] == ref["prefix_cache"]
    assert port["kv_tiers"] == ref["kv_tiers"]
    assert port["prefetch"] == ref["prefetch"]
    assert port["first"] == ref["first"]
    if ref["pages"] is not None and case != "corrupt_spill":
        for a, b in zip(port["pages"], ref["pages"]):
            np.testing.assert_allclose(a, b, atol=BAND, rtol=0)
    # and each case's tokens are the cold prefill's (never wrong tokens)
    cold, _ = _gen(engines("port", kvtier=None), SYS + _suffix(2),
                   SamplingParams(max_tokens=8, temperature=0.0), "the-req")
    assert port["tokens"] == cold
    tiers = port["kv_tiers"]
    if case == "host":
        assert port["prefix_cache"]["by_tier"].get("host", 0) >= len(SYS)
        assert port["cached"] >= len(SYS)
    elif case == "object":
        assert port["prefix_cache"]["by_tier"].get("object", 0) >= len(SYS)
    elif case == "corrupt_spill":
        assert tiers["corrupt_dropped"]["host"] >= 1
        assert port["prefix_cache"]["by_tier"].get("host", 0) == 0
    elif case == "dropped_spill":
        assert tiers["spills_dropped"] > 0 and tiers["host"]["entries"] == 0
    else:
        assert port["prefix_cache"]["by_tier"]["host"] == 2 * BS
        assert port["prefix_cache"]["by_tier"]["hbm"] >= 3 * BS


def test_seeded_identity_object_tier(engines):
    """A seeded request resurrected from the object tier gives a cold
    prefill's tokens (seeded streams hold within the port)."""
    sp = SamplingParams(max_tokens=8, temperature=1.0, seed=1234, top_k=5)
    kvt = KVTierConfig(host_bytes=1, object_bytes=256 << 20)
    eng = engines(kvtier=kvt)
    _gen(eng, SYS + _suffix(1), sp, "warm")
    _fill_to_evict(eng, "port")
    assert eng.kvtier.stats()["object"]["entries"] > 0
    warm, cached = _gen(eng, SYS + _suffix(2), sp, "the-req")
    assert eng.stats()["prefix_cache"]["by_tier"].get("object", 0) >= len(SYS)
    cold, _ = _gen(engines(kvtier=kvt), SYS + _suffix(2), sp, "the-req")
    assert warm == cold and cached >= len(SYS)


def test_default_config_has_both_tiers(engines):
    """``kvtier=True`` is KVTierConfig()'s defaults: a 64 MiB host slab and a
    256 MiB object tier behind it."""
    eng = engines(kvtier=True)
    st = eng.kvtier.stats()
    assert st["host"]["capacity_bytes"] == 64 << 20
    assert st["object"]["capacity_bytes"] == 256 << 20
    assert st["slab"]["bytes"] <= 64 << 20
    assert st["slab"]["slots"] == (64 << 20) // eng.kvtier.block_nbytes


def test_probe_counts_mid_gather_spill_as_host_resident(engines, monkeypatch):
    """A probe landing while the spill worker is inside its gather reads the
    spilled head as host-resident (``get`` would wait and serve it)."""
    eng = engines()
    _gen(eng, SYS + _suffix(1), SamplingParams(max_tokens=8, temperature=0.0), "warm")
    mgr = eng.kvtier
    hold, entered = threading.Event(), threading.Event()
    real = type(mgr)._gather

    def slow_gather(self, entries):
        entered.set()
        hold.wait(timeout=10.0)  # pin the worker inside the gather
        return real(self, entries)

    monkeypatch.setattr(type(mgr), "_gather", slow_gather)
    try:
        alloc = eng.allocator
        taken = alloc.allocate(len(alloc._free) + 2)
        alloc.free(taken)
        assert entered.wait(timeout=5.0)
        assert eng.peek_prefix_tiered(SYS + _suffix(2))["by_tier"].get("host", 0) == 2 * BS
    finally:
        hold.set()
    assert mgr.flush_spills()
    assert eng.peek_prefix_tiered(SYS + _suffix(2))["by_tier"].get("host", 0) == 2 * BS


def test_respill_does_not_double_count_tier_bytes(engines):
    eng = engines()
    _gen(eng, SYS + _suffix(1), SamplingParams(max_tokens=4, temperature=0.0), "warm")
    _fill_to_evict(eng, "port")
    mgr = eng.kvtier
    h, sb = next(iter(mgr._host.items()))
    before = mgr._host_bytes
    mgr._host_insert(h, sb)
    assert mgr._host_bytes == before
    mgr._object_insert(h, sb)
    obj_before = mgr._obj_bytes
    mgr._object_insert(h, sb)
    assert mgr._obj_bytes == obj_before
    assert mgr._store.stats()["num_objects"] == len(mgr._obj)
    # the object copy round-trips the pages exactly, as plain host bytes
    with mgr._lock:
        oid = mgr._obj[h][0]
    back = deserialize(*mgr._store.serialized_get(oid))
    assert torch.equal(back.handoff.k_pages, sb.handoff.k_pages)
    assert back.handoff.verify() and back.tokens == sb.tokens


def test_flush_index_retries_after_failed_publish(engines):
    class FlakyIndex:
        def __init__(self):
            self.fail, self.updates = True, []

        def update(self, payload):
            if self.fail:
                return False
            self.updates.append(payload)
            return True

    eng = engines()
    _gen(eng, SYS + _suffix(1), SamplingParams(max_tokens=4, temperature=0.0), "warm")
    idx, mgr = FlakyIndex(), eng.kvtier
    mgr.index, mgr.engine_key, mgr._index_dirty = idx, "e0", True
    mgr.flush_index(force=True)
    assert mgr._index_dirty and not idx.updates
    idx.fail = False
    mgr.flush_index(force=True)
    assert not mgr._index_dirty and len(idx.updates) == 1
    mgr._index_refresh_next = mgr._index_next = 0.0
    mgr.flush_index()
    assert len(idx.updates) == 2 and idx.updates[1]["seq"] > idx.updates[0]["seq"]


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.clone()) for k, v in tree.items()}


def _copy_into(dst, src):
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])


def test_invalidation_drops_every_tier_and_serves_new_weights(weights):
    """A weight swap (new params written in place, then the allocator's
    drop) empties every tier and the engine's index rows; the next request
    resurrects nothing and matches an engine built on the new weights."""
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    eng = LLMEngine(EngineConfig(model=FP32_TINY, kvtier=True, **ENGINE_KW),
                    params=_clone(weights[1]), device="cpu")
    try:
        _swap_case(eng, sp)
    finally:
        eng.close()


def _swap_case(eng, sp):
    idx = LocalPrefixIndex()
    eng.kvtier.attach_index(idx, engine_key="e0")
    _gen(eng, SYS + _suffix(1), sp, "warm")
    _fill_to_evict(eng, "port")
    assert eng.kvtier.stats()["host"]["entries"] > 0
    eng.kvtier.flush_index(force=True)
    assert idx.lookup(chain_hashes(SYS, BS))["engines"]
    new = tllama.init_params(FP32_TINY, torch.Generator().manual_seed(99), "cpu",
                             dtype=torch.float32)
    with torch.no_grad():
        _copy_into(eng.params, new)
    eng.allocator.drop_prefix_cache()
    st = eng.kvtier.stats()
    assert st["host"]["entries"] == 0 and st["object"]["entries"] == 0
    assert not idx.lookup(chain_hashes(SYS, BS))["engines"]
    before = dict(eng.kvtier.resurrected_tokens)
    warm, cached = _gen(eng, SYS + _suffix(2), sp, "post-swap")
    assert dict(eng.kvtier.resurrected_tokens) == before and cached == 0
    fresh = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=new, device="cpu")
    assert warm == _gen(fresh, SYS + _suffix(2), sp, "post-swap")[0]


def test_recover_rebuild_rebinds_listeners(engines):
    """``recover(rebuild_kv=True)`` gives the tier manager the new
    allocator: the spilled prefix still resurrects, and later evictions
    still spill."""
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    eng = engines()
    _gen(eng, SYS + _suffix(1), sp, "warm")
    _fill_to_evict(eng, "port")
    eng.recover(rebuild_kv=True)
    assert eng.allocator.evict_listener == eng.kvtier.on_evict
    toks, cached = _gen(eng, SYS + _suffix(2), sp, "the-req")
    assert cached >= len(SYS)
    cold, _ = _gen(engines(kvtier=None), SYS + _suffix(2), sp, "the-req")
    assert toks == cold
    spilled = eng.kvtier.stats()["spilled_bytes_total"]["host"]
    _fill_to_evict(eng, "port")
    assert eng.kvtier.stats()["spilled_bytes_total"]["host"] > spilled


def test_slab_slots_return_on_promotion_and_eviction(engines):
    """Host-tier pages live in slab slots: every resident entry holds one,
    promotion and LRU eviction give it back, and the slab never grows."""
    kvt = KVTierConfig(host_bytes=4 * 2 * 2 * 2 * BS * 16 * 4, object_bytes=0)
    eng = engines(kvtier=kvt)
    slab = eng.kvtier._slab
    assert slab.n_slots == 4
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    _gen(eng, SYS + _suffix(1), sp, "warm")
    _fill_to_evict(eng, "port")
    st = eng.kvtier.stats()
    assert st["host"]["entries"] == 4 and st["slab"]["free"] == 0
    assert st["evicted_blocks"] > 0 and st["slab"]["reused"] > 0 and st["slab"]["misses"] == 0
    data_ptr = slab.buf.data_ptr()
    eng.kvtier.invalidate_all()
    assert eng.kvtier.stats()["slab"]["free"] == 4
    assert slab.buf.data_ptr() == data_ptr


def test_tier_tables_consistent_under_concurrent_threads(engines):
    """Stress, bounded in time: 8 threads (more than the cores the tests
    get) take, verify, promote, re-insert, probe and read the stats of one
    tier at once, with the interpreter's switch interval shortened. No
    update is lost: the host bytes equal the resident blocks' sum, every
    insert counts once in the spilled bytes, and every slab slot is free or
    held by a resident block once the threads are done."""
    import random

    eng = engines(kvtier=KVTierConfig(object_bytes=0))
    _gen(eng, SYS + _suffix(1), SamplingParams(max_tokens=4, temperature=0.0), "warm")
    _fill_to_evict(eng, "port")
    mgr = eng.kvtier
    with mgr._lock:
        keys = [(h, sb.tokens) for h, sb in mgr._host.items()]
    spilled0 = mgr.stats()["spilled_bytes_total"]["host"]
    inserts, errors = [0] * 8, []
    stop = time.monotonic() + 1.5

    def hammer(i):
        rng = random.Random(i)
        try:
            while time.monotonic() < stop:
                h, toks = rng.choice(keys)
                got = mgr.take_verified(h, toks)
                if got is not None and rng.random() < 0.5:
                    mgr.promoted(h, "host")
                    mgr._insert(h, got[1])
                    inserts[i] += 1
                mgr.peek(h)
                mgr.stats()
                del got
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert sum(inserts) > 0
    st = mgr.stats()
    with mgr._lock:
        assert mgr._host_bytes == sum(sb.nbytes for sb in mgr._host.values())
        resident = len(mgr._host)
    assert st["spilled_bytes_total"]["host"] - spilled0 == sum(inserts) * mgr.block_nbytes
    assert st["slab"]["free"] + resident == st["slab"]["slots"]


# -- the prefix index and the routing pick ---------------------------------------


def test_index_epoch_seq_staleness():
    for store in (PrefixIndexStore(), JPrefixIndexStore()):
        rows = [[h, 0, (i + 1) * BS] for i, h in enumerate(chain_hashes(SYS, BS))]
        assert store.update({"engine": "e0", "epoch": 5, "seq": 1, "rows": rows})["ok"]
        assert not store.update({"engine": "e0", "epoch": 5, "seq": 1, "rows": []})["ok"]
        assert not store.update({"engine": "e0", "epoch": 4, "seq": 99, "rows": []})["ok"]
        got = store.lookup(chain_hashes(SYS, BS))["engines"]
        assert got["e0"]["n_tokens"] == len(SYS) and got["e0"]["tier"] == "hbm"
        assert store.lookup(chain_hashes(SYS[:BS], BS))["engines"]["e0"]["n_tokens"] == BS
        assert store.update({"engine": "e0", "epoch": 6, "seq": 1, "rows": []})["ok"]
        assert not store.lookup(chain_hashes(SYS, BS))["engines"]
        assert store.num_stale_dropped == 2


def test_index_stale_rows_omitted_and_dead_engines_reaped():
    store = PrefixIndexStore(stale_after_s=0.0)
    rows = [[h, 0, BS] for h in chain_hashes(SYS[:BS], BS)]
    store.update({"engine": "e0", "epoch": 1, "seq": 1, "rows": rows})
    assert store.lookup(chain_hashes(SYS[:BS], BS))["engines"] == {}
    store2 = PrefixIndexStore(expire_after_s=60.0)
    store2.update({"engine": "dead-1", "epoch": 1, "seq": 1, "rows": rows})
    store2.update({"engine": "live", "epoch": 1, "seq": 1, "rows": rows})
    store2._engines["dead-1"].ts -= 120
    st = store2.stats()
    assert st["engines"] == 1 and st["expired"] == 1


LOOKUPS = [
    ({"a": {"tier": "object", "n_tokens": 80, "age_s": 0.1},
      "b": {"tier": "hbm", "n_tokens": 48, "age_s": 0.1}}, {"a": 0, "b": 0}, 0.0),
    ({"a": {"tier": "object", "n_tokens": 80, "age_s": 0.1},
      "b": {"tier": "hbm", "n_tokens": 48, "age_s": 0.1}}, {"a": 0, "b": 99}, 0.0),
    ({"a": {"tier": "hbm", "n_tokens": 80, "age_s": 1e9}}, {"a": 0}, 0.0),
    ({"hot": {"tier": "host", "n_tokens": 320, "age_s": 0.1},
      "small": {"tier": "hbm", "n_tokens": 16, "age_s": 0.1}}, {"cold": 0, "hot": 99}, 0.25),
    ({"hot": {"tier": "host", "n_tokens": 320, "age_s": 0.1},
      "small": {"tier": "hbm", "n_tokens": 16, "age_s": 0.1}},
     {"small": 0, "cold": 0, "hot": 2}, 0.25),
]


@pytest.mark.parametrize("i", range(len(LOOKUPS)))
def test_best_prefix_replica_equals_reference(i):
    engines_, depths, fw = LOOKUPS[i]
    lookup = {"engines": engines_}
    got = best_prefix_replica(lookup, depths, KVTierConfig(), fetch_weight=fw)
    assert got == j_best_prefix_replica(lookup, depths, JKVTierConfig(), fetch_weight=fw)
    assert best_prefix_replica(None, depths, KVTierConfig()) is None
    expected = ["b", "a", None, "cold", "hot"][i]
    assert got == expected


def test_gcs_index_and_shared_store_refused_naming_b8():
    """The GCS-backed index builds against a GCS (an engine's tiered cache
    publishes through it); a cross-process object store is still refused
    naming B8."""
    from ray_tpu_torch.cluster.gcs_service import GcsServer
    from ray_tpu_torch.cluster.rpc import ReconnectingRpcClient

    server = GcsServer(port=0)
    client = ReconnectingRpcClient(*server.start(), timeout=5).connect()
    try:
        idx = GcsPrefixIndex(client, timeout_s=5)
        rows = [[h, 0, (i + 1) * BS] for i, h in enumerate(chain_hashes(SYS, BS))]
        assert idx.update({"engine": "e0", "epoch": 1, "seq": 1, "rows": rows})
        assert idx.lookup(chain_hashes(SYS, BS))["engines"]["e0"]["n_tokens"] == len(SYS)
    finally:
        client.close()
        server.stop()
    with pytest.raises(NotImplementedError, match="B8"):
        EngineConfig(model=FP32_TINY, **ENGINE_KW, kvtier={"object_store": "tcp://store:1"})
    # an in-process store shared by engines is fine
    store = ObjectStore()
    assert EngineConfig(model=FP32_TINY, **ENGINE_KW,
                        kvtier={"object_store": store}).kvtier.object_store is store


# -- the orchestrator's prefix-aware picks --------------------------------------


def _park(pe, fn):
    """Run ``fn`` on the port pool engine's loop and keep the loop parked
    after it (nothing steps the engine) until the returned Event is set."""
    ran, release = threading.Event(), threading.Event()

    def gate():
        fn()
        ran.set()
        release.wait(timeout=60)

    pe.post(gate)
    assert ran.wait(timeout=60)
    return release


def _warm_pool_engine(pe, prompt, pkg, fill=False):
    def warm():
        eng = pe.engine
        eng.add_request(prompt, _sp(pkg, max_tokens=4, temperature=0.0), request_id="warm-x")
        while eng.has_unfinished():
            eng.step()
        if fill:
            _fill_to_evict(eng, pkg)
    if pkg == "port":
        pe.call(warm)
    else:
        with pe.lock:
            warm()


def _close_ref_orch(orch):
    orch.shutdown()
    for pe in orch._prefill + orch._decode:
        _close(pe.engine)


def test_orchestrator_prefix_aware_decode_pick_equals_reference(weights):
    """The decode engine holding the prompt's prefix only in its HOST tier
    wins the pick (the HBM peek is blind to it); prefix-blind, the ladder."""
    probe = SYS + _suffix(2)
    picks = {}
    for pkg in ("ref", "port"):
        if pkg == "port":
            orch = DisaggOrchestrator(DisaggConfig(
                engine=EngineConfig(model=FP32_TINY, kvtier=True, **ENGINE_KW),
                num_prefill=1, num_decode=2), params=weights[1], model_tag="kvt-pick",
                device="cpu")
            h = KVHandoff(request_id="probe", prompt_token_ids=probe, output_token_ids=[1],
                          sampling_params=None, seed_base=0, num_kv_tokens=0,
                          k_pages=torch.zeros(1, 1, 0, 1), v_pages=torch.zeros(1, 1, 0, 1),
                          model_sig=(1, 1, 1))
        else:
            orch = JDisaggOrchestrator(JDisaggConfig(
                engine=JEngineConfig(model=J_FP32_TINY, kvtier=True, **ENGINE_KW),
                num_prefill=1, num_decode=2, connector="inproc"), params=weights[0], seed=0,
                model_tag="kvt-pick-ref")
            h = JKVHandoff(request_id="probe", prompt_token_ids=probe, output_token_ids=[1],
                           sampling_params=None, key_data=np.zeros(1, np.uint32),
                           num_kv_tokens=0, k_pages=np.zeros((1, 1, 0, 1)),
                           v_pages=np.zeros((1, 1, 0, 1)), model_sig=(1, 1, 1))
        try:
            d1 = orch._decode[1]
            _warm_pool_engine(d1, SYS + _suffix(1), pkg, fill=True)
            assert d1.engine.peek_prefix_tokens(probe) == 0
            assert d1.engine.peek_prefix_tiered(probe)["by_tier"].get("host", 0) >= len(SYS)
            aware = orch._pick_decode(h)
            orch.config.prefix_aware_routing = False
            blind = orch._pick_decode(h)
            picks[pkg] = (aware, blind)
        finally:
            orch.shutdown() if pkg == "port" else _close_ref_orch(orch)
    assert picks["port"] == picks["ref"] == (1, 0)


def test_orchestrator_prefix_aware_prefill_pick_and_depth_slack(weights):
    orch = DisaggOrchestrator(DisaggConfig(
        engine=EngineConfig(model=FP32_TINY, kvtier=True, **ENGINE_KW),
        num_prefill=2, num_decode=1, depth_slack=2), params=weights[1], model_tag="kvt-pre",
        device="cpu")
    try:
        p1 = orch._prefill[1]
        _warm_pool_engine(p1, SYS + _suffix(1), "port")
        assert orch._pick_prefill(SYS + _suffix(2)) is p1
        orch.config.fetch_cost_routing = False
        orch._fetch_enabled = False

        def load():
            for i in range(4):
                p1.engine.add_request(_suffix(50 + i, 32), SamplingParams(max_tokens=1),
                                      request_id=f"load-{i}")

        release = _park(p1, load)  # the load waits: nothing steps p1
        try:
            assert orch._pick_prefill(SYS + _suffix(3)) is orch._prefill[0]
        finally:
            release.set()
    finally:
        orch.shutdown()


# -- observability ---------------------------------------------------------------


def test_tier_metrics_and_stats(engines):
    eng = engines()
    eng.model_tag = "kvt-obs"
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    _gen(eng, SYS + _suffix(1), sp, "warm")
    _fill_to_evict(eng, "port")
    _gen(eng, SYS + _suffix(2), sp, "res")
    eng.update_telemetry_gauges()
    snap = {m.name: m for m in registry_snapshot()}
    for name in ("ray_tpu_llm_kvtier_spilled_bytes_total", "ray_tpu_llm_kvtier_resident_bytes",
                 "ray_tpu_llm_kvtier_resurrected_tokens_total",
                 "ray_tpu_llm_kvtier_spill_queue_depth"):
        assert name in snap, name
    hit = snap["ray_tpu_llm_prefix_cache_hit_tokens_total"]
    assert hit.series()[hit._key({"model": "kvt-obs", "tier": "host"})] >= len(SYS)
    st = eng.stats()
    assert st["prefix_cache"]["by_tier"].get("host", 0) >= len(SYS)
    timings = st["kv_tiers"]["timings"]
    for stage in ("capture", "gather", "pin", "seal", "verify", "h2d", "scatter"):
        assert timings[stage]["blocks"] > 0, stage


def test_new_modules_import_without_jax():
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "ray_tpu", "triton"):
    sys.modules[name] = None
import ray_tpu_torch.llm.kvtier, ray_tpu_torch.llm.kvfetch
import ray_tpu_torch.cluster.prefix_index, ray_tpu_torch.core.object_store
from ray_tpu_torch.llm.kvtier import metrics
from ray_tpu_torch.llm.kvfetch import metrics as fm
metrics.register_metrics(); fm.register_metrics()
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
