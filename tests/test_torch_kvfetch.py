"""The fetch plane, prefetch-at-admission and the async batched spill of
ray_tpu_torch (``llm/kvfetch``, ``llm/kvtier/tiers.py``) held against
ray_tpu.llm.kvfetch on the CPU.

Mirrors ``tests/test_llm_kvfetch.py`` with the ``local`` backend (the device
and RPC backends are held in ``tests/test_torch_rpc.py``), on
LLAMA_TINY in fp32 with the reference's configuration: cross-engine
identity (greedy tokens and fetch counts equal the reference pair's),
adoption and re-indexing, prefetch = sync, an abort storm that leaks
nothing, the spill worker's crash window, the bounded spill queue, a stale
insert after an invalidation, corrupt and dropped fetches (counts equal the
reference's), a dead source as a bounded typed error, the fetch discount,
the orchestrator's wiring and its fetch-cost pick (equal to the reference
orchestrator's), and the stats surface.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu.llm.disagg import DisaggConfig as JDisaggConfig
from ray_tpu.llm.disagg import DisaggOrchestrator as JDisaggOrchestrator
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.kvfetch import LocalFetchClient as JLocalFetchClient
from ray_tpu.llm.kvfetch import LocalFetchRegistry as JLocalFetchRegistry
from ray_tpu.llm.kvtier import KVTierConfig as JKVTierConfig
from ray_tpu.llm.kvtier import LocalPrefixIndex as JLocalPrefixIndex
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch import chaos
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator
from ray_tpu_torch.llm.kvfetch import (
    DeviceFetchClient,
    KVFetchError,
    LocalFetchClient,
    LocalFetchRegistry,
    RpcFetchClient,
    RpcFetchServer,
    make_fetch_client,
)
from ray_tpu_torch.llm.kvtier import KVTierConfig, LocalPrefixIndex, best_prefix_replica, chain_hashes
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util.metrics import registry_snapshot

pytestmark = [pytest.mark.torch_port, pytest.mark.kvfetch]
torch.set_num_threads(2)

BS = 16
SYS = [int(x) for x in np.random.RandomState(0).randint(3, 200, size=5 * BS)]  # 80 tokens
J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(num_blocks=16, block_size=BS, max_num_seqs=4, max_prefill_len=128)
TIER_THREADS = ("kvtier-spill", "kvfetch")


def _suffix(seed, n=BS):
    return [int(x) for x in np.random.RandomState(seed).randint(3, 200, size=n)]


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
    if isinstance(eng, LLMEngine):
        eng.close()
    elif getattr(eng, "kvtier", None) is not None:
        eng.kvfetch.close()
        eng.kvtier.stop()


@pytest.fixture
def engines(weights):
    """Factory of engines of either package, each closed when the test ends."""
    made = []

    def make(pkg="port", kvtier=True):
        if pkg == "port":
            eng = LLMEngine(EngineConfig(model=FP32_TINY, kvtier=kvtier, **ENGINE_KW),
                            params=weights[1], device="cpu")
        else:
            if isinstance(kvtier, KVTierConfig):
                kvtier = JKVTierConfig(**{f.name: getattr(kvtier, f.name)
                                          for f in dataclasses.fields(kvtier)})
            eng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, kvtier=kvtier, **ENGINE_KW),
                             params=weights[0], seed=0)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        _close(eng)


def _sp(pkg, **kw):
    return (SamplingParams if pkg == "port" else JSamplingParams)(**kw)


def _gen(eng, prompt, sp, rid, prefetch_wait=False):
    eng.add_request(prompt, sp, request_id=rid)
    if prefetch_wait:
        assert eng.kvfetch.wait_idle(30)
    toks = cached = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished and o.request_id == rid:
                toks, cached = list(o.output_token_ids), o.num_cached_tokens
    assert toks is not None
    return toks, cached


def _warm_and_spill(eng, pkg, tag="w"):
    """The shared prefix warmed, then pushed out of HBM into the host tier."""
    sp = _sp(pkg, max_tokens=4, temperature=0.0)
    _gen(eng, SYS + _suffix(1), sp, f"{tag}-warm", prefetch_wait=True)
    for i in range(4):
        p = [int(x) for x in np.random.RandomState(100 + i).randint(3, 200, size=112)]
        _gen(eng, p, sp, f"{tag}-fill-{i}", prefetch_wait=True)
    _settle(eng)
    assert eng.kvtier.stats()["host"]["entries"] > 0
    eng.kvtier.flush_index(force=True)


def _settle(eng):
    """Every queued spill inserted: the queue drained and no gather in
    flight (the reference's ``flush_spills`` returns once the queue is
    empty, while its worker may still be inserting)."""
    mgr = eng.kvtier
    assert mgr.flush_spills()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        with mgr._lock:
            if not mgr._gathering and not mgr._pending:
                return
        time.sleep(0.002)
    raise AssertionError("a spill gather did not finish")


def _wire_pair(make, pkg="port"):
    """Owner engine (holds the spilled prefix) and a cold engine fetching
    over the local backend; both publish into one index."""
    idx = LocalPrefixIndex() if pkg == "port" else JLocalPrefixIndex()
    reg = LocalFetchRegistry() if pkg == "port" else JLocalFetchRegistry()
    owner, cold = make(pkg), make(pkg)
    reg.register("owner", owner.kvtier)
    reg.register("cold", cold.kvtier)
    owner.kvtier.attach_index(idx, engine_key="owner")
    cold.kvtier.attach_index(idx, engine_key="cold")
    cold.kvfetch.attach((LocalFetchClient if pkg == "port" else JLocalFetchClient)(reg))
    return idx, reg, owner, cold


def _cold_tokens(make, prompt, sp, rid):
    return _gen(make(kvtier=None), prompt, sp, rid)[0]


def test_cross_engine_identity_equals_reference(engines):
    """A cold engine pulls the owner's spilled prefix over the fetch plane:
    greedy tokens and the fetch counts equal the reference pair's; seeded
    tokens equal a cold prefill's; the whole prefix counts as cached."""
    got = {}
    for pkg in ("ref", "port"):
        _idx, _reg, owner, cold = _wire_pair(engines, pkg)
        _warm_and_spill(owner, pkg, "own")
        toks, cached = _gen(cold, SYS + _suffix(2), _sp(pkg, max_tokens=8, temperature=0.0),
                            "the-greedy", prefetch_wait=True)
        st = cold.kvfetch.stats()
        got[pkg] = (toks, cached, st["remote"], st["client"]["num_blocks"],
                    st["client"]["bytes_fetched"], owner.kvtier.stats()["fetch_served"],
                    cold.stats()["prefix_cache"])
        if pkg == "port":
            sp = SamplingParams(max_tokens=8, temperature=1.0, seed=1234, top_k=5)
            toks_s, cached_s = _gen(cold, SYS + _suffix(3), sp, "the-seeded", prefetch_wait=True)
            assert toks_s == _cold_tokens(engines, SYS + _suffix(3), sp, "the-seeded")
            assert cached_s >= len(SYS)
    assert got["port"] == got["ref"]
    toks, cached, remote = got["port"][:3]
    assert toks == _cold_tokens(engines, SYS + _suffix(2),
                                SamplingParams(max_tokens=8, temperature=0.0), "the-greedy")
    assert cached >= len(SYS) and remote["fetches"] >= 1 and remote["blocks"] >= 5


def test_fetched_blocks_adopted_and_reindexed(engines):
    idx, _reg, owner, cold = _wire_pair(engines)
    _warm_and_spill(owner, "port", "own-adopt")
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    _gen(cold, SYS + _suffix(2), sp, "first", prefetch_wait=True)
    fetches = cold.kvfetch.stats()["remote"]["fetches"]
    assert fetches >= 1
    _gen(cold, SYS + _suffix(3), sp, "second", prefetch_wait=True)
    assert cold.kvfetch.stats()["remote"]["fetches"] == fetches  # served locally now
    cold.kvtier.flush_index(force=True)
    assert "cold" in idx.lookup(chain_hashes(SYS, BS))["engines"]


def test_prefetch_vs_sync_identity_and_counters(engines):
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    pre = engines()
    _warm_and_spill(pre, "port", "pre")
    toks_pre, cached_pre = _gen(pre, SYS + _suffix(2), sp, "the-req", prefetch_wait=True)
    sync = engines(kvtier=KVTierConfig(prefetch=False))
    _warm_and_spill(sync, "port", "sync")
    toks_sync, cached_sync = _gen(sync, SYS + _suffix(2), sp, "the-req")
    assert toks_pre == toks_sync
    assert cached_pre == cached_sync >= len(SYS)
    # the prefetched blocks count under their source tier
    assert pre.stats()["prefix_cache"]["by_tier"].get("host", 0) >= len(SYS)
    st = pre.kvfetch.stats()["prefetch"]
    assert st["started"] >= 1 and st["completed"] >= 1
    assert st["staged"] == 0 and st["reserved_blocks"] == 0
    names = {m.name for m in registry_snapshot()}
    assert "ray_tpu_llm_kvtier_prefetch_completed_total" in names
    assert "ray_tpu_llm_kvtier_prefetch_lead_seconds" in names


def test_abort_storm_mid_prefetch_leaks_nothing(engines):
    _idx, _reg, owner, cold = _wire_pair(engines)
    _warm_and_spill(owner, "port", "own-storm")
    busy = SamplingParams(max_tokens=48, temperature=0.0)
    for i in range(4):
        cold.add_request(_suffix(700 + i, 24), busy, request_id=f"busy-{i}")
    while len(cold.running) < 4:
        cold.step()
    rids = []
    for i in range(6):
        rid = f"storm-{i}"
        cold.add_request(SYS + _suffix(800 + i), SamplingParams(max_tokens=4, temperature=0.0),
                         request_id=rid)
        rids.append(rid)
    assert cold.kvfetch.wait_idle(30)
    for _ in range(4):
        cold.step()  # the tick scatters staged chains under reservations
    assert cold.kvfetch.stats()["prefetch"]["reserved_blocks"] > 0
    for rid in rids:
        cold.abort_request(rid)
    st = cold.kvfetch.stats()["prefetch"]
    assert st["reserved_blocks"] == 0 and st["staged"] == 0 and st["wasted"] >= 1
    while cold.has_unfinished():
        cold.step()
    assert cold.allocator.num_free == cold.config.num_blocks


def test_async_spill_crash_window_means_miss_not_torn(engines, monkeypatch):
    eng = engines()
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    _gen(eng, SYS + _suffix(1), sp, "warm")
    mgr = eng.kvtier
    monkeypatch.setattr(type(mgr), "_materialize",
                        lambda self, *a, **k: (_ for _ in ()).throw(RuntimeError("died")))
    for i in range(4):
        p = [int(x) for x in np.random.RandomState(100 + i).randint(3, 200, size=112)]
        _gen(eng, p, SamplingParams(max_tokens=4, temperature=0.0), f"fill-{i}")
    assert mgr.flush_spills()
    assert mgr.spill_gather_failures > 0
    assert mgr.stats()["host"]["entries"] == 0
    # every slot the failed spills took came back
    assert mgr.stats()["slab"]["free"] == mgr.stats()["slab"]["slots"]
    monkeypatch.undo()
    toks, _ = _gen(eng, SYS + _suffix(2), sp, "the-req")
    assert toks == _cold_tokens(engines, SYS + _suffix(2), sp, "the-req")


def test_spill_queue_bounded_overflow_drops_oldest(engines):
    eng = engines(kvtier=KVTierConfig(spill_queue_depth=2))
    _gen(eng, SYS + _suffix(1), SamplingParams(max_tokens=4, temperature=0.0), "warm")
    eng.kvtier.stop()  # captures accumulate
    taken = eng.allocator.allocate(eng.allocator.num_free)
    eng.allocator.free(taken)
    with eng.kvtier._lock:
        assert len(eng.kvtier._pending) <= 2
    assert eng.kvtier.spill_queue_dropped > 0


def test_stale_insert_after_invalidation_is_dropped(engines):
    eng = engines()
    _warm_and_spill(eng, "port", "gen")
    mgr = eng.kvtier
    with mgr._lock:
        h, sb = next(iter(mgr._host.items()))
    gen0 = mgr.generation
    mgr.invalidate_all()
    assert mgr.stats()["host"]["entries"] == 0
    mgr._insert(h, sb, gen=gen0)
    mgr.adopt_fetched(h, sb, gen=gen0)
    assert mgr.stats()["host"]["entries"] == 0
    mgr._insert(h, sb, gen=mgr.generation)
    assert mgr.stats()["host"]["entries"] == 1


@pytest.mark.parametrize("kind", ["corrupt_kv_transfer", "drop_kv_transfer"])
def test_fetch_chaos_recomputes_with_reference_counts(engines, kind):
    """CORRUPT at ``llm.kvfetch``: the requester's verify drops the flipped
    block (counted); DROP: a typed failure, local tiers and recompute. The
    tokens stay the cold prefill's and the counts equal the reference's."""
    got = {}
    for pkg in ("ref", "port"):
        mod = chaos if pkg == "port" else jchaos
        _idx, _reg, owner, cold = _wire_pair(engines, pkg)
        _warm_and_spill(owner, pkg, f"own-{kind}")
        mod.install(mod.FaultSchedule(7, [mod.FaultSpec(kind, site="llm.kvfetch",
                                                        max_fires=1000)]))
        try:
            toks, cached = _gen(cold, SYS + _suffix(2), _sp(pkg, max_tokens=8, temperature=0.0),
                                "the-req", prefetch_wait=True)
        finally:
            mod.uninstall()
        st = cold.kvfetch.stats()
        got[pkg] = (toks, cached, st["remote"], cold.stats()["prefix_cache"])
    assert got["port"] == got["ref"]
    remote = got["port"][2]
    if kind == "corrupt_kv_transfer":
        assert remote["corrupt_dropped"] >= 1
    else:
        assert remote["failures"] >= 1 and remote["blocks"] == 0
    assert got["port"][0] == _cold_tokens(engines, SYS + _suffix(2),
                                          SamplingParams(max_tokens=8, temperature=0.0), "the-req")


def test_dead_source_is_bounded_typed_failure(engines):
    reg = LocalFetchRegistry()
    client = LocalFetchClient(reg)
    t0 = time.monotonic()
    with pytest.raises(KVFetchError):
        client.fetch("dead", None, [123], [(1,) * BS], timeout_s=2.0)
    assert time.monotonic() - t0 < 10.0
    _idx, reg, owner, cold = _wire_pair(engines)
    _warm_and_spill(owner, "port", "own-dead")
    reg.unregister("owner")  # the source engine died
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    toks, _ = _gen(cold, SYS + _suffix(2), sp, "the-req", prefetch_wait=True)
    assert cold.kvfetch.fetch_failures >= 1
    assert toks == _cold_tokens(engines, SYS + _suffix(2), sp, "the-req")


def test_best_prefix_replica_fetch_discount():
    cfg = KVTierConfig()
    lookup = {"engines": {"hot": {"tier": "host", "n_tokens": 320, "age_s": 0.1},
                          "small": {"tier": "hbm", "n_tokens": 16, "age_s": 0.1}}}
    depths = {"cold": 0, "hot": 99}
    assert best_prefix_replica(lookup, depths, cfg) is None
    assert best_prefix_replica(lookup, depths, cfg, fetch_weight=cfg.fetch_weight) == "cold"
    depths = {"small": 0, "cold": 0, "hot": 99}
    assert best_prefix_replica(lookup, depths, cfg) == "small"
    assert best_prefix_replica(lookup, depths, cfg,
                               fetch_weight=cfg.fetch_weight) in ("small", "cold")
    depths = {"small": 0, "cold": 0, "hot": 2}
    assert best_prefix_replica(lookup, depths, cfg, fetch_weight=cfg.fetch_weight) == "hot"
    assert best_prefix_replica(None, depths, cfg, fetch_weight=cfg.fetch_weight) is None


def _gated_load(pe, pkg, n=4):
    """Queue ``n`` requests on a prefill engine and keep its loop from
    stepping them until the returned Event is set (the reference: under
    its lock; the port: a blocking callable posted to the loop)."""
    def load():
        for i in range(n):
            pe.engine.add_request(_suffix(50 + i, 32), _sp(pkg, max_tokens=1),
                                  request_id=f"load-{i}")
    if pkg == "ref":
        # the pool lock, made reentrant by the caller: held on this thread
        # through the picks, which take it again
        assert pe.lock.acquire(timeout=60)
        load()
        return pe.lock
    release, ran = threading.Event(), threading.Event()

    def gate():
        load()
        ran.set()
        release.wait(timeout=60)

    pe.post(gate)
    assert ran.wait(timeout=60)
    return release


def _warm_prefill(pe, pkg):
    def warm():
        pe.engine.add_request(SYS + _suffix(1), _sp(pkg, max_tokens=4, temperature=0.0),
                              request_id="warm-p1")
        while pe.engine.has_unfinished():
            pe.engine.step()
    if pkg == "port":
        pe.call(warm)
    else:
        with pe.lock:
            warm()


def test_orchestrator_wires_fetch_plane_and_spreads_like_reference(weights):
    """Every pool engine is on one index and fetch registry; with the holder
    past the slack the prefill pick spreads to the cold engine (it can pull
    the prefix), and without fetch-cost routing it falls to the ladder; the
    reference orchestrator picks the same engines."""
    picks = {}
    for pkg in ("ref", "port"):
        if pkg == "port":
            orch = DisaggOrchestrator(DisaggConfig(
                engine=EngineConfig(model=FP32_TINY, kvtier=True, **ENGINE_KW), num_prefill=2,
                num_decode=1, depth_slack=2), params=weights[1], model_tag="kvf-orch",
                device="cpu")
        else:
            orch = JDisaggOrchestrator(JDisaggConfig(
                engine=JEngineConfig(model=J_FP32_TINY, kvtier=True, **ENGINE_KW),
                num_prefill=2, num_decode=1, connector="inproc", depth_slack=2),
                params=weights[0], seed=0, model_tag="kvf-orch-ref")
        try:
            for p in orch._prefill + orch._decode:
                assert p.engine.kvfetch.client is not None
                assert p.engine.kvtier.index is not None
            p0, p1 = orch._prefill
            if pkg == "ref":
                p1.lock = threading.RLock()  # the loop takes the new one next round
            _warm_prefill(p1, pkg)
            first = orch._pick_prefill(SYS + _suffix(2))
            gate = _gated_load(p1, pkg)
            try:
                spread = orch._pick_prefill(SYS + _suffix(3))
                orch._fetch_enabled = False
                blind = orch._pick_prefill(SYS + _suffix(3))
            finally:
                gate.release() if pkg == "ref" else gate.set()
            picks[pkg] = (first.index, spread.index, blind.index)
        finally:
            orch.shutdown()
            if pkg == "ref":
                for pe in orch._prefill + orch._decode:
                    _close(pe.engine)
    assert picks["port"] == picks["ref"] == (1, 0, 0)


def test_device_and_rpc_fetch_clients_refused_by_name():
    """The device and RPC fetch clients (C1) build as the reference's do; the
    GCS-backed prefix index still waits for the cluster runtime (B8)."""
    from ray_tpu_torch.fabric import DeviceTransport
    from ray_tpu_torch.llm.kvtier import GcsPrefixIndex

    dev = make_fetch_client("device", registry=LocalFetchRegistry(),
                            transport=DeviceTransport("t-kvf-make", devices=["cpu"]))
    assert isinstance(dev, DeviceFetchClient) and dev.stats()["backend"] == "device"
    dev.close()
    rpc = make_fetch_client("rpc")
    assert isinstance(rpc, RpcFetchClient) and rpc.stats()["backend"] == "rpc"
    rpc.close()
    srv = RpcFetchServer()
    try:
        host, port = srv.address
        assert host == "127.0.0.1" and port > 0
    finally:
        srv.stop()
    with pytest.raises(NotImplementedError, match="B8"):
        GcsPrefixIndex()
    with pytest.raises(ValueError, match="unknown fetch backend"):
        make_fetch_client("carrier-pigeon")
    assert isinstance(make_fetch_client("local", registry=LocalFetchRegistry()), LocalFetchClient)


def test_kvfetch_stats_surface(engines):
    _idx, _reg, owner, cold = _wire_pair(engines)
    owner.model_tag, cold.model_tag = "kvf-obs-owner", "kvf-obs-cold"
    _warm_and_spill(owner, "port", "own-obs")
    _gen(cold, SYS + _suffix(2), SamplingParams(max_tokens=4, temperature=0.0), "res",
         prefetch_wait=True)
    cold.update_telemetry_gauges()
    snap = {m.name: m for m in registry_snapshot()}
    for name in ("ray_tpu_llm_kvtier_prefetch_started_total",
                 "ray_tpu_llm_kvtier_prefetch_completed_total",
                 "ray_tpu_llm_kvtier_fetch_bytes_total", "ray_tpu_llm_kvtier_spill_queue_depth"):
        assert name in snap, name
    fetched = snap["ray_tpu_llm_kvtier_fetch_bytes_total"]
    assert fetched.series()[fetched._key({"backend": "local"})] > 0
    st = cold.stats()["kv_tiers"]
    assert st["fetch"]["remote"]["fetches"] >= 1
    assert st["spill_queue"]["async"] is True
