"""The RPC plane of ray_tpu_torch (``cluster/rpc.py``, ``RpcKVConnector``, the
RPC and device fetch clients) and the fabric's RPC fallback, on the CPU.

Mirrors tests/test_fabric.py's chunked-send cases (a handoff exactly at the
frame budget rides one frame, one byte over rides two, many small chunks;
a torn blob fails its CRC and delivers nothing; the budget below the
envelope margin is refused; the timeout bounds the whole transfer; the
reassembly deadline moves on every chunk) and its fallback cases against
the reference orchestrator (the budget exhausting loudly when the RPC
retries die too, a partial fallback that keeps the pool topology device,
unlinked slices choosing RPC; an injected device connector getting device
edges), the RPC primitives (pipelined calls, remote errors, bounded
timeouts, a dead peer, a torn frame), and tests/test_llm_kvfetch.py's
cross-engine identity over ``["device", "rpc"]``. Every server binds
127.0.0.1:0, every wait is bounded, and every server is stopped in a
``finally``.
"""

import dataclasses
import pickle
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu.fabric import SlicePoolSpec as JSlicePoolSpec
from ray_tpu.fabric import build_topology as jbuild_topology
from ray_tpu.llm.disagg import DisaggConfig as JDisaggConfig
from ray_tpu.llm.disagg import DisaggOrchestrator as JDisaggOrchestrator
from ray_tpu.llm.disagg import KVTransferError as JKVTransferError
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch import chaos
from ray_tpu_torch.cluster.rpc import MAX_FRAME, ClientPool, RemoteError, RpcError, RpcServer
from ray_tpu_torch.fabric import DeviceKVConnector, DeviceTransport, SlicePoolSpec, build_topology
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.disagg import (
    DisaggConfig,
    DisaggOrchestrator,
    KVTransferError,
    RpcKVConnector,
    make_connector,
)
from ray_tpu_torch.llm.disagg.connector import CHUNK_MARGIN
from ray_tpu_torch.llm.kvfetch import (
    DeviceFetchClient,
    KVFetchError,
    LocalFetchClient,
    LocalFetchRegistry,
    RpcFetchClient,
    RpcFetchServer,
)
from ray_tpu_torch.llm.kvtier import LocalPrefixIndex
from ray_tpu_torch.models import llama as tllama

pytestmark = [pytest.mark.torch_port, pytest.mark.fabric]
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=64)


def _greedy(cls=SamplingParams):
    return cls(max_tokens=10, temperature=0.0, ignore_eos=True)


@pytest.fixture(autouse=True)
def _chaos_off():
    yield
    chaos.uninstall()
    jchaos.uninstall()


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [[int(x) for x in rng.integers(3, 120, rng.integers(8, 24))] for _ in range(4)]


@pytest.fixture(scope="module")
def colocated(weights, prompts):
    eng = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=weights[1], device="cpu")
    return eng.generate(prompts, _greedy())


@pytest.fixture(scope="module")
def exported(weights, prompts):
    pre = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=weights[1], device="cpu")
    pre.add_request(prompts[0], _greedy(), request_id="c1")
    pre.step()
    return pre.export_request("c1")


def _orch(weights, tag, inject=None, **kw):
    return DisaggOrchestrator(DisaggConfig(engine=EngineConfig(model=FP32_TINY, **ENGINE_KW), **kw),
                              params=weights[1], model_tag=tag, connector=inject, device="cpu")


def _jorch(weights, tag, **kw):
    return JDisaggOrchestrator(JDisaggConfig(engine=JEngineConfig(model=J_FP32_TINY, **ENGINE_KW),
                                             **kw), params=weights[0], seed=0, model_tag=tag)


# ---------------------------------------------------------------------------
# the RPC primitives
# ---------------------------------------------------------------------------


def test_rpc_calls_errors_and_bounds():
    srv = RpcServer()
    gate = threading.Event()

    def boom(payload, peer):
        raise ValueError(f"bad {payload}")

    async def aecho(payload, peer):
        return ("async", payload, peer[0])

    srv.route("echo", lambda payload, peer: payload)
    srv.route("boom", boom)
    srv.route("aecho", aecho)
    srv.route("park", lambda payload, peer: gate.wait(timeout=10))
    addr = srv.start()
    pool = ClientPool(timeout=5.0)
    try:
        assert addr[0] == "127.0.0.1" and addr[1] > 0
        c = pool.get(addr)
        assert pool.get(addr) is c
        big = bytes(range(256)) * (4 << 10)
        assert c.call("echo", {"x": big}) == {"x": big}
        assert c.call("aecho", 3) == ("async", 3, "127.0.0.1")
        with pytest.raises(RemoteError) as ei:
            c.call("boom", 7)
        assert isinstance(ei.value.cause, ValueError) and "bad 7" in str(ei.value.cause)
        # pipelined: a parked call does not hold the connection
        results = []
        t = threading.Thread(target=lambda: results.append(c.call("park", None, timeout=10)),
                             daemon=True)
        t.start()
        assert c.call("echo", 1) == 1
        with pytest.raises(RpcError, match="timed out"):
            c.call("park", None, timeout=0.05)
        gate.set()
        t.join(timeout=10)
        assert not t.is_alive() and results == [True]
    finally:
        gate.set()
        pool.close_all()
        srv.stop()
    # the peer is gone: a typed error, bounded
    with pytest.raises(RpcError):
        c.call("echo", 1, timeout=2.0)
    with pytest.raises(RpcError, match="cannot connect"):
        ClientPool(timeout=0.5).get(addr)


def test_torn_frame_drops_the_connection_not_the_server():
    srv = RpcServer()
    srv.route("echo", lambda payload, peer: payload)
    addr = srv.start()
    pool = ClientPool(timeout=5.0)
    try:
        c = pool.get(addr)
        chaos.install(chaos.FaultSchedule(3, [chaos.FaultSpec(chaos.CORRUPT_FRAME,
                                                              site="rpc.frame", max_fires=1)]))
        with pytest.raises(RpcError):
            c.call("echo", "x" * 64, timeout=5.0)
        chaos.uninstall()
        assert not c.connected
        assert pool.get(addr).call("echo", 5) == 5  # a fresh dial, same server
        chaos.install(chaos.FaultSchedule(3, [chaos.FaultSpec(chaos.DROP_RPC, site="rpc.call",
                                                              max_fires=1)]))
        with pytest.raises(RpcError, match="chaos: dropped"):
            pool.get(addr).call("echo", 1)
    finally:
        chaos.uninstall()
        pool.close_all()
        srv.stop()


def test_oversized_frame_fails_loudly(monkeypatch):
    from ray_tpu_torch.cluster import rpc

    srv = RpcServer()
    srv.route("echo", lambda payload, peer: payload)
    addr = srv.start()
    pool = ClientPool(timeout=5.0)
    try:
        c = pool.get(addr)
        monkeypatch.setattr(rpc, "MAX_FRAME", 1024)
        with pytest.raises(RpcError, match="exceeds MAX_FRAME"):
            c.call("echo", b"x" * 4096)
        monkeypatch.setattr(rpc, "MAX_FRAME", MAX_FRAME)
        assert c.call("echo", 2) == 2 and c._pending == {}
    finally:
        pool.close_all()
        srv.stop()


# ---------------------------------------------------------------------------
# RpcKVConnector: chunked multi-frame sends
# ---------------------------------------------------------------------------


def test_rpc_chunked_send_at_exact_frame_boundary(exported):
    h = exported
    blob_len = len(pickle.dumps(h, protocol=5))
    for max_frame in (blob_len + CHUNK_MARGIN,      # exactly one full chunk
                      blob_len + CHUNK_MARGIN - 1,  # one byte over: two chunks
                      CHUNK_MARGIN + 2048):         # many small chunks
        conn = RpcKVConnector(max_frame_bytes=max_frame)
        try:
            conn.send(conn.register_target("d0"), h)
            got = conn.recv("d0", timeout_s=10.0)
            assert got is not None and got.verify(), max_frame
            assert torch.equal(got.k_pages, h.k_pages) and torch.equal(got.v_pages, h.v_pages)
            assert got.output_token_ids == h.output_token_ids and got.seed_base == h.seed_base
            assert conn.stats()["num_sent"] == conn.stats()["num_received"] == 1
        finally:
            conn.close()


def test_rpc_chunk_reassembly_crc_rejects_torn_blob(exported):
    conn = RpcKVConnector(max_frame_bytes=CHUNK_MARGIN + 1024)
    try:
        conn.register_target("d0")
        blob = pickle.dumps(exported, protocol=5)
        chunks = [blob[i:i + 1024] for i in range(0, len(blob), 1024)]
        bad = bytes([chunks[0][0] ^ 0xFF]) + chunks[0][1:]
        with pytest.raises(KVTransferError, match="CRC"):
            for seq, data in enumerate([bad] + chunks[1:]):
                conn._on_kv_chunk({"target": "d0", "xfer": "torn-1", "seq": seq,
                                   "total": len(chunks), "data": data,
                                   "crc": zlib.crc32(blob) & 0xFFFFFFFF}, ("127.0.0.1", 0))
        assert conn.recv("d0", timeout_s=0.05) is None  # nothing delivered
        assert conn._partial == {}
    finally:
        conn.close()


def test_rpc_connector_rejects_frame_budget_below_margin():
    with pytest.raises(ValueError, match="headroom"):
        RpcKVConnector(max_frame_bytes=CHUNK_MARGIN)


def test_rpc_chunked_send_bounded_by_overall_timeout(exported):
    conn = RpcKVConnector(max_frame_bytes=CHUNK_MARGIN + 512)
    try:
        with pytest.raises(KVTransferError, match="exceeded"):
            conn.send(conn.register_target("d0"), exported, timeout_s=1e-9)
    finally:
        conn.close()


def test_rpc_chunk_deadline_refreshes_per_chunk(exported):
    conn = RpcKVConnector(max_frame_bytes=CHUNK_MARGIN + 1024)
    try:
        conn.register_target("d0")
        blob = pickle.dumps(exported, protocol=5)
        chunks = [blob[i:i + 1024] for i in range(0, len(blob), 1024)]
        assert len(chunks) >= 3
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        for seq, data in enumerate(chunks[:3]):
            # every gap exceeds ttl_s, the whole transfer several ttl_s: still
            # delivered, since each chunk moves the deadline by another ttl_s
            time.sleep(0.12)
            conn._on_kv_chunk({"target": "d0", "xfer": "slow-1", "seq": seq,
                               "total": len(chunks), "data": data, "crc": crc, "ttl_s": 0.2},
                              ("127.0.0.1", 0))
        for seq, data in enumerate(chunks[3:], start=3):
            conn._on_kv_chunk({"target": "d0", "xfer": "slow-1", "seq": seq,
                               "total": len(chunks), "data": data, "crc": crc, "ttl_s": 0.2},
                              ("127.0.0.1", 0))
        got = conn.recv("d0", timeout_s=1.0)
        assert got is not None and got.verify() and conn._partial == {}
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# the orchestrator over the RPC plane and the fallback, against the reference
# ---------------------------------------------------------------------------


def test_rpc_primary_identity(weights, prompts, colocated):
    orch = _orch(weights, "t-rpc-primary", num_decode=2, connector="rpc")
    try:
        assert orch.generate(prompts, _greedy(), timeout_s=60) == colocated
        st = orch.stats()
    finally:
        orch.shutdown()
    assert st["fabric"]["backends"] == {"rpc": len(prompts)}
    assert st["transfer"]["connector"] == "rpc" and st["transfer"]["num_received"] == len(prompts)
    assert all(e["num_prefill_batches"] == 0 for e in st["decode"])


def test_device_drop_budget_exhausts_loudly(weights, prompts):
    """Device edges degrade to RPC after the first fault, so the schedule
    also kills the RPC retries; the caller gets a typed error, never a hang."""
    for pkg, harness, err in (("ref", jchaos, JKVTransferError), ("port", chaos, KVTransferError)):
        harness.install(harness.FaultSchedule(3, [
            harness.FaultSpec("drop_device_transfer", site="disagg.kv_transfer"),
            harness.FaultSpec("drop_kv_transfer", site="disagg.kv_transfer")]))
        try:
            orch = (_jorch if pkg == "ref" else _orch)(weights, f"t-budget-{pkg}",
                                                       connector="device", max_handoff_retries=1)
            try:
                sp = _greedy(JSamplingParams) if pkg == "ref" else _greedy()
                t0 = time.time()
                with pytest.raises(err, match="budget"):
                    orch.generate([prompts[0]], sp, timeout_s=60)
                assert time.time() - t0 < 30
                assert orch.num_fallbacks == 1
            finally:
                orch.shutdown()
        finally:
            harness.uninstall()


def _two_phase(orch, prompts, sp):
    try:
        out = orch.generate(prompts[:1], sp, timeout_s=60)
        out += orch.generate(prompts[1:], sp, timeout_s=60)
        return out, orch.stats(), orch.topology
    finally:
        orch.shutdown()


def test_partial_edge_fallback_keeps_pool_topology_device(weights, prompts, colocated):
    """One faulted engine edge of two degrades only itself; the pool-level
    topology stays device while an engine edge still rides the device
    plane. The faulted edge and the counts equal the reference's."""
    got = {}
    for pkg, harness in (("ref", jchaos), ("port", chaos)):
        harness.install(harness.FaultSchedule(7, [
            harness.FaultSpec("drop_device_transfer", site="disagg.kv_transfer", max_fires=1)]))
        try:
            orch = (_jorch if pkg == "ref" else _orch)(weights, f"t-partial-{pkg}",
                                                       connector="device", num_decode=2)
            sp = _greedy(JSamplingParams) if pkg == "ref" else _greedy()
            got[pkg] = _two_phase(orch, prompts, sp)
        finally:
            harness.uninstall()
    (out, st, topo), (jout, jst, jtopo) = got["port"], got["ref"]
    assert out == colocated == [list(map(int, o)) for o in jout]
    assert st["fabric"]["edges"] == jst["fabric"]["edges"]
    assert sorted(e["backend"] for e in st["fabric"]["edges"]) == ["device", "rpc"]
    assert st["fabric"]["fallbacks"] == jst["fabric"]["fallbacks"] == 1
    assert st["transfer"]["reprefills"] == jst["transfer"]["reprefills"] == 1
    for t in (topo, jtopo):
        assert t.edge_backend("prefill", "decode") == "device" and t.fallbacks() == {}


def test_unlinked_slices_choose_rpc(weights, prompts, colocated):
    """A topology whose pools share no mesh keeps every edge on RPC with the
    device connector configured: selection is the topology's call."""
    got = {}
    for pkg in ("ref", "port"):
        specs = (JSlicePoolSpec if pkg == "ref" else SlicePoolSpec)
        build = jbuild_topology if pkg == "ref" else build_topology
        topo = build([specs("prefill", "prefill", "s0", 1), specs("decode", "decode", "s1", 2)])
        orch = (_jorch if pkg == "ref" else _orch)(weights, f"t-unlinked-{pkg}",
                                                   connector="device", num_decode=2,
                                                   fabric=topo if pkg == "ref" else topo.to_dict())
        sp = _greedy(JSamplingParams) if pkg == "ref" else _greedy()
        try:
            got[pkg] = (orch.generate(prompts[:2], sp, timeout_s=60), orch.stats())
        finally:
            orch.shutdown()
    (out, st), (jout, jst) = got["port"], got["ref"]
    assert out == colocated[:2] == [list(map(int, o)) for o in jout]
    assert st["fabric"] == jst["fabric"]
    assert all(e["backend"] == "rpc" for e in st["fabric"]["edges"])
    assert st["fabric"]["backends"] == {"rpc": 2}


def test_injected_device_connector_gets_device_edges(weights, prompts, colocated):
    """An injected DeviceKVConnector outranks config.connector (left at its
    "inproc" default): the degenerate topology keys on the effective
    primary, or every transfer would ride the RPC fallback."""
    conn = DeviceKVConnector(transport=DeviceTransport("t-injected", devices=["cpu"]))
    orch = _orch(weights, "t-injected", inject=conn)
    try:
        assert orch.generate(prompts[:2], _greedy(), timeout_s=60) == colocated[:2]
        st = orch.stats()
    finally:
        orch.shutdown()
    assert all(e["backend"] == "device" for e in st["fabric"]["edges"])
    assert st["fabric"]["backends"] == {"device": 2}
    assert set(orch.connectors) == {"device", "rpc"}
    assert isinstance(make_connector("rpc"), RpcKVConnector)


# ---------------------------------------------------------------------------
# the fetch plane over the device and RPC backends
# ---------------------------------------------------------------------------

BS = 16
SYS = [int(x) for x in np.random.RandomState(0).randint(3, 200, size=5 * BS)]
KV_KW = dict(num_blocks=16, block_size=BS, max_num_seqs=4, max_prefill_len=128)


def _suffix(seed, n=BS):
    return [int(x) for x in np.random.RandomState(seed).randint(3, 200, size=n)]


def _gen(eng, prompt, sp, rid, prefetch_wait=False):
    eng.add_request(prompt, sp, request_id=rid)
    if prefetch_wait:
        assert eng.kvfetch.wait_idle(30)
    toks = cached = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished and o.request_id == rid:
                toks, cached = list(o.output_token_ids), o.num_cached_tokens
    return toks, cached


def _warm_and_spill(eng, tag):
    sp = SamplingParams(max_tokens=4, temperature=0.0)
    _gen(eng, SYS + _suffix(1), sp, f"{tag}-warm", prefetch_wait=True)
    for i in range(4):
        p = [int(x) for x in np.random.RandomState(100 + i).randint(3, 200, size=112)]
        _gen(eng, p, sp, f"{tag}-fill-{i}", prefetch_wait=True)
    mgr = eng.kvtier
    assert mgr.flush_spills()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        with mgr._lock:
            if not mgr._gathering and not mgr._pending:
                break
        time.sleep(0.002)
    assert mgr.stats()["host"]["entries"] > 0
    mgr.flush_index(force=True)


def _fetch_run(weights, backend):
    """Owner and cold engines over one backend: the cold engine's greedy and
    seeded tokens and what its fetch counted."""
    made, closers = [], []

    def engine(kvtier=True):
        eng = LLMEngine(EngineConfig(model=FP32_TINY, kvtier=kvtier, **KV_KW), params=weights[1],
                        device="cpu")
        made.append(eng)
        return eng

    try:
        idx, reg = LocalPrefixIndex(), LocalFetchRegistry()
        owner, cold = engine(), engine()
        reg.register("owner", owner.kvtier)
        reg.register("cold", cold.kvtier)
        addr = None
        if backend == "local":
            client = LocalFetchClient(reg)
        elif backend == "device":
            client = DeviceFetchClient(reg, transport=DeviceTransport(f"kvf-{backend}",
                                                                      devices=["cpu"]))
        else:
            srv = RpcFetchServer()
            closers.append(srv.stop)
            addr = srv.register_source("owner", owner.kvtier)
            client = RpcFetchClient()
        closers.append(client.close)
        owner.kvtier.attach_index(idx, engine_key="owner", fetch_addr=addr)
        cold.kvtier.attach_index(idx, engine_key="cold")
        cold.kvfetch.attach(client)
        _warm_and_spill(owner, f"own-{backend}")
        out = {}
        for name, sp in (("greedy", SamplingParams(max_tokens=8, temperature=0.0)),
                         ("seeded", SamplingParams(max_tokens=8, temperature=1.0, seed=1234,
                                                   top_k=5))):
            prompt = SYS + _suffix(2 if name == "greedy" else 3)
            toks, cached = _gen(cold, prompt, sp, f"the-{name}", prefetch_wait=True)
            ref, _ = _gen(engine(kvtier=None), prompt, sp, f"the-{name}")
            assert toks == ref, f"{backend}/{name} tokens diverged"
            assert cached >= len(SYS)
            out[name] = (toks, cached)
        st = cold.kvfetch.stats()
        assert st["client"]["backend"] == backend and st["client"]["bytes_fetched"] > 0
        return (out, st["remote"], st["client"]["num_blocks"], st["client"]["bytes_fetched"],
                owner.kvtier.stats()["fetch_served"])
    finally:
        for c in closers:
            c()
        for eng in made:
            eng.close()


@pytest.mark.parametrize("backend", ["device", "rpc"])
def test_cross_engine_identity_over_device_and_rpc(weights, backend):
    """A cold engine pulls the spilled prefix over the backend and serves
    greedy and seeded requests as a cold prefill does, the whole prefix
    counted cached; tokens and counts equal the local backend's (which
    tests/test_torch_kvfetch.py holds against the reference pair)."""
    got = _fetch_run(weights, backend)
    assert got == _fetch_run(weights, "local")
    _out, remote, blocks, _nbytes, served = got
    assert remote["fetches"] >= 1 and remote["blocks"] >= 5 and blocks >= 5
    assert served["blocks"] >= 5


def test_dead_rpc_fetch_source_is_a_bounded_typed_failure():
    srv = RpcFetchServer()
    addr = srv.address
    srv.stop()
    client = RpcFetchClient(timeout_s=1.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(KVFetchError, match="failed"):
            client.fetch("owner", addr, [1], [(1, 2)], timeout_s=1.0)
        assert time.monotonic() - t0 < 15
        with pytest.raises(KVFetchError, match="fetch_addr"):
            client.fetch("owner", None, [1], [(1, 2)])
        assert client.stats()["num_failures"] == 2
    finally:
        client.close()
