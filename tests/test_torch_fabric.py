"""The device fabric of ray_tpu_torch (``fabric/``, the device-sealed KV
handoff, ``DeviceKVConnector`` and the orchestrator's per-edge transport)
held against ray_tpu.fabric on the CPU.

Mirrors tests/test_fabric.py: the device checksum, the ``ArrayBundle`` seal
and ``KVHandoff.seal(device=True)`` give the reference's u32 for the same
bytes (exact); device corruption is caught and leaves the sender's tensor
intact; a full backlog fails the sender; two transport instances share one
plane; the topology's edges, fallback state and wire form equal the
reference's; and ``DisaggOrchestrator(connector="device")`` on LLAMA_TINY
fp32 (the reference's weights) gives the reference's greedy tokens and the
colocated engine's, with zero decode-side prefill, and the reference's
``stats()["fabric"]`` with no fault and under each device fault kind (one
edge degraded to RPC under the budget). The RPC plane's cases are in
tests/test_torch_rpc.py.
"""

import asyncio
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import chaos as jchaos
from ray_tpu.fabric import ArrayBundle as JArrayBundle
from ray_tpu.fabric import FabricTopology as JFabricTopology
from ray_tpu.fabric.transport import device_checksum as jdevice_checksum
from ray_tpu.llm.disagg import DisaggConfig as JDisaggConfig
from ray_tpu.llm.disagg import DisaggOrchestrator as JDisaggOrchestrator
from ray_tpu.llm.disagg.handoff import KVHandoff as JKVHandoff
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.serve.proxy import Request as HttpRequest
from ray_tpu_torch import chaos
from ray_tpu_torch.fabric import (
    ArrayBundle,
    DeviceKVConnector,
    DeviceTransport,
    FabricTopology,
    FabricTransferError,
    device_checksum,
)
from ray_tpu_torch.fabric.transport import corrupt_on_device
from ray_tpu_torch.llm import ByteTokenizer, EngineConfig, LLMConfig, LLMEngine, LLMServer
from ray_tpu_torch.llm import SamplingParams
from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator, KVHandoff
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util.metrics import registry_snapshot

pytestmark = [pytest.mark.torch_port, pytest.mark.fabric]
torch.set_num_threads(2)

CPU = torch.device("cpu")
J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_fabric.py's engine_config
ENGINE_KW = dict(num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=64)


def _greedy(cls=SamplingParams):
    return cls(max_tokens=10, temperature=0.0, ignore_eos=True)


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


def _transport(ns, **kw):
    return DeviceTransport(namespace=ns, devices=[CPU], **kw)


def _orch(weights, tag, **kw):
    return DisaggOrchestrator(DisaggConfig(engine=EngineConfig(model=FP32_TINY, **ENGINE_KW), **kw),
                              params=weights[1], model_tag=tag, device="cpu")


def _jorch(weights, tag, **kw):
    return JDisaggOrchestrator(JDisaggConfig(engine=JEngineConfig(model=J_FP32_TINY, **ENGINE_KW),
                                             **kw), params=weights[0], seed=0, model_tag=tag)


# ---------------------------------------------------------------------------
# the device checksum, bundles and the device-sealed handoff (exact)
# ---------------------------------------------------------------------------


def _pair(dtype: str, shape=(3, 5, 7)):
    """The same bytes as a torch tensor and a jax array (numpy seed 0)."""
    x = np.random.default_rng(0).standard_normal(shape) * 100.0
    if dtype == "bfloat16":
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    a = x.astype(dtype)
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32", "int8", "uint8",
                                   "empty"])
def test_device_checksum_equals_reference(dtype):
    if dtype == "empty":
        t, j = torch.empty(0), jnp.zeros((0,), jnp.float32)
    else:
        t, j = _pair(dtype)
    # the same bytes in both packages
    assert np.asarray(j).tobytes() == t.reshape(-1).view(torch.uint8).numpy().tobytes()
    assert device_checksum(t) == jdevice_checksum(j)


def test_array_bundle_checksum_equals_reference_and_binds_names():
    a, ja = _pair("float32", (64,))
    b, jb = _pair("bfloat16", (64,))
    bundle = ArrayBundle("b0", {"k_pages": a, "v_pages": b}).seal()
    assert bundle.checksum == JArrayBundle("b0", {"k_pages": ja, "v_pages": jb}).seal().checksum
    assert bundle.verify()
    # a chained fold, not a commutative one: swapped contents fail
    x = torch.arange(64, dtype=torch.float32)
    y = x + 1.0
    same = ArrayBundle("b1", {"k_pages": x, "v_pages": y}).seal()
    assert not dataclasses.replace(same, arrays={"k_pages": y, "v_pages": x}).verify()
    assert bundle.nbytes == 64 * 4 + 64 * 2


def test_device_sealed_handoff_checksum_equals_reference():
    k, jk = _pair("float32", (2, 2, 5, 8))
    v, jv = _pair("bfloat16", (2, 2, 5, 8))
    toks = dict(prompt_token_ids=[5, 6, 7, 8, 9], output_token_ids=[11])
    h = KVHandoff(request_id="d", sampling_params=None, seed_base=0, num_kv_tokens=5, k_pages=k,
                  v_pages=v, model_sig=(2, 2, 8), **toks).seal(device=True)
    jh = JKVHandoff(request_id="d", sampling_params=None, key_data=np.zeros(2, np.uint32),
                    num_kv_tokens=5, k_pages=jk, v_pages=jv, model_sig=(2, 2, 8),
                    **toks).seal(device=True)
    assert h.checksum_kind == jh.checksum_kind == "device_u32"
    assert h.checksum == jh.checksum
    assert h.verify()
    assert not dataclasses.replace(h, k_pages=h.v_pages.float(), v_pages=h.k_pages).verify()
    assert not dataclasses.replace(h, output_token_ids=[12]).verify()
    host = h.to_host()
    assert host.checksum_kind == "crc32" and host.verify()
    assert torch.equal(host.k_pages, k) and host.k_pages.device == CPU


def test_corrupt_on_device_fails_verify_and_leaves_the_sender_intact():
    for dtype in ("float32", "bfloat16"):
        t, _ = _pair(dtype, (128,))
        before = t.clone()
        bundle = ArrayBundle("b0", {"w": t}).seal()
        bad = corrupt_on_device(t)
        assert bad.data_ptr() != t.data_ptr()
        assert not dataclasses.replace(bundle, arrays={"w": bad}).verify()
        assert bundle.verify() and torch.equal(t, before)
        # exactly 16 lanes in the middle flipped, as the reference does
        diff = (bad.view(torch.uint8) != t.view(torch.uint8)).nonzero()
        lane = t.element_size()
        assert diff.numel() > 0 and int(diff.min()) >= 64 * lane and int(diff.max()) < 80 * lane


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------


def test_transport_roundtrip_bounded_recv_and_unknown_endpoint():
    t = _transport("t-roundtrip")
    try:
        tok = t.register_endpoint("e0", device="cpu")
        a = torch.arange(256, dtype=torch.float32).reshape(16, 16)
        t.send_arrays(tok, {"x": a}, meta={"v": 7})
        b = t.recv_arrays("e0", timeout_s=2.0)
        assert b is not None and b.verify() and b.meta["v"] == 7
        assert b.arrays["x"].device == CPU and torch.equal(b.arrays["x"], a)
        assert b.arrays["x"].data_ptr() == a.data_ptr()  # its own device: by reference
        assert t.recv_arrays("e0", timeout_s=0.01) is None
        with pytest.raises(FabricTransferError, match="unknown"):
            t.send_arrays(("t-roundtrip", "nope"), {"x": a})
        assert t.stats()["num_sent"] == t.stats()["num_received"] == 1
    finally:
        t.close()


def test_two_transport_instances_share_one_plane():
    recv_t, send_t = _transport("t-xinst"), _transport("t-xinst")
    try:
        tok = recv_t.register_endpoint("e0", device="cpu")
        send_t.send_arrays(tok, {"x": torch.arange(64, dtype=torch.float32)})
        b = recv_t.recv_arrays("e0", timeout_s=2.0)
        assert b is not None and b.verify() and b.arrays["x"].device == CPU
        # the device pin travels with the endpoint, through the shared map
        assert send_t.endpoint_device("e0") == recv_t.endpoint_device("e0") == CPU
    finally:
        recv_t.close()
        send_t.close()


def test_backlog_full_fails_the_sender():
    t = _transport("t-backlog", endpoint_capacity=2)
    try:
        tok = t.register_endpoint("e0")
        a = torch.arange(16, dtype=torch.float32)
        t.send_arrays(tok, {"x": a}, timeout_s=0.5)
        t.send_arrays(tok, {"x": a}, timeout_s=0.5)
        with pytest.raises(FabricTransferError, match="backlog"):
            t.send_arrays(tok, {"x": a}, timeout_s=0.05)
        assert t.num_dropped == 1
        assert t.recv_arrays("e0", timeout_s=1.0) is not None  # a free slot unblocks it
        t.send_arrays(tok, {"x": a}, timeout_s=0.5)
    finally:
        t.close()


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def _declare(cls):
    topo = cls()
    topo.add_pool("prefill", "prefill", "s0", 2)
    topo.add_pool("decode", "decode", "s1", 2)
    topo.add_pool("draft", "draft", "s2", 1)
    seen = [topo.edge_backend("prefill", "decode")]
    topo.link("s0", "s1")
    seen += [topo.shares_mesh("prefill", "decode"), topo.edge_backend("prefill", "decode"),
             topo.edge_backend("prefill", "draft")]
    topo.link("s1", "s2")
    seen += [topo.edge_backend("decode", "draft"),
             topo.mark_fallback("prefill", "decode", "chaos"),
             topo.mark_fallback("prefill", "decode", "again"),
             topo.edge_backend("prefill", "decode"), topo.fallbacks(),
             topo.edge_backend("decode", "prefill")]
    topo.set_edge_backend("draft", "prefill", "inproc")
    seen += [topo.edges(), topo.to_dict(), topo.pool_of_role("decode"), topo.pools()]
    clone = cls.from_dict(topo.to_dict())
    seen += [clone.edges(), clone.to_dict(), clone.fallbacks()]
    with pytest.raises(ValueError, match="backend"):
        topo.set_edge_backend("prefill", "decode", "carrier-pigeon")
    return seen


def test_topology_equals_reference():
    got, ref = _declare(FabricTopology), _declare(JFabricTopology)
    assert got == ref
    assert got[0] == "rpc" and got[2] == "device" and got[7] == "rpc"
    assert got[8] == {"prefill->decode": "chaos"}
    # the wire form carries the declaration, not the runtime fallback state
    assert dict(((e["src"], e["dst"]), e["backend"]) for e in got[14])[("prefill", "decode")] \
        == "device"


# ---------------------------------------------------------------------------
# the engine's device export and the orchestrator over the device plane
# ---------------------------------------------------------------------------


def test_device_export_import_zero_copy(weights, prompts):
    pre = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=weights[1], device="cpu")
    pre.add_request(prompts[0], _greedy(), request_id="d1")
    pre.step()
    h = pre.export_request("d1", keep_on_device=True)
    assert h.checksum_kind == "device_u32" and h.verify()
    assert set(h.timings) == {"gather_ms", "seal_ms"}  # no pin, no d2h
    conn = DeviceKVConnector(transport=_transport("t-zero-copy"))
    try:
        conn.send(conn.register_target("d0", device="cpu"), h)
        got = conn.recv("d0", timeout_s=2.0)
    finally:
        conn.close()
    assert got.k_pages is h.k_pages and got.checksum == h.checksum and got.verify()
    assert got.timings == h.timings and got.src_engine == h.src_engine
    dec = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=weights[1], device="cpu")
    cache_k = dec.cache["k"]
    dec.import_handoff(got)
    assert dec.cache["k"] is cache_k and dec.num_prefill_batches == 0
    out = {}
    while dec.has_unfinished():
        for o in dec.step():
            if o.finished:
                out[o.request_id] = o.output_token_ids
    ref = LLMEngine(EngineConfig(model=FP32_TINY, **ENGINE_KW), params=weights[1],
                    device="cpu").generate([prompts[0]], _greedy())
    assert out["d1"] == ref[0]


def _serve(orch, prompts, sp, first_alone):
    try:
        if first_alone:
            out = orch.generate(prompts[:1], sp, timeout_s=120)
            out += orch.generate(prompts[1:], sp, timeout_s=120)
        else:
            out = orch.generate(prompts, sp, timeout_s=120)
        return out, orch.stats()
    finally:
        orch.shutdown()


FAULTS = {"none": None, "drop": "drop_device_transfer", "corrupt": "corrupt_device_transfer"}


@pytest.mark.parametrize("fault", ["none", "drop", "corrupt"])
def test_device_orchestrator_equals_reference(weights, prompts, colocated, fault):
    """Greedy tokens equal the reference orchestrator's and the colocated
    engine's with zero decode-side prefill; ``stats()["fabric"]`` equals
    the reference's. Under a device fault (dropped before the move, or
    corrupt and caught by the device checksum where it arrives) exactly
    the faulted edge degrades to RPC and the request re-prefills once."""
    kind = FAULTS[fault]
    num_decode = 2 if kind is None else 1
    got = {}
    for pkg, harness in (("ref", jchaos), ("port", chaos)):
        sched = None
        if kind is not None:
            sched = harness.install(harness.FaultSchedule(7, [
                harness.FaultSpec(kind, site="disagg.kv_transfer", max_fires=1)]))
        try:
            t0 = time.time()
            if pkg == "ref":
                out, st = _serve(_jorch(weights, f"t-fab-{fault}", num_decode=num_decode,
                                        connector="device"),
                                 prompts, _greedy(JSamplingParams), kind is not None)
            else:
                out, st = _serve(_orch(weights, f"t-fab-{fault}", num_decode=num_decode,
                                       connector="device"),
                                 prompts, _greedy(), kind is not None)
            assert time.time() - t0 < 60  # bounded, not a hang
            got[pkg] = (out, st, sched.fired_kinds() if sched else [])
        finally:
            harness.uninstall()
    (out, st, fired), (jout, jst, jfired) = got["port"], got["ref"]
    assert out == colocated
    assert out == [list(map(int, o)) for o in jout]
    assert st["fabric"] == jst["fabric"]
    assert all(e["num_prefill_batches"] == 0 for e in st["decode"])
    assert sum(e["num_kv_imports"] for e in st["decode"]) == len(prompts)
    assert st["transfer"]["kv_transfers"] == jst["transfer"]["kv_transfers"]
    assert st["transfer"]["reprefills"] == jst["transfer"]["reprefills"]
    assert st["transfer"]["bytes_sent"] > 0
    if kind is None:
        assert st["fabric"]["backends"] == {"device": len(prompts)}
        assert st["fabric"]["fallbacks"] == 0
        assert all(e["backend"] == "device" for e in st["fabric"]["edges"])
    else:
        assert fired == jfired == [kind]
        assert st["transfer"]["reprefills"] == 1 and st["fabric"]["fallbacks"] == 1
        assert st["fabric"]["edges"] == [{"src": "prefill0", "dst": "decode0", "backend": "rpc"}]
        assert st["fabric"]["backends"].get("rpc", 0) >= 1


def test_llm_server_device_stats_carry_the_fabric(weights):
    """LLMConfig(disagg={connector: device}) serves through the device plane
    and GET /v1/stats carries the edges and backends."""
    tok = ByteTokenizer(FP32_TINY.vocab_size)
    body = {"prompt": "fabric stats", "max_tokens": 6, "temperature": 0.0}
    direct = LLMEngine(EngineConfig(model=FP32_TINY, eos_token_id=tok.eos_token_id, **ENGINE_KW),
                       params=weights[1], device="cpu").generate(
        [tok.encode(body["prompt"])], SamplingParams(max_tokens=6, temperature=0.0))[0]
    want = tok.decode(direct[:-1] if direct and direct[-1] == tok.eos_token_id else direct)
    srv = LLMServer(LLMConfig(model_id="t-oai-fab", engine=EngineConfig(model=FP32_TINY,
                                                                        **ENGINE_KW),
                              params=weights[1], device="cpu",
                              disagg={"num_prefill": 1, "num_decode": 1, "connector": "device"}))
    try:
        def req(method, path, b=None):
            return HttpRequest(method, path, {}, {},
                               b"" if b is None else json.dumps(b).encode())

        out = asyncio.run(srv(req("POST", "/v1/completions", body)))
        stats = asyncio.run(srv(req("GET", "/v1/stats")))
    finally:
        srv.shutdown()
    assert out["choices"][0]["text"] == want
    assert stats["mode"] == "disagg"
    assert stats["fabric"]["backends"] == {"device": 1}
    assert all(e["backend"] == "device" for e in stats["fabric"]["edges"])
    assert stats["fabric"]["fallbacks"] == 0
    assert stats["decode"][0]["num_prefill_batches"] == 0
    names = {m.name for m in registry_snapshot()}
    assert "ray_tpu_fabric_edges_active" in names
