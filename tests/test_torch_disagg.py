"""Disaggregated prefill/decode serving in ray_tpu_torch (llm/disagg and the
engine's KV handoff) held against ray_tpu.llm.disagg on the CPU.

Mirrors tests/test_llm_disagg.py on a tiny fp32 model whose weights come
from the JAX package: the allocator's listener trace, the exported pages
(2e-5) and their hygiene, a handoff exported by the reference imported by
the port, the in-process connector, greedy token identity of the port's
orchestrator with its colocated engine and the reference's orchestrator,
the pinned mixed-batch divergence, seeded streams across the hop, drops and
corruption injected through the connector's chaos gate (``disagg.kv_transfer``),
the ``llm.kv_transfer`` spans and ``llm_kv_transfer_*`` series against the
reference orchestrator's, and LLMServer(disagg=).
"""

import asyncio
import dataclasses
import json
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import obs as jobs
from ray_tpu.llm import kv_cache as jkv
from ray_tpu.llm.disagg import DisaggConfig as JDisaggConfig
from ray_tpu.llm.disagg import DisaggOrchestrator as JDisaggOrchestrator
from ray_tpu.llm.disagg import KVTransferError as JKVTransferError
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.openai_api import LLMConfig as JLLMConfig
from ray_tpu.llm.openai_api import LLMServer as JLLMServer
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.obs import slo as jslo
from ray_tpu.serve.proxy import Request as HttpRequest
from ray_tpu_torch import chaos, obs
from ray_tpu_torch.llm import ByteTokenizer, EngineConfig, LLMConfig, LLMEngine, LLMServer
from ray_tpu_torch.llm import SamplingParams
from ray_tpu_torch.llm import kv_cache as tkv
from ray_tpu_torch.llm.disagg import (
    DisaggConfig,
    DisaggOrchestrator,
    InProcessConnector,
    KVHandoff,
    KVTransferError,
    make_connector,
)
from ray_tpu_torch.llm.disagg.connector import _corrupt_handoff
from ray_tpu_torch.llm.engine import RequestStatus
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.obs import slo as tslo

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
# tests/test_llm_disagg.py's engine_config
ENGINE_KW = dict(num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=64)
MAX_TOKENS = 10
BAND = 2e-5


def _greedy(cls=SamplingParams, n=MAX_TOKENS):
    return cls(max_tokens=n, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jp, tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [[int(x) for x in rng.integers(3, 120, rng.integers(8, 24))] for _ in range(4)]


def _cfg(**kw):
    return EngineConfig(model=FP32_TINY, **{**ENGINE_KW, **kw})


def _jcfg(**kw):
    return JEngineConfig(model=J_FP32_TINY, **{**ENGINE_KW, **kw})


def _port(weights, **kw):
    return LLMEngine(_cfg(**kw), params=weights[1], device="cpu")


def _orch(weights, tag, connector=None, engine=None, **kw):
    return DisaggOrchestrator(DisaggConfig(engine=engine or _cfg(), **kw), params=weights[1],
                              model_tag=tag, connector=connector, device="cpu")


def _finish(eng) -> dict:
    got = {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                got[o.request_id] = list(o.output_token_ids)
    return got


@pytest.fixture(scope="module")
def colocated(weights, prompts):
    """The port's colocated greedy tokens, mixed batching off and on."""
    return {mixed: _port(weights, mixed_batch=mixed, mixed_prefill_chunk=8).generate(
        prompts, _greedy()) for mixed in (False, True)}


# ---------------------------------------------------------------------------
# the allocator's handoff surface
# ---------------------------------------------------------------------------


def _allocator_trace(mod, seed: int) -> list:
    """One random trace through a BlockAllocator of ``mod``: admissions with
    prefix matches (few token values, so prefixes repeat), seals, frees,
    evictions under pressure, salted and full drops, and the read-only
    probes; every listener call and probe result in order."""
    alloc = mod.BlockAllocator(12, 4)
    log = []
    alloc.seal_listener = lambda *a: log.append(("seal", *a))
    alloc.evict_listener = lambda *a: log.append(("evict", *a))
    alloc.drop_listener = lambda *a: log.append(("drop", *a))
    rng = np.random.default_rng(seed)
    live, hashes = [], []

    def tokens():
        return [int(x) for x in rng.integers(1, 4, int(rng.integers(3, 17)))]

    for _ in range(400):
        op = int(rng.integers(0, 7))
        salt = int(rng.integers(0, 3))
        if op in (0, 1):
            toks = tokens()
            seq = mod.SequenceBlocks(alloc)
            seq.chain = salt
            blocks, matched, chain = alloc.match_prefix(toks, salt)
            if blocks:
                seq.adopt_prefix(blocks, chain, matched)
            try:
                seq.ensure_capacity(len(toks))
            except mod.NoFreeBlocksError:
                seq.release()
                log.append(("full", len(toks)))
                continue
            seq.seal_full_blocks(toks)
            hashes.append(seq.chain)
            live.append(seq)
        elif op == 2 and live:
            live.pop(int(rng.integers(0, len(live)))).release()
        elif op == 3:
            alloc.drop_prefix_cache(salt=None if rng.random() < 0.3 else salt)
        elif op == 4:
            log.append(("probe", alloc.probe_prefix(tokens(), salt)))
        elif op == 5 and hashes:
            log.append(("contains", alloc.contains_hash(hashes[int(rng.integers(0, len(hashes)))])))
        else:
            log.append(("need", alloc.probe_admission_need(tokens(), salt)))
        log.append(("free", alloc.num_free))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_listener_trace_equals_reference(seed):
    ref = _allocator_trace(jkv, seed)
    got = _allocator_trace(tkv, seed)
    kinds = {e[0] for e in ref}
    assert {"seal", "evict", "drop", "probe", "contains"} <= kinds, kinds
    assert got == ref


# ---------------------------------------------------------------------------
# export / import on the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(weights, prompts):
    """The same prompt prefilled and exported by the reference and by the
    port (greedy: the first token is the same)."""
    jpre = JLLMEngine(_jcfg(), params=weights[0], seed=0)
    jpre.add_request(prompts[0], _greedy(JSamplingParams), request_id="x1")
    jpre.step()
    pre = _port(weights)
    pre.add_request(prompts[0], _greedy(), request_id="x1")
    outs = pre.step()
    assert len(pre.running) == 1
    req = pre.requests["x1"]
    h = pre.export_request("x1")
    return jpre.export_request("x1"), pre, outs, req, h


def test_exported_pages_equal_reference(prompts, exported):
    jh, _pre, outs, _req, h = exported
    assert h.num_kv_tokens == jh.num_kv_tokens == len(prompts[0])
    assert h.output_token_ids == list(jh.output_token_ids) == outs[0].output_token_ids
    assert h.prompt_token_ids == list(jh.prompt_token_ids)
    assert h.model_sig == tuple(jh.model_sig)
    assert tuple(h.k_pages.shape) == tuple(np.shape(jh.k_pages))
    for got, ref in ((h.k_pages, jh.k_pages), (h.v_pages, jh.v_pages)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=BAND)
    assert h.nbytes == jh.nbytes
    assert set(h.timings) == {"gather_ms", "seal_ms"}  # no host copy on the CPU


def test_export_hygiene_and_checksum(weights, prompts, exported):
    _jh, pre, _outs, req, h = exported
    # the prefill side dropped ownership; every block is reclaimable and the
    # sealed prefix stays resurrectable (a re-prefill hits it)
    assert pre.requests == {} and pre.running == []
    assert req.status == RequestStatus.MIGRATED
    assert pre.allocator.num_free == pre.config.num_blocks
    assert pre.allocator.probe_prefix(prompts[0]) > 0
    assert h.verify()
    bad = _corrupt_handoff(h)
    assert not bad.verify()
    assert h.verify()  # the original is untouched
    with pytest.raises(ValueError, match="not RUNNING"):
        pre.export_request("x1")


def test_import_refusals(weights, exported):
    _jh, _pre, _outs, _req, h = exported
    dec = _port(weights)
    with pytest.raises(ValueError, match="signature"):
        dec.import_handoff(dataclasses.replace(h, model_sig=(1, 1, 4)))
    with pytest.raises(ValueError, match="disagree"):
        dec.import_handoff(dataclasses.replace(h, num_kv_tokens=h.num_kv_tokens - 1))
    assert dec.allocator.num_free == dec.config.num_blocks  # refused before writing
    dec.import_handoff(dataclasses.replace(h, timings={}))
    with pytest.raises(ValueError, match="already live"):
        dec.import_handoff(dataclasses.replace(h, timings={}))
    tiny = _port(weights, num_blocks=1)
    with pytest.raises(tkv.NoFreeBlocksError):
        tiny.import_handoff(dataclasses.replace(h, timings={}))
    assert tiny.allocator.num_free == 1 and tiny.requests == {}


def test_import_zero_recompute_and_hygiene(weights, prompts, exported):
    _jh, _pre, _outs, _req, h = exported
    prompt = prompts[0]
    dec = _port(weights)
    total = dec.config.num_blocks
    rid = dec.import_handoff(dataclasses.replace(h, timings={}))
    req = dec.requests[rid]
    assert req.seq.num_cached_tokens >= len(prompt)
    assert req.seed_base == h.seed_base
    assert dec.num_prefill_batches == 0 and dec.stats()["num_kv_imports"] == 1
    assert total - len(dec.allocator._free) == dec.allocator.blocks_needed(req.num_tokens)
    # imported full blocks are sealed into the decode engine's prefix cache
    n = (len(prompt) // 8) * 8
    assert dec.peek_prefix_tokens(prompt) == n > 0
    assert dec.peek_prefix_tiered(prompt) == {"n_tokens": n, "discounted": float(n),
                                              "by_tier": {"hbm": n}}
    _finish(dec)
    assert dec.allocator.num_free == total
    assert dec.num_prefill_batches == 0


def test_reference_handoff_continues_on_the_port(weights, prompts):
    """A handoff the reference exported, carried over to the port's KVHandoff
    (greedy: the sampler key plays no part), continues on a port decode
    engine with the reference decode engine's tokens."""
    jpre = JLLMEngine(_jcfg(), params=weights[0], seed=0)
    jpre.add_request(prompts[1], _greedy(JSamplingParams), request_id="c1")
    jpre.step()
    jh = jpre.export_request("c1")
    jdec = JLLMEngine(_jcfg(), params=weights[0], seed=0)
    jdec.import_handoff(jh)
    ref = _finish(jdec)["c1"]
    h = KVHandoff(
        request_id=jh.request_id, prompt_token_ids=list(jh.prompt_token_ids),
        output_token_ids=list(jh.output_token_ids), sampling_params=_greedy(), seed_base=0,
        num_kv_tokens=jh.num_kv_tokens, k_pages=torch.from_numpy(np.array(jh.k_pages)),
        v_pages=torch.from_numpy(np.array(jh.v_pages)), model_sig=tuple(jh.model_sig),
    ).seal()
    dec = _port(weights)
    dec.import_handoff(h)
    assert _finish(dec)["c1"] == ref
    assert len(ref) == MAX_TOKENS


def test_refusals_name_their_roadmap_items(weights, exported):
    _jh, _pre, _outs, _req, h = exported
    with pytest.raises(NotImplementedError, match="C1"):
        h.seal(device=True)
    with pytest.raises(NotImplementedError, match="C1"):
        h.to_host()
    with pytest.raises(NotImplementedError, match="C1"):
        dataclasses.replace(h, checksum_kind="device_u32").verify()
    eng = _port(weights)
    eng.add_request([1, 2, 3], _greedy(), request_id="k")
    eng.step()
    with pytest.raises(NotImplementedError, match="C1"):
        eng.export_request("k", keep_on_device=True)
    with pytest.raises(NotImplementedError, match="C5/B8"):
        make_connector("rpc")
    with pytest.raises(NotImplementedError, match="C1"):
        make_connector("device")
    with pytest.raises(NotImplementedError, match="C5/B8"):
        DisaggConfig(engine=_cfg(), connector="rpc")
    with pytest.raises(NotImplementedError, match="C1"):
        DisaggConfig(engine=_cfg(), fabric={"pools": []})
    with pytest.raises(ValueError, match="unknown KV connector"):
        DisaggConfig(engine=_cfg(), connector="carrier-pigeon")
    with pytest.raises(NotImplementedError, match="C3"):
        DisaggConfig(engine={"model": FP32_TINY, "kvtier": {"host_blocks": 8}})


# ---------------------------------------------------------------------------
# the in-process connector
# ---------------------------------------------------------------------------


def test_inproc_connector_roundtrip_and_namespaces(exported):
    _jh, _pre, _outs, _req, h = exported
    a = InProcessConnector(namespace="t-roundtrip-a")
    b = InProcessConnector(namespace="t-roundtrip-b")
    a.send(a.register_target("d0"), h)
    b.register_target("d0")
    assert b.recv("d0", timeout_s=0.01) is None  # another namespace sees nothing
    got = a.recv("d0", timeout_s=1.0)
    assert got is h and got.verify()
    assert a.recv("d0", timeout_s=0.01) is None  # bounded, no hang
    assert a.stats() == {"connector": "inproc", "num_sent": 1, "num_received": 1,
                         "num_dropped": 0, "bytes_sent": h.nbytes}
    with pytest.raises(KVTransferError, match="unknown KV target"):
        a.send("nope", h)
    a.close()
    b.close()


def test_same_tag_orchestrators_do_not_cross_deliver(weights, prompts, colocated):
    a = _orch(weights, "twin")
    b = _orch(weights, "twin")
    try:
        assert a.connector.namespace != b.connector.namespace
        assert a.generate(prompts[:2], _greedy(), timeout_s=60) == colocated[False][:2]
        assert b.generate(prompts[:1], _greedy(), timeout_s=60) == colocated[False][:1]
    finally:
        a.shutdown()
        b.shutdown()


# ---------------------------------------------------------------------------
# the orchestrator end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_disagg(weights, prompts):
    orch = JDisaggOrchestrator(JDisaggConfig(engine=_jcfg(), num_prefill=1, num_decode=2),
                               params=weights[0], seed=0, model_tag="t-ref")
    try:
        return orch.generate(prompts, _greedy(JSamplingParams), timeout_s=120)
    finally:
        orch.shutdown()


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_greedy_identity_colocated_vs_disagg(weights, prompts, colocated, reference_disagg,
                                             mixed):
    orch = _orch(weights, f"t-greedy-{mixed}", num_decode=2,
                 engine=_cfg(mixed_batch=mixed, mixed_prefill_chunk=8))
    try:
        out = orch.generate(prompts, _greedy(), timeout_s=60)
        s = orch.stats()
    finally:
        orch.shutdown()
    assert out == colocated[mixed]
    if not mixed:
        assert out == reference_disagg
    assert all(e["num_prefill_batches"] == 0 for e in s["decode"])
    assert all("mixed" not in e for e in s["decode"])
    assert sum(e.get("num_kv_imports", 0) for e in s["decode"]) == len(prompts)
    assert s["transfer"]["kv_transfers"] == s["transfer"]["imported"] == len(prompts)
    assert s["transfer"]["reprefills"] == 0 and s["transfer"]["bytes_sent"] > 0
    assert s["transfer"]["bytes_imported"] == s["transfer"]["bytes_sent"]
    # in-transit handoffs count in the depth, so a burst spreads
    assert all(e.get("num_kv_imports", 0) > 0 for e in s["decode"])
    assert orch.num_inflight() == 0


def test_mixed_prefill_export_divergence(weights):
    """The reference's prefill loop exports rows still mid-prompt in a mixed
    batch, which export_request refuses, until the re-prefill budget is
    spent; the port exports only complete prompts and returns the colocated
    tokens (DisaggConfig's docstring)."""
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(3, 120, 30)] for _ in range(2)]
    kw = dict(mixed_batch=True, mixed_prefill_chunk=8)
    ref = JDisaggOrchestrator(JDisaggConfig(engine=_jcfg(**kw)), params=weights[0], seed=0,
                              model_tag="t-div-ref")
    try:
        with pytest.raises(JKVTransferError, match="prefill_death:ValueError.*budget"):
            ref.generate(prompts, _greedy(JSamplingParams, 8), timeout_s=60)
    finally:
        ref.shutdown()
    orch = _orch(weights, "t-div", engine=_cfg(**kw))
    try:
        out = orch.generate(prompts, _greedy(n=8), timeout_s=60)
        assert orch.num_reprefills == 0 and orch.num_transfers == 2
    finally:
        orch.shutdown()
    assert out == _port(weights, **kw).generate(prompts, _greedy(n=8))
    # export_request keeps the reference's refusal of a mid-prompt row
    eng = _port(weights, **kw)
    eng.add_request(prompts[0], _greedy(n=8), request_id="m")
    eng.step()
    with pytest.raises(ValueError, match="mid-prefill"):
        eng.export_request("m")


SEEDED = dict(max_tokens=MAX_TOKENS, temperature=0.9, top_k=8, top_p=0.95, seed=1234,
              ignore_eos=True)


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_seeded_stream_bit_for_bit_across_the_hop(weights, prompts, mixed):
    sp = SamplingParams(**SEEDED)
    rid = "seeded-handoff-1"
    eng = _port(weights, mixed_batch=mixed, mixed_prefill_chunk=8)
    eng.add_request(prompts[0], sp, request_id=rid)
    colocated = _finish(eng)[rid]
    orch = _orch(weights, f"t-seeded-{mixed}", engine=_cfg(mixed_batch=mixed,
                                                           mixed_prefill_chunk=8))
    try:
        _rid, q = orch.submit(prompts[0], sp, request_id=rid)
        out = None
        while out is None or not out.finished:
            out = q.get(timeout=60)
            assert not isinstance(out, BaseException)
    finally:
        orch.shutdown()
    assert out.output_token_ids == colocated and len(colocated) == MAX_TOKENS


def test_mixed_sampling_over_two_decode_engines(weights, prompts):
    sps = [
        _greedy(),
        SamplingParams(max_tokens=8, temperature=0.8, seed=7, ignore_eos=True),
        _greedy(),
        SamplingParams(max_tokens=6, temperature=1.1, top_p=0.9, seed=9, ignore_eos=True),
    ]
    rids = [f"ms-{i}" for i in range(4)]
    eng = _port(weights)
    for rid, p, sp in zip(rids, prompts, sps):
        eng.add_request(p, sp, request_id=rid)
    colocated = _finish(eng)
    orch = _orch(weights, "t-mixed-sampling", num_decode=2)
    try:
        subs = [orch.submit(p, sp, request_id=rid) for rid, p, sp in zip(rids, prompts, sps)]
        got = {}
        for rid, q in subs:
            out = None
            while out is None or not out.finished:
                out = q.get(timeout=60)
            got[rid] = out.output_token_ids
        s = orch.stats()
    finally:
        orch.shutdown()
    assert got == colocated
    for rid, sp in zip(rids, sps):
        assert len(got[rid]) == sp.max_tokens
    assert s["transfer"]["kv_transfers"] == 4
    assert [e.get("num_kv_imports", 0) > 0 for e in s["decode"]] == [True, True]


# ---------------------------------------------------------------------------
# the transfer plane fails safe
# ---------------------------------------------------------------------------


@pytest.fixture
def chaos_off():
    """A schedule is process-wide: uninstalled after every test that installs one."""
    yield
    chaos.uninstall()


def _gate(kind: str, max_fires=1):
    """A schedule that drops or corrupts the first ``max_fires`` handoffs at
    the connector's chaos gate (-1: every one)."""
    k = {"drop": chaos.DROP_KV_TRANSFER, "corrupt": chaos.CORRUPT_KV_TRANSFER}[kind]
    return chaos.install(chaos.FaultSchedule(7, [
        chaos.FaultSpec(k, site="disagg.kv_transfer", max_fires=max_fires)]))


@pytest.mark.parametrize("kind", ["drop", "corrupt"])
def test_lost_transfer_reprefills_not_hangs(weights, prompts, colocated, kind, chaos_off):
    sched = _gate(kind)
    orch = _orch(weights, f"t-lost-{kind}", num_prefill=2)
    try:
        out = orch.generate(prompts, _greedy(), timeout_s=60)
        assert out == colocated[False]  # the retry is lossless
        assert orch.num_reprefills == 1 and orch.num_transfer_failures == 1
        assert len(sched.log) == 1 and orch.num_transfers == len(prompts) + (kind == "corrupt")
        assert orch.connector.num_dropped == (kind == "drop")
        failed = [s for t in obs.get_recorder().traces(limit=256)
                  for s in obs.get_recorder().get(t["trace_id"])
                  if s.name == "llm.kv_transfer_failed" and f"t-lost-{kind}" in s.attrs["error"]]
        assert len(failed) == 1 and failed[0].status == "error"
    finally:
        orch.shutdown()


def test_transfer_budget_exhausts_loudly(weights, prompts, chaos_off):
    sched = _gate("drop", max_fires=-1)
    orch = _orch(weights, "t-budget", max_handoff_retries=1)
    try:
        with pytest.raises(KVTransferError, match="budget"):
            orch.generate([prompts[0]], _greedy(), timeout_s=30)
        assert len(sched.log) == 2 and orch.num_inflight() == 0
        assert orch.connector.num_dropped == 2
    finally:
        orch.shutdown()


def test_kv_transfer_spans_and_series_equal_reference(weights, prompts):
    """Each disaggregated request's trace holds its ``llm.kv_transfer`` span
    between prefill and decode and covers >= 90 %; the transfer series
    count one handoff per request, with the reference's labels and bytes."""
    out, views = [], []
    for pkg in ("ref", "port"):
        tag = f"t-xfer-{pkg}"
        if pkg == "ref":
            orch = JDisaggOrchestrator(JDisaggConfig(engine=_jcfg()), params=weights[0],
                                       seed=0, model_tag=tag)
            rec, slo_mod, sp = jobs.get_recorder(), jslo, _greedy(JSamplingParams)
            ctxs = [jobs.new_context() for _ in prompts]
        else:
            orch = _orch(weights, tag)
            rec, slo_mod, sp = obs.get_recorder(), tslo, _greedy()
            ctxs = [obs.new_context() for _ in prompts]
        try:
            subs = [orch.submit(p, sp, trace=c) for p, c in zip(prompts, ctxs)]
            got = {}
            for rid, q in subs:
                o = q.get(timeout=60)
                while not o.finished:
                    o = q.get(timeout=60)
                got[rid] = list(o.output_token_ids)
            out.append(sorted(got.values()))
        finally:
            orch.shutdown()
        view = []
        for c in ctxs:
            spans = rec.get(c.trace_id)
            names = [s.name for s in spans]
            xfer = [s for s in spans if s.name == "llm.kv_transfer"]
            assert len(xfer) == 1 and names.count("llm.request") == 1, names
            prefill = next(s for s in spans if s.name == "engine.prefill")
            assert xfer[0].start == pytest.approx(prefill.end, abs=1e-6)
            assert rec.summary(c.trace_id)["coverage_pct"] >= 90.0
            view.append((xfer[0].attrs["backend"], xfer[0].attrs["kv_tokens"],
                         xfer[0].attrs["bytes"]))
        hist = slo_mod.kv_transfer_histogram().hist_data()[(tag, "inproc")]
        nbytes = slo_mod.kv_transfer_bytes_counter().series()[(tag, "inproc")]
        views.append((sorted(view), hist[2], nbytes))
    assert out[1] == out[0]
    assert views[1] == views[0]
    assert views[1][1] == len(prompts)


def _fail_once(eng, at: int):
    """Make the ``at``-th step of ``eng`` raise after running."""
    step, calls = eng.step, [0]

    def faulty():
        calls[0] += 1
        outs = step()
        if calls[0] == at:
            raise RuntimeError(f"injected at step {at}")
        return outs

    eng.step = faulty


@pytest.mark.parametrize("pool", ["prefill", "decode"])
def test_engine_failure_recovers_with_the_same_tokens(weights, prompts, colocated, pool):
    """A prefill engine failing mid-step re-homes its requests through the
    re-prefill path; a decode engine failing recovers in place (the first
    rung of its ladder). Either way each position reaches the caller once
    and the tokens equal the colocated engine's."""
    orch = _orch(weights, f"t-fail-{pool}")
    eng = (orch._prefill if pool == "prefill" else orch._decode)[0].engine
    _fail_once(eng, 2 if pool == "decode" else 1)
    try:
        subs = [orch.submit(p, _greedy()) for p in prompts]
        got = []
        for _rid, q in subs:
            seen, out = [], None
            while out is None or not out.finished:
                out = q.get(timeout=60)
                assert not isinstance(out, BaseException), out
                seen += out.new_token_ids
            assert seen == out.output_token_ids  # each position once
            got.append(seen)
        s = orch.stats()
    finally:
        orch.shutdown()
    assert got == colocated[False]
    if pool == "prefill":
        assert s["transfer"]["reprefills"] >= 1
    else:
        assert s["decode"][0]["num_preemptions"] >= 1


def test_abort_anywhere(weights, prompts):
    orch = _orch(weights, "t-abort")
    try:
        rid, q = orch.submit(prompts[0], SamplingParams(max_tokens=200, temperature=0.0,
                                                        ignore_eos=True))
        out = q.get(timeout=60)  # the first token, from the prefill engine
        assert out.new_token_ids and not out.finished
        orch.abort(rid)
        while out is not None:
            out = q.get(timeout=60)
        assert orch.num_inflight() == 0
        # an abort mid-pipeline flushes the in-flight chunk; the engine holds
        # those outputs until its loop's next step() hands them out (and the
        # orchestrator drops them), so each engine is idle one step later
        for pe in orch._prefill + orch._decode:
            deadline = time.time() + 60
            while pe.call(lambda e=pe.engine: e.has_unfinished()):
                assert time.time() < deadline, f"{pe.role} engine {pe.index} never went idle"
                time.sleep(0.01)
            assert pe.call(lambda e=pe.engine: rid not in e.requests)
    finally:
        orch.shutdown()


# ---------------------------------------------------------------------------
# LLMServer(disagg=)
# ---------------------------------------------------------------------------


def _req(method, path, body=None):
    return HttpRequest(method, path, {}, {}, b"" if body is None else json.dumps(body).encode())


def test_llm_server_disagg(weights, prompts):
    texts = ["hello prefix", "a longer prompt of disaggregated serving"]
    body = {"max_tokens": 6, "temperature": 0.0}
    tok = ByteTokenizer(FP32_TINY.vocab_size)
    direct = _port(weights, eos_token_id=tok.eos_token_id).generate(
        [tok.encode(t) for t in texts], SamplingParams(max_tokens=6, temperature=0.0))
    want = [tok.decode(t[:-1] if t and t[-1] == tok.eos_token_id else t) for t in direct]
    ref = JLLMServer(JLLMConfig(model_id="t-oai-d", engine=_jcfg(), params=weights[0],
                                disagg={"num_prefill": 1, "num_decode": 1}))
    srv = LLMServer(LLMConfig(model_id="t-oai-d", engine=_cfg(), params=weights[1],
                              device="cpu", disagg={"num_prefill": 1, "num_decode": 1}))
    try:
        async def go(server):
            outs = await asyncio.gather(*[server(_req("POST", "/v1/completions",
                                                      {"prompt": t, **body})) for t in texts])
            return [o["choices"][0]["text"] for o in outs], await server(_req("GET", "/v1/stats"))

        got, stats = asyncio.run(go(srv))
        ref_text, ref_stats = asyncio.run(go(ref))
        assert got == want == ref_text
        assert stats["mode"] == "disagg"
        assert set(stats) == set(ref_stats) - {"fabric"}
        assert stats["transfer"]["kv_transfers"] == 2
        assert len(stats["prefill"]) == 1 and len(stats["decode"]) == 1
        assert stats["decode"][0]["num_prefill_batches"] == 0
        assert stats["decode"][0]["num_kv_imports"] == 2
        drained = srv.drain(timeout_s=5.0)
        assert drained == {"drained": True, "inflight": 0}
        late = asyncio.run(srv(_req("POST", "/v1/completions", {"prompt": "late", **body})))
        assert late["error"]["code"] == 503
    finally:
        srv.shutdown()
        ref.shutdown()


# ---------------------------------------------------------------------------
# shared state across threads
# ---------------------------------------------------------------------------


def test_launch_tallies_lose_nothing_across_threads():
    """count_launch from more threads than cores, switching often: the
    wrapper's count is the sum of every thread's own tally."""
    from ray_tpu_torch.ops.paged_attention import count_launch, thread_launches

    def wrapper():
        pass

    wrapper.launches = 0
    tallies, n, per = [], 16, 2000

    def work():
        before = thread_launches().get("stress", 0)
        for _ in range(per):
            count_launch(wrapper, "stress")
        tallies.append(thread_launches()["stress"] - before)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n * per and tallies == [per] * n


def test_concurrent_submits_and_aborts(weights, prompts, colocated):
    """Eight caller threads submit at once, switching often, two of them
    aborting their request after its first token: every other request ends
    with the colocated tokens, each position delivered once, nothing stays
    in flight, and every engine's blocks come back."""
    orch = _orch(weights, "t-stress", num_decode=2)
    results, errors = {}, []

    def caller(i):
        try:
            p = prompts[i % len(prompts)]
            rid, q = orch.submit(p, _greedy(), request_id=f"st-{i}")
            seen, out = [], None
            while out is None or not out.finished:
                out = q.get(timeout=60)
                if out is None:
                    results[i] = None  # aborted
                    return
                assert not isinstance(out, BaseException), out
                seen += out.new_token_ids
                if i in (1, 6) and seen:
                    orch.abort(rid)
            assert seen == out.output_token_ids
            results[i] = seen
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        orch.shutdown()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        if results[i] is not None:
            assert results[i] == colocated[False][i % len(prompts)]
    assert orch.num_inflight() == 0
    for pe in orch._prefill + orch._decode:
        assert pe.engine.requests == {}
        assert pe.engine.allocator.num_free == pe.engine.config.num_blocks
