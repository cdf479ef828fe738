"""The engine's request tracing and its series, held against the reference
engine on the CPU.

Both engines serve the same fp32 LLAMA_TINY weights and prompts (numpy
seeds); per request, the multiset of span names, the ``llm.request``
attributes and the SLO histogram counts must equal the reference's, and
the spans must cover >= 90 % of arrival -> finish (as
``tests/test_obs_trace.py`` asks of the reference). The pipelined chunk
controller picks chunk lengths from host timings, so both packages'
controllers are held at their initial length here: then the round
structure, and with it the span multiset, is a function of the trace.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import obs as jobs
from ray_tpu.llm import engine as jengine_mod
from ray_tpu.llm import pipeline as jpipeline
from ray_tpu.llm import spec as jspec
from ray_tpu.llm.spec import stats as jspec_stats
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu.obs import slo as jslo
from ray_tpu_torch import obs as tobs
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as tengine_mod
from ray_tpu_torch.llm import pipeline as tpipeline
from ray_tpu_torch.llm import spec as tspec
from ray_tpu_torch.llm.spec import stats as tspec_stats
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.obs import slo as tslo

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
BASE = dict(num_blocks=64, block_size=4, max_num_seqs=4, max_prefill_len=64, decode_chunk=4)
GREEDY = dict(temperature=0.0, ignore_eos=True)
ROOT_ATTRS = ("prompt_tokens", "output_tokens", "finish_reason", "num_preemptions")
SLO_HISTS = ("ttft_histogram", "tpot_histogram", "queue_wait_histogram",
             "prefill_span_histogram")


@pytest.fixture(autouse=True)
def _pinned_chunk_controller(monkeypatch):
    for mod in (jpipeline, tpipeline):
        monkeypatch.setattr(mod.ChunkController, "note_chunk", lambda self, *a, **k: None)


@pytest.fixture(scope="module")
def tree():
    eng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, **BASE), seed=0)
    return jax.tree.map(np.asarray, eng.params)


def _engines(tree, jkw=None, tkw=None, **kw):
    cfg = {**BASE, **kw}
    jeng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, **cfg, **(jkw or {})), seed=0)
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    teng = LLMEngine(EngineConfig(model=FP32_TINY, **cfg, **(tkw or {})), params=params,
                     device="cpu")
    return jeng, teng


def _prompts(n=4, seed=0, shared=16):
    """``n`` prompts of 10..30 tokens; the first two share a ``shared``-token
    prefix (prefix-cache hits)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(3, 500, size=shared).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(3, 500, size=int(rng.integers(10, 30))).tolist()
        out.append(head + tail[:8] if i < 2 else tail)
    return out


def _add(eng, prompts, sp, first=0, **kw):
    """Add requests r{first}.. and return {rid: trace_id}."""
    out = {}
    for i, p in enumerate(prompts):
        rid = eng.add_request(p, sp, request_id=f"r{first + i}", **kw)
        out[rid] = eng.requests[rid].trace.trace_id
    return out


def _drain(eng) -> dict:
    finals = {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                finals[o.request_id] = o.output_token_ids
    return finals


def _trace_view(recorder, traces: dict) -> dict:
    """rid -> (span-name multiset, llm.request attrs, coverage %)."""
    view = {}
    for rid, tid in traces.items():
        spans = recorder.get(tid)
        root = [s for s in spans if s.name == "llm.request"]
        assert len(root) == 1, (rid, [s.name for s in spans])
        view[rid] = (collections.Counter(s.name for s in spans),
                     {k: root[0].attrs[k] for k in ROOT_ATTRS},
                     recorder.summary(tid)["coverage_pct"])
    return view


def _slo_counts(slo_mod, tag: str) -> dict:
    out = {}
    for name in SLO_HISTS:
        data = getattr(slo_mod, name)().hist_data()
        out[name] = sum(n for k, (_b, _s, n) in data.items() if k[0] == tag)
    out["e2e"] = {k[1]: n for k, (_b, _s, n) in slo_mod.e2e_histogram().hist_data().items()
                  if k[0] == tag}
    return out


def _spec_totals(stats_mod) -> dict:
    m = stats_mod._spec_metrics()
    return {k: m[k].series().get((), 0.0) for k in ("drafted", "accepted", "emitted")}


def _series(counter, tag: str) -> dict:
    """A counter's series of one model tag, keyed by its other tags."""
    return {k[1:]: v for k, v in counter.series().items() if k[0] == tag}


def _tiles(recorder, traces: dict, exact: bool) -> None:
    """The port's lifecycle spans leave no gap in the llm.request root:
    queue wait, prefill and each round start where the spans before them
    end (a round's span starts at the request's cursor), or, on a
    pipelined path, earlier, at the round's dispatch, when its chunk was
    dispatched before the previous one synced; every span starts after
    the one before it."""
    for rid, tid in traces.items():
        spans = sorted((s for s in recorder.get(tid) if s.name != "llm.request"),
                       key=lambda s: (s.start, s.end))
        root = next(s for s in recorder.get(tid) if s.name == "llm.request")
        assert spans[0].start == root.start, rid
        for a, b in zip(spans, spans[1:]):
            assert (b.start == a.end) if exact else (a.start < b.start <= a.end), (
                rid, a.name, b.name, b.start - a.end)
        assert spans[-1].end == root.end, rid


def _hold_equal(jeng, teng, jtr, ttr, tag, decode_span):
    jv, tv = _trace_view(jobs.get_recorder(), jtr), _trace_view(tobs.get_recorder(), ttr)
    assert set(tv) == set(jv)
    for rid in jv:
        names, attrs, cov = tv[rid]
        assert names == jv[rid][0], rid
        assert attrs == jv[rid][1], rid
        assert cov >= 90.0 and jv[rid][2] >= 90.0, (rid, cov, jv[rid][2])
        assert {"engine.queue_wait", "engine.prefill", "llm.request"} <= set(names)
        if attrs["output_tokens"] > 1:
            # a round without prefill work (or without drafts) is a plain one
            assert names[decode_span] + names["engine.decode_chunk"] >= 1, (rid, names)
    assert sum(v[0][decode_span] for v in tv.values()) >= 1
    assert _slo_counts(tslo, tag) == _slo_counts(jslo, tag)
    assert _slo_counts(tslo, tag)["ttft_histogram"] == len(ttr)
    for fn in ("prefix_cache_hit_counter", "prefix_cache_lookup_counter",
               "preemption_counter"):
        got = _series(getattr(tengine_mod, fn)(), tag)
        assert got == _series(getattr(jengine_mod, fn)(), tag), fn


PATHS = {
    # path: (engine kwargs, the decode span its rounds record)
    "sync": (dict(pipeline_decode=False), "engine.decode_chunk"),
    "pipelined": (dict(pipeline_decode=True), "engine.decode_chunk"),
    "mixed": (dict(mixed_batch=True, mixed_prefill_chunk=8), "engine.mixed_round"),
    "spec": (dict(), "engine.spec_round"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_trace_matches_reference(tree, path):
    kw, decode_span = PATHS[path]
    jkw = tkw = None
    prompts = _prompts()
    if path == "spec":
        # prompt lookup: repetitive prompts give drafts
        jkw, tkw = ({"spec": jspec.SpecConfig(num_draft_tokens=3)},
                    {"spec": tspec.SpecConfig(num_draft_tokens=3)})
        prompts = [(p[:6] * 4)[: len(p)] for p in prompts]
    jeng, teng = _engines(tree, jkw, tkw, **kw)
    tag = f"trace-{path}"
    jeng.model_tag = teng.model_tag = tag
    spec0 = [_spec_totals(m) for m in (jspec_stats, tspec_stats)]
    jtr = _add(jeng, prompts, JSamplingParams(max_tokens=12, **GREEDY))
    ttr = _add(teng, prompts, SamplingParams(max_tokens=12, **GREEDY))
    assert _drain(teng) == _drain(jeng)
    # the spec counters moved alike (process-wide series: deltas)
    spec = [{k: v - s0[k] for k, v in _spec_totals(m).items()}
            for m, s0 in zip((jspec_stats, tspec_stats), spec0)]
    assert spec[1] == spec[0]
    assert (spec[1]["drafted"] > 0) == (path == "spec")
    _hold_equal(jeng, teng, jtr, ttr, tag, decode_span)
    _tiles(tobs.get_recorder(), ttr, exact=path in ("sync", "spec"))
    assert teng.stats()["prefix_cache"] == jeng.stats()["prefix_cache"]
    if path != "mixed":
        # mixed admission takes both sharing prompts in one step, before
        # either sealed a block: no hit there, in either package
        assert teng.stats()["prefix_cache"]["by_tier"]["hbm"] > 0


def test_trace_matches_reference_under_kv_pressure(tree):
    """A cache too small for the batch preempts by recompute: the
    ``engine.preempt`` spans and ``llm_preemptions_total{reason=pressure}``
    equal the reference's."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 500, size=10).tolist() for _ in range(3)]
    jeng, teng = _engines(tree, num_blocks=10, pipeline_decode=False)
    jeng.model_tag = teng.model_tag = "trace-pressure"
    jtr = _add(jeng, prompts, JSamplingParams(max_tokens=20, **GREEDY))
    ttr = _add(teng, prompts, SamplingParams(max_tokens=20, **GREEDY))
    assert _drain(teng) == _drain(jeng)
    assert teng.num_preemptions > 0
    _hold_equal(jeng, teng, jtr, ttr, "trace-pressure", "engine.decode_chunk")
    assert set(_series(tengine_mod.preemption_counter(), "trace-pressure")) == {("", "pressure")}


def test_trace_matches_reference_under_priority(tree):
    """A priority-2 request meeting a full batch of priority-0 rows preempts
    one at the next step: ``reason=priority``, tenant-labelled."""
    prompts = _prompts(3, seed=5)
    jeng, teng = _engines(tree, max_num_seqs=2, pipeline_decode=False)
    jeng.model_tag = teng.model_tag = "trace-priority"
    views = []
    for eng, sp in ((jeng, JSamplingParams), (teng, SamplingParams)):
        tr = _add(eng, prompts[:2], sp(max_tokens=12, **GREEDY), tenant="batch")
        eng.step()
        eng.step()
        tr.update(_add(eng, prompts[2:], sp(max_tokens=12, **GREEDY), first=2,
                       priority=2, tenant="gold"))
        views.append((tr, _drain(eng)))
    assert views[1][1] == views[0][1]
    assert teng.num_preemptions == jeng.num_preemptions == 1
    _hold_equal(jeng, teng, views[0][0], views[1][0], "trace-priority", "engine.decode_chunk")
    assert _series(tengine_mod.preemption_counter(), "trace-priority") == {
        ("batch", "priority"): 1.0}


def test_trace_matches_reference_after_recover(tree):
    """``recover()`` re-enqueues the running rows: an ``engine.recover``
    span each, ``reason=recover``, and the spans still tile."""
    prompts = _prompts(3, seed=6)
    jeng, teng = _engines(tree)
    jeng.model_tag = teng.model_tag = "trace-recover"
    views = []
    for eng, sp in ((jeng, JSamplingParams), (teng, SamplingParams)):
        tr = _add(eng, prompts, sp(max_tokens=10, **GREEDY))
        for _ in range(3):
            eng.step()
        assert eng.recover(rebuild_kv=False)
        views.append((tr, _drain(eng)))
    assert views[1][1] == views[0][1]
    _hold_equal(jeng, teng, views[0][0], views[1][0], "trace-recover", "engine.decode_chunk")
    got = _series(tengine_mod.preemption_counter(), "trace-recover")
    assert got == {("", "recover"): 3.0}


def test_abort_records_the_root_span(tree):
    jeng, teng = _engines(tree)
    roots = []
    for eng, sp, rec in ((jeng, JSamplingParams, jobs), (teng, SamplingParams, tobs)):
        eng.model_tag = "trace-abort"
        tid = _add(eng, [[1, 2, 3]], sp(max_tokens=64))["r0"]
        eng.step()  # prefill + first token
        eng.abort_request("r0")
        spans = rec.get_recorder().get(tid)
        root = [s for s in spans if s.name == "llm.request"]
        assert len(root) == 1 and root[0].attrs["finish_reason"] == "abort"
        roots.append({k: v for k, v in root[0].attrs.items() if k != "e2e_s"})
    assert roots[1] == roots[0]
    assert _slo_counts(tslo, "trace-abort")["e2e"] == {"abort": 1}


def test_handoff_import_tiles_from_the_import(tree):
    """An imported request's decode rounds start at the import, and its
    handoff carries the prefill timestamps and the trace."""
    _, src = _engines(tree)
    _, dst = _engines(tree)
    tid = _add(src, [_prompts(1)[0]], SamplingParams(max_tokens=6, **GREEDY))["r0"]
    src.step()
    h = src.export_request("r0")
    assert h.trace["trace_id"] == tid
    assert h.t_first_prefill is not None and h.t_export >= h.t_first_prefill
    dst.import_handoff(h)
    req = dst.requests["r0"]
    assert req.trace.trace_id == tid and req.t_first_prefill == h.t_first_prefill
    assert req.t_span_cursor >= h.t_export
    _drain(dst)
    names = collections.Counter(s.name for s in tobs.get_recorder().get(tid))
    assert names["engine.prefill"] == 1 and names["llm.request"] == 1
    assert names["engine.decode_chunk"] >= 1
