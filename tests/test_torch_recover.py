"""LLMEngine.recover in ray_tpu_torch held against ray_tpu.llm on the CPU.

recover() pushes every running request back to the waiting queue with its
generated prefix, optionally on a new allocator and a KV cache zeroed in
place. The contract is greedy fp32 token identity: after any recovery the
port's streams equal the reference engine's through the same recovery,
and a fault-free run's. Mirrors tests/test_chaos.py (finished prefix kept,
soft and rebuilt), tests/test_llm_pipeline.py (a chunk in flight) and
tests/test_llm_mixed.py (mid mixed batch; the fault injected by wrapping
step, as the port has no chaos harness). The allocator is whole at the end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import EngineConfig, EnginePreempted, LLMEngine, SamplingParams
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
GREEDY = dict(temperature=0.0, ignore_eos=True)
# tests/test_chaos.py's _tiny_engine_config
CHAOS_KW = dict(num_blocks=64, block_size=8, max_num_seqs=4, max_prefill_len=32,
                decode_chunk=2)
# tests/test_llm_mixed.py's _engine
MIXED_KW = dict(num_blocks=128, block_size=4, max_num_seqs=8, max_prefill_len=64)
MODES = {"pipelined": dict(pipeline_decode=True), "sync": dict(pipeline_decode=False),
         "mixed": dict(mixed_batch=True, mixed_prefill_chunk=6)}


@pytest.fixture(scope="module")
def weights():
    """The reference's fp32 tiny params, as numpy and as the port's."""
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    return jp, tllama.params_from_numpy(tree, FP32_TINY, device="cpu")


def _jax(weights, **kw):
    return JLLMEngine(JEngineConfig(model=J_FP32_TINY, **kw), params=weights[0], seed=0)


def _port(weights, **kw):
    return LLMEngine(EngineConfig(model=FP32_TINY, **kw), params=weights[1], device="cpu")


def _finish(eng, got=None) -> dict:
    got = {} if got is None else got
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                got[o.request_id] = list(o.output_token_ids)
    return got


def _chaos_trace(eng):
    """tests/test_chaos.py::test_engine_recover_preserves_finished_prefix on
    either package's engine: two steps, a soft recover, a step, a rebuilt
    recover, then the rest."""
    sp_cls = SamplingParams if isinstance(eng, LLMEngine) else JSamplingParams
    sp = sp_cls(max_tokens=12, **GREEDY)
    rids = [eng.add_request([1, 2, 3, i + 4], sp) for i in range(3)]
    eng.step()
    eng.step()
    before = {r: list(eng.requests[r].output_token_ids) for r in rids}
    moved = eng.recover(rebuild_kv=False)
    assert set(moved) == set(rids)
    eng.step()
    eng.recover(rebuild_kv=True)
    outs = _finish(eng)
    return [outs[r] for r in rids], [before[r] for r in rids]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recover_keeps_finished_prefix(weights, mode):
    kw = {**CHAOS_KW, **MODES[mode]}
    ref, _ = _chaos_trace(_jax(weights, **kw))
    eng = _port(weights, **kw)
    got, before = _chaos_trace(eng)
    assert got == ref
    for out, pre in zip(got, before):
        assert len(out) == 12 and out[: len(pre)] == pre, "prefix changed"
    assert eng.num_preemptions >= 3
    assert eng.allocator.num_free == kw["num_blocks"]
    clean = _port(weights, **kw).generate([[1, 2, 3, i + 4] for i in range(3)],
                                          SamplingParams(max_tokens=12, **GREEDY))
    assert got == clean


def test_recover_with_chunk_in_flight(weights):
    """tests/test_llm_pipeline.py::test_pipelined_recover_mid_pipeline: the
    un-synced chunk is dropped, re-admission recomputes the delivered
    prefix, and the streams equal the reference's sync path."""
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(3, 500, size=n))) for n in (7, 12, 5)]
    kw = dict(block_size=4, max_num_seqs=4, max_prefill_len=64, num_blocks=64)
    ref = _jax(weights, pipeline_decode=False, **kw).generate(
        prompts, JSamplingParams(max_tokens=14, **GREEDY))
    eng = _port(weights, pipeline_decode=True, **kw)
    rids = [eng.add_request(p, SamplingParams(max_tokens=14, **GREEDY)) for p in prompts]
    for _ in range(3):  # admission + cold-start dispatch (+ one sync)
        eng.step()
    assert eng._pipe_inflight is not None
    assert set(eng.recover()) == set(rids)
    assert eng._pipe_inflight is None and eng._pipe_state is None
    out = _finish(eng)
    assert [out[r] for r in rids] == ref
    assert eng.allocator.num_free == 64


def _mixed_prompts():
    """tests/test_llm_mixed.py's prompts: short ones and chunked long ones."""
    rng = np.random.default_rng(7)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in [5, 37, 9, 52, 14, 23]]


@pytest.fixture(scope="module")
def mixed_reference(weights):
    """The reference's split-path greedy streams of the mixed prompts."""
    return _jax(weights, **MIXED_KW).generate(_mixed_prompts(),
                                              JSamplingParams(max_tokens=10, **GREEDY))


@pytest.mark.parametrize("rebuild_kv", [False, True], ids=["soft", "rebuilt"])
def test_recover_mid_mixed_batch(weights, mixed_reference, rebuild_kv):
    """tests/test_llm_mixed.py::test_preempt_mid_mixed_batch_recovers_identical:
    a preemption raised before the third step, recover(), finish."""
    eng = _port(weights, mixed_batch=True, mixed_prefill_chunk=6, **MIXED_KW)
    step, calls = eng.step, [0]

    def faulty_step():
        calls[0] += 1
        if calls[0] == 3:
            raise EnginePreempted("injected before the third step")
        return step()

    eng.step = faulty_step
    for i, p in enumerate(_mixed_prompts()):
        eng.add_request(p, SamplingParams(max_tokens=10, **GREEDY), request_id=f"c{i}")
    got, fired = {}, 0
    while eng.has_unfinished():
        try:
            outs = eng.step()
        except EnginePreempted:
            fired += 1
            assert eng._mixed_prefills  # the fault hit mid-prompt
            eng.recover(rebuild_kv=rebuild_kv)
            assert not eng._mixed_prefills  # cursors died with the batch
            continue
        for o in outs:
            if o.finished:
                got[o.request_id] = list(o.output_token_ids)
    assert fired == 1
    assert [got[f"c{i}"] for i in range(6)] == mixed_reference
    assert eng.allocator.num_free == MIXED_KW["num_blocks"]


def test_rebuild_zeroes_the_cache_in_place_and_sweeps_orphans(weights, mixed_reference):
    """rebuild_kv keeps the cache tensors (captured graphs read them by
    address), zeroes them, trash page included, and takes a new allocator;
    a request lost inside admission (in neither queue) is re-queued. Four
    batch slots leave two requests waiting."""
    eng = _port(weights, mixed_batch=True, mixed_prefill_chunk=6,
                **{**MIXED_KW, "max_num_seqs": 4})
    for i, p in enumerate(_mixed_prompts()):
        eng.add_request(p, SamplingParams(max_tokens=10, **GREEDY), request_id=f"c{i}")
    eng.step()
    eng.step()
    ptrs = {n: t.data_ptr() for n, t in eng.cache.items()}
    assert any(bool(t.any()) for t in eng.cache.values())
    old_alloc = eng.allocator
    orphan = eng.waiting.popleft()  # a crash between popleft and running.append
    moved = eng.recover(rebuild_kv=True)
    # the running rows newest first, then the orphan (the reference's order)
    assert moved == ["c3", "c2", "c1", "c0", orphan.request_id]
    assert {n: t.data_ptr() for n, t in eng.cache.items()} == ptrs
    assert not any(bool(t.any()) for t in eng.cache.values())
    assert eng.allocator is not old_alloc and eng.allocator.num_free == MIXED_KW["num_blocks"]
    # each appended at the head: the orphan, then the oldest running row
    assert [r.request_id for r in eng.waiting] == ["c4", "c0", "c1", "c2", "c3", "c5"]
    got = _finish(eng)
    assert [got[f"c{i}"] for i in range(6)] == mixed_reference
    assert eng.allocator.num_free == MIXED_KW["num_blocks"]
