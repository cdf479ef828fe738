"""ray_tpu_torch.llm held against ray_tpu.llm on the CPU.

The contract is greedy TOKEN IDENTITY with the reference engine in fp32
(FP32_TINY, the reference engine's own params carried over), with mixed
batching on and off and chunked decode at 1 and 8 steps, plus preemption
by recompute and prefix-cache hits. Seeded sampling draws counter-based
SplitMix64 noise, not threefry, so it is held by distribution (chi-square
against the reference's exact target distribution) and by invariance to
the decode chunking. The block allocator copy replays the same random
trace as the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import kv_cache as jkv
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.llm.sampling import target_probs
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import kv_cache as tkv
from ray_tpu_torch.llm.sampling import request_seed_base, row_seed, sample_tokens
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
GREEDY = dict(temperature=0.0, ignore_eos=True)


def _prompts():
    """The tests/test_llm_mixed.py prompts: short ones and chunked long ones."""
    rng = np.random.default_rng(7)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in [5, 37, 9, 52, 14, 23]]


def _jax_engine(**kw):
    base = dict(model=J_FP32_TINY, num_blocks=128, block_size=4, max_num_seqs=8,
                max_prefill_len=64)
    return JLLMEngine(JEngineConfig(**{**base, **kw}), seed=0)


def _engine(tree, **kw):
    base = dict(model=FP32_TINY, num_blocks=128, block_size=4, max_num_seqs=8,
                max_prefill_len=64)
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    return LLMEngine(EngineConfig(**{**base, **kw}), params=params, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference engine (split path, its default decode) and its
    greedy outputs on the shared prompts."""
    eng = _jax_engine()
    outs = eng.generate(_prompts(), JSamplingParams(max_tokens=16, **GREEDY))
    return eng, jax.tree.map(np.asarray, eng.params), outs


@pytest.mark.parametrize("decode_chunk", [1, 8])
@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_greedy_token_identical_to_reference(reference, mixed, decode_chunk):
    _, tree, ref = reference
    eng = _engine(tree, mixed_batch=mixed, mixed_prefill_chunk=8, decode_chunk=decode_chunk)
    assert eng.generate(_prompts(), SamplingParams(max_tokens=16, **GREEDY)) == ref
    assert eng.allocator.num_free == 128  # KV fully returned
    if mixed:
        st = eng.stats()["mixed"]
        assert st["dispatches"] > 0 and st["prefill_tokens"] > 0
        assert st["decode_tokens"] > 0  # decode rows rode prefill dispatches
    else:
        assert "mixed" not in eng.stats()


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_preemption_matches_reference(reference, mixed):
    """A cache too small for the batch forces preemption by recompute; the
    streams must still equal the reference's under the same pressure."""
    _, tree, _ = reference
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 500, size=10).tolist() for _ in range(3)]
    kw = dict(num_blocks=10, max_num_seqs=4, mixed_batch=mixed, mixed_prefill_chunk=8)
    ref = _jax_engine(**kw).generate(prompts, JSamplingParams(max_tokens=20, **GREEDY))
    eng = _engine(tree, **kw)
    outs = eng.generate(prompts, SamplingParams(max_tokens=20, **GREEDY))
    assert outs == ref
    assert eng.num_preemptions > 0
    assert eng.allocator.num_free == 10


def test_prefix_cache_hit_matches_reference(reference):
    jeng, tree, _ = reference
    rng = np.random.default_rng(2)
    shared = rng.integers(3, 500, size=24).tolist()
    sp = SamplingParams(max_tokens=4, **GREEDY)
    eng = _engine(tree, max_num_seqs=4, num_blocks=64)
    eng.generate([shared], sp)
    rid = eng.add_request(shared + [7, 8, 9], sp)
    cached, final = None, None
    while eng.has_unfinished():
        for out in eng.step():
            if out.request_id == rid:
                cached = out.num_cached_tokens if cached is None else cached
                final = out.output_token_ids if out.finished else final
    assert cached == 24
    assert eng.stats()["prefix_cache"]["hit_tokens"] == 24
    assert eng.allocator.num_free == 64
    no_cache = _engine(tree, max_num_seqs=4, num_blocks=64, enable_prefix_caching=False)
    assert final == no_cache.generate([shared + [7, 8, 9]], sp)[0]
    assert final == jeng.generate([shared + [7, 8, 9]], JSamplingParams(max_tokens=4, **GREEDY))[0]


def test_block_allocator_trace_replay():
    """The same random allocate / seal / match / truncate / free / drop
    trace through the reference's BlockAllocator and the port's copy."""
    rng = np.random.default_rng(0)
    sides = {}
    for name, mod in (("ref", jkv), ("port", tkv)):
        sides[name] = {"mod": mod, "alloc": mod.BlockAllocator(24, 4), "seqs": {}}
    trunk = [1, 2, 3, 4, 5, 6, 7, 8]

    def run(side, op, arg):
        mod, a, seqs = side["mod"], side["alloc"], side["seqs"]
        try:
            if op == "new":
                sid, toks = arg
                seq = mod.SequenceBlocks(a)
                blocks, n, chain = a.match_prefix(toks)
                if blocks:
                    seq.adopt_prefix(blocks, chain, n)
                try:
                    seq.ensure_capacity(len(toks))
                except mod.NoFreeBlocksError:
                    seq.release()
                    return ("full", n)
                seq.num_tokens = len(toks)
                seq.seal_full_blocks(toks)
                seqs[sid] = (seq, list(toks))
                return ("new", list(blocks), n, list(seq.blocks))
            if op == "grow":
                sid, extra = arg
                seq, toks = seqs[sid]
                toks += extra
                seq.ensure_capacity(len(toks))
                seq.seal_full_blocks(toks)
                return ("grow", list(seq.blocks), seq.num_sealed_tokens)
            if op == "truncate":
                sid, n = arg
                seq, toks = seqs[sid]
                freed = seq.truncate_to(n)
                del toks[n:]
                return ("truncate", freed, list(seq.blocks))
            if op == "free":
                seq, _ = seqs.pop(arg)
                seq.release()
                return ("free",)
            if op == "probe":
                return ("probe", a.probe_admission_need(arg))
            if op == "drop":
                a.drop_prefix_cache()
                return ("drop",)
        except (mod.NoFreeBlocksError, ValueError) as e:
            return (type(e).__name__,)
        raise AssertionError(op)

    next_id = 0
    for _ in range(400):
        live = sorted(sides["ref"]["seqs"])
        op = rng.choice(["new", "new", "grow", "truncate", "free", "probe", "drop"],
                        p=[0.25, 0.1, 0.2, 0.1, 0.2, 0.13, 0.02])
        if op in ("grow", "truncate", "free") and not live:
            op = "new"
        if op == "new":
            n = int(rng.integers(1, 14))
            toks = (trunk[: int(rng.integers(0, 9))] + rng.integers(1, 4, size=n).tolist())
            arg = (next_id, toks)
            next_id += 1
        elif op == "grow":
            arg = (int(rng.choice(live)), rng.integers(1, 4, size=int(rng.integers(1, 6))).tolist())
        elif op == "truncate":
            sid = int(rng.choice(live))
            seq, toks = sides["ref"]["seqs"][sid]
            arg = (sid, int(rng.integers(seq.num_sealed_tokens, len(toks) + 1)))
        elif op == "free":
            arg = int(rng.choice(live))
        elif op == "probe":
            arg = trunk[: int(rng.integers(0, 9))] + rng.integers(1, 4, size=6).tolist()
        else:
            arg = None
        results = [run(sides[s], op, arg) for s in ("ref", "port")]
        assert results[0] == results[1], (op, arg, results)
    ra, pa = sides["ref"]["alloc"], sides["port"]["alloc"]
    assert ra.num_free == pa.num_free
    for field in ("_free", "_refcount", "_hash_to_block", "_block_hash", "_zero_ref_lru"):
        assert getattr(ra, field) == getattr(pa, field), field


def test_seeded_sampling_chunk_invariant(reference):
    """Seeds derive from (request seed, absolute token index): a seeded
    request emits identical tokens whether it decodes one token per host
    sync or in chunks, and regardless of batch-mates."""
    _, tree, _ = reference
    p = [5, 6, 7]
    sp = SamplingParams(max_tokens=20, temperature=1.0, seed=7, ignore_eos=True)
    outs = {}
    for chunk in (1, 4, 8):
        outs[chunk] = _engine(tree, decode_chunk=chunk, pipeline_decode=False).generate([p], sp)[0]
    assert outs[1] == outs[4] == outs[8]
    eng = _engine(tree, decode_chunk=8)
    sp_short = SamplingParams(max_tokens=3, temperature=0.0, ignore_eos=True)
    both = eng.generate([p, [9, 10, 11, 12]], [sp, sp_short])
    assert both[0] == outs[1]
    mixed = _engine(tree, mixed_batch=True, mixed_prefill_chunk=2).generate([p], sp)[0]
    assert mixed == outs[1]


def test_seeded_sampling_reproducible_and_stop(reference):
    _, tree, _ = reference
    p = [5, 6, 7]
    sp = SamplingParams(max_tokens=30, temperature=1.0, seed=42, ignore_eos=True)
    o1 = _engine(tree).generate([p], sp)[0]
    assert o1 == _engine(tree).generate([p], sp)[0]
    assert o1 != _engine(tree).generate([p], dataclasses.replace(sp, seed=43))[0]
    stop_tok = o1[3]
    o3 = _engine(tree).generate([p], dataclasses.replace(sp, stop_token_ids=(stop_tok,)))[0]
    assert o3[-1] == stop_tok and len(o3) == o1.index(stop_tok) + 1


def test_request_seed_is_stable_across_processes():
    """The request id enters the seed through crc32, not the per-process
    salted str hash: these values are fixed."""
    base = request_seed_base(7, "req-0")
    assert base == request_seed_base(7, "req-0")
    assert base != request_seed_base(7, "req-1") != request_seed_base(8, "req-0")
    assert 0 <= row_seed(base, 3) < 2**63 and row_seed(base, 3) != row_seed(base, 4)


def test_sampler_distribution_matches_reference_target():
    """Seeded top-k/top-p sampling is held by distribution: N draws with
    distinct seeds against the reference's exact target distribution
    (chi-square, p = 0.001)."""
    from scipy.stats import chi2

    rng = np.random.default_rng(0)
    V, N = 12, 3000
    logits = rng.normal(size=(1, V)).astype(np.float32) * 1.5
    temp, top_k, top_p = 0.8, 8, 0.9
    want = np.asarray(target_probs(jnp.asarray(logits), jnp.asarray([temp]),
                                   jnp.asarray([top_k]), jnp.asarray([top_p])))[0]
    lg = torch.from_numpy(np.repeat(logits, N, axis=0))
    seeds = torch.tensor([row_seed(request_seed_base(1, f"r{i}"), 0) for i in range(N)])
    tok, _ = sample_tokens(lg, torch.full((N,), temp), torch.full((N,), top_k),
                           torch.full((N,), top_p), seeds, mode="full")
    counts = np.bincount(tok.numpy(), minlength=V)
    support = want > 0
    assert counts[~support].sum() == 0  # nothing outside top-k / nucleus
    expected = want[support] * N
    stat = float(((counts[support] - expected) ** 2 / expected).sum())
    assert stat < chi2.ppf(0.999, int(support.sum()) - 1), (stat, counts, want)


def test_sampler_modes_agree_for_unfiltered_rows():
    """A row with no top-k/top-p emits the same token in every mode, so a
    batch-mate's knobs never change it; greedy rows are argmax."""
    rng = np.random.default_rng(1)
    lg = torch.from_numpy(rng.normal(size=(4, 300)).astype(np.float32))
    temps = torch.tensor([1.0, 0.7, 0.0, 1.2])
    seeds = torch.tensor([11, 12, 0, 14])
    no_filter = (torch.zeros(4, dtype=torch.long), torch.ones(4))
    toks = {mode: sample_tokens(lg, temps, *no_filter, seeds, mode=mode)[0]
            for mode in ("categorical", "full", "full_sort")}
    assert torch.equal(toks["categorical"], toks["full"])
    assert torch.equal(toks["full"], toks["full_sort"])
    assert int(toks["full"][2]) == int(torch.argmax(lg[2]))
    greedy, lp = sample_tokens(lg, torch.zeros(4), *no_filter, None, mode="greedy")
    assert torch.equal(greedy, torch.argmax(lg, dim=-1))
    np.testing.assert_allclose(lp.numpy(), torch.log_softmax(lg, -1).max(-1).values.numpy(),
                               rtol=1e-6)
    # top_k = 1 is greedy whatever the temperature
    k1, _ = sample_tokens(lg, torch.ones(4), torch.ones(4, dtype=torch.long), torch.ones(4),
                          torch.tensor([1, 2, 3, 4]), mode="full")
    assert torch.equal(k1, torch.argmax(lg, dim=-1))


@pytest.mark.parametrize("kw,msg", [
    (dict(max_tokens=0), "max_tokens"), (dict(temperature=-1.0), "temperature"),
    (dict(top_k=-1), "top_k"), (dict(top_p=1.5), "top_p"),
])
def test_sampling_params_validation(kw, msg):
    with pytest.raises(ValueError, match=msg):
        SamplingParams(**kw)
    assert SamplingParams(top_p=0.0).top_p == 0.0
    assert SamplingParams(top_k=300).needs_full_sort


@pytest.mark.parametrize("field,value", [
    ("kvtier", True), ("mesh_spec", object()), ("profile", True),
])
def test_unported_engine_options_refuse(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(model=FP32_TINY, **{field: value})


@pytest.mark.parametrize("field,value", [
    ("spec", {"num_draft_tokens": 2}), ("pipeline_decode", True), ("max_loras", 2),
])
def test_ported_engine_options_accepted(field, value):
    cfg = EngineConfig(model=FP32_TINY, **{field: value})
    assert getattr(cfg, field) is not None
    with pytest.raises(ValueError, match="SpecConfig"):
        EngineConfig(model=FP32_TINY, spec=object())


def test_engine_config_defaults_follow_reference():
    port, ref = EngineConfig(), JEngineConfig()
    for f in ("num_blocks", "block_size", "max_num_seqs", "max_prefill_len", "decode_chunk",
              "enable_prefix_caching", "eos_token_id", "mixed_batch", "mixed_prefill_chunk"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.pipeline_decode is ref.pipeline_decode is True
    assert port.decode_buckets() == ref.decode_buckets()
    assert port.prefill_buckets() == ref.prefill_buckets()


def test_bucket_helpers_match_reference():
    from ray_tpu.llm import mixed as jmixed
    from ray_tpu.llm import pipeline as jpipe
    from ray_tpu_torch.llm import mixed as tmixed
    from ray_tpu_torch.llm import pipeline as tpipe

    assert tpipe.CHUNK_BUCKETS == jpipe.CHUNK_BUCKETS
    for n in range(0, 80):
        assert tmixed.token_bucket(n) == jmixed.token_bucket(n)
        for cap in (None, 1, 3, 8, 100):
            assert tpipe.chunk_bucket(n, cap) == jpipe.chunk_bucket(n, cap), (n, cap)


def test_abort_returns_blocks_and_priority_admits_first(reference):
    _, tree, _ = reference
    eng = _engine(tree, max_num_seqs=2, num_blocks=32)
    sp = SamplingParams(max_tokens=6, **GREEDY)
    a = eng.add_request([3, 4, 5, 6, 7], sp)
    b = eng.add_request([8, 9, 10], sp)
    eng.step()
    eng.abort_request(a)
    assert eng.requests.get(a) is None and eng.allocator.num_free < 32
    eng.abort_request(b)
    assert eng.allocator.num_free == 32 and not eng.has_unfinished()
    # a full batch of low-priority work; a priority request preempts one
    low = [eng.add_request([11 + i, 12, 13], sp) for i in range(2)]
    eng.step()
    hi = eng.add_request([20, 21, 22], sp, priority=1)
    finals, order = {}, []
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = out.output_token_ids
                order.append(out.request_id)
    assert eng.num_preemptions >= 1 and order.index(hi) < order.index(low[1])
    alone = _engine(tree).generate([[20, 21, 22], [11, 12, 13], [12, 12, 13]], sp)
    assert [finals[hi], finals[low[0]], finals[low[1]]] == alone
    assert eng.allocator.num_free == 32


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(EngineConfig(model=FP32_TINY))


def test_engine_refuses_params_on_another_device(reference):
    _, tree, _ = reference
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        LLMEngine(EngineConfig(model=FP32_TINY, attn_impl="cuda"), params=params, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        LLMEngine(EngineConfig(model=FP32_TINY), params=params, device="cpu")
