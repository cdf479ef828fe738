"""The mixed step and the ragged spec verifier on per-bucket static
buffers (``ray_tpu_torch/llm/graphs.PackedGraphs``), held against ray_tpu
on the CPU, where each bucket's program runs eagerly on the same buffers
that a captured CUDA graph reads on the card.

fp32 at LLAMA_TINY, the reference engine's params carried across as numpy
(``params_from_numpy``):
 * the programs: every mixed step and every ragged verify pass of a
   served batch, as it read its bucket's buffers, against the JAX
   ``mixed_step`` / ``verify_tokens_ragged`` on the same arrays and cache
   (logits and K/V within 2e-5), and the port's own eager call on fresh
   tensors (bit for bit);
 * the stale tail: a smaller step in a bucket a larger one filled writes
   no live slot outside its own rows;
 * the engine: greedy tokens equal ``ray_tpu.llm.engine.LLMEngine(
   mixed_batch=True)``'s on tests/test_llm_mixed.py's prompts: plain,
   LoRA rows beside base rows, spec with prompt lookup (ragged verify),
   and preemption while prompts are mid-prefill;
 * the bucket keys: shapes only, bounded, and reused.
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
from ray_tpu.llm.spec import SpecConfig as JSpecConfig
from ray_tpu.models import llama as jllama
from ray_tpu.models import llama_decode as jld
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.graphs import PackedBuffers
from ray_tpu_torch.llm.mixed import token_bucket
from ray_tpu_torch.llm.spec import SpecConfig
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import llama_decode as tld

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
GREEDY = dict(temperature=0.0, ignore_eos=True)
ATOL = 2e-5
# tests/test_llm_mixed.py's engine: chunk 8, block_size 4
BASE = dict(num_blocks=128, block_size=4, max_num_seqs=8, max_prefill_len=64,
            mixed_batch=True, mixed_prefill_chunk=8)
TRASH = BASE["num_blocks"] * BASE["block_size"]


@pytest.fixture(scope="module")
def tree():
    """The reference's LLAMA_TINY weights (fp32, key 0), as numpy."""
    return jax.tree.map(np.asarray, jllama.init_params(J_FP32_TINY, jax.random.key(0)))


def _prompts():
    """tests/test_llm_mixed.py's prompts: chunked long ones and short ones."""
    rng = np.random.default_rng(7)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in [5, 37, 9, 52, 14, 23]]


def _spec_prompts():
    """tests/test_llm_mixed.py's spec prompts: repeated phrases, so prompt
    lookup drafts."""
    rng = np.random.default_rng(3)
    pat = rng.integers(3, 200, size=5).tolist()
    return [pat * 4, rng.integers(3, 500, size=9).tolist(), pat * 3]


def _wq_adapter(seed):
    """tests/test_llm_mixed.py's adapters: wq only, rank 4."""
    m = FP32_TINY
    rng = np.random.RandomState(seed)
    return {"wq": ((rng.randn(m.n_layers, m.d_model, 4) * 0.5).astype(np.float32),
                   (rng.randn(m.n_layers, 4, m.n_heads * m.head_dim) * 0.5).astype(np.float32))}


class _Oracle:
    """Drafts the true continuation (from the non-spec streams), with the
    third token of every draft made at a length divisible by 3 wrong: full,
    partial and zero acceptance, so rows of 1 to 5 packed tokens. Any
    drafter of either package (propose / release)."""

    def __init__(self, prompts, streams):
        self.streams = [list(p) + list(o) for p, o in zip(prompts, streams)]

    def propose(self, request_id, tokens, k):
        for s in self.streams:
            if s[: len(tokens)] == list(tokens):
                d = s[len(tokens) : len(tokens) + k]
                if len(d) > 2 and len(tokens) % 3 == 0:
                    d[2] = (d[2] + 1) % FP32_TINY.vocab_size
                return d
        return []

    def release(self, request_id):
        pass


def _engine(tree, **kw):
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    return LLMEngine(EngineConfig(model=FP32_TINY, **{**BASE, **kw}), params=params, device="cpu")


def _jax_engine(tree, **kw):
    return JLLMEngine(JEngineConfig(model=J_FP32_TINY, **{**BASE, **kw}),
                      params=jax.tree.map(jnp.asarray, tree), seed=0)


def _record(eng, family):
    """Wrap ``family.run``: for each dispatch keep the buffers object, the
    inputs as the program read them, the cache before and after, and the
    logits."""
    calls = []
    real = family.run

    def run(fn, bufs):
        before = {n: t.clone() for n, t in eng.cache.items()}
        inputs = {n: getattr(bufs, n).clone() for n in bufs._inputs()}
        out = real(fn, bufs)
        calls.append(dict(bufs=bufs, inputs=inputs, before=before, logits=out.clone(),
                          after={n: t.clone() for n, t in eng.cache.items()}))
        return out

    family.run = run
    return calls


def _serve(eng, prompts, sp, lora_ids=None):
    lora_ids = lora_ids or [None] * len(prompts)
    rids = [eng.add_request(p, sp, lora_id=lid) for p, lid in zip(prompts, lora_ids)]
    finals = {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = out.output_token_ids
    return [finals[r] for r in rids]


def _jax_call(jfn, tree, call, **kw):
    a = {n: jnp.asarray(t.numpy()) for n, t in call["inputs"].items()}
    cache = {n: jnp.asarray(t.numpy()) for n, t in call["before"].items()}
    args = [a["tokens"], a["positions"], a["slots"], a["block_tables"], a["cu_q_lens"],
            a["context_lens"]] + ([a["gather_idx"]] if "gather_idx" in a else [])
    return jfn(jax.tree.map(jnp.asarray, tree), *args, cache, J_FP32_TINY,
               block_size=BASE["block_size"], attn_impl="xla", **kw)


def _torch_eager(tfn, eng, call, **kw):
    """The port's program on fresh tensors of the recorded inputs and a
    copy of the cache before the dispatch."""
    a = {n: t.clone() for n, t in call["inputs"].items()}
    cache = {n: t.clone() for n, t in call["before"].items()}
    args = [a["tokens"], a["positions"], a["slots"], a["block_tables"], a["cu_q_lens"],
            a["context_lens"]] + ([a["gather_idx"]] if "gather_idx" in a else [])
    logits, cache = tfn(eng.params, *args, cache, FP32_TINY, block_size=BASE["block_size"],
                        **kw)
    return logits, cache


def _check_against_reference(tree, eng, call, jfn, tfn, max_q_len, against_jax=True):
    if against_jax:
        ref_lg, ref_cache = _jax_call(jfn, tree, call, max_q_len=max_q_len)
        np.testing.assert_allclose(call["logits"].numpy(), np.asarray(ref_lg), atol=ATOL,
                                   rtol=ATOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(call["after"][n][:, :, :TRASH].numpy(),
                                       np.asarray(ref_cache[n])[:, :, :TRASH], atol=ATOL,
                                       rtol=ATOL)
    lg, cache = _torch_eager(tfn, eng, call, max_q_len=max_q_len)
    assert torch.equal(lg, call["logits"])
    for n in ("k", "v"):
        assert torch.equal(cache[n][:, :, :TRASH], call["after"][n][:, :, :TRASH])


def test_bucket_mixed_steps_match_reference_program(tree):
    """The mixed steps of a served batch, as their buckets' buffers held
    them, give the JAX mixed_step's logits and K/V on the same arrays (the
    first step of each bucket, and the first of both kinds of row), and
    every one the port's eager mixed_step's bits on fresh tensors."""
    eng = _engine(tree)
    calls = _record(eng, eng._mixed_graphs)
    _serve(eng, _prompts(), SamplingParams(max_tokens=4, **GREEDY))
    assert len(calls) == eng.stats()["mixed"]["dispatches"] >= 4
    q_lens = [np.diff(c["inputs"]["cu_q_lens"].numpy()) for c in calls]
    # prefill chunks and decode rows in one dispatch
    assert any((q == 1).any() and (q > 1).any() for q in q_lens)
    seen, both_seen = set(), False
    for call, q in zip(calls, q_lens):
        both = bool((q == 1).any() and (q > 1).any())
        against_jax = (both and not both_seen) or call["bufs"].key not in seen
        seen.add(call["bufs"].key)
        both_seen |= both
        _check_against_reference(tree, eng, call, jld.mixed_step, tld.mixed_step,
                                 BASE["mixed_prefill_chunk"], against_jax)


def test_bucket_verify_passes_match_reference_program(tree):
    """Every ragged verify pass of a spec engine (k = 4, the oracle
    drafter), as its bucket's buffers held it, gives the JAX
    verify_tokens_ragged's logits [B_pad, K+1, V] and K/V on the same
    arrays."""
    prompts = _spec_prompts()
    sp = SamplingParams(max_tokens=12, **GREEDY)
    eng = _engine(tree, spec=SpecConfig(num_draft_tokens=4))
    eng.drafter = _Oracle(prompts, _serve(_engine(tree), prompts, sp))
    calls = _record(eng, eng._verify_graphs)
    _serve(eng, prompts, sp)
    st = eng.stats()["spec"]
    assert len(calls) == st["steps"] == st["verify_graphs"]["eager_runs"] >= 3
    assert 0 < st["accepted_tokens"] < st["drafted_tokens"]
    assert all(c["bufs"].key[0] == "verify" and c["bufs"].key[4] == 5 for c in calls)
    for call in calls:
        assert call["logits"].shape == (call["bufs"].key[2], 5, FP32_TINY.vocab_size)
        _check_against_reference(tree, eng, call, jld.verify_tokens_ragged,
                                 tld.verify_tokens_ragged, 5)


def test_stale_tail_writes_no_live_slot(tree):
    """A step of T = 56 in the T_pad 64 bucket a T = 64 step filled: its
    padded tail is trash (no stale token of the earlier step), every
    non-trash slot outside its own rows keeps its K/V, and its logits and
    cache equal the eager program's on fresh tensors."""
    eng = _engine(tree, mixed_prefill_chunk=16, max_num_seqs=4)
    calls = _record(eng, eng._mixed_graphs)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 500, size=30).tolist() for _ in range(4)]
    _serve(eng, prompts, SamplingParams(max_tokens=2, **GREEDY))
    first, second = calls[0], calls[1]
    assert second["bufs"] is first["bufs"]  # the same bucket's buffers
    assert first["inputs"]["cu_q_lens"][-1] == 64 and second["inputs"]["cu_q_lens"][-1] == 56
    T = 56
    tail = {n: t[T:] for n, t in second["inputs"].items() if t.shape[0] == 64}
    assert torch.all(tail["slots"] == TRASH) and not tail["tokens"].any()
    assert not tail["positions"].any() and not tail["lora_ids"].any()
    own = set(second["inputs"]["slots"][:T].tolist())
    others = [s for s in range(TRASH) if s not in own]
    for n in ("k", "v"):
        assert torch.equal(second["after"][n][:, :, others], second["before"][n][:, :, others])
    lg, cache = _torch_eager(tld.mixed_step, eng, second, max_q_len=16)
    assert torch.equal(lg, second["logits"])
    for n in ("k", "v"):
        assert torch.equal(cache[n][:, :, :TRASH], second["after"][n][:, :, :TRASH])


def test_fill_refuses_a_partial_step():
    """A bucket's buffers take every input, each of its full padded shape:
    an array shorter than its buffer or a missing input raises."""
    bufs = PackedBuffers.empty(("mixed", 16, 4, 16, 0, False), "cpu")
    full = dict(tokens=np.zeros(16), positions=np.zeros(16), slots=np.zeros(16),
                lora_ids=np.zeros(16), cu_q_lens=np.zeros(5), context_lens=np.zeros(4),
                block_tables=np.zeros((4, 16)))
    bufs.fill(**full)
    with pytest.raises(ValueError, match="does not cover"):
        bufs.fill(**{**full, "tokens": np.zeros(10)})
    with pytest.raises(ValueError, match="fill takes"):
        bufs.fill(**{k: v for k, v in full.items() if k != "slots"})
    verify = PackedBuffers.empty(("verify", 16, 4, 16, 5, False), "cpu")
    assert verify.gather_idx.shape == (4, 5)
    idle = verify.idle(trash_slot=99)
    assert torch.all(idle.slots == 99) and not idle.cu_q_lens.any()


# the engine on the bucket path against the reference's mixed engine
ENGINE_CASES = {
    "plain": dict(kw={}, prompts=_prompts, max_tokens=16),
    "lora": dict(kw=dict(max_loras=2, lora_rank=4), prompts=lambda: _prompts()[:4],
                 max_tokens=10, lora_ids=[None, "A", "B", "A"]),
    "spec": dict(kw=dict(spec="prompt_lookup"), prompts=_spec_prompts, max_tokens=20),
    "spec_oracle": dict(kw=dict(spec="oracle"), prompts=_spec_prompts, max_tokens=20),
    "preemption": dict(kw=dict(num_blocks=24, mixed_prefill_chunk=6), prompts=_prompts,
                       max_tokens=10),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mixed_engine_on_buckets_matches_reference_engine(tree, case):
    """Greedy fp32 tokens equal the reference's mixed engine's, every mixed
    step (and ragged verify pass) through a bucket's buffers."""
    c = ENGINE_CASES[case]
    kw = dict(c["kw"])
    jkw = dict(kw)
    if kw.get("spec"):
        kw["spec"], jkw["spec"] = SpecConfig(num_draft_tokens=4), JSpecConfig(num_draft_tokens=4)
    eng, jeng = _engine(tree, **kw), _jax_engine(tree, **jkw)
    if c["kw"].get("spec") == "oracle":
        sp = SamplingParams(max_tokens=c["max_tokens"], **GREEDY)
        eng.drafter = jeng.drafter = _Oracle(
            c["prompts"](), _serve(_engine(tree), c["prompts"](), sp))
    for name, seed in (("A", 1), ("B", 2)) if "lora_ids" in c else ():
        eng.add_lora(name, _wq_adapter(seed))
        jeng.add_lora(name, _wq_adapter(seed))
    mid_prefill = []
    preempt = eng._preempt_one

    def noting_preempt(*a, **k):
        mid_prefill.append(bool(eng._mixed_prefills))
        return preempt(*a, **k)

    eng._preempt_one = noting_preempt
    got = _serve(eng, c["prompts"](), SamplingParams(max_tokens=c["max_tokens"], **GREEDY),
                 c.get("lora_ids"))
    want = _serve(jeng, c["prompts"](), JSamplingParams(max_tokens=c["max_tokens"], **GREEDY),
                  c.get("lora_ids"))
    assert got == want
    st = eng.stats()
    assert st["mixed"]["graphs"]["eager_runs"] == st["mixed"]["dispatches"] > 0
    assert eng.allocator.num_free == eng.config.num_blocks
    if case.startswith("spec"):
        spec, jspec = st["spec"], jeng.stats()["spec"]
        assert spec["verify_graphs"]["eager_runs"] == spec["steps"] > 0
        counts = ("steps", "drafted_tokens", "accepted_tokens", "emitted_tokens")
        assert {k: spec[k] for k in counts} == {k: jspec[k] for k in counts}
        assert spec["drafted_tokens"] > 0
        if case == "spec_oracle":
            assert spec["acceptance_rate"] > 0.5
    if case == "preemption":
        assert eng.num_preemptions == jeng.num_preemptions > 0
        assert any(mid_prefill)  # a preemption while prompts were mid-prefill


def test_bucket_keys_are_shapes_bounded_and_reused(tree):
    """The bucket key is (program, T_pad, B_pad, table width, K+1, lora):
    T_pad a token bucket, B_pad a decode bucket, the width the engine's
    table rule; the set stays within the product of those axes, and the
    same traffic served again adds no bucket."""
    eng = _engine(tree, enable_prefix_caching=False)
    c = eng.config
    sp = SamplingParams(max_tokens=6, **GREEDY)
    first = _serve(eng, _prompts(), sp)
    st = eng.stats()["mixed"]
    keys = [(b["program"], b["T_pad"], b["B_pad"], b["table_width"], b["k_plus_1"], b["lora"])
            for b in st["graphs"]["buckets"]]
    assert len(keys) == len(set(keys)) >= 2
    t_pads = {token_bucket(n) for n in range(1, c.max_num_seqs * c.mixed_prefill_chunk + 1)}
    widths = {eng._bt_width([n]) for n in range(1, c.max_blocks_per_seq + 1)}
    for program, T_pad, B_pad, W, k1, lora in keys:
        assert (program, k1, lora) == ("mixed", 0, False)
        assert T_pad in t_pads and B_pad in c.decode_buckets() and W in widths
    assert len(keys) <= len(t_pads) * len(c.decode_buckets()) * len(widths)
    assert _serve(eng, _prompts(), sp) == first
    again = eng.stats()["mixed"]
    assert again["dispatches"] == 2 * st["dispatches"]
    assert len(again["graphs"]["buckets"]) == len(keys)
    assert again["graphs"]["captured"] == 0  # nothing is captured on the CPU
