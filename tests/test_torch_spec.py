"""ray_tpu_torch.llm.spec held against ray_tpu.llm.spec on the CPU.

 * drafters: prompt-lookup proposals equal the reference's on the same
   histories; the draft-model drafter over the port's llama_decode
   proposes the reference drafter's tokens from the same weights;
 * ``accept_draft``: greedy equals the reference's (full, partial and
   zero accept); sampled acceptance preserves the target distribution
   (chi-square, as tests/test_llm_spec.py checks the reference);
 * ``verify_tokens`` / ``verify_tokens_ragged``: fp32 logits and cache
   within 2e-5 of the reference's;
 * the engine: greedy spec with both drafters, split and mixed (ragged
   verify), equals non-spec decode and the JAX spec engine token for
   token, with the same acceptance counts for prompt lookup;
 * ``SpecConfig`` validation as the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import kv_cache as jkv
from ray_tpu.llm import spec as jspec
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.llm.sampling import target_probs as j_target_probs
from ray_tpu.models import llama as jllama
from ray_tpu.models import llama_decode as jld
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import kv_cache as tkv
from ray_tpu_torch.llm import sampling as tsamp
from ray_tpu_torch.llm import spec as tspec
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import llama_decode as tld

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
GREEDY = dict(temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def trees():
    """Target and draft weights (the reference's init, as numpy)."""
    return tuple(jax.tree.map(np.asarray, jllama.init_params(J_FP32_TINY, jax.random.key(s)))
                 for s in (0, 5))


def _prompts():
    rng = np.random.default_rng(3)
    pat = rng.integers(3, 200, size=5).tolist()
    return [pat * 4, rng.integers(3, 500, size=9).tolist(), pat * 3 + [11]]


def _spec_pair(trees, method):
    """(reference SpecConfig, port SpecConfig) with the same drafter."""
    if method == "prompt_lookup":
        return jspec.SpecConfig(num_draft_tokens=4), tspec.SpecConfig(num_draft_tokens=4)
    draft = trees[1]
    return (
        jspec.SpecConfig(num_draft_tokens=4, method="draft_model", draft_model=J_FP32_TINY,
                         draft_params=jax.tree.map(jnp.asarray, draft),
                         draft_kv=jkv.KVCacheConfig(num_blocks=64, block_size=4,
                                                    dtype=jnp.float32)),
        tspec.SpecConfig(num_draft_tokens=4, method="draft_model", draft_model=FP32_TINY,
                         draft_params=tllama.params_from_numpy(draft, FP32_TINY, device="cpu"),
                         draft_kv=tkv.KVCacheConfig(num_blocks=64, block_size=4)),
    )


def _jax_engine(tree, **kw):
    base = dict(model=J_FP32_TINY, num_blocks=128, block_size=4, max_num_seqs=4,
                max_prefill_len=64)
    return JLLMEngine(JEngineConfig(**{**base, **kw}),
                      params=jax.tree.map(jnp.asarray, tree), seed=0)


def _engine(tree, **kw):
    base = dict(model=FP32_TINY, num_blocks=128, block_size=4, max_num_seqs=4,
                max_prefill_len=64)
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    return LLMEngine(EngineConfig(**{**base, **kw}), params=params, device="cpu")


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


def test_prompt_lookup_matches_reference():
    rng = np.random.default_rng(0)
    for kw in (dict(), dict(max_ngram=2, min_ngram=1, max_history=6), dict(min_ngram=2)):
        ref, port = jspec.PromptLookupDrafter(**kw), tspec.PromptLookupDrafter(**kw)
        for _ in range(200):
            n = int(rng.integers(0, 40))
            hist = rng.integers(0, 6, size=n).tolist()
            k = int(rng.integers(1, 6))
            assert port.propose("r", hist, k) == ref.propose("r", hist, k), (hist, k)
    d = tspec.PromptLookupDrafter(max_ngram=3, min_ngram=1)
    assert d.propose("r", [1, 2, 3, 4, 1, 2, 3], 4) == [4, 1, 2, 3]
    assert d.propose("r", [5, 9, 2, 5, 7, 3, 5], 2) == [7, 3]


def test_draft_model_drafter_matches_reference(trees):
    draft = trees[1]
    ref = jspec.DraftModelDrafter(J_FP32_TINY, params=jax.tree.map(jnp.asarray, draft),
                                  kv=jkv.KVCacheConfig(num_blocks=64, block_size=4,
                                                       dtype=jnp.float32))
    port = tspec.DraftModelDrafter(FP32_TINY, tllama.params_from_numpy(draft, FP32_TINY, "cpu"),
                                   kv=tkv.KVCacheConfig(num_blocks=64, block_size=4),
                                   device="cpu")
    toks = [5, 9, 17, 3]
    out1 = port.propose("r1", toks, 3)
    assert out1 == ref.propose("r1", toks, 3) and len(out1) == 3
    # an accepted prefix and then a different token: both roll back and re-draft
    nxt = toks + out1[:2] + [42]
    assert port.propose("r1", nxt, 3) == ref.propose("r1", nxt, 3)
    port.release("r1")
    assert port.allocator.num_free == 64


# ---------------------------------------------------------------------------
# acceptance
# ---------------------------------------------------------------------------


def _keys(B, seed=0):
    return jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(seed), jnp.arange(B))


def test_accept_greedy_matches_reference():
    B, K, V = 3, 4, 32
    logits = np.random.default_rng(0).normal(size=(B, K + 1, V)).astype(np.float32) * 3
    greedy = logits.argmax(-1).astype(np.int32)
    draft = greedy[:, :K].copy()
    draft[1, 2] = (draft[1, 2] + 1) % V  # row 1 rejected at 2; row 2 has no draft
    lens = np.asarray([K, K, 0], np.int32)
    ref = jspec.accept_draft(jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(lens),
                             jnp.zeros((B,)), jnp.zeros((B,), jnp.int32), jnp.ones((B,)),
                             _keys(B), mode="greedy")
    got = tspec.accept_draft(torch.from_numpy(logits), torch.from_numpy(draft),
                             torch.from_numpy(lens), torch.zeros(B), torch.zeros(B, dtype=torch.long),
                             torch.ones(B), None, mode="greedy")
    assert got[2].tolist() == np.asarray(ref[2]).tolist() == [K, 2, 0]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-5)
    # greedy rows inside a sampled batch take the same short-circuit
    temps = torch.tensor([0.0, 0.0, 0.0])
    mixed = tspec.accept_draft(torch.from_numpy(logits), torch.from_numpy(draft),
                               torch.from_numpy(lens), temps, torch.zeros(B, dtype=torch.long),
                               torch.ones(B), torch.tensor([1, 2, 3]), mode="sample")
    assert mixed[2].tolist() == [K, 2, 0]
    for b, a in enumerate([K, 2, 0]):
        assert mixed[0][b, : a + 1].tolist() == got[0][b, : a + 1].tolist()


def _chi_square(counts, probs):
    exp = probs * counts.sum()
    m = exp > 0
    return float(((counts[m] - exp[m]) ** 2 / exp[m]).sum())


@pytest.mark.parametrize("mode", ["categorical", "sample"])
def test_accept_preserves_target_distribution(mode):
    """The first emitted token's marginal equals the target distribution
    whatever the drafter proposed (chi-square, df 15, p 0.001), and plain
    sampling from the same logits passes the same gate."""
    V, N, K = 16, 8000, 2
    rng = np.random.default_rng(5 if mode == "categorical" else 7)
    row = (rng.normal(size=V) * 1.5).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (N, K + 1, 1)))
    if mode == "categorical":
        temps, ks, ps = torch.ones(N), torch.zeros(N, dtype=torch.long), torch.ones(N)
    else:
        temps, ks, ps = torch.full((N,), 0.9), torch.full((N,), 6), torch.full((N,), 0.95)
    probs = np.asarray(j_target_probs(jnp.asarray(row[None]), jnp.asarray(temps[:1].numpy()),
                                      jnp.asarray(ks[:1].numpy()), jnp.asarray(ps[:1].numpy())))[0]
    port_probs = tsamp.target_probs(logits[:1, 0], temps[:1], ks[:1], ps[:1])[0].numpy()
    np.testing.assert_allclose(port_probs, probs, atol=1e-6)
    d_tok = int(np.argsort(probs)[-2])  # the second most likely token
    seeds = torch.tensor([tsamp.row_seed(tsamp.request_seed_base(11, f"r{i}"), 0)
                          for i in range(N)])
    out, _, acc = tspec.accept_draft(logits, torch.full((N, K), d_tok), torch.full((N,), K),
                                     temps, ks, ps, seeds, mode=mode)
    first = out[:, 0].numpy()
    counts = np.bincount(first, minlength=V)
    assert counts[probs == 0].sum() == 0, "filtered-out token emitted"
    assert _chi_square(counts, probs) < 37.70
    assert 0 < float(acc.float().mean()) < K  # both branches taken
    toks, _ = tsamp.sample_tokens(logits[:, 0], temps, ks, ps, seeds,
                                  mode="categorical" if mode == "categorical" else "full_sort")
    assert _chi_square(np.bincount(toks.numpy(), minlength=V), probs) < 37.70


# ---------------------------------------------------------------------------
# verify passes
# ---------------------------------------------------------------------------


def _verify_case():
    c = FP32_TINY
    rng = np.random.default_rng(9)
    bs, MB, num_blocks = 4, 8, 40
    slots = num_blocks * bs
    shape = (c.n_layers, c.n_kv_heads, slots + bs, c.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    B, K1 = 4, 5
    draft_lens = [4, 2, 0, 3]
    ctx0 = np.array([9, 14, 5, 20])  # tokens before the fed one, + 1
    bt = rng.choice(num_blocks, size=(B, MB), replace=False).astype(np.int32)
    tokens = np.zeros((B, K1), np.int32)
    positions = np.zeros((B, K1), np.int32)
    sm = np.full((B, K1), slots, np.int32)
    for b, L in enumerate(draft_lens):
        n = L + 1
        tokens[b, :n] = rng.integers(3, 500, size=n)
        positions[b, :n] = np.arange(ctx0[b] - 1, ctx0[b] - 1 + n)
        sm[b, :n] = bt[b, positions[b, :n] // bs] * bs + positions[b, :n] % bs
    ctx = (ctx0 + np.asarray(draft_lens)).astype(np.int32)
    return dict(k=k, v=v, bs=bs, slots=slots, bt=bt, tokens=tokens, positions=positions,
                sm=sm, ctx=ctx, draft_lens=draft_lens)


def _pack(case):
    """The ragged layout of the same rows: 1 + draft_len tokens each."""
    K1 = case["tokens"].shape[1]
    toks, pos, sl, cu, gather = [], [], [], [0], []
    for b, L in enumerate(case["draft_lens"]):
        n = L + 1
        gather.append(len(toks) + np.minimum(np.arange(K1), n - 1))
        toks += case["tokens"][b, :n].tolist()
        pos += case["positions"][b, :n].tolist()
        sl += case["sm"][b, :n].tolist()
        cu.append(len(toks))
    T_pad = 16
    pad = T_pad - len(toks)
    arr = lambda x, fill: np.asarray(x + [fill] * pad, np.int32)  # noqa: E731
    return (arr(toks, 0), arr(pos, 0), arr(sl, case["slots"]), np.asarray(cu, np.int32),
            np.stack(gather).astype(np.int32))


@pytest.mark.parametrize("ragged", [False, True], ids=["verify_tokens", "verify_tokens_ragged"])
def test_verify_matches_reference(trees, ragged):
    case = _verify_case()
    jp = jax.tree.map(jnp.asarray, trees[0])
    tp = tllama.params_from_numpy(trees[0], FP32_TINY, device="cpu")
    jc = {"k": jnp.asarray(case["k"]), "v": jnp.asarray(case["v"])}
    tc = {"k": torch.from_numpy(case["k"].copy()), "v": torch.from_numpy(case["v"].copy())}
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    if ragged:
        toks, pos, sl, cu, gather = _pack(case)
        ref_lg, ref_c = jld.verify_tokens_ragged(
            jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(sl), jnp.asarray(case["bt"]),
            jnp.asarray(cu), jnp.asarray(case["ctx"]), jnp.asarray(gather), jc, J_FP32_TINY,
            block_size=case["bs"], max_q_len=5, attn_impl="xla")
        lg, cache = tld.verify_tokens_ragged(
            tp, t(toks), t(pos), t(sl), t(case["bt"]), t(cu), t(case["ctx"]), t(gather), tc,
            FP32_TINY, block_size=case["bs"], max_q_len=5)
    else:
        ref_lg, ref_c = jld.verify_tokens(
            jp, jnp.asarray(case["tokens"]), jnp.asarray(case["positions"]),
            jnp.asarray(case["sm"]), jnp.asarray(case["bt"]), jnp.asarray(case["ctx"]), jc,
            J_FP32_TINY, block_size=case["bs"])
        lg, cache = tld.verify_tokens(
            tp, t(case["tokens"]), t(case["positions"]), t(case["sm"]), t(case["bt"]),
            t(case["ctx"]), tc, FP32_TINY, block_size=case["bs"])
    assert lg.shape == (4, 5, FP32_TINY.vocab_size)
    # columns past a row's draft are pad (split) or repeats (ragged): compare the real ones
    for b, L in enumerate(case["draft_lens"]):
        np.testing.assert_allclose(lg[b, : L + 1].numpy(), np.asarray(ref_lg)[b, : L + 1],
                                   atol=2e-5)
    s = case["slots"]
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n][:, :, :s].numpy(), np.asarray(ref_c[n])[:, :, :s],
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def baseline(trees):
    sp = SamplingParams(max_tokens=20, **GREEDY)
    return _engine(trees[0], pipeline_decode=False).generate(_prompts(), sp)


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
@pytest.mark.parametrize("method", ["prompt_lookup", "draft_model"])
def test_greedy_spec_matches_baseline_and_jax_spec_engine(trees, baseline, method, mixed):
    jcfg, tcfg = _spec_pair(trees, method)
    kw = dict(mixed_batch=mixed, mixed_prefill_chunk=8)
    eng = _engine(trees[0], spec=tcfg, **kw)
    got = eng.generate(_prompts(), SamplingParams(max_tokens=20, **GREEDY))
    assert got == baseline
    jeng = _jax_engine(trees[0], spec=jcfg, **kw)
    assert jeng.generate(_prompts(), JSamplingParams(max_tokens=20, **GREEDY)) == got
    st, jst = eng.stats()["spec"], jeng.stats()["spec"]
    assert st["steps"] > 0 and st["drafted_tokens"] > 0
    assert {k: st[k] for k in ("steps", "drafted_tokens", "accepted_tokens", "emitted_tokens")} \
        == {k: jst[k] for k in ("steps", "drafted_tokens", "accepted_tokens", "emitted_tokens")}
    assert eng.allocator.num_free == 128
    if method == "draft_model":
        assert eng.drafter.allocator.num_free == 64  # every draft sequence released


class _OracleDrafter(tspec.Drafter):
    def __init__(self, streams):
        self.streams = [list(p) + list(o) for p, o in streams]

    def propose(self, request_id, tokens, k):
        for s in self.streams:
            if s[: len(tokens)] == list(tokens):
                return s[len(tokens) : len(tokens) + k]
        return []


def test_spec_oracle_and_stops_and_sampled_reproducible(trees, baseline):
    """Full acceptance with stop ids inside an accepted run; a sampled spec
    request next to a greedy one leaves the greedy stream alone; sampled
    spec output is reproducible."""
    prompts = _prompts()
    eng = _engine(trees[0], spec=tspec.SpecConfig(num_draft_tokens=4))
    eng.drafter = _OracleDrafter(list(zip(prompts, baseline)))
    stop = baseline[0][5]
    got = eng.generate([prompts[0]], SamplingParams(max_tokens=20, stop_token_ids=(stop,),
                                                    **GREEDY))[0]
    assert got == baseline[0][: baseline[0].index(stop) + 1]
    st = eng.stats()["spec"]
    assert st["acceptance_rate"] > 0.9 and st["mean_accepted_len"] > 2.0
    sampled = SamplingParams(max_tokens=12, temperature=1.0, seed=5, ignore_eos=True)
    mixed = eng.generate([prompts[0], prompts[1]], [SamplingParams(max_tokens=20, **GREEDY),
                                                    sampled])
    assert mixed[0] == baseline[0]
    a = _engine(trees[0], spec=tspec.SpecConfig(num_draft_tokens=3)).generate(prompts, sampled)
    b = _engine(trees[0], spec=tspec.SpecConfig(num_draft_tokens=3)).generate(prompts, sampled)
    assert a == b and all(len(x) == 12 for x in a)
    assert eng.allocator.num_free == 128


@pytest.mark.parametrize("kw", [
    dict(num_draft_tokens=0), dict(method="nope"), dict(method="draft_model"),
    dict(min_ngram=3, max_ngram=2),
])
def test_spec_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jspec.SpecConfig(**kw)
    with pytest.raises(ValueError):
        tspec.SpecConfig(**kw)
    with pytest.raises(ValueError):
        EngineConfig(model=FP32_TINY, spec="yes")
    assert EngineConfig(model=FP32_TINY, spec={"num_draft_tokens": 2}).spec.num_draft_tokens == 2
    assert tspec.SpecConfig(method="draft_model", draft_model="llama3-1b").draft_model \
        is tllama.LLAMA3_1B
    with pytest.raises(ValueError, match="vocab"):
        tspec.SpecConfig(method="draft_model", draft_model=FP32_TINY).build_drafter(
            tllama.LLAMA3_8B, "cpu")
