"""LoRA multiplexing in ray_tpu_torch held against ray_tpu on the CPU.

fp32 at LLAMA_TINY, the same numpy params (``params_from_numpy``) and the
same numpy adapters (random arrays from a seed, as tests/test_llm_lora.py
makes them) on both sides:
 * the delta: ``_apply_lora`` / ``_apply_lora_packed`` against the
   reference's ``_lora_delta`` / ``_apply_lora`` / ``_apply_lora_packed``
   with slot ids that include 0 and repeat, within 2e-5;
 * the programs: ``prefill``, ``decode_step``, ``mixed_step``,
   ``verify_tokens`` and ``verify_tokens_ragged`` with ``lora=``: logits
   and the K/V pages written within 2e-5;
 * the engine: a batch mixing two adapters and base rows gives the
   reference engine's greedy tokens on the sync, mixed, pipelined and
   speculative paths; the reference's four LoRA tests on the port; slot
   management (AdapterSlotsExhausted, LRU eviction, a slot reused);
 * the allocator: one random trace of salted admissions, seals, frees and
   salt-scoped drops through both allocators.
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
from ray_tpu.models import llama as jllama
from ray_tpu.models import llama_decode as jld
from ray_tpu_torch.llm import AdapterSlotsExhausted, EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import kv_cache as tkv
from ray_tpu_torch.llm.spec import SpecConfig
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import llama_decode as tld

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
BAND = dict(rtol=2e-5, atol=2e-5)
GREEDY = dict(temperature=0.0, ignore_eos=True)
TARGETS = ("wq", "wk", "wv")
RANK = 4


def _adapters(seed, targets=TARGETS, rank=RANK, scale=0.5):
    """{target: (A [L, d, r], B [L, r, o])}, as tests/test_llm_lora.py makes them."""
    m = FP32_TINY
    rng = np.random.RandomState(seed)
    out = {"wq": m.n_heads * m.head_dim, "wk": m.n_kv_heads * m.head_dim,
           "wv": m.n_kv_heads * m.head_dim}
    return {t: ((rng.randn(m.n_layers, m.d_model, rank) * scale).astype(np.float32),
                (rng.randn(m.n_layers, rank, out[t]) * scale).astype(np.float32))
            for t in targets}


def _stacks(adapter_seeds, targets=TARGETS):
    """Stacks [L, n, d, r] / [L, n, r, o] with slot 0 zero and slot i the
    adapter of seed adapter_seeds[i - 1], as numpy."""
    ads = [_adapters(s, targets) for s in adapter_seeds]
    out = {}
    for t in targets:
        for j, key in enumerate((f"{t}_A", f"{t}_B")):
            w = [a[t][j] for a in ads]
            out[key] = np.stack([np.zeros_like(w[0])] + w, axis=1)
    return out


def _lora_args(stacks, ids):
    j = {"ids": jnp.asarray(ids, jnp.int32), **{k: jnp.asarray(v) for k, v in stacks.items()}}
    t = {"ids": torch.from_numpy(np.asarray(ids, np.int32)),
         **{k: torch.from_numpy(v.copy()) for k, v in stacks.items()}}
    return j, t


# ---------------------------------------------------------------------------
# the delta
# ---------------------------------------------------------------------------


def _layer0(stacks):
    return {k: v[0] for k, v in stacks.items()}


@pytest.mark.parametrize("target", TARGETS)
def test_lora_delta_matches_reference(target):
    """One target's delta alone: the port's _apply_lora on zero
    projections against the reference's _lora_delta, per-row ids with 0
    and a repeated slot."""
    m = FP32_TINY
    rng = np.random.default_rng(0)
    stacks = _stacks([1, 2], targets=(target,))
    ids = np.array([0, 2, 1, 2, 0], np.int32)
    x = rng.normal(size=(5, 3, m.d_model)).astype(np.float32)
    l0 = _layer0(stacks)
    ref = np.asarray(jld._lora_delta(jnp.asarray(x), jnp.asarray(l0[f"{target}_A"]),
                                     jnp.asarray(l0[f"{target}_B"]), jnp.asarray(ids)))
    heads = {"wq": m.n_heads, "wk": m.n_kv_heads, "wv": m.n_kv_heads}
    zeros = {t: torch.zeros(5, 3, heads[t], m.head_dim) for t in TARGETS}
    _, tl = _lora_args(stacks, ids)
    mask, layers = tld._lora_layers(tl)
    got = tld._apply_lora(zeros["wq"], zeros["wk"], zeros["wv"], torch.from_numpy(x),
                          layers[0], mask)
    got = got[TARGETS.index(target)].reshape(5, 3, -1).numpy()
    np.testing.assert_allclose(got, ref, **BAND)
    assert np.all(got[ids == 0] == 0.0)  # slot 0: exactly no delta


@pytest.mark.parametrize("packed", [False, True], ids=["per_row", "per_token"])
def test_apply_lora_matches_reference(packed):
    m = FP32_TINY
    rng = np.random.default_rng(1)
    stacks = _stacks([3, 4, 5])
    if packed:
        ids = np.array([0, 1, 1, 3, 0, 2, 3, 3], np.int32)
        B, S = 1, 8
    else:
        ids = np.array([3, 0, 1, 3], np.int32)
        B, S = 4, 2
    x = rng.normal(size=(B, S, m.d_model)).astype(np.float32)
    qkv = [rng.normal(size=(B, S, h, m.head_dim)).astype(np.float32)
           for h in (m.n_heads, m.n_kv_heads, m.n_kv_heads)]
    l0 = _layer0(stacks)
    jl0 = {k: jnp.asarray(v) for k, v in l0.items()}
    jfn = jld._apply_lora_packed if packed else jld._apply_lora
    # read the reference's outputs before the port runs: jnp.asarray can alias
    # a 64-byte-aligned numpy buffer, the port adds its deltas into that
    # buffer in place, and JAX dispatches asynchronously, so a reference
    # still in flight would add the deltas twice
    ref = [np.asarray(r) for r in jfn(*(jnp.asarray(a) for a in qkv), jnp.asarray(x), jl0,
                                      jnp.asarray(ids), J_FP32_TINY)]
    _, tl = _lora_args(stacks, ids)
    mask, layers = tld._lora_layers(tl)
    tfn = tld._apply_lora_packed if packed else tld._apply_lora
    got = tfn(*(torch.from_numpy(a) for a in qkv), torch.from_numpy(x), layers[0], mask)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **BAND)


def test_base_rows_are_bit_for_bit_base():
    """Slot 0 adds exactly nothing: q + 0 for every base row, whatever the
    other rows' adapters."""
    m = FP32_TINY
    rng = np.random.default_rng(2)
    stacks = _stacks([1, 2])
    ids = np.array([0, 2, 0, 1], np.int32)
    x = torch.from_numpy(rng.normal(size=(4, 1, m.d_model)).astype(np.float32))
    qkv = [torch.from_numpy(rng.normal(size=(4, 1, h, m.head_dim)).astype(np.float32))
           for h in (m.n_heads, m.n_kv_heads, m.n_kv_heads)]
    _, tl = _lora_args(stacks, ids)
    mask, layers = tld._lora_layers(tl)
    got = tld._apply_lora(*(t.clone() for t in qkv), x, layers[1], mask)  # adds in place
    for g, base in zip(got, qkv):
        assert torch.equal(g[ids == 0], base[ids == 0])
        assert not torch.equal(g[ids != 0], base[ids != 0])


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

BS = 4
NUM_SLOTS = 32 * BS


def _setup():
    jp = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    tp = tllama.params_from_numpy(jax.tree.map(np.asarray, jp), FP32_TINY, device="cpu")
    jcache = jld.init_cache(J_FP32_TINY, NUM_SLOTS, dtype=jnp.float32, trash_slots=BS)
    tcache = tld.init_cache(FP32_TINY, NUM_SLOTS, dtype=torch.float32, trash_slots=BS,
                            device="cpu")
    return jp, tp, jcache, tcache


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


def _check(tl, jl, tcache, jcache):
    np.testing.assert_allclose(tl, np.asarray(jl), **BAND)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **BAND)


def _prefill_arrays(prompts, blocks_per_seq, S_pad):
    B = len(prompts)
    bt = np.zeros((B, 8), np.int32)
    tokens = np.zeros((B, S_pad), np.int32)
    pos = np.zeros((B, S_pad), np.int32)
    slots = np.full((B, S_pad), NUM_SLOTS, np.int32)
    for b, (p, blocks) in enumerate(zip(prompts, blocks_per_seq)):
        bt[b, : len(blocks)] = blocks
        tokens[b, : len(p)] = p
        pos[b, : len(p)] = np.arange(len(p))
        slots[b, : len(p)] = [blocks[i // BS] * BS + i % BS for i in range(len(p))]
    lens = np.asarray([len(p) for p in prompts], np.int32)
    return tokens, pos, lens, slots, bt, lens.copy()


def test_prefill_then_decode_with_lora_match_reference():
    jp, tp, jcache, tcache = _setup()
    stacks = _stacks([1, 2])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (9, 6, 7)]
    blocks = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    ids = np.array([2, 0, 1], np.int32)
    jlora, tlora = _lora_args(stacks, ids)
    arrays = _prefill_arrays(prompts, blocks, S_pad=12)
    ja, ta = _both(arrays)
    jl, jcache = jld.prefill(jp, *ja, jcache, J_FP32_TINY, block_size=BS, lora=jlora)
    tl, tcache = tld.prefill(tp, *ta, tcache, FP32_TINY, block_size=BS, lora=tlora)
    _check(tl.numpy(), jl, tcache, jcache)
    bt = arrays[4]
    toks = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    ctx = arrays[2].copy()
    for _ in range(3):
        pos = ctx.copy()
        slot = np.asarray([bt[b, p // BS] * BS + p % BS for b, p in enumerate(pos)], np.int32)
        ctx = ctx + 1
        ja, ta = _both([toks, pos, slot, bt, ctx])
        jl, jcache = jld.decode_step(jp, *ja, jcache, J_FP32_TINY, block_size=BS,
                                     attn_impl="xla", lora=jlora)
        tl, tcache = tld.decode_step(tp, *ta, tcache, FP32_TINY, block_size=BS, lora=tlora)
        _check(tl.numpy(), jl, tcache, jcache)
        toks = np.asarray(jnp.argmax(jl, axis=-1), np.int32)


def _packed_case(rng, rows, blocks, T_pad, B_pad):
    """Packed rows (seq, start, n) over the given pages -> the ragged arrays."""
    tokens = np.zeros(T_pad, np.int32)
    pos = np.zeros(T_pad, np.int32)
    slots = np.full(T_pad, NUM_SLOTS, np.int32)
    cu = np.zeros(B_pad + 1, np.int32)
    ctx = np.zeros(B_pad, np.int32)
    bt = np.zeros((B_pad, 8), np.int32)
    t = 0
    for i, (b, start, n) in enumerate(rows):
        tokens[t : t + n] = rng.integers(3, 500, size=n)
        pos[t : t + n] = np.arange(start, start + n)
        slots[t : t + n] = [blocks[b][p // BS] * BS + p % BS for p in range(start, start + n)]
        bt[i, : len(blocks[b])] = blocks[b]
        ctx[i] = start + n
        t += n
        cu[i + 1] = t
    cu[len(rows) + 1 :] = t
    return tokens, pos, slots, bt, cu, ctx


def _history(jp, tp, jcache, tcache, rng, hist, blocks, slot_of, stacks):
    """Prefill each sequence's history under its own adapter on both sides."""
    for b, n in hist.items():
        arrays = _prefill_arrays([rng.integers(3, 500, size=n).tolist()], [blocks[b]], S_pad=16)
        ja, ta = _both(arrays)
        jlora, tlora = _lora_args(stacks, [slot_of[b]])
        _, jcache = jld.prefill(jp, *ja, jcache, J_FP32_TINY, block_size=BS, lora=jlora)
        _, tcache = tld.prefill(tp, *ta, tcache, FP32_TINY, block_size=BS, lora=tlora)
    return jcache, tcache


def test_mixed_step_with_lora_matches_reference():
    """A packed batch of prefill chunks and decode rows under different
    adapters (base included), a q_len-0 pad sequence and pad tokens."""
    jp, tp, jcache, tcache = _setup()
    stacks = _stacks([1, 2])
    rng = np.random.default_rng(2)
    blocks = {0: [0, 1, 2], 1: [3, 4], 2: [5, 6, 7], 3: [8, 9]}
    slot_of = {0: 1, 1: 2, 2: 0, 3: 2}
    jcache, tcache = _history(jp, tp, jcache, tcache, rng, {0: 5, 2: 9, 3: 4}, blocks,
                              slot_of, stacks)
    rows = [(0, 5, 4), (1, 0, 6), (2, 9, 1), (3, 4, 1)]
    arrays = _packed_case(rng, rows, blocks, T_pad=16, B_pad=5)
    ids = np.zeros(16, np.int32)  # per token; pad tokens slot 0
    t = 0
    for b, _, n in rows:
        ids[t : t + n] = slot_of[b]
        t += n
    jlora, tlora = _lora_args(stacks, ids)
    ja, ta = _both(arrays)
    jl, jcache = jld.mixed_step(jp, *ja, jcache, J_FP32_TINY, block_size=BS, max_q_len=8,
                                attn_impl="xla", lora=jlora)
    tl, tcache = tld.mixed_step(tp, *ta, tcache, FP32_TINY, block_size=BS, max_q_len=8,
                                lora=tlora)
    _check(tl.numpy()[:4], np.asarray(jl)[:4], tcache, jcache)


@pytest.mark.parametrize("ragged", [False, True], ids=["verify_tokens", "verify_tokens_ragged"])
def test_verify_with_lora_matches_reference(ragged):
    """Spec verification of drafted suffixes under per-row (paged) or
    per-token (ragged) adapter ids."""
    jp, tp, jcache, tcache = _setup()
    stacks = _stacks([1, 2], targets=("wq", "wv"))
    rng = np.random.default_rng(3)
    blocks = {0: [0, 1, 2, 3], 1: [4, 5, 6, 7], 2: [8, 9, 10, 11]}
    slot_of = {0: 2, 1: 0, 2: 1}
    hist = {0: 7, 1: 5, 2: 9}
    jcache, tcache = _history(jp, tp, jcache, tcache, rng, hist, blocks, slot_of, stacks)
    draft_lens = [3, 0, 2]
    K1 = 4
    if ragged:
        rows = [(b, hist[b] - 1, L + 1) for b, L in enumerate(draft_lens)]
        tokens, pos, slots, bt, cu, ctx = _packed_case(rng, rows, blocks, T_pad=16, B_pad=4)
        gather = np.zeros((4, K1), np.int32)
        ids = np.zeros(16, np.int32)
        for i, (b, _, n) in enumerate(rows):
            gather[i] = cu[i] + np.minimum(np.arange(K1), n - 1)
            ids[cu[i] : cu[i] + n] = slot_of[b]
        jlora, tlora = _lora_args(stacks, ids)
        ja, ta = _both([tokens, pos, slots, bt, cu, ctx, gather])
        jl, jcache = jld.verify_tokens_ragged(jp, *ja, jcache, J_FP32_TINY, block_size=BS,
                                              max_q_len=K1, attn_impl="xla", lora=jlora)
        tl, tcache = tld.verify_tokens_ragged(tp, *ta, tcache, FP32_TINY, block_size=BS,
                                              max_q_len=K1, lora=tlora)
    else:
        B = 3
        tokens = np.zeros((B, K1), np.int32)
        pos = np.zeros((B, K1), np.int32)
        slots = np.full((B, K1), NUM_SLOTS, np.int32)
        bt = np.zeros((B, 8), np.int32)
        ctx = np.zeros(B, np.int32)
        for b, L in enumerate(draft_lens):
            p0, n = hist[b] - 1, L + 1
            tokens[b, :n] = rng.integers(3, 500, size=n)
            pos[b, :n] = np.arange(p0, p0 + n)
            slots[b, :n] = [blocks[b][p // BS] * BS + p % BS for p in range(p0, p0 + n)]
            bt[b, : len(blocks[b])] = blocks[b]
            ctx[b] = p0 + n
        jlora, tlora = _lora_args(stacks, [slot_of[b] for b in range(B)])
        ja, ta = _both([tokens, pos, slots, bt, ctx])
        jl, jcache = jld.verify_tokens(jp, *ja, jcache, J_FP32_TINY, block_size=BS, lora=jlora)
        tl, tcache = tld.verify_tokens(tp, *ta, tcache, FP32_TINY, block_size=BS, lora=tlora)
    for b, L in enumerate(draft_lens):
        np.testing.assert_allclose(tl[b, : L + 1].numpy(), np.asarray(jl)[b, : L + 1], **BAND)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, :, :NUM_SLOTS].numpy(),
                                   np.asarray(jcache[name])[:, :, :NUM_SLOTS], **BAND)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------


def _mixed_prompts():
    rng = np.random.default_rng(7)
    pat = rng.integers(3, 200, size=5).tolist()
    return [pat * 4, rng.integers(3, 500, size=37).tolist(), pat * 3 + [11],
            rng.integers(3, 500, size=14).tolist()]


MIX = ["a", None, "b", "a"]  # two adapters and a base row


@pytest.fixture(scope="module")
def reference():
    """One reference engine with two adapters on all three targets: its
    params as numpy and its greedy tokens for the mixed-adapter batch."""
    eng = JLLMEngine(JEngineConfig(model=J_FP32_TINY, num_blocks=128, block_size=4,
                                   max_num_seqs=4, max_prefill_len=64, max_loras=2,
                                   lora_rank=RANK, lora_targets=TARGETS), seed=0)
    eng.add_lora("a", _adapters(1))
    eng.add_lora("b", _adapters(2))
    sp = JSamplingParams(max_tokens=16, **GREEDY)
    rids = [eng.add_request(p, sp, lora_id=lid) for p, lid in zip(_mixed_prompts(), MIX)]
    finals = {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = out.output_token_ids
    return jax.tree.map(np.asarray, eng.params), [finals[r] for r in rids]


def _engine(tree, **kw):
    base = dict(model=FP32_TINY, num_blocks=128, block_size=4, max_num_seqs=4,
                max_prefill_len=64, max_loras=2, lora_rank=RANK, lora_targets=TARGETS)
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    return LLMEngine(EngineConfig(**{**base, **kw}), params=params, device="cpu")


def _serve(eng, prompts, lora_ids, max_tokens=16):
    sp = SamplingParams(max_tokens=max_tokens, **GREEDY)
    rids = [eng.add_request(p, sp, lora_id=lid) for p, lid in zip(prompts, lora_ids)]
    finals = {}
    while eng.has_unfinished():
        for out in eng.step():
            if out.finished:
                finals[out.request_id] = out.output_token_ids
    return [finals[r] for r in rids]


PATHS = {
    "sync": dict(pipeline_decode=False),
    "mixed": dict(mixed_batch=True, mixed_prefill_chunk=8, pipeline_decode=False),
    "pipelined": dict(pipeline_decode=True),
    "pipelined_mixed": dict(pipeline_decode=True, mixed_batch=True, mixed_prefill_chunk=8),
    "spec": dict(spec=SpecConfig(num_draft_tokens=4)),
    "spec_ragged": dict(spec=SpecConfig(num_draft_tokens=4), mixed_batch=True,
                        mixed_prefill_chunk=8),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_mixed_adapter_batch_matches_reference_engine(reference, path):
    tree, ref = reference
    eng = _engine(tree, **PATHS[path])
    eng.add_lora("a", _adapters(1))
    eng.add_lora("b", _adapters(2))
    got = _serve(eng, _mixed_prompts(), MIX)
    assert got == ref
    assert eng.allocator.num_free == 128
    st = eng.stats()
    if "spec" in path:
        assert st["spec"]["steps"] > 0 and st["spec"]["accepted_tokens"] > 0
    if path.startswith("pipelined"):
        assert st["pipeline"]["dispatches"] > 0
    # every request under an adapter differs from the same prompt on the base model
    base = _serve(_engine(tree, **PATHS[path]), _mixed_prompts(), [None] * 4)
    assert all(g != b for g, b, lid in zip(got, base, MIX) if lid is not None)
    assert all(g == b for g, b, lid in zip(got, base, MIX) if lid is None)


def test_adapter_loaded_while_a_chunk_is_in_flight(reference):
    """An adapter loaded while a pipelined chunk is in flight, and a
    request under it admitted next: both requests give their tokens of a
    sync engine that had the adapter from the start."""
    tree, _ = reference
    prompts = _mixed_prompts()[:2]
    sync = _engine(tree, pipeline_decode=False)
    sync.add_lora("a", _adapters(1))
    want = _serve(sync, prompts, [None, "a"])
    eng = _engine(tree)
    sp = SamplingParams(max_tokens=16, **GREEDY)
    rids = [eng.add_request(prompts[0], sp)]
    finals = {}
    for _ in range(3):
        finals.update({o.request_id: o.output_token_ids for o in eng.step() if o.finished})
    assert eng._pipe_inflight is not None
    eng.add_lora("a", _adapters(1))
    rids.append(eng.add_request(prompts[1], sp, lora_id="a"))
    while eng.has_unfinished():
        finals.update({o.request_id: o.output_token_ids for o in eng.step() if o.finished})
    assert [finals[r] for r in rids] == want
    assert eng.stats()["pipeline"]["rebuilds"] >= 2


# ---------------------------------------------------------------------------
# the reference's four LoRA tests (tests/test_llm_lora.py) on the port
# ---------------------------------------------------------------------------

CFG = dict(model=tllama.LLAMA_TINY, num_blocks=64, max_num_seqs=4, max_loras=2, lora_rank=4)
PROMPT = [5, 9, 17, 3]


def _ref_adapters(seed, scale=1.0):
    return _adapters(seed, targets=("wq", "wv"), rank=4, scale=scale)


def _gen(engine, lora_id=None, prompt=PROMPT, n=10):
    rid = engine.add_request(prompt, SamplingParams(max_tokens=n, temperature=0.0),
                             lora_id=lora_id)
    out = []
    while engine.has_unfinished():
        for ro in engine.step():
            if ro.request_id == rid and ro.finished:
                out = ro.output_token_ids
    return tuple(out)


def test_zero_adapter_matches_base():
    base = LLMEngine(EngineConfig(model=tllama.LLAMA_TINY, num_blocks=64, max_num_seqs=4),
                     seed=7, device="cpu")
    lora = LLMEngine(EngineConfig(**CFG), seed=7, device="cpu")
    assert _gen(base) == _gen(lora, None)  # slot 0 = exact no-op


def test_adapters_change_output_and_multiplex():
    engine = LLMEngine(EngineConfig(**CFG), seed=7, device="cpu")
    engine.add_lora("styleA", _ref_adapters(1, scale=0.5))
    engine.add_lora("styleB", _ref_adapters(2, scale=0.5))
    base_out = _gen(engine, None)
    a_out = _gen(engine, "styleA")
    b_out = _gen(engine, "styleB")
    assert a_out != base_out and b_out != base_out and a_out != b_out
    # mixed batch: all three decode together, each reproduces its solo output
    rids = {
        engine.add_request(PROMPT, SamplingParams(max_tokens=10, temperature=0.0),
                           lora_id=lid): expect
        for lid, expect in [(None, base_out), ("styleA", a_out), ("styleB", b_out)]
    }
    got = {}
    while engine.has_unfinished():
        for ro in engine.step():
            if ro.finished and ro.request_id in rids:
                got[ro.request_id] = tuple(ro.output_token_ids)
    for rid, expect in rids.items():
        assert got[rid] == expect, (got[rid], expect)


def test_prefix_cache_isolated_per_adapter():
    engine = LLMEngine(EngineConfig(**CFG), seed=7, device="cpu")
    engine.add_lora("styleA", _ref_adapters(1, scale=0.5))
    bs = engine.config.block_size
    long_prompt = list(range(40, 40 + 3 * bs + 2))
    base = _gen(engine, None, long_prompt, 8)
    hits0 = engine.prefix_hit_tokens
    # the same tokens under an adapter must not reuse the base's blocks
    a1 = _gen(engine, "styleA", long_prompt, 8)
    assert engine.prefix_hit_tokens == hits0
    a2 = _gen(engine, "styleA", long_prompt, 8)  # ... but two under one adapter share
    assert engine.prefix_hit_tokens == hits0 + 3 * bs
    assert a1 != base
    assert a1 == a2


def test_lora_slot_management():
    engine = LLMEngine(EngineConfig(**CFG), seed=0, device="cpu")
    engine.add_lora("a", _ref_adapters(1))
    engine.add_lora("b", _ref_adapters(2))
    with pytest.raises(ValueError, match="slots in use"):
        engine.add_lora("c", _ref_adapters(3))
    engine.remove_lora("a")
    engine.add_lora("c", _ref_adapters(3))  # freed slot reused
    assert engine._lora_slots == {"b": 2, "c": 1}
    with pytest.raises(ValueError, match="unknown lora"):
        engine.add_request(PROMPT, lora_id="nope")


def test_slots_exhausted_lru_eviction_and_in_flight_refusal():
    engine = LLMEngine(EngineConfig(**CFG), seed=0, device="cpu")
    engine.add_lora("a", _ref_adapters(1))
    engine.add_lora("b", _ref_adapters(2))
    with pytest.raises(AdapterSlotsExhausted):
        engine.add_lora("c", _ref_adapters(3))
    # a request touches "a": "b" is now the least recently used
    rid = engine.add_request(PROMPT, SamplingParams(max_tokens=4), lora_id="a")
    with pytest.raises(ValueError, match="in use"):
        engine.remove_lora("a")  # held by a waiting request
    engine.add_lora("c", _ref_adapters(3), evict=True)
    assert set(engine._lora_slots) == {"a", "c"} and engine._lora_slots["c"] == 2
    # every resident adapter held: nothing can be evicted
    engine.add_request(PROMPT, SamplingParams(max_tokens=4), lora_id="c")
    assert engine.evict_lru_lora() is None
    with pytest.raises(AdapterSlotsExhausted):
        engine.add_lora("d", _ref_adapters(4), evict=True)
    engine.step()  # both running now
    with pytest.raises(ValueError, match="in use"):
        engine.remove_lora("c")
    while engine.has_unfinished():
        engine.step()
    assert rid not in engine.requests
    assert engine.evict_lru_lora() == "a"  # "a" was used before "c"
    # shapes and targets are checked before anything is written
    with pytest.raises(ValueError, match="not in lora_targets"):
        engine.add_lora("e", {"wk": _adapters(5)["wk"]})
    bad = _ref_adapters(5)
    bad["wq"] = (bad["wq"][0][:, :, :2], bad["wq"][1])
    with pytest.raises(ValueError, match="shapes"):
        engine.add_lora("e", bad)
    assert set(engine._lora_slots) == {"c"}
    with pytest.raises(ValueError, match="LoRA disabled"):
        LLMEngine(EngineConfig(model=tllama.LLAMA_TINY), device="cpu").add_lora("a", bad)


def test_removed_slot_serves_the_next_adapter_and_drops_only_its_chains():
    """remove_lora then add_lora of another adapter into the same slot:
    the new adapter's tokens (not the old one's cached K/V), while another
    adapter's cached prefix survives."""
    bs = 16
    long_prompt = list(range(40, 40 + 3 * bs + 2))
    fresh = LLMEngine(EngineConfig(**CFG), seed=7, device="cpu")
    fresh.add_lora("c", _ref_adapters(3, scale=0.5))
    want_c = _gen(fresh, "c", long_prompt, 8)
    engine = LLMEngine(EngineConfig(**CFG), seed=7, device="cpu")
    engine.add_lora("a", _ref_adapters(1, scale=0.5))
    engine.add_lora("b", _ref_adapters(2, scale=0.5))
    a_out = _gen(engine, "a", long_prompt, 8)
    _gen(engine, "b", long_prompt, 8)
    engine.remove_lora("a")
    engine.add_lora("c", _ref_adapters(3, scale=0.5))
    assert engine._lora_slots["c"] == 1
    hits0 = engine.prefix_hit_tokens
    assert _gen(engine, "c", long_prompt, 8) == want_c != a_out
    assert engine.prefix_hit_tokens == hits0  # slot 1's old chains are gone
    _gen(engine, "b", long_prompt, 8)
    assert engine.prefix_hit_tokens == hits0 + 3 * bs  # slot 2's survived


def test_preempted_adapter_request_recomputes_under_its_adapter(reference):
    """KV pressure preempts an adapter request; its recompute matches the
    prefix chains of its own slot and the tokens do not change."""
    tree, ref = reference
    eng = _engine(tree, num_blocks=24, pipeline_decode=False)
    eng.add_lora("a", _adapters(1))
    eng.add_lora("b", _adapters(2))
    got = _serve(eng, _mixed_prompts(), MIX)
    assert eng.num_preemptions > 0
    assert got == ref


# ---------------------------------------------------------------------------
# the allocator: salted chains and scoped drops against the reference's
# ---------------------------------------------------------------------------


def test_salted_allocator_trace_replay():
    """The same random trace of salted admissions, seals, growth, frees,
    probes and (salt-scoped or full) drops through the reference's
    BlockAllocator and the port's: the same matched blocks and free counts
    at every step."""
    rng = np.random.default_rng(0)
    sides = {name: {"mod": mod, "alloc": mod.BlockAllocator(24, 4), "seqs": {}}
             for name, mod in (("ref", jkv), ("port", tkv))}
    trunk = [1, 2, 3, 4, 5, 6, 7, 8]

    def run(side, op, arg):
        mod, a, seqs = side["mod"], side["alloc"], side["seqs"]
        try:
            if op == "new":
                sid, toks, salt = arg
                seq = mod.SequenceBlocks(a)
                seq.chain = salt
                blocks, n, chain = a.match_prefix(toks, salt)
                if blocks:
                    seq.adopt_prefix(blocks, chain, n)
                try:
                    seq.ensure_capacity(len(toks))
                except mod.NoFreeBlocksError:
                    seq.release()
                    return ("full", n, a.num_free)
                seq.num_tokens = len(toks)
                seq.seal_full_blocks(toks)
                seqs[sid] = (seq, list(toks))
                return ("new", list(blocks), n, list(seq.blocks), a.num_free)
            if op == "grow":
                sid, extra = arg
                seq, toks = seqs[sid]
                toks += extra
                seq.ensure_capacity(len(toks))
                seq.seal_full_blocks(toks)
                return ("grow", list(seq.blocks), seq.num_sealed_tokens, a.num_free)
            if op == "free":
                seq, _ = seqs.pop(arg)
                seq.release()
                return ("free", a.num_free)
            if op == "probe":
                toks, salt = arg
                return ("probe", a.probe_admission_need(toks, salt))
            if op == "drop":
                a.drop_prefix_cache(salt=arg)
                return ("drop", a.num_free)
        except (mod.NoFreeBlocksError, ValueError) as e:
            return (type(e).__name__, a.num_free)
        raise AssertionError(op)

    next_id = 0
    for _ in range(500):
        live = sorted(sides["ref"]["seqs"])
        op = rng.choice(["new", "grow", "free", "probe", "drop"],
                        p=[0.35, 0.2, 0.22, 0.15, 0.08])
        if op in ("grow", "free") and not live:
            op = "new"
        salt = int(rng.integers(0, 3))
        if op == "new":
            toks = trunk[: int(rng.integers(0, 9))] + rng.integers(1, 4, size=int(rng.integers(1, 14))).tolist()
            arg = (next_id, toks, salt)
            next_id += 1
        elif op == "grow":
            arg = (int(rng.choice(live)), rng.integers(1, 4, size=int(rng.integers(1, 6))).tolist())
        elif op == "free":
            arg = int(rng.choice(live))
        elif op == "probe":
            arg = (trunk[: int(rng.integers(0, 9))] + rng.integers(1, 4, size=6).tolist(), salt)
        else:
            arg = None if rng.random() < 0.25 else salt
        results = [run(sides[s], op, arg) for s in ("ref", "port")]
        assert results[0] == results[1], (op, arg, results)
    ra, pa = sides["ref"]["alloc"], sides["port"]["alloc"]
    for field in ("_free", "_refcount", "_hash_to_block", "_block_hash", "_zero_ref_lru",
                  "_hash_salt"):
        assert getattr(ra, field) == getattr(pa, field), field
