"""ray_tpu_torch's pipelined decode held against ray_tpu.llm.pipeline on the CPU.

 * ``decode_chunk_masked`` against the reference's on the same
   numpy-seeded inputs (a row stopping mid-chunk on max_tokens, one on a
   stop id, one on EOS, one already done, a pad row): tokens, n_emitted,
   steps_run and carry equal, logprobs and the cache within 2e-5;
 * ``ChunkController`` replays a trace to the reference's buckets;
 * greedy engine tokens with the default ``pipeline_decode=True`` equal
   the JAX engine's, mixed batching on and off, with stop ids firing
   mid-chunk, EOS and max_tokens terminations, the wide-stop-set sync
   fallback, preemption and abort mid-pipeline;
 * seeded sampling: pipelined == sync within the port, chunk-invariant;
 * the counter-based noise's bits against a pure-Python SplitMix64.

On the CPU the chunk runs eagerly; its graph capture is held on the card
by tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import pipeline as jpipe
from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm import pipeline as tpipe
from ray_tpu_torch.llm import sampling as tsamp
from ray_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

J_FP32_TINY = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)
FP32_TINY = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32)
GREEDY = dict(temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def tree():
    params = jllama.init_params(J_FP32_TINY, jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _jax_engine(tree, **kw):
    base = dict(model=J_FP32_TINY, num_blocks=64, block_size=4, max_num_seqs=4,
                max_prefill_len=64)
    params = jax.tree.map(jnp.asarray, tree)
    return JLLMEngine(JEngineConfig(**{**base, **kw}), params=params, seed=0)


def _engine(tree, **kw):
    base = dict(model=FP32_TINY, num_blocks=64, block_size=4, max_num_seqs=4,
                max_prefill_len=64)
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    return LLMEngine(EngineConfig(**{**base, **kw}), params=params, device="cpu")


def _prompts():
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(3, 500, size=n))) for n in (7, 12, 5)]


def _drain(eng):
    out, reasons = {}, {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                out[o.request_id] = o.output_token_ids
                reasons[o.request_id] = o.finish_reason
    return out, reasons


# ---------------------------------------------------------------------------
# the masked chunk against the reference's
# ---------------------------------------------------------------------------


def _chunk_case(tree, eos_id, stop_tok):
    """Six rows over random cache contents: max_tokens after 6 and after 3
    tokens, a stop id, EOS, already done, and a pad row."""
    c = FP32_TINY
    rng = np.random.default_rng(4)
    bs, MB, num_blocks = 4, 8, 48
    slots = num_blocks * bs
    shape = (c.n_layers, c.n_kv_heads, slots + bs, c.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    B = 6
    ctx = np.array([9, 13, 5, 17, 7, 0], np.int32)
    bt = rng.choice(num_blocks, size=(B, MB), replace=False).astype(np.int32)
    bt[5] = 0
    arrays = dict(
        tokens=rng.integers(3, 500, size=B).astype(np.int32),
        positions=np.maximum(ctx - 1, 0).astype(np.int32),
        block_tables=bt, context_lens=ctx,
        temps=np.zeros(B, np.float32), top_ks=np.zeros(B, np.int32),
        top_ps=np.ones(B, np.float32),
        starts=np.array([0, 2, 1, 4, 3, 0], np.int32),
        max_toks=np.array([6, 5, 100, 100, 100, 2**31 - 1], np.int32),
        done=np.array([False, False, False, False, True, False]),
        stop_ids=np.full((B, 2), -1, np.int32),
        stop_on_eos=np.array([False, False, False, True, False, False]),
    )
    arrays["stop_ids"][2, 1] = stop_tok
    return arrays, k, v, dict(n_steps=8, block_size=bs, trash_slot=slots, eos_id=eos_id)


def _run_reference(tree, arrays, k, v, kw):
    params = jax.tree.map(jnp.asarray, tree)
    a = {n: jnp.asarray(x) for n, x in arrays.items()}
    B = a["tokens"].shape[0]
    keys = jnp.stack([jax.random.key(0)] * B)
    toks, lps, ne, steps, carry, cache = jpipe.decode_chunk_masked(
        params, a["tokens"], a["positions"], a["block_tables"], a["context_lens"],
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, a["temps"], a["top_ks"],
        a["top_ps"], keys, a["starts"], a["max_toks"], a["done"], a["stop_ids"],
        a["stop_on_eos"], J_FP32_TINY, attn_impl="xla", sample_mode="greedy", **kw,
    )
    return jax.tree.map(np.asarray, (toks, lps, ne, steps, carry, cache))


def _run_port(tree, arrays, k, v, kw, early_exit):
    params = tllama.params_from_numpy(tree, FP32_TINY, device="cpu")
    a = {n: torch.from_numpy(x.copy()) for n, x in arrays.items()}
    B = a["tokens"].shape[0]
    out = tpipe.decode_chunk_masked(
        params, a["tokens"], a["positions"], a["block_tables"], a["context_lens"],
        {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}, a["temps"],
        a["top_ks"], a["top_ps"], torch.zeros(B, dtype=torch.int64), a["starts"],
        a["max_toks"], a["done"], a["stop_ids"], a["stop_on_eos"], FP32_TINY,
        sample_mode="greedy", early_exit=early_exit, **kw,
    )
    toks, lps, ne, steps, carry, cache = out
    return (toks.numpy(), lps.numpy(), ne.numpy(), int(steps),
            tuple(t.numpy() for t in carry), {n: t.numpy() for n, t in cache.items()})


@pytest.mark.parametrize("early_exit", [False, True], ids=["whole_chunk", "early_exit"])
def test_decode_chunk_masked_matches_reference(tree, early_exit):
    # a first pass with no stop id or EOS picks tokens the rows really emit
    arrays, k, v, kw = _chunk_case(tree, eos_id=-5, stop_tok=-5)
    free = _run_reference(tree, arrays, k, v, kw)[0]
    eos_id, stop_tok = int(free[2, 3]), int(free[1, 2])
    arrays, k, v, kw = _chunk_case(tree, eos_id=eos_id, stop_tok=stop_tok)
    ref = _run_reference(tree, arrays, k, v, kw)
    got = _run_port(tree, arrays, k, v, kw, early_exit)
    np.testing.assert_array_equal(got[0], ref[0])          # tokens
    np.testing.assert_allclose(got[1], ref[1], atol=2e-5)  # logprobs
    np.testing.assert_array_equal(got[2], ref[2])          # n_emitted
    assert got[3] == int(ref[3])                           # steps_run
    for g, r in zip(got[4], ref[4]):                       # carry
        np.testing.assert_array_equal(g, np.asarray(r).astype(g.dtype))
    trash = kw["trash_slot"]
    for n in ("k", "v"):  # the trash page takes racing writes: not compared
        np.testing.assert_allclose(got[5][n][:, :, :trash], ref[5][n][:, :, :trash], atol=2e-5)
    # the cases fired: max_tokens row 1 after 3 tokens, stop row 2 by step
    # 1, EOS row 3 by step 2 (each row's last token its stop), row 4 done at
    # entry, pad row 5
    ne = got[2]
    assert ne.tolist()[4:] == [0, 0] and ne[1] == 3 and ne[2] <= 2 and ne[3] <= 3
    assert got[0][ne[2] - 1, 2] == stop_tok and got[0][ne[3] - 1, 3] == eos_id
    assert ne[0] == 6 and got[3] == 6 < kw["n_steps"]


def test_chunk_controller_matches_reference():
    rng = np.random.default_rng(0)
    trace = [(float(rng.uniform(0, 80)), float(rng.uniform(0, 30)),
              float(rng.uniform(1, 120)), int(rng.integers(0, 65))) for _ in range(60)]
    for initial in (1, 8, 64):
        picks = {}
        for name, mod in (("ref", jpipe), ("port", tpipe)):
            ctl = mod.ChunkController(initial=initial)
            out = []
            for gap, sync, chunk_ms, steps_run in trace:
                n = ctl.next_steps(cap=int(steps_run) + 1)
                ctl.note_overhead(gap + sync)
                ctl.note_chunk(chunk_ms, n, min(steps_run, n))
                out.append(n)
            picks[name] = out
        assert picks["port"] == picks["ref"]
        assert len(set(picks["port"])) > 1  # the trace moves the ratchet
    for n in range(0, 10):
        if n <= tpipe.STOP_WIDTH_CAP:
            assert tpipe.stop_width(n) == jpipe.stop_width(n)
    assert tpipe.STOP_WIDTHS == jpipe.STOP_WIDTHS


# ---------------------------------------------------------------------------
# the engine against the JAX engine, greedy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_greedy(tree):
    return _jax_engine(tree).generate(_prompts(), JSamplingParams(max_tokens=12, **GREEDY))


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_pipelined_greedy_matches_jax_engine(tree, ref_greedy, mixed):
    eng = _engine(tree, mixed_batch=mixed, mixed_prefill_chunk=4)
    assert eng.config.pipeline_decode is True  # the default, as in the reference
    assert eng.generate(_prompts(), SamplingParams(max_tokens=12, **GREEDY)) == ref_greedy
    assert eng.allocator.num_free == 64
    st = eng.stats()["pipeline"]
    assert st["dispatches"] > 0 and st["graphs"]["eager_chunks"] == st["dispatches"]  # CPU
    # every row ends on max_tokens: no chunk is dispatched past the last one
    # that still had a live row, so each is synced
    assert st["syncs"] == st["dispatches"]


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_pipelined_stop_token_mid_chunk(tree, ref_greedy, mixed):
    p = _prompts()[1]
    stop_tok = ref_greedy[1][3]
    sp = SamplingParams(max_tokens=30, stop_token_ids=(stop_tok,), **GREEDY)
    got = _engine(tree, mixed_batch=mixed, decode_chunk=8).generate([p], sp)[0]
    ref = _jax_engine(tree, mixed_batch=mixed).generate(
        [p], JSamplingParams(max_tokens=30, stop_token_ids=(stop_tok,), **GREEDY))[0]
    assert got == ref == ref_greedy[1][:4]


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_pipelined_eos_and_max_tokens_match_jax_engine(tree, ref_greedy, mixed):
    """EOS (a token the greedy stream really emits) and max_tokens walls
    land on the same tokens with the same finish reasons."""
    eos = ref_greedy[0][5]
    budgets = (40, 6, 40)
    res = {}
    for side in ("port", "jax"):
        if side == "port":
            eng = _engine(tree, eos_token_id=eos, mixed_batch=mixed)
            rids = [eng.add_request(p, SamplingParams(max_tokens=m, temperature=0.0))
                    for p, m in zip(_prompts(), budgets)]
        else:
            eng = _jax_engine(tree, eos_token_id=eos, mixed_batch=mixed)
            rids = [eng.add_request(p, JSamplingParams(max_tokens=m, temperature=0.0))
                    for p, m in zip(_prompts(), budgets)]
        out, reasons = _drain(eng)
        res[side] = [(out[r], reasons[r]) for r in rids]
    assert res["port"] == res["jax"]
    assert res["port"][0] == (ref_greedy[0][:6], "stop")
    assert res["port"][1][1] == "length" and len(res["port"][1][0]) == 6


def test_pipelined_wide_stop_set_falls_back_to_sync(tree, ref_greedy):
    stops = tuple(range(1000, 1000 + tpipe.STOP_WIDTH_CAP + 3))
    eng = _engine(tree)
    got = eng.generate(_prompts(), SamplingParams(max_tokens=12, stop_token_ids=stops, **GREEDY))
    assert got == ref_greedy
    assert eng._pipe_stats.sync_fallbacks > 0 and eng._pipe_stats.dispatches == 0


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_pipelined_preemption_matches_jax_engine(tree, mixed):
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(3, 500, size=10))) for _ in range(3)]
    kw = dict(num_blocks=10, mixed_batch=mixed, mixed_prefill_chunk=8)
    eng = _engine(tree, **kw)
    outs = eng.generate(prompts, SamplingParams(max_tokens=20, **GREEDY))
    assert eng.num_preemptions > 0 and eng.allocator.num_free == 10
    assert outs == _jax_engine(tree, **kw).generate(prompts, JSamplingParams(max_tokens=20, **GREEDY))


def test_pipelined_abort_mid_pipeline(tree, ref_greedy):
    """abort_request while a chunk is in flight: the flush lands it (a
    batch-mate's finish rides the pending outputs, so has_unfinished stays
    true until a step() delivers it), the survivors keep the JAX engine's
    streams and every block comes back."""
    prompts = _prompts()
    eng = _engine(tree, decode_chunk=2)
    rids = [eng.add_request(p, SamplingParams(max_tokens=12, **GREEDY)) for p in prompts]
    while eng._pipe_inflight is None:
        eng.step()
    eng.abort_request(rids[0])
    assert eng._pipe_inflight is None and eng._pipe_state is None
    if eng._pending_outputs:
        assert eng.has_unfinished()
    out, _ = _drain(eng)
    assert rids[0] not in out
    assert [out[rids[1]], out[rids[2]]] == ref_greedy[1:]
    assert eng.allocator.num_free == 64 and eng.stats()["pipeline"]["flushes"] >= 1


def test_pipe_drop_discards_the_chunk_in_flight(tree, ref_greedy):
    """Dropping the in-flight chunk unsynced books none of its tokens; the
    next round rebuilds the batch from the host's state and rewrites the
    dropped positions, so the streams still equal the JAX engine's."""
    eng = _engine(tree, decode_chunk=2)
    rids = [eng.add_request(p, SamplingParams(max_tokens=12, **GREEDY)) for p in _prompts()]
    while eng._pipe_inflight is None:
        eng.step()
    booked = [len(eng.requests[r].output_token_ids) for r in rids]
    eng._pipe_drop()
    assert eng._pipe_inflight is None and eng._pipe_state is None
    assert [len(eng.requests[r].output_token_ids) for r in rids] == booked
    out, _ = _drain(eng)
    assert [out[r] for r in rids] == ref_greedy


def test_admission_resets_the_host_gap_clock(tree):
    """The chunk controller's host-gap signal never spans a membership
    change: a batch's last chunk is synced before the batch ends (no chunk
    is dispatched past it), and the next admission resets the clock."""
    eng = _engine(tree)
    sp = SamplingParams(max_tokens=12, **GREEDY)
    eng.generate([_prompts()[0]], sp)
    assert eng._pipe_inflight is None and eng._pipe_last_sync_t is not None
    eng.add_request(_prompts()[1], sp)
    eng.step()  # admission
    assert eng._pipe_last_sync_t is None


def test_all_done_early_exit_is_counted(tree, ref_greedy):
    """Rows that stop at their first decode step inside a 16-step chunk:
    steps_run reports the live steps, and the rest counts as saved."""
    prompts = _prompts()[:2]
    sps = [SamplingParams(max_tokens=20, stop_token_ids=(ref_greedy[i][1],), **GREEDY)
           for i in range(2)]
    eng = _engine(tree, decode_chunk=16)
    outs = eng.generate(prompts, sps)
    assert [len(o) for o in outs] == [2, 2]
    st = eng.stats()["pipeline"]
    assert st["steps_dispatched"] >= 16 and st["steps_executed"] <= 4
    assert st["steps_saved_by_early_exit"] >= 12


def test_dropped_engine_is_freed_without_the_cycle_collector(tree):
    """An engine that served pipelined chunks holds no reference cycle, so
    dropping it frees its cache and graphs at once (a caller building the
    next engine on the same card needs that memory back)."""
    import gc
    import weakref

    gc.disable()
    try:
        eng = _engine(tree)
        eng.generate(_prompts(), SamplingParams(max_tokens=12, **GREEDY))
        assert eng.stats()["pipeline"]["dispatches"] > 0
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# seeded sampling inside the port
# ---------------------------------------------------------------------------


def test_pipelined_seeded_equals_sync_and_is_chunk_invariant(tree):
    prompts = _prompts()
    sps = [
        SamplingParams(max_tokens=15, temperature=1.0, seed=7, ignore_eos=True),
        SamplingParams(max_tokens=9, temperature=0.8, top_k=5, seed=3, ignore_eos=True),
        SamplingParams(max_tokens=12, temperature=1.2, top_p=0.9, seed=11, ignore_eos=True),
    ]
    sync = _engine(tree, pipeline_decode=False).generate(prompts, sps)
    assert _engine(tree).generate(prompts, sps) == sync
    assert _engine(tree, decode_chunk=2).generate(prompts, sps) == sync
    assert _engine(tree, pipeline_decode=False, decode_chunk=1).generate(prompts, sps) == sync
    assert _engine(tree, mixed_batch=True, mixed_prefill_chunk=3).generate(prompts, sps) == sync
    # natural EOS stops under sampling land identically too
    sp = SamplingParams(max_tokens=40, temperature=1.0, seed=5)
    assert _engine(tree).generate(prompts, sp) == \
        _engine(tree, pipeline_decode=False).generate(prompts, sp)


# ---------------------------------------------------------------------------
# the counter-based noise
# ---------------------------------------------------------------------------


M64 = (1 << 64) - 1


def _py_splitmix(x):
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


@pytest.mark.parametrize("base,index,vocab_id", [
    (0, 0, 0), (1, 2, 3), (2**64 - 1, 17, 511), (0x0123456789ABCDEF, 1000, 128255),
    (tsamp.request_seed_base(42, "req-3"), 31, 77),
])
def test_noise_bits_pinned_to_python_splitmix(base, index, vocab_id):
    seed = _py_splitmix(base ^ index) >> 1
    assert tsamp.row_seed(base, index) == seed
    dev_seed = tsamp.row_seeds(torch.tensor([tsamp.as_int64(base)]), torch.tensor([index]))
    assert int(dev_seed[0]) == seed
    want = _py_splitmix((seed + vocab_id * 0x9E3779B97F4A7C15) & M64)
    bits = tsamp.noise_bits(dev_seed, vocab_id + 1)
    assert int(bits[0, vocab_id]) & M64 == want
    u = float(tsamp.uniforms(dev_seed, vocab_id + 1)[0, vocab_id])
    assert u == ((want >> 41) + 0.5) / 2**23
    tagged = _py_splitmix(seed ^ 1) >> 1
    assert int(tsamp.stream_seeds(dev_seed, 0)[0]) == tagged


def test_noise_is_uniform_and_sampler_masks_done_rows():
    u = tsamp.uniforms(torch.arange(64, dtype=torch.int64) * 7919, 4096).flatten()
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    hist = torch.histc(u, bins=16, min=0.0, max=1.0)
    assert float((hist / u.numel() - 1 / 16).abs().max()) < 0.005
    lg = torch.randn(3, 50)
    done = torch.tensor([False, True, False])
    seeds = torch.tensor([5, 6, 7])
    ones = torch.ones(3)
    tok, lp = tsamp.sample_tokens(lg, ones, torch.zeros(3, dtype=torch.long), ones, seeds,
                                  mode="categorical", done=done)
    free, lp_free = tsamp.sample_tokens(lg, ones, torch.zeros(3, dtype=torch.long), ones, seeds,
                                        mode="categorical")
    assert int(tok[1]) == 0 and float(lp[1]) == 0.0
    assert torch.equal(tok[[0, 2]], free[[0, 2]]) and torch.equal(lp[[0, 2]], lp_free[[0, 2]])
