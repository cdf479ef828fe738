"""ray_tpu_torch.models.llama_decode held against ray_tpu.models.llama_decode.

LLAMA_TINY in fp32, the reference's own random params carried over with
``params_from_numpy``. The same paged inputs go through ``prefill``,
``decode_step`` and ``mixed_step`` of both; the logits must agree within
1e-4 and the updated cache contents within 2e-5. The logits band is
wider than the attention band because they come out of two layers of
matmuls and a vocab projection that PyTorch and XLA run through
different CPU matmul libraries, which sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import llama_decode as jld
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import llama_decode as tld

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=2e-5, atol=2e-5)
BS = 4
NUM_SLOTS = 32 * BS


def _configs(tie=False):
    j = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32, tie_embeddings=tie)
    t = dataclasses.replace(tllama.LLAMA_TINY, dtype=torch.float32, tie_embeddings=tie)
    return j, t


def _setup(tie=False):
    jc, tc = _configs(tie)
    jp = jllama.init_params(jc, jax.random.key(0))
    tp = tllama.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jcache = jld.init_cache(jc, NUM_SLOTS, dtype=jnp.float32, trash_slots=BS)
    tcache = tld.init_cache(tc, NUM_SLOTS, dtype=torch.float32, trash_slots=BS, device="cpu")
    return jc, tc, jp, tp, jcache, tcache


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays])


def _check_cache(jcache, tcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **CACHE)


def _prefill_arrays(prompts, blocks_per_seq, S_pad):
    """Two right-padded prompts on disjoint pages (pad -> trash slot)."""
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


@pytest.mark.parametrize("tie", [False, True], ids=["lm_head", "tied"])
def test_prefill_then_decode_match_reference(tie):
    jc, tc, jp, tp, jcache, tcache = _setup(tie)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, size=9).tolist(), rng.integers(3, 500, size=6).tolist()]
    blocks = [[0, 1, 2, 3], [4, 5, 6, 7]]
    arrays = _prefill_arrays(prompts, blocks, S_pad=12)
    (ja, ta) = _both(arrays)
    jl, jcache = jld.prefill(jp, *ja, jcache, jc, block_size=BS)
    tl, tcache = tld.prefill(tp, *ta, tcache, tc, block_size=BS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    _check_cache(jcache, tcache)

    bt = arrays[4]
    toks = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    ctx = np.asarray([len(p) for p in prompts], np.int32)
    for _ in range(3):
        pos = ctx.copy()
        slot = np.asarray([bt[b, p // BS] * BS + p % BS for b, p in enumerate(pos)], np.int32)
        ctx = ctx + 1
        (ja, ta) = _both([toks, pos, slot, bt, ctx])
        jl, jcache = jld.decode_step(jp, *ja, jcache, jc, block_size=BS, attn_impl="xla")
        tl, tcache = tld.decode_step(tp, *ta, tcache, tc, block_size=BS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        _check_cache(jcache, tcache)
        toks = np.asarray(jnp.argmax(jl, axis=-1), np.int32)


def test_prefill_over_cached_prefix_matches_reference():
    """A suffix prefilled over a prefix already in the cache (the prefix-
    cache hit shape): the suffix attends to pages it did not write."""
    jc, tc, jp, tp, jcache, tcache = _setup()
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, 500, size=14).tolist()
    blocks = [3, 1, 6, 2]
    first = _prefill_arrays([prompt[:8]], [blocks], S_pad=8)
    ja, ta = _both(first)
    _, jcache = jld.prefill(jp, *ja, jcache, jc, block_size=BS)
    _, tcache = tld.prefill(tp, *ta, tcache, tc, block_size=BS)
    tokens = np.zeros((1, 8), np.int32)
    tokens[0, :6] = prompt[8:]
    pos = np.zeros((1, 8), np.int32)
    pos[0, :6] = np.arange(8, 14)
    slots = np.full((1, 8), NUM_SLOTS, np.int32)
    slots[0, :6] = [blocks[p // BS] * BS + p % BS for p in range(8, 14)]
    arrays = [tokens, pos, np.asarray([6], np.int32), slots, first[4], np.asarray([14], np.int32)]
    ja, ta = _both(arrays)
    jl, jcache = jld.prefill(jp, *ja, jcache, jc, block_size=BS)
    tl, tcache = tld.prefill(tp, *ta, tcache, tc, block_size=BS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    _check_cache(jcache, tcache)


def test_mixed_step_matches_reference():
    """A packed batch: a prefill chunk over a cached prefix, a first
    chunk, two decode rows, a q_len-0 pad sequence and trailing pad rows."""
    jc, tc, jp, tp, jcache, tcache = _setup()
    rng = np.random.default_rng(2)
    # history already in the cache for sequences 0, 2, 3
    hist = {0: 5, 2: 9, 3: 4}
    blocks = {0: [0, 1, 2], 1: [3, 4], 2: [5, 6, 7], 3: [8, 9]}
    for b, n in hist.items():
        arrays = _prefill_arrays([rng.integers(3, 500, size=n).tolist()], [blocks[b]], S_pad=16)
        ja, ta = _both(arrays)
        _, jcache = jld.prefill(jp, *ja, jcache, jc, block_size=BS)
        _, tcache = tld.prefill(tp, *ta, tcache, tc, block_size=BS)
    # rows: seq0 chunk of 4 at 5..8, seq1 first chunk of 6, seq2 decode at 9,
    # seq3 decode at 4, seq4 pad (q_len 0)
    rows = [(0, 5, 4), (1, 0, 6), (2, 9, 1), (3, 4, 1)]
    T_pad = 16
    tokens = np.zeros(T_pad, np.int32)
    pos = np.zeros(T_pad, np.int32)
    slots = np.full(T_pad, NUM_SLOTS, np.int32)
    cu = np.zeros(6, np.int32)
    ctx = np.zeros(5, np.int32)
    bt = np.zeros((5, 8), np.int32)
    t = 0
    for i, (b, start, n) in enumerate(rows):
        tokens[t : t + n] = rng.integers(3, 500, size=n)
        pos[t : t + n] = np.arange(start, start + n)
        slots[t : t + n] = [blocks[b][p // BS] * BS + p % BS for p in range(start, start + n)]
        bt[i, : len(blocks[b])] = blocks[b]
        ctx[i] = start + n
        t += n
        cu[i + 1] = t
    cu[5:] = t
    ja, ta = _both([tokens, pos, slots, bt, cu, ctx])
    jl, jcache = jld.mixed_step(jp, *ja, jcache, jc, block_size=BS, max_q_len=8, attn_impl="xla")
    tl, tcache = tld.mixed_step(tp, *ta, tcache, tc, block_size=BS, max_q_len=8)
    np.testing.assert_allclose(tl.numpy()[:4], np.asarray(jl)[:4], **LOGITS)
    _check_cache(jcache, tcache)


def test_params_from_numpy_checks_the_tree():
    jc, tc = _configs()
    tree = jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(1)))
    params = tllama.params_from_numpy(tree, tc, device="cpu")
    assert params["layers"]["wq"].shape == (2, 64, 64)
    assert params["lm_head"].dtype == torch.float32
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    bf16 = tllama.params_from_numpy(tree, dataclasses.replace(tc, dtype=torch.bfloat16), "cpu")
    assert bf16["layers"]["w_up"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="untied"):
        tllama.params_from_numpy({k: v for k, v in tree.items() if k != "lm_head"}, tc, "cpu")
    with pytest.raises(ValueError, match="ties"):
        tllama.params_from_numpy(tree, dataclasses.replace(tc, tie_embeddings=True), "cpu")
    bad = dict(tree, embed=tree["embed"][:10])
    with pytest.raises(ValueError, match="shape"):
        tllama.params_from_numpy(bad, tc, "cpu")


def test_init_params_layout_and_device_rules():
    tc = _configs()[1]
    gen = torch.Generator().manual_seed(0)
    params = tllama.init_params(tc, gen, device="cpu")
    shapes = tllama.param_shapes(tc)
    assert params["layers"]["w_down"].shape == shapes["layers"]["w_down"]
    assert torch.all(params["layers"]["ln1"] == 1)
    w = params["layers"]["wq"]
    assert float(w.abs().max()) <= 3.0 / 64 ** 0.5 + 1e-6  # truncated at 3 std
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tllama.init_params(tc, gen)  # default device is cuda
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tld.init_cache(tc, 64)
