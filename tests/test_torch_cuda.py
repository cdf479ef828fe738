"""ray_tpu_torch's CUDA kernels on the card, against their plain PyTorch
twins (the twins are held against the JAX package by the CPU tests), and
the pipelined decode chunk's CUDA graphs against the same chunk run
eagerly.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor
the JAX package, so it also runs on a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash as tfl
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops import ragged as trg

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]
torch.set_num_threads(2)

BANDS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _paged_case(seed, ctx_lens, H=8, KVH=2, D=64, bs=4, MB=8, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    B = len(ctx_lens)
    num_blocks = max(64, B * MB)
    num_slots = num_blocks * bs
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.normal(size=(KVH, num_slots, D)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.normal(size=(KVH, num_slots, D)).astype(np.float32)).to(dtype)
    bt = torch.from_numpy(rng.choice(num_blocks, size=(B, MB), replace=False).astype(np.int32))
    ctx = torch.tensor(ctx_lens, dtype=torch.int32)
    return q, k, v, bt, ctx, bs


# (kv heads, block_size, table width, contexts): one split at a narrow
# table; split edges (ctx 0, 1, block_size, one split's exact page count
# 256 = 16 pages, the full width 1024) with B x KVH below the SM count (4
# splits); and B x KVH above it (one split a row, 160 CTAs)
PAGED_CASES = {
    "one_split": (2, 4, 8, [7, 0, 13, 32, 1]),
    "split_edges": (2, 16, 64, [0, 1, 16, 17, 256, 1000, 1023, 1024]),
    "many_ctas": (4, 16, 32, [int(x) for x in np.random.default_rng(9).integers(0, 513, 40)]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("D,G", [(64, 4), (128, 4), (128, 16), (64, 1), (64, 24)])
def test_paged_kernel_matches_plain(D, G, case, dtype):
    """Split-KV decode against the plain version; a second launch gives the
    same bits, and so does the ragged kernel on the same rows (q_len 1)."""
    _need_cuda()
    KVH, bs, MB, ctx_lens = PAGED_CASES[case]
    q, k, v, bt, ctx, bs = _paged_case(0, ctx_lens, H=KVH * G, KVH=KVH, D=D, bs=bs, MB=MB,
                                       dtype=dtype)
    ref = tpa.paged_attention_torch(q, k, v, bt, ctx, block_size=bs)
    args = [t.cuda() for t in (q, k, v, bt, ctx)]
    got = tpa.paged_attention(*args, block_size=bs)
    again = tpa.paged_attention(*args, block_size=bs)
    cu = torch.arange(len(ctx_lens) + 1, dtype=torch.int32, device="cuda")
    ragged = trg.ragged_attention(*args[:4], cu, args[4], block_size=bs, max_q_len=1)
    torch.cuda.synchronize()
    assert float((got.cpu().float() - ref.float()).abs().max()) <= BANDS[dtype]
    assert torch.equal(got, again)
    assert torch.equal(ragged, got)
    for b, c in enumerate(ctx_lens):
        if c == 0:
            assert torch.all(got[b] == 0)  # ctx = 0 pad row


def test_split_count_follows_shapes_on_card():
    """The host rule on the card's SM count: splits at a short batch over a
    wide table, none when B x KVH already fills the card."""
    _need_cuda()
    n_sm = tpa.sm_count(torch.device("cuda", 0))
    assert tpa.num_splits(8, 2, 1024, n_sm) == 4
    assert tpa.num_splits(40, 4, 512, n_sm) == 1


# (H, KVH, D, block_size, table width, q_lens, contexts, T_pad, max_q_lens)
RAGGED_CASES = {
    "small": (8, 2, 128, 4, 16, [5, 1, 0, 40, 3, 0], [5, 20, 0, 52, 9, 0], 64, (40, 8)),
    # a 256-token chunk, a mid-prompt chunk, decode rows, a q_len 0
    # sequence, a chunk whose folded rows (77 x 4) are no multiple of 64,
    # trailing pad rows; max_q_len 128 leaves the 256-token chunk longer
    "engine": (32, 8, 128, 16, 128, [256, 128, 1, 1, 1, 1, 0, 77],
               [256, 1024, 300, 17, 1, 2000, 0, 500], 768, (256, 128)),
    "engine_d64": (32, 8, 64, 16, 128, [256, 128, 1, 1, 0, 77],
                   [256, 1024, 300, 2048, 0, 500], 512, (256,)),
    "gqa16": (16, 1, 64, 16, 16, [70, 1, 3], [100, 33, 3], 80, (70, 16)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(RAGGED_CASES))
def test_ragged_kernel_matches_plain(case, dtype):
    _need_cuda()
    H, KVH, D, bs, MB, q_lens, ctx_lens, T_pad, max_q_lens = RAGGED_CASES[case]
    rng = np.random.default_rng(1)
    _, k, v, bt, ctx, bs = _paged_case(1, ctx_lens, H=H, KVH=KVH, D=D, bs=bs, MB=MB, dtype=dtype)
    q = torch.from_numpy(rng.normal(size=(T_pad, H, D)).astype(np.float32)).to(dtype)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32)
    ref = trg.ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)
    args = [t.cuda() for t in (q, k, v, bt, cu, ctx)]
    # max_q_len below the longest chunk: the kernel strides over the rest
    for max_q_len in max_q_lens:
        got = trg.ragged_attention(*args, block_size=bs, max_q_len=max_q_len)
        again = trg.ragged_attention(*args, block_size=bs, max_q_len=max_q_len)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        got = got.cpu()
        assert float((got.float() - ref.float()).abs().max()) <= BANDS[dtype]
        assert torch.all(got[sum(q_lens):] == 0)


def test_kernels_count_launches_and_refuse_bad_input():
    _need_cuda()
    q, k, v, bt, ctx, bs = _paged_case(2, [3, 9], D=64)
    q, k, v, bt, ctx = (t.cuda() for t in (q, k, v, bt, ctx))
    before = tpa.paged_attention_cuda.launches
    tpa.paged_attention(q, k, v, bt, ctx, block_size=bs)
    assert tpa.paged_attention_cuda.launches == before + 1
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                            v[..., :16].contiguous(), bt, ctx, block_size=bs)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention(q, k, v, bt.long(), ctx, block_size=bs)
    with pytest.raises(ValueError, match="plain version serves CPU"):
        tpa.paged_attention(q, k, v, bt, ctx, block_size=bs, impl="torch")
    assert tpa.paged_attention_cuda.launches == before + 1


def test_cuda_tensor_without_library_raises_not_falls_back(monkeypatch, tmp_path):
    """On the card a kernel that cannot be built is an error, never the
    plain version."""
    _need_cuda()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    q, k, v, bt, ctx, bs = _paged_case(0, [7, 20, 13])
    before = tpa.paged_attention_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tpa.paged_attention(*(t.cuda() for t in (q, k, v, bt, ctx)), block_size=bs)
    assert tpa.paged_attention_cuda.launches == before


def test_engine_on_card_matches_cpu():
    """A small fp32 model (head_dim 64) served on the card and on the CPU
    gives the same greedy tokens, mixed batching on and off."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    model = LlamaConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                        d_ff=512, max_seq=256, dtype=torch.float32)
    params = init_params(model, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: (v.cuda() if torch.is_tensor(v) else {n: t.cuda() for n, t in v.items()})
               for k, v in params.items()}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 500, size=int(n)).tolist() for n in (5, 30, 61, 12)]
    sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    for mixed in (False, True):
        outs = []
        for dev, p, pipelined in (("cuda", on_card, True), ("cuda", on_card, False),
                                  ("cpu", params, True)):
            cfg = EngineConfig(model=model, num_blocks=64, block_size=16, max_num_seqs=4,
                               max_prefill_len=128, mixed_batch=mixed, mixed_prefill_chunk=16,
                               pipeline_decode=pipelined)
            outs.append(LLMEngine(cfg, params=p, device=dev).generate(prompts, sp))
        assert outs[0] == outs[1] == outs[2], mixed


# flash: the reference's allclose bands (tests/test_flash.py:39,46,88)
FLASH = {("fwd", torch.float32): 2e-5, ("bwd", torch.float32): 5e-4,
         ("fwd", torch.bfloat16): 2e-2, ("bwd", torch.bfloat16): 2e-2}


def _flash_case(seed, B, Sq, Sk, H, KVH, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D), (B, Sq, H, D)))
    q = q / D ** 0.5  # the scale folded in, as flash_attention does
    dlse = torch.from_numpy(rng.normal(size=(B, H, Sq)).astype(np.float32)) * 0.1
    return [t.to(dtype) for t in (q, k, v, do)] + [dlse]


def _close(got, ref, band):
    torch.testing.assert_close(got.float().cpu(), ref.float().cpu(), rtol=band, atol=band)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,H,KVH,S,causal,q_offset,segments", [
    (64, 8, 4, 200, True, 0, False),     # ragged edge (200 = 3 x 64 + 8)
    (128, 8, 2, 130, True, 0, True),     # two segments, GQA 4
    (64, 4, 4, 96, False, 0, True),      # bidirectional, MHA
    (128, 8, 8, 64, True, 40, False),    # q_offset, Sk > Sq
    (64, 16, 4, 1000, True, 0, True),    # S 1000: no multiple of the 64/128-row tiles, segments
    (128, 16, 8, 200, True, 800, False), # Sq 200 into Sk 1000 at q_offset 800
    (64, 32, 4, 150, True, 0, False),    # GQA 8
    (64, 16, 1, 136, True, 0, True),     # GQA 16
    (128, 12, 4, 72, False, 0, False),   # GQA 3: bf16 only (fp32 folds groups dividing 64)
])
def test_flash_kernels_match_plain(D, H, KVH, S, causal, q_offset, segments, dtype):
    _need_cuda()
    Sk = S + q_offset
    q, k, v, do, dlse = _flash_case(1, 2, S, Sk, H, KVH, D, dtype)
    if dtype == torch.float32 and 64 % (H // KVH):
        # a shape the fp32 kernel does not take raises in the wrapper
        f0 = tfl.flash_fwd_cuda.launches
        with pytest.raises(ValueError, match="GQA group"):
            tfl.flash_fwd_cuda(q.cuda(), k.cuda(), v.cuda())
        assert tfl.flash_fwd_cuda.launches == f0
        return
    seg = None
    if segments:
        seg = torch.stack([(torch.arange(S) >= b).int() for b in (S // 3, S // 2)])
    kw = dict(causal=causal, q_offset=q_offset)
    ref_o, ref_lse = tfl.flash_attention_fwd_torch(q, k, v, seg, seg, **kw)
    ref_g = tfl.flash_attention_bwd_torch(q, k, v, ref_o, ref_lse, do, dlse, seg, seg, **kw)
    cu = [None if t is None else t.cuda() for t in (q, k, v, ref_o, ref_lse, do, dlse, seg)]
    o, lse = tfl.flash_fwd_cuda(cu[0], cu[1], cu[2], cu[7], cu[7], **kw)
    g = tfl.flash_bwd_cuda(*cu[:7], cu[7], cu[7], **kw)
    torch.cuda.synchronize()
    _close(o, ref_o, FLASH[("fwd", dtype)])
    _close(lse, ref_lse, FLASH[("fwd", dtype)])
    for got, ref in zip(g, ref_g):
        _close(got, ref, FLASH[("bwd", dtype)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_fully_masked_rows_follow_pallas(dtype):
    """q rows in a segment the kv side lacks: the mean of V over the row's
    window and lse ~ NEG_INF, zero gradient (ROADMAP Queue 3); on both the
    fp32 CUDA-core and the bf16 tensor-core kernels."""
    _need_cuda()
    q, k, v, do, dlse = _flash_case(2, 1, 64, 64, 4, 2, 64, dtype)
    qseg = torch.cat([torch.full((1, 8), 7), torch.zeros(1, 56)], 1).int()
    kseg = torch.zeros(1, 64, dtype=torch.int32)
    ref_o, ref_lse = tfl.flash_attention_fwd_torch(q, k, v, qseg, kseg, causal=False)
    o, lse = tfl.flash_fwd_cuda(*(t.cuda() for t in (q, k, v, qseg, kseg)), causal=False)
    band = FLASH[("fwd", dtype)]
    _close(o, ref_o, band)
    _close(lse, ref_lse, band)
    torch.testing.assert_close(o[0, :8, 0].float().cpu(),
                               v[0, :, 0].float().mean(0).expand(8, 64), rtol=band, atol=band)
    g = tfl.flash_bwd_cuda(*(t.cuda() for t in (q, k, v, ref_o, ref_lse, do, dlse, qseg, kseg)),
                           causal=False)
    assert float(g[0][0, :8].abs().max()) == 0.0


def test_flash_bf16_backward_is_deterministic():
    """No atomics: two backward launches on the same inputs give the same
    bits (S 1000 with segments and GQA 4, so every tile edge is crossed)."""
    _need_cuda()
    q, k, v, do, dlse = (t.cuda() for t in _flash_case(4, 2, 1000, 1000, 16, 4, 64, torch.bfloat16))
    seg = torch.stack([(torch.arange(1000) >= b).int() for b in (300, 700)]).cuda()
    o, lse = tfl.flash_fwd_cuda(q, k, v, seg, seg)
    first = tfl.flash_bwd_cuda(q, k, v, o, lse, do, dlse, seg, seg)
    second = tfl.flash_bwd_cuda(q, k, v, o, lse, do, dlse, seg, seg)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert all(float(g.float().abs().max()) > 0 for g in first)


@pytest.mark.parametrize("B,S,H,KVH", [(1, 256, 4, 2), (2, 1000, 16, 4)])
def test_flash_fp32_backward_bit_identical_to_plain_on_card(B, S, H, KVH):
    """The fp32 CUDA-core backward stays as it was: its sums are the plain
    version's fp32 FMA chains in cuBLAS's SGEMM order, so on the card the
    two agree bit for bit (TF32 off)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, dlse = (t.cuda() for t in _flash_case(5, B, S, S, H, KVH, 64, torch.float32))
    o, lse = tfl.flash_attention_fwd_torch(q, k, v)
    got = tfl.flash_bwd_cuda(q, k, v, o, lse, do, dlse)
    ref = tfl.flash_attention_bwd_torch(q, k, v, o, lse, do, dlse)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, ref):
        assert torch.equal(a, b), f"d{name}: max diff {float((a - b).abs().max())}"


def test_flash_counts_launches_and_refuses_bad_input():
    _need_cuda()
    q, k, v, do, dlse = (t.cuda() for t in _flash_case(3, 1, 32, 32, 4, 2, 64, torch.float32))
    f0, b0 = tfl.flash_fwd_cuda.launches, tfl.flash_bwd_cuda.launches
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    tfl.flash_attention(qg, kg, vg).sum().backward()
    assert (tfl.flash_fwd_cuda.launches, tfl.flash_bwd_cuda.launches) == (f0 + 1, b0 + 1)
    with pytest.raises(ValueError, match="head_dim"):
        tfl.flash_fwd_cuda(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    with pytest.raises(ValueError, match="GQA group"):
        tfl.flash_fwd_cuda(q.repeat(1, 1, 48, 1), k[:, :, :1].contiguous(),
                           v[:, :, :1].contiguous())
    with pytest.raises(TypeError, match="dtype"):
        tfl.flash_fwd_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfl.flash_fwd_cuda(q.transpose(1, 2), k, v)
    assert tfl.flash_fwd_cuda.launches == f0 + 1


def test_train_step_on_card_matches_cpu():
    """A small fp32 model with flash attention: 3 AdamW steps on the card
    (kernels) and on the CPU (plain versions) from the same params."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32, attention_impl="flash",
                              d_model=256, n_heads=4, n_kv_heads=2, remat=True)
    base = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512, size=(2, 65)))
    hist = {}
    for dev in ("cuda", "cpu"):
        params = {k: (v.to(dev, copy=True) if torch.is_tensor(v) else
                      {n: t.to(dev, copy=True) for n, t in v.items()}) for k, v in base.items()}
        state = TrainState.create(params, adamw())
        step = make_train_step(lambda p, b: llama.loss_and_weight_fn(p, b, cfg))
        batch = {"tokens": toks[:, :-1].to(dev), "targets": toks[:, 1:].to(dev)}
        hist[dev] = [tuple(float(x) for x in step(state, batch)[1].values()) for _ in range(3)]
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# pipelined decode on captured CUDA graphs (llm/graphs.py)
# ---------------------------------------------------------------------------


GRAPH_MODEL = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                   d_ff=512, max_seq=256)
LORA_KW = dict(max_loras=2, lora_rank=8, lora_targets=("wq", "wk", "wv"))


def _adapter(seed, scale=0.3, rank=8):
    """Random LoRA weights for every target of GRAPH_MODEL, from a numpy seed."""
    m = GRAPH_MODEL
    hd = m["d_model"] // m["n_heads"]
    rng = np.random.default_rng(seed)
    outs = {"wq": m["n_heads"] * hd, "wk": m["n_kv_heads"] * hd, "wv": m["n_kv_heads"] * hd}
    return {t: ((rng.normal(size=(m["n_layers"], m["d_model"], rank)) * scale).astype(np.float32),
                (rng.normal(size=(m["n_layers"], rank, o)) * scale).astype(np.float32))
            for t, o in outs.items()}


def _graph_engine(dtype, loras=None, lora_ids=(None, None, None), **kw):
    """A small engine (head_dim 64) on the card with three requests
    prefilled (under ``lora_ids``, of the adapters ``loras`` loaded first),
    its decode batch built into a bucket's static buffers."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.pipeline import DeviceBatchState
    from ray_tpu_torch.models.llama import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaConfig(**GRAPH_MODEL, dtype=dtype)
    cfg = EngineConfig(model=model, num_blocks=64, block_size=4, max_num_seqs=4,
                       max_prefill_len=64, **kw)
    eng = LLMEngine(cfg, seed=0, device="cuda")
    for name, ad in (loras or {}).items():
        eng.add_lora(name, ad)
    rng = np.random.default_rng(5)
    sps = [SamplingParams(max_tokens=40, temperature=0.0, ignore_eos=True),
           SamplingParams(max_tokens=5, temperature=1.0, top_k=20, seed=3, ignore_eos=True),
           SamplingParams(max_tokens=40, temperature=0.7, seed=4, ignore_eos=True)]
    for n, sp, lid in zip((7, 23, 12), sps, lora_ids):
        eng.add_request(rng.integers(3, 500, size=n).tolist(), sp, lora_id=lid)
    eng.step()  # admits and prefills all three
    for r in eng.running:
        r.seq.ensure_capacity(r.num_tokens + 16)
    state = DeviceBatchState.build(eng, eng.running)
    return eng, state


def _snapshot(eng, bufs):
    return ({n: t.clone() for n, t in eng.cache.items()}, [t.clone() for t in bufs.carry()])


def _restore(eng, bufs, snap):
    cache, carry = snap
    for n, t in cache.items():
        eng.cache[n].copy_(t)
    for dst, src in zip(bufs.carry(), carry):
        dst.copy_(src)


@pytest.mark.parametrize("lora", [False, True], ids=["base", "adapters"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_replay_bit_identical_to_eager_chunk(dtype, lora):
    """A captured chunk's replay gives the eager chunk's bits (tokens,
    logprobs, n_emitted, steps_run, carry and cache), and two replays from
    the same state give the same bits; also with rows under two adapters
    and a base row."""
    _need_cuda()
    if lora:
        eng, state = _graph_engine(dtype, loras={"a": _adapter(1), "b": _adapter(2)},
                                   lora_ids=("a", None, "b"), **LORA_KW)
        assert state.bufs.lora_ids.tolist() == [1, 0, 2, 0]
    else:
        eng, state = _graph_engine(dtype)
    bufs, mode, n = state.bufs, state.sample_mode, 8
    assert mode == "full"
    snap = _snapshot(eng, bufs)
    eager = [t.clone() for t in eng._masked_chunk(bufs, n, mode, False)]
    after_eager = _snapshot(eng, bufs)
    replays = []
    for _ in range(2):
        _restore(eng, bufs, snap)
        got = eng._graphs.run(eng._masked_chunk, bufs, n, mode)
        toks, lps, ne, steps = got.wait()
        replays.append(((toks, lps, ne, steps), _snapshot(eng, bufs)))
    assert eng._graphs.captures == 1 and eng._graphs.replays == 2
    trash = eng.config.num_blocks * eng.config.block_size
    for (toks, lps, ne, steps), (cache, carry) in replays:
        assert np.array_equal(toks, eager[0].cpu().numpy())
        assert np.array_equal(lps, eager[1].cpu().numpy())
        assert np.array_equal(ne, eager[2].cpu().numpy()) and steps == int(eager[3])
        assert ne.tolist()[:3] == [8, 4, 8]  # row 1 stopped at its max_tokens
        for a, b in zip(carry, after_eager[1]):
            assert torch.equal(a, b)
        for name in ("k", "v"):
            assert torch.equal(cache[name][:, :, :trash], after_eager[0][name][:, :, :trash])


def test_graph_replays_follow_block_table_growth():
    """Chunks replayed back to back while rows grow into new blocks (the
    table re-uploaded between replays, nothing synced in between) match the
    same chunks run eagerly with the same tables."""
    _need_cuda()
    from ray_tpu_torch.llm.graphs import upload

    eng, state = _graph_engine(torch.float32)
    bufs, mode = state.bufs, state.sample_mode
    snap = _snapshot(eng, bufs)
    tables, eager = [], []
    for i in range(4):
        for r in eng.running:  # the chunk's 8 positions: new blocks from chunk 2 on
            r.seq.ensure_capacity(r.num_tokens + 8 * (i + 1))
        assert state.refresh_block_tables(eng.running)
        tables.append(state._bt_np.copy())
        eager.append(eng._masked_chunk(bufs, 8, mode, False)[0].cpu().numpy())
    assert not np.array_equal(tables[0], tables[-1])
    _restore(eng, bufs, snap)
    upload(bufs.block_tables, tables[0])
    inflight = []
    for table in tables:
        upload(bufs.block_tables, table)
        inflight.append(eng._graphs.run(eng._masked_chunk, bufs, 8, mode))
    for want, got in zip(eager, inflight):
        assert np.array_equal(got.wait()[0], want)
    assert eng._graphs.replays == 4


def test_paged_kernel_launches_inside_replay():
    """torch.profiler sees the paged kernels run inside a replay, as many
    as the graph recorded at its capture; the wrapper's counter does not
    move on replay."""
    _need_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng, state = _graph_engine(torch.bfloat16)
    bufs, mode = state.bufs, state.sample_mode
    eng._graphs.run(eng._masked_chunk, bufs, 4, mode).wait()  # capture + first replay
    per_replay = eng._graphs.launches["paged_attention"]
    assert per_replay == 4 * eng.config.model.n_layers
    before = tpa.paged_attention_cuda.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng._graphs.run(eng._masked_chunk, bufs, 4, mode).wait()
        torch.cuda.synchronize()
    assert tpa.paged_attention_cuda.launches == before
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    main = [n for n in names if "paged_attention_" in n and "combine" not in n]
    assert len(main) == per_replay, sorted(set(names))[:20]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_at_spec_verify_shape(dtype):
    """K4 at the speculative verify shape: 16 sequences of q_len 1..5
    (1 + draft length, k = 4) over contexts up to 2048, the 8B heads."""
    _need_cuda()
    rng = np.random.default_rng(12)
    q_lens = [int(x) for x in rng.integers(1, 6, size=16)]
    ctx_lens = [int(x) for x in rng.integers(64, 2049, size=16)]
    _, k, v, bt, ctx, bs = _paged_case(3, ctx_lens, H=32, KVH=8, D=128, bs=16, MB=128,
                                       dtype=dtype)
    T = sum(q_lens)
    q = torch.from_numpy(rng.normal(size=(T, 32, 128)).astype(np.float32)).to(dtype)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32)
    ref = trg.ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)
    got = trg.ragged_attention(*(t.cuda() for t in (q, k, v, bt, cu, ctx)), block_size=bs,
                               max_q_len=5).cpu()
    assert float((got.float() - ref.float()).abs().max()) <= BANDS[dtype]


def test_graph_cap_evicts_least_recently_replayed(monkeypatch):
    """Past MAX_GRAPHS the least recently replayed graph goes; its bucket
    is captured again on its next use."""
    _need_cuda()
    from ray_tpu_torch.llm import graphs

    monkeypatch.setattr(graphs, "MAX_GRAPHS", 1)
    eng, state = _graph_engine(torch.float32)
    for n in (2, 4, 2):
        eng._graphs.run(eng._masked_chunk, state.bufs, n, state.sample_mode).wait()
    st = eng._graphs.stats()
    assert (st["graphs"], st["captured"], st["evicted"], st["replays"]) == (1, 3, 2, 3)


# ---------------------------------------------------------------------------
# LoRA adapters in the captured chunks
# ---------------------------------------------------------------------------


def test_adapter_added_after_capture_is_seen_by_replay():
    """The graph reads the adapter stacks and the rows' slots by address:
    an adapter loaded after the bucket's capture, selected by a row through
    the slot buffer, changes the next replay's tokens to the eager chunk's
    with no new capture; the base row does not move."""
    _need_cuda()
    from ray_tpu_torch.llm.graphs import upload

    eng, state = _graph_engine(torch.float32, loras={"a": _adapter(1)},
                               lora_ids=("a", None, "a"), **LORA_KW)
    bufs, mode = state.bufs, state.sample_mode
    snap = _snapshot(eng, bufs)
    first = eng._graphs.run(eng._masked_chunk, bufs, 8, mode).wait()[0]
    eng.add_lora("b", _adapter(2))  # slot 2, written after the capture
    upload(bufs.lora_ids, np.array([2, 0, 2, 0], np.int32))  # rows 0 and 2 under "b"
    _restore(eng, bufs, snap)
    eager = eng._masked_chunk(bufs, 8, mode, False)[0].cpu().numpy()
    _restore(eng, bufs, snap)
    replay = eng._graphs.run(eng._masked_chunk, bufs, 8, mode).wait()[0]
    assert eng._graphs.captures == 1 and eng._graphs.replays == 2
    assert np.array_equal(replay, eager)
    assert not np.array_equal(replay[:, [0, 2]], first[:, [0, 2]])
    assert np.array_equal(replay[:, 1], first[:, 1])


def _serve_tokens(eng, prompts, lora_ids, logprobs=False):
    from ray_tpu_torch.llm import SamplingParams

    sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True, logprobs=logprobs)
    reqs = []
    for p, lid in zip(prompts, lora_ids):
        reqs.append(eng.requests[eng.add_request(p, sp, lora_id=lid)])
    while eng.has_unfinished():
        eng.step()
    return [(r.output_token_ids, r.token_logprobs) for r in reqs]


def _small_engine(dtype, params=None, **kw):
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EngineConfig(model=LlamaConfig(**GRAPH_MODEL, dtype=dtype), num_blocks=64,
                       block_size=4, max_num_seqs=4, max_prefill_len=64, **kw)
    return LLMEngine(cfg, params=params, seed=0, device="cuda")


def _prompts4():
    rng = np.random.default_rng(8)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in (9, 21, 14, 33)]


def test_removed_then_readded_slot_serves_the_new_adapter_on_graphs():
    """remove_lora then add_lora of another adapter into the same (only)
    slot: the pipelined engine's replays give the new adapter's tokens, as
    a sync engine loaded with it from the start does (fp32)."""
    _need_cuda()
    prompts = _prompts4()
    eng = _small_engine(torch.float32, max_loras=1, lora_targets=("wq", "wk", "wv"))
    eng.add_lora("a", _adapter(1))
    out_a = _serve_tokens(eng, prompts, ["a", None, "a", "a"])
    replays = eng._graphs.replays
    eng.remove_lora("a")
    eng.add_lora("b", _adapter(2))
    assert eng._lora_slots == {"b": 1}
    out_b = _serve_tokens(eng, prompts, ["b", None, "b", "b"])
    assert eng._graphs.replays > replays
    sync = _small_engine(torch.float32, params=eng.params, max_loras=1,
                         lora_targets=("wq", "wk", "wv"), pipeline_decode=False)
    sync.add_lora("b", _adapter(2))
    want = _serve_tokens(sync, prompts, ["b", None, "b", "b"])
    assert [t for t, _ in out_b] == [t for t, _ in want]
    assert all(a != b for (a, _), (b, _), i in zip(out_a, out_b, range(4)) if i != 1)


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_base_rows_under_lora_engine_bit_identical_to_base_engine(mixed):
    """bf16, pipelined on graphs: base rows of an engine with adapters
    loaded (and adapter rows beside them) give the tokens and the logprob
    bits of an engine without LoRA serving the same batch (same B_pad)."""
    _need_cuda()
    prompts = _prompts4()
    kw = dict(mixed_batch=mixed, mixed_prefill_chunk=16)
    base = _small_engine(torch.bfloat16, **kw)
    want = _serve_tokens(base, prompts, [None] * 4, logprobs=True)
    eng = _small_engine(torch.bfloat16, params=base.params, **kw, **LORA_KW)
    eng.add_lora("a", _adapter(1))
    eng.add_lora("b", _adapter(2))
    ids = ["a", None, "b", None]
    got = _serve_tokens(eng, prompts, ids, logprobs=True)
    assert eng.stats()["pipeline"]["graphs"]["replays"] > 0
    for (t, lp), (wt, wlp), lid in zip(got, want, ids):
        if lid is None:
            assert t == wt and lp == wlp
        else:
            assert t != wt


def test_bf16_pipelined_and_sync_chunks_agree_at_the_same_b_pad():
    """The cause of the bf16 pipelined-vs-sync token gap of the 8B engine:
    from one batch state, the pipelined chunk (a graph replay) and the sync
    path's chunk (llm/decode_loop.py) give the same bf16 bits when the batch
    is padded to the same B_pad; padded to another B_pad the GEMMs may take
    another cuBLAS plan, so the bits may differ (the first step's logprobs
    stay within the bf16 band)."""
    _need_cuda()
    from ray_tpu_torch.llm.decode_loop import decode_chunk
    from ray_tpu_torch.llm.pipeline import assemble_batch_arrays

    eng, state = _graph_engine(torch.bfloat16)
    bufs, mode = state.bufs, state.sample_mode
    snap = _snapshot(eng, bufs)
    toks, lps, n_emit, _ = eng._graphs.run(eng._masked_chunk, bufs, 8, mode).wait()
    c = eng.config

    def sync_chunk(B_pad):
        _restore(eng, bufs, snap)
        a, seeds = assemble_batch_arrays(eng.running, B_pad, state.bt_width)
        remaining = np.zeros(B_pad, np.int32)
        remaining[: len(eng.running)] = [eng._remaining(r) for r in eng.running]
        t = lambda x: torch.from_numpy(np.asarray(x)).cuda()  # noqa: E731
        out_t, out_lp, _ = decode_chunk(
            eng.params, t(a["tokens"]), t(a["positions"]), t(a["bt"]), t(a["context_lens"]),
            eng.cache, t(a["temps"]), t(a["top_ks"]), t(a["top_ps"]), t(seeds), t(a["starts"]),
            t(remaining), c.model, n_steps=8, block_size=c.block_size,
            trash_slot=c.num_blocks * c.block_size, sample_mode=mode)
        return out_t.cpu().numpy(), out_lp.cpu().numpy()

    same_t, same_lp = sync_chunk(state.B_pad)
    for j in range(3):
        n = int(n_emit[j])
        assert np.array_equal(toks[:n, j], same_t[:n, j])
        assert np.array_equal(lps[:n, j], same_lp[:n, j])  # the same bits
    wide_t, wide_lp = sync_chunk(16)
    assert np.abs(wide_lp[0, :3] - same_lp[0, :3]).max() <= BANDS[torch.bfloat16]


# ---------------------------------------------------------------------------
# the mixed step and the ragged verifier on captured CUDA graphs per
# packed-token bucket (llm/graphs.PackedGraphs)
# ---------------------------------------------------------------------------


class _TailDrafter:
    """Drafts the last 1..k tokens of the history again (the count from its
    length): a verify pass every round, rows of 2 to k + 1 packed tokens,
    whatever the weights."""

    def propose(self, request_id, tokens, k):
        return list(tokens[-(1 + len(tokens) % k):])[:k]

    def release(self, request_id):
        pass


def _packed_engine(dtype, params=None, loras=None, spec=False, **kw):
    """A small mixed-batching engine on the card (GRAPH_MODEL, block_size 4,
    16-token chunks), with ``loras`` loaded and, with ``spec``, k = 4 and
    the tail drafter."""
    from ray_tpu_torch.llm.spec import SpecConfig

    eng = _small_engine(dtype, params=params, mixed_batch=True, mixed_prefill_chunk=16,
                        **({"spec": SpecConfig(num_draft_tokens=4)} if spec else {}), **kw)
    if spec:
        eng.drafter = _TailDrafter()
    for name, ad in (loras or {}).items():
        eng.add_lora(name, ad)
    return eng


def _replays_checked(eng, family):
    """Wrap ``family.run``: every dispatch first runs the program eagerly on
    the bucket's buffers, then the cache is put back and the graph replays
    (captured on the bucket's first use); each entry says whether the
    replay gave the eager logits and K/V bits."""
    trash = eng.config.num_blocks * eng.config.block_size
    real = family.run
    results = []

    def run(fn, bufs):
        snap = {n: t.clone() for n, t in eng.cache.items()}
        eager = fn(bufs).clone()
        eager_kv = {n: t[:, :, :trash].clone() for n, t in eng.cache.items()}
        for n, t in snap.items():
            eng.cache[n].copy_(t)
        out = real(fn, bufs)
        same = torch.equal(out, eager) and all(
            torch.equal(eng.cache[n][:, :, :trash], eager_kv[n]) for n in eager_kv)
        results.append((bufs.key, same))
        return out

    family.run = run
    return results


def _prompts_long():
    rng = np.random.default_rng(8)
    return [rng.integers(3, 500, size=int(n)).tolist() for n in (9, 41, 14, 60)]


@pytest.mark.parametrize("lora", [False, True], ids=["base", "adapters"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("program", ["mixed", "verify"])
def test_packed_graph_replay_bit_identical_to_eager(program, dtype, lora):
    """Every mixed step (or ragged verify pass) of a served batch: the
    bucket's replay gives the eager program's logits and K/V bits on the
    same buffers, first use (capture) or later; also with rows under two
    adapters and base rows. K4 runs inside the replays."""
    _need_cuda()
    kw = dict(loras={"a": _adapter(1), "b": _adapter(2)}, **LORA_KW) if lora else {}
    eng = _packed_engine(dtype, spec=program == "verify", **kw)
    family = eng._mixed_graphs if program == "mixed" else eng._verify_graphs
    results = _replays_checked(eng, family)
    _serve_tokens(eng, _prompts_long(), ["a", None, "b", "a"] if lora else [None] * 4)
    st = family.stats()
    assert len(results) >= 2 and all(same for _, same in results), results
    assert st["replays"] == len(results) and 1 <= st["captured"] <= len({k for k, _ in results})
    assert st["replay_kernel_launches"]["ragged_attention"] > 0
    assert all(k[5] == lora for k, _ in results)


def test_packed_graph_stale_tail_on_card():
    """fp32 on the card: a T = 56 step replays the T_pad 64 graph a T = 64
    step captured; its tail is trash, no live slot outside its rows moves,
    and logits and K/V equal the eager mixed_step on fresh tensors."""
    _need_cuda()
    from ray_tpu_torch.models import llama_decode as tld

    eng = _packed_engine(torch.float32)
    trash = eng.config.num_blocks * eng.config.block_size
    real, calls = eng._mixed_graphs.run, []

    def run(fn, bufs):
        before = {n: t.clone() for n, t in eng.cache.items()}
        inputs = {n: getattr(bufs, n).clone() for n in bufs._inputs()}
        out = real(fn, bufs)
        calls.append((bufs, inputs, before, out.clone(),
                      {n: t.clone() for n, t in eng.cache.items()}))
        return out

    eng._mixed_graphs.run = run
    rng = np.random.default_rng(4)
    _serve_tokens(eng, [rng.integers(3, 500, size=30).tolist() for _ in range(4)], [None] * 4)
    (b1, in1, _, _, _), (b2, inp, before, logits, after) = calls[:2]
    assert b2 is b1 and int(in1["cu_q_lens"][-1]) == 64 and int(inp["cu_q_lens"][-1]) == 56
    assert eng._mixed_graphs.stats()["buckets"][0]["replays"] >= 2
    assert torch.all(inp["slots"][56:] == trash) and not inp["tokens"][56:].any()
    own = set(inp["slots"][:56].tolist())
    others = torch.tensor([s for s in range(trash) if s not in own], device="cuda")
    for n in ("k", "v"):
        assert torch.equal(after[n][:, :, others], before[n][:, :, others])
    c = eng.config
    cache = {n: t.clone() for n, t in before.items()}
    lg, cache = tld.mixed_step(
        eng.params, *(inp[n].clone() for n in ("tokens", "positions", "slots", "block_tables",
                                                "cu_q_lens", "context_lens")),
        cache, c.model, block_size=c.block_size, max_q_len=c.mixed_prefill_chunk)
    assert torch.equal(lg, logits)
    for n in ("k", "v"):
        assert torch.equal(cache[n][:, :, :trash], after[n][:, :, :trash])


@pytest.mark.parametrize("lora", [False, True], ids=["base", "adapters"])
def test_mixed_graphs_on_card_match_cpu_tokens(lora):
    """fp32: mixed batching on the card, every mixed step a graph replay
    (pipelined and sync decode rounds), gives the CPU's greedy tokens; also
    with two adapters and base rows."""
    _need_cuda()
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaConfig(**GRAPH_MODEL, dtype=torch.float32)
    params = init_params(model, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: (v.cuda() if torch.is_tensor(v) else {n: t.cuda() for n, t in v.items()})
               for k, v in params.items()}
    ids = ["a", None, "b", "a"] if lora else [None] * 4
    outs = []
    for dev, p, pipelined in (("cuda", on_card, True), ("cuda", on_card, False),
                              ("cpu", params, True)):
        cfg = EngineConfig(model=model, num_blocks=64, block_size=4, max_num_seqs=4,
                           max_prefill_len=64, mixed_batch=True, mixed_prefill_chunk=16,
                           pipeline_decode=pipelined, **(LORA_KW if lora else {}))
        eng = LLMEngine(cfg, params=p, device=dev)
        if lora:
            eng.add_lora("a", _adapter(1))
            eng.add_lora("b", _adapter(2))
        outs.append([t for t, _ in _serve_tokens(eng, _prompts_long(), ids)])
        st = eng.stats()["mixed"]
        if dev == "cuda":
            assert st["graphs"]["replays"] == st["dispatches"] > 0
    assert outs[0] == outs[1] == outs[2]


def test_greedy_spec_with_replayed_verify_matches_non_spec_on_card():
    """fp32 greedy spec (k = 4, the tail drafter: a verify pass every round)
    with mixed batching on the card, every ragged verify pass a graph
    replay, gives the non-spec engine's tokens."""
    _need_cuda()
    prompts = _prompts_long()
    want = [t for t, _ in _serve_tokens(_packed_engine(torch.float32), prompts, [None] * 4)]
    eng = _packed_engine(torch.float32, spec=True)
    got = [t for t, _ in _serve_tokens(eng, prompts, [None] * 4)]
    st = eng.stats()["spec"]
    assert got == want
    assert st["verify_graphs"]["replays"] == st["steps"] > 0 and st["drafted_tokens"] > 0


def test_adapter_added_after_mixed_capture_is_seen_by_replay():
    """A mixed-step graph reads the adapter stacks and the tokens' slots by
    address: an adapter loaded after the bucket's capture, selected through
    the slot buffer, gives the next replay the eager program's logits with
    no new capture."""
    _need_cuda()
    from ray_tpu_torch.llm.graphs import upload

    eng = _packed_engine(torch.float32, loras={"a": _adapter(1)}, **LORA_KW)
    _serve_tokens(eng, _prompts_long(), ["a", None, "a", "a"])
    fam = eng._mixed_graphs
    bufs = next(b for k, b in fam._bufs.items() if k in fam._graphs)
    ids = bufs.lora_ids.cpu().numpy()
    assert (ids == 1).any()
    snap = {n: t.clone() for n, t in eng.cache.items()}

    def restore():
        for n, t in snap.items():
            eng.cache[n].copy_(t)

    first = fam.run(eng._mixed_program, bufs).clone()
    restore()
    eng.add_lora("b", _adapter(2))  # slot 2, written after the capture
    upload(bufs.lora_ids, np.where(ids == 1, 2, ids).astype(np.int32))
    eager = eng._mixed_program(bufs).clone()
    restore()
    captures = fam.captures
    replay = fam.run(eng._mixed_program, bufs).clone()
    restore()
    assert fam.captures == captures
    assert torch.equal(replay, eager) and not torch.equal(replay, first)


def test_packed_graph_cap_evicts_least_recently_replayed(monkeypatch):
    """Past MAX_GRAPHS the least recently replayed mixed-step graph goes;
    its bucket is captured again on its next use (buckets of idle rows:
    every token on the trash slot, every q_len 0)."""
    _need_cuda()
    from ray_tpu_torch.llm import graphs

    monkeypatch.setattr(graphs, "MAX_GRAPHS", 1)
    eng = _packed_engine(torch.float32)
    fam = eng._mixed_graphs
    trash = eng.config.num_blocks * eng.config.block_size
    buckets = []
    for T_pad in (16, 32):
        b = fam.buffers("mixed", T_pad, 4, 16)
        b.slots.fill_(trash)
        buckets.append(b)
    for b in (buckets[0], buckets[1], buckets[0]):
        fam.run(eng._mixed_program, b)
    st = fam.stats()
    assert (st["graphs"], st["captured"], st["evicted"], st["replays"]) == (1, 3, 2, 3)


@pytest.mark.parametrize("decode", ["pipelined", "spec"])
def test_recover_rebuilt_after_captures_replays_write_the_live_cache(decode):
    """fp32, mixed batching on the card: a first pass captures the mixed
    graphs and the decode-chunk graphs (pipelined) or the verify graphs
    (spec). In a second pass of the same prompts, recover(rebuild_kv=True)
    after three steps zeroes the cache in place (same tensors) and the
    replays that follow, of graphs captured before it, write the live
    cache: the tokens equal a fault-free run's."""
    _need_cuda()
    from ray_tpu_torch.llm import SamplingParams

    spec = decode == "spec"
    prompts = _prompts_long()
    want = [t for t, _ in _serve_tokens(_packed_engine(torch.float32), prompts, [None] * 4)]
    eng = _packed_engine(torch.float32, spec=spec)
    assert [t for t, _ in _serve_tokens(eng, prompts, [None] * 4)] == want
    fams = (eng._graphs, eng._mixed_graphs, eng._verify_graphs)
    assert eng._mixed_graphs.captures > 0
    assert (eng._verify_graphs if spec else eng._graphs).captures > 0
    captured = [set(f._graphs) for f in fams]
    ptrs = {n: t.data_ptr() for n, t in eng.cache.items()}

    eng.allocator.drop_prefix_cache()
    sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    reqs = [eng.requests[eng.add_request(p, sp)] for p in prompts]
    for _ in range(3):
        eng.step()
    assert any(r.output_token_ids for r in reqs)
    replays_before = [dict(f.replays_by_key) for f in fams]
    eng.recover(rebuild_kv=True)
    torch.cuda.synchronize()
    assert {n: t.data_ptr() for n, t in eng.cache.items()} == ptrs
    assert not any(bool(t.any()) for t in eng.cache.values())
    while eng.has_unfinished():
        eng.step()
    assert [r.output_token_ids for r in reqs] == want
    reused = sum(f.replays_by_key[k] - before.get(k, 0)
                 for f, keys, before in zip(fams, captured, replays_before) for k in keys)
    assert reused > 0
    assert eng.allocator.num_free == eng.config.num_blocks


def test_llm_server_on_card_matches_cpu():
    """The OpenAI front end over an fp32 engine on the card (mixed steps
    and decode chunks as graph replays, all on the runner's loop thread)
    answers completions, a list of prompts, chat and a stream with the
    CPU server's payloads, ids and timestamps aside."""
    _need_cuda()
    import asyncio

    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaConfig(**GRAPH_MODEL, dtype=torch.float32)
    params = init_params(model, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: (v.cuda() if torch.is_tensor(v) else {n: t.cuda() for n, t in v.items()})
               for k, v in params.items()}

    class _Req:
        def __init__(self, method, path, body):
            self.method, self.path, self.body = method, path, body

        def json(self):
            return self.body

    bodies = [("/v1/completions", {"prompt": "hello world", "max_tokens": 12,
                                   "temperature": 0.0}),
              ("/v1/completions", {"prompt": ["a", "The cat", "0123" * 12], "max_tokens": 10,
                                   "temperature": 0.0}),
              ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                        "max_tokens": 8, "temperature": 0.0}),
              ("/v1/completions", {"prompt": "zzz", "max_tokens": 6, "temperature": 0.0,
                                   "stream": True})]

    async def serve(srv):
        outs = await asyncio.gather(*[srv(_Req("POST", p, b)) for p, b in bodies])
        deltas = [d async for d in srv.generate_stream("hello world", max_tokens=12,
                                                       temperature=0.0)]
        strip = [o if isinstance(o, str) else
                 {k: v for k, v in o.items() if k not in ("id", "created", "trace_id")}
                 for o in outs]
        strip[-1] = strip[-1].split('"choices"')[1]  # the SSE body past its ids
        return strip, "".join(deltas)

    results = []
    for dev, p in (("cuda", on_card), ("cpu", params)):
        cfg = EngineConfig(model=model, num_blocks=64, block_size=4, max_num_seqs=4,
                           max_prefill_len=64, mixed_batch=True, mixed_prefill_chunk=16)
        srv = LLMServer(LLMConfig(model_id="m", engine=cfg, params=p, device=dev))
        try:
            results.append(asyncio.run(serve(srv)))
            st = srv.stats()
        finally:
            srv.shutdown()
        if dev == "cuda":
            assert st["mixed"]["graphs"]["replays"] == st["mixed"]["dispatches"] > 0
            assert st["pipeline"]["graphs"]["replays"] > 0
    assert results[0] == results[1]
    assert results[0][1] == results[0][0][0]["choices"][0]["text"]


def _export_after_prefill(eng, prompt, rid):
    """Admit ``prompt`` on ``eng``, step until its prompt is complete, export."""
    from ray_tpu_torch.llm import SamplingParams

    eng.add_request(prompt, SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True),
                    request_id=rid)
    while rid in eng._mixed_prefills or not eng.requests[rid].output_token_ids:
        eng.step()
    return eng.export_request(rid)


def test_import_after_capture_is_read_by_the_replays():
    """fp32, mixed batching on the card: a decode engine serves a first pass
    (its graphs captured), then twice imports handoffs of the same prompts
    that a card prefill engine exported. The imports write the cache in
    place (same tensors), the second round captures nothing and replays
    only graphs captured before its imports, and every continued stream
    equals a colocated engine's. The chunk controller is pinned (no
    step-up), so both rounds decode the same chunks."""
    _need_cuda()
    from ray_tpu_torch.llm.pipeline import ChunkController, PipelineStats

    prompts = _prompts_long()
    want = [t for t, _ in _serve_tokens(_packed_engine(torch.float32), prompts, [None] * 4)]
    dec = _packed_engine(torch.float32)
    dec._pipe_ctl, dec._pipe_stats = ChunkController(initial=8, target_ratio=0.0), PipelineStats()
    assert [t for t, _ in _serve_tokens(dec, prompts, [None] * 4)] == want
    fams = (dec._graphs, dec._mixed_graphs)
    assert all(f.captures > 0 for f in fams)
    ptrs = {n: t.data_ptr() for n, t in dec.cache.items()}
    prefills = dec.num_prefill_batches
    pre = _packed_engine(torch.float32)
    for rnd in range(2):
        captures0 = sum(f.captures for f in fams)
        keys0 = [set(f._graphs) for f in fams]
        replays0 = [dict(f.replays_by_key) for f in fams]
        handoffs = [_export_after_prefill(pre, p, f"h{rnd}-{i}") for i, p in enumerate(prompts)]
        for h in handoffs:
            assert h.k_pages.is_pinned() and h.verify()
            dec.import_handoff(h)
            assert set(h.timings) == {"pin_ms", "gather_ms", "d2h_ms", "seal_ms", "h2d_ms",
                                      "scatter_ms"}
        assert {n: t.data_ptr() for n, t in dec.cache.items()} == ptrs
        got = {}
        while dec.has_unfinished():
            for o in dec.step():
                if o.finished:
                    got[o.request_id] = o.output_token_ids
        assert [got[f"h{rnd}-{i}"] for i in range(4)] == want
        if rnd == 1:
            assert sum(f.captures for f in fams) == captures0
            reused = sum(f.replays_by_key[k] - r0.get(k, 0)
                         for f, keys, r0 in zip(fams, keys0, replays0) for k in keys)
            assert reused > 0
    assert dec.num_prefill_batches == prefills and dec.stats()["num_kv_imports"] == 8
    assert dec.allocator.num_free == dec.config.num_blocks


def test_bf16_export_import_bit_for_bit():
    """bf16 on the card: the exported pages are the prefill cache's slots,
    bit for bit; imported, they are the decode cache's slots, bit for bit."""
    _need_cuda()
    pre = _packed_engine(torch.bfloat16)
    prompt = _prompts_long()[3]
    pre.add_request(prompt, None, request_id="b")
    while "b" in pre._mixed_prefills or not pre.requests["b"].output_token_ids:
        pre.step()
    src = pre.requests["b"].seq.slots_for_range(0, len(prompt))
    k_src = pre.cache["k"][:, :, src].cpu()
    v_src = pre.cache["v"][:, :, src].cpu()
    h = pre.export_request("b")
    assert h.k_pages.dtype == torch.bfloat16 and h.num_kv_tokens == len(prompt)
    assert torch.equal(h.k_pages, k_src) and torch.equal(h.v_pages, v_src)
    dec = _packed_engine(torch.bfloat16)
    dec.import_handoff(h)
    dst = dec.requests["b"].seq.slots_for_range(0, len(prompt))
    assert torch.equal(dec.cache["k"][:, :, dst].cpu(), k_src)
    assert torch.equal(dec.cache["v"][:, :, dst].cpu(), v_src)


def test_two_engines_capture_concurrently_on_two_threads():
    """Two fresh fp32 engines served at once from two threads, each
    capturing its graphs while the other one works: the tokens equal one
    engine served alone, and each graph's per-replay launch count equals
    the lone engine's (a capture reads its own thread's launch tally)."""
    _need_cuda()
    import threading

    prompts = _prompts_long()
    alone = _packed_engine(torch.float32)
    want = [t for t, _ in _serve_tokens(alone, prompts, [None] * 4)]
    engines = [_packed_engine(torch.float32) for _ in range(2)]
    results, errors = [None, None], []
    start = threading.Barrier(2)

    def serve(i):
        try:
            start.wait(timeout=60)
            for _ in range(2):  # the second pass replays what the first captured
                engines[i].allocator.drop_prefix_cache()
                results[i] = [t for t, _ in _serve_tokens(engines[i], prompts, [None] * 4)]
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert results == [want, want]
    for eng in engines:
        for fam, ref in ((eng._graphs, alone._graphs), (eng._mixed_graphs, alone._mixed_graphs)):
            assert fam.captures > 0 and fam.replays > 0
            common = fam._graphs.keys() & ref._graphs.keys()
            assert common
            assert all(fam._graphs[k][2] == ref._graphs[k][2] for k in common)


def test_disagg_on_card_matches_cpu_colocated():
    """The orchestrator on the card (fp32; one prefill and one decode
    engine, each on its loop thread, graphs captured concurrently) gives
    the CPU colocated engine's greedy tokens, mixed batching on and off."""
    _need_cuda()
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaConfig(**GRAPH_MODEL, dtype=torch.float32)
    params = init_params(model, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: (v.cuda() if torch.is_tensor(v) else {n: t.cuda() for n, t in v.items()})
               for k, v in params.items()}
    prompts = _prompts_long()
    sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    for mixed in (False, True):
        cfg = EngineConfig(model=model, num_blocks=64, block_size=4, max_num_seqs=4,
                           max_prefill_len=64, mixed_batch=mixed, mixed_prefill_chunk=16)
        want = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sp)
        orch = DisaggOrchestrator(DisaggConfig(engine=cfg), params=on_card, device="cuda")
        try:
            got = orch.generate(prompts, sp, timeout_s=120)
            st = orch.stats()
        finally:
            orch.shutdown()
        assert got == want
        assert st["transfer"]["kv_transfers"] == 4 and st["transfer"]["reprefills"] == 0
        assert st["decode"][0]["num_prefill_batches"] == 0
        assert st["decode"][0]["pipeline"]["graphs"]["replays"] > 0
        assert orch._prefill[0].engine.params["embed"].data_ptr() == on_card["embed"].data_ptr()


# ---------------------------------------------------------------------------
# the device fabric (fabric/) on the card
# ---------------------------------------------------------------------------


def test_device_checksum_on_card_equals_cpu():
    """The sum reduced on the card equals the CPU's for the same bytes (the
    CPU's is held against the reference's by tests/test_torch_fabric.py),
    every lane width, the empty tensor, and a tensor past one slice of
    widened lanes."""
    _need_cuda()
    from ray_tpu_torch.fabric.transport import _SLICE, ArrayBundle, device_checksum

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 7)) * 100.0
    cases = [torch.from_numpy(x.astype(d)) for d in ("float32", "float16", "int32", "int8",
                                                     "uint8")]
    cases += [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16), torch.empty(0),
              torch.from_numpy(rng.standard_normal(_SLICE + 12345).astype(np.float32))
              .to(torch.bfloat16)]
    for t in cases:
        assert device_checksum(t.cuda()) == device_checksum(t), t.dtype
    pages = {"k_pages": cases[5].cuda(), "v_pages": cases[0].cuda()}
    assert ArrayBundle("b", pages).seal().checksum == ArrayBundle(
        "b", {n: a.cpu() for n, a in pages.items()}).seal().checksum


def test_corrupted_device_bundle_fails_verify_on_card():
    """CORRUPT_DEVICE_TRANSFER through the transport on the card: the
    received handoff fails its device verify, the sender's pages are intact
    and still verify."""
    _need_cuda()
    from ray_tpu_torch import chaos
    from ray_tpu_torch.chaos.schedule import CORRUPT_DEVICE_TRANSFER
    from ray_tpu_torch.fabric import DeviceKVConnector

    pre = _packed_engine(torch.bfloat16)
    pre.add_request(_prompts_long()[3], None, request_id="c")
    while "c" in pre._mixed_prefills or not pre.requests["c"].output_token_ids:
        pre.step()
    h = pre.export_request("c", keep_on_device=True)
    assert h.k_pages.is_cuda and h.checksum_kind == "device_u32" and h.verify()
    before = h.k_pages.clone()
    conn = DeviceKVConnector(namespace="t-card-corrupt")
    chaos.install(chaos.FaultSchedule(7, [chaos.FaultSpec(CORRUPT_DEVICE_TRANSFER,
                                                          site="disagg.kv_transfer",
                                                          max_fires=1)]))
    try:
        conn.send(conn.register_target("d0", device=pre.kv_cache_device()), h)
        got = conn.recv("d0", timeout_s=5.0)
    finally:
        chaos.uninstall()
        conn.close()
    assert got.k_pages.is_cuda and got.k_pages.data_ptr() != h.k_pages.data_ptr()
    assert not got.verify()
    assert h.verify() and torch.equal(h.k_pages, before)


def test_device_export_import_replays_over_its_pages():
    """fp32, mixed batching on the card: a decode engine serves a first pass
    (graphs captured), then twice imports DEVICE handoffs of the same
    prompts (exported with keep_on_device: device pages, sealed on the
    card, no pinned pages, no copy either way). The imports write the cache
    in place, the second round captures nothing and replays graphs captured
    before its imports, and every stream equals a colocated engine's."""
    _need_cuda()
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.pipeline import ChunkController, PipelineStats

    prompts = _prompts_long()
    want = [t for t, _ in _serve_tokens(_packed_engine(torch.float32), prompts, [None] * 4)]
    dec = _packed_engine(torch.float32)
    dec._pipe_ctl, dec._pipe_stats = ChunkController(initial=8, target_ratio=0.0), PipelineStats()
    assert [t for t, _ in _serve_tokens(dec, prompts, [None] * 4)] == want
    fams = (dec._graphs, dec._mixed_graphs)
    ptrs = {n: t.data_ptr() for n, t in dec.cache.items()}
    pre = _packed_engine(torch.float32)
    for rnd in range(2):
        captures0 = sum(f.captures for f in fams)
        keys0 = [set(f._graphs) for f in fams]
        replays0 = [dict(f.replays_by_key) for f in fams]
        handoffs = []
        for i, p in enumerate(prompts):
            rid = f"d{rnd}-{i}"
            pre.add_request(p, SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True),
                            request_id=rid)
            while rid in pre._mixed_prefills or not pre.requests[rid].output_token_ids:
                pre.step()
            handoffs.append(pre.export_request(rid, keep_on_device=True))
        for h in handoffs:
            assert h.k_pages.is_cuda and not h.k_pages.is_pinned()
            assert h.checksum_kind == "device_u32" and h.verify()
            dec.import_handoff(h)
            assert set(h.timings) == {"gather_ms", "seal_ms", "scatter_ms"}
        assert {n: t.data_ptr() for n, t in dec.cache.items()} == ptrs
        got = {}
        while dec.has_unfinished():
            for o in dec.step():
                if o.finished:
                    got[o.request_id] = o.output_token_ids
        assert [got[f"d{rnd}-{i}"] for i in range(4)] == want
        if rnd == 1:
            assert sum(f.captures for f in fams) == captures0
            assert sum(f.replays_by_key[k] - r0.get(k, 0)
                       for f, keys, r0 in zip(fams, keys0, replays0) for k in keys) > 0
    assert dec.stats()["num_kv_imports"] == 8


def test_device_disagg_on_card_matches_cpu_and_falls_back():
    """The orchestrator on the card over the device connector (fp32): the
    CPU colocated engine's greedy tokens with every transfer on the device
    plane; with one CORRUPT_DEVICE_TRANSFER the edge degrades to RPC, the
    request re-prefills once and the tokens are the same."""
    _need_cuda()
    from ray_tpu_torch import chaos
    from ray_tpu_torch.chaos.schedule import CORRUPT_DEVICE_TRANSFER
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.disagg import DisaggConfig, DisaggOrchestrator
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaConfig(**GRAPH_MODEL, dtype=torch.float32)
    params = init_params(model, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: (v.cuda() if torch.is_tensor(v) else {n: t.cuda() for n, t in v.items()})
               for k, v in params.items()}
    prompts = _prompts_long()
    sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    cfg = EngineConfig(model=model, num_blocks=64, block_size=4, max_num_seqs=4,
                       max_prefill_len=64, mixed_batch=True, mixed_prefill_chunk=16)
    want = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sp)
    for fault in (False, True):
        if fault:
            chaos.install(chaos.FaultSchedule(7, [chaos.FaultSpec(
                CORRUPT_DEVICE_TRANSFER, site="disagg.kv_transfer", max_fires=1)]))
        orch = DisaggOrchestrator(DisaggConfig(engine=cfg, connector="device"), params=on_card,
                                  device="cuda")
        try:
            got = orch.generate(prompts[:1], sp, timeout_s=120)
            got += orch.generate(prompts[1:], sp, timeout_s=120)
            st = orch.stats()
            done = list(orch.handoffs)
        finally:
            orch.shutdown()
            chaos.uninstall()
        assert got == want
        assert st["decode"][0]["num_prefill_batches"] == 0
        if not fault:
            assert st["fabric"]["backends"] == {"device": 4} and st["fabric"]["fallbacks"] == 0
            assert all(h["backend"] == "device" and "h2d_ms" not in h and "pin_ms" not in h
                       for h in done)
        else:
            assert st["fabric"]["fallbacks"] == 1 and st["transfer"]["reprefills"] == 1
            assert st["fabric"]["backends"] == {"device": 1, "rpc": 4}
            assert all(h["backend"] == "rpc" for h in done)


# ---------------------------------------------------------------------------
# the tiered KV cache (llm/kvtier) on the card
# ---------------------------------------------------------------------------


def _tier_engine(dtype, **kvtier):
    """A small mixed-batching engine with the tiered cache (host tier only)."""
    return _packed_engine(dtype, kvtier={"object_bytes": 0, **kvtier})


def _chain_blocks(eng, prompt):
    """(hash, block id) of the prompt's full blocks sealed in HBM."""
    from ray_tpu_torch.llm.kv_cache import BlockAllocator

    bs, h, out = eng.config.block_size, 0, []
    for i in range(len(prompt) // bs):
        h = BlockAllocator.chain_hash(h, tuple(prompt[i * bs:(i + 1) * bs]))
        out.append((h, eng.allocator._hash_to_block.get(h)))
    return out


def _evict_all(eng):
    alloc = eng.allocator
    alloc.free(alloc.allocate(alloc.num_free))
    assert eng.kvtier.flush_spills(60.0)


def _block_pages(eng, b):
    bs = eng.config.block_size
    return (eng.cache["k"][:, :, b * bs:(b + 1) * bs].cpu(),
            eng.cache["v"][:, :, b * bs:(b + 1) * bs].cpu())


def test_kvtier_resurrected_pages_equal_captured_bit_for_bit():
    """bf16: a block spilled from HBM holds the cache's pages bit for bit in
    its pinned slab slot, and resurrected into another block the cache holds
    them again, bit for bit (copies and an in-place scatter, no arithmetic)."""
    _need_cuda()
    from ray_tpu_torch.llm import SamplingParams

    eng = _tier_engine(torch.bfloat16)
    try:
        prompt = _prompts_long()[3]
        sp = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
        eng.generate([prompt], sp)
        chain = _chain_blocks(eng, prompt)
        before = {h: _block_pages(eng, b) for h, b in chain}
        _evict_all(eng)
        assert all(not eng.allocator.contains_hash(h) for h, _ in chain)
        for h, (k, v) in before.items():
            tier, sb = eng.kvtier.get(h)
            assert tier == "host" and sb.handoff.k_pages.is_pinned()
            assert torch.equal(sb.handoff.k_pages, k) and torch.equal(sb.handoff.v_pages, v)
        eng.generate([prompt + [7, 8, 9]], sp)
        st = eng.stats()
        assert st["kv_tiers"]["resurrected_tokens"]["host"] == len(chain) * 4
        for h, b in _chain_blocks(eng, prompt):
            k, v = _block_pages(eng, b)
            assert torch.equal(k, before[h][0]) and torch.equal(v, before[h][1])
    finally:
        eng.close()


def test_kvtier_capture_while_spill_worker_drains_stays_valid(monkeypatch):
    """fp32: the spill worker's gather (copies on the copy stream and an
    event wait) is held until the engine thread is inside a mixed-step
    graph capture, and runs there. The capture succeeds, the spilled pages
    verify, and the engine's tokens (replays of that graph included) equal
    the CPU engine's."""
    _need_cuda()
    import threading

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.kvtier.tiers import KVTierManager
    from ray_tpu_torch.models.llama import LlamaConfig

    eng = _tier_engine(torch.float32)
    armed, capturing, gathered = threading.Event(), threading.Event(), threading.Event()
    errors = []
    real_gather = KVTierManager._gather

    def held_gather(self, entries):
        if threading.current_thread().name == "kvtier-spill" and not gathered.is_set():
            if not capturing.wait(timeout=60):
                errors.append("no capture began")
            try:
                return real_gather(self, entries)
            finally:
                gathered.set()
        return real_gather(self, entries)

    real_program = eng._mixed_program

    def program(bufs):
        if (armed.is_set() and torch.cuda.is_current_stream_capturing()
                and not capturing.is_set()):
            capturing.set()
            if not gathered.wait(timeout=20):
                import faulthandler
                import sys

                faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
                errors.append("the gather did not run during the capture")
        return real_program(bufs)

    monkeypatch.setattr(KVTierManager, "_gather", held_gather)
    eng._mixed_program = program
    try:
        prompts = _prompts_long()
        warm = list(range(3, 43))  # shares no block with the prompts
        sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
        first = eng.generate([warm], sp)
        # evictions: the captures queue, and the worker holds their gather
        # until the next capture begins
        armed.set()
        eng.allocator.free(eng.allocator.allocate(eng.allocator.num_free))
        got = eng.generate(prompts, sp)  # new packed buckets: captures
        assert not errors, errors
        assert capturing.is_set() and gathered.is_set()
        assert eng.kvtier.flush_spills(60.0)
        with eng.kvtier._lock:
            blocks = list(eng.kvtier._host.values())
        assert blocks and all(sb.handoff.verify() for sb in blocks)
        again = eng.generate(prompts, sp)  # replays of the graphs captured above
        cpu_params = {k: (v.cpu() if torch.is_tensor(v) else {n: t.cpu() for n, t in v.items()})
                      for k, v in eng.params.items()}
        cfg = EngineConfig(model=LlamaConfig(**GRAPH_MODEL, dtype=torch.float32), num_blocks=64,
                           block_size=4, max_num_seqs=4, max_prefill_len=64, mixed_batch=True,
                           mixed_prefill_chunk=16)
        cpu = LLMEngine(cfg, params=cpu_params, device="cpu")
        assert first == cpu.generate([warm], sp)
        want = cpu.generate(prompts, sp)
        assert got == want and again == want
        assert eng.stats()["mixed"]["graphs"]["replays"] > 0
    finally:
        eng.close()


def test_kvtier_pinned_slab_slots_reused_without_growth():
    """The host tier's pages live in one pinned slab allocated with the
    engine: rounds of spills reuse its slots (LRU eviction returns them),
    the slab does not grow, and nor does pinned memory by a block (the tier
    pins nothing per block)."""
    _need_cuda()
    from ray_tpu_torch.llm import SamplingParams

    eng = _tier_engine(torch.float32, host_bytes=8 * 2 * 2 * 2 * 4 * 64 * 4)
    try:
        slab = eng.kvtier._slab
        assert slab.n_slots == 8 and slab.buf.is_pinned()
        ptr = slab.buf.data_ptr()
        sp = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)
        pinned = []
        for rnd in range(3):
            rng = np.random.default_rng(100 + rnd)  # no prefix shared across rounds
            for n in (9, 41, 14, 60):
                eng.generate([rng.integers(3, 500, size=n).tolist()], sp)
            _evict_all(eng)
            torch.cuda.synchronize()
            st = eng.kvtier.stats()
            assert st["host"]["entries"] == 8 and st["slab"]["free"] == 0
            stats = getattr(torch.cuda, "host_memory_stats", dict)()
            pinned.append({k: v for k, v in stats.items()
                           if "allocated_bytes" in k and k.endswith("current")})
        st = eng.kvtier.stats()
        assert st["slab"]["taken"] > 3 * 8 and st["slab"]["reused"] > 0
        assert st["slab"]["misses"] == 0 and st["evicted_blocks"] > 0
        assert slab.buf.data_ptr() == ptr
        # no pinned allocation per block: in-use pinned bytes move by less
        # than one block's over two rounds of 8+ spilled blocks
        for key in pinned[0]:
            assert abs(pinned[2][key] - pinned[0][key]) < eng.kvtier.block_nbytes, pinned
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# weight publishing and the fleet (train/weight_sync.py, fleet/weights.py)
# ---------------------------------------------------------------------------


def _graph_params(dtype, seed):
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return init_params(LlamaConfig(**GRAPH_MODEL, dtype=dtype), gen, "cuda", dtype=dtype)


def _publish_once(params, eng, ns):
    from ray_tpu_torch.train.weight_sync import WeightPublisher, WeightSubscriber

    pub = WeightPublisher(namespace=ns)
    try:
        tgt = pub.register_rollout("e0", device=eng.kv_cache_device())
        sub = WeightSubscriber(pub.transport, "e0")
        pub.publish(params, [tgt])
        return sub, sub.apply_to_engine(eng)
    finally:
        pub.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_captured_before_publish_replays_new_weights(dtype):
    """A mixed-batching engine serves a first pass (its decode and mixed
    graphs captured), then takes a publish: the weights are written into
    the same tensors (every data_ptr unchanged), the second pass captures
    nothing for the buckets it reuses, replays them, and its greedy tokens
    equal a fresh engine's on the published weights."""
    _need_cuda()
    from ray_tpu_torch.llm.pipeline import ChunkController, PipelineStats
    from ray_tpu_torch.models.llama import sorted_leaves

    prompts = _prompts_long()
    new = _graph_params(dtype, 5)
    want = [t for t, _ in _serve_tokens(_packed_engine(dtype, params=new), prompts,
                                        [None] * 4)]
    eng = _packed_engine(dtype, params=_graph_params(dtype, 3))
    eng._pipe_ctl, eng._pipe_stats = ChunkController(initial=8, target_ratio=0.0), PipelineStats()
    before = [t for t, _ in _serve_tokens(eng, prompts, [None] * 4)]
    assert before != want
    fams = (eng._graphs, eng._mixed_graphs)
    keys0 = [set(f._graphs) for f in fams]
    replays0 = [dict(f.replays_by_key) for f in fams]
    ptrs = [t.data_ptr() for t in sorted_leaves(eng.params)]
    sub, applied = _publish_once(new, eng, "cuda-graph-publish")
    assert applied == 1 and eng.stats()["weight_version"] == 1
    assert [t.data_ptr() for t in sorted_leaves(eng.params)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(sorted_leaves(eng.params), sorted_leaves(new)))
    assert [t for t, _ in _serve_tokens(eng, prompts, [None] * 4)] == want
    reused = sum(f.replays_by_key[k] - r0.get(k, 0)
                 for f, keys, r0 in zip(fams, keys0, replays0) for k in keys)
    assert reused > 0


def test_fp32_publish_to_bf16_engine_is_cast_in_the_copy():
    """fp32 learner params published to a bf16 engine: the engine keeps its
    bf16 tensors (same addresses) and holds exactly src.to(bfloat16)."""
    _need_cuda()
    from ray_tpu_torch.autoscale import params_bitwise_equal
    from ray_tpu_torch.models.llama import sorted_leaves

    eng = _packed_engine(torch.bfloat16, params=_graph_params(torch.bfloat16, 3))
    src = _graph_params(torch.float32, 5)
    ptrs = [t.data_ptr() for t in sorted_leaves(eng.params)]
    assert _publish_once(src, eng, "cuda-cast")[1] == 1
    got = sorted_leaves(eng.params)
    assert [t.data_ptr() for t in got] == ptrs and all(t.dtype == torch.bfloat16 for t in got)
    assert all(torch.equal(a, b.to(torch.bfloat16)) for a, b in zip(got, sorted_leaves(src)))
    assert params_bitwise_equal(src, eng.params)


def test_same_device_send_aliases_and_a_mutated_alias_is_refused():
    """On one card the transport delivers the sender's own tensors (same
    data_ptr); a leaf written after the send makes the subscriber refuse
    the bundle, counted, with the engine's bytes unchanged."""
    _need_cuda()
    from ray_tpu_torch.fabric import DeviceTransport
    from ray_tpu_torch.models.llama import sorted_leaves
    from ray_tpu_torch.train.weight_sync import WeightPublisher, WeightSubscriber

    t = DeviceTransport(namespace="cuda-alias")
    try:
        tgt = t.register_endpoint("e0", device="cuda")
        a = torch.arange(16, dtype=torch.float32, device="cuda")
        t.send_arrays(tgt, {"a": a})
        assert t.recv_arrays("e0", timeout_s=1.0).arrays["a"].data_ptr() == a.data_ptr()
    finally:
        t.close()
    eng = _packed_engine(torch.float32, params=_graph_params(torch.float32, 3))
    before = [x.clone() for x in sorted_leaves(eng.params)]
    live = _graph_params(torch.float32, 5)
    pub = WeightPublisher(namespace="cuda-alias-pub")
    try:
        tgt = pub.register_rollout("e0", device=eng.kv_cache_device())
        sub = WeightSubscriber(pub.transport, "e0")
        pub.publish(live, [tgt])
        live["embed"].mul_(2.0)  # the learner writes after the send
        assert sub.apply_to_engine(eng) is None and sub.num_mutated_dropped == 1
        assert all(torch.equal(x, y) for x, y in zip(sorted_leaves(eng.params), before))
    finally:
        pub.close()


def test_learner_write_during_the_copy_on_card_raises():
    """A learner write queued on its own stream while the apply's copies are
    queued on the engine's: the subscriber waits for its copies, sees the
    write and raises, counted, reporting no new version; a snapshot then
    applies bit for bit at the same addresses."""
    _need_cuda()
    from ray_tpu_torch.autoscale import params_bitwise_equal
    from ray_tpu_torch.models.llama import sorted_leaves
    from ray_tpu_torch.train.weight_sync import (
        WeightPublisher,
        WeightSubscriber,
        WeightSyncError,
        snapshot,
    )

    eng = _packed_engine(torch.float32, params=_graph_params(torch.float32, 3))
    ptrs = [x.data_ptr() for x in sorted_leaves(eng.params)]
    live = _graph_params(torch.float32, 5)
    learner = torch.cuda.Stream()
    write = eng.write_params

    def write_racing_learner(leaves):
        write(leaves)
        with torch.cuda.stream(learner):
            live["embed"].mul_(2.0)

    pub = WeightPublisher(namespace="cuda-race-pub")
    try:
        tgt = pub.register_rollout("e0", device=eng.kv_cache_device())
        sub = WeightSubscriber(pub.transport, "e0")
        pub.publish(live, [tgt])
        eng.write_params = write_racing_learner
        with pytest.raises(WeightSyncError, match="while it was copied"):
            sub.apply_to_engine(eng)
        del eng.write_params
        learner.synchronize()
        assert sub.num_mutated_dropped == 1 and sub.version == 0 and eng.weight_version == 0
        snap = snapshot(live)
        pub.publish(snap, [tgt])
        assert sub.apply_to_engine(eng) == 2 and params_bitwise_equal(snap, eng.params)
        assert [x.data_ptr() for x in sorted_leaves(eng.params)] == ptrs
    finally:
        pub.close()


def test_fleet_replicas_own_storages_and_promote_is_bitwise():
    """bf16 fleet of two replicas on the card: the second replica's weights
    are a clone (no storage shared), a canary writes in place, and promote
    leaves both replicas bit for bit the candidate on distinct storages,
    serving identical greedy tokens."""
    _need_cuda()
    from ray_tpu_torch.fleet import (
        FleetManager,
        FleetSpec,
        ModelSpec,
        TenantSpec,
        bitwise_equal,
        shares_storage,
    )
    from ray_tpu_torch.llm import EngineConfig, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, sorted_leaves

    params = _graph_params(torch.bfloat16, 3)
    cfg = EngineConfig(model=LlamaConfig(**GRAPH_MODEL, dtype=torch.bfloat16), num_blocks=64,
                       block_size=4, max_num_seqs=4, max_prefill_len=64, mixed_batch=True,
                       mixed_prefill_chunk=16)
    spec = FleetSpec(models=(ModelSpec("m", replicas=2),),
                     tenants=(TenantSpec("gold", priority=2, weight=3.0),))
    mgr = FleetManager(spec, engine_config=cfg, params={"m": params}, seed=0)
    try:
        r0, r1 = mgr.replicas("m")
        assert not shares_storage(r0.engine.params, r1.engine.params)
        ptrs = [[t.data_ptr() for t in sorted_leaves(r.engine.params)] for r in (r0, r1)]
        new = {k: ({kk: vv * 1.01 for kk, vv in v.items()} if isinstance(v, dict) else v * 1.01)
               for k, v in params.items()}
        mgr.weights.begin_canary("m", params=new)
        assert bitwise_equal(r1.engine.params, new) and not bitwise_equal(r0.engine.params, new)
        assert mgr.weights.promote()["outcome"] == "promoted"
        assert all(bitwise_equal(r.engine.params, new) for r in (r0, r1))
        assert not shares_storage(r0.engine.params, r1.engine.params)
        assert [[t.data_ptr() for t in sorted_leaves(r.engine.params)] for r in (r0, r1)] == ptrs
        sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
        outs = {r.tag: r.runner.call(lambda e=r.engine: e.generate(_prompts4(), sp))
                for r in (r0, r1)}
        assert outs[r0.tag] == outs[r1.tag]
    finally:
        mgr.close()


class _IdText:
    """ByteTokenizer's encoding, and a decode that writes every id as
    "<id>" (random weights make ids past the byte range, which
    ByteTokenizer decodes to nothing)."""

    def __init__(self, vocab_size):
        from ray_tpu_torch.llm import ByteTokenizer

        self._bytes = ByteTokenizer(vocab_size)
        self.eos_token_id = self._bytes.eos_token_id

    def encode(self, text):
        return self._bytes.encode(text)

    def decode(self, ids):
        return "".join(f"<{i}>" for i in ids)


def _serve_400m():
    """LLAMA_400M bf16 weights on the card, an engine config for them, and
    a free loopback port."""
    import socket

    from ray_tpu_torch.llm import EngineConfig
    from ray_tpu_torch.models.llama import LLAMA_400M, init_params

    params = init_params(LLAMA_400M, torch.Generator(device="cuda").manual_seed(0), "cuda",
                         dtype=torch.bfloat16)
    cfg = EngineConfig(model=LLAMA_400M, num_blocks=256, block_size=16, max_num_seqs=4,
                       max_prefill_len=256, mixed_batch=True, mixed_prefill_chunk=64)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return params, cfg, port


def _post(url, body):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _replica_servers():
    from ray_tpu_torch.core import runtime as rt

    return [a.instance._callable for a in rt.get_runtime().gcs.list_actors()
            if type(a.instance).__name__ == "Replica" and a.instance._callable is not None]


def test_openai_app_on_card_serves_the_callers_weights():
    """LLAMA_400M bf16 deployed with build_openai_app and served over the
    stdlib HTTP proxy: the replica's engine holds the caller's tensors (no
    copy), and a greedy completion over HTTP has the tokens a direct
    LLMServer on the same weights gives the same request, each sent
    alone."""
    _need_cuda()
    import asyncio
    import dataclasses

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig, LLMServer, build_openai_app
    from ray_tpu_torch.models.llama import sorted_leaves

    params, cfg, port = _serve_400m()
    tok = _IdText(cfg.model.vocab_size)
    body = {"prompt": "the quick brown fox " * 8, "max_tokens": 24, "temperature": 0.0}
    ray_tpu_torch.init()
    try:
        serve.start(host="127.0.0.1", port=port)
        build_openai_app(LLMConfig(model_id="m", engine=cfg, params=params, tokenizer=tok),
                         route_prefix="/")
        (server,) = _replica_servers()
        assert [t.data_ptr() for t in sorted_leaves(server.engine.params)] == \
            [t.data_ptr() for t in sorted_leaves(params)]
        over_http = _post(f"http://127.0.0.1:{port}/v1/completions", body)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()

    class _Req:
        method, path = "POST", "/v1/completions"

        def json(self):
            return body

    direct = LLMServer(LLMConfig(model_id="m", engine=dataclasses.replace(cfg), params=params,
                                 tokenizer=tok))
    try:
        alone = asyncio.run(direct(_Req()))
    finally:
        direct.shutdown()
    assert over_http["usage"]["completion_tokens"] == 24
    assert over_http["choices"][0]["text"] == alone["choices"][0]["text"]


def test_serve_disagg_app_on_card_matches_colocated():
    """build_disagg_openai_app on the card (fp32, a small model of head_dim
    64, one prefill and one decode replica, KV over the device fabric): the
    completions' text equals the colocated LLMServer's on the card and on
    the CPU, every handoff went by the device plane, the pools are
    role-tagged, and shutdown stops both engine loops."""
    _need_cuda()
    import asyncio
    import dataclasses

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.serve import build_disagg_openai_app

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaConfig(**GRAPH_MODEL, dtype=torch.float32)
    params = init_params(model, torch.Generator().manual_seed(0), device="cpu")
    on_card = {k: (v.cuda() if torch.is_tensor(v) else {n: t.cuda() for n, t in v.items()})
               for k, v in params.items()}
    cfg = EngineConfig(model=model, num_blocks=64, block_size=4, max_num_seqs=4,
                       max_prefill_len=64)
    tok = _IdText(model.vocab_size)
    bodies = [{"prompt": p, "max_tokens": 12, "temperature": 0.0}
              for p in ("serve disagg on the card", "a second prompt, longer than the first",
                        "x" * 40)]

    class _Req:
        method, path = "POST", "/v1/completions"

        def __init__(self, body):
            self.body = body

        def json(self):
            return self.body

    colocated = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        srv = LLMServer(LLMConfig(model_id="m", engine=dataclasses.replace(cfg), params=p,
                                  tokenizer=tok, device=dev))
        try:
            colocated[dev] = [asyncio.run(srv(_Req(b)))["choices"][0]["text"] for b in bodies]
        finally:
            srv.shutdown()
    ray_tpu_torch.init()
    try:
        dcfg = dataclasses.replace(cfg, eos_token_id=tok.eos_token_id)
        handle = build_disagg_openai_app(
            LLMConfig(model_id="m", engine=dcfg, params=on_card, tokenizer=tok),
            connector="device", name="card-disagg", route_prefix=None)
        got = [handle.remote(_Req(b)).result(timeout_s=120)["choices"][0]["text"]
               for b in bodies]
        stats = handle.stats.remote().result(timeout_s=60)
        roles = {n: d.get("role") for a in serve.status()["applications"].values()
                 for n, d in a["deployments"].items()}
        reps = {type(r).__name__: r for r in _replica_servers()}
        loops = [reps["PrefillServer"]._loop.thread, reps["DecodeServer"]._loop.thread]
        conn = reps["PrefillServer"].connector.stats()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert got == colocated["cuda"] == colocated["cpu"]
    assert stats["reprefills"] == 0 and roles["Prefill:m"] == "prefill"
    assert roles["Decode:m"] == "decode"
    assert conn["connector"] == "device" and conn["num_sent"] == len(bodies)
    assert not any(t.is_alive() for t in loops)


def test_serve_shutdown_frees_the_kv_cache_on_card():
    """serve.shutdown() returns after the replica's shutdown hook: the
    engine loop has exited and the card's allocated memory fell by at least
    the KV cache's bytes (the weights stay: they are the caller's)."""
    _need_cuda()
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig, build_openai_app

    params, cfg, port = _serve_400m()
    ray_tpu_torch.init()
    try:
        serve.start(host="127.0.0.1", port=port)
        build_openai_app(LLMConfig(model_id="m", engine=cfg, params=params,
                                   tokenizer=_IdText(cfg.model.vocab_size)), route_prefix="/")
        out = _post(f"http://127.0.0.1:{port}/v1/completions",
                    {"prompt": "hello", "max_tokens": 8, "temperature": 0.0})
        assert out["usage"]["completion_tokens"] == 8
        (server,) = _replica_servers()
        thread, kv_bytes = server.runner._thread, server.engine._kv_cache_nbytes
        del server
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        serve.shutdown()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert not thread.is_alive()
    assert before - after >= kv_bytes > 0


def _feed_runtime():
    import ray_tpu_torch
    from ray_tpu_torch.core import runtime as rt

    if rt.is_initialized():
        rt.shutdown_runtime()
    ray_tpu_torch.init(num_cpus=4)


def test_device_feed_batches_equal_host_batches_bit_for_bit():
    """iter_device_batches on the card: int32, float32 and bf16 (a dtypes
    cast on the host) columns equal the host batches bit for bit, object
    columns stay lists, and every tensor lies on the card."""
    _need_cuda()
    import ray_tpu_torch
    from ray_tpu_torch import data

    rng = np.random.default_rng(0)
    cols = {"tok": rng.integers(0, 128256, (40, 1025), dtype=np.int32),
            "x": rng.standard_normal((40, 64)).astype(np.float32),
            "h": rng.standard_normal((40, 64)).astype(np.float32),
            "s": np.array([f"row {i}" for i in range(40)], dtype=object)}
    _feed_runtime()
    try:
        ds = data.from_numpy(cols)
        host = list(ds.iter_batches(batch_size=16))
        fed = list(ds.iter_device_batches(batch_size=16, dtypes={"h": torch.bfloat16}))
        torch.cuda.synchronize()
    finally:
        ray_tpu_torch.shutdown()
    assert [len(b["s"]) for b in fed] == [16, 16, 8]
    for h, f in zip(host, fed):
        for k, dt in (("tok", torch.int32), ("x", torch.float32), ("h", torch.bfloat16)):
            assert f[k].is_cuda and f[k].dtype == dt
            want = torch.from_numpy(h[k]).to(dt)
            assert torch.equal(f[k].cpu(), want)
        assert f["s"] == list(h["s"])


def test_device_feed_consumer_waits_for_a_held_back_copy(monkeypatch):
    """The feed's side stream is held back by a spin before each copy: a
    kernel on the consumer's stream still reads the batch's values, since
    that stream waits on the copy's event."""
    _need_cuda()
    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.data import iterator

    copy = iterator._CudaFeed._copy

    def held_back(self, host):
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the side stream
        return copy(self, host)

    monkeypatch.setattr(iterator._CudaFeed, "_copy", held_back)
    x = np.arange(6 * 4096, dtype=np.float32).reshape(6, 4096)
    _feed_runtime()
    try:
        sums = [(b["x"] * 2).sum(dim=1) for b in data.from_numpy({"x": x}).iter_device_batches(
            batch_size=2, prefetch=2)]
        torch.cuda.synchronize()
    finally:
        ray_tpu_torch.shutdown()
    got = torch.cat(sums).cpu().numpy()
    np.testing.assert_array_equal(got, (x * 2).sum(axis=1))


def test_build_processor_on_card_equals_direct_generate():
    """build_processor at LLAMA_400M bf16 over a port Dataset (the stage on
    an actor pool of one, its graphs captured on the actor's thread) gives
    each row the text of the same engine configuration's direct generate on
    the same 4-row batches; the pool's engine is freed after the stream."""
    _need_cuda()
    import dataclasses
    import gc

    import ray_tpu_torch
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import (EngineConfig, LLMEngine, ProcessorConfig, SamplingParams,
                                   build_processor)
    from ray_tpu_torch.llm.openai_api import ByteTokenizer
    from ray_tpu_torch.models.llama import LLAMA_400M, init_params

    params = init_params(LLAMA_400M, torch.Generator(device="cuda").manual_seed(0), "cuda",
                         dtype=torch.bfloat16)
    cfg = EngineConfig(model=LLAMA_400M, num_blocks=256, block_size=16, max_num_seqs=4,
                       max_prefill_len=256, mixed_batch=True, mixed_prefill_chunk=64)
    sp = SamplingParams(max_tokens=16, temperature=0.0)
    prompts = [f"prompt {i}: " + "the quick brown fox " * (1 + i % 5) for i in range(8)]
    pc = ProcessorConfig(engine=dataclasses.replace(cfg), params=params, sampling=sp,
                         batch_size=4)
    _feed_runtime()
    try:
        torch.cuda.synchronize()
        rows = build_processor(pc)(data.from_items(
            [{"prompt": p, "row": i} for i, p in enumerate(prompts)], parallelism=2)).take_all()
    finally:
        ray_tpu_torch.shutdown()
    gc.collect()
    tok = ByteTokenizer(cfg.model.vocab_size)
    eng = LLMEngine(dataclasses.replace(cfg, eos_token_id=tok.eos_token_id), params=params,
                    device="cuda")
    want = []
    for lo in range(0, 8, 4):
        for toks in eng.generate([tok.encode(p) for p in prompts[lo:lo + 4]], sp):
            want.append(tok.decode(toks[:-1] if toks and toks[-1] == tok.eos_token_id else toks))
    assert [r["row"] for r in rows] == list(range(8))
    assert [r["prompt"] for r in rows] == prompts
    assert [r["generated_text"] for r in rows] == want


def _process_runtime(num_gpus=1):
    import ray_tpu_torch
    from ray_tpu_torch.core import runtime as rt

    if rt.is_initialized():
        rt.shutdown_runtime()
    ray_tpu_torch.init(num_cpus=4, num_gpus=num_gpus, worker_mode="process")
    return ray_tpu_torch


def test_process_task_gets_a_cuda_argument_on_its_own_card():
    """A CUDA tensor argument crosses to a GPU task's worker by value and
    is rebuilt on the worker's card (CUDA_VISIBLE_DEVICES "0"); a CUDA
    result comes back on the parent's card, bit for bit."""
    _need_cuda()
    import os

    t = torch.randn(512, 384, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    t = t.to(torch.bfloat16)
    api = _process_runtime()
    try:
        @api.remote(num_gpus=1)
        def on_card(x):
            return (x.device.type, torch.cuda.current_device(),
                    os.environ["CUDA_VISIBLE_DEVICES"], x * 2)

        kind, idx, visible, doubled = api.get(on_card.remote(t), timeout=120)
    finally:
        api.shutdown()
    assert (kind, idx, visible) == ("cuda", 0, "0")
    assert doubled.is_cuda and torch.equal(doubled.view(torch.int16), (t * 2).view(torch.int16))


def test_cuda_tensor_to_a_worker_without_a_card_raises_type_error():
    _need_cuda()
    api = _process_runtime()
    try:
        @api.remote
        def no_card(x):
            return x

        with pytest.raises(api.TaskError) as ei:
            api.get(no_card.remote(torch.ones(4, device="cuda")), timeout=120)
    finally:
        api.shutdown()
    assert isinstance(ei.value.cause, TypeError) and "sees no card" in str(ei.value.cause)


def test_gpu_task_in_a_worker_equals_thread_mode():
    """The paged kernel on the same inputs in a pinned worker process and
    on a thread of this process: the same bits, and the kernel launched in
    the worker (its counter travels back with the output)."""
    _need_cuda()
    import ray_tpu_torch
    from ray_tpu_torch.core import runtime as rt

    def run(seed):
        q, k, v, bt, ctx, bs = _paged_case(seed, [7, 0, 13, 32, 1], D=128, dtype=torch.bfloat16)
        args = [a.cuda() for a in (q, k, v, bt, ctx)]
        before = tpa.paged_attention_cuda.launches
        out = tpa.paged_attention(*args, block_size=bs)
        return out.cpu(), tpa.paged_attention_cuda.launches - before

    outs = {}
    for mode in ("process", "thread"):
        if rt.is_initialized():
            rt.shutdown_runtime()
        ray_tpu_torch.init(num_cpus=2, num_gpus=1, worker_mode=mode)
        try:
            outs[mode] = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(run).remote(3),
                                           timeout=300)
        finally:
            ray_tpu_torch.shutdown()
    assert outs["process"][1] == outs["thread"][1] == 1
    assert torch.equal(outs["process"][0].view(torch.int16), outs["thread"][0].view(torch.int16))


def _gpu_cluster():
    """A port cluster of one node holding this machine's first card, and
    the driver attached to it. Functions of this file go by value: the
    cluster's workers cannot import it."""
    import sys

    import ray_tpu_torch
    from ray_tpu_torch.cluster import LocalCluster
    from ray_tpu_torch.core.serialization import register_pickle_by_value

    register_pickle_by_value(sys.modules[__name__])
    c = LocalCluster(node_death_timeout_s=5.0)
    try:
        c.start()
        c.add_node({"num_cpus": 2, "GPU": 1}, node_id="gpu")
        c.wait_for_nodes(1)
        ray_tpu_torch.init(address=c.address)
    except BaseException:
        c.shutdown()
        raise
    return ray_tpu_torch, c


def _stop_cluster(api, c):
    api.shutdown()
    c.shutdown()
    assert c.leftovers() == {"processes": [], "store_files": []}


def _probe_cards():
    import os

    import torch

    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "available": torch.cuda.is_available(), "count": torch.cuda.device_count(),
            "node": os.environ.get("RAY_TPU_NODE_ID"), "pid": os.getpid(),
            "initialized": torch.cuda.is_initialized()}


def test_cluster_gpu_task_sees_exactly_its_card():
    _need_cuda()
    import os

    api, c = _gpu_cluster()
    try:
        got = api.get(api.remote(num_gpus=1)(_probe_cards).remote(), timeout=300)
        res = api.cluster_resources()
    finally:
        _stop_cluster(api, c)
    assert got["node"] == "gpu" and got["available"] and got["count"] == 1
    assert got["visible"] == (os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0")
    assert res["GPU"] == 1.0


def test_cluster_cpu_lease_worker_has_no_cuda_context():
    _need_cuda()
    api, c = _gpu_cluster()
    try:
        cpu = api.get(api.remote(num_cpus=1)(_probe_cards).remote(), timeout=300)
        gpu = api.get(api.remote(num_gpus=1)(_probe_cards).remote(), timeout=300)
    finally:
        _stop_cluster(api, c)
    assert cpu["visible"] == "" and not cpu["available"] and cpu["count"] == 0
    assert not cpu["initialized"]
    assert gpu["pid"] != cpu["pid"]  # never the same worker


def test_cluster_cuda_tensor_returned_through_the_store_bit_for_bit():
    """A bf16 CUDA tensor made in a GPU worker crosses through the node's
    shared-memory store and is rebuilt on this process's card, bit for
    bit (its bit patterns cover every int16, NaNs included)."""
    _need_cuda()

    def make(n):
        import torch

        bits = (torch.arange(n, dtype=torch.int64, device="cuda") * 40503 % 65536) - 32768
        return bits.to(torch.int16).view(torch.bfloat16)

    n = 8 << 20  # 16 MiB
    api, c = _gpu_cluster()
    try:
        got = api.get(api.remote(num_gpus=1)(make).remote(n), timeout=300)
    finally:
        _stop_cluster(api, c)
    want = make(n)
    assert got.is_cuda and got.dtype == torch.bfloat16 and got.shape == (n,)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


class _CardHolder:
    """A GPU actor holding a CUDA tensor, and a tiny fp32 engine on the card
    whose SLO samples a reporter ships to both GCS endpoints."""

    def __init__(self, endpoints):
        import dataclasses

        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMEngine
        from ray_tpu_torch.models.llama import LLAMA_TINY
        from ray_tpu_torch.obs.telemetry import TelemetryReporter

        self.t = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
        # head_dim 64: a width the serving kernels take
        cfg = dataclasses.replace(LLAMA_TINY, dtype=torch.float32, d_model=256, n_heads=4,
                                  n_kv_heads=2)
        self.eng = LLMEngine(EngineConfig(model=cfg, num_blocks=64, block_size=4, max_num_seqs=4,
                                          max_prefill_len=32), device="cuda")
        self.eng.model_tag = "ha-card"
        self.reporter = TelemetryReporter(tuple(map(tuple, endpoints)), reporter_id="ha-card",
                                          kind="engine", interval_s=0.5).start()

    def serve(self, prompts):
        from ray_tpu_torch.llm import SamplingParams

        return self.eng.generate(prompts, SamplingParams(max_tokens=6, temperature=0.0,
                                                         ignore_eos=True))

    def checksum(self):
        return float(self.t.sum().item()), str(self.t.device)

    def flush(self):
        from ray_tpu_torch.obs import slo

        landed = any(self.reporter.push_once() for _ in range(10))
        b, _s, n = slo.ttft_histogram().hist_data()[("ha-card",)]
        return landed, list(b), n


def test_cluster_ha_gpu_actor_rides_a_failover_and_leases_through_the_new_primary():
    """A GPU actor of a cluster whose GCS has a standby keeps its card and
    its CUDA state across KILL_GCS_PRIMARY: its greedy tokens do not change,
    the promoted GCS merges its TTFT histogram bucket for bucket, its lease
    is released there when it is killed, and a GPU task then leases its
    card through the new primary."""
    _need_cuda()
    import sys
    import time

    import ray_tpu_torch
    from ray_tpu_torch.cluster import LocalCluster
    from ray_tpu_torch.core.api import _cluster
    from ray_tpu_torch.core.serialization import register_pickle_by_value

    register_pickle_by_value(sys.modules[__name__])
    c = LocalCluster(node_death_timeout_s=5.0, standby=True)
    try:
        c.start()
        c.add_node({"num_cpus": 2, "GPU": 1}, node_id="gpu")
        c.wait_for_nodes(1)
        ray_tpu_torch.init(address=c.address)
        gcs = _cluster().client.gcs
        prompts = [[5, 6, 7, 8], [9, 10, 11]]
        holder = ray_tpu_torch.remote(num_gpus=1)(_CardHolder).remote(c.gcs_endpoints)
        before = ray_tpu_torch.get(holder.serve.remote(prompts), timeout=300)
        csum = ray_tpu_torch.get(holder.checksum.remote(), timeout=60)
        c.kill_gcs_primary()
        deadline = time.monotonic() + 20
        st = {}
        while st.get("term") != 1:
            assert time.monotonic() < deadline, st
            try:
                st = gcs.call("ha_status", {}, timeout=5)
            except Exception:  # noqa: BLE001 — the failover window
                time.sleep(0.1)
        after = ray_tpu_torch.get(holder.serve.remote(prompts), timeout=120)
        assert after == before
        assert ray_tpu_torch.get(holder.checksum.remote(), timeout=60) == csum
        landed, buckets, n = ray_tpu_torch.get(holder.flush.remote(), timeout=60)
        merged = gcs.call("telemetry_cluster", {}, timeout=15)["histograms"][
            "ray_tpu_llm_ttft_seconds"]["series"]["model=ha-card"]
        assert landed and merged["buckets"] == buckets and merged["count"] == n == 4
        ray_tpu_torch.kill(holder)
        deadline = time.monotonic() + 20
        while True:
            row = next(x for x in gcs.call("list_nodes", None, timeout=15) if x["node_id"] == "gpu")
            if row["available"].get("GPU") == 1 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert row["available"].get("GPU") == 1, row
        got = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(_probe_cards).remote(),
                                timeout=300)
        assert got["node"] == "gpu" and got["available"] and got["count"] == 1
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    assert c.leftovers() == {"processes": [], "store_files": []}
