"""ray_tpu_torch's CUDA kernels on the card, against their plain PyTorch
twins (the twins are held against the JAX package by the CPU tests).

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G", [(64, 4), (128, 4), (128, 16), (64, 1)])
def test_paged_kernel_matches_plain(D, G, dtype):
    _need_cuda()
    q, k, v, bt, ctx, bs = _paged_case(0, [7, 0, 13, 32, 1], H=2 * G, KVH=2, D=D, dtype=dtype)
    ref = tpa.paged_attention_torch(q, k, v, bt, ctx, block_size=bs)
    got = tpa.paged_attention(*(t.cuda() for t in (q, k, v, bt, ctx)), block_size=bs).cpu()
    torch.cuda.synchronize()
    assert float((got.float() - ref.float()).abs().max()) <= BANDS[dtype]
    assert torch.all(got[1] == 0)  # ctx = 0 pad row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_matches_plain(dtype):
    _need_cuda()
    rng = np.random.default_rng(1)
    q_lens, ctx_lens, T_pad = [5, 1, 0, 40, 3, 0], [5, 20, 0, 52, 9, 0], 64
    _, k, v, bt, ctx, bs = _paged_case(1, ctx_lens, H=8, KVH=2, D=128, MB=16, dtype=dtype)
    q = torch.from_numpy(rng.normal(size=(T_pad, 8, 128)).astype(np.float32)).to(dtype)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32)
    ref = trg.ragged_attention_torch(q, k, v, bt, cu, ctx, block_size=bs)
    # max_q_len below the real 40 rows: the kernel strides over the rest
    for max_q_len in (40, 8):
        got = trg.ragged_attention(*(t.cuda() for t in (q, k, v, bt, cu, ctx)),
                                   block_size=bs, max_q_len=max_q_len).cpu()
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
        for dev, p in (("cuda", on_card), ("cpu", params)):
            cfg = EngineConfig(model=model, num_blocks=64, block_size=16, max_num_seqs=4,
                               max_prefill_len=128, mixed_batch=mixed, mixed_prefill_chunk=16)
            outs.append(LLMEngine(cfg, params=p, device=dev).generate(prompts, sp))
        assert outs[0] == outs[1], mixed


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
])
def test_flash_kernels_match_plain(D, H, KVH, S, causal, q_offset, segments, dtype):
    _need_cuda()
    Sk = S + q_offset
    q, k, v, do, dlse = _flash_case(1, 2, S, Sk, H, KVH, D, dtype)
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


def test_flash_kernel_fully_masked_rows_follow_pallas():
    """q rows in a segment the kv side lacks: the mean of V over the row's
    window and lse ~ NEG_INF, zero gradient (ROADMAP Queue 3)."""
    _need_cuda()
    q, k, v, do, dlse = _flash_case(2, 1, 64, 64, 4, 2, 64, torch.float32)
    qseg = torch.cat([torch.full((1, 8), 7), torch.zeros(1, 56)], 1).int()
    kseg = torch.zeros(1, 64, dtype=torch.int32)
    ref_o, ref_lse = tfl.flash_attention_fwd_torch(q, k, v, qseg, kseg, causal=False)
    o, lse = tfl.flash_fwd_cuda(*(t.cuda() for t in (q, k, v, qseg, kseg)), causal=False)
    _close(o, ref_o, 2e-5)
    _close(lse, ref_lse, 2e-5)
    torch.testing.assert_close(o[0, :8, 0].cpu(), v[0, :, 0].mean(0).expand(8, 64))
    g = tfl.flash_bwd_cuda(*(t.cuda() for t in (q, k, v, ref_o, ref_lse, do, dlse, qseg, kseg)),
                           causal=False)
    assert float(g[0][0, :8].abs().max()) == 0.0


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
