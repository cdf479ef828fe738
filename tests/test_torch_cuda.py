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
