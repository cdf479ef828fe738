"""ray_tpu_torch.ops.flash held against ray_tpu.ops.flash on the CPU.

On CPU tensors the port's ``flash_attention`` runs its plain versions
(``flash_attention_fwd_torch``, and ``flash_attention_bwd_torch`` in the
backward); the reference runs its Pallas kernels in interpret mode (the
default off a TPU) and its XLA composite. Same numpy inputs through both;
the bands are the reference's own (tests/test_flash.py:39,46,88): fp32
forward 2e-5, gradients 5e-4, bf16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash as jflash
from ray_tpu.ops.attention import xla_attention
from ray_tpu_torch.ops import flash as tflash
from ray_tpu_torch.ops.attention import attention, attention_torch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=5e-4)


def _qkv(seed, B, Sq, Sk, H, KVH, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# the cases of tests/test_flash.py
CASES = {
    "mha": (2, 64, 4, 4, 32, True),
    "gqa": (2, 64, 4, 2, 32, True),
    "gqa_deep": (1, 128, 8, 2, 64, True),
    "bidirectional": (2, 64, 4, 2, 32, False),
    "pad_100": (1, 100, 4, 2, 32, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas_and_xla(case):
    B, S, H, KVH, D, causal = CASES[case]
    q, k, v = _qkv(0, B, S, S, H, KVH, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas_o, pallas_lse = jflash.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                                  block_k=64, return_lse=True)
    xla = xla_attention(jq, jk, jv, causal=causal)
    o, lse = tflash.flash_attention(*_t(q, k, v), causal=causal, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas_o), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(pallas_lse), **FWD)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla), **FWD)


def test_segments_match_pallas_and_xla():
    B, S, H, KVH, D = 2, 64, 4, 2, 32
    q, k, v = _qkv(2, B, S, S, H, KVH, D)
    seg = np.concatenate([np.zeros((B, S // 2), np.int32), np.ones((B, S - S // 2), np.int32)], 1)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    pallas = jflash.flash_attention(*jargs, causal=True, segment_ids=jnp.asarray(seg),
                                    block_q=32, block_k=32)
    xla = xla_attention(*jargs, causal=True, segment_ids=jnp.asarray(seg))
    o = tflash.flash_attention(*_t(q, k, v), causal=True, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), **FWD)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla), **FWD)


def test_q_offset_window_matches_pallas_and_xla():
    """Short q attending into a longer kv prefix (chunked-prefill shape)."""
    q, k, v = _qkv(3, 1, 16, 64, 4, 2, 32)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    pallas = jflash.flash_attention(*jargs, causal=True, q_offset=48, block_q=16, block_k=16)
    xla = xla_attention(*jargs, causal=True, q_offset=48)
    o = tflash.flash_attention(*_t(q, k, v), causal=True, q_offset=48)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), **FWD)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla), **FWD)


def test_fully_masked_rows_follow_pallas():
    """q rows 0..7 in segment 7, every kv position in segment 0, not causal:
    the Pallas forward gives each such row p = exp(NEG_INF - NEG_INF) = 1
    at every kv position, i.e. the mean of V, with lse ~ NEG_INF; the port
    follows it (ROADMAP Queue 3). xla_attention has no kv-side segments."""
    B, S, H, KVH, D = 1, 32, 2, 1, 16
    q, k, v = _qkv(0, B, S, S, H, KVH, D)
    qseg = np.concatenate([np.full((B, 8), 7, np.int32), np.zeros((B, S - 8), np.int32)], 1)
    kseg = np.zeros((B, S), np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    p_o, p_lse = jflash.flash_attention(*jargs, causal=False, segment_ids=jnp.asarray(qseg),
                                        kv_segment_ids=jnp.asarray(kseg), block_q=16,
                                        block_k=16, return_lse=True)
    o, lse = tflash.flash_attention(*_t(q, k, v), causal=False,
                                    segment_ids=torch.from_numpy(qseg),
                                    kv_segment_ids=torch.from_numpy(kseg), return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(p_o), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(p_lse), rtol=2e-5, atol=2e-5)
    mean_v = v[0].mean(axis=0)[0]  # [D]: the one kv head
    np.testing.assert_allclose(o.numpy()[0, :8, 0], np.broadcast_to(mean_v, (8, D)), **FWD)
    assert np.all(lse.numpy()[0, :8] < -1e29)


def test_bf16_forward_matches_pallas():
    q, k, v = _qkv(1, 2, 128, 128, 4, 2, 64)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    pallas = jflash.flash_attention(*jargs, causal=True).astype(jnp.float32)
    o = tflash.flash_attention(*(t.to(torch.bfloat16) for t in _t(q, k, v)), causal=True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(pallas), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("segments", [False, True])
def test_backward_matches_jax_grad_of_pallas_with_lse_cotangent(segments):
    """jax.grad of the Pallas path (o and lse both in the loss, so the lse
    cotangent dlse is nonzero) against the port's explicit flash-2 backward,
    with right padding (S 100) and, optionally, two segments."""
    B, S, H, KVH, D = 1, 100, 4, 2, 32
    q, k, v = _qkv(5, B, S, S, H, KVH, D)
    w = np.random.default_rng(6).normal(size=(B, S, H)).astype(np.float32)
    seg = (np.arange(S)[None, :] >= 40).astype(np.int32) if segments else None

    def jloss(q, k, v):
        o, lse = jflash.flash_attention(q, k, v, causal=True, block_q=32, block_k=32,
                                        segment_ids=None if seg is None else jnp.asarray(seg),
                                        return_lse=True)
        return jnp.sum(o ** 2) + jnp.sum(lse * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    o, lse = tflash.flash_attention(tq, tk, tv, causal=True, return_lse=True,
                                    segment_ids=None if seg is None else torch.from_numpy(seg))
    ((o ** 2).sum() + (lse * torch.from_numpy(w)).sum()).backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD, err_msg=f"d{name}")


def test_backward_matches_xla_grads():
    """The plain backward against autograd of the composite, GQA 2."""
    q, k, v = _qkv(4, 2, 64, 64, 4, 2, 32)
    grads = []
    for fn in (tflash.flash_attention, attention_torch):
        args = [t.requires_grad_(True) for t in _t(q, k, v)]
        (fn(*args, causal=True) ** 2).sum().backward()
        grads.append([a.grad.numpy() for a in args])
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got, ref, **GRAD)


def test_plain_backward_formulas_take_dlse():
    """flash_attention_bwd_torch directly: dlse = 0 equals None, and a
    nonzero dlse changes only through delta (ds = p * (dp - delta + dlse))."""
    q, k, v = _t(*_qkv(7, 1, 48, 48, 4, 2, 16))
    o, lse = tflash.flash_attention_fwd_torch(q, k, v, causal=True)
    do = torch.from_numpy(np.random.default_rng(8).normal(size=o.shape).astype(np.float32))
    base = tflash.flash_attention_bwd_torch(q, k, v, o, lse, do, None, causal=True)
    zero = tflash.flash_attention_bwd_torch(q, k, v, o, lse, do, torch.zeros_like(lse), causal=True)
    for a, b in zip(base, zero):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dlse = torch.ones_like(lse)
    shifted = tflash.flash_attention_bwd_torch(q, k, v, o, lse, do, dlse, causal=True)
    torch.testing.assert_close(shifted[2], base[2], rtol=0, atol=0)  # dv does not see delta
    assert not torch.allclose(shifted[0], base[0])


@pytest.mark.parametrize("dtype,H,KVH,D,match", [
    (torch.bfloat16, 96, 1, 64, None),        # bf16 (tensor cores): any whole group
    (torch.bfloat16, 24, 8, 128, None),
    (torch.float32, 96, 1, 64, "divide 64"),  # fp32 folds the group into a 64-row tile
    (torch.bfloat16, 6, 4, 64, "whole"),
    (torch.bfloat16, 4, 2, 96, "head_dim"),
    (torch.float16, 4, 2, 64, "dtype"),
])
def test_kernel_shape_checks_per_dtype_raise_before_launch(dtype, H, KVH, D, match):
    """The wrappers' checks of what each dtype's kernels take run before
    the device check, so they hold here; shapes the kernels take reach the
    device check (CPU tensors) and nothing launches."""
    q = torch.zeros(1, 8, H, D, dtype=dtype)
    k = v = torch.zeros(1, 8, KVH, D, dtype=dtype)
    lse = torch.zeros(1, H, 8)
    f0, b0 = tflash.flash_fwd_cuda.launches, tflash.flash_bwd_cuda.launches
    calls = (lambda: tflash.flash_fwd_cuda(q, k, v),
             lambda: tflash.flash_bwd_cuda(q, k, v, q, lse, q))
    for call in calls:
        if match is None:
            with pytest.raises(ValueError, match="CUDA tensors"):
                call()
        else:
            with pytest.raises((ValueError, TypeError), match=match):
                call()
    assert (tflash.flash_fwd_cuda.launches, tflash.flash_bwd_cuda.launches) == (f0, b0)
    if match is None:
        tflash.check_kernel_shape("x", dtype, H, KVH, D)


def test_dispatch_and_checks():
    q, k, v = _t(*_qkv(9, 1, 16, 16, 4, 2, 64))
    before = tflash.flash_fwd_cuda.launches
    tflash.flash_attention(q, k, v)  # CPU tensors: the plain version
    assert tflash.flash_fwd_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="not divisible"):
        tflash.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 64), v[:, :, :1].expand(1, 16, 3, 64))
    with pytest.raises(ValueError, match="static int"):
        tflash.flash_attention(q, k, v, q_offset=torch.tensor(3))
    with pytest.raises(ValueError, match="Sq == Sk"):
        tflash.flash_attention(q[:, :8], k, v, segment_ids=torch.zeros(1, 8, dtype=torch.int32))
    assert torch.equal(attention(q, k, v, impl="xla"), attention_torch(q, k, v))
    with pytest.raises(NotImplementedError):
        attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="unknown"):
        attention(q, k, v, impl="nope")
