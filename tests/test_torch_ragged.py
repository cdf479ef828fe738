"""ray_tpu_torch.ops.ragged held against ray_tpu.ops.ragged.

The plain PyTorch version must match ``ragged_attention_xla`` on the
packed rows that belong to a sequence, and the Pallas kernel
(interpret mode) on every row: q_len = 0 pad sequences write nothing and
packed rows past cu_q_lens[B] are 0. The decode-only case (all q_len 1)
is the paged decode attention. fp32 band 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import ragged as jrg
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops import ragged as trg

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, q_lens, ctx_lens, T_pad=None, bs=4, MB=8, H=8, KVH=2, D=16):
    """The tests/test_llm_mixed.py ragged case, with optional trailing
    pad rows (T_pad > sum(q_lens))."""
    rng = np.random.default_rng(seed)
    B = len(q_lens)
    T = T_pad or sum(q_lens)
    num_slots = 64 * bs
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    k = rng.normal(size=(KVH, num_slots, D)).astype(np.float32)
    v = rng.normal(size=(KVH, num_slots, D)).astype(np.float32)
    bt = rng.choice(64, size=(B, MB), replace=False).astype(np.int32)
    cu = np.zeros(B + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    return q, k, v, bt, cu, np.asarray(ctx_lens, np.int32), bs


def _torch(q, k, v, bt, cu, ctx, bs):
    return trg.ragged_attention_torch(
        *(torch.from_numpy(a) for a in (q, k, v, bt, cu, ctx)), block_size=bs
    ).numpy()


def _jax(impl, q, k, v, bt, cu, ctx, bs, max_q_len=8):
    return np.asarray(jrg.ragged_attention(
        *(jnp.asarray(a) for a in (q, k, v, bt, cu, ctx)),
        block_size=bs, max_q_len=max_q_len, impl=impl,
    ))


CASES = {
    # prefill chunk, decode rows, a chunk ending mid-prompt history
    "mixed": ([5, 1, 1, 3], [5, 20, 13, 9], None),
    "packed": ([6, 1, 4, 1, 1], [6, 17, 11, 9, 25], None),
    # a q_len = 0 pad sequence in the middle and at the end, trailing pad rows
    "pad_seqs_and_rows": ([5, 1, 0, 3, 0], [5, 20, 0, 9, 0], 16),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_plain_matches_reference(name, impl):
    q_lens, ctx_lens, T_pad = CASES[name]
    args = _case(0, q_lens, ctx_lens, T_pad)
    got = _torch(*args)
    ref = _jax(impl, *args)
    T = sum(q_lens)
    rows = slice(0, T) if impl == "xla" else slice(None)  # xla: pad rows unspecified
    np.testing.assert_allclose(got[rows], ref[rows], **TOL)
    assert np.all(got[T:] == 0.0)


def test_decode_only_is_paged_attention():
    """All q_len = 1: ragged == the port's paged decode attention, and ==
    the reference's paged attention."""
    q, k, v, bt, cu, ctx, bs = _case(1, [1, 1, 1], [7, 20, 13])
    got = _torch(q, k, v, bt, cu, ctx, bs)
    paged = tpa.paged_attention_torch(
        *(torch.from_numpy(a) for a in (q, k, v, bt, ctx)), block_size=bs
    ).numpy()
    np.testing.assert_allclose(got, paged, **TOL)
    from ray_tpu.ops.paged_attention import paged_attention as jpaged

    ref = np.asarray(jpaged(*(jnp.asarray(a) for a in (q, k, v, bt, ctx)),
                            block_size=bs, impl="xla"))
    np.testing.assert_allclose(got, ref, **TOL)


def test_dispatch_on_cpu_and_refusals():
    args = [torch.from_numpy(a) for a in _case(2, [2, 1], [4, 9])[:6]]
    auto = trg.ragged_attention(*args, block_size=4, max_q_len=2)
    assert torch.equal(auto, trg.ragged_attention_torch(*args, block_size=4))
    with pytest.raises(ValueError, match="CUDA"):
        trg.ragged_attention(*args, block_size=4, max_q_len=2, impl="cuda")
    with pytest.raises(ValueError, match="max_q_len"):
        trg.ragged_attention(*args, block_size=4, max_q_len=0)


def _kernel_args(**over):
    q, k, v, bt, cu, ctx, bs = _case(2, [3, 1, 0], [9, 4, 0], T_pad=8, D=64)
    args = dict(zip(("q", "k_cache", "v_cache", "block_tables", "cu_q_lens", "context_lens"),
                    (torch.from_numpy(a) for a in (q, k, v, bt, cu, ctx))))
    args.update(over)
    return args, bs


@pytest.mark.parametrize("change,max_q_len,exc,match", [
    (lambda a: {"cu_q_lens": a["cu_q_lens"][:-1]}, 3, ValueError, "disagree on B"),
    (lambda a: {"block_tables": a["block_tables"][:2]}, 3, ValueError, "disagree on B"),
    (lambda a: {}, 0, ValueError, "max_q_len"),
    (lambda a: {"q": a["q"].half()}, 3, TypeError, "dtype"),
    (lambda a: {"cu_q_lens": a["cu_q_lens"].long()}, 3, TypeError, "int32"),
    (lambda a: {"q": a["q"][..., :32].contiguous(), "k_cache": a["k_cache"][..., :32].contiguous(),
                "v_cache": a["v_cache"][..., :32].contiguous()}, 3, ValueError, "head_dim"),
    (lambda a: {}, 3, ValueError, "needs CUDA tensors"),
], ids=["cu_len", "bt_rows", "max_q_len", "q_dtype", "int32", "head_dim", "device"])
def test_kernel_wrapper_raises_before_launch(change, max_q_len, exc, match):
    """Each check of the kernel wrapper raises before anything is built or
    launched; on CPU tensors the device check comes last."""
    args, bs = _kernel_args()
    args.update(change(args))
    before = trg.ragged_attention_cuda.launches
    with pytest.raises(exc, match=match):
        trg.ragged_attention_cuda(**args, block_size=bs, max_q_len=max_q_len)
    assert trg.ragged_attention_cuda.launches == before


def test_decode_rows_share_the_paged_split_plan():
    """The ragged wrapper plans its decode rows with the paged wrapper's
    rule on the same shapes, so decode-only batches launch the same grid."""
    B, H, KVH, D, MB, bs = 12, 32, 8, 128, 128, 16
    splits, shape = tpa.split_plan(B, H, KVH, D, MB * bs, 132)
    assert splits == tpa.num_splits(B, KVH, MB * bs, 132) == 2
    assert shape == (B, H, 2, D + 2)
    assert trg.decode_workspace is tpa.decode_workspace
