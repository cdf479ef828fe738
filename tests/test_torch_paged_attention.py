"""ray_tpu_torch.ops.paged_attention held against ray_tpu.ops.paged_attention.

The plain PyTorch version (the CPU path, and what the CUDA kernel is held
against on the card) must match ``paged_attention_xla`` on rows with a
context and the Pallas kernel (interpret mode) on every row, including a
ctx = 0 pad row, where the Pallas kernel writes 0 and the XLA version
gives NaN. fp32 band 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, ctx_lens, B=3, H=8, KVH=2, D=16, bs=4, MB=5):
    """The tests/test_llm.py paged case: random q / caches, distinct pages."""
    rng = np.random.default_rng(seed)
    num_slots = 64 * bs
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(KVH, num_slots, D)).astype(np.float32)
    v = rng.normal(size=(KVH, num_slots, D)).astype(np.float32)
    bt = rng.choice(64, size=(B, MB), replace=False).astype(np.int32)
    ctx = np.asarray(ctx_lens, np.int32)
    return q, k, v, bt, ctx, bs


def _torch_args(q, k, v, bt, ctx):
    return (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(bt), torch.from_numpy(ctx))


def _jax(impl, q, k, v, bt, ctx, bs):
    return np.asarray(jpa.paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, bt, ctx)), block_size=bs, impl=impl
    ))


@pytest.mark.parametrize("ctx_lens", [[7, 20, 13], [7, 0, 13]], ids=["full", "pad_row"])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_plain_matches_reference(ctx_lens, impl):
    q, k, v, bt, ctx, bs = _case(0, ctx_lens)
    got = tpa.paged_attention_torch(*_torch_args(q, k, v, bt, ctx), block_size=bs).numpy()
    ref = _jax(impl, q, k, v, bt, ctx, bs)
    rows = ctx > 0 if impl == "xla" else np.ones(len(ctx), bool)  # xla: NaN at ctx 0
    np.testing.assert_allclose(got[rows], ref[rows], **TOL)
    assert np.all(got[ctx == 0] == 0.0)


def test_plain_short_table_and_partial_page():
    """Contexts that end mid-page and a table narrower than the cache."""
    q, k, v, bt, ctx, bs = _case(3, [1, 17, 5, 20], B=4, H=4, KVH=4, D=8, MB=5)
    got = tpa.paged_attention_torch(*_torch_args(q, k, v, bt, ctx), block_size=bs).numpy()
    np.testing.assert_allclose(got, _jax("pallas_interpret", q, k, v, bt, ctx, bs), **TOL)


def test_dispatch_on_cpu_takes_plain_version():
    q, k, v, bt, ctx, bs = _case(1, [7, 20, 13])
    args = _torch_args(q, k, v, bt, ctx)
    auto = tpa.paged_attention(*args, block_size=bs)
    plain = tpa.paged_attention_torch(*args, block_size=bs)
    assert torch.equal(auto, plain)
    assert torch.equal(tpa.paged_attention(*args, block_size=bs, impl="torch"), plain)


def test_cuda_impl_refuses_cpu_tensors():
    q, k, v, bt, ctx, bs = _case(1, [7, 20, 13])
    before = tpa.paged_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(*_torch_args(q, k, v, bt, ctx), block_size=bs, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        tpa.paged_attention(*_torch_args(q, k, v, bt, ctx), block_size=bs, impl="xla")
    assert tpa.paged_attention_cuda.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_attention")


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: pretend compile failure' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="pretend compile failure"):
        _build.load("paged_attention")
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_tracks_sources():
    a = _build._library_path("paged_attention")
    b = _build._library_path("ragged_attention")
    assert a != b and a.parent == _build.BUILD_DIR
    assert a == _build._library_path("paged_attention")


# -- the split-KV kernel's host logic (runs before any launch) --------------


@pytest.mark.parametrize("B,KVH,max_kv,sms,want", [
    (16, 8, 2048, 132, 2),    # the kernels-phase shape: ceil(132 / 128)
    (1, 8, 2048, 132, 8),     # one long sequence: capped at 2048 / 256 positions' worth
    (12, 8, 2048, 132, 2),    # the engine's decode rows at full table width
    (40, 4, 512, 132, 1),     # B x KVH above the SM count: no split
    (4, 8, 64, 132, 1),       # a narrow table is never split
    (1, 1, 1 << 20, 132, tpa.MAX_SPLITS),
    (0, 8, 2048, 132, 1),
])
def test_num_splits_rule(B, KVH, max_kv, sms, want):
    assert tpa.num_splits(B, KVH, max_kv, sms) == want


def test_split_plan_is_fixed_by_shapes_alone():
    """The wrapper's plan takes shapes only: the same (batch, table width)
    bucket always gives the same grid and workspace, whatever the contexts."""
    assert tpa.split_plan(16, 32, 8, 128, 2048, 132) == (2, (16, 32, 2, 130))
    assert tpa.split_plan(2, 8, 2, 64, 1024, 132) == (4, (2, 8, 4, 66))
    assert tpa.split_plan(200, 32, 8, 128, 2048, 132) == (1, None)  # the kernel writes the output
    for sms in (66, 132, 264):
        s, shape = tpa.split_plan(8, 16, 4, 64, 4096, sms)
        assert 1 <= s <= tpa.MAX_SPLITS and (shape is None) == (s == 1)
        assert 8 * 4 * s < sms + 8 * 4  # no more than one wave of CTAs


def _cuda_args(**over):
    q, k, v, bt, ctx, bs = _case(1, [7, 20, 13], D=64)
    args = dict(zip(("q", "k_cache", "v_cache", "block_tables", "context_lens"),
                    _torch_args(q, k, v, bt, ctx)))
    args.update(over)
    return args, bs


@pytest.mark.parametrize("change,exc,match", [
    (lambda a: {"q": a["q"].half()}, TypeError, "dtype"),
    (lambda a: {"k_cache": a["k_cache"].double()}, TypeError, "cache dtypes"),
    (lambda a: {"q": a["q"][..., :32].contiguous(), "k_cache": a["k_cache"][..., :32].contiguous(),
                "v_cache": a["v_cache"][..., :32].contiguous()}, ValueError, "head_dim"),
    (lambda a: {"v_cache": a["v_cache"][:, :128].contiguous()}, ValueError, "caches must be"),
    (lambda a: {"q": a["q"][:, :5].contiguous()}, ValueError, "not a multiple"),
    (lambda a: {"q": a["q"].transpose(0, 1).contiguous().transpose(0, 1)}, ValueError, "contiguous"),
    (lambda a: {"block_tables": a["block_tables"].long()}, TypeError, "int32"),
    (lambda a: {"context_lens": a["context_lens"][:2]}, ValueError, "batch"),
    (lambda a: {}, ValueError, "needs CUDA tensors"),
], ids=["q_dtype", "cache_dtype", "head_dim", "cache_shape", "group", "contiguous", "int32",
        "batch", "device"])
def test_kernel_wrapper_raises_before_launch(change, exc, match):
    """Each check of the kernel wrapper raises before anything is built or
    launched; on CPU tensors the device check comes last."""
    args, bs = _cuda_args()
    args.update(change(args))
    before = tpa.paged_attention_cuda.launches
    with pytest.raises(exc, match=match):
        tpa.paged_attention_cuda(**args, block_size=bs)
    assert tpa.paged_attention_cuda.launches == before


def test_kernel_wrapper_refuses_bad_block_size():
    args, _ = _cuda_args()
    with pytest.raises(ValueError, match="block_size"):
        tpa.paged_attention_cuda(**args, block_size=3)
