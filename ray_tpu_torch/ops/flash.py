"""Flash attention for training (counterpart of ``ray_tpu/ops/flash.py``).

 * ``flash_attention_fwd_torch`` / ``flash_attention_bwd_torch`` — the
   plain PyTorch versions of the forward (o and the per-row log-sum-exp)
   and of the backward (dq, dk, dv from the stored lse with the explicit
   flash-2 formulas, the lse cotangent ``dlse`` included). The CPU path,
   and what the kernels are held against.
 * ``flash_fwd_cuda`` / ``flash_bwd_cuda`` — launch the hand-written
   Hopper kernels ``csrc/flash_fwd.cu`` (replacing the Pallas
   ``_fwd_kernel``) and ``csrc/flash_bwd.cu`` (replacing
   ``_bwd_fused_kernel``, ``_dq_kernel`` and ``_dkv_kernel``): bf16 runs
   on the tensor cores (wgmma, ``csrc/flash_sm90.cuh``), fp32 on the CUDA
   cores. ``check_kernel_shape`` says what each dtype's kernels take.
 * ``flash_attention`` — the public function, with the reference's
   checks and signature (less the TPU block and fold knobs). Its gradient
   is a ``torch.autograd.Function``; both of its passes take the plain
   version for CPU tensors and the kernel for CUDA tensors, and a kernel
   that cannot build or launch raises.

As in the reference, the softmax scale is folded into q (an fp32 multiply
cast back to q's dtype) outside the differentiated function, and the
kernels run with scale 1. The forward is the custom op
``ray_tpu_torch::flash_fwd`` so that a selective-checkpoint policy can
save its outputs (the reference names them ``attn_out``/``attn_lse`` for
its "dots" remat policy) instead of launching the kernel again.

Masking follows the Pallas kernels: the finite ``NEG_INF = -1e30``,
causal at ``q_offset + i >= j``, segment ids. A row that sees kv
positions but none of its segment gets, as the Pallas forward gives it,
p = exp(NEG_INF - NEG_INF) = 1 at each of them: its output is the mean
of V over its causal window [0, min(Sk, q_offset + i + 1)) and its lse
is about NEG_INF; the backward gives that row zero gradient. A row that
sees no kv position at all returns 0 with lse = NEG_INF.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ray_tpu_torch.ops.paged_attention import pick_impl, raise_on_error

NEG_INF = -1e30  # finite: -inf would breed NaN through (-inf) - (-inf)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# fp32 runs on CUDA cores with the G heads of a GQA group folded into one
# 64-row tile, so G must divide 64; bf16 runs on the tensor cores (wgmma)
# with one CTA per q head, so any whole group works
_FP32_ROWS = 64


def _masks(B, Sq, Sk, causal, q_offset, qseg, kseg, device):
    """window [1|B, 1, 1, Sq, Sk]: the kv positions a row may see at all
    (causal limit); valid: those it attends to (window and same segment)."""
    q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=device)[None, :]
    window = (k_pos <= q_pos) if causal else torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    window = window[None, None, None]
    valid = window
    if qseg is not None:
        valid = window & (qseg[:, :, None] == kseg[:, None, :])[:, None, None]
    return window, valid


def _scores(q, k, scale):
    """fp32 scores [B, KVH, G, Sq, Sk] (exact products of the inputs)."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    qg = q.float().reshape(B, Sq, KVH, H // KVH, D)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale


def flash_attention_fwd_torch(q, k, v, qseg=None, kseg=None, *, causal: bool = True,
                              q_offset: int = 0, scale: float = 1.0):
    """Plain forward: (o [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32).
    Probabilities are cast to v's dtype for the PV product, as the Pallas
    kernel casts them; the denominator sums them in fp32."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    window, valid = _masks(B, Sq, Sk, causal, q_offset, qseg, kseg, q.device)
    s = torch.where(valid, _scores(q, k, scale), NEG_INF)
    s = s.masked_fill(~window, float("-inf"))  # outside the window: not visited
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)  # rows that see nothing -> 0
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = o / safe_l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(safe_l)).reshape(B, H, Sq)
    return o.reshape(B, Sq, H, D).to(q.dtype).contiguous(), lse


def flash_attention_bwd_torch(q, k, v, o, lse, do, dlse=None, qseg=None, kseg=None, *,
                              causal: bool = True, q_offset: int = 0, scale: float = 1.0):
    """Plain backward from the stored lse [B, H, Sq]:
        p = exp(s - lse) on valid entries, 0 elsewhere
        delta = rowsum(dO * O) - dlse
        dV = p^T dO,  dP = dO V^T,  dS = p * (dP - delta) * scale
        dQ = dS K,    dK = dS^T Q
    with dK/dV summed over the GQA group; p and dS are cast to the input
    dtype for their products, as the Pallas kernels cast them."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    _, valid = _masks(B, Sq, Sk, causal, q_offset, qseg, kseg, q.device)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    if dlse is not None:
        delta = delta - dlse.float()
    s = _scores(q, k, scale)
    p = torch.where(valid, torch.exp(s - lse.reshape(B, KVH, G, Sq, 1)), 0.0)
    dof = do.float().reshape(B, Sq, KVH, G, D)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = (p * (dp - delta.reshape(B, KVH, G, Sq, 1)) * scale).to(q.dtype).float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(B, Sq, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(B, Sq, KVH, G, D))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def check_kernel_shape(name, dtype, H: int, KVH: int, D: int) -> None:
    """Raise unless the kernels of ``dtype`` take this head layout: head_dim
    64 or 128; H a whole multiple of KVH; for fp32 also a group that
    divides 64 (bf16 takes any whole group)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not supported {_HEAD_DIMS}")
    if KVH <= 0 or H % KVH:
        raise ValueError(f"{name}: GQA group {H}/{KVH} must be whole")
    if dtype == torch.float32 and _FP32_ROWS % (H // KVH):
        raise ValueError(f"{name}: GQA group {H}/{KVH} must divide {_FP32_ROWS} for the fp32 "
                         f"kernel (bf16 takes any whole group)")


def _check(name, q, k, v, qseg, kseg, extra=()):
    """What the kernels take; anything else raises before launch. The
    shape checks come first, so they also hold for CPU tensors."""
    B, Sq, H, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: k/v must be [B, Sk, KVH, {D}], got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    check_kernel_shape(name, q.dtype, H, k.shape[2], D)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q is on {q.device}, the kernel needs CUDA tensors")
    for t_name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {t_name} dtype {t.dtype} != q dtype {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be contiguous and 16-byte aligned")
    for t_name, t, n in (("q segments", qseg, Sq), ("kv segments", kseg, k.shape[1])):
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: {t_name} must be a contiguous int32 CUDA tensor")
        if t.shape != (B, n):
            raise ValueError(f"{name}: {t_name} shape {tuple(t.shape)} != {(B, n)}")
    if (qseg is None) != (kseg is None):
        raise ValueError(f"{name}: pass both segment arrays or neither")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _lib(name: str, n_ptrs: int):
    from ray_tpu_torch.ops import _build

    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_fwd_cuda(q, k, v, qseg=None, kseg=None, *, causal: bool = True,
                   q_offset: int = 0, scale: float = 1.0):
    """Launch ``csrc/flash_fwd.cu`` on the current stream -> (o, lse)."""
    _check("flash_fwd", q, k, v, qseg, kseg)
    B, Sq, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib("flash_fwd", 7)
    rc = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg), _ptr(kseg),
        o.data_ptr(), lse.data_ptr(),
        B, Sq, k.shape[1], H, k.shape[2], D, int(q_offset), int(causal),
        float(scale), _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on_error(lib, "flash_fwd", rc)
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0  # kernel launches, for showing a path ran it


def flash_bwd_cuda(q, k, v, o, lse, do, dlse=None, qseg=None, kseg=None, *,
                   causal: bool = True, q_offset: int = 0, scale: float = 1.0):
    """Launch ``csrc/flash_bwd.cu`` (its dK/dV and dQ kernels) on the
    current stream -> (dq, dk, dv). delta = rowsum(dO * O) - dlse is
    computed here, outside the kernels, as the reference computes it
    outside every pallas_call."""
    do = do.contiguous()
    _check("flash_bwd", q, k, v, qseg, kseg, extra=(("do", do),))
    if o.shape != q.shape:
        raise ValueError(f"flash_bwd: o shape {tuple(o.shape)} != q shape {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    # the same fp32 products and sum as (do.float() * o.float()).sum(-1),
    # with one fp32 copy instead of three (mul_ reads o in its own dtype)
    delta = do.to(torch.float32, copy=True).mul_(o).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    delta = delta.contiguous()
    lse = lse.float().contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib("flash_bwd", 11)
    rc = lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(qseg), _ptr(kseg), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, k.shape[1], H, k.shape[2], D, int(q_offset), int(causal),
        float(scale), _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    raise_on_error(lib, "flash_bwd", rc)
    flash_bwd_cuda.launches += 1
    return dq, dk, dv


flash_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# differentiable function
# ---------------------------------------------------------------------------


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qseg: Optional[torch.Tensor], kseg: Optional[torch.Tensor],
                  causal: bool, q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    impl = pick_impl("flash_attention", q.device, "auto")
    fwd = flash_attention_fwd_torch if impl == "torch" else flash_fwd_cuda
    return fwd(q, k, v, qseg, kseg, causal=causal, q_offset=q_offset)


@_flash_fwd_op.register_fake
def _(q, k, v, qseg, kseg, causal, q_offset):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq), dtype=torch.float32)


FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with a differentiable lse: ring attention merges blockwise
    results through lse, so its cotangent must reach dS."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, q_offset):
        o, lse = torch.ops.ray_tpu_torch.flash_fwd(q, k, v, qseg, kseg, causal, q_offset)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        impl = pick_impl("flash_attention", q.device, "auto")
        bwd = flash_attention_bwd_torch if impl == "torch" else flash_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, lse, do, dlse, qseg, kseg,
                         causal=ctx.causal, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KVH, D]
    v: torch.Tensor,  # [B, Sk, KVH, D]
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,     # [B, S] (requires Sq == Sk)
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, Sk] (k/v side override)
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Drop-in for ``attention_torch`` with O(S) memory. kv_segment_ids:
    the k/v side's segments when they differ from q's (ring attention's
    rotating kv shards); segment_ids then applies to q only. return_lse:
    also return the differentiable per-row log-sum-exp [B, Sq, H]."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if H % KVH != 0:
        raise ValueError(f"n_heads {H} not divisible by kv heads {KVH}")
    if not isinstance(q_offset, int):
        raise ValueError(
            "flash_attention requires a static int q_offset (traced offsets "
            "belong to the paged decode path, ops/paged_attention.py)"
        )
    if segment_ids is not None and kv_segment_ids is None and Sq != Sk:
        raise ValueError("segment_ids requires Sq == Sk (or pass kv_segment_ids separately)")
    if kv_segment_ids is not None and segment_ids is None and Sq != Sk:
        raise ValueError(
            "kv_segment_ids with Sq != Sk needs an explicit q-side segment_ids "
            "(the kv array cannot stand in for it)"
        )
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    q = (q.float() * scale).to(q.dtype)  # fold the scale: the kernels run at 1.0

    qseg = kseg = None
    if segment_ids is not None or kv_segment_ids is not None:
        q_side = segment_ids if segment_ids is not None else kv_segment_ids
        k_side = kv_segment_ids if kv_segment_ids is not None else segment_ids
        qseg = q_side.to(torch.int32).contiguous()
        kseg = k_side.to(torch.int32).contiguous()
    o, lse = _FlashAttention.apply(q, k.contiguous(), v.contiguous(), qseg, kseg,
                                   causal, q_offset)
    if return_lse:
        return o, lse.transpose(1, 2)
    return o
