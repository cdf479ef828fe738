"""Paged decode attention over a flat-slot KV cache (counterpart of
``ray_tpu/ops/paged_attention.py``).

 * ``paged_attention_torch`` — the plain PyTorch version: gather + masked
   softmax, mirroring ``paged_attention_xla``. The CPU path and the
   yardstick the CUDA kernel is held against.
 * ``paged_attention_cuda`` — launches the hand-written Hopper kernel
   ``csrc/paged_attention.cu`` (replacing the Pallas ``_paged_attn_kernel``).
 * ``paged_attention`` — dispatch: the plain version for CPU tensors, the
   kernel for CUDA tensors. Unlike the reference, whose ``auto`` means
   XLA everywhere, ``auto`` never runs the plain version on the card, and
   nothing falls back to it: a kernel that cannot launch raises.

Layout: k_cache / v_cache are HEAD-MAJOR [n_kv_heads, num_slots, head_dim]
per layer; slot = block_id * block_size + offset. One page of one kv head
is a contiguous block_size x head_dim tile, which is what the kernel reads.

A pad row (context length 0) returns 0 in both versions, as the Pallas
kernel writes (``paged_attention_xla`` returns NaN there).
"""

from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 16  # query heads per kv head the decode kernel's row tile holds


def paged_attention_torch(
    q: torch.Tensor,             # [B, n_heads, head_dim]
    k_cache: torch.Tensor,       # [n_kv_heads, num_slots, head_dim]
    v_cache: torch.Tensor,       # [n_kv_heads, num_slots, head_dim]
    block_tables: torch.Tensor,  # [B, max_blocks] int32 block ids (padded w/ 0)
    context_lens: torch.Tensor,  # [B] int32 valid tokens per sequence
    *,
    block_size: int,
) -> torch.Tensor:               # [B, n_heads, head_dim]
    B, H, D = q.shape
    KVH = k_cache.shape[0]
    G = H // KVH
    MB = block_tables.shape[1]
    S = MB * block_size  # padded kv length

    offs = torch.arange(S, device=q.device)
    slots = block_tables.long()[:, offs // block_size] * block_size + offs % block_size
    k = k_cache[:, slots].float()  # [KVH, B, S, D]
    v = v_cache[:, slots].float()
    qg = q.reshape(B, KVH, G, D).float()
    scores = torch.einsum("bhgd,hbsd->bhgs", qg, k) * (1.0 / math.sqrt(D))
    mask = offs[None, :] < context_lens.long()[:, None]  # [B, S]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # ctx = 0 pad rows -> 0
    out = torch.einsum("bhgs,hbsd->bhgd", probs, v)
    return out.reshape(B, H, D).to(q.dtype)


def check_kernel_args(name: str, q, k_cache, v_cache, int_arrays: dict,
                      block_size: int) -> None:
    """What the CUDA kernels take; anything else raises before launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: q is on {dev}, the kernel needs CUDA tensors")
    for t_name, t in (("k_cache", k_cache), ("v_cache", v_cache), *int_arrays.items()):
        if t.device != dev:
            raise ValueError(f"{name}: {t_name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"{name}: cache dtypes {k_cache.dtype}/{v_cache.dtype} != q dtype {q.dtype}"
        )
    D = q.shape[-1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not supported {_HEAD_DIMS}")
    if k_cache.ndim != 3 or k_cache.shape != v_cache.shape or k_cache.shape[2] != D:
        raise ValueError(
            f"{name}: caches must be [KVH, slots, {D}], got "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}"
        )
    H, KVH = q.shape[-2], k_cache.shape[0]
    if H % KVH:
        raise ValueError(f"{name}: {H} query heads not a multiple of {KVH} kv heads")
    if k_cache.shape[1] % block_size:
        raise ValueError(
            f"{name}: cache slots {k_cache.shape[1]} not a multiple of "
            f"block_size {block_size}"
        )
    for t_name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")
    for t_name, t in int_arrays.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: {t_name} must be a contiguous int32 tensor")


def raise_on_error(lib, name: str, rc: int) -> None:
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel failed: {err(rc).decode()} (cudaError {rc})")


def _paged_lib():
    from ray_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_attention_cuda(q, k_cache, v_cache, block_tables, context_lens, *,
                         block_size: int) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on the current stream."""
    B, H, D = q.shape
    check_kernel_args(
        "paged_attention", q, k_cache, v_cache,
        {"block_tables": block_tables, "context_lens": context_lens}, block_size,
    )
    if H // k_cache.shape[0] > _MAX_GROUP:
        raise ValueError(
            f"paged_attention: GQA group {H // k_cache.shape[0]} > {_MAX_GROUP}"
        )
    if block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("paged_attention: block_tables / context_lens batch != q batch")
    out = torch.empty_like(q)
    lib = _paged_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        B, H, k_cache.shape[0], D, k_cache.shape[1], block_tables.shape[1],
        block_size, _DTYPE_CODES[q.dtype], stream,
    )
    raise_on_error(lib, "paged_attention", rc)
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0  # kernel launches, for showing a path ran it


def pick_impl(name: str, device: torch.device, impl: str) -> str:
    """auto | torch | cuda -> torch | cuda. ``auto`` takes the plain
    version for CPU tensors and the kernel for CUDA tensors; ``torch``
    takes only CPU tensors (the plain version never runs on the card)."""
    if impl == "auto":
        impl = {"cpu": "torch", "cuda": "cuda"}.get(device.type)
        if impl is None:
            raise ValueError(f"{name}: no implementation for device {device}")
    if impl == "torch" and device.type != "cpu":
        raise ValueError(
            f"{name}: the plain version serves CPU tensors only; CUDA tensors "
            "launch the kernel"
        )
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {device}")
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown {name} impl {impl!r}")
    return impl


def paged_attention(q, k_cache, v_cache, block_tables, context_lens, *,
                    block_size: int, impl: str = "auto") -> torch.Tensor:
    """impl: auto | torch | cuda (see ``pick_impl``)."""
    if pick_impl("paged_attention", q.device, impl) == "torch":
        return paged_attention_torch(
            q, k_cache, v_cache, block_tables, context_lens, block_size=block_size
        )
    return paged_attention_cuda(
        q, k_cache, v_cache, block_tables, context_lens, block_size=block_size
    )
