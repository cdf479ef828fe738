"""Paged decode attention over a flat-slot KV cache (counterpart of
``ray_tpu/ops/paged_attention.py``).

 * ``paged_attention_torch`` — the plain PyTorch version: gather + masked
   softmax, mirroring ``paged_attention_xla``. The CPU path and the
   yardstick the CUDA kernel is held against.
 * ``paged_attention_cuda`` — launches the hand-written Hopper kernel
   ``csrc/paged_attention.cu`` (replacing the Pallas ``_paged_attn_kernel``):
   split-KV flash-decoding, with a split count fixed by shapes alone
   (``num_splits``) and an fp32 workspace for the splits' partials.
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

import collections
import ctypes
import math
import threading

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


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
    """What the CUDA kernels take; anything else raises before launch. The
    device checks come last, so every other check also holds for CPU
    tensors."""
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
    if block_size <= 0 or k_cache.shape[1] % block_size:
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
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: q is on {dev}, the kernel needs CUDA tensors")
    for t_name, t in (("k_cache", k_cache), ("v_cache", v_cache), *int_arrays.items()):
        if t.device != dev:
            raise ValueError(f"{name}: {t_name} is on {t.device}, q on {dev}")


# Split-KV decode (csrc/decode_split.cuh): each (sequence, kv head)'s pages
# are cut into `splits` ranges, one CTA each. The count comes from shapes
# alone, never from the context lengths, so the engine's decode loop reads
# nothing back and a (batch, table-width) bucket always launches the same
# grid. One CTA per SM measured better than two (chip_smoke.py's
# `split_sweep_ms`): more splits add merge work and shorten no split enough
# to pay for it.
SPLIT_MIN_POSITIONS = 256   # no split is cut shorter than this much of the table's width
MAX_SPLITS = 32


def num_splits(B: int, KVH: int, max_kv: int, sm_count: int) -> int:
    """Splits per (sequence, kv head): enough CTAs for one on every SM,
    but none covering less than SPLIT_MIN_POSITIONS positions of the
    block table's width ``max_kv`` (= max_blocks * block_size)."""
    if B * KVH <= 0 or max_kv <= 0:
        return 1
    want = -(-sm_count // (B * KVH))
    cap = -(-max_kv // SPLIT_MIN_POSITIONS)
    return max(1, min(want, cap, MAX_SPLITS))


def split_plan(B: int, H: int, KVH: int, D: int, max_kv: int, sm_count: int):
    """(splits, workspace shape): the fp32 partials [B, H, splits, D + 2]
    (unnormalised output, running max, sum) that the combine kernel merges;
    no workspace with one split, where the kernel writes the output."""
    s = num_splits(B, KVH, max_kv, sm_count)
    return s, ((B, H, s, D + 2) if s > 1 else None)


_SM_COUNTS: dict = {}


def sm_count(device: torch.device) -> int:
    n = _SM_COUNTS.get(device.index)
    if n is None:
        n = _SM_COUNTS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def decode_workspace(q, H: int, KVH: int, D: int, B: int, max_kv: int):
    """(splits, workspace tensor or None) for a launch on q's device."""
    splits, shape = split_plan(B, H, KVH, D, max_kv, sm_count(q.device))
    ws = None if shape is None else torch.empty(shape, dtype=torch.float32, device=q.device)
    return splits, ws


_launch_lock = threading.Lock()
_thread_tally = threading.local()


def count_launch(wrapper, name: str) -> None:
    """Book one launch of ``wrapper``'s kernel: its ``launches`` count (every
    thread's, under a lock so concurrent engines lose none) and this
    thread's tally (``thread_launches``), which a graph capture reads so
    that another thread's launches never enter its per-replay count."""
    with _launch_lock:
        wrapper.launches += 1
    tally = getattr(_thread_tally, "counts", None)
    if tally is None:
        tally = _thread_tally.counts = collections.Counter()
    tally[name] += 1


def thread_launches() -> dict:
    """Kernel launches booked by the calling thread so far, by kernel name."""
    return dict(getattr(_thread_tally, "counts", {}))


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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def paged_attention_cuda(q, k_cache, v_cache, block_tables, context_lens, *,
                         block_size: int) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on the current stream: the
    split-KV kernel, then the combine kernel when there are several splits."""
    B, H, D = q.shape
    if block_tables.ndim != 2 or block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("paged_attention: block_tables / context_lens batch != q batch")
    check_kernel_args(
        "paged_attention", q, k_cache, v_cache,
        {"block_tables": block_tables, "context_lens": context_lens}, block_size,
    )
    KVH, MB = k_cache.shape[0], block_tables.shape[1]
    splits, ws = decode_workspace(q, H, KVH, D, B, MB * block_size)
    out = torch.empty_like(q)
    lib = _paged_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        B, H, KVH, D, k_cache.shape[1], MB, block_size, splits,
        None if ws is None else ws.data_ptr(), _DTYPE_CODES[q.dtype], stream,
    )
    raise_on_error(lib, "paged_attention", rc)
    count_launch(paged_attention_cuda, "paged_attention")
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
