"""Functional NN building blocks on torch tensors (counterpart of
``ray_tpu/nn/layers.py``).

Plain functions over tensors and a dict of weights, as in the reference:
no ``nn.Module`` state, so the decode paths can slice the stacked layer
weights per layer without copies. Where the reference has a
``jax.custom_vjp`` (the fused lm-head + cross entropy) the port has a
``torch.autograd.Function``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in fp32 whatever the input dtype; the result is cast
    back to ``x.dtype``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 500000.0,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables [max_seq, head_dim // 2] in fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the features (half-split, not interleaved).
    x: [B, S, H, D]; positions: [B, S] or [S]."""
    c = cos[positions]  # [..., S, D/2]
    s = sin[positions]
    if c.ndim == 2:  # positions was [S]
        c = c[None, :, None, :]
        s = s[None, :, None, :]
    else:  # [B, S, D/2]
        c = c[:, :, None, :]
        s = s[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    gate = x @ w_gate.to(x.dtype)
    up = x @ w_up.to(x.dtype)
    return (F.silu(gate) * up) @ w_down.to(x.dtype)


def cross_entropy_loss(
    logits: torch.Tensor,                # [B, S, V] (any float dtype; upcast inside)
    targets: torch.Tensor,               # [B, S] int
    mask: torch.Tensor | None = None,    # [B, S] 0/1
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean_nll, total_weight), with an fp32 log-softmax."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def _masked_mean(nll: torch.Tensor, mask: torch.Tensor | None):
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / total, total


# ---------------------------------------------------------------------------
# fused lm-head + cross entropy (reference: ray_tpu/nn/layers.py:78-167)
# ---------------------------------------------------------------------------
#
# The backward recomputes the [T, V] logits from (h, w) instead of keeping
# them, so the residuals are O(T): h, w, targets and the per-token lse. At
# T 8192, V 32000 the fp32 logits alone take 1.05 GB. The matmuls take
# bf16 operands and accumulate and return fp32, as the reference's
# ``preferred_element_type=float32`` dot does.


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation and an fp32 result, whatever the
    (shared) operand dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()  # exact products of the narrow operands


class _FusedNLL(torch.autograd.Function):
    """Per-token negative log-likelihood of a linear head.
    h [T, D] (bf16 typical), w [D, V], targets [T] int -> [T] fp32."""

    @staticmethod
    def forward(ctx, h, w, targets):
        logits = _mm_f32(h, w.to(h.dtype))
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, targets.long()[:, None])[:, 0]
        ctx.save_for_backward(h, w, targets, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lse = ctx.saved_tensors
        wh = w.to(h.dtype)
        dl = torch.exp(_mm_f32(h, wh) - lse[:, None])  # softmax, recomputed
        dl[torch.arange(h.shape[0], device=h.device), targets.long()] -= 1.0
        dl = (dl * g[:, None]).to(h.dtype)  # [T, V] in the compute dtype
        dh = (dl @ wh.T).to(h.dtype)
        dw = _mm_f32(h.T, dl).to(w.dtype)
        return dh, dw, None


def fused_cross_entropy_loss(
    h: torch.Tensor,                     # [B, S, D] final hidden states
    w: torch.Tensor,                     # [D, V] lm-head weight
    targets: torch.Tensor,               # [B, S] int
    mask: torch.Tensor | None = None,    # [B, S] 0/1
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean_nll, total_weight) without keeping fp32 softmax state."""
    B, S, D = h.shape
    nll = _FusedNLL.apply(h.reshape(B * S, D), w, targets.reshape(B * S))
    return _masked_mean(nll.reshape(B, S), mask)
