"""Functional NN building blocks on torch tensors (counterpart of
``ray_tpu/nn/layers.py``).

Plain functions over tensors and a dict of weights, as in the reference:
no ``nn.Module`` state, so the decode paths can slice the stacked layer
weights per layer without copies.
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
