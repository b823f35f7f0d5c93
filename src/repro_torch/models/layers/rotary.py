"""Rotary position embeddings (RoPE)."""
from __future__ import annotations

import torch

__all__ = ["rope_frequencies", "apply_rope"]


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) in float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(
    x: torch.Tensor,  # (..., seq, heads, head_dim)
    positions: torch.Tensor,  # (..., seq) integer
    theta: float = 10000.0,
) -> torch.Tensor:
    """Rotate the halves (x[..., :d/2], x[..., d/2:]) in float32 — the
    llama 'half' convention."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
