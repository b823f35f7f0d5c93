"""Normalization layers (functions + init)."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm"]


def rmsnorm_init(dim: int, device=None, dtype=torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 math, cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * (var + eps) ** -0.5
    out = normed * params["scale"].float()
    return out.to(x.dtype)


def layernorm_init(dim: int, device=None, dtype=torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 math with the population variance (``jnp.var``),
    cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * (var + eps) ** -0.5
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)
