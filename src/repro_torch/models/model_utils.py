"""Shared model-assembly pieces: named parameter groups and the init law.

The JAX package stacks each leaf over layers and scans them with
``lax.scan``; the port keeps one parameter group per layer in an
``nn.ModuleList`` and loops over it.  (Remat and the gradient dtype guard
of the reference are training concerns; this slice runs inference only.)
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["ParamGroup", "normal"]


class ParamGroup(nn.Module):
    """Named tensors as non-trainable parameters, read like the JAX
    package's parameter dicts (``group["wq"]``)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]


def normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """``N(0, std^2)`` drawn in float32 from ``generator``, cast to ``dtype``
    (the JAX package's ``normal(key, shape, float32) * std`` init)."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return (out * std).to(dtype)
