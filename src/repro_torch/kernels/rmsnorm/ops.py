"""RMSNorm through the hand-written CUDA kernel ``csrc/rmsnorm.cu``.

:func:`rmsnorm_fused` replaces the TPU kernel
``repro/kernels/rmsnorm/kernel.py::rmsnorm_fused``: rows ``(R, D)`` in
float32 or bfloat16, a float32 ``(D,)`` scale.  For CUDA tensors it
launches the kernel or raises; for CPU tensors it runs
:func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`.  Its ``launches``
attribute counts kernel launches.  :func:`rmsnorm` takes the model layout
``(..., D)``.  As in the JAX package, the models normalise through
``models/layers/norms.py``; this kernel is its own entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import F, I, P, check, device_of, launch, stream
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_fused"]

# x, scale, out, rows, d, eps, is_bf16, stream
_ARGTYPES = (P, P, P, I, I, F, I, P)
DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_fused(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of each row of ``x`` (R, D); returns (R, D) in ``x``'s dtype."""
    device = device_of(x, scale)
    if device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    check("x", x, DTYPES, 2)
    check("scale", scale, torch.float32, 1)
    rows, d = x.shape
    if scale.shape[0] != d:
        raise ValueError(f"scale {tuple(scale.shape)} does not match D={d}")
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    launch(
        "rmsnorm", _ARGTYPES, x.data_ptr(), scale.data_ptr(), out.data_ptr(),
        rows, d, float(eps), int(x.dtype == torch.bfloat16), stream(device),
    )
    rmsnorm_fused.launches += 1
    return out


rmsnorm_fused.launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the model layout ``(..., D)``."""
    shape = x.shape
    return rmsnorm_fused(x.reshape(-1, shape[-1]), scale, eps=eps).reshape(shape)
