"""RMSNorm through the hand-written CUDA kernels of ``csrc/rmsnorm.cu``.

:func:`rmsnorm_fused` replaces the TPU kernel
``repro/kernels/rmsnorm/kernel.py::rmsnorm_fused``: rows ``(R, D)`` in
float32, bfloat16 or float16, a ``(D,)`` scale of any floating dtype, cast to
float32 before the launch (as the reference casts it).  For CUDA tensors it
launches one of the source's three kernels, chosen by :func:`kernel_for`
from the shape, or raises (also when an input requires grad while
gradients are recorded: the kernel has no backward); for CPU tensors it runs
:func:`~repro_torch.kernels.rmsnorm.ref.rmsnorm_ref`.  Its ``launches``
attribute counts kernel launches, ``launches_by_kernel`` the same per
kernel.  :func:`rmsnorm` takes the model layout ``(..., D)``.  As in the
JAX package, the models normalise through ``models/layers/norms.py``; this
kernel is its own entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    F, I, P, check, device_of, forward_only, launch, stream,
)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.utils.kernel_bounds import rmsnorm_bound
from repro_torch.utils.op_cost import priced

__all__ = ["rmsnorm", "rmsnorm_fused", "kernel_for", "KERNELS"]

# x, scale, out, rows, d, eps, dtype, kernel, stream
_ARGTYPES = (P, P, P, I, I, F, I, I, P)
# dtype -> the C side's code
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# kernel name -> the C side's code
KERNELS = {"scalar": 0, "warp": 1, "cta": 2}
WARP_MAX_D = 2048      # one warp per row up to here
MAX_VECTORS = 2048     # 16-byte vectors a 256-thread CTA holds in registers


def kernel_for(d: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """Which kernel of ``csrc/rmsnorm.cu`` takes rows of ``d`` elements of
    ``dtype``: ``"warp"`` (one warp per row, D <= 2048) or ``"cta"`` (one
    CTA per row) when D is a multiple of the 16-byte vector width and the
    pointers are 16-byte ``aligned``, else ``"scalar"``."""
    vec = 16 // dtype.itemsize
    if d % vec or not aligned or d // vec > MAX_VECTORS:
        return "scalar"
    return "warp" if d <= WARP_MAX_D else "cta"


def rmsnorm_fused(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of each row of ``x`` (R, D); returns (R, D) in ``x``'s dtype."""
    return priced(
        "rmsnorm_fused",
        lambda: rmsnorm_bound(x.shape[0], x.shape[-1], x.element_size()),
        lambda: _rmsnorm_fused(x, scale, eps),
        lambda: torch.empty_like(x), x, scale)


def _rmsnorm_fused(x, scale, eps: float) -> torch.Tensor:
    device = device_of(x, scale)
    if device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    forward_only("rmsnorm_fused", x, scale)
    check("x", x, tuple(DTYPES), 2)
    if scale.is_floating_point():  # as the reference and the CPU leg do
        scale = scale.to(torch.float32)
    check("scale", scale, torch.float32, 1)
    rows, d = x.shape
    if scale.shape[0] != d:
        raise ValueError(f"scale {tuple(scale.shape)} does not match D={d}")
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out))
    kernel = kernel_for(d, x.dtype, aligned)
    launch(
        "rmsnorm", _ARGTYPES, x.data_ptr(), scale.data_ptr(), out.data_ptr(),
        rows, d, float(eps), DTYPES[x.dtype], KERNELS[kernel],
        stream(device),
    )
    rmsnorm_fused.launches += 1
    rmsnorm_fused.launches_by_kernel[kernel] += 1
    return out


rmsnorm_fused.launches = 0
rmsnorm_fused.launches_by_kernel = dict.fromkeys(KERNELS, 0)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the model layout ``(..., D)``."""
    shape = x.shape
    return rmsnorm_fused(x.reshape(-1, shape[-1]), scale, eps=eps).reshape(shape)
