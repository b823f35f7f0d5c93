"""Attention through the hand-written CUDA kernel ``csrc/flash_attention.cu``.

:func:`mha` replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention`` behind the
JAX package's ``ops.mha``: blockwise online-softmax attention in the
model layout — q ``(B, S, N, h)``, k and v ``(B, T, K, h)`` — with GQA
(query head n reads kv head ``n*K//N``), the causal and sliding-window
masks (``window`` only with ``causal``), float32 running max, sum and
accumulator, and the output in q's dtype.  The kernel reads the model
layout through its strides, so nothing is transposed or padded.

For CUDA tensors it launches the kernel or raises (float32 or bfloat16,
head_dim 64 or 128, contiguous inputs); for CPU tensors it runs
:func:`~repro_torch.kernels.flash_attention.ref.mha_ref`.  ``mha.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import I, P, check, device_of, launch, stream
from repro_torch.kernels.flash_attention.ref import mha_ref

__all__ = ["mha", "HEAD_DIMS"]

# q, k, v, out, B, S, T, N, K, h, causal, window, is_bf16, stream
_ARGTYPES = (P, P, P, P, I, I, I, I, I, I, I, I, I, P)
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)


def mha(
    q: torch.Tensor,  # (B, S, N, h)
    k: torch.Tensor,  # (B, T, K, h)
    v: torch.Tensor,  # (B, T, K, h)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention output (B, S, N, h) in q's dtype."""
    device = device_of(q, k, v)
    if device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(name, t, DTYPES, 4)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, n, h = q.shape
    t, kh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t, kh, h) or tuple(v.shape) != (b, t, kh, h):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} not supported; one of {HEAD_DIMS}")
    if kh == 0 or n % kh:
        raise ValueError("q heads must be a multiple of kv heads")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch(
        "flash_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, s, t, n, kh, h, int(causal),
        int(window) if causal else 0, int(q.dtype == torch.bfloat16),
        stream(device),
    )
    mha.launches += 1
    return out


mha.launches = 0
