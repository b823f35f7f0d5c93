"""Attention through the port's hand-written CUDA kernels.

:func:`mha` replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention`` behind the
JAX package's ``ops.mha``: blockwise online-softmax attention in the
model layout — q ``(B, S, N, h)``, k and v ``(B, T, K, h)`` — with GQA
(query head n reads kv head ``n*K//N``), the causal and sliding-window
masks (``window`` only with ``causal``), float32 running max, sum and
accumulator, and the output in q's dtype.  The kernels read the model
layout directly, so nothing is transposed or padded.  Like the reference's
kernel it takes float32, bfloat16 and float16 at any head_dim >= 1.

Two routes, chosen by dtype, head_dim and alignment (:func:`route_of`):

- ``wgmma_bf16``: bfloat16 and float16 at a head_dim that is a multiple of
  8 up to 256, with 16-byte aligned bases, through
  ``csrc/flash_attention_wgmma.cu``, on the tensor cores (``wgmma`` fed by
  TMA), built at head_dim 64, 128 and 256 (a head_dim runs at the smallest
  >= it, TMA filling the columns past it with zeros).  The probabilities
  are rounded to the input's type before P·V.  float16 launches ride this
  route's name and counter.
- ``mma_sync``: float32, and bfloat16 and float16 at any other head_dim or
  base, through ``csrc/flash_attention.cu``, on the tensor cores by
  ``mma.sync``: 16-bit inputs as the wgmma route rounds them, float32 by
  split TF32 (each operand as a TF32 big part plus a TF32 small part, three
  products for each one, so float32 keeps its 2e-5 tolerance, which one
  TF32 product misses).  Any head_dim >= 1 and any base: the head_dim is
  padded with zeros to the next multiple of 16 (8 in float32), past 256
  the output columns are split into slices of at most 256, one CTA each,
  every slice forming the same scores.

The scale is always the true head_dim's h^-1/2.  A head_dim of 0 raises,
on either device.

For CUDA tensors :func:`mha` launches the route's kernel or raises
(contiguous inputs; an input that requires grad while gradients are
recorded: the kernels have no backward); for CPU tensors it runs
:func:`~repro_torch.kernels.flash_attention.ref.mha_ref`.  ``mha.launches``
counts kernel launches, ``mha.launches_by_route`` the same per route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    I, P, check, device_of, forward_only, launch, stream,
)
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.utils.kernel_bounds import flash_bound
from repro_torch.utils.op_cost import priced

__all__ = ["mha", "route_of", "HEAD_DIMS", "WGMMA_MAX_HEAD_DIM", "ROUTES"]

# dtype -> route (at a head_dim and base the route takes); the C side's
# dtype code of the mma.sync kernel
ROUTES = {torch.bfloat16: "wgmma_bf16", torch.float16: "wgmma_bf16",
          torch.float32: "mma_sync"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# route -> (library, C argument types): q, k, v, out, B, S, T, N, K, h,
# causal, window, is_half (wgmma) or the dtype code (mma.sync), stream
_LAUNCH = {
    "wgmma_bf16": ("flash_attention_wgmma", (P, P, P, P) + (I,) * 9 + (P,)),
    "mma_sync": ("flash_attention", (P, P, P, P) + (I,) * 9 + (P,)),
}
# the head_dims the wgmma kernel is built at; a head_dim h runs at the
# smallest one >= h, its columns past h zero
HEAD_DIMS = (64, 128, 256)
WGMMA_MAX_HEAD_DIM = HEAD_DIMS[-1]


def route_of(dtype: torch.dtype, head_dim: int | None = None,
             aligned: bool = True) -> str:
    """The kernel route for inputs of ``dtype`` (at ``head_dim``, where
    given, from bases that are 16-byte ``aligned`` or not); raise on a
    dtype the reference's kernel never sees (``TypeError``: float64 with
    JAX's x64 off, integers) or a head_dim of 0 (``ValueError``).
    bfloat16 and float16 go to ``wgmma_bf16`` unless the head_dim is not a
    multiple of 8 (TMA's rows are 16-byte multiples) or past 256, or a base
    is not 16-byte aligned (TMA's), which go to ``mma_sync``."""
    if dtype not in ROUTES:
        raise TypeError(f"flash attention takes {tuple(ROUTES)}, got {dtype}")
    if head_dim is None:
        return ROUTES[dtype]
    _check_head_dim(head_dim)
    if ROUTES[dtype] == "wgmma_bf16" and (
            head_dim % 8 or head_dim > WGMMA_MAX_HEAD_DIM or not aligned):
        return "mma_sync"
    return ROUTES[dtype]


def _check_head_dim(h: int) -> None:
    if h < 1:
        raise ValueError(f"head_dim {h}: attention needs a head_dim >= 1")


def mha(
    q: torch.Tensor,  # (B, S, N, h)
    k: torch.Tensor,  # (B, T, K, h)
    v: torch.Tensor,  # (B, T, K, h)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention output (B, S, N, h) in q's dtype."""
    b, s, n, h = q.shape
    return priced(
        "flash_attention",
        lambda: flash_bound(b, s, k.shape[1], n, k.shape[2], h,
                            q.element_size(), causal, window if causal else 0),
        lambda: _mha(q, k, v, causal, window),
        lambda: torch.empty(q.shape, dtype=q.dtype, device=q.device), q, k, v)


def _mha(q, k, v, causal: bool, window: int) -> torch.Tensor:
    device = device_of(q, k, v)
    _check_head_dim(q.shape[-1])  # on either device
    if device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window)
    forward_only("flash attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(name, t, tuple(ROUTES), 4)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, n, h = q.shape
    t, kh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t, kh, h) or tuple(v.shape) != (b, t, kh, h):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    # TMA reads from 16-byte aligned bases
    route = route_of(q.dtype, h, all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    if kh == 0 or n % kh:
        raise ValueError("q heads must be a multiple of kv heads")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    window = int(window) if causal else 0
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, n, kh, h, int(causal), window,
            int(q.dtype == torch.float16) if route == "wgmma_bf16"
            else _DTYPE_CODE[q.dtype]]
    library, argtypes = _LAUNCH[route]
    launch(library, argtypes, *args, stream(device))
    mha.launches += 1
    mha.launches_by_route[route] += 1
    return out


mha.launches = 0
mha.launches_by_route = dict.fromkeys(_LAUNCH, 0)
