"""The Mamba-2 SSD scan through the hand-written CUDA kernel ``csrc/ssd_scan.cu``.

:func:`ssd_scan` replaces the TPU kernel
``repro/kernels/ssd/kernel.py::ssd_scan``: the chunked SSD in the
head-major layout, with the (N, P) float32 state carried across chunks
(one persistent CTA per (b, h) walks its chunks in order).  x, B and C
may be float32 or bfloat16, da and dt are float32, y is float32, and
``L % chunk == 0``.  For CUDA tensors it launches the kernel or raises;
for CPU tensors it runs :func:`~repro_torch.kernels.ssd.ref.ssd_scan_ref`.
``ssd_scan.launches`` counts kernel launches.

:func:`ssd` is the model-layout wrapper (the JAX package's ``ops.ssd``):
the layout change, the group repeat, ``da = dt * a``, and the padding to
a chunk multiple with zero rows (zero ``dt`` and ``da`` leave the state
unchanged, and the padded outputs are cut off).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._launch import I, P, check, device_of, launch, stream
from repro_torch.kernels.ssd.ref import ssd_ref, ssd_scan_ref

__all__ = ["ssd", "ssd_scan", "ssd_oracle", "MAX_STATE", "MAX_HEAD_DIM"]

# x, da, dt, B, C, y, batch*heads, L, P, N, chunk, is_bf16, stream
_ARGTYPES = (P, P, P, P, P, P, I, I, I, I, I, I, P)
DTYPES = (torch.float32, torch.bfloat16)
# the kernel's register tiles: at most 64 head channels and 128 states
MAX_HEAD_DIM, MAX_STATE = 64, 128


def ssd_scan(xs, da, dt, bs, cs, *, chunk: int) -> torch.Tensor:
    """y (B, H, L, P) float32 of the chunked SSD, head-major inputs."""
    device = device_of(xs, da, dt, bs, cs)
    if device.type == "cpu":
        return ssd_scan_ref(xs, da, dt, bs, cs, chunk=chunk)
    check("xs", xs, DTYPES, 4)
    check("da", da, torch.float32, 3)
    check("dt", dt, torch.float32, 3)
    check("bs", bs, xs.dtype, 4)
    check("cs", cs, xs.dtype, 4)
    b, h, l, p = xs.shape
    n = bs.shape[-1]
    if tuple(da.shape) != (b, h, l) or tuple(dt.shape) != (b, h, l):
        raise ValueError("da/dt must be (B, H, L)")
    if tuple(bs.shape) != (b, h, l, n) or tuple(cs.shape) != (b, h, l, n):
        raise ValueError("bs/cs must be (B, H, L, N)")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"L={l} must be a multiple of chunk={chunk}")
    if not (0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE and n % 16 == 0):
        raise ValueError(f"head_dim {p} / d_state {n}: the kernel takes head_dim "
                         f"<= {MAX_HEAD_DIM} and d_state <= {MAX_STATE}, a "
                         "multiple of 16")
    y = torch.empty((b, h, l, p), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return y
    launch(
        "ssd_scan", _ARGTYPES, xs.data_ptr(), da.data_ptr(), dt.data_ptr(),
        bs.data_ptr(), cs.data_ptr(), y.data_ptr(), b * h, l, p, n, chunk,
        int(xs.dtype == torch.bfloat16), stream(device),
    )
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0


def _head_major(xs, dt, a, bs, cs):
    rep = xs.shape[2] // bs.shape[2]
    xs_k = xs.transpose(1, 2).contiguous()  # (B,H,L,P)
    dt_k = dt.transpose(1, 2).contiguous()  # (B,H,L)
    da_k = dt_k * a[None, :, None]
    bs_k = bs.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    cs_k = cs.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    return xs_k, da_k, dt_k, bs_k, cs_k


def ssd(xs, dt, a, bs, cs, chunk: int = 128):
    """Model layout: xs (B, L, H, P), dt (B, L, H) post-softplus, a (H,)
    negative decay rates, bs/cs (B, L, G, N).  Returns ``(y (B, L, H, P)
    float32, None)``, as ``layers.mamba2.ssd_chunked`` does."""
    l = xs.shape[1]
    xs_k, da_k, dt_k, bs_k, cs_k = _head_major(xs, dt, a, bs, cs)
    pad = (-l) % chunk
    if pad:
        xs_k, bs_k, cs_k = (F.pad(t, (0, 0, 0, pad)) for t in (xs_k, bs_k, cs_k))
        da_k, dt_k = (F.pad(t, (0, pad)) for t in (da_k, dt_k))
    y = ssd_scan(xs_k, da_k, dt_k, bs_k, cs_k, chunk=chunk)
    return y[:, :, :l].transpose(1, 2), None


def ssd_oracle(xs, dt, a, bs, cs) -> torch.Tensor:
    """Model-layout oracle (the exact recurrence), y (B, L, H, P)."""
    return ssd_ref(*_head_major(xs, dt, a, bs, cs)).transpose(1, 2)
