"""Plain PyTorch versions of the Mamba-2 SSD chunked-scan kernel.

Head-major layout throughout: xs (B, H, L, P), da and dt (B, H, L), bs and
cs (B, H, L, N) (groups already expanded to heads).

* :func:`ssd_scan_ref` is the kernel's own algorithm — the per-chunk body
  of ``repro/kernels/ssd/kernel.py`` (``_kernel``) over all (b, h) at
  once, with the (N, P) state carried from chunk to chunk;
* :func:`ssd_ref` is the exact sequential recurrence, the test oracle.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(xs, da, dt, bs, cs, *, chunk: int) -> torch.Tensor:
    """Chunked SSD; returns y (B, H, L, P) in float32 (float64 for float64
    inputs, an exact-arithmetic yardstick).  ``L % chunk == 0``."""
    b, h, l, p = xs.shape
    n = bs.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} must be a multiple of chunk={chunk}")
    work = torch.float64 if xs.dtype == torch.float64 else torch.float32
    state = torch.zeros((b, h, n, p), dtype=work, device=xs.device)
    y = torch.empty((b, h, l, p), dtype=work, device=xs.device)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device).tril()
    for c0 in range(0, l, chunk):
        sl = slice(c0, c0 + chunk)
        x = xs[:, :, sl].to(work)  # (B,H,Q,P)
        dtc = dt[:, :, sl].to(work)  # (B,H,Q)
        bb = bs[:, :, sl].to(work)  # (B,H,Q,N)
        cc = cs[:, :, sl].to(work)
        cum = torch.cumsum(da[:, :, sl].to(work), dim=-1)  # (B,H,Q)
        # intra-chunk: att[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
        scores = cc @ bb.transpose(-1, -2)  # (B,H,Q,Q)
        decay = torch.exp(cum[..., :, None] - cum[..., None, :])
        att = torch.where(causal, scores * decay, 0.0) * dtc[..., None, :]
        yc = att @ x
        # inter-chunk: the carried state's contribution
        yc = yc + torch.exp(cum)[..., None] * (cc @ state)
        # state update
        tail = torch.exp(cum[..., -1:] - cum) * dtc  # (B,H,Q)
        state = torch.exp(cum[..., -1])[..., None, None] * state + (
            (bb * tail[..., None]).transpose(-1, -2) @ x
        )
        y[:, :, sl] = yc
    return y


def ssd_ref(xs, da, dt, bs, cs) -> torch.Tensor:
    """Exact sequential recurrence; returns y (B, H, L, P) float32."""
    b, h, l, p = xs.shape
    n = bs.shape[-1]
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(l):
        x_t, b_t, c_t = (a[:, :, t].float() for a in (xs, bs, cs))
        decay = torch.exp(da[:, :, t].float())
        state = decay[..., None, None] * state + (
            dt[:, :, t].float()[..., None, None] * b_t[..., None] * x_t[..., None, :]
        )
        ys.append(torch.einsum("bhn,bhnp->bhp", c_t, state))
    return torch.stack(ys, dim=2)
