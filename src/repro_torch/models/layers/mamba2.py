"""Mamba-2 (SSD, state-space duality) mixer layer [arXiv:2405.21060].

Selective state space with scalar-per-head decay:
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T        (state: (H, N, P))
    y_t = C_t h_t + D * x_t

The full sequence uses the chunked SSD formulation (quadratic within
chunks of length Q, linear state passing across chunks): in PyTorch here
(:func:`ssd_chunked`), or with ``use_kernel`` through the hand-written
CUDA kernel ``ssd_scan`` (``repro_torch.kernels.ssd.ops.ssd``).  Decode is
the O(1) single-step recurrence.  :func:`ssd_reference` (the exact
sequential scan) is the oracle of the tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.model_utils import normal
from repro_torch.sharding.constraints import (
    aligned_to, constrain, is_dtensor, local_call, placements_of,
)
from repro_torch.utils.kernel_bounds import ssd_bound
from repro_torch.utils.op_cost import priced

__all__ = [
    "MambaDims",
    "mamba_init",
    "mamba_apply",
    "mamba_decode",
    "init_mamba_cache",
    "ssd_chunked",
    "ssd_reference",
]


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_state: int  # N
    num_heads: int  # H
    head_dim: int  # P  (d_inner = H * P)
    num_groups: int = 1  # G (B/C shared per group)
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.num_groups * self.d_state


def mamba_init(dims: MambaDims, dtype, device, generator) -> dict:
    """The JAX package's init law; ``a_log``, ``d_skip`` and ``dt_bias``
    stay float32 whatever the model dtype."""
    d = dims.d_model
    proj_out = dims.d_inner + dims.conv_channels + dims.num_heads  # z, conv-in, dt
    u = torch.rand((dims.num_heads,), generator=generator, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, proj_out), d**-0.5, dtype, device, generator),
        "conv_w": normal((dims.conv_kernel, dims.conv_channels), 0.1, dtype,
                         device, generator),
        "conv_b": torch.zeros((dims.conv_channels,), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, dims.num_heads + 1, **f32)),
        "d_skip": torch.ones((dims.num_heads,), **f32),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "norm_scale": torch.ones((dims.d_inner,), dtype=dtype, device=device),
        "out_proj": normal((dims.d_inner, d), dims.d_inner**-0.5, dtype, device,
                           generator),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, L, C); w: (K, C).  On a mesh each
    device convolves its channels (``groups`` is the local width): the
    weight and bias follow x's channel shards, the sequence is whole."""
    if is_dtensor(x):
        px = placements_of(x, (0, 2))
        return local_call(
            _causal_conv, (x, w, b),
            (px, aligned_to(px, {2: 1}), aligned_to(px, {2: 0})),
            px, tuple(x.shape))
    k, l = w.shape[0], x.shape[1]
    out = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), b, padding=k - 1,
                   groups=w.shape[1])
    return out[..., :l].transpose(1, 2)


def _split_proj(params, x, dims: MambaDims):
    proj = x @ params["in_proj"]
    return torch.split(proj, [dims.d_inner, dims.conv_channels, dims.num_heads],
                       dim=-1)


def _split_conv_out(conv_out, dims: MambaDims):
    g_n = dims.num_groups * dims.d_state
    xs, bs, cs = torch.split(conv_out, [dims.d_inner, g_n, g_n], dim=-1)
    b, l = conv_out.shape[:2]
    xs = xs.reshape(b, l, dims.num_heads, dims.head_dim)
    bs = bs.reshape(b, l, dims.num_groups, dims.d_state)
    cs = cs.reshape(b, l, dims.num_groups, dims.d_state)
    return xs, bs, cs


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums along ``dim`` as one float64 product with a
    triangle of ones, rounded to ``x``'s dtype: deterministic and the same
    bits on every device, where ``torch.cumsum`` on CUDA is neither (it
    refuses to run under ``torch.use_deterministic_algorithms``); one
    launch, where a scan over the chunk would take one a column."""
    n = x.shape[dim]
    upper = torch.ones((n, n), dtype=torch.float64, device=x.device).triu()
    out = torch.matmul(x.movedim(dim, -1).double(), upper)
    return out.to(x.dtype).movedim(-1, dim)


def ssd_chunked(
    xs: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H)  post-softplus, float32
    a: torch.Tensor,  # (H,) negative decay rates, float32
    bs: torch.Tensor,  # (B, L, G, N)
    cs: torch.Tensor,  # (B, L, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P) initial state
) -> tuple:
    """Chunked SSD; returns (y (B,L,H,P), final_state (B,H,N,P)), float32.

    Heads are laid out as (G, H/G) with head h in group h // (H/G), so B
    and C broadcast over a group's heads instead of being repeated, and
    every contraction is one batched matmul."""
    b, l, h, p = xs.shape
    g, n = bs.shape[2], bs.shape[3]
    pad = (-l) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bs = F.pad(bs, (0, 0, 0, 0, 0, pad))
        cs = F.pad(cs, (0, 0, 0, 0, 0, pad))
    lp = l + pad
    nc, q = lp // chunk, chunk
    rep = h // g

    # (B, NC, G, rep, Q, ...) for the heads, (B, NC, G, 1, Q, N) for B and C
    x_c = xs.reshape(b, nc, q, g, rep, p).permute(0, 1, 3, 4, 2, 5).float()
    dt_c = dt.reshape(b, nc, q, g, rep).permute(0, 1, 3, 4, 2)
    b_c = bs.reshape(b, nc, q, g, 1, n).permute(0, 1, 3, 4, 2, 5).float()
    c_c = cs.reshape(b, nc, q, g, 1, n).permute(0, 1, 3, 4, 2, 5).float()

    da = dt_c * a.reshape(g, rep, 1)  # log-decay increments (<= 0)
    cum = _prefix_sum(da, dim=-1)  # inclusive within chunk

    # intra-chunk: att[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
    scores = c_c @ b_c.transpose(-1, -2)  # (B,NC,G,1,Q,Q)
    mask = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    # exp of the masked (j > i) exponents, which are positive and may
    # overflow, is never taken: an inf there would give the backward pass
    # 0 * inf = nan; the kept entries are the same bits either way
    decay = torch.exp(torch.where(
        mask, cum[..., :, None] - cum[..., None, :], float("-inf")))
    att = torch.where(mask, scores * decay, 0.0) * dt_c[..., None, :]
    y_intra = att @ x_c  # (B,NC,G,rep,Q,P)

    # chunk summary states: S_k = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    tail = torch.exp(cum[..., -1:] - cum) * dt_c  # (B,NC,G,rep,Q)
    s_k = (b_c * tail[..., None]).transpose(-1, -2) @ x_c  # (..., N, P)

    # inter-chunk recurrence, sequential over chunks
    chunk_decay = torch.exp(cum[..., -1])  # (B,NC,G,rep)
    h_state = (torch.zeros((b, g, rep, n, p), dtype=torch.float32,
                           device=xs.device)
               if h0 is None else h0.float().reshape(b, g, rep, n, p))
    h_enter = []
    for c in range(nc):
        h_enter.append(h_state)  # the state entering chunk c
        h_state = chunk_decay[:, c, ..., None, None] * h_state + s_k[:, c]
    h_enter = torch.stack(h_enter, dim=1)  # (B,NC,G,rep,N,P)

    # inter-chunk contribution: y_i += C_i exp(cum_i) H_enter
    y_inter = (c_c * torch.exp(cum)[..., None]) @ h_enter
    y = (y_intra + y_inter).permute(0, 1, 4, 2, 3, 5).reshape(b, lp, h, p)
    return y[:, :l], h_state.reshape(b, h, n, p)


def ssd_reference(xs, dt, a, bs, cs, h0=None) -> tuple:
    """Exact sequential recurrence (oracle).  Same signature minus chunk."""
    b, l, h, p = xs.shape
    rep = h // bs.shape[2]
    n = bs.shape[3]
    bs = bs.repeat_interleave(rep, dim=2).float()
    cs = cs.repeat_interleave(rep, dim=2).float()
    xs = xs.float()
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=xs.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * a[None])  # (B,H)
        contrib = dt[:, t, :, None, None] * bs[:, t, :, :, None] * xs[:, t, :, None, :]
        state = decay[..., None, None] * state + contrib
        ys.append(torch.einsum("bhn,bhnp->bhp", cs[:, t], state))
    return torch.stack(ys, dim=1), state


def _ssd(xs, dt, a, bs, cs, chunk: int, use_kernel: bool) -> torch.Tensor:
    """y (B, L, H, P) float32, contiguous either way: the CUDA SSD scan or
    :func:`ssd_chunked`."""
    if use_kernel:
        from repro_torch.kernels.ssd.ops import ssd

        return ssd(xs, dt, a, bs, cs, chunk=chunk)[0].contiguous()
    return ssd_chunked(xs, dt, a, bs, cs, chunk)[0]


def _ssd_priced(xs, dt, a, bs, cs, chunk: int, use_kernel: bool):
    """:func:`_ssd` as one priced call (``repro_torch.utils.op_cost``): the
    SSD kernel's work at the chunk-padded length whichever path runs."""
    b, l, h, p = xs.shape
    g, n = bs.shape[2], bs.shape[3]
    lp = -(-l // chunk) * chunk
    return priced(
        "ssd_scan",
        lambda: ssd_bound(b, h, lp, p, n, chunk, xs.element_size(), g),
        lambda: _ssd(xs, dt, a, bs, cs, chunk, use_kernel),
        lambda: torch.empty(xs.shape, dtype=torch.float32, device=xs.device),
        xs, dt, a, bs, cs)


def _ssd_local(xs, dt, a, bs, cs, chunk: int, use_kernel: bool):
    """:func:`_ssd_priced` on each device's batch and heads on a mesh; B
    and C follow the heads' split where their groups divide it (one group
    stays whole), else they are repeated to the heads first, so that each
    device's heads read their own groups."""
    if not is_dtensor(xs):
        return _ssd_priced(xs, dt, a, bs, cs, chunk, use_kernel)
    px = placements_of(xs, (0, 2))
    split = math.prod(xs.device_mesh.shape[i] for i, pl in enumerate(px)
                      if getattr(pl, "dim", None) == 2)
    g, h = bs.shape[2], xs.shape[2]
    if split > 1 and g > 1 and g % split:
        bs, cs = (t.repeat_interleave(h // g, dim=2) for t in (bs, cs))
        g = h
    pb = aligned_to(px, {0: 0, 2: 2} if g > 1 else {0: 0})
    return local_call(
        lambda *t: _ssd_priced(*t, chunk, use_kernel), (xs, dt, a, bs, cs),
        (px, aligned_to(px, {0: 0, 2: 2}), aligned_to(px, {2: 0}), pb, pb),
        px, tuple(xs.shape))


def mamba_apply(params, x: torch.Tensor, dims: MambaDims,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence mamba2 block: (B, L, D) -> (B, L, D)."""
    z, conv_in, dt_raw = _split_proj(params, x, dims)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"], params["conv_b"]))
    xs, bs, cs = _split_conv_out(conv_out, dims)
    xs = constrain(xs, ("data", None, "model", None))
    bs = constrain(bs, ("data", None, None, None))
    cs = constrain(cs, ("data", None, None, None))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    dt = constrain(dt, ("data", None, "model"))
    a = -torch.exp(params["a_log"])
    y = _ssd_local(xs, dt, a, bs, cs, dims.chunk, use_kernel)
    y = y + params["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(x.shape[0], x.shape[1], dims.d_inner).to(x.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z))
    return y @ params["out_proj"]


# ---------------------------------------------------------------------------
# Decode path: O(1) recurrent step with a (conv, ssm) cache
# ---------------------------------------------------------------------------


def init_mamba_cache(batch: int, dims: MambaDims, dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, dims.conv_kernel - 1, dims.conv_channels),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, dims.num_heads, dims.d_state, dims.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(params, x: torch.Tensor, cache: dict, dims: MambaDims) -> tuple:
    """One-token step. x: (B, 1, D) -> (B, 1, D) and the new cache."""
    z, conv_in, dt_raw = _split_proj(params, x, dims)  # (B,1,*)
    window = torch.cat([cache["conv"], conv_in.to(cache["conv"].dtype)], dim=1)
    conv_out = (window * params["conv_w"][None]).sum(dim=1, keepdim=True)
    conv_out = F.silu(conv_out + params["conv_b"])
    xs, bs, cs = _split_conv_out(conv_out, dims)  # (B,1,H,P), (B,1,G,N)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])[:, 0]  # (B,H)
    a = -torch.exp(params["a_log"])
    rep = dims.num_heads // dims.num_groups
    b_t = bs[:, 0].repeat_interleave(rep, dim=1).float()  # (B,H,N)
    c_t = cs[:, 0].repeat_interleave(rep, dim=1).float()
    x_t = xs[:, 0].float()  # (B,H,P)

    decay = torch.exp(dt * a[None])  # (B,H)
    h_new = (decay[..., None, None] * cache["ssm"]
             + dt[..., None, None] * b_t[..., None] * x_t[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", c_t, h_new)
    y = y + params["d_skip"][None, :, None] * x_t
    y = y.reshape(x.shape[0], 1, dims.d_inner).to(x.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z))
    out = y @ params["out_proj"]
    return out, {"conv": window[:, 1:], "ssm": h_new}
