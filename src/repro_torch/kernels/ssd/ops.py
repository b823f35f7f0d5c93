"""The Mamba-2 SSD scan through the port's hand-written CUDA kernels.

:func:`ssd_scan` replaces the TPU kernel
``repro/kernels/ssd/kernel.py::ssd_scan``: the chunked SSD in the
head-major layout, with the (N, P) float32 state carried across chunks.
As the reference's kernel does, it takes x, B and C in float32, bfloat16
or float16 at any head_dim and d_state >= 1, da and dt in any of those
types (cast once to float32 here, as the reference's kernel casts them
first), and gives y in float32; ``L % chunk == 0``.

Two routes, chosen by :func:`route_of` before any launch:

- ``mma_bf16``: bfloat16 and float16 at head_dim 64, d_state 64 or 128
  and chunk 64, 128 or 256, with x, B and C 16-byte aligned (cp.async),
  through ``csrc/ssd_scan_mma.cu``: chunk-parallel on the tensor cores
  (``mma.sync``), in three launches (chunk states, the state pass over a
  ``(B, H, L/chunk, N, P)`` float32 scratch that the wrapper allocates,
  the output).  float16 launches ride this route's name and counter.
  The kernel splits its float32 operands (B (.) w, the entering state,
  att) into 16-bit hi + lo; in float16 it scales each operand block by a
  power of two around the split, so an operand's error is at most 2^-22
  of its block's largest magnitude (2^-38 absolute for a block under 2)
  and float16 has no range limit short of float32's.
- ``mma_tf32``: every other input, through ``csrc/ssd_scan.cu``:
  chunk-parallel on the tensor cores in split TF32 (``mma.sync`` m16n8k8),
  in the same three launches over a float32 scratch the wrapper allocates
  (the chunk states, their decays and the chunk cumsums: the C side's
  ``ssd_scan_scratch_floats``).  Any head_dim and d_state >= 1 (in slabs
  of 64 channels and k-tiles of 64 states), any base, a chunk of at most
  39,680 rows.  float32 operands are split into two TF32 parts (three
  products a product, four for att @ x); bf16 and float16 x, B and C are
  exact in TF32 and unsplit.  Its bound: the operations at a third of
  TF32's rate in float32 (``kernel_bounds.ssd_ops_per_s``), the bytes in
  16 bits.

For CUDA tensors :func:`ssd_scan` launches the route's kernels or raises
(also when an input requires grad while gradients are recorded: the
kernels have no backward); for CPU tensors it runs :func:`~repro_torch.kernels.ssd.ref.ssd_scan_ref`.
``ssd_scan.launches`` counts calls that launched (one per call, whatever
the route launches inside), ``ssd_scan.launches_by_route`` the same per
route.

:func:`ssd` is the model-layout wrapper (the JAX package's ``ops.ssd``):
the layout change, the group repeat, ``da = dt * a``, and the padding to
a chunk multiple with zero rows (zero ``dt`` and ``da`` leave the state
unchanged, and the padded outputs are cut off).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._launch import (
    I, P, check, device_of, forward_only, launch, query, stream,
)
from repro_torch.kernels.ssd.ref import ssd_ref, ssd_scan_ref
from repro_torch.utils.kernel_bounds import ssd_bound
from repro_torch.utils.op_cost import priced

__all__ = ["ssd", "ssd_scan", "ssd_oracle", "route_of", "ROUTES"]

# dtype -> the C side's code (csrc/ssd_scan.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# route -> (library, C argument types)
_LAUNCH = {
    # x, da, dt, B, C, y, states, decay, batch*heads, L, P, N, chunk,
    # is_half, stream
    "mma_bf16": ("ssd_scan_mma", (P,) * 8 + (I,) * 6 + (P,)),
    # x, da, dt, B, C, y, scratch, batch*heads, L, P, N, chunk, dtype,
    # stream
    "mma_tf32": ("ssd_scan", (P,) * 7 + (I,) * 6 + (P,)),
}
ROUTES = tuple(_LAUNCH)
# the shapes csrc/ssd_scan_mma.cu takes, in bfloat16 or float16
MMA_HEAD_DIM, MMA_STATES, MMA_CHUNKS = 64, (64, 128), (64, 128, 256)


def route_of(dtype: torch.dtype, p: int, n: int, chunk: int,
             aligned: bool = True) -> str:
    """The kernel route for x, B and C of ``dtype`` at head_dim ``p``,
    d_state ``n`` and ``chunk``, from bases that are 16-byte ``aligned``
    or not: ``"mma_bf16"`` for the bfloat16 and float16 shapes
    ``csrc/ssd_scan_mma.cu`` takes from aligned bases (cp.async copies
    16-byte pieces), else ``"mma_tf32"``; raise on a dtype the
    reference's kernel never sees (float64 with JAX's x64 off,
    integers)."""
    if dtype not in DTYPES:
        raise TypeError(f"the SSD scan takes {tuple(DTYPES)}, got {dtype}")
    if (dtype != torch.float32 and p == MMA_HEAD_DIM and n in MMA_STATES
            and chunk in MMA_CHUNKS and aligned):
        return "mma_bf16"
    return "mma_tf32"


def ssd_scan(xs, da, dt, bs, cs, *, chunk: int) -> torch.Tensor:
    """y (B, H, L, P) float32 of the chunked SSD, head-major inputs."""
    b, h, l, p = xs.shape
    return priced(
        "ssd_scan",
        lambda: ssd_bound(b, h, l, p, bs.shape[-1], chunk, xs.element_size(),
                          bs.shape[1]),
        lambda: _ssd_scan(xs, da, dt, bs, cs, chunk),
        lambda: torch.empty(xs.shape, dtype=torch.float32, device=xs.device),
        xs, da, dt, bs, cs)


def _ssd_scan(xs, da, dt, bs, cs, chunk: int) -> torch.Tensor:
    device = device_of(xs, da, dt, bs, cs)
    p, n = xs.shape[-1], bs.shape[-1]
    if p < 1 or n < 1:  # on either device
        raise ValueError(f"head_dim {p} / d_state {n}: the scan needs both "
                         ">= 1")
    if device.type == "cpu":
        return ssd_scan_ref(xs, da, dt, bs, cs, chunk=chunk)
    forward_only("ssd_scan", xs, da, dt, bs, cs)
    check("xs", xs, tuple(DTYPES), 4)
    check("da", da, tuple(DTYPES), 3)
    check("dt", dt, tuple(DTYPES), 3)
    check("bs", bs, xs.dtype, 4)
    check("cs", cs, xs.dtype, 4)
    # the kernels read da and dt as float32, as the TPU kernel casts them
    da, dt = da.float(), dt.float()
    b, h, l, _ = xs.shape
    if tuple(da.shape) != (b, h, l) or tuple(dt.shape) != (b, h, l):
        raise ValueError("da/dt must be (B, H, L)")
    if tuple(bs.shape) != (b, h, l, n) or tuple(cs.shape) != (b, h, l, n):
        raise ValueError("bs/cs must be (B, H, L, N)")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"L={l} must be a multiple of chunk={chunk}")
    route = route_of(xs.dtype, p, n, chunk,
                     all(t.data_ptr() % 16 == 0 for t in (xs, bs, cs)))
    y = torch.empty((b, h, l, p), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return y
    ptrs = [t.data_ptr() for t in (xs, da, dt, bs, cs, y)]
    if route == "mma_bf16":
        nc = l // chunk
        states = torch.empty((b, h, nc, n, p), dtype=torch.float32,
                             device=device)
        decay = torch.empty((b, h, nc), dtype=torch.float32, device=device)
        args = ptrs + [states.data_ptr(), decay.data_ptr(),
                       b * h, l, p, n, chunk, int(xs.dtype == torch.float16)]
    else:
        # the chunk states, decays and cumsums (-1: a chunk too long)
        floats = query("ssd_scan", "ssd_scan_scratch_floats", (I,) * 5,
                       ctypes.c_longlong, b * h, l, p, n, chunk)
        if floats < 0:
            raise ValueError(f"chunk {chunk}: too long for the kernel's shared "
                             "memory (at most 39,680 rows)")
        scratch = torch.empty(floats, dtype=torch.float32, device=device)
        args = ptrs + [scratch.data_ptr(), b * h, l, p, n, chunk,
                       DTYPES[xs.dtype]]
    library, argtypes = _LAUNCH[route]
    launch(library, argtypes, *args, stream(device))
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[route] += 1
    return y


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)


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
    if device_of(xs, dt, a, bs, cs).type == "cuda":
        forward_only("ssd_scan", xs, dt, a, bs, cs)
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
