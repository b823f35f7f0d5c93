"""Wrapper of the hand-written CUDA kernel ``walk_transition_ragged``.

Source: ``repro_torch/csrc/walk_transition_ragged.cu`` (built by
``repro_torch.kernels._build``, loaded with ctypes).  It replaces the TPU
kernel ``repro/kernels/walk_transition/kernel.py::walk_transition_ragged``.

For CUDA tensors the wrapper launches the kernel on the current stream or
raises; for CPU tensors it runs the plain version
(:func:`~repro_torch.kernels.walk_transition.ref.walk_transition_ragged_ref`).
``walk_transition_ragged.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.engine import MAX_NNZ, num_uniforms, search_iters
from repro_torch.core.levy import icdf_constants
from repro_torch.kernels import _build
from repro_torch.kernels.walk_transition.ref import walk_transition_ragged_ref

__all__ = ["walk_transition_ragged"]

_ARGTYPES = [ctypes.c_void_p] * 9 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]

# float32 log(1 - p_d), computed once per (device, 1 - p_d) on the device
_DEN: dict = {}


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("walk_transition_ragged")
    fn = lib.walk_transition_ragged_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, ndim):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def walk_transition_ragged(
    nodes: torch.Tensor,  # (W,) int32
    indptr: torch.Tensor,  # (n+1,) int32 CSR row pointers
    degrees: torch.Tensor,  # (n,) int32
    indices: torch.Tensor,  # (nnz,) int32 CSR neighbor ids
    edge_cdf: torch.Tensor,  # (nnz,) float32 flat per-edge CDF
    uniforms: torch.Tensor,  # (W, 3 + r) float32, slot 0 = jump flag
    *,
    p_d: float,
    r: int,
    max_degree: int,
) -> tuple:
    """The fused MHLJ step on the flat CSR; returns ``(next_nodes, hops)``,
    both (W,) int32.  ``max_degree`` sets the binary search's probe count
    (``engine.search_iters``)."""
    tensors = (nodes, indptr, degrees, indices, edge_cdf, uniforms)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return walk_transition_ragged_ref(
            nodes, indptr, degrees, indices, edge_cdf, uniforms,
            p_d=p_d, r=r, max_degree=max_degree,
        )
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t, dtype, ndim in (
        ("nodes", nodes, torch.int32, 1),
        ("indptr", indptr, torch.int32, 1),
        ("degrees", degrees, torch.int32, 1),
        ("indices", indices, torch.int32, 1),
        ("edge_cdf", edge_cdf, torch.float32, 1),
        ("uniforms", uniforms, torch.float32, 2),
    ):
        _check(name, t, dtype, ndim)
    w, n, nnz = nodes.shape[0], degrees.shape[0], indices.shape[0]
    if nnz > MAX_NNZ:
        raise ValueError(f"nnz={nnz} exceeds the int32 index range")
    if indptr.shape[0] != n + 1 or edge_cdf.shape[0] != nnz:
        raise ValueError("indptr/degrees/indices/edge_cdf sizes disagree")
    if tuple(uniforms.shape) != (w, num_uniforms(r)):
        raise ValueError(
            f"uniforms must be ({w}, {num_uniforms(r)}), got "
            f"{tuple(uniforms.shape)}"
        )
    z32, q32 = icdf_constants(p_d, r)
    key = (device, q32)
    den = _DEN.get(key)
    if den is None:
        den = torch.log(torch.full((1,), q32, dtype=torch.float32, device=device))
        _DEN[key] = den
    next_nodes = torch.empty(w, dtype=torch.int32, device=device)
    hops = torch.empty(w, dtype=torch.int32, device=device)
    if w == 0:
        return next_nodes, hops
    err = _launcher()(
        nodes.data_ptr(), indptr.data_ptr(), degrees.data_ptr(),
        indices.data_ptr(), edge_cdf.data_ptr(), uniforms.data_ptr(),
        den.data_ptr(), next_nodes.data_ptr(), hops.data_ptr(),
        w, r, z32, search_iters(max_degree),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"walk_transition_ragged launch failed with CUDA error {err}"
        )
    walk_transition_ragged.launches += 1
    return next_nodes, hops


walk_transition_ragged.launches = 0
