"""Wrappers of the hand-written CUDA walk-transition kernels.

Three kernels, each in ``repro_torch/csrc/`` (built by
``repro_torch.kernels._build``, loaded with ctypes), each replacing a TPU
kernel of ``repro/kernels/walk_transition/kernel.py``:

* :func:`walk_transition_ragged` (``walk_transition_ragged.cu``) — the
  fused MHLJ step on the flat CSR (ragged layout);
* :func:`walk_transition_sparse` (``walk_transition_sparse.cu``) — the MH
  CDF inversion over gathered ``(W, width)`` tiles (sparse layout, and the
  tile op of the bucketed dispatch :func:`walk_transition_bucketed` /
  :func:`walk_transition_bucketed_compacted`, which are host code);
* :func:`walk_transition` (``walk_transition_dense.cu``) — the fused MHLJ
  step over the resident ``(n, max_deg)`` tables (dense layout).

For CUDA tensors a wrapper launches its kernel on the current stream or
raises; for CPU tensors it runs the plain version from
:mod:`repro_torch.kernels.walk_transition.ref`.  Each wrapper's
``launches`` attribute counts its kernel launches
(``kernels._launch.counted``; under a replayed CUDA graph
``repro_torch.core.scan`` keeps it equal to the launches the card ran).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import (
    MAX_NNZ,
    combine_bucketed,
    num_uniforms,
    scatter_compacted,
)
from repro_torch.core.levy import icdf_constants
from repro_torch.kernels._launch import F, I, P, counted, launch
from repro_torch.kernels._launch import check as _check
from repro_torch.kernels._launch import device_of as _device
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels.walk_transition.ref import (
    walk_transition_ragged_ref,
    walk_transition_ref,
    walk_transition_sparse_ref,
)
from repro_torch.utils.kernel_bounds import walk_step_work
from repro_torch.utils.op_cost import priced

__all__ = [
    "walk_transition",
    "walk_transition_sparse",
    "walk_transition_bucketed",
    "walk_transition_bucketed_compacted",
    "walk_transition_ragged",
]

_ARGTYPES = {
    # nodes, indptr, degrees, indices, edge_cdf, uniforms, den, next, hops,
    # W, r, z, group, stream
    "walk_transition_ragged": [P] * 9 + [I, I, F, I, P],
    # rows, neigh_rows, u_mh, live, v_mh, W, width, stream
    "walk_transition_sparse": [P] * 5 + [I, I, P],
    # nodes, row_probs, neighbors, degrees, uniforms, den, next, hops,
    # W, max_deg, r, z, stream
    "walk_transition_dense": [P] * 8 + [I, I, I, F, P],
}

# Lanes a walk of the ragged kernel, and the widths it is built for;
# chip_smoke.py times every one of them at the main path's shapes.
RAGGED_GROUP = 32
RAGGED_GROUPS = (4, 8, 16, 32)

# float32 log(1 - p_d), computed once per (device, 1 - p_d) on the device
_DEN: dict = {}


def _launch(name: str, *args) -> None:
    launch(name, _ARGTYPES[name], *args)


def _levy_constants(device, p_d: float, r: int) -> tuple:
    """``(z, den)``: the float32 ``1 - (1-p_d)^r`` and a (1,) device tensor
    holding PyTorch's float32 ``log(1 - p_d)`` (the plain version's op)."""
    z32, q32 = icdf_constants(p_d, r)
    key = (device, q32)
    den = _DEN.get(key)
    if den is None:
        den = torch.log(torch.full((1,), q32, dtype=torch.float32, device=device))
        _DEN[key] = den
    return z32, den


def _check_uniforms(uniforms, w: int, r: int) -> None:
    if tuple(uniforms.shape) != (w, num_uniforms(r)):
        raise ValueError(
            f"uniforms must be ({w}, {num_uniforms(r)}), got "
            f"{tuple(uniforms.shape)}"
        )


@counted
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
    both (W,) int32.  ``max_degree`` sets the plain version's probe count
    (``engine.search_iters``); the kernel, a group of
    :data:`RAGGED_GROUP` lanes a walk, searches each segment in rounds of
    that many probes and needs no bound."""
    return priced(
        "walk_transition_ragged",
        lambda: walk_step_work(nodes.shape[0], max_degree, r),
        lambda: _ragged(nodes, indptr, degrees, indices, edge_cdf, uniforms,
                        p_d=p_d, r=r, max_degree=max_degree),
        lambda: (torch.empty_like(nodes), torch.empty_like(nodes)), nodes)


def _ragged(nodes, indptr, degrees, indices, edge_cdf, uniforms, *, p_d, r,
            max_degree) -> tuple:
    device = _device(nodes, indptr, degrees, indices, edge_cdf, uniforms)
    if device.type == "cpu":
        return walk_transition_ragged_ref(
            nodes, indptr, degrees, indices, edge_cdf, uniforms,
            p_d=p_d, r=r, max_degree=max_degree,
        )
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
    _check_uniforms(uniforms, w, r)
    z32, den = _levy_constants(device, p_d, r)
    next_nodes = torch.empty(w, dtype=torch.int32, device=device)
    hops = torch.empty(w, dtype=torch.int32, device=device)
    if w == 0:
        return next_nodes, hops
    _launch(
        "walk_transition_ragged",
        nodes.data_ptr(), indptr.data_ptr(), degrees.data_ptr(),
        indices.data_ptr(), edge_cdf.data_ptr(), uniforms.data_ptr(),
        den.data_ptr(), next_nodes.data_ptr(), hops.data_ptr(),
        w, r, z32, RAGGED_GROUP, _stream(device),
    )
    walk_transition_ragged.launches += 1
    return next_nodes, hops


@counted
def walk_transition_sparse(
    rows: torch.Tensor,  # (W, width) float32 — the W walks' P_IS rows
    neigh_rows: torch.Tensor,  # (W, width) int32 — their padded neighbor rows
    u_mh: torch.Tensor,  # (W,) float32 — the U_MH uniform per walk
    live: Optional[torch.Tensor] = None,  # 0-d bool gate on the device
) -> torch.Tensor:
    """The MH move for W walks from gathered tiles: per walk the index of
    ``u_mh · total`` in the row's CDF (row-CDF rule), clamped to
    ``width - 1``, and the neighbor there.  Rows must be non-negative.
    Where the device flag ``live`` is False the kernel reads no tile and
    every pick is 0 (the gated branch of a captured dispatch).  Returns
    ``v_mh`` (W,) int32."""
    return priced(
        "walk_transition_sparse",
        lambda: walk_step_work(rows.shape[0], rows.shape[1], 0),
        lambda: _sparse(rows, neigh_rows, u_mh, live),
        lambda: torch.empty(rows.shape[0], dtype=torch.int32,
                            device=rows.device), rows)


def _sparse(rows, neigh_rows, u_mh, live) -> torch.Tensor:
    tensors = (rows, neigh_rows, u_mh) + (() if live is None else (live,))
    device = _device(*tensors)
    if device.type == "cpu":
        return walk_transition_sparse_ref(rows, neigh_rows, u_mh, live=live)
    _check("rows", rows, torch.float32, 2)
    _check("neigh_rows", neigh_rows, torch.int32, 2)
    _check("u_mh", u_mh, torch.float32, 1)
    if live is not None:
        _check("live", live, torch.bool, 0)
    w, width = rows.shape
    if tuple(neigh_rows.shape) != (w, width) or u_mh.shape[0] != w:
        raise ValueError(
            f"rows {tuple(rows.shape)}, neigh_rows "
            f"{tuple(neigh_rows.shape)} and u_mh {tuple(u_mh.shape)} disagree"
        )
    if width < 1:
        raise ValueError("rows must have at least one column")
    v_mh = torch.empty(w, dtype=torch.int32, device=device)
    if w == 0:
        return v_mh
    _launch(
        "walk_transition_sparse",
        rows.data_ptr(), neigh_rows.data_ptr(), u_mh.data_ptr(),
        None if live is None else live.data_ptr(), v_mh.data_ptr(), w, width,
        _stream(device),
    )
    walk_transition_sparse.launches += 1
    return v_mh


def walk_transition_bucketed(
    bucket_ids: torch.Tensor,  # (W,) int32 — degree bucket of each walk
    rows_by_bucket,  # tuple of (W, width_b) float32 P_IS tiles
    tiles_by_bucket,  # tuple of (W, width_b) int32 neighbor tiles
    u_mh: torch.Tensor,  # (W,) float32
    live: Optional[torch.Tensor] = None,  # 0-d bool gate of every pass
) -> torch.Tensor:
    """The bucketed MH move: one :func:`walk_transition_sparse` pass per
    bucket at its width over all W walks; walk w keeps the result of
    bucket ``bucket_ids[w]`` (``engine.combine_bucketed``).  ``live``
    gates every pass.  Returns ``v_mh`` (W,)."""
    return combine_bucketed(
        bucket_ids,
        [
            walk_transition_sparse(rows, tiles, u_mh, live)
            for rows, tiles in zip(rows_by_bucket, tiles_by_bucket)
        ],
    )


def walk_transition_bucketed_compacted(
    rows_by_bucket,  # tuple of (cap_b, width_b) float32 compacted P_IS tiles
    tiles_by_bucket,  # tuple of (cap_b, width_b) int32 compacted tiles
    u_by_bucket,  # tuple of (cap_b,) float32 — U_MH uniform per lane
    walk_idx_by_bucket,  # tuple of (cap_b,) int32 — original walk index
    valid_by_bucket,  # tuple of (cap_b,) bool — lane holds a real walk
    num_walks: int,
    live: Optional[torch.Tensor] = None,  # 0-d bool gate of every pass
) -> torch.Tensor:
    """The compacted bucketed MH move: one :func:`walk_transition_sparse`
    pass per bucket over its ``cap_b`` lanes only, scattered back to walk
    order (``engine.scatter_compacted``, slop lanes dropped).  ``live``
    gates every pass.  Returns ``v_mh`` (num_walks,)."""
    return scatter_compacted(
        num_walks,
        walk_idx_by_bucket,
        valid_by_bucket,
        [
            walk_transition_sparse(rows, tiles, u_b, live)
            for rows, tiles, u_b in zip(
                rows_by_bucket, tiles_by_bucket, u_by_bucket
            )
        ],
    )


@counted
def walk_transition(
    nodes: torch.Tensor,  # (W,) int32
    row_probs: torch.Tensor,  # (n, max_deg) float32, pads exactly 0
    neighbors: torch.Tensor,  # (n, max_deg) int32, pads = row id
    degrees: torch.Tensor,  # (n,) int32
    uniforms: torch.Tensor,  # (W, 3 + r) float32, slot 0 = jump flag
    *,
    p_d: float,
    r: int,
) -> tuple:
    """The fused MHLJ step on the resident padded tables (dense layout):
    the MH inversion of row v's CDF, r Lévy hops through the neighbor
    table, the combine.  Rows must be non-negative with exactly-zero pads
    (the padded-row convention).  Returns ``(next_nodes, hops)``, both
    (W,) int32."""
    return priced(
        "walk_transition",
        lambda: walk_step_work(nodes.shape[0], neighbors.shape[1], r),
        lambda: _dense(nodes, row_probs, neighbors, degrees, uniforms,
                       p_d=p_d, r=r),
        lambda: (torch.empty_like(nodes), torch.empty_like(nodes)), nodes)


def _dense(nodes, row_probs, neighbors, degrees, uniforms, *, p_d,
           r) -> tuple:
    device = _device(nodes, row_probs, neighbors, degrees, uniforms)
    if device.type == "cpu":
        return walk_transition_ref(
            nodes, row_probs, neighbors, degrees, uniforms, p_d=p_d, r=r
        )
    for name, t, dtype, ndim in (
        ("nodes", nodes, torch.int32, 1),
        ("row_probs", row_probs, torch.float32, 2),
        ("neighbors", neighbors, torch.int32, 2),
        ("degrees", degrees, torch.int32, 1),
        ("uniforms", uniforms, torch.float32, 2),
    ):
        _check(name, t, dtype, ndim)
    w = nodes.shape[0]
    n, max_deg = neighbors.shape
    if tuple(row_probs.shape) != (n, max_deg) or degrees.shape[0] != n:
        raise ValueError("row_probs/neighbors/degrees shapes disagree")
    _check_uniforms(uniforms, w, r)
    z32, den = _levy_constants(device, p_d, r)
    next_nodes = torch.empty(w, dtype=torch.int32, device=device)
    hops = torch.empty(w, dtype=torch.int32, device=device)
    if w == 0:
        return next_nodes, hops
    _launch(
        "walk_transition_dense",
        nodes.data_ptr(), row_probs.data_ptr(), neighbors.data_ptr(),
        degrees.data_ptr(), uniforms.data_ptr(), den.data_ptr(),
        next_nodes.data_ptr(), hops.data_ptr(), w, max_deg, r, z32,
        _stream(device),
    )
    walk_transition.launches += 1
    return next_nodes, hops
