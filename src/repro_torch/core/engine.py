"""Batched MHLJ walk engine — Algorithm 1 in PyTorch, on four row layouts.

A transition for W parallel walks consumes a uniform block of shape
``(W, 3 + r)`` with slot layout::

    [jump_flag, mh, distance, hop_1 .. hop_r]
     U_JUMP     U_MH  U_DIST   U_HOP0 ..

Slot ``U_JUMP`` arrives as the {0.0, 1.0} Bernoulli(p_J) flag, resolved
before the transition (so ``p_j`` may be a per-step schedule).  The
layouts (:data:`LAYOUTS`) differ only in how the MH move finds its row:

* ``"sparse"`` gathers the W active ``(W, max_deg)`` P_IS rows and
  neighbor tiles and inverts each row's CDF
  (``kernels.walk_transition.walk_transition_sparse``); the Lévy hops are
  W-wide gathers through the padded neighbor table;
* ``"dense"`` hands the whole ``(n, max_deg)`` table to one fused step
  (``kernels.walk_transition.walk_transition``);
* ``"bucketed"`` runs the same tile inversion once per degree bucket of a
  ``BucketedCSRGraph`` at that bucket's width — by default *compacted*:
  the walks are sorted by bucket and each bucket's pass runs at a static
  capacity (:func:`bucket_capacities`), with the full dispatch taken on
  overflow, chosen on the device; the Lévy hops read the CSR arrays;
* ``"ragged"`` keeps one flat per-edge CDF and binary-searches each
  walk's own segment in one fused step
  (``kernels.walk_transition.walk_transition_ragged``).

Every kernel wrapper launches its CUDA kernel for CUDA tensors (or
raises) and runs its plain PyTorch version for CPU tensors.  A step reads
nothing from the device on the host, so :meth:`WalkEngine.run` is a
device-resident loop that ``repro_torch.core.scan`` captures in CUDA
graphs on the card, as the reference's ``run`` is a ``lax.scan``.

**The row-CDF rule.**  Every CDF over a probability row — the per-edge
CDF, the tile inversion, the dense row, and the self-slot mass of live
Eq.-7 rows — is a sequential, left-to-right float32 accumulation along the
row (:func:`row_cdf`), in the CUDA kernels and in their plain versions
alike.  Pads carry exactly 0 and rows are non-negative, so a row's CDF
does not depend on its padded width, on the device, or on the layout:
the four layouts sample the same walk bit for bit from the same rows.

A ragged engine follows an edge churn without a rebuild:
:meth:`WalkEngine.apply_churn` patches the per-edge CDF segment-locally
(:func:`ragged_edge_cdf_update`) into a new engine.

The engine draws its uniforms from an explicit ``torch.Generator``, or
takes an injected block — the seam the parity tests use to feed both
packages the same numbers.  Every step returns the Remark-1 hop count per
walk (1 for an MH move, d for a Lévy jump).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import scan as scan_mod
from repro_torch.core.graphs import (
    _concat_ranges,
    _ragged_row_chunks,
    flat_edge_values,
)
from repro_torch.core.levy import trunc_geom_icdf

__all__ = [
    "U_JUMP",
    "U_MH",
    "U_DIST",
    "U_HOP0",
    "LAYOUTS",
    "num_uniforms",
    "search_iters",
    "row_cdf",
    "p_is_rows",
    "p_is_rows_block",
    "mh_cdf_invert",
    "ragged_edge_cdf",
    "ragged_edge_cdf_update",
    "ragged_mh_invert",
    "combine_bucketed",
    "bucket_capacities",
    "compact_plan",
    "scatter_compacted",
    "mhlj_transition_math",
    "levy_jump_batched",
    "combine_mh_jump",
    "draw_uniforms",
    "WalkEngine",
]

# Uniform-block slot layout (shared with the CUDA kernels).
U_JUMP, U_MH, U_DIST, U_HOP0 = 0, 1, 2, 3

# Row layouts of the engine (the reference's ``engine.LAYOUTS``).
LAYOUTS = ("sparse", "dense", "bucketed", "ragged")

# int32 index math on the device: the flat buffers must stay below 2^31.
MAX_NNZ = 2**31 - 1


def num_uniforms(r: int) -> int:
    """Columns of the uniform block for jump range ``r``."""
    return U_HOP0 + r


def search_iters(max_degree: int) -> int:
    """Probes of the ragged binary search: ``ceil(log2(max_degree + 1))``."""
    return max(1, math.ceil(math.log2(max_degree + 1)))


def row_cdf(rows: torch.Tensor) -> torch.Tensor:
    """The port's row-CDF rule: inclusive prefix sums along each row of a
    ``(R, width)`` float32 tensor, accumulated left to right one column at
    a time (``cdf[:, j] = cdf[:, j-1] + rows[:, j]``).

    ``torch.cumsum`` is avoided on purpose: its summation order differs
    between the CPU and CUDA builds, and this order is the one the CUDA
    kernels use.  The loop runs over columns, so it costs ``width`` small
    launches; it is on the path only at construction time, or as the plain
    version of a kernel.
    """
    cols = rows.t().contiguous()  # (width, R): each column contiguous
    out = torch.empty_like(cols)
    if cols.shape[0]:
        out[0] = cols[0]
        for j in range(1, cols.shape[0]):
            torch.add(out[j - 1], cols[j], out=out[j])
    return out.t()


def p_is_rows(
    neighbors: torch.Tensor,  # (n, max_deg) int32
    degrees: torch.Tensor,  # (n,) int32
    lipschitz: torch.Tensor,  # (n,) float32
    nodes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """P_IS rows of Eq. (7) over padded neighbor lists, from local info only:
    the full ``(n, max_deg)`` table (``nodes=None``) or the W rows of
    ``nodes``."""
    if nodes is None:
        nodes = torch.arange(
            neighbors.shape[0], dtype=torch.int32, device=neighbors.device
        )
    return p_is_rows_block(
        neighbors[nodes], nodes, degrees[nodes], degrees, lipschitz
    )


def p_is_rows_block(
    nbrs: torch.Tensor,  # (rows, width) padded neighbor block
    self_ids: torch.Tensor,  # (rows,) owning node id per row
    deg_v: torch.Tensor,  # (rows,) true degree per row
    degrees: torch.Tensor,  # (n,) full degree vector (neighbor lookups)
    lipschitz: torch.Tensor,  # (n,) float32
) -> torch.Tensor:
    """Eq.-7 rows in float32 on a padded neighbor block (live rows).

    P(v,u) = min{1/deg(v), L_u / (deg(u) L_v)} for true neighbors u != v;
    leftover mass goes to the self slot, pads carry exactly 0.  The
    leftover is ``1 - Σ move`` with the sum taken by :func:`row_cdf`, so a
    row's bits do not depend on the block's width or on the device.
    """
    deg_vf = deg_v.to(torch.float32)[:, None]
    deg_u = degrees[nbrs].to(torch.float32)
    l_v = lipschitz[self_ids][:, None]
    l_u = lipschitz[nbrs]
    move = torch.minimum(1.0 / deg_vf, l_u / (deg_u * l_v))
    cols = torch.arange(nbrs.shape[1], device=nbrs.device)
    is_pad = cols[None, :] >= deg_v[:, None]
    is_self = (nbrs == self_ids[:, None]) & ~is_pad
    move = torch.where(is_self | is_pad, 0.0, move)
    p_stay = 1.0 - row_cdf(move)[:, -1:]
    probs = torch.where(is_self, p_stay, move)
    return torch.clamp(probs, min=0.0)


def mh_cdf_invert(
    rows: torch.Tensor,  # (W, width) padded probability rows
    neigh_rows: torch.Tensor,  # (W, width) matching padded neighbor rows
    u_mh: torch.Tensor,  # (W,) the U_MH uniform per walk
) -> torch.Tensor:
    """The MH-move CDF inversion over padded rows; returns ``v_mh`` (W,).

    ``idx = count(cdf < u · cdf[-1])`` clamped to ``width - 1``, with the
    CDF from :func:`row_cdf` — the plain version of the tile kernel
    ``walk_transition_sparse``.
    """
    width = rows.shape[1]
    cdf = row_cdf(rows)
    thr = u_mh * cdf[:, -1]
    idx = (cdf < thr[:, None]).sum(dim=1)
    idx = torch.clamp(idx, max=width - 1)
    return torch.gather(neigh_rows, 1, idx[:, None])[:, 0]


def _host(x, dtype) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _rows_cdf(
    ids: np.ndarray,
    deg_ids: np.ndarray,
    device: torch.device,
    *,
    probs: Optional[torch.Tensor] = None,
    nbr_ids: Optional[torch.Tensor] = None,
    lips: Optional[torch.Tensor] = None,
    deg_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The CDF segments of rows ``ids`` (ascending), concatenated in CSR
    edge order: the rows padded to their own longest row, their CDF by
    :func:`row_cdf`, the pad columns stripped.  Row source: the rows' flat
    ``probs``, or live Eq.-7 rows from their neighbor ids ``nbr_ids`` (flat,
    CSR order), ``lips`` and the full degree vector ``deg_t``."""
    cw = int(deg_ids.max())
    deg_c = torch.as_tensor(deg_ids, device=device)
    mask = torch.arange(cw, device=device)[None, :] < deg_c[:, None]
    if probs is not None:
        rows = torch.zeros((ids.size, cw), device=device)
        rows[mask] = probs
    else:
        ids_t = torch.as_tensor(ids.astype(np.int32), device=device)
        nbrs = ids_t[:, None].expand(ids.size, cw).clone()
        nbrs[mask] = nbr_ids
        rows = p_is_rows_block(nbrs, ids_t, deg_t[ids_t], deg_t, lips)
    return row_cdf(rows)[mask]


def ragged_edge_cdf(
    indptr,
    indices,
    degrees,
    *,
    row_probs=None,
    lipschitz=None,
    width: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """The flat per-edge CDF of the ragged layout — (nnz,) float32 on ``device``.

    Entry ``indptr[v] + k`` holds the inclusive CDF prefix of row v at slot
    k, under the row-CDF rule (:func:`row_cdf`) — so it equals the padded
    layouts' CDF of the same row bit for bit, on either device.  Rows are
    materialized on the device in bounded chunks (the reference builder's
    chunks), each chunk only as wide as its own longest row, and stripped
    of their pad columns.

    Row source: ``row_probs``, a flat (nnz,) probability buffer (e.g.
    ``transition.mh_importance_rows_ragged``) or an (n, max_deg) padded
    table, or live Eq.-7 rows from a ``lipschitz`` vector.

    ``width`` is the reference's materialization width (its XLA row sums
    change bits with it, so its churn patches at a recorded width).  Under
    the row-CDF rule a row's bits do not depend on the width it is padded
    to, so here ``width`` is only checked: one below the max degree
    raises, as in the reference.
    """
    indptr_np = np.asarray(indptr, dtype=np.int64)
    deg_np = np.asarray(degrees, dtype=np.int64)
    n, nnz, max_deg = deg_np.size, int(indptr_np[-1]), int(deg_np.max())
    if width is not None and width < max_deg:
        raise ValueError(
            f"width={width} cannot cover max degree {max_deg}; CDF rows "
            "must materialize at least as wide as the longest row"
        )
    device = torch.device(device)
    src = {}
    if row_probs is not None:
        rp = _host(row_probs, np.float32)
        if rp.ndim == 2 and rp.shape == (n, max_deg):
            rp = flat_edge_values(indptr_np, deg_np, rp)
        if rp.shape != (nnz,):
            raise ValueError(
                f"row_probs must be a flat (nnz,)=({nnz},) buffer or an "
                f"(n, max_deg)=({n}, {max_deg}) table, got {rp.shape}"
            )
        flat = torch.as_tensor(rp, device=device)
    elif lipschitz is None:
        raise ValueError(
            "ragged_edge_cdf needs a row source: row_probs (flat buffer or "
            "padded table) or lipschitz"
        )
    else:
        src = dict(lips=torch.as_tensor(_host(lipschitz, np.float32),
                                        device=device),
                   deg_t=torch.as_tensor(deg_np.astype(np.int32),
                                         device=device))
        idx_t = torch.as_tensor(
            np.asarray(indices).astype(np.int32), device=device
        )
    out = torch.empty(nnz, dtype=torch.float32, device=device)
    for ids in _ragged_row_chunks(n, max_deg):
        a, b = int(indptr_np[ids[0]]), int(indptr_np[ids[-1] + 1])
        if src:
            out[a:b] = _rows_cdf(ids, deg_np[ids], device,
                                 nbr_ids=idx_t[a:b], **src)
        else:
            out[a:b] = _rows_cdf(ids, deg_np[ids], device, probs=flat[a:b])
    return out


def ragged_edge_cdf_update(
    old_indptr,
    old_degrees,
    old_edge_cdf,
    new_indptr,
    new_indices,
    new_degrees,
    touched_rows,
    *,
    touched_probs=None,
    lipschitz=None,
    width: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """The flat per-edge CDF after a batch of edge churn — a new (nnz',)
    float32 tensor on ``device`` (default: ``old_edge_cdf``'s, else cuda).

    The segment-local counterpart of :func:`ragged_edge_cdf`: a row not in
    ``touched_rows`` (``graphs.EdgeChurn.touched_rows``) keeps its old CDF
    segment, moved by one device gather ``out[new_pos] = old[old_pos]``
    (the positions built on the host); the touched rows are recomputed in
    bounded chunks by the same ops as :func:`ragged_edge_cdf`.  The old
    buffer is read, never written.

    Under the row-CDF rule a row's bits depend on its values only, not on
    the width it is padded to, so the result equals
    ``ragged_edge_cdf(new_graph)`` bit for bit at any width, on the CPU
    and on the card, whenever the row source gives the same values (live
    Eq.-7 rows from ``lipschitz`` always do).  ``width`` (the reference's
    ``WalkEngine.cdf_width``) is only checked: below the new max degree it
    raises, and the caller escalates to a full rebuild, as
    :meth:`WalkEngine.apply_churn` does.

    Row source of the touched rows, exactly one: ``touched_probs``, a flat
    float32 buffer of ``sum(new_degrees[touched_rows])`` entries in CSR
    edge order (any ``transition.*_rows_ragged(..., node_ids=touched_rows)``),
    or a full-length ``lipschitz`` vector.  Raises, as the reference does,
    when the node count changed, ``touched_rows`` is not unique ascending
    in range, or a row outside it changed degree.
    """
    old_indptr_np = np.asarray(old_indptr, dtype=np.int64)
    deg_old = np.asarray(old_degrees, dtype=np.int64)
    new_indptr_np = np.asarray(new_indptr, dtype=np.int64)
    deg_new = np.asarray(new_degrees, dtype=np.int64)
    touched = np.asarray(touched_rows, dtype=np.int64)
    if device is None:
        device = (old_edge_cdf.device if isinstance(old_edge_cdf, torch.Tensor)
                  else "cuda")
    device = torch.device(device)
    n = deg_new.size
    if deg_old.size != n:
        raise ValueError(
            "node count changed across the churn; apply_edge_churn moves "
            "edges, never nodes"
        )
    if touched.size and (
        np.any(np.diff(touched) <= 0) or touched[0] < 0 or touched[-1] >= n
    ):
        raise ValueError(
            "touched_rows must be unique ascending node ids in range "
            "(EdgeChurn.touched_rows is)"
        )
    if (touched_probs is None) == (lipschitz is None):
        raise ValueError(
            "pass exactly one row source: touched_probs (flat buffer over "
            "the touched rows) or lipschitz (full vector, live Eq.-7 rows)"
        )
    keep = np.ones(n, dtype=bool)
    keep[touched] = False
    keep_ids = np.nonzero(keep)[0]
    if not np.array_equal(deg_old[keep_ids], deg_new[keep_ids]):
        raise ValueError(
            "a row outside touched_rows changed degree; touched_rows must "
            "cover every changed row (use EdgeChurn.touched_rows)"
        )
    max_deg = int(deg_new.max())
    if width is not None and width < max_deg:
        raise ValueError(
            f"width={width} cannot cover the new max degree {max_deg}; "
            "the churn outgrew the old build width — escalate to a full "
            "ragged_edge_cdf rebuild at the wider width"
        )
    old_cdf = torch.as_tensor(old_edge_cdf, dtype=torch.float32).to(device)
    out = torch.empty(int(new_indptr_np[-1]), dtype=torch.float32,
                      device=device)
    new_pos = _concat_ranges(new_indptr_np[keep_ids], deg_new[keep_ids])
    old_pos = _concat_ranges(old_indptr_np[keep_ids], deg_old[keep_ids])
    out[torch.as_tensor(new_pos, device=device)] = old_cdf[
        torch.as_tensor(old_pos, device=device)]
    if touched.size == 0:
        return out
    deg_t = deg_new[touched]
    if lipschitz is not None:
        src = dict(lips=torch.as_tensor(_host(lipschitz, np.float32),
                                        device=device),
                   deg_t=torch.as_tensor(deg_new.astype(np.int32),
                                         device=device))
        idx_t = torch.as_tensor(
            np.asarray(new_indices).astype(np.int32), device=device
        )
    else:
        tp = _host(touched_probs, np.float32)
        expect = int(deg_t.sum())
        if tp.ndim != 1 or tp.shape[0] != expect:
            raise ValueError(
                f"touched_probs must be a flat ({expect},) buffer covering "
                f"the touched rows in CSR edge order, got {tp.shape}"
            )
        tp_t = torch.as_tensor(tp, device=device)
        tp_off = np.concatenate([[0], np.cumsum(deg_t)])
    # the reference's bound on a chunk's transient (rows, width) block
    chunk = max(256, (32 << 20) // max(1, 4 * (width or max_deg)))
    for a in range(0, touched.size, chunk):
        ids, dt = touched[a : a + chunk], deg_t[a : a + chunk]
        pos = torch.as_tensor(
            _concat_ranges(new_indptr_np[ids], dt), device=device)
        if lipschitz is not None:
            out[pos] = _rows_cdf(ids, dt, device, nbr_ids=idx_t[pos], **src)
        else:
            out[pos] = _rows_cdf(
                ids, dt, device,
                probs=tp_t[int(tp_off[a]) : int(tp_off[a + ids.size])])
    return out


def ragged_mh_invert(
    indptr: torch.Tensor,  # (n+1,) int32 CSR row pointers
    degrees: torch.Tensor,  # (n,) int32
    indices: torch.Tensor,  # (nnz,) int32 CSR neighbor ids
    edge_cdf: torch.Tensor,  # (nnz,) float32 flat per-edge CDF
    nodes: torch.Tensor,  # (W,) int32 current node per walk
    u_mh: torch.Tensor,  # (W,) the U_MH uniform per walk
    *,
    max_degree: int,
) -> torch.Tensor:
    """The ragged MH move: binary-search each walk's own CDF segment for
    ``u_mh * total``; returns ``v_mh`` (W,).

    The index is the count of segment entries ``< u_mh * total`` (clamped
    to ``deg - 1``), found in :func:`search_iters` probes.
    """
    start = indptr[nodes]
    deg = degrees[nodes]
    total = edge_cdf[start + deg - 1]
    t = u_mh * total
    lo = torch.zeros_like(deg)
    hi = deg
    for _ in range(search_iters(max_degree)):
        active = lo < hi
        mid = (lo + hi) // 2
        c = edge_cdf[start + torch.minimum(mid, deg - 1)]
        pred = active & (c < t)
        lo = torch.where(pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    idx = torch.minimum(lo, deg - 1)
    return indices[start + idx]


def levy_jump_batched(
    nodes: torch.Tensor,  # (W,) int32
    uniforms: torch.Tensor,  # (W, 3 + r)
    degrees: torch.Tensor,  # (n,) int32
    p_d: float,
    r: int,
    *,
    neighbors: Optional[torch.Tensor] = None,  # (n, max_deg) int32
    csr: Optional[tuple] = None,  # (indptr, indices), both int32
) -> tuple:
    """The Lévy branch for W walks: d ~ TruncGeom(p_d, r), then d uniform
    hops, hop k of a walk at ``v`` going to its neighbor number
    ``min(floor(u * deg(v)), deg(v) - 1)``.  The neighbor comes from the
    padded table (``neighbors[v, k]``) or from the CSR arrays
    (``indices[indptr[v] + k]``); both hold the same id for every
    ``k < deg(v)``.  Exactly one of the two is given.  Returns
    ``(v_jump, d)``."""
    if (neighbors is None) == (csr is None):
        raise ValueError("pass exactly one of neighbors= and csr=")
    d = trunc_geom_icdf(uniforms[:, U_DIST], p_d, r)
    v_cur = nodes
    for i in range(r):
        deg = degrees[v_cur]
        hop_idx = torch.minimum(
            (uniforms[:, U_HOP0 + i] * deg.to(torch.float32)).to(torch.int32),
            deg - 1,
        )
        if csr is None:
            v_new = neighbors[v_cur, hop_idx]
        else:
            indptr, indices = csr
            v_new = indices[indptr[v_cur] + hop_idx]
        v_cur = torch.where(i < d, v_new, v_cur)
    return v_cur, d


def combine_mh_jump(
    v_mh: torch.Tensor,
    v_jump: torch.Tensor,
    d: torch.Tensor,
    uniforms: torch.Tensor,
) -> tuple:
    """Resolve the J~Ber(p_J) branch per walk: the jump or MH destination
    from the ``U_JUMP`` flag, and the Remark-1 hop count (1 or d)."""
    do_jump = uniforms[:, U_JUMP] > 0.5
    v_next = torch.where(do_jump, v_jump, v_mh)
    hops = torch.where(do_jump, d, torch.ones_like(d))
    return v_next, hops


def combine_bucketed(bucket_ids: torch.Tensor, results_by_bucket) -> torch.Tensor:
    """The bucket-merge rule: walk w keeps the result of bucket
    ``bucket_ids[w]``."""
    merged = None
    for b, vm in enumerate(results_by_bucket):
        merged = vm if merged is None else torch.where(bucket_ids == b, vm, merged)
    return merged


def bucket_capacities(
    num_walks: int,
    shares: Tuple[float, ...],
    capacity_factor: float,
    *,
    min_cap: int = 32,
    lane: int = 8,
) -> Tuple[int, ...]:
    """Static per-bucket walk capacities for the compacted dispatch:
    bucket b gets ``min(W, round_up(max(min_cap, ceil(capacity_factor · W
    · share_b)), lane))`` lanes, ``share_b`` being the bucket's expected
    walk share (the engine uses max(node share, degree share))."""
    caps = []
    for share in shares:
        c = math.ceil(capacity_factor * num_walks * share)
        c = max(c, min_cap)
        c = -(-c // lane) * lane
        caps.append(min(c, num_walks))
    return tuple(caps)


def compact_plan(bucket_ids: torch.Tensor, num_buckets: int) -> tuple:
    """Sort the W walks by bucket id — the compaction pass.

    Returns ``(order, starts, counts)``, all int32: ``order`` is the stable
    argsort of ``bucket_ids`` (the walks of bucket b occupy positions
    ``starts[b] : starts[b] + counts[b]`` of it, in walk order), and
    ``counts[b]`` the number of walks in bucket b, summed over a one-hot
    ``(W, num_buckets)`` mask (``bincount`` sizes its output from the
    data on the host).
    """
    buckets = torch.arange(num_buckets, dtype=bucket_ids.dtype,
                           device=bucket_ids.device)
    counts = (bucket_ids[:, None] == buckets[None, :]).sum(
        dim=0, dtype=torch.int32
    )
    order = torch.argsort(bucket_ids, stable=True).to(torch.int32)
    starts = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=counts.device),
         torch.cumsum(counts, 0, dtype=torch.int32)[:-1]]
    )
    return order, starts, counts


def scatter_compacted(
    num_walks: int,
    walk_idx_by_bucket,
    valid_by_bucket,
    results_by_bucket,
) -> torch.Tensor:
    """The compacted merge rule: scatter per-bucket results back to walk
    order.  Lane j of bucket b holds the result for walk
    ``walk_idx_by_bucket[b][j]``; invalid lanes (capacity slop) are sent to
    an extra slot ``num_walks`` that is dropped.  Valid lanes partition
    the walks, so the scatters never collide."""
    res0 = results_by_bucket[0]
    out = torch.zeros(num_walks + 1, dtype=res0.dtype, device=res0.device)
    for widx, valid, res in zip(
        walk_idx_by_bucket, valid_by_bucket, results_by_bucket
    ):
        idx = torch.where(valid, widx, num_walks).long()
        out[idx] = res
    return out[:num_walks]


def mhlj_transition_math(
    nodes: torch.Tensor,  # (W,) int32
    rows: torch.Tensor,  # (W, max_deg) P_IS row per walk (padded)
    neighbors: torch.Tensor,  # (n, max_deg) int32, pads = self id
    degrees: torch.Tensor,  # (n,) int32
    uniforms: torch.Tensor,  # (W, 3 + r); slot U_JUMP is a {0,1} flag
    p_d: float,
    r: int,
) -> tuple:
    """One Algorithm-1 transition for W walks on the padded layout: the MH
    move by :func:`mh_cdf_invert`, the Lévy branch through the padded
    table, the combine.  Returns ``(next_nodes, hops)``, both (W,) int32."""
    v_mh = mh_cdf_invert(rows, neighbors[nodes], uniforms[:, U_MH])
    v_jump, d = levy_jump_batched(
        nodes, uniforms, degrees, p_d, r, neighbors=neighbors
    )
    return combine_mh_jump(v_mh, v_jump, d, uniforms)


def draw_uniforms(
    num_walks: int,
    r: int,
    p_j,
    generator: torch.Generator,
    device: torch.device,
) -> torch.Tensor:
    """One ``(W, 3 + r)`` block from ``generator``, slot 0 replaced by the
    flag ``u < p_j`` (p_j compared in float32)."""
    u = torch.rand(
        (num_walks, num_uniforms(r)), generator=generator, device=device
    )
    if not isinstance(p_j, torch.Tensor):
        p_j = float(np.float32(p_j))  # a float32 value, no host-device copy
    u[:, U_JUMP] = (u[:, U_JUMP] < p_j).to(torch.float32)
    return u




def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class WalkEngine:
    """Batched MHLJ sampler for W parallel walks on one of :data:`LAYOUTS`.

    All tensors live on one device; indices are int32.  Build with
    :meth:`from_graph` (or ``repro_torch.interop.from_reference_state``),
    then call :meth:`step` per transition or :meth:`run` for whole
    trajectories.  Which fields are set depends on ``layout``: the padded
    layouts hold ``neighbors`` (and ``row_probs``), the bucketed layout the
    per-bucket tables and the CSR arrays, the ragged layout the CSR arrays
    and ``edge_cdf``.  Without precomputed rows (``row_probs`` /
    ``bucket_rows`` both None) the padded and bucketed layouts build live
    Eq.-7 rows from the ``lipschitz=`` argument of :meth:`step`.
    """

    degrees: torch.Tensor  # (n,) int32
    layout: str = "sparse"
    p_j: float = 0.1  # default jump probability (overridable per call)
    p_d: float = 0.5
    r: int = 3
    # -- padded layouts (sparse, dense) --------------------------------------
    neighbors: Optional[torch.Tensor] = None  # (n, max_deg) int32, pads = id
    row_probs: Optional[torch.Tensor] = None  # (n, max_deg) float32 P_IS
    # -- bucketed layout ------------------------------------------------------
    compact: bool = True  # sort walks by bucket, run tiles at capacity
    capacity_factor: float = 1.25  # headroom of the bucket_capacities rule
    bucket_share: Optional[Tuple[float, ...]] = None  # expected walk share
    node_bucket: Optional[torch.Tensor] = None  # (n,) int32 bucket per node
    node_slot: Optional[torch.Tensor] = None  # (n,) int32 row within bucket
    bucket_neighbors: Optional[Tuple[torch.Tensor, ...]] = None  # (n_b, w_b)
    bucket_rows: Optional[Tuple[torch.Tensor, ...]] = None  # (n_b, w_b) P_IS
    # -- CSR arrays (bucketed and ragged) -------------------------------------
    indptr: Optional[torch.Tensor] = None  # (n+1,) int32
    indices: Optional[torch.Tensor] = None  # (nnz,) int32
    # -- ragged layout --------------------------------------------------------
    edge_cdf: Optional[torch.Tensor] = None  # (nnz,) float32 flat CDF
    max_degree: Optional[int] = None  # bound of the binary search
    cdf_width: Optional[int] = None  # the reference's build width of
    #   edge_cdf (>= max_degree, sticky across churn): recorded, carried
    #   in checkpoints and checked; the port's CDF bits do not depend on it
    # -- dynamic graphs --------------------------------------------------------
    graph_version: int = 0  # bumped by apply_churn
    # device copies of host constants, made once (a step copies nothing)
    _consts: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False
    )

    @classmethod
    def from_graph(
        cls,
        graph,
        params,
        *,
        row_probs=None,
        lipschitz=None,
        layout: Optional[str] = None,
        bucket_factor: Optional[int] = None,
        compact: bool = True,
        capacity_factor: float = 1.25,
        device: Union[str, torch.device] = "cuda",
    ) -> "WalkEngine":
        """Engine from a ``repro_torch.core.graphs`` graph + ``MHLJParams``.

        The layout follows the graph class unless ``layout`` is given: a
        ``BucketedCSRGraph`` selects ``"bucketed"``, a ``RaggedCSRGraph``
        ``"ragged"``, a ``Graph`` or ``CSRGraph`` ``"sparse"``; any graph is
        converted when a layout is asked for (``bucket_factor`` picks the
        bucketed width ladder).  Rows: ``row_probs`` — an (n, max_deg)
        table (column-truncated per bucket on the bucketed layout), a
        per-bucket tuple (bucketed), or a flat (nnz,) buffer (ragged) — or
        precomputed on the device from a static ``lipschitz`` vector; with
        neither, the padded and bucketed layouts take live rows from
        :meth:`step`'s ``lipschitz=`` (the ragged layout needs one of the
        two here).  ``compact``/``capacity_factor`` tune the bucketed
        layout's per-step compaction.
        """
        params.validate()
        device = torch.device(device)
        is_bucketed = hasattr(graph, "buckets")
        is_bare_csr = hasattr(graph, "indptr") and not (
            is_bucketed or hasattr(graph, "neighbors")
        )
        if layout is None:
            layout = (
                "bucketed" if is_bucketed
                else "ragged" if is_bare_csr
                else "sparse"
            )
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
        common = dict(
            layout=layout, p_j=params.p_j, p_d=params.p_d, r=params.r,
            compact=compact, capacity_factor=capacity_factor,
        )
        if layout == "ragged":
            core = graph.to_ragged()
            if row_probs is None and lipschitz is None:
                raise ValueError(
                    "the ragged layout precomputes its flat per-edge CDF at "
                    "construction; pass row_probs or lipschitz to from_graph"
                )
            edge_cdf = ragged_edge_cdf(
                core.indptr, core.indices, core.degrees,
                row_probs=row_probs, lipschitz=lipschitz, device=device,
            )
            return cls(
                degrees=_i32(core.degrees, device),
                indptr=_i32(core.indptr, device),
                indices=_i32(core.indices, device),
                edge_cdf=edge_cdf,
                max_degree=int(np.asarray(core.degrees).max()),
                cdf_width=int(np.asarray(core.degrees).max()),
                **common,
            )
        if layout == "bucketed":
            # bucket_factor=None keeps an already-bucketed graph's ladder
            if is_bucketed and bucket_factor is None:
                bg = graph
            else:
                base = graph if hasattr(graph, "to_bucketed") else graph.to_csr()
                bg = base.to_bucketed(bucket_factor=bucket_factor or 2)
            degrees = _i32(bg.degrees, device)
            bucket_neighbors = tuple(_i32(b.neighbors, device) for b in bg.buckets)
            if row_probs is not None:
                if isinstance(row_probs, (tuple, list)):
                    bucket_rows = tuple(_f32(x, device) for x in row_probs)
                else:  # (n, max_deg) table: exact per-bucket truncation
                    table = np.asarray(row_probs, dtype=np.float32)
                    if table.ndim != 2:
                        raise ValueError(
                            "bucketed row_probs must be a per-bucket tuple "
                            f"or an (n, max_deg) table, got {table.shape}"
                        )
                    bucket_rows = tuple(
                        _f32(table[b.node_ids][:, : b.width], device)
                        for b in bg.buckets
                    )
            elif lipschitz is not None:
                lips = _f32(lipschitz, device)
                bucket_rows = tuple(
                    p_is_rows_block(
                        nb, _i32(b.node_ids, device),
                        degrees[_i32(b.node_ids, device)], degrees, lips,
                    )
                    for b, nb in zip(bg.buckets, bucket_neighbors)
                )
            else:
                bucket_rows = None
            # expected walk share per bucket: max of node share (MH-IS
            # occupancy) and degree share (Lévy-jump / proposal occupancy)
            total_deg = int(bg.degrees.sum())
            bucket_share = tuple(
                max(
                    int(b.node_ids.size) / bg.n,
                    int(bg.degrees[b.node_ids].sum()) / total_deg,
                )
                for b in bg.buckets
            )
            return cls(
                degrees=degrees,
                bucket_share=bucket_share,
                node_bucket=_i32(bg.node_bucket, device),
                node_slot=_i32(bg.node_slot, device),
                bucket_neighbors=bucket_neighbors,
                bucket_rows=bucket_rows,
                indptr=_i32(bg.indptr, device),
                indices=_i32(bg.indices, device),
                **common,
            )
        if is_bucketed or is_bare_csr:
            graph = graph.to_csr()  # the padded layouts need the full table
        neighbors = _i32(graph.neighbors, device)
        degrees = _i32(graph.degrees, device)
        if isinstance(row_probs, (tuple, list)):
            raise ValueError(
                "per-bucket row tuples need the bucketed layout; the "
                f"{layout} layout takes an (n, max_deg) table"
            )
        if row_probs is not None:
            table = np.asarray(row_probs, dtype=np.float32)
            if table.shape != tuple(neighbors.shape):
                raise ValueError(
                    f"row_probs must be an (n, max_deg)={tuple(neighbors.shape)}"
                    f" table on the {layout} layout, got {table.shape}"
                )
            rows = _f32(table, device)
        elif lipschitz is not None:
            rows = p_is_rows(neighbors, degrees, _f32(lipschitz, device))
        else:
            rows = None
        return cls(degrees=degrees, neighbors=neighbors, row_probs=rows, **common)

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; one of {LAYOUTS}")
        need = {
            "sparse": ("neighbors",),
            "dense": ("neighbors",),
            "bucketed": ("node_bucket", "node_slot", "bucket_neighbors",
                         "indptr", "indices"),
            "ragged": ("indptr", "indices", "edge_cdf", "max_degree"),
        }[self.layout]
        missing = [f for f in need if getattr(self, f) is None]
        if missing:
            raise ValueError(f"layout {self.layout!r} needs {missing}")
        if self.indices is not None and self.indices.shape[0] > MAX_NNZ:
            raise ValueError(
                f"nnz={self.indices.shape[0]} exceeds the int32 index range"
            )
        if (self.cdf_width is not None and self.max_degree is not None
                and self.cdf_width < self.max_degree):
            raise ValueError(
                f"cdf_width={self.cdf_width} must cover max_degree="
                f"{self.max_degree}"
            )

    def apply_churn(
        self,
        graph,
        churn,
        *,
        lipschitz=None,
        touched_probs=None,
    ) -> "WalkEngine":
        """A new engine over a churned graph, recomputing only touched rows.

        ``graph`` is the post-churn ``CSRGraph``/``RaggedCSRGraph`` and
        ``churn`` its ``graphs.EdgeChurn``, both from
        ``graphs.apply_edge_churn``.  The CDF is patched by
        :func:`ragged_edge_cdf_update` (untouched segments moved by one
        device gather, ``churn.touched_rows`` recomputed from ``lipschitz``
        or ``touched_probs``, exactly one) into fresh tensors; this
        engine's tensors are never written, and the new engine has its own
        device constants.  ``graph_version`` goes up by one.

        ``cdf_width`` is sticky as in the reference: kept when the max
        degree stays at or below it, raised to the new max degree when an
        insert pushes past it.  That escalation rebuilds the whole CDF by
        :func:`ragged_edge_cdf`, so a ``touched_probs`` buffer must then be
        full length (nnz,), or the call raises.  The port's bits do not
        depend on the width (the row-CDF rule), so the patched buffer
        equals ``ragged_edge_cdf(graph)`` of the same row values either
        way; the escalation only keeps the reference's contract.  Walk
        positions are not moved here: ``WalkFleet.migrate`` does that.

        Ragged layout only: rebuild the other layouts with
        :meth:`from_graph`.
        """
        if self.layout != "ragged":
            raise ValueError(
                "incremental churn updates exist on layout='ragged' only "
                "(the flat per-edge CDF is segment-local); rebuild other "
                "layouts via WalkEngine.from_graph"
            )
        if not hasattr(graph, "indptr"):
            raise TypeError(
                "apply_churn needs the post-churn CSRGraph/RaggedCSRGraph "
                f"(got {type(graph).__name__})"
            )
        new_max = int(np.asarray(graph.degrees).max())
        old_width = (self.cdf_width if self.cdf_width is not None
                     else self.max_degree)
        if new_max <= old_width:
            new_cdf = ragged_edge_cdf_update(
                self.indptr.cpu().numpy(), self.degrees.cpu().numpy(),
                self.edge_cdf, graph.indptr, graph.indices, graph.degrees,
                churn.touched_rows, touched_probs=touched_probs,
                lipschitz=lipschitz, width=old_width, device=self.device,
            )
            new_width = old_width
        else:
            if (touched_probs is None) == (lipschitz is None):
                raise ValueError(
                    "pass exactly one row source: touched_probs or "
                    "lipschitz"
                )
            nnz = int(np.asarray(graph.indices).shape[0])
            if touched_probs is not None:
                tp = _host(touched_probs, np.float32)
                if tp.ndim != 1 or tp.shape[0] != nnz:
                    raise ValueError(
                        f"churn raised the max degree past the engine's "
                        f"cdf_width ({old_width} -> {new_max}); the "
                        "escalated full rebuild needs a full-length "
                        f"({nnz},) row-probability buffer, not one "
                        "restricted to the touched rows — recompute "
                        f"without node_ids (got {tp.shape})"
                    )
                src = dict(row_probs=tp)
            else:
                src = dict(lipschitz=lipschitz)
            new_cdf = ragged_edge_cdf(
                graph.indptr, graph.indices, graph.degrees, width=new_max,
                device=self.device, **src,
            )
            new_width = new_max
        return dataclasses.replace(
            self,
            degrees=_i32(graph.degrees, self.device),
            indptr=_i32(graph.indptr, self.device),
            indices=_i32(graph.indices, self.device),
            edge_cdf=new_cdf,
            max_degree=new_max,
            cdf_width=new_width,
            graph_version=self.graph_version + 1,
        )

    @property
    def device(self) -> torch.device:
        return self.degrees.device

    @property
    def n(self) -> int:
        return int(self.degrees.shape[0])

    # -- P_IS row plumbing --------------------------------------------------

    def rows_table(self, lipschitz: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full (n, max_deg) P_IS table (precomputed or live Eq.-7); only
        the dense layout consumes it."""
        if self.layout in ("bucketed", "ragged"):
            raise ValueError(
                f"the {self.layout} layout has no full-width row table"
            )
        if self.row_probs is not None:
            return self.row_probs
        if lipschitz is None:
            raise ValueError(
                "engine has no precomputed row_probs; pass lipschitz= for "
                "live Eq. (7) rows"
            )
        return p_is_rows(self.neighbors, self.degrees, lipschitz)

    def rows_for(
        self, nodes: torch.Tensor, lipschitz: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """P_IS rows for the W active walk positions only."""
        if self.layout in ("bucketed", "ragged"):
            raise ValueError(
                f"the {self.layout} layout has no full-width rows"
            )
        if self.row_probs is not None:
            return self.row_probs[nodes]
        if lipschitz is None:
            raise ValueError(
                "engine has no precomputed row_probs; pass lipschitz= for "
                "live Eq. (7) rows"
            )
        return p_is_rows(self.neighbors, self.degrees, lipschitz, nodes=nodes)

    def _check_bucket_rows(self, lipschitz) -> None:
        if self.bucket_rows is None and lipschitz is None:
            raise ValueError(
                "engine has no precomputed bucket rows; pass lipschitz= for "
                "live Eq. (7) rows"
            )

    def _bucket_tiles(
        self, nodes: torch.Tensor, lipschitz: Optional[torch.Tensor] = None
    ) -> tuple:
        """Per-bucket (P_IS rows, neighbor tiles) for all W walks: a walk
        outside bucket b reads the bucket's row 0, a dummy the merge drops.
        Returns ``(bucket_id, rows_by_bucket, tiles_by_bucket)``."""
        self._check_bucket_rows(lipschitz)
        bid = self.node_bucket[nodes]
        slot = self.node_slot[nodes]
        deg_v = self.degrees[nodes]
        rows_by, tiles_by = [], []
        for b, nbrs_b in enumerate(self.bucket_neighbors):
            local = torch.where(bid == b, slot, 0)
            tiles = nbrs_b[local]  # (W, width_b)
            if self.bucket_rows is not None:
                rows = self.bucket_rows[b][local]
            else:
                rows = p_is_rows_block(
                    tiles, nodes, deg_v, self.degrees, lipschitz
                )
            rows_by.append(rows)
            tiles_by.append(tiles)
        return bid, tuple(rows_by), tuple(tiles_by)

    def _bucketed_mh_full(
        self,
        nodes: torch.Tensor,
        u_mh: torch.Tensor,
        lipschitz: Optional[torch.Tensor] = None,
        live: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Uncompacted bucketed MH move: every bucket pass runs all W walks
        (the ``compact=False`` path and the overflow fallback, whose passes
        the device flag ``live`` gates)."""
        from repro_torch.kernels.walk_transition.kernel import (
            walk_transition_bucketed,
        )

        bid, rows_by, tiles_by = self._bucket_tiles(nodes, lipschitz)
        return walk_transition_bucketed(bid, rows_by, tiles_by, u_mh, live)

    def compacted_bucket_inputs(
        self,
        nodes: torch.Tensor,
        u_mh: torch.Tensor,
        caps: Tuple[int, ...],
        order: torch.Tensor,
        starts: torch.Tensor,
        counts: torch.Tensor,
        lipschitz: Optional[torch.Tensor] = None,
    ) -> tuple:
        """The compacted gather convention: per-bucket ``[cap_b, …]`` inputs
        from a :func:`compact_plan`.

        Lane j of bucket b is sorted position ``starts[b] + j`` (the order
        vector is padded with ``max(caps)`` zeros, so the gather never runs
        off its end); lanes at or beyond ``counts[b]`` are invalid and read
        the bucket's row 0.  Returns ``(walk_idx, valid, rows, tiles,
        u_mh)``, each a tuple with one entry per bucket.
        """
        order_p = torch.cat(
            [order, torch.zeros(max(caps), dtype=order.dtype,
                                device=order.device)]
        )
        widx_by, valid_by, rows_by, tiles_by, u_by = [], [], [], [], []
        for b, cap in enumerate(caps):
            lanes = torch.arange(cap, dtype=torch.int32, device=order.device)
            widx = order_p[starts[b] + lanes]
            valid = lanes < counts[b]
            nodes_b = nodes[widx]
            slot = torch.where(valid, self.node_slot[nodes_b], 0)
            tiles = self.bucket_neighbors[b][slot]
            if self.bucket_rows is not None:
                rows = self.bucket_rows[b][slot]
            else:
                rows = p_is_rows_block(
                    tiles, nodes_b, self.degrees[nodes_b], self.degrees,
                    lipschitz,
                )
            widx_by.append(widx)
            valid_by.append(valid)
            rows_by.append(rows)
            tiles_by.append(tiles)
            u_by.append(u_mh[widx])
        return (
            tuple(widx_by), tuple(valid_by), tuple(rows_by),
            tuple(tiles_by), tuple(u_by),
        )

    def bucket_capacities(self, num_walks: int) -> Tuple[int, ...]:
        """This engine's per-bucket capacities at W = ``num_walks``."""
        shares = self.bucket_share
        if shares is None:  # built without from_graph: node share only
            shares = tuple(
                int(nb.shape[0]) / self.n for nb in self.bucket_neighbors
            )
        return bucket_capacities(num_walks, shares, self.capacity_factor)

    def _capacities_on_device(self, caps: Tuple[int, ...]) -> torch.Tensor:
        """``caps`` as an int32 device vector, made once per ``caps`` with
        fills (no host-to-device copy, so a warm-up may make it)."""
        key = ("caps", caps)
        if key not in self._consts:
            t = torch.empty(len(caps), dtype=torch.int32, device=self.device)
            for i, c in enumerate(caps):
                t[i].fill_(c)
            self._consts[key] = t
        return self._consts[key]

    def _bucketed_mh_compacted(
        self,
        nodes: torch.Tensor,
        u_mh: torch.Tensor,
        lipschitz: Optional[torch.Tensor] = None,
    ) -> tuple:
        """Compacted bucketed MH move: each bucket pays only its own walks.

        One :func:`compact_plan` stable sort groups the walks by bucket;
        bucket b's pass runs on a ``[cap_b, width_b]`` tile and
        :func:`scatter_compacted` puts the results back in walk order.  If
        a bucket holds more walks than its capacity, the step takes
        :meth:`_bucketed_mh_full` instead.  The choice is the reference's
        ``lax.cond``, made on the device: both dispatches are issued, each
        tile pass gated by the overflow flag (the unused branch's passes
        read no tile), and ``torch.where`` keeps the taken branch's
        result.  Returns ``(v_mh, overflow)``, ``overflow`` a 0-d device
        bool.
        """
        from repro_torch.kernels.walk_transition.kernel import (
            walk_transition_bucketed_compacted,
        )

        self._check_bucket_rows(lipschitz)
        num_walks = nodes.shape[0]
        caps = self.bucket_capacities(num_walks)
        bid = self.node_bucket[nodes]
        order, starts, counts = compact_plan(bid, len(caps))
        overflow = (counts > self._capacities_on_device(caps)).any()
        widx_by, valid_by, rows_by, tiles_by, u_by = (
            self.compacted_bucket_inputs(
                nodes, u_mh, caps, order, starts, counts, lipschitz
            )
        )
        compacted = walk_transition_bucketed_compacted(
            rows_by, tiles_by, u_by, widx_by, valid_by, num_walks,
            live=~overflow,
        )
        full = self._bucketed_mh_full(nodes, u_mh, lipschitz, live=overflow)
        return torch.where(overflow, full, compacted), overflow

    # -- the transition -----------------------------------------------------

    def _check_block(self, uniforms: torch.Tensor, shape: tuple) -> torch.Tensor:
        if tuple(uniforms.shape) != shape:
            raise ValueError(
                f"uniform block must have shape {shape}, got "
                f"{tuple(uniforms.shape)}"
            )
        return uniforms.to(device=self.device, dtype=torch.float32)

    def step(
        self,
        nodes: torch.Tensor,
        *,
        uniforms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        p_j=None,
        lipschitz: Optional[torch.Tensor] = None,
        with_aux: bool = False,
        faults: Optional[tuple] = None,
        rescue_uniforms: Optional[torch.Tensor] = None,
    ) -> tuple:
        """One batched MHLJ transition of the (W,) int32 ``nodes``.

        Either ``uniforms`` — an injected ``(W, 3 + r)`` block whose slot 0
        already holds the jump flag — or ``generator``, from which the
        block is drawn with the flag ``u < p_j`` (``p_j`` defaults to the
        engine's).  ``lipschitz`` gives live Eq.-7 rows to an engine
        without precomputed rows.  Returns ``(next_nodes, hops)``, both
        (W,) int32; with ``with_aux`` also ``{"compact_overflow": 0-d
        bool tensor}`` on the engine's device, True when this step's
        compacted bucketed dispatch overflowed a capacity and took the
        full dispatch.  A 0-d ``nodes`` (with a ``(3 + r,)`` or
        ``(1, 3 + r)`` block) returns 0-d outputs.  The step reads nothing
        from the device on the host.

        ``faults=(FaultModel, FaultState)`` takes the liveness-masked path
        (``repro_torch.core.faults``, docs/faults.md): the layout's
        proposal is computed as without faults, then
        :func:`~repro_torch.core.faults.apply_liveness` rejects handoffs
        onto dead nodes or dropped edges and moves walkers blocked
        ``patience`` steps to a uniform live node.  It needs
        ``with_aux=True``; the aux gains ``blocked_steps`` (the updated
        (W,) counter, the caller's next ``FaultState.blocked``),
        ``fault_blocked`` and ``rescued`` (W,) masks.  With a rescuing
        model the rescue takes ``rescue_uniforms`` (W,) beside an injected
        block, or draws them from ``generator`` after the block.  Edge
        faults need the ragged layout.
        """
        from repro_torch.kernels.walk_transition.kernel import (
            walk_transition,
            walk_transition_ragged,
            walk_transition_sparse,
        )

        if faults is not None and not with_aux:
            raise ValueError(
                "the liveness-masked path returns its blocked counter "
                "through aux; call step(..., faults=..., with_aux=True)"
            )
        if (faults is not None and faults[0].rescue and uniforms is not None
                and rescue_uniforms is None):
            raise ValueError("a rescuing fault model draws (W,) rescue "
                             "uniforms: pass rescue_uniforms= beside uniforms=")
        nodes = torch.as_tensor(nodes, dtype=torch.int32, device=self.device)
        squeeze = nodes.ndim == 0
        if squeeze:
            nodes = nodes[None]
        if nodes.ndim != 1:
            raise ValueError(f"nodes must be (W,) or 0-d, got {tuple(nodes.shape)}")
        shape = (nodes.shape[0], num_uniforms(self.r))
        if uniforms is not None:
            if squeeze and uniforms.ndim == 1:
                uniforms = uniforms[None]
            u = self._check_block(uniforms, shape)
        elif generator is not None:
            u = draw_uniforms(
                shape[0], self.r, self.p_j if p_j is None else p_j,
                generator, self.device,
            )
        else:
            raise ValueError("pass uniforms= (injected block) or generator=")
        if lipschitz is not None:
            lipschitz = torch.as_tensor(
                lipschitz, dtype=torch.float32, device=self.device
            )
        overflow = None
        if self.layout == "ragged":
            nxt, hops = walk_transition_ragged(
                nodes, self.indptr, self.degrees, self.indices, self.edge_cdf,
                u, p_d=self.p_d, r=self.r, max_degree=self.max_degree,
            )
        elif self.layout == "dense":
            nxt, hops = walk_transition(
                nodes, self.rows_table(lipschitz), self.neighbors,
                self.degrees, u, p_d=self.p_d, r=self.r,
            )
        else:
            u_mh = u[:, U_MH].contiguous()
            if self.layout == "bucketed":
                if self.compact and len(self.bucket_neighbors) > 1:
                    v_mh, overflow = self._bucketed_mh_compacted(
                        nodes, u_mh, lipschitz
                    )
                else:
                    v_mh = self._bucketed_mh_full(nodes, u_mh, lipschitz)
                jump = dict(csr=(self.indptr, self.indices))
            else:  # sparse: the W active rows and neighbor tiles only
                v_mh = walk_transition_sparse(
                    self.rows_for(nodes, lipschitz), self.neighbors[nodes], u_mh
                )
                jump = dict(neighbors=self.neighbors)
            v_jump, d = levy_jump_batched(
                nodes, u, self.degrees, self.p_d, self.r, **jump
            )
            nxt, hops = combine_mh_jump(v_mh, v_jump, d, u)
        aux = {}
        if faults is not None:
            # the masking follows the dispatch, the same on every layout
            fmodel, fstate = faults
            nxt, hops, blocked, was_blocked, rescued = faults_mod.apply_liveness(
                nodes, nxt, hops, fstate.blocked.reshape(-1),
                fmodel.live_mask(fstate),
                patience=fmodel.patience, rescue=fmodel.rescue,
                rescue_hops=self.r,
                uniforms=None if rescue_uniforms is None
                else torch.as_tensor(rescue_uniforms).reshape(-1),
                generator=None if uniforms is not None else generator,
                edge_live=fmodel.edge_live_mask(fstate),
                indptr=self.indptr, indices=self.indices,
                max_degree=self.max_degree,
            )
            aux.update(blocked_steps=blocked, fault_blocked=was_blocked,
                       rescued=rescued)
        if squeeze:
            nxt, hops = nxt[0], hops[0]
            aux = {k: v[0] for k, v in aux.items()}
        if with_aux:
            if overflow is None:
                overflow = torch.zeros((), dtype=torch.bool,
                                       device=self.device)
            return nxt, hops, {"compact_overflow": overflow, **aux}
        return nxt, hops

    def _p_schedule(self, p_j, num_steps: int) -> torch.Tensor:
        """``p_j`` (default the engine's) as a ``(num_steps,)`` float32
        device schedule; a scalar becomes a fill, not a copy."""
        p = self.p_j if p_j is None else p_j
        if isinstance(p, torch.Tensor):
            sched = p.to(device=self.device, dtype=torch.float32)
        elif np.ndim(p) == 0:
            sched = torch.full((num_steps,), float(np.float32(p)),
                               dtype=torch.float32, device=self.device)
        else:
            sched = _f32(p, self.device)
        return sched.broadcast_to((num_steps,))

    def run(
        self,
        v0s: torch.Tensor,
        num_steps: int,
        *,
        uniforms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        p_j=None,
        lipschitz: Optional[torch.Tensor] = None,
        with_aux: bool = False,
        capture: Optional[bool] = None,
    ) -> tuple:
        """Whole trajectories for W walks (Algorithm 1's update sequence).

        ``uniforms`` is an injected ``(T, W, 3 + r)`` block (slot 0 = flag);
        otherwise each step draws from ``generator`` with ``p_j`` a scalar
        or a (T,) schedule.  Returns ``(update_nodes, hops)``, both
        (W, T) int32: element t is the node holding the model when update
        t runs (the first at v0) and the hops taken after it; with
        ``with_aux`` also ``{"compact_overflow": (T,) bool tensor}`` on
        the engine's device.  A 0-d ``v0s`` (with a ``(T, 3 + r)`` block)
        drops the walk axis.

        The loop is the reference's ``lax.scan``: a step over ``(t, v)``
        on the device, driven by ``repro_torch.core.scan.scan``, which
        captures it in CUDA graphs on the card (``capture=False`` runs it
        uncaptured, for comparison) and runs it as a plain loop on the
        CPU.  Both give the same walks, bit for bit, and leave
        ``generator`` in the same state.
        """
        v = torch.as_tensor(v0s, dtype=torch.int32, device=self.device)
        squeeze = v.ndim == 0
        if squeeze:
            v = v[None]
            if uniforms is not None and uniforms.ndim == 2:
                uniforms = uniforms[:, None]
        w = v.shape[0]
        if uniforms is not None:
            uniforms = self._check_block(
                uniforms, (num_steps, w, num_uniforms(self.r))
            )
        elif generator is None:
            raise ValueError("pass uniforms= (injected blocks) or generator=")
        p_sched = self._p_schedule(p_j, num_steps)
        if lipschitz is not None:
            lipschitz = torch.as_tensor(
                lipschitz, dtype=torch.float32, device=self.device
            )

        def body(carry):
            t, v = carry
            row = t.view(1)
            if uniforms is not None:
                draw = dict(uniforms=uniforms.index_select(0, row)[0])
            else:
                draw = dict(generator=generator,
                            p_j=p_sched.index_select(0, row))
            nxt, hops, aux = self.step(
                v, lipschitz=lipschitz, with_aux=True, **draw
            )
            return (t + 1, nxt), (v, hops, aux["compact_overflow"])

        t0 = torch.zeros((), dtype=torch.int64, device=self.device)
        flag = torch.zeros((), dtype=torch.bool, device=self.device)
        (nodes_out, hops_out, overflow), _, _ = scan_mod.scan(
            body, (t0, v), num_steps, (v, v, flag), capture=capture,
            generators=() if generator is None else (generator,),
        )
        update_nodes = nodes_out.T.contiguous()
        hops = hops_out.T.contiguous()
        if squeeze:
            update_nodes, hops = update_nodes[0], hops[0]
        if with_aux:
            return update_nodes, hops, {"compact_overflow": overflow}
        return update_nodes, hops
