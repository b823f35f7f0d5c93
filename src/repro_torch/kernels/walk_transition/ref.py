"""Plain PyTorch versions of the walk-transition kernels.

Each is the engine's own composition of the function its CUDA kernel
computes — what the kernel's wrapper runs for CPU tensors, and what the
kernel is held against on the card.  The CDFs follow the engine's row-CDF
rule (``engine.row_cdf``), as the kernels do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import (
    U_MH,
    combine_bucketed,
    combine_mh_jump,
    levy_jump_batched,
    mh_cdf_invert,
    mhlj_transition_math,
    ragged_mh_invert,
    scatter_compacted,
)

__all__ = [
    "walk_transition_ref",
    "walk_transition_sparse_ref",
    "walk_transition_bucketed_ref",
    "walk_transition_bucketed_compacted_ref",
    "walk_transition_ragged_ref",
]


def walk_transition_ref(
    nodes: torch.Tensor,  # (W,) int32
    row_probs: torch.Tensor,  # (n, max_deg) float32
    neighbors: torch.Tensor,  # (n, max_deg) int32
    degrees: torch.Tensor,  # (n,) int32
    uniforms: torch.Tensor,  # (W, 3 + r) float32, slot 0 = jump flag
    *,
    p_d: float,
    r: int,
) -> tuple:
    """Same contract as ``kernel.walk_transition``; returns
    ``(next_nodes, hops)``, both (W,) int32."""
    return mhlj_transition_math(
        nodes, row_probs[nodes], neighbors, degrees, uniforms, p_d, r
    )


def walk_transition_sparse_ref(
    rows: torch.Tensor,  # (W, width) float32
    neigh_rows: torch.Tensor,  # (W, width) int32
    u_mh: torch.Tensor,  # (W,) float32
    live: Optional[torch.Tensor] = None,  # 0-d bool gate
) -> torch.Tensor:
    """Same contract as ``kernel.walk_transition_sparse``: the CDF
    inversion over gathered tiles, every pick 0 where ``live`` is False;
    returns ``v_mh`` (W,) int32."""
    v_mh = mh_cdf_invert(rows, neigh_rows, u_mh)
    return v_mh if live is None else torch.where(live, v_mh, 0)


def walk_transition_bucketed_ref(
    bucket_ids: torch.Tensor,
    rows_by_bucket,
    tiles_by_bucket,
    u_mh: torch.Tensor,
) -> torch.Tensor:
    """Same contract as ``kernel.walk_transition_bucketed``: one inversion
    per bucket over all W walks, each walk keeping its own bucket's
    result."""
    return combine_bucketed(
        bucket_ids,
        [
            mh_cdf_invert(rows, tiles, u_mh)
            for rows, tiles in zip(rows_by_bucket, tiles_by_bucket)
        ],
    )


def walk_transition_bucketed_compacted_ref(
    rows_by_bucket,
    tiles_by_bucket,
    u_by_bucket,
    walk_idx_by_bucket,
    valid_by_bucket,
    num_walks: int,
) -> torch.Tensor:
    """Same contract as ``kernel.walk_transition_bucketed_compacted``: one
    inversion per compacted ``[cap_b, width_b]`` tile, scattered back to
    walk order."""
    return scatter_compacted(
        num_walks,
        walk_idx_by_bucket,
        valid_by_bucket,
        [
            mh_cdf_invert(rows, tiles, u_b)
            for rows, tiles, u_b in zip(
                rows_by_bucket, tiles_by_bucket, u_by_bucket
            )
        ],
    )


def walk_transition_ragged_ref(
    nodes: torch.Tensor,  # (W,) int32
    indptr: torch.Tensor,  # (n+1,) int32
    degrees: torch.Tensor,  # (n,) int32
    indices: torch.Tensor,  # (nnz,) int32
    edge_cdf: torch.Tensor,  # (nnz,) float32
    uniforms: torch.Tensor,  # (W, 3 + r) float32, slot 0 = jump flag
    *,
    p_d: float,
    r: int,
    max_degree: int,
) -> tuple:
    """Same contract as ``kernel.walk_transition_ragged``; returns
    ``(next_nodes, hops)``, both (W,) int32."""
    v_mh = ragged_mh_invert(
        indptr, degrees, indices, edge_cdf, nodes, uniforms[:, U_MH],
        max_degree=max_degree,
    )
    v_jump, d = levy_jump_batched(
        nodes, uniforms, degrees, p_d, r, csr=(indptr, indices)
    )
    return combine_mh_jump(v_mh, v_jump, d, uniforms)
