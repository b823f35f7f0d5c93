"""Plain PyTorch version of the ragged walk-transition kernel.

The composition of the engine's ragged MH move, CSR Lévy branch and
jump/MH combine — the function the CUDA kernel computes per walk.  It is
what the kernel's wrapper runs for CPU tensors, and what the kernel is
held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import (
    U_MH,
    combine_mh_jump,
    levy_jump_batched,
    ragged_mh_invert,
)

__all__ = ["walk_transition_ragged_ref"]


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
