"""Chain-law rows of the ragged layout (numpy, host side).

A copy of the parts of ``repro.core.transition`` that the ragged walk-SGD
path needs, bit for bit:

1. ``simple_rw``      P(v,u) = 1/deg(v)
2. ``mh_uniform``     MH targeting uniform pi
3. ``mh_importance``  P_IS of Eq. (7): MH targeting pi_IS ∝ L_v

Each law is a flat ``(nnz,)`` float32 probability buffer aligned with the
graph's CSR ``indices``.  Rows are built in bounded chunks through the
padded block builders at the full ``max_deg`` width and then stripped of
their exactly-zero pads, so every entry equals the padded-builder entry.
The MHLJ law itself is never materialized: the engine samples it in two
phases (MH move or Lévy jump).  Dense matrices, padded/bucketed row
tables and the heterogeneity and private laws are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graphs import (
    _pad_neighbor_lists,
    _ragged_row_chunks,
    flat_edge_values,
)

__all__ = [
    "MHLJParams",
    "simple_rw_rows_ragged",
    "mh_uniform_rows_ragged",
    "mh_importance_rows_ragged",
]


@dataclasses.dataclass(frozen=True)
class MHLJParams:
    """Lévy jump hyper-parameters (paper uses (0.1, 0.5, 3) in Fig 3)."""

    p_j: float = 0.1
    p_d: float = 0.5
    r: int = 3

    def validate(self) -> None:
        if not (0.0 <= self.p_j <= 1.0):
            raise ValueError(f"p_j must be in [0,1], got {self.p_j}")
        if not (0.0 < self.p_d < 1.0):
            raise ValueError(f"p_d must be in (0,1), got {self.p_d}")
        if self.r < 1:
            raise ValueError(f"r must be >= 1, got {self.r}")


def _check_lipschitz(graph, lipschitz) -> np.ndarray:
    lipschitz = np.asarray(lipschitz, dtype=np.float64)
    if lipschitz.shape != (graph.n,):
        raise ValueError(
            f"lipschitz must have shape ({graph.n},), got {lipschitz.shape}"
        )
    if np.any(lipschitz <= 0):
        raise ValueError("Lipschitz constants must be strictly positive")
    return lipschitz


def _block_masks(nbrs: np.ndarray, self_ids: np.ndarray, deg_v: np.ndarray):
    width = nbrs.shape[1]
    is_pad = np.arange(width)[None, :] >= deg_v[:, None]
    is_self = (nbrs == self_ids[:, None].astype(nbrs.dtype)) & ~is_pad
    return is_pad, is_self


def _mh_rows_block(
    nbrs: np.ndarray,  # (rows, width) padded neighbor block
    self_ids: np.ndarray,  # (rows,) owning node id per row
    deg_v: np.ndarray,  # (rows,) true degree per row
    degrees: np.ndarray,  # (n,) full degree vector (neighbor lookups)
    target_weight: np.ndarray,  # (n,) pi ∝ target_weight
) -> np.ndarray:
    """MH rows (Eq. 6, Q = simple RW) on an arbitrary padded block.

    P(v,u) = (1/deg_v) min{1, deg_v w_u / (deg_u w_v)} for true neighbors
    u != v; leftover mass goes to the self slot, pads carry exactly 0.
    """
    is_pad, is_self = _block_masks(nbrs, self_ids, deg_v)
    w = np.asarray(target_weight, dtype=np.float64)
    deg_vf = deg_v[:, None].astype(np.float64)
    deg_u = degrees[nbrs].astype(np.float64)
    move = np.minimum(1.0 / deg_vf, w[nbrs] / (deg_u * w[self_ids][:, None]))
    move = np.where(is_pad | is_self, 0.0, move)
    p_self = 1.0 - move.sum(axis=1, keepdims=True)
    out = np.where(is_self, p_self, move)
    out = np.maximum(out, 0.0)
    return (out / out.sum(axis=1, keepdims=True)).astype(np.float32)


def _simple_rw_block(nbrs: np.ndarray, deg_v: np.ndarray) -> np.ndarray:
    """Simple-RW rows on a padded block: 1/deg_v on true slots, pads 0."""
    width = nbrs.shape[1]
    is_pad = np.arange(width)[None, :] >= deg_v[:, None]
    out = np.where(is_pad, 0.0, 1.0 / deg_v[:, None].astype(np.float64))
    return out.astype(np.float32)


def _rows_ragged(graph, block_fn, chunk_rows: Optional[int] = None) -> np.ndarray:
    indptr = np.asarray(graph.indptr)
    indices = np.asarray(graph.indices)
    deg = np.asarray(graph.degrees, dtype=np.int64)
    n, max_deg = deg.size, int(deg.max())
    out = np.empty(indices.shape[0], dtype=np.float32)
    for ids in _ragged_row_chunks(n, max_deg, chunk_rows):
        nbrs = _pad_neighbor_lists(
            indptr, indices, deg, node_ids=ids, width=max_deg
        )
        out[indptr[ids[0]] : indptr[ids[-1] + 1]] = flat_edge_values(
            indptr, deg, block_fn(nbrs, ids, deg[ids]), node_ids=ids
        )
    return out


def simple_rw_rows_ragged(graph, chunk_rows: Optional[int] = None) -> np.ndarray:
    """Flat (nnz,) simple-RW probabilities for any CSR-core graph."""
    return _rows_ragged(
        graph, lambda nbrs, ids, deg_v: _simple_rw_block(nbrs, deg_v),
        chunk_rows,
    )


def mh_uniform_rows_ragged(graph, chunk_rows: Optional[int] = None) -> np.ndarray:
    """Flat (nnz,) MH-uniform probabilities for any CSR-core graph."""
    deg = np.asarray(graph.degrees, dtype=np.int64)
    weight = np.ones(deg.size)
    return _rows_ragged(
        graph,
        lambda nbrs, ids, deg_v: _mh_rows_block(nbrs, ids, deg_v, deg, weight),
        chunk_rows,
    )


def mh_importance_rows_ragged(
    graph, lipschitz: np.ndarray, chunk_rows: Optional[int] = None
) -> np.ndarray:
    """Flat (nnz,) P_IS probabilities of Eq. (7) for any CSR-core graph."""
    lipschitz = _check_lipschitz(graph, lipschitz)
    deg = np.asarray(graph.degrees, dtype=np.int64)
    return _rows_ragged(
        graph,
        lambda nbrs, ids, deg_v: _mh_rows_block(
            nbrs, ids, deg_v, deg, lipschitz
        ),
        chunk_rows,
    )
