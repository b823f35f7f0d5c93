"""Chain-law rows for the walk engine's four layouts (numpy, host side).

A copy of the parts of ``repro.core.transition`` that the engine's layouts
need, bit for bit:

1. ``simple_rw``      P(v,u) = 1/deg(v)
2. ``mh``             general Metropolis–Hastings, Eq. (6)
3. ``mh_uniform``     MH targeting uniform pi
4. ``mh_importance``  P_IS of Eq. (7): MH targeting pi_IS ∝ L_v
5. ``mhlj``           P = (1-p_J) P_IS + p_J P_Lévy (paper §V), dense only

Each law comes as a dense row-stochastic ``(n, n)`` matrix (a
:class:`~repro_torch.core.graphs.Graph` only; :func:`row_probs_padded`
gathers it onto the padded neighbor lists), as padded ``(n, max_deg)``
rows built from local information, as a tuple of per-bucket
``(n_b, width_b)`` rows, or as a flat ``(nnz,)`` buffer aligned with the
CSR ``indices``.  The local builders share one block function per law,
and pads carry exactly 0, so a bucket row is the column truncation of the
padded row and a flat entry is the padded entry.  The MHLJ law exists
only as the dense matrix :func:`mhlj`, for the chain analysis: the engine
samples it in two phases (MH move or Lévy jump).

Two more laws are MH with another target, through the same block math:
the heterogeneity-aware law (``heterogeneity_*``, MH targeting a pi from
:mod:`repro_torch.core.heterogeneity`) and the private weighted walk
(``private_weighted_*``, MH targeting Gamma-noised weights from
:func:`private_weights`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import levy as levy_mod
from repro_torch.core.graphs import (
    Graph,
    _pad_neighbor_lists,
    _ragged_row_chunks,
    flat_edge_values,
)

__all__ = [
    "MHLJParams",
    "simple_rw",
    "mh",
    "mh_uniform",
    "mh_importance",
    "mhlj",
    "is_row_stochastic",
    "supported_on_graph",
    "row_probs_padded",
    "simple_rw_rows",
    "mh_uniform_rows",
    "mh_importance_rows",
    "simple_rw_rows_bucketed",
    "mh_uniform_rows_bucketed",
    "mh_importance_rows_bucketed",
    "simple_rw_rows_ragged",
    "mh_uniform_rows_ragged",
    "mh_importance_rows_ragged",
    "heterogeneity_mh",
    "heterogeneity_rows",
    "heterogeneity_rows_bucketed",
    "heterogeneity_rows_ragged",
    "private_weights",
    "private_weighted_mh",
    "private_weighted_rows",
    "private_weighted_rows_bucketed",
    "private_weighted_rows_ragged",
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


def simple_rw(graph: Graph) -> np.ndarray:
    """Uniform neighbor choice: P(v,u) = 1/deg(v) on edges (incl. self-loop)."""
    a = graph.adj
    return a / a.sum(axis=1, keepdims=True)


def mh(graph: Graph, pi: np.ndarray, q: Optional[np.ndarray] = None) -> np.ndarray:
    """General Metropolis–Hastings transition, paper Eq. (6).

    P(i,j) = Q(i,j) min{1, pi_j Q(j,i) / (pi_i Q(i,j))} for i != j on edges,
    diagonal = leftover mass.  Q defaults to the simple random walk; a
    custom ``q`` must be row-stochastic and supported on the graph, else
    this raises.
    """
    pi = np.asarray(pi, dtype=np.float64)
    if pi.shape != (graph.n,):
        raise ValueError(f"pi must have shape ({graph.n},), got {pi.shape}")
    if np.any(pi <= 0):
        raise ValueError("pi must be strictly positive")
    pi = pi / pi.sum()
    if q is None:
        q = simple_rw(graph)
    else:
        q = np.asarray(q, dtype=np.float64)
        if q.shape != (graph.n, graph.n):
            raise ValueError(
                f"proposal q must have shape ({graph.n}, {graph.n}), "
                f"got {q.shape}"
            )
        if not is_row_stochastic(q, atol=1e-8):
            bad = np.abs(q.sum(axis=1) - 1.0).argmax()
            raise ValueError(
                "proposal q is not row-stochastic (row "
                f"{bad} sums to {q.sum(axis=1)[bad]:.6g} or carries "
                "negative mass); refusing to renormalize silently"
            )
        if not supported_on_graph(q, graph, atol=1e-12):
            raise ValueError(
                "proposal q places mass on non-edges; the MH chain of an "
                "off-graph proposal is not implementable by a walk on this "
                "graph"
            )

    a = graph.adj
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (pi[None, :] * q.T) / (pi[:, None] * q)
    ratio = np.where(q > 0, ratio, 0.0)
    p = q * np.minimum(1.0, ratio)
    p *= a
    np.fill_diagonal(p, 0.0)
    np.fill_diagonal(p, 1.0 - p.sum(axis=1))
    diag = np.diag(p).copy()
    if np.any(diag < -1e-12):
        raise AssertionError("MH construction produced negative self-loop mass")
    np.fill_diagonal(p, np.maximum(diag, 0.0))
    p /= p.sum(axis=1, keepdims=True)
    return p


def mh_uniform(graph: Graph) -> np.ndarray:
    """MH targeting the uniform distribution (paper design 2)."""
    return mh(graph, np.full(graph.n, 1.0 / graph.n))


def mh_importance(graph: Graph, lipschitz: np.ndarray) -> np.ndarray:
    """P_IS of paper Eq. (7): MH targeting pi_IS(v) ∝ L_v."""
    lipschitz = np.asarray(lipschitz, dtype=np.float64)
    if lipschitz.shape != (graph.n,):
        raise ValueError(
            f"lipschitz must have shape ({graph.n},), got {lipschitz.shape}"
        )
    if np.any(lipschitz <= 0):
        raise ValueError("Lipschitz constants must be strictly positive")
    return mh(graph, lipschitz / lipschitz.sum())


def mhlj(
    graph: Graph,
    lipschitz: np.ndarray,
    params: MHLJParams,
    *,
    chained_levy: bool = True,
) -> np.ndarray:
    """MHLJ effective transition: P = (1 - p_J) P_IS + p_J P_Lévy (paper §V).

    ``chained_levy=True`` uses the exact law of Algorithm 1's jump loop
    (composition of uniform hops); ``False`` uses the paper's adjacency-power
    closed form.  They coincide on regular graphs (ring, torus grid).
    """
    params.validate()
    p_is = mh_importance(graph, lipschitz)
    if params.p_j == 0.0:
        return p_is
    if chained_levy:
        p_levy = levy_mod.levy_matrix_chained(graph, params.p_d, params.r)
    else:
        p_levy = levy_mod.levy_matrix(graph, params.p_d, params.r)
    return (1.0 - params.p_j) * p_is + params.p_j * p_levy


def is_row_stochastic(p: np.ndarray, atol: float = 1e-9) -> bool:
    return bool(
        np.all(p >= -atol) and np.allclose(p.sum(axis=1), 1.0, atol=atol)
    )


def supported_on_graph(p: np.ndarray, graph: Graph, atol: float = 1e-12) -> bool:
    """True iff P(i,j) > 0 only where adj(i,j) = 1 (1-hop kernels)."""
    off_support = p * (1.0 - np.minimum(graph.adj, 1.0))
    return bool(np.abs(off_support).max() <= atol)


def row_probs_padded(p: np.ndarray, graph: Graph) -> np.ndarray:
    """Gather each row of a 1-hop-supported P onto the padded neighbor
    lists: (n, max_deg) float32 aligned with ``graph.neighbors``, pads 0."""
    if not supported_on_graph(p, graph):
        raise ValueError("row_probs_padded requires a 1-hop-supported kernel")
    n, max_deg = graph.neighbors.shape
    out = np.zeros((n, max_deg), dtype=np.float32)
    for v in range(n):
        deg = int(graph.degrees[v])
        nbrs = graph.neighbors[v, :deg]
        out[v, :deg] = p[v, nbrs]
    s = out.sum(axis=1, keepdims=True)
    return (out / s).astype(np.float32)


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


def _graph_locals(graph):
    nbrs = np.asarray(graph.neighbors)
    deg = np.asarray(graph.degrees, dtype=np.int64)
    return nbrs, np.arange(graph.n, dtype=np.int64), deg


def simple_rw_rows(graph) -> np.ndarray:
    """Padded rows of the simple RW: 1/deg(v) on every true neighbor slot."""
    nbrs, _, deg = _graph_locals(graph)
    return _simple_rw_block(nbrs, deg)


def mh_uniform_rows(graph) -> np.ndarray:
    """Padded MH rows targeting uniform pi: P(v,u) = min{1/deg_v, 1/deg_u}."""
    nbrs, ids, deg = _graph_locals(graph)
    return _mh_rows_block(nbrs, ids, deg, deg, np.ones(graph.n))


def mh_importance_rows(graph, lipschitz: np.ndarray) -> np.ndarray:
    """Padded P_IS rows of Eq. (7) from local info only."""
    lipschitz = _check_lipschitz(graph, lipschitz)
    nbrs, ids, deg = _graph_locals(graph)
    return _mh_rows_block(nbrs, ids, deg, deg, lipschitz)


def simple_rw_rows_bucketed(graph) -> tuple:
    """Per-bucket simple-RW rows for a :class:`BucketedCSRGraph`."""
    deg = np.asarray(graph.degrees, dtype=np.int64)
    return tuple(
        _simple_rw_block(b.neighbors, deg[b.node_ids]) for b in graph.buckets
    )


def _mh_rows_bucketed(graph, target_weight: np.ndarray) -> tuple:
    deg = np.asarray(graph.degrees, dtype=np.int64)
    return tuple(
        _mh_rows_block(
            b.neighbors, b.node_ids.astype(np.int64),
            deg[b.node_ids], deg, target_weight,
        )
        for b in graph.buckets
    )


def mh_uniform_rows_bucketed(graph) -> tuple:
    """Per-bucket MH-uniform rows for a :class:`BucketedCSRGraph`."""
    return _mh_rows_bucketed(graph, np.ones(graph.n))


def mh_importance_rows_bucketed(graph, lipschitz: np.ndarray) -> tuple:
    """Per-bucket P_IS rows of Eq. (7) for a :class:`BucketedCSRGraph`."""
    return _mh_rows_bucketed(graph, _check_lipschitz(graph, lipschitz))


def _rows_ragged(
    graph,
    block_fn,
    chunk_rows: Optional[int] = None,
    node_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    indptr = np.asarray(graph.indptr)
    indices = np.asarray(graph.indices)
    deg = np.asarray(graph.degrees, dtype=np.int64)
    n, max_deg = deg.size, int(deg.max())
    if node_ids is not None:
        # the rows of node_ids only, in ascending CSR edge order — the
        # ``touched_probs`` of ``engine.ragged_edge_cdf_update``; built at
        # the graph's full max_deg width, as the full build is
        ids = np.asarray(node_ids, dtype=np.int64)
        if ids.size and (
            np.any(np.diff(ids) <= 0) or ids[0] < 0 or ids[-1] >= n
        ):
            raise ValueError(
                "node_ids must be unique ascending node ids in range "
                "(EdgeChurn.touched_rows is)"
            )
        nbrs = _pad_neighbor_lists(
            indptr, indices, deg, node_ids=ids, width=max_deg
        )
        return flat_edge_values(
            indptr, deg, block_fn(nbrs, ids, deg[ids]), node_ids=ids
        )
    out = np.empty(indices.shape[0], dtype=np.float32)
    for ids in _ragged_row_chunks(n, max_deg, chunk_rows):
        nbrs = _pad_neighbor_lists(
            indptr, indices, deg, node_ids=ids, width=max_deg
        )
        out[indptr[ids[0]] : indptr[ids[-1] + 1]] = flat_edge_values(
            indptr, deg, block_fn(nbrs, ids, deg[ids]), node_ids=ids
        )
    return out


def simple_rw_rows_ragged(
    graph,
    chunk_rows: Optional[int] = None,
    node_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Flat (nnz,) simple-RW probabilities for any CSR-core graph.

    ``node_ids`` (unique ascending) restricts the buffer to those rows,
    each bit for bit its entry of the full build: the row source of
    ``engine.ragged_edge_cdf_update`` (so of the four builders below).
    """
    return _rows_ragged(
        graph, lambda nbrs, ids, deg_v: _simple_rw_block(nbrs, deg_v),
        chunk_rows, node_ids,
    )


def mh_uniform_rows_ragged(
    graph,
    chunk_rows: Optional[int] = None,
    node_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Flat (nnz,) MH-uniform probabilities for any CSR-core graph."""
    deg = np.asarray(graph.degrees, dtype=np.int64)
    weight = np.ones(deg.size)
    return _rows_ragged(
        graph,
        lambda nbrs, ids, deg_v: _mh_rows_block(nbrs, ids, deg_v, deg, weight),
        chunk_rows, node_ids,
    )


def mh_importance_rows_ragged(
    graph,
    lipschitz: np.ndarray,
    chunk_rows: Optional[int] = None,
    node_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Flat (nnz,) P_IS probabilities of Eq. (7) for any CSR-core graph."""
    lipschitz = _check_lipschitz(graph, lipschitz)
    deg = np.asarray(graph.degrees, dtype=np.int64)
    return _rows_ragged(
        graph,
        lambda nbrs, ids, deg_v: _mh_rows_block(
            nbrs, ids, deg_v, deg, lipschitz
        ),
        chunk_rows, node_ids,
    )


# -- the heterogeneity-aware law (Dandi et al., arXiv:2204.06477) ------------
#
# MH targeting the pi that ``repro_torch.core.heterogeneity`` optimizes
# against the measured gradient-dissimilarity matrix: Eq. (6) with w = pi,
# one call into the shared block math on every layout.


def _check_target_pi(graph, pi) -> np.ndarray:
    pi = np.asarray(pi, dtype=np.float64)
    if pi.shape != (graph.n,):
        raise ValueError(f"pi must have shape ({graph.n},), got {pi.shape}")
    if np.any(pi <= 0):
        raise ValueError(
            "heterogeneity target pi must be strictly positive — a zero "
            "entry disconnects the MH chain (use the optimizer's floor)"
        )
    return pi


def heterogeneity_mh(graph: Graph, pi: np.ndarray) -> np.ndarray:
    """Dense MH chain targeting a heterogeneity-optimized (n,) ``pi``."""
    return mh(graph, _check_target_pi(graph, pi))


def heterogeneity_rows(graph, pi: np.ndarray) -> np.ndarray:
    """Padded MH rows targeting a heterogeneity-optimized pi."""
    pi = _check_target_pi(graph, pi)
    nbrs, ids, deg = _graph_locals(graph)
    return _mh_rows_block(nbrs, ids, deg, deg, pi)


def heterogeneity_rows_bucketed(graph, pi: np.ndarray) -> tuple:
    """Per-bucket heterogeneity-law rows for a :class:`BucketedCSRGraph`."""
    return _mh_rows_bucketed(graph, _check_target_pi(graph, pi))


def heterogeneity_rows_ragged(
    graph,
    pi: np.ndarray,
    chunk_rows: Optional[int] = None,
    node_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Flat (nnz,) heterogeneity-law probabilities for any CSR-core graph."""
    pi = _check_target_pi(graph, pi)
    deg = np.asarray(graph.degrees, dtype=np.int64)
    return _rows_ragged(
        graph,
        lambda nbrs, ids, deg_v: _mh_rows_block(nbrs, ids, deg_v, deg, pi),
        chunk_rows, node_ids,
    )


# -- the private weighted walk (Ayache & El Rouayheb, arXiv:2009.01790) ------
#
# MH targeting Gamma-perturbed weights ŵ_v = w_v + G_v, G_v ~ Gamma(1/n,
# theta) i.i.d., theta = gamma · n · mean(w): the aggregate noise is an
# Exponential(theta) whatever n, while each node's share stays vague.


def private_weights(
    weights: np.ndarray, gamma: float, *, seed: int = 0
) -> np.ndarray:
    """Gamma-noised node weights ŵ = w + G, G_v ~ Gamma(1/n, gamma·n·w̄),
    drawn once from ``np.random.default_rng(seed)``; ``gamma=0`` returns
    ``w`` exactly."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1:
        raise ValueError(f"weights must be (n,), got shape {w.shape}")
    if np.any(w <= 0):
        raise ValueError("node weights must be strictly positive")
    if gamma < 0:
        raise ValueError(f"privacy gamma must be >= 0, got {gamma}")
    if gamma == 0.0:
        return w.copy()
    n = w.size
    rng = np.random.default_rng(seed)
    noise = rng.gamma(shape=1.0 / n, scale=gamma * n * w.mean(), size=n)
    return w + noise


def _private_target(graph, weights, gamma, seed) -> np.ndarray:
    return private_weights(_check_lipschitz(graph, weights), gamma, seed=seed)


def private_weighted_mh(
    graph: Graph, weights: np.ndarray, gamma: float, *, seed: int = 0
) -> np.ndarray:
    """Dense private weighted walk: MH targeting ŵ = ``private_weights``."""
    w_hat = _private_target(graph, weights, gamma, seed)
    return mh(graph, w_hat / w_hat.sum())


def private_weighted_rows(
    graph, weights: np.ndarray, gamma: float, *, seed: int = 0
) -> np.ndarray:
    """Padded private-weighted-walk rows (MH targeting ŵ)."""
    w_hat = _private_target(graph, weights, gamma, seed)
    nbrs, ids, deg = _graph_locals(graph)
    return _mh_rows_block(nbrs, ids, deg, deg, w_hat)


def private_weighted_rows_bucketed(
    graph, weights: np.ndarray, gamma: float, *, seed: int = 0
) -> tuple:
    """Per-bucket private-weighted-walk rows for a :class:`BucketedCSRGraph`."""
    return _mh_rows_bucketed(graph, _private_target(graph, weights, gamma, seed))


def private_weighted_rows_ragged(
    graph,
    weights: np.ndarray,
    gamma: float,
    *,
    seed: int = 0,
    chunk_rows: Optional[int] = None,
    node_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Flat (nnz,) private-weighted-walk probabilities for any CSR-core
    graph.  The noise depends on (weights, gamma, seed) only, never on
    ``node_ids``, so a restricted buffer matches the full build."""
    w_hat = _private_target(graph, weights, gamma, seed)
    deg = np.asarray(graph.degrees, dtype=np.int64)
    return _rows_ragged(
        graph,
        lambda nbrs, ids, deg_v: _mh_rows_block(nbrs, ids, deg_v, deg, w_hat),
        chunk_rows, node_ids,
    )
