"""Graph substrate of the port (numpy, host side).

A copy of the parts of ``repro.core.graphs`` that the ragged walk-SGD path
needs, kept bit-for-bit: the same constructions on the same seeds give
equal arrays.  Every node has a self-loop (paper §II.A).  Three classes:

* :class:`Graph` — dense ``(n, n)`` adjacency plus padded neighbor lists,
  for analysis-scale topologies and the dense chain laws of the tests;
* :class:`CSRGraph` — the O(E) CSR pair ``(indptr, indices)`` plus the
  padded ``(n, max_deg)`` neighbor tensor;
* :class:`RaggedCSRGraph` — the bare CSR core (``indptr``/``indices``/
  ``degrees`` and nothing sized by ``max_degree``), the substrate of the
  engine's ragged layout.

The degree-bucketed layout, edge churn and the other families (grid,
Watts-Strogatz, Erdos-Renyi, SBM, lollipop, ...) are not ported yet
(ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "CSRGraph",
    "RaggedCSRGraph",
    "flat_edge_values",
    "ring",
    "barabasi_albert",
    "dumbbell",
    "from_adjacency",
    "from_edges",
]

LAYOUTS = ("dense", "csr", "ragged")


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected graph with self-loops, in both dense and padded forms.

    Attributes:
      adj: (n, n) float64 {0,1} adjacency, symmetric, unit diagonal.
      neighbors: (n, max_deg) int32 padded neighbor lists: ascending ids
        (the node itself included), then pads that repeat the node's id.
      degrees: (n,) int32 true degrees (including the self-loop).
      name: human-readable description.
    """

    adj: np.ndarray
    neighbors: np.ndarray
    degrees: np.ndarray
    name: str = "graph"

    @property
    def n(self) -> int:
        return int(self.adj.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def num_edges(self) -> int:
        """Directed edge count incl. self-loops (nnz of the adjacency)."""
        return int(self.degrees.astype(np.int64).sum())

    def validate(self) -> None:
        a = self.adj
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not np.allclose(a, a.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if not np.all(np.diag(a) == 1):
            raise ValueError("every node needs a self-loop (paper §II.A)")
        if not np.all((a == 0) | (a == 1)):
            raise ValueError("adjacency entries must be 0/1")
        if not _is_connected(a):
            raise ValueError("graph must be connected")
        deg = a.sum(axis=1).astype(np.int64)
        if not np.array_equal(deg, self.degrees.astype(np.int64)):
            raise ValueError("degree vector inconsistent with adjacency")

    def to_csr(self) -> "CSRGraph":
        """O(E) CSR view of this graph (shared padded-neighbor ordering)."""
        rows, cols = np.nonzero(self.adj)  # row-major => sorted per row
        counts = np.bincount(rows, minlength=self.n).astype(np.int64)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        g = CSRGraph(
            indptr=indptr,
            indices=cols.astype(np.int32),
            degrees=self.degrees.copy(),
            neighbors=self.neighbors.copy(),
            name=self.name,
        )
        g.validate()
        return g

    def to_ragged(self) -> "RaggedCSRGraph":
        return self.to_csr().to_ragged()


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """An undirected graph with self-loops in O(E) sparse form.

    Attributes:
      indptr: (n+1,) int64 CSR row pointers.
      indices: (nnz,) int32 neighbor ids, ascending within each row,
        including the self-loop.
      degrees: (n,) int32 true degrees (== diff(indptr)).
      neighbors: (n, max_deg) int32 padded neighbor lists (pads = row id).
      name: human-readable description.
    """

    indptr: np.ndarray
    indices: np.ndarray
    degrees: np.ndarray
    neighbors: np.ndarray
    name: str = "csr-graph"

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def max_degree(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def validate(self) -> None:
        _validate_csr_core(self.indptr, self.indices, self.degrees)
        expect = _pad_neighbor_lists(self.indptr, self.indices, self.degrees)
        if not np.array_equal(expect, self.neighbors):
            raise ValueError("padded neighbor tensor inconsistent with CSR")

    def to_csr(self) -> "CSRGraph":
        return self

    def to_ragged(self) -> "RaggedCSRGraph":
        """Bare-CSR-core view (drops the padded tensor; O(E) resident)."""
        g = RaggedCSRGraph(
            indptr=self.indptr.copy(),
            indices=self.indices.copy(),
            degrees=self.degrees.copy(),
            name=self.name,
        )
        g.validate()
        return g


@dataclasses.dataclass(frozen=True)
class RaggedCSRGraph:
    """The bare CSR core — the zero-padding graph representation.

    Attributes:
      indptr: (n+1,) int64 CSR row pointers.
      indices: (nnz,) int32 neighbor ids, ascending within each row,
        including the self-loop.
      degrees: (n,) int32 true degrees (== diff(indptr)).
      name: human-readable description.
    """

    indptr: np.ndarray
    indices: np.ndarray
    degrees: np.ndarray
    name: str = "ragged-csr-graph"

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def validate(self) -> None:
        _validate_csr_core(self.indptr, self.indices, self.degrees)

    def to_ragged(self) -> "RaggedCSRGraph":
        return self

    def to_csr(self) -> CSRGraph:
        """Materialize the padded-tensor :class:`CSRGraph`."""
        g = CSRGraph(
            indptr=self.indptr.copy(),
            indices=self.indices.copy(),
            degrees=self.degrees.copy(),
            neighbors=_pad_neighbor_lists(
                self.indptr, self.indices, self.degrees
            ),
            name=self.name,
        )
        g.validate()
        return g


def flat_edge_values(
    indptr: np.ndarray,
    degrees: np.ndarray,
    table: np.ndarray,
    node_ids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Flatten per-row padded values into the flat per-edge buffer.

    Given a ``(rows, width)`` array aligned with the padded neighbor rows,
    returns the ``(nnz,)`` buffer holding each row's first ``deg(v)``
    entries in CSR edge order (aligned with ``indices``).  With
    ``node_ids`` the table covers only those rows.
    """
    if node_ids is None:
        node_ids = np.arange(indptr.shape[0] - 1, dtype=np.int64)
    deg = np.asarray(degrees, dtype=np.int64)[node_ids]
    if table.shape[0] != node_ids.shape[0] or table.shape[1] < int(
        deg.max(initial=0)
    ):
        raise ValueError("table shape inconsistent with the requested rows")
    mask = np.arange(table.shape[1])[None, :] < deg[:, None]
    return np.asarray(table)[mask]


def _ragged_row_chunks(n: int, max_deg: int, chunk_rows: Optional[int] = None):
    """Contiguous row-id chunks for the O(E) flat-buffer builders.

    Shared by ``transition._rows_ragged`` and ``engine.ragged_edge_cdf``:
    the chunk bounds the transient ``(chunk, max_deg)`` padded block at
    ~32 MB (floored at 256 rows), and each chunk is a contiguous ascending
    range, so its flat output is ``indptr[ids[0]] : indptr[ids[-1] + 1]``.
    """
    if chunk_rows is None:
        chunk_rows = max(256, min(n, (32 << 20) // max(1, 4 * max_deg)))
    for a in range(0, n, chunk_rows):
        yield np.arange(a, min(a + chunk_rows, n), dtype=np.int64)


# ---------------------------------------------------------------------------
# Construction machinery
# ---------------------------------------------------------------------------


def _is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        v = stack.pop()
        for u in np.nonzero(adj[v])[0]:
            if not seen[u]:
                seen[u] = True
                stack.append(int(u))
    return bool(seen.all())


def _concat_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of ``[arange(s, s+c) for s, c in zip(...)]``."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    cum = np.cumsum(counts)
    out[0] = starts[0]
    out[cum[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(out)


def _csr_is_connected(indptr: np.ndarray, indices: np.ndarray) -> bool:
    """BFS over the CSR structure — O(E) total, no dense matrix."""
    n = indptr.shape[0] - 1
    seen = np.zeros(n, dtype=bool)
    seen[0] = True
    frontier = np.array([0], dtype=np.int64)
    while frontier.size:
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        nbrs = indices[_concat_ranges(starts, counts)]
        new = np.unique(nbrs[~seen[nbrs]])
        seen[new] = True
        frontier = new
    return bool(seen.all())


def _validate_csr_core(
    indptr: np.ndarray, indices: np.ndarray, degrees: np.ndarray
) -> None:
    """Structural CSR checks: degree consistency, sortedness, symmetry,
    self-loops, connectivity.  Raises ``ValueError`` on the first failure."""
    n = indptr.shape[0] - 1
    deg = np.diff(indptr)
    if not np.array_equal(deg, degrees.astype(np.int64)):
        raise ValueError("degree vector inconsistent with indptr")
    if int(deg.min(initial=1)) < 1:
        raise ValueError("every node needs a self-loop (paper §II.A)")
    if indices.shape[0] != int(indptr[-1]):
        raise ValueError("indices length inconsistent with indptr")
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = indices.astype(np.int64)
    if np.any(dst < 0) or np.any(dst >= n):
        raise ValueError("neighbor ids out of range")
    codes = src * n + dst
    if np.any(np.diff(codes) <= 0):
        raise ValueError("CSR rows must be sorted and duplicate-free")
    if not np.array_equal(np.sort(dst * n + src), codes):
        raise ValueError("edge set must be symmetric (undirected graph)")
    self_codes = np.arange(n, dtype=np.int64) * (n + 1)
    pos = np.searchsorted(codes, self_codes)
    if np.any(pos >= codes.shape[0]) or np.any(codes[pos] != self_codes):
        raise ValueError("every node needs a self-loop (paper §II.A)")
    if not _csr_is_connected(indptr, indices):
        raise ValueError("graph must be connected")


def _edges_to_csr(n: int, src: np.ndarray, dst: np.ndarray):
    """Symmetrize + add self-loops + dedupe an edge list into sorted CSR."""
    keep = src != dst  # self-loops are added uniformly below
    src, dst = src[keep], dst[keep]
    loops = np.arange(n, dtype=np.int64)
    a = np.concatenate([src, dst, loops])
    b = np.concatenate([dst, src, loops])
    codes = np.unique(a * n + b)  # sorted row-major == sorted CSR
    rows = codes // n
    indices = (codes % n).astype(np.int32)
    degrees = np.bincount(rows, minlength=n).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    return indptr, indices, degrees


def _pad_neighbor_lists(
    indptr: np.ndarray,
    indices: np.ndarray,
    degrees: np.ndarray,
    node_ids: Optional[np.ndarray] = None,
    width: Optional[int] = None,
) -> np.ndarray:
    """Padded neighbor rows from CSR; pads repeat the row's own id.

    Default: the full ``(n, max_deg)`` tensor; with ``node_ids``/``width``
    only those rows at the requested width.
    """
    if node_ids is None:
        node_ids = np.arange(indptr.shape[0] - 1, dtype=np.int64)
    deg = np.asarray(degrees, dtype=np.int64)[node_ids]
    width = int(deg.max()) if width is None else int(width)
    out = np.repeat(node_ids.astype(np.int32)[:, None], width, axis=1)
    mask = np.arange(width)[None, :] < deg[:, None]
    out[mask] = indices[_concat_ranges(indptr[node_ids], deg)]
    return out


def from_adjacency(adj: np.ndarray, name: str = "graph") -> Graph:
    """Build a :class:`Graph` from a 0/1 adjacency; adds self-loops if absent."""
    adj = np.asarray(adj, dtype=np.float64).copy()
    np.fill_diagonal(adj, 1.0)
    adj = np.maximum(adj, adj.T)  # symmetrize
    degrees = adj.sum(axis=1).astype(np.int32)
    max_deg = int(degrees.max())
    n = adj.shape[0]
    neighbors = np.empty((n, max_deg), dtype=np.int32)
    for v in range(n):
        nbrs = np.nonzero(adj[v])[0].astype(np.int32)
        pad = np.full(max_deg - len(nbrs), v, dtype=np.int32)
        neighbors[v] = np.concatenate([nbrs, pad])
    g = Graph(adj=adj, neighbors=neighbors, degrees=degrees, name=name)
    g.validate()
    return g


def from_edges(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    name: str = "graph",
    layout: str = "csr",
):
    """Build a graph from an undirected edge list (self-loops added).

    ``layout="csr"`` is the O(E) path (no N×N array), ``"ragged"`` keeps
    only the bare CSR core, ``"dense"`` routes through
    :func:`from_adjacency`.  All validate on construction.
    """
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError("src/dst edge arrays must have the same length")
    if src.size and (
        min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n
    ):
        raise ValueError("edge endpoints out of range")
    if layout == "dense":
        adj = np.zeros((n, n), dtype=np.float64)
        adj[src, dst] = 1.0
        return from_adjacency(adj, name=name)
    if layout not in LAYOUTS:
        raise ValueError(
            f"layout must be one of {LAYOUTS} (the bucketed layout is not "
            f"ported yet), got {layout!r}"
        )
    indptr, indices, degrees = _edges_to_csr(n, src, dst)
    _validate_csr_core(indptr, indices, degrees)
    if layout == "ragged":
        return RaggedCSRGraph(
            indptr=indptr, indices=indices, degrees=degrees, name=name
        )
    return CSRGraph(
        indptr=indptr,
        indices=indices,
        degrees=degrees,
        neighbors=_pad_neighbor_lists(indptr, indices, degrees),
        name=name,
    )


# ---------------------------------------------------------------------------
# Topologies
# ---------------------------------------------------------------------------


def ring(n: int, layout: str = "dense"):
    """Ring of n nodes — the paper's canonical entrapment topology (Fig 2a)."""
    if n < 3:
        raise ValueError("ring needs n >= 3")
    idx = np.arange(n, dtype=np.int64)
    return from_edges(n, idx, (idx + 1) % n, name=f"ring({n})", layout=layout)


def barabasi_albert(n: int, m: int, seed: int = 0, layout: str = "dense"):
    """Barabasi-Albert preferential attachment: hubs = degree-bias traps.

    Batagelj–Brandes repeated-nodes construction, vectorized: edge ``e`` of
    new node ``v`` picks a uniform position of the repeated endpoint list
    built by all earlier nodes' edges, and the position→endpoint
    indirection is resolved by vectorized pointer chasing (odd positions
    point at an earlier edge's target, whose own draw strictly precedes
    it).  Node ``m`` seeds the process by attaching to all of ``0..m-1``.
    """
    if not (1 <= m < n):
        raise ValueError("barabasi_albert requires 1 <= m < n")
    rng = np.random.default_rng(seed)
    num_edges = m * (n - m)
    src = m + np.arange(num_edges, dtype=np.int64) // m
    bound = 2 * m * (src - m)
    pos = np.zeros(num_edges, dtype=np.int64)
    if num_edges > m:
        pos[m:] = rng.integers(0, bound[m:])
    while True:
        e_prev = (pos - 1) // 2
        unresolved = (pos % 2 == 1) & (e_prev >= m)
        if not unresolved.any():
            break
        pos[unresolved] = pos[e_prev[unresolved]]
    dst = np.where(pos % 2 == 0, m + (pos // 2) // m, (pos - 1) // 2)
    dst[:m] = np.arange(m)  # the seed attachments
    return from_edges(n, src, dst, name=f"ba({n},{m})", layout=layout)


def dumbbell(clique_n: int, path_len: int = 1, layout: str = "dense"):
    """Two ``clique_n``-cliques joined by a ``path_len``-node path.

    The bridge is a single-edge bottleneck, so a walk entering one bell is
    trapped for Omega(clique_n^2) expected steps.  ``path_len=0`` joins
    the cliques by a direct edge.
    """
    if clique_n < 3:
        raise ValueError("dumbbell needs clique_n >= 3")
    if path_len < 0:
        raise ValueError("dumbbell needs path_len >= 0")
    n = 2 * clique_n + path_len
    iu, ju = np.triu_indices(clique_n, k=1)
    off_b = clique_n + path_len
    chain = np.concatenate(
        [[clique_n - 1], np.arange(clique_n, off_b), [off_b]]
    )
    src = np.concatenate([iu, iu + off_b, chain[:-1]])
    dst = np.concatenate([ju, ju + off_b, chain[1:]])
    return from_edges(
        n, src, dst, name=f"dumbbell({clique_n},{path_len})", layout=layout
    )
