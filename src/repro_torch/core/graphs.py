"""Graph substrate of the port (numpy, host side).

A copy of the parts of ``repro.core.graphs`` that the walk engine's four
layouts need, kept bit-for-bit: the same constructions on the same seeds
give equal arrays.  Every node has a self-loop (paper §II.A).  Four
classes, one per engine layout:

* :class:`Graph` — dense ``(n, n)`` adjacency plus padded neighbor lists,
  for analysis-scale topologies and the dense chain laws (``sparse``);
* :class:`CSRGraph` — the O(E) CSR pair ``(indptr, indices)`` plus the
  padded ``(n, max_deg)`` neighbor tensor (``sparse``);
* :class:`BucketedCSRGraph` — rows grouped into geometric degree buckets,
  each padded only to its own width; a bucket row is the column
  truncation of the padded row (``bucketed``);
* :class:`RaggedCSRGraph` — the bare CSR core (``indptr``/``indices``/
  ``degrees`` and nothing sized by ``max_degree``), the substrate of the
  engine's ragged layout.

Families: ``ring``, ``grid2d``, ``watts_strogatz``, ``erdos_renyi``,
``star``, ``complete``, ``expander``, ``barabasi_albert``, ``sbm``,
``dumbbell`` and ``lollipop``.  :func:`apply_edge_churn` inserts and
deletes a batch of undirected edges on a ``CSRGraph`` or
``RaggedCSRGraph`` and returns the :class:`EdgeChurn` receipt that the
engine's segment-local CDF patch and the fleet's walk-continuity rule
key off (docs/dynamic_graphs.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "Graph",
    "CSRGraph",
    "DegreeBucket",
    "BucketedCSRGraph",
    "RaggedCSRGraph",
    "EdgeChurn",
    "apply_edge_churn",
    "flat_edge_values",
    "ring",
    "grid2d",
    "watts_strogatz",
    "erdos_renyi",
    "star",
    "complete",
    "expander",
    "barabasi_albert",
    "sbm",
    "dumbbell",
    "lollipop",
    "from_adjacency",
    "from_edges",
]

LAYOUTS = ("dense", "csr", "bucketed", "ragged")


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

    def row(self, v: int) -> np.ndarray:
        """True (unpadded) neighbor ids of node v."""
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def validate(self) -> None:
        _validate_csr_core(self.indptr, self.indices, self.degrees)
        expect = _pad_neighbor_lists(self.indptr, self.indices, self.degrees)
        if not np.array_equal(expect, self.neighbors):
            raise ValueError("padded neighbor tensor inconsistent with CSR")

    def to_csr(self) -> "CSRGraph":
        return self

    def apply_edge_churn(
        self, insert=None, delete=None, *, check_connectivity: bool = False
    ):
        """Batched edge insert/delete — see :func:`apply_edge_churn`.
        Returns ``(new_graph, EdgeChurn)``."""
        return apply_edge_churn(
            self, insert, delete, check_connectivity=check_connectivity
        )

    def to_bucketed(
        self, min_width: int = 8, bucket_factor: int = 2
    ) -> "BucketedCSRGraph":
        """Degree-bucketed view with the width ladder ``min_width·f^k``
        (clamped to ``max_degree``), ``f = bucket_factor``."""
        return _bucketed_from_csr_arrays(
            self.indptr.copy(), self.indices.copy(), self.degrees.copy(),
            min_width=min_width, bucket_factor=bucket_factor,
            name=self.name,
        )

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

    def to_dense(self) -> Graph:
        """Materialize the dense :class:`Graph` (analysis-scale only)."""
        n = self.n
        adj = np.zeros((n, n), dtype=np.float64)
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(self.indptr))
        adj[src, self.indices.astype(np.int64)] = 1.0
        g = Graph(
            adj=adj,
            neighbors=self.neighbors.copy(),
            degrees=self.degrees.copy(),
            name=self.name,
        )
        g.validate()
        return g


@dataclasses.dataclass(frozen=True)
class DegreeBucket:
    """One degree bucket of a :class:`BucketedCSRGraph`.

    Attributes:
      width: padded row width of this bucket (every member's degree ≤ width).
      node_ids: (n_b,) int32 member node ids, ascending.
      neighbors: (n_b, width) int32 padded neighbor rows — each the column
        truncation of the member's full padded row.
    """

    width: int
    node_ids: np.ndarray
    neighbors: np.ndarray


@dataclasses.dataclass(frozen=True)
class BucketedCSRGraph:
    """Degree-bucketed layout for hub-heavy graphs.

    Rows are grouped into geometric degree buckets and padded per bucket,
    so storage is O(E + Σ_b n_b·width_b) instead of O(n·max_deg), while
    each bucket row stays a column truncation of the shared padded row.
    Built via :meth:`CSRGraph.to_bucketed`; ``to_csr()`` round-trips.

    Attributes:
      indptr/indices/degrees: the O(E) CSR core.
      node_bucket: (n,) int32 bucket id per node.
      node_slot: (n,) int32 row index of the node inside its bucket.
      buckets: tuple of :class:`DegreeBucket`, widths strictly increasing.
      name: human-readable description.
    """

    indptr: np.ndarray
    indices: np.ndarray
    degrees: np.ndarray
    node_bucket: np.ndarray
    node_slot: np.ndarray
    buckets: tuple
    name: str = "bucketed-csr-graph"
    min_width: int = 8
    bucket_factor: int = 2

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def bucket_widths(self) -> tuple:
        return tuple(b.width for b in self.buckets)

    def row(self, v: int) -> np.ndarray:
        """True (unpadded) neighbor ids of node v."""
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def validate(self) -> None:
        _validate_csr_core(self.indptr, self.indices, self.degrees)
        widths = np.asarray(self.bucket_widths, dtype=np.int64)
        if widths.size == 0 or np.any(np.diff(widths) <= 0):
            raise ValueError("bucket widths must be non-empty and increasing")
        deg = self.degrees.astype(np.int64)
        seen = np.zeros(self.n, dtype=np.int64)
        for b, bk in enumerate(self.buckets):
            ids = bk.node_ids.astype(np.int64)
            if np.any(np.diff(ids) <= 0):
                raise ValueError("bucket node_ids must be ascending")
            seen[ids] += 1
            if not np.array_equal(self.node_bucket[ids], np.full(ids.size, b)):
                raise ValueError("node_bucket inconsistent with bucket members")
            if not np.array_equal(
                self.node_slot[ids], np.arange(ids.size, dtype=np.int64)
            ):
                raise ValueError("node_slot inconsistent with bucket order")
            if np.any(deg[ids] > bk.width):
                raise ValueError("bucket member degree exceeds bucket width")
            if b > 0 and np.any(deg[ids] <= self.buckets[b - 1].width):
                raise ValueError(
                    "bucket member would fit in a smaller bucket"
                )
            expect = _pad_neighbor_lists(
                self.indptr, self.indices, self.degrees,
                node_ids=ids, width=bk.width,
            )
            if not np.array_equal(expect, bk.neighbors):
                raise ValueError("bucket neighbor rows inconsistent with CSR")
        if not np.all(seen == 1):
            raise ValueError("buckets must partition the node set")

    def to_csr(self) -> CSRGraph:
        """Round-trip back to the padded CSR layout."""
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

    def to_bucketed(
        self, min_width: int = 8, bucket_factor: int = 2
    ) -> "BucketedCSRGraph":
        """Identity when the requested ladder matches this graph's; otherwise
        re-buckets straight from the CSR core."""
        if (min_width, bucket_factor) == (self.min_width, self.bucket_factor):
            return self
        return _bucketed_from_csr_arrays(
            self.indptr.copy(), self.indices.copy(), self.degrees.copy(),
            min_width=min_width, bucket_factor=bucket_factor,
            name=self.name,
        )

    def to_ragged(self) -> "RaggedCSRGraph":
        """Bare-CSR-core view (drops the per-bucket tables)."""
        g = RaggedCSRGraph(
            indptr=self.indptr.copy(),
            indices=self.indices.copy(),
            degrees=self.degrees.copy(),
            name=self.name,
        )
        g.validate()
        return g

    def to_dense(self) -> Graph:
        """Materialize the dense :class:`Graph` (analysis-scale only)."""
        return self.to_csr().to_dense()


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

    def row(self, v: int) -> np.ndarray:
        """True (unpadded) neighbor ids of node v."""
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def validate(self) -> None:
        _validate_csr_core(self.indptr, self.indices, self.degrees)

    def apply_edge_churn(
        self, insert=None, delete=None, *, check_connectivity: bool = False
    ):
        """Batched edge insert/delete — see :func:`apply_edge_churn`.
        Returns ``(new_graph, EdgeChurn)``."""
        return apply_edge_churn(
            self, insert, delete, check_connectivity=check_connectivity
        )

    def to_ragged(self) -> "RaggedCSRGraph":
        return self

    def to_bucketed(
        self, min_width: int = 8, bucket_factor: int = 2
    ) -> BucketedCSRGraph:
        """Degree-bucketed view straight from the core (no padded table)."""
        return _bucketed_from_csr_arrays(
            self.indptr.copy(), self.indices.copy(), self.degrees.copy(),
            min_width=min_width, bucket_factor=bucket_factor,
            name=self.name,
        )

    def to_dense(self) -> Graph:
        """Materialize the dense :class:`Graph` (analysis-scale only)."""
        return self.to_csr().to_dense()

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
    bucket_factor: int = 2,
):
    """Build a graph from an undirected edge list (self-loops added).

    ``layout="csr"`` is the O(E) path (no N×N array), ``"bucketed"`` buckets
    straight from the CSR core (the padded table never exists),
    ``"ragged"`` keeps only the bare CSR core, ``"dense"`` routes through
    :func:`from_adjacency`.  ``bucket_factor`` picks the bucketed width
    ladder.  All validate on construction.
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
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    indptr, indices, degrees = _edges_to_csr(n, src, dst)
    return _csr_graph_from_arrays(
        indptr, indices, degrees, name, layout, bucket_factor=bucket_factor
    )


def _csr_graph_from_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    degrees: np.ndarray,
    name: str,
    layout: str,
    bucket_factor: int = 2,
):
    """Validated graph of ``layout`` from already-built CSR arrays."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "bucketed":
        _validate_csr_core(indptr, indices, degrees)
        return _bucketed_from_csr_arrays(
            indptr, indices, degrees,
            min_width=8, bucket_factor=bucket_factor, name=name,
        )
    if layout == "ragged":
        _validate_csr_core(indptr, indices, degrees)
        return RaggedCSRGraph(
            indptr=indptr, indices=indices, degrees=degrees, name=name
        )
    g = CSRGraph(
        indptr=indptr,
        indices=indices,
        degrees=degrees,
        neighbors=_pad_neighbor_lists(indptr, indices, degrees),
        name=name,
    )
    g.validate()
    return g.to_dense() if layout == "dense" else g


def _bucket_widths_ladder(
    max_deg: int, min_width: int, bucket_factor: int
) -> np.ndarray:
    """The geometric bucket-width ladder ``min_width·bucket_factor^k``,
    clamped to ``max_deg`` (so the last rung is exactly ``max_deg``)."""
    if min_width < 1:
        raise ValueError("min_width must be >= 1")
    if bucket_factor < 2:
        raise ValueError("bucket_factor must be >= 2")
    ladder = [min_width]
    while ladder[-1] < max_deg:
        ladder.append(ladder[-1] * bucket_factor)
    return np.minimum(np.asarray(ladder, dtype=np.int64), max_deg)


def _bucketed_from_csr_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    degrees: np.ndarray,
    *,
    min_width: int,
    bucket_factor: int,
    name: str,
) -> BucketedCSRGraph:
    """Degree-bucketed graph straight from a validated CSR core: only the
    per-bucket padded rows are materialized, never the full table."""
    deg = np.asarray(degrees, dtype=np.int64)
    max_deg = int(deg.max())
    ladder = _bucket_widths_ladder(max_deg, min_width, bucket_factor)
    width_of = ladder[np.searchsorted(ladder, deg, side="left")]
    widths = np.unique(width_of)
    node_bucket = np.searchsorted(widths, width_of).astype(np.int32)
    node_slot = np.empty(deg.size, dtype=np.int32)
    buckets = []
    for b, w in enumerate(widths):
        ids = np.nonzero(node_bucket == b)[0]  # ascending node ids
        node_slot[ids] = np.arange(ids.size, dtype=np.int32)
        buckets.append(
            DegreeBucket(
                width=int(w),
                node_ids=ids.astype(np.int32),
                neighbors=_pad_neighbor_lists(
                    indptr, indices, degrees, node_ids=ids, width=int(w)
                ),
            )
        )
    return BucketedCSRGraph(
        indptr=indptr,
        indices=indices,
        degrees=degrees,
        node_bucket=node_bucket,
        node_slot=node_slot,
        buckets=tuple(buckets),
        name=name,
        min_width=min_width,
        bucket_factor=bucket_factor,
    )


# ---------------------------------------------------------------------------
# Dynamic graphs: batched edge churn
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EdgeChurn:
    """Receipt of one batch applied by :func:`apply_edge_churn`.

    Attributes:
      inserted: (k_i, 2) int64 undirected pairs inserted, ``(min, max)``
        each, sorted by pair code ``lo*n + hi``.
      deleted: (k_d, 2) int64 undirected pairs deleted, same form.
      endpoints: unique ascending int64 ids of the nodes incident to a
        churned edge — the rows whose neighbor lists changed.
      degree_changed: the endpoints whose degree changed (a node that
        gained and lost as many edges keeps its degree).
      touched_rows: unique ascending int64 ids of the rows whose per-edge
        state must be recomputed: ``endpoints`` plus every new-graph
        neighbor of a node in ``degree_changed`` (an MH row reads its
        neighbors' degrees, Eq. 7).
      num_edges_before/num_edges_after: directed nnz incl. self-loops.
    """

    inserted: np.ndarray
    deleted: np.ndarray
    endpoints: np.ndarray
    degree_changed: np.ndarray
    touched_rows: np.ndarray
    num_edges_before: int
    num_edges_after: int


def _canonical_pairs(pairs, n: int, tag: str) -> np.ndarray:
    """A batch of undirected pairs checked and put in canonical form:
    ``(min, max)`` rows sorted by ``lo*n + hi``.  Raises on a batch that
    is not ``(k, 2)``, on ids out of range, on a self-pair (self-loops are
    structural, paper §II.A) and on a duplicate pair."""
    if pairs is None:
        return np.empty((0, 2), dtype=np.int64)
    arr = np.asarray(pairs, dtype=np.int64)
    if arr.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"{tag} must be a (k, 2) array of node pairs")
    if arr.min() < 0 or arr.max() >= n:
        raise ValueError(f"{tag} endpoints out of range for n={n}")
    if np.any(arr[:, 0] == arr[:, 1]):
        raise ValueError(
            f"{tag} contains a self-loop; self-loops are structural "
            "(paper §II.A) and cannot be churned"
        )
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    order = np.argsort(lo * n + hi, kind="stable")
    lo, hi = lo[order], hi[order]
    if np.any((np.diff(lo) == 0) & (np.diff(hi) == 0)):
        raise ValueError(f"{tag} contains duplicate undirected pairs")
    return np.stack([lo, hi], axis=1)


def _directed_codes(pairs: np.ndarray, n: int) -> np.ndarray:
    """Sorted int64 ``src*n + dst`` codes of both orientations of each
    pair — the edge-code space of the CSR core."""
    a = np.concatenate([pairs[:, 0], pairs[:, 1]])
    b = np.concatenate([pairs[:, 1], pairs[:, 0]])
    return np.sort(a * n + b)


def apply_edge_churn(
    graph,
    insert=None,
    delete=None,
    *,
    check_connectivity: bool = False,
):
    """Insert and delete a batch of undirected edges of a sparse graph.

    Returns ``(new_graph, churn)``: ``new_graph`` of ``graph``'s class
    (:class:`CSRGraph` or :class:`RaggedCSRGraph`) and the
    :class:`EdgeChurn` receipt.  The update is linear passes over the
    sorted edge-code array (deletes masked out of it, inserts merged in
    at their ``searchsorted`` positions), so the new core is sorted,
    symmetric and self-looped by construction; ``validate()`` stays the
    from-scratch audit.  Host numpy, bit for bit the reference's.

    The whole batch is checked before anything changes, and a bad one
    raises ``ValueError``: a self-pair, a duplicate pair or an id out of
    range in either side, an insert that overlaps a delete, a delete of an
    absent edge, an insert of a present one.  A node may lose its last
    non-loop edge: it "departs" (degree 1, its self-loop) and stays a
    row; ``check_connectivity=True`` raises instead when the new graph is
    disconnected.
    """
    if not isinstance(graph, (CSRGraph, RaggedCSRGraph)):
        raise TypeError(
            "apply_edge_churn needs a CSRGraph or RaggedCSRGraph, got "
            f"{type(graph).__name__}; convert dense/bucketed graphs via "
            "to_csr()/to_ragged() first"
        )
    n = graph.n
    ins = _canonical_pairs(insert, n, "insert")
    dele = _canonical_pairs(delete, n, "delete")
    if ins.shape[0] and dele.shape[0]:
        overlap = np.intersect1d(
            ins[:, 0] * n + ins[:, 1], dele[:, 0] * n + dele[:, 1]
        )
        if overlap.size:
            raise ValueError(
                "insert and delete batches overlap on "
                f"{overlap.size} pair(s); resolve the net churn first"
            )

    indptr = np.asarray(graph.indptr, dtype=np.int64)
    deg_old = np.diff(indptr)
    nnz_old = int(graph.indices.shape[0])
    codes_old = (
        np.repeat(np.arange(n, dtype=np.int64), deg_old) * n
        + graph.indices.astype(np.int64)
    )  # sorted: the CSR invariant

    kept = codes_old
    if dele.shape[0]:
        del_codes = _directed_codes(dele, n)
        pos = np.searchsorted(codes_old, del_codes)
        if np.any(pos >= nnz_old) or np.any(codes_old[pos] != del_codes):
            raise ValueError(
                "delete batch contains an edge not present in the graph"
            )
        mask = np.ones(nnz_old, dtype=bool)
        mask[pos] = False
        kept = codes_old[mask]
    if ins.shape[0]:
        ins_codes = _directed_codes(ins, n)
        pos = np.searchsorted(kept, ins_codes)
        clamped = np.minimum(pos, kept.shape[0] - 1)
        if kept.size and np.any(kept[clamped] == ins_codes):
            raise ValueError(
                "insert batch contains an edge already present in the graph"
            )
        new_codes = np.insert(kept, pos, ins_codes)
    else:
        new_codes = kept

    new_rows = new_codes // n
    new_indices = (new_codes % n).astype(np.int32)
    new_degrees = np.bincount(new_rows, minlength=n).astype(np.int32)
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_degrees, out=new_indptr[1:])
    if check_connectivity and not _csr_is_connected(new_indptr, new_indices):
        raise ValueError("churn disconnects the graph")

    if ins.shape[0] or dele.shape[0]:
        endpoints = np.unique(np.concatenate([ins.ravel(), dele.ravel()]))
    else:
        endpoints = np.empty(0, dtype=np.int64)
    deg_new64 = new_degrees.astype(np.int64)
    degree_changed = endpoints[deg_new64[endpoints] != deg_old[endpoints]]
    if degree_changed.size:
        nbrs = new_indices[
            _concat_ranges(new_indptr[degree_changed], deg_new64[degree_changed])
        ].astype(np.int64)
        touched_rows = np.unique(np.concatenate([endpoints, nbrs]))
    else:
        touched_rows = endpoints

    churn = EdgeChurn(
        inserted=ins,
        deleted=dele,
        endpoints=endpoints,
        degree_changed=degree_changed,
        touched_rows=touched_rows,
        num_edges_before=nnz_old,
        num_edges_after=int(new_codes.shape[0]),
    )
    if isinstance(graph, RaggedCSRGraph):
        return RaggedCSRGraph(
            indptr=new_indptr, indices=new_indices, degrees=new_degrees,
            name=graph.name,
        ), churn

    # CSRGraph: while the padded width survives only the endpoint rows
    # change (pads repeat the row's own id), so patch those rows
    old_width = int(graph.neighbors.shape[1])
    if int(deg_new64.max()) == old_width:
        neighbors = graph.neighbors.copy()
        if endpoints.size:
            neighbors[endpoints] = _pad_neighbor_lists(
                new_indptr, new_indices, new_degrees,
                node_ids=endpoints, width=old_width,
            )
    else:
        neighbors = _pad_neighbor_lists(new_indptr, new_indices, new_degrees)
    return CSRGraph(
        indptr=new_indptr, indices=new_indices, degrees=new_degrees,
        neighbors=neighbors, name=graph.name,
    ), churn


# ---------------------------------------------------------------------------
# Topologies
# ---------------------------------------------------------------------------


def ring(n: int, layout: str = "dense", bucket_factor: int = 2):
    """Ring of n nodes — the paper's canonical entrapment topology (Fig 2a)."""
    if n < 3:
        raise ValueError("ring needs n >= 3")
    idx = np.arange(n, dtype=np.int64)
    return from_edges(
        n, idx, (idx + 1) % n, name=f"ring({n})", layout=layout,
        bucket_factor=bucket_factor,
    )


def grid2d(
    rows: int,
    cols: Optional[int] = None,
    layout: str = "dense",
    bucket_factor: int = 2,
):
    """2-D grid (paper Fig 5a uses ~1000 nodes)."""
    cols = cols or rows
    n = rows * cols
    ids = np.arange(n, dtype=np.int64).reshape(rows, cols)
    src = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    dst = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    return from_edges(
        n, src, dst, name=f"grid2d({rows}x{cols})", layout=layout,
        bucket_factor=bucket_factor,
    )


def watts_strogatz(n: int, k: int, p: float, seed: int = 0) -> Graph:
    """Watts-Strogatz small world (paper Fig 5b: WS(1000, 4, 0.1)).

    Ring lattice with k nearest neighbors (k even), each "forward" edge
    rewired with probability p (no self/multi edges).  A rewiring that
    disconnects the graph retries with the next seed.
    """
    if k % 2 != 0 or k >= n:
        raise ValueError("watts_strogatz requires even k < n")
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n))
    for v in range(n):
        for j in range(1, k // 2 + 1):
            adj[v, (v + j) % n] = 1
            adj[(v + j) % n, v] = 1
    for v in range(n):
        for j in range(1, k // 2 + 1):
            if rng.random() < p:
                u = (v + j) % n
                # rewire edge (v, u) -> (v, w)
                candidates = np.nonzero((adj[v] == 0))[0]
                candidates = candidates[candidates != v]
                if len(candidates) == 0:
                    continue
                w = int(rng.choice(candidates))
                adj[v, u] = adj[u, v] = 0
                adj[v, w] = adj[w, v] = 1
    if not _is_connected(np.maximum(adj, np.eye(n))):
        return watts_strogatz(n, k, p, seed=seed + 1)
    return from_adjacency(adj, name=f"ws({n},{k},{p})")  # validates


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    """Erdos-Renyi G(n, p) (paper Fig 4 uses ER(1000, 0.1)); resamples
    until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(64):
        upper = rng.random((n, n)) < p
        adj = np.triu(upper, k=1).astype(np.float64)
        adj = adj + adj.T
        if _is_connected(np.maximum(adj, np.eye(n))):
            return from_adjacency(adj, name=f"er({n},{p})")  # validates
    raise RuntimeError(f"could not sample a connected ER({n},{p}) in 64 tries")


def star(n: int) -> Graph:
    """Star graph — worst-case hub topology, useful in entrapment tests."""
    adj = np.zeros((n, n))
    adj[0, 1:] = 1
    adj[1:, 0] = 1
    return from_adjacency(adj, name=f"star({n})")


def complete(n: int) -> Graph:
    """Complete graph — the centralized-equivalent reference topology."""
    adj = np.ones((n, n))
    return from_adjacency(adj, name=f"complete({n})")


def expander(n: int, d: int = 6, seed: int = 0) -> Graph:
    """Random d-regular-ish expander: the union of d/2 random perfect
    matchings plus a ring (for connectivity).  Good conductance — a control
    topology where entrapment should not occur."""
    if n % 2 != 0:
        raise ValueError("expander needs even n")
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n))
    for _ in range(max(1, d // 2)):
        perm = rng.permutation(n)
        for i in range(0, n, 2):
            a, b = perm[i], perm[i + 1]
            adj[a, b] = adj[b, a] = 1
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = 1
    adj[(idx + 1) % n, idx] = 1
    return from_adjacency(adj, name=f"expander({n},{d})")  # validates


def barabasi_albert(
    n: int, m: int, seed: int = 0, layout: str = "dense",
    bucket_factor: int = 2,
):
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
    return from_edges(
        n, src, dst, name=f"ba({n},{m})", layout=layout,
        bucket_factor=bucket_factor,
    )


def _tri_decode(codes: np.ndarray, s: int):
    """Decode c in [0, s(s-1)/2) to the c-th pair (i, j), i < j, row-major."""
    c = codes.astype(np.float64)
    i = np.floor((2 * s - 1 - np.sqrt((2 * s - 1) ** 2 - 8 * c)) / 2).astype(
        np.int64
    )

    def rowstart(k):
        return k * s - k * (k + 1) // 2

    i[codes < rowstart(i)] -= 1  # fix sqrt rounding either way
    i[codes >= rowstart(i + 1)] += 1
    j = codes - rowstart(i) + i + 1
    return i, j


def _sample_distinct_codes(rng, pairs: int, count: int) -> np.ndarray:
    """``count`` distinct uniform draws from [0, pairs) without allocating
    O(pairs): draw with replacement and top up until all are distinct."""
    codes = np.unique(rng.integers(0, pairs, size=count))
    while codes.size < count:
        extra = rng.integers(0, pairs, size=count - codes.size)
        codes = np.unique(np.concatenate([codes, extra]))
    return codes


def sbm(
    block_sizes: Sequence[int],
    p_in: float,
    p_out: float,
    seed: int = 0,
    layout: str = "dense",
    bucket_factor: int = 2,
):
    """Stochastic block model with tunable inter-cluster bottlenecks.

    Edges are sampled sparsely per block pair — a Binomial(pairs, p) count,
    then that many distinct uniform pair codes — so construction is O(E);
    resamples (seed ``seed + 9973·attempt``) until connected.
    """
    sizes = np.asarray(block_sizes, dtype=np.int64)
    if sizes.ndim != 1 or sizes.size < 1 or np.any(sizes < 1):
        raise ValueError("block_sizes must be a non-empty list of positive ints")
    for q, tag in ((p_in, "p_in"), (p_out, "p_out")):
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"{tag} must be in [0,1], got {q}")
    n = int(sizes.sum())
    offs = np.zeros(sizes.size, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offs[1:])
    name = f"sbm({list(map(int, sizes))},{p_in},{p_out})"
    for attempt in range(64):
        rng = np.random.default_rng(seed + 9973 * attempt)
        src_parts, dst_parts = [], []
        for a in range(sizes.size):
            s_a = int(sizes[a])
            pairs = s_a * (s_a - 1) // 2
            if pairs and p_in > 0:
                count = rng.binomial(pairs, p_in)
                if count:
                    codes = _sample_distinct_codes(rng, pairs, count)
                    i, j = _tri_decode(codes, s_a)
                    src_parts.append(i + offs[a])
                    dst_parts.append(j + offs[a])
            for b in range(a + 1, sizes.size):
                s_b = int(sizes[b])
                count = rng.binomial(s_a * s_b, p_out)
                if count:
                    codes = _sample_distinct_codes(rng, s_a * s_b, count)
                    src_parts.append(codes // s_b + offs[a])
                    dst_parts.append(codes % s_b + offs[b])
        src = np.concatenate(src_parts) if src_parts else np.empty(0, np.int64)
        dst = np.concatenate(dst_parts) if dst_parts else np.empty(0, np.int64)
        indptr, indices, degrees = _edges_to_csr(n, src, dst)
        if _csr_is_connected(indptr, indices):
            return _csr_graph_from_arrays(
                indptr, indices, degrees, name, layout,
                bucket_factor=bucket_factor,
            )
    raise RuntimeError(f"could not sample a connected {name} in 64 tries")


def dumbbell(
    clique_n: int, path_len: int = 1, layout: str = "dense",
    bucket_factor: int = 2,
):
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
        n, src, dst, name=f"dumbbell({clique_n},{path_len})", layout=layout,
        bucket_factor=bucket_factor,
    )


def lollipop(
    clique_n: int, path_len: int, layout: str = "dense",
    bucket_factor: int = 2,
):
    """A ``clique_n``-clique with a ``path_len``-node path hanging off it.

    Maximizes hitting time clique -> path tip (the classical Theta(n^3)
    lollipop bound) — the sharpest single-walk entrapment stressor.
    """
    if clique_n < 3:
        raise ValueError("lollipop needs clique_n >= 3")
    if path_len < 1:
        raise ValueError("lollipop needs path_len >= 1")
    n = clique_n + path_len
    iu, ju = np.triu_indices(clique_n, k=1)
    chain = np.concatenate([[clique_n - 1], np.arange(clique_n, n)])
    src = np.concatenate([iu, chain[:-1]])
    dst = np.concatenate([ju, chain[1:]])
    return from_edges(
        n, src, dst, name=f"lollipop({clique_n},{path_len})", layout=layout,
        bucket_factor=bucket_factor,
    )
