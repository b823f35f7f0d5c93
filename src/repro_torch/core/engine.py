"""Batched MHLJ walk engine on the ragged layout — Algorithm 1 in PyTorch.

A transition for W parallel walks consumes a uniform block of shape
``(W, 3 + r)`` with slot layout::

    [jump_flag, mh, distance, hop_1 .. hop_r]
     U_JUMP     U_MH  U_DIST   U_HOP0 ..

Slot ``U_JUMP`` arrives as the {0.0, 1.0} Bernoulli(p_J) flag, resolved
before the transition (so ``p_j`` may be a per-step schedule).  The layout
is the ragged one: resident row state is one flat per-edge CDF aligned
with the CSR ``indices`` (exactly O(E)), the MH move binary-searches each
walk's own CDF segment, and the Lévy branch takes its d hops straight
from the CSR arrays.

:meth:`WalkEngine.step` sends every transition through
``repro_torch.kernels.walk_transition.walk_transition_ragged``: on CUDA
tensors that wrapper launches the hand-written kernel (or raises), on CPU
tensors it runs the plain composition of :func:`ragged_mh_invert`,
:func:`levy_jump_batched` and :func:`combine_mh_jump` below.

The engine draws its uniforms from an explicit ``torch.Generator``, or
takes an injected block — the seam the parity tests use to feed both
packages the same numbers.  Every step returns the Remark-1 hop count per
walk (1 for an MH move, d for a Lévy jump).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.graphs import _ragged_row_chunks
from repro_torch.core.levy import trunc_geom_icdf

__all__ = [
    "U_JUMP",
    "U_MH",
    "U_DIST",
    "U_HOP0",
    "num_uniforms",
    "search_iters",
    "p_is_rows_block",
    "ragged_edge_cdf",
    "ragged_mh_invert",
    "levy_jump_batched",
    "combine_mh_jump",
    "draw_uniforms",
    "WalkEngine",
]

# Uniform-block slot layout (shared with the CUDA kernel).
U_JUMP, U_MH, U_DIST, U_HOP0 = 0, 1, 2, 3

# int32 index math on the device: the flat buffers must stay below 2^31.
MAX_NNZ = 2**31 - 1


def num_uniforms(r: int) -> int:
    """Columns of the uniform block for jump range ``r``."""
    return U_HOP0 + r


def search_iters(max_degree: int) -> int:
    """Probes of the ragged binary search: ``ceil(log2(max_degree + 1))``."""
    return max(1, math.ceil(math.log2(max_degree + 1)))


def p_is_rows_block(
    nbrs: torch.Tensor,  # (rows, width) padded neighbor block
    self_ids: torch.Tensor,  # (rows,) owning node id per row
    deg_v: torch.Tensor,  # (rows,) true degree per row
    degrees: torch.Tensor,  # (n,) full degree vector (neighbor lookups)
    lipschitz: torch.Tensor,  # (n,) float32
) -> torch.Tensor:
    """Eq.-7 rows in float32 on a padded neighbor block (live rows).

    P(v,u) = min{1/deg(v), L_u / (deg(u) L_v)} for true neighbors u != v;
    leftover mass goes to the self slot, pads carry exactly 0.
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
    p_stay = 1.0 - move.sum(dim=-1, keepdim=True)
    probs = torch.where(is_self, p_stay, move)
    return torch.clamp(probs, min=0.0)


def ragged_edge_cdf(
    indptr,
    indices,
    degrees,
    *,
    row_probs=None,
    lipschitz=None,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """The flat per-edge CDF of the ragged layout — (nnz,) float32 on ``device``.

    Entry ``indptr[v] + k`` holds the inclusive CDF prefix of row v at slot
    k.  Rows are materialized on the device in bounded chunks at the max
    degree — the same chunks and width as the reference builder —
    cumulatively summed along the row and stripped of their pad columns.  The sum order is PyTorch's, so the bits may differ
    from the reference's in the last ulp; the walk kernels take whatever
    buffer they are given.

    Row source: ``row_probs``, a flat (nnz,) probability buffer (e.g.
    ``transition.mh_importance_rows_ragged``), or live Eq.-7 rows from a
    ``lipschitz`` vector.
    """
    indptr_np = np.asarray(indptr, dtype=np.int64)
    deg_np = np.asarray(degrees, dtype=np.int64)
    n, nnz, width = deg_np.size, int(indptr_np[-1]), int(deg_np.max())
    device = torch.device(device)
    flat = None
    if row_probs is not None:
        rp = np.asarray(row_probs)
        if rp.shape != (nnz,):
            raise ValueError(
                f"row_probs must be a flat (nnz,)=({nnz},) buffer, got "
                f"{rp.shape}"
            )
        flat = torch.as_tensor(rp.astype(np.float32), device=device)
    elif lipschitz is None:
        raise ValueError(
            "ragged_edge_cdf needs a row source: row_probs (flat buffer) "
            "or lipschitz"
        )
    else:
        lips = torch.as_tensor(
            np.asarray(lipschitz, dtype=np.float32), device=device
        )
        deg_t = torch.as_tensor(deg_np.astype(np.int32), device=device)
        idx_t = torch.as_tensor(
            np.asarray(indices).astype(np.int32), device=device
        )
    out = torch.empty(nnz, dtype=torch.float32, device=device)
    cols = torch.arange(width, device=device)
    for ids in _ragged_row_chunks(n, width):
        a, b = int(indptr_np[ids[0]]), int(indptr_np[ids[-1] + 1])
        deg_c = torch.as_tensor(deg_np[ids], device=device)
        mask = cols[None, :] < deg_c[:, None]
        if flat is not None:
            rows = torch.zeros((ids.size, width), device=device)
            rows[mask] = flat[a:b]
        else:
            ids_t = torch.as_tensor(ids.astype(np.int32), device=device)
            nbrs = ids_t[:, None].expand(ids.size, width).clone()
            nbrs[mask] = idx_t[a:b]
            rows = p_is_rows_block(nbrs, ids_t, deg_t[ids_t], deg_t, lips)
        out[a:b] = torch.cumsum(rows, dim=1)[mask]
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
    csr: tuple,  # (indptr, indices), both int32
) -> tuple:
    """The Lévy branch for W walks: d ~ TruncGeom(p_d, r), then d uniform
    hops, hop k of a walk at ``v`` going to
    ``indices[indptr[v] + min(floor(u * deg(v)), deg(v) - 1)]``.
    Returns ``(v_jump, d)``."""
    indptr, indices = csr
    d = trunc_geom_icdf(uniforms[:, U_DIST], p_d, r)
    v_cur = nodes
    for i in range(r):
        deg = degrees[v_cur]
        hop_idx = torch.minimum(
            (uniforms[:, U_HOP0 + i] * deg.to(torch.float32)).to(torch.int32),
            deg - 1,
        )
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


@dataclasses.dataclass(frozen=True, eq=False)
class WalkEngine:
    """Batched MHLJ sampler for W parallel walks on the ragged layout.

    All tensors live on ``device``; indices are int32.  Build with
    :meth:`from_graph` (or ``repro_torch.interop.from_reference_state``),
    then call :meth:`step` per transition or :meth:`run` for whole
    trajectories.
    """

    indptr: torch.Tensor  # (n+1,) int32 CSR row pointers
    indices: torch.Tensor  # (nnz,) int32 CSR neighbor ids
    degrees: torch.Tensor  # (n,) int32
    edge_cdf: torch.Tensor  # (nnz,) float32 flat per-edge CDF
    max_degree: int  # bound of the binary search
    p_j: float = 0.1  # default jump probability (overridable per call)
    p_d: float = 0.5
    r: int = 3

    @classmethod
    def from_graph(
        cls,
        graph,
        params,
        *,
        row_probs=None,
        lipschitz=None,
        device: Union[str, torch.device] = "cuda",
    ) -> "WalkEngine":
        """Engine from a ``repro_torch.core.graphs`` graph + ``MHLJParams``.

        The flat per-edge CDF is built once here from ``row_probs`` (a flat
        (nnz,) buffer) or from a static ``lipschitz`` vector (live Eq.-7
        rows); one of them is required.
        """
        params.validate()
        core = graph.to_ragged()
        if row_probs is None and lipschitz is None:
            raise ValueError(
                "the ragged layout precomputes its flat per-edge CDF at "
                "construction; pass row_probs or lipschitz to from_graph"
            )
        device = torch.device(device)
        edge_cdf = ragged_edge_cdf(
            core.indptr, core.indices, core.degrees,
            row_probs=row_probs, lipschitz=lipschitz, device=device,
        )
        max_degree = int(np.asarray(core.degrees).max())

        def dev(x):
            return torch.as_tensor(
                np.asarray(x).astype(np.int32), device=device
            )

        return cls(
            indptr=dev(core.indptr),
            indices=dev(core.indices),
            degrees=dev(core.degrees),
            edge_cdf=edge_cdf,
            max_degree=max_degree,
            p_j=params.p_j,
            p_d=params.p_d,
            r=params.r,
        )

    def __post_init__(self):
        if self.indices.shape[0] > MAX_NNZ:
            raise ValueError(
                f"nnz={self.indices.shape[0]} exceeds the int32 index range"
            )

    @property
    def device(self) -> torch.device:
        return self.edge_cdf.device

    @property
    def n(self) -> int:
        return int(self.degrees.shape[0])

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
    ) -> tuple:
        """One batched MHLJ transition of the (W,) int32 ``nodes``.

        Either ``uniforms`` — an injected ``(W, 3 + r)`` block whose slot 0
        already holds the jump flag — or ``generator``, from which the
        block is drawn with the flag ``u < p_j`` (``p_j`` defaults to the
        engine's).  Returns ``(next_nodes, hops)``, both (W,) int32.
        """
        from repro_torch.kernels.walk_transition.kernel import (
            walk_transition_ragged,
        )

        nodes = torch.as_tensor(nodes, dtype=torch.int32, device=self.device)
        if nodes.ndim != 1:
            raise ValueError(f"nodes must be (W,), got {tuple(nodes.shape)}")
        shape = (nodes.shape[0], num_uniforms(self.r))
        if uniforms is not None:
            u = self._check_block(uniforms, shape)
        elif generator is not None:
            u = draw_uniforms(
                shape[0], self.r, self.p_j if p_j is None else p_j,
                generator, self.device,
            )
        else:
            raise ValueError("pass uniforms= (injected block) or generator=")
        return walk_transition_ragged(
            nodes, self.indptr, self.degrees, self.indices, self.edge_cdf,
            u, p_d=self.p_d, r=self.r, max_degree=self.max_degree,
        )

    def run(
        self,
        v0s: torch.Tensor,
        num_steps: int,
        *,
        uniforms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        p_j=None,
    ) -> tuple:
        """Whole trajectories for W walks (Algorithm 1's update sequence).

        ``uniforms`` is an injected ``(T, W, 3 + r)`` block (slot 0 = flag);
        otherwise each step draws from ``generator`` with ``p_j`` a scalar
        or a (T,) schedule.  Returns ``(update_nodes, hops)``, both
        (W, T) int32: element t is the node holding the model when update
        t runs (the first at v0) and the hops taken after it.
        """
        v = torch.as_tensor(v0s, dtype=torch.int32, device=self.device)
        w = v.shape[0]
        if uniforms is not None:
            uniforms = self._check_block(
                uniforms, (num_steps, w, num_uniforms(self.r))
            )
        p_sched = torch.as_tensor(
            self.p_j if p_j is None else p_j, dtype=torch.float32,
            device=self.device,
        ).broadcast_to((num_steps,))
        nodes_out = torch.empty((num_steps, w), dtype=torch.int32,
                                device=self.device)
        hops_out = torch.empty_like(nodes_out)
        for t in range(num_steps):
            nodes_out[t] = v
            if uniforms is not None:
                v, hops = self.step(v, uniforms=uniforms[t])
            else:
                v, hops = self.step(v, generator=generator, p_j=p_sched[t])
            hops_out[t] = hops
        return nodes_out.T.contiguous(), hops_out.T.contiguous()
