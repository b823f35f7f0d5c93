"""The trap-prone graph samplers on the device, from torch random numbers.

The counterpart of the reference's ``jax_sampling``: the dynamic-graph
loop re-samples graphs between training epochs, so the random part of
the samplers runs on the device from a ``torch.Generator`` (or from
injected uniforms), and the host only turns the sample into a validated
``core.graphs`` class.

* :func:`barabasi_albert_edges` — the Batagelj–Brandes construction of
  ``graphs.barabasi_albert``: one float32 uniform per attachment edge, a
  product and a truncation, and the position→endpoint pointer chase as a
  synchronous loop ``p = where(unresolved(p), p[clip(e_prev)], p)``
  whose stop test (``any``) is a set-up host read;
* :func:`sbm_pair_mask` — a Bernoulli mask over all ``n(n-1)/2`` node
  pairs at the block-dependent probability;
* :func:`barabasi_albert_torch` / :func:`sbm_torch` — the validated graph
  classes (``from_edges``; the SBM retried until connected).

Given the reference's own uniforms the outputs are the reference's bit
for bit (one float32 product, a truncation and integer gathers).  Draws
from a generator differ from ``jax.random``'s by design: they are held at
the family level (``validate()`` passes, the graph is connected, BA has
``m(n-m)`` attachment edges).  The SBM mask is O(n²) pairs, which bounds
it to the analysis and Dada scales; ``graphs.sbm`` stays the large-graph
constructor.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.graphs import (
    _csr_graph_from_arrays,
    _csr_is_connected,
    _edges_to_csr,
    from_edges,
)

__all__ = [
    "barabasi_albert_edges",
    "barabasi_albert_torch",
    "sbm_pair_mask",
    "sbm_torch",
]


def _uniforms(shape, uniforms, generator, device) -> torch.Tensor:
    """``uniforms`` checked against ``shape`` (float32 on ``device``), or
    a fresh float32 draw from ``generator``."""
    if uniforms is not None:
        if not isinstance(uniforms, torch.Tensor):
            uniforms = torch.from_numpy(np.array(uniforms, dtype=np.float32))
        u = uniforms.to(device=device, dtype=torch.float32)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms must be {tuple(shape)}, got "
                             f"{tuple(u.shape)}")
        return u
    if generator is None:
        raise ValueError("pass uniforms= (injected) or generator=")
    return torch.rand(shape, generator=generator, device=device)


def barabasi_albert_edges(
    n: int,
    m: int,
    *,
    uniforms=None,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barabási–Albert attachment edges on the device.

    Edge ``e`` of node ``v = m + e//m`` takes a uniform position of the
    repeated endpoint list that earlier nodes' edges built (so the pick is
    degree-proportional): ``min(int(u · bound), bound - 1)`` with ``bound
    = 2m(v-m)``, ``u`` the edge's float32 uniform (``uniforms``, an
    ``(m(n-m),)`` array, or drawn from ``generator``).  An odd position
    points at an earlier edge's target and is chased until every pointer
    is resolved; the first ``m`` edges attach node ``m`` to ``0..m-1``.
    Returns ``(src, dst)`` int32 of the ``m(n-m)`` undirected edges, ``dst
    < src``.
    """
    if not (1 <= m < n):
        raise ValueError("barabasi_albert requires 1 <= m < n")
    device = torch.device(device)
    num_edges = m * (n - m)
    eidx = torch.arange(num_edges, dtype=torch.int32, device=device)
    src = m + eidx // m
    bound = 2 * m * (src - m)
    u = _uniforms((num_edges,), uniforms, generator, device)
    pos = torch.minimum(
        (u * bound.to(torch.float32)).to(torch.int32),
        torch.clamp(bound - 1, min=0),
    )

    def unresolved(p):
        return (p % 2 == 1) & ((p - 1) // 2 >= m)

    todo = unresolved(pos)
    while bool(todo.any()):  # a set-up host read per round
        e_prev = torch.clamp((pos - 1) // 2, 0, num_edges - 1)
        pos = torch.where(todo, pos[e_prev.long()], pos)
        todo = unresolved(pos)
    dst = torch.where(pos % 2 == 0, m + (pos // 2) // m, (pos - 1) // 2)
    dst = torch.where(eidx < m, eidx, dst)  # node m's seed attachments
    return src, dst


def barabasi_albert_torch(
    n: int,
    m: int,
    *,
    uniforms=None,
    generator: Optional[torch.Generator] = None,
    layout: str = "csr",
    bucket_factor: int = 2,
    device: Union[str, torch.device] = "cuda",
):
    """A validated BA graph of ``layout`` from :func:`barabasi_albert_edges`
    (``from_edges``: dedupe, self-loops, full validation)."""
    src, dst = barabasi_albert_edges(
        n, m, uniforms=uniforms, generator=generator, device=device
    )
    return from_edges(
        n,
        src.cpu().numpy().astype(np.int64),
        dst.cpu().numpy().astype(np.int64),
        name=f"ba_torch({n},{m})",
        layout=layout,
        bucket_factor=bucket_factor,
    )


def _sbm_pair_meta(block_sizes: Sequence[int]):
    sizes = np.asarray(block_sizes, dtype=np.int64)
    if sizes.ndim != 1 or sizes.size < 1 or np.any(sizes < 1):
        raise ValueError("block_sizes must be a non-empty list of positive ints")
    n = int(sizes.sum())
    block_ids = np.repeat(np.arange(sizes.size), sizes)
    i, j = np.triu_indices(n, k=1)
    return n, i, j, block_ids[i] == block_ids[j]


def sbm_pair_mask(
    block_sizes: Sequence[int],
    p_in: float,
    p_out: float,
    *,
    uniforms=None,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Bernoulli mask over all unordered node pairs, on the device.

    Entry ``k`` decides pair ``(i_k, j_k)`` of ``np.triu_indices(n, 1)``:
    present when its float32 uniform is below ``p_in`` inside a block,
    ``p_out`` across (both compared in float32).  ``uniforms`` is an
    ``(n(n-1)/2,)`` array, or the draw comes from ``generator``.
    """
    device = torch.device(device)
    _, _, _, same_block = _sbm_pair_meta(block_sizes)
    p_pair = torch.where(
        torch.as_tensor(same_block, device=device),
        torch.tensor(np.float32(p_in), device=device),
        torch.tensor(np.float32(p_out), device=device),
    )
    return _uniforms(p_pair.shape, uniforms, generator, device) < p_pair


def sbm_torch(
    block_sizes: Sequence[int],
    p_in: float,
    p_out: float,
    *,
    uniforms: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    layout: str = "csr",
    bucket_factor: int = 2,
    max_retries: int = 64,
    device: Union[str, torch.device] = "cuda",
):
    """A validated SBM graph of ``layout``, resampled until connected.

    Attempt ``a`` takes ``uniforms[a]`` (one ``(n(n-1)/2,)`` array per
    attempt, e.g. the reference's per-attempt draws) or a fresh draw from
    ``generator``; at most ``max_retries`` attempts.
    """
    for q, tag in ((p_in, "p_in"), (p_out, "p_out")):
        if not (0.0 <= float(q) <= 1.0):
            raise ValueError(f"{tag} must be in [0,1], got {q}")
    n, i, j, _ = _sbm_pair_meta(block_sizes)
    sizes = [int(s) for s in np.asarray(block_sizes, dtype=np.int64)]
    name = f"sbm_torch({sizes},{p_in},{p_out})"
    attempts = max_retries if uniforms is None else min(max_retries,
                                                        len(uniforms))
    for attempt in range(attempts):
        mask = sbm_pair_mask(
            block_sizes, p_in, p_out,
            uniforms=None if uniforms is None else uniforms[attempt],
            generator=generator, device=device,
        ).cpu().numpy()
        indptr, indices, degrees = _edges_to_csr(n, i[mask], j[mask])
        if _csr_is_connected(indptr, indices):
            return _csr_graph_from_arrays(
                indptr, indices, degrees, name, layout,
                bucket_factor=bucket_factor,
            )
    raise RuntimeError(
        f"could not sample a connected {name} in {attempts} tries"
    )
