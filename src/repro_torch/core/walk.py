"""Random-walk simulators (paper §II.C + Algorithm 1) over the port's engine.

The thin trajectory-shaped consumers of
:class:`~repro_torch.core.engine.WalkEngine`, as in ``repro.core.walk``:

* :func:`walk_mhlj` / :func:`walk_mhlj_batched` — Algorithm 1 exactly, via
  ``WalkEngine.run``: per iteration the flag J ~ Ber(p_J); J=0 -> one MH-IS
  hop, J=1 -> d ~ TruncGeom(p_d, r) uniform hops without updates.  They
  return the *update* nodes v_t and the physical transitions per
  iteration (Remark-1 accounting).  ``p_j`` may be a scalar or a (T,)
  schedule (Fig 6 annealing).
* :func:`walk_markov` / :func:`walk_markov_batched` — a 1-hop chain given
  padded per-row probabilities (simple RW, MH-uniform, MH-IS).  The
  reference draws it by a Gumbel categorical; the port runs the engine at
  p_J = 0 on the same padded rows, so the same law is inverted by the
  port's row-CDF rule — on the card through the sparse walk kernel.  It
  agrees with the reference in law, not in bits.
* :func:`empirical_distribution` — the visit distribution of a sequence.

Graphs enter as the padded neighbor tensors ``neighbors`` (n, max_deg) with
degree vector ``degrees`` (:func:`graph_tensors`); 1-hop rows enter as
(n, max_deg) probabilities aligned with ``neighbors``, pads 0.  Randomness
is an explicit ``torch.Generator`` or an injected uniform block of shape
``(T, W, 3 + r)`` whose slot 0 already holds the jump flag (the walk axis
is absent for a single walk); a Markov walk's block has r = 1 and a zero
flag.  Every tensor lives on the device of ``neighbors``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import WalkEngine, num_uniforms

__all__ = [
    "graph_tensors",
    "walk_markov",
    "walk_mhlj",
    "walk_markov_batched",
    "walk_mhlj_batched",
    "empirical_distribution",
]


def graph_tensors(
    graph, device: Union[str, torch.device] = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device tensors (neighbors int32 (n, max_deg), degrees int32 (n,)).

    Accepts a dense :class:`~repro_torch.core.graphs.Graph` or a
    :class:`~repro_torch.core.graphs.CSRGraph`; a bucketed or ragged graph
    has no padded neighbor tensor and raises.
    """
    if not hasattr(graph, "neighbors"):
        raise TypeError(
            "graph has no padded neighbor tensor (bucketed or ragged "
            "layout?); use WalkEngine.from_graph(graph, ...) or "
            "graph.to_csr() instead"
        )
    device = torch.device(device)
    return (
        torch.as_tensor(np.asarray(graph.neighbors, np.int32), device=device),
        torch.as_tensor(np.asarray(graph.degrees, np.int32), device=device),
    )


def _engine(row_probs, neighbors, degrees, p_d: float, r: int) -> WalkEngine:
    neighbors = torch.as_tensor(neighbors, dtype=torch.int32)
    return WalkEngine(
        degrees=torch.as_tensor(
            degrees, dtype=torch.int32, device=neighbors.device
        ),
        layout="sparse",
        p_j=0.0,
        p_d=p_d,
        r=r,
        neighbors=neighbors,
        row_probs=torch.as_tensor(
            row_probs, dtype=torch.float32, device=neighbors.device
        ),
    )


def walk_markov_batched(
    row_probs: torch.Tensor,  # (n, max_deg) float, aligned with neighbors
    neighbors: torch.Tensor,  # (n, max_deg) int32
    v0s: torch.Tensor,  # (W,)
    num_steps: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """W independent 1-hop chains; returns trajectories (W, num_steps+1).

    The engine at p_J = 0: its jump branch is computed and discarded, so
    its hop index reads the padded table at full width (pads hold the
    row's own id) and no degree vector is needed.  ``uniforms`` is a
    ``(num_steps, W, 4)`` block with slot 0 zero.
    """
    n, width = neighbors.shape
    degrees = torch.full((n,), width, dtype=torch.int32,
                         device=neighbors.device)
    engine = _engine(row_probs, neighbors, degrees, 0.5, 1)
    v = torch.as_tensor(v0s, dtype=torch.int32, device=engine.device)
    if v.ndim != 1:
        raise ValueError(f"v0s must be (W,), got {tuple(v.shape)}")
    shape = (num_steps, v.shape[0], num_uniforms(1))
    if uniforms is not None:
        if tuple(uniforms.shape) != shape:
            raise ValueError(
                f"uniforms must be {shape}, got {tuple(uniforms.shape)}"
            )
        if bool((uniforms[..., 0] != 0).any()):
            raise ValueError("a Markov walk's block must carry a zero jump flag")
    elif generator is None:
        raise ValueError("pass uniforms= (injected block) or generator=")
    traj = torch.empty((num_steps + 1, v.shape[0]), dtype=torch.int32,
                       device=engine.device)
    traj[0] = v
    for t in range(num_steps):
        if uniforms is not None:
            v, _ = engine.step(v, uniforms=uniforms[t])
        else:
            v, _ = engine.step(v, generator=generator, p_j=0.0)
        traj[t + 1] = v
    return traj.T.contiguous()


def walk_markov(
    row_probs: torch.Tensor,
    neighbors: torch.Tensor,
    v0: int,
    num_steps: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Simulate one 1-hop chain; returns the trajectory (num_steps+1,).
    ``uniforms`` is a ``(num_steps, 4)`` block with slot 0 zero."""
    if uniforms is not None and uniforms.ndim == 2:
        uniforms = uniforms[:, None]
    v0s = torch.as_tensor([int(v0)], dtype=torch.int32)
    return walk_markov_batched(
        row_probs, neighbors, v0s, num_steps, generator=generator,
        uniforms=uniforms,
    )[0]


def walk_mhlj_batched(
    is_row_probs: torch.Tensor,  # (n, max_deg) P_IS rows
    neighbors: torch.Tensor,  # (n, max_deg) int32
    degrees: torch.Tensor,  # (n,) int32
    v0s: torch.Tensor,  # (W,), or 0-d for one walk
    num_steps: int,
    p_j,
    p_d: float,
    r: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """W Algorithm-1 walks in one batched engine run (one sparse-layout
    transition services all W walks per step).

    Returns ``(update_nodes, transitions)``, both (W, num_steps) int32:
    element t is the node holding the model when update t runs (the first
    at v0) and the physical hops taken after it (1 for an MH move, d for a
    jump).  A 0-d ``v0s`` drops the walk axis.
    """
    engine = _engine(is_row_probs, neighbors, degrees, p_d, r)
    return engine.run(
        v0s, num_steps, uniforms=uniforms, generator=generator, p_j=p_j
    )


def walk_mhlj(
    is_row_probs: torch.Tensor,
    neighbors: torch.Tensor,
    degrees: torch.Tensor,
    v0: int,
    num_steps: int,
    p_j,
    p_d: float,
    r: int,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1's node sequence for a single walk: ``(update_nodes,
    transitions)``, both (num_steps,) int32 (see :func:`walk_mhlj_batched`).
    ``uniforms`` is a ``(num_steps, 3 + r)`` block."""
    v0 = torch.as_tensor(int(v0), dtype=torch.int32)
    return walk_mhlj_batched(
        is_row_probs, neighbors, degrees, v0, num_steps, p_j, p_d, r,
        generator=generator, uniforms=uniforms,
    )


def empirical_distribution(
    update_nodes: np.ndarray, n: int, burn_in: int = 0
) -> np.ndarray:
    """Empirical visit distribution of the update sequence after burn-in."""
    seq = np.asarray(update_nodes)[..., burn_in:].ravel()
    counts = np.bincount(seq, minlength=n).astype(np.float64)
    return counts / counts.sum()
