"""Carry the JAX package's walk state into the port.

The port reads the reference's state as plain numpy arrays — it imports
nothing of the JAX package — and rebuilds its own engine (and fleet) on
the requested device.  Parity tests use this to hand the reference's
exact per-edge CDF to the port, so a last-ulp difference between the two
CDF builders cannot hide or fake a sampler fault.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core.engine import WalkEngine
from repro_torch.walk_sgd.fleet import WalkFleet

__all__ = ["from_reference_state"]


def from_reference_state(
    *,
    indptr,
    indices,
    degrees,
    edge_cdf,
    max_degree: int,
    cdf_width: int,
    p_d: float,
    r: int,
    p_j: float = 0.0,
    nodes=None,
    models=None,
    avg_every: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> tuple:
    """Port engine, fleet and models from the reference's numpy state.

    ``indptr``/``indices``/``degrees``/``edge_cdf``/``max_degree``/
    ``cdf_width``/``p_d``/``r`` are a reference ragged ``WalkEngine``'s
    fields (the port builds no CDF here, so ``cdf_width`` is only checked
    against ``max_degree``); ``nodes`` the fleet's (W,) positions and ``models`` its
    (W, dim) per-walker models.  Returns ``(engine, fleet, models)`` —
    ``fleet`` is None without ``nodes``, ``models`` None without models.
    """
    device = torch.device(device)
    indices = np.asarray(indices)
    edge_cdf = np.array(edge_cdf, dtype=np.float32)  # own, writable copy
    if edge_cdf.shape != indices.shape:
        raise ValueError("edge_cdf and indices must both be (nnz,)")
    if cdf_width < max_degree:
        raise ValueError("cdf_width must cover max_degree")

    def i32(x):
        return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)

    engine = WalkEngine(
        indptr=i32(indptr),
        indices=i32(indices),
        degrees=i32(degrees),
        edge_cdf=torch.as_tensor(edge_cdf, device=device),
        max_degree=int(max_degree),
        p_j=float(p_j),
        p_d=float(p_d),
        r=int(r),
    )
    fleet = None
    if nodes is not None:
        nodes = np.asarray(nodes, np.int32)
        fleet = WalkFleet.create(
            engine, int(nodes.shape[0]), v0s=nodes, avg_every=avg_every
        )
    if models is not None:
        models = torch.as_tensor(np.asarray(models, np.float32), device=device)
    return engine, fleet, models
