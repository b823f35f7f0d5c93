"""What the figure modules share: the MSE milestones (a copy of the
reference's ``benchmarks/common.py::milestones``) and :func:`train`, the
one training call, which takes an optional injected uniform block.

``blocks`` is ``None`` (each call draws from the trainer's
``torch.Generator``, seeded with the call's ``seed`` as the reference seeds
its key) or a callable ``blocks(*, tag, method, seed, num_steps,
num_walks, r, p_j)`` that returns the ``(num_steps, num_walks, 3 + r)``
float32 block for that call — slot 0 the jump flag drawn at the (T,)
float32 schedule ``p_j`` — or ``None`` to let that call draw its own.
``tag`` names the call within its figure (the graph or data set).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.transition import MHLJParams
from repro_torch.walk_sgd import run_rw_sgd, run_rw_sgd_multi

__all__ = ["milestones", "train"]


def milestones(mse: np.ndarray, ts=(1000, 5000, 10000, 20000, -1)) -> dict:
    out = {}
    for t in ts:
        idx = len(mse) - 1 if t == -1 else min(t, len(mse) - 1)
        lo, hi = max(0, idx - 250), min(len(mse), idx + 250)
        out[f"mse@{'end' if t == -1 else t}"] = float(np.median(mse[lo:hi]))
    return out


def train(
    blocks: Optional[Callable],
    tag: str,
    method: str,
    graph,
    data,
    gamma: float,
    num_steps: int,
    *,
    seed: int,
    device,
    mhlj_params: Optional[MHLJParams] = None,
    p_j_schedule: Optional[np.ndarray] = None,
    num_walks: Optional[int] = None,
    **kwargs,
):
    """``run_rw_sgd`` (``num_walks=None``) or ``run_rw_sgd_multi``, with
    ``uniforms=`` from ``blocks``; other keywords pass through."""
    if method == "mhlj":
        params = mhlj_params or MHLJParams()
        r = params.r
        p_j = (np.full(num_steps, params.p_j) if p_j_schedule is None
               else p_j_schedule)
    else:  # the engine runs every other law at p_J = 0, r = 1
        r, p_j = 1, np.zeros(num_steps)
    uniforms = None if blocks is None else blocks(
        tag=tag, method=method, seed=seed, num_steps=num_steps,
        num_walks=num_walks or 1, r=r, p_j=np.asarray(p_j, np.float32),
    )
    common = dict(mhlj_params=mhlj_params, p_j_schedule=p_j_schedule,
                  seed=seed, uniforms=uniforms, device=device, **kwargs)
    if num_walks is None:
        return run_rw_sgd(method, graph, data, gamma, num_steps, **common)
    return run_rw_sgd_multi(
        method, graph, data, gamma, num_steps, num_walks, **common
    )
