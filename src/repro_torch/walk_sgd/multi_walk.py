"""W parallel MHLJ walks with periodic parameter averaging — thin aliases
of the fleet (``repro_torch.walk_sgd.fleet``).

The paper's algorithm is a SINGLE walk; the journal extension
(arXiv:2604.12260) runs W independent walks whose models are averaged
every ``avg_every`` updates (a token-algorithm analogue of
local-SGD/FedAvg): averaging divides the Markov-sampling variance term of
Theorem 1 by ~W while each walk keeps the paper's Remark-1 communication
budget.

``make_multi_walk_step`` is ``fleet.make_fleet_step`` (the walkers'
updates, ONE batched walk transition, the conditional average),
``init_multi_walk_state`` is ``fleet.init_fleet_walk_state``,
``stack_params`` is ``fleet.stack_params`` and ``average_params`` the
unconditional ``fleet.fleet_average``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.optim.base import GradientTransformation
from repro_torch.walk_sgd.fleet import (
    fleet_average,
    init_fleet_walk_state,
    make_fleet_step,
    stack_params,
)
from repro_torch.walk_sgd.llm_trainer import WalkContext

__all__ = [
    "init_multi_walk_state",
    "stack_params",
    "make_multi_walk_step",
    "average_params",
]


def init_multi_walk_state(
    n_nodes: int,
    num_walks: int,
    lipschitz: Optional[np.ndarray] = None,
    v0s: Optional[Sequence[int]] = None,
    seed: int = 0,
    *,
    device="cuda",
    mesh=None,
):
    """Stacked walk states with distinct start nodes and generators
    (``fleet.init_fleet_walk_state``; under ``mesh`` the rank's walkers)."""
    return init_fleet_walk_state(
        n_nodes, num_walks, lipschitz=lipschitz, v0s=v0s, seed=seed,
        device=device, mesh=mesh,
    )


def average_params(params_w):
    """All-walk parameter average, re-broadcast to every walk
    (``fleet.fleet_average``)."""
    return fleet_average(params_w)


def make_multi_walk_step(
    model,
    optimizer: GradientTransformation,
    walk: WalkContext,
    avg_every: int = 0,
    *,
    mesh=None,
) -> Callable:
    """``(params_w, opt_w, walk_w, batches_w, step_idx) -> updated``: the
    fleet step (``fleet.make_fleet_step``, under ``mesh`` sharded over its
    walker axis)."""
    return make_fleet_step(model, optimizer, walk, avg_every, mesh=mesh)
