"""The W-walker fleet and its training loop (regression path).

W parallel walks ride one batched :class:`~repro_torch.core.engine.WalkEngine`
transition per step, each walk carrying its own model; every
``avg_every`` steps the models are averaged across walkers (local-SGD
style, :func:`fleet_average`).  :func:`run_fleet` is the one training
loop — the W=1 case is single-walk RW-SGD — written as a plain Python
loop over steps on the engine's device.

Faults, checkpoints and the multi-device mesh are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import WalkEngine, num_uniforms
from repro_torch.models import regression as reg

__all__ = [
    "WalkFleet",
    "sample_initial_nodes",
    "fleet_average",
    "run_fleet",
]


def sample_initial_nodes(
    n: int,
    num_walks: int,
    *,
    seed: int = 0,
    v0s: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Initial nodes of a fleet: ``v0s`` validated, or ``num_walks`` draws
    from ``np.random.default_rng(seed)`` (without replacement while the
    fleet fits the graph, with replacement beyond)."""
    if n <= 0:
        raise ValueError(
            f"cannot seed {num_walks} walks: the active-node set is empty "
            f"(n={n})"
        )
    if v0s is None:
        rng = np.random.default_rng(seed)
        v0s = rng.choice(n, size=num_walks, replace=num_walks > n)
    v0s = np.asarray(v0s, np.int32)
    if v0s.shape != (num_walks,):
        raise ValueError(f"v0s must have shape ({num_walks},), got {v0s.shape}")
    if v0s.size and (int(v0s.min()) < 0 or int(v0s.max()) >= n):
        raise ValueError(
            f"v0s must be node ids in [0, {n}), got range "
            f"[{int(v0s.min())}, {int(v0s.max())}]"
        )
    return v0s


def fleet_average(xs: torch.Tensor) -> torch.Tensor:
    """Cross-walker model average, re-broadcast to all W walkers."""
    return xs.mean(dim=0, keepdim=True).expand_as(xs).clone()


@dataclasses.dataclass(frozen=True, eq=False)
class WalkFleet:
    """W parallel walkers riding one batched engine."""

    engine: WalkEngine
    nodes: torch.Tensor  # (W,) int32 walk positions on the engine's device
    num_walks: int = 1
    avg_every: int = 0  # 0 = never average

    @classmethod
    def create(
        cls,
        engine: WalkEngine,
        num_walks: int,
        *,
        v0s: Optional[Sequence[int]] = None,
        seed: int = 0,
        avg_every: int = 0,
    ) -> "WalkFleet":
        """Fleet with :func:`sample_initial_nodes` seeding/validation."""
        v0 = sample_initial_nodes(engine.n, num_walks, seed=seed, v0s=v0s)
        return cls(
            engine=engine,
            nodes=torch.as_tensor(v0, device=engine.device),
            num_walks=num_walks,
            avg_every=avg_every,
        )


def run_fleet(
    x0s: torch.Tensor,  # (W, dim)
    features: torch.Tensor,  # (n, dim) float32
    targets: torch.Tensor,  # (n,) float32
    weights: torch.Tensor,  # (n,) L_bar / L_v
    fleet: WalkFleet,
    num_steps: int,
    gamma: float,
    p_j_sched: torch.Tensor,  # (num_steps,) float32
    use_weights: bool,
    loss_grad: Callable,
    *,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Train the fleet for ``num_steps`` steps.

    Per step: each walker takes the (importance-weighted, when
    ``use_weights``) gradient step of its node's loss, the models are
    averaged on steps ``t`` with ``(t + 1) % avg_every == 0``, and all
    walkers advance through one engine step — with the injected block
    ``uniforms[t]`` of a ``(T, W, 3 + r)`` tensor (slot 0 = jump flag), or
    drawn from ``generator`` at ``p_j_sched[t]``.

    Returns ``(x_final (W, dim), mse (W, T+1), avg_mse (T+1,),
    update_nodes (W, T), hops (W, T), final_nodes (W,))``.
    """
    engine = fleet.engine
    w = fleet.num_walks
    if uniforms is not None:
        expect = (num_steps, w, num_uniforms(engine.r))
        if tuple(uniforms.shape) != expect:
            raise ValueError(
                f"uniforms must be {expect}, got {tuple(uniforms.shape)}"
            )
        uniforms = uniforms.to(engine.device, torch.float32)
    elif generator is None:
        raise ValueError("pass uniforms= (injected blocks) or generator=")
    device = engine.device
    mses = torch.empty((num_steps + 1, w), device=device)
    avg_mses = torch.empty(num_steps + 1, device=device)
    nodes_out = torch.empty((num_steps, w), dtype=torch.int32, device=device)
    hops_out = torch.empty_like(nodes_out)
    mses[0] = reg.mse_objective(x0s, features, targets)
    avg_mses[0] = reg.mse_objective(x0s.mean(dim=0), features, targets)
    ones = torch.ones(w, device=device)
    xs, vs = x0s, fleet.nodes
    for t in range(num_steps):
        gs = loss_grad(xs, features[vs], targets[vs])  # (W, dim)
        ws = (weights[vs] if use_weights else ones)[:, None]
        xs = xs - gamma * ws * gs
        if fleet.avg_every > 0 and (t + 1) % fleet.avg_every == 0:
            xs = fleet_average(xs)
        nodes_out[t] = vs
        if uniforms is not None:
            vs, hops = engine.step(vs, uniforms=uniforms[t])
        else:
            vs, hops = engine.step(vs, generator=generator, p_j=p_j_sched[t])
        hops_out[t] = hops
        mses[t + 1] = reg.mse_objective(xs, features, targets)
        avg_mses[t + 1] = reg.mse_objective(xs.mean(dim=0), features, targets)
    return (
        xs,
        mses.T.contiguous(),
        avg_mses,
        nodes_out.T.contiguous(),
        hops_out.T.contiguous(),
        vs,
    )
