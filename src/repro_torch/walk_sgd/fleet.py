"""The W-walker fleet and its training loop (regression path).

W parallel walks ride one batched :class:`~repro_torch.core.engine.WalkEngine`
transition per step, each walk carrying its own model; every
``avg_every`` steps the models are averaged across walkers (local-SGD
style, :func:`fleet_average`).  :func:`run_fleet` is the one training
loop — the W=1 case is single-walk RW-SGD — and the reference's
``_fleet_scan``: a step over ``(t, xs, vs)`` on the device, driven by
``repro_torch.core.scan.scan`` (captured in CUDA graphs on the card, a
plain loop on the CPU).

Faults, checkpoints and the multi-device mesh are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import scan as scan_mod
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


def fleet_average(
    xs: torch.Tensor, do_avg: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Cross-walker model average, re-broadcast to all W walkers.

    ``do_avg=None`` averages unconditionally; a 0-d device bool makes the
    average conditional (the ``(t + 1) % avg_every == 0`` gate of the
    fleet loop), selected on the device: the mean where ``do_avg``, else
    ``xs``.
    """
    mean = xs.mean(dim=0, keepdim=True).expand_as(xs)
    return mean.clone() if do_avg is None else torch.where(do_avg, mean, xs)


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

    def advance(
        self,
        *,
        uniforms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        p_j=None,
        lipschitz: Optional[torch.Tensor] = None,
        faults=None,
    ):
        """ONE batched MHLJ transition for all W walkers.

        The block is an injected ``(W, 3 + r)`` ``uniforms`` (slot 0 = jump
        flag) or drawn from ``generator`` at ``p_j``, in place of the
        reference's key.  Returns ``(advanced_fleet, hops)``; ``hops`` is
        the Remark-1 physical transition count per walker.
        """
        if faults is not None:
            raise NotImplementedError(
                "advance(faults=...) is not ported yet: fault models come "
                "with a later slice of the port (ROADMAP Queue 1 item 7)"
            )
        nxt, hops = self.engine.step(
            self.nodes, uniforms=uniforms, generator=generator, p_j=p_j,
            lipschitz=lipschitz,
        )
        return dataclasses.replace(self, nodes=nxt), hops


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
    capture: Optional[bool] = None,
):
    """Train the fleet for ``num_steps`` steps.

    Per step: each walker takes the (importance-weighted, when
    ``use_weights``) gradient step of its node's loss, the models are
    averaged on steps ``t`` with ``(t + 1) % avg_every == 0``, and all
    walkers advance through one engine step — with the injected block
    ``uniforms[t]`` of a ``(T, W, 3 + r)`` tensor (slot 0 = jump flag), or
    drawn from ``generator`` at ``p_j_sched[t]``.  The step is the
    reference's ``_fleet_scan`` step over ``(t, xs, vs)``, ``t`` on the
    device; ``repro_torch.core.scan.scan`` captures the loop on the card
    (``capture=False`` runs it uncaptured, for comparison only).

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
    avg_every = fleet.avg_every
    ones = torch.ones(w, device=device)

    def step(carry):
        t, xs, vs = carry
        row = t.view(1)
        gs = loss_grad(xs, features[vs], targets[vs])  # (W, dim)
        ws = (weights[vs] if use_weights else ones)[:, None]
        xs_new = xs - gamma * ws * gs
        if avg_every > 0:
            xs_new = fleet_average(xs_new, (t + 1) % avg_every == 0)
        if uniforms is not None:
            draw = dict(uniforms=uniforms.index_select(0, row)[0])
        else:
            draw = dict(generator=generator,
                        p_j=p_j_sched.index_select(0, row))
        vs_next, hops = engine.step(vs, **draw)  # ONE batched call
        mses = reg.mse_objective(xs_new, features, targets)
        avg_mse = reg.mse_objective(xs_new.mean(dim=0), features, targets)
        return (t + 1, xs_new, vs_next), (mses, avg_mse, vs, hops)

    mse0 = reg.mse_objective(x0s, features, targets)
    avg0 = reg.mse_objective(x0s.mean(dim=0), features, targets)
    t0 = torch.zeros((), dtype=torch.int64, device=device)
    (mses, avg_mses, nodes, hops), (_, xs, vs), _ = scan_mod.scan(
        step, (t0, x0s, fleet.nodes), num_steps,
        (mse0, avg0, fleet.nodes, fleet.nodes), capture=capture,
        generators=() if generator is None else (generator,),
    )
    return (
        xs,
        torch.cat([mse0[None], mses]).T.contiguous(),
        torch.cat([avg0[None], avg_mses]),
        nodes.T.contiguous(),
        hops.T.contiguous(),
        vs,
    )
