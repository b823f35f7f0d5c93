"""Walk-orchestrated training of the language models (the paper's loop at
LLM scale).

The random-walk state (current silo, generator, per-silo Lipschitz
estimates) rides beside the model: each train step is forward, backward,
the importance weight ``w(v) = L_bar / L_v`` (Eq. 12) on the gradient,
the optimizer update, then — with the online estimator — the gradient
norm, the parameter fingerprint and the secant update of ``L_v``, and
last the MHLJ transition (Algorithm 1) to the next silo, in the
reference's order.  The host feeds the batch of the node the walk
announces.

The MH-IS rows are computed on the fly from the current Lipschitz vector
(Eq. 7 needs only deg(v), deg(u), L_v, L_u), which supports both a static
L_v and the online estimator.  ``WalkContext`` is a thin adapter over
:class:`~repro_torch.core.engine.WalkEngine` on the ``sparse`` layout (live
rows, one ``walk_transition_sparse`` launch a transition on the card) and
the fleet: :meth:`WalkContext.advance` is the one-walker fleet,
:meth:`WalkContext.advance_batched` the W-walker fleet (the W-walker
*training* step is ``repro_torch.walk_sgd.fleet.make_fleet_step``).

The walk state carries a ``torch.Generator`` (``"rng"``) where the
reference carries a PRNG key; ``advance`` also takes an injected uniform
block, which is how the parity tests feed the reference's draws.  The
parameters are the reference's pytree (``repro_torch.models.base``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import WalkEngine, draw_uniforms, num_uniforms
from repro_torch.core.importance import param_fingerprint
from repro_torch.core.transition import MHLJParams
from repro_torch.optim.base import (GradientTransformation, apply_updates,
                                    global_norm, leaves, unflatten)
from repro_torch.sharding.constraints import constrain
from repro_torch.walk_sgd.fleet import WalkFleet

__all__ = ["WalkContext", "make_train_step", "make_serve_step",
           "init_walk_state"]


@dataclasses.dataclass(frozen=True, eq=False)
class WalkContext:
    """Device-resident graph + MHLJ hyper-parameters (all small tensors)."""

    neighbors: torch.Tensor  # (n, max_deg) int32, padded with self id
    degrees: torch.Tensor  # (n,) int32
    p_j: float
    p_d: float
    r: int
    online_lipschitz: bool = False
    lipschitz_ema: float = 0.9
    # importance-weight clip range: online L_v estimates are noisy early on
    # and w = L_bar/L_v multiplies the gradient; unclipped extremes
    # destabilize adaptive optimizers.  The exact closed-form-L_v setting
    # corresponds to clip = (0, inf).
    weight_clip: tuple = (0.1, 10.0)

    @classmethod
    def from_graph(
        cls, graph, params: MHLJParams, online_lipschitz: bool = False, *,
        device="cuda",
    ) -> "WalkContext":
        device = torch.device(device)
        return cls(
            neighbors=torch.as_tensor(np.asarray(graph.neighbors, np.int32),
                                      device=device),
            degrees=torch.as_tensor(np.asarray(graph.degrees, np.int32),
                                    device=device),
            p_j=params.p_j,
            p_d=params.p_d,
            r=params.r,
            online_lipschitz=online_lipschitz,
        )

    @property
    def device(self) -> torch.device:
        return self.degrees.device

    @functools.cached_property
    def _engine(self) -> WalkEngine:
        return WalkEngine(degrees=self.degrees, layout="sparse",
                          neighbors=self.neighbors, p_j=self.p_j,
                          p_d=self.p_d, r=self.r)

    def engine(self) -> WalkEngine:
        """The Algorithm-1 sampler on the sparse layout; rows come live
        from the current Lipschitz vector (Eq. 7)."""
        return self._engine

    def _block(self, gen, p_j) -> torch.Tensor:
        if not isinstance(gen, torch.Generator):
            raise ValueError(
                "the walk state's rng is not a torch.Generator (a reference "
                "checkpoint's key is data): pass uniforms= to advance")
        return draw_uniforms(1, self.r, p_j, gen, self.device)

    def advance(self, state: dict, uniforms: Optional[torch.Tensor] = None) -> dict:
        """Advance one walk: the one-walker fleet's transition on a
        ``(1, 3 + r)`` block, drawn from ``state["rng"]`` at
        ``state.get("p_j", self.p_j)`` or injected (slot 0 the jump flag)."""
        if uniforms is None:
            uniforms = self._block(state["rng"], state.get("p_j", self.p_j))
        fleet = WalkFleet(engine=self.engine(), nodes=state["node"],
                          num_walks=1)
        fleet, hops = fleet.advance(uniforms=uniforms,
                                    lipschitz=state["lipschitz"])
        return {
            **state,
            "node": fleet.nodes.to(torch.int32),
            "hops": state["hops"] + hops,
            "updates": state["updates"] + 1,
        }

    def advance_batched(self, states: dict,
                        uniforms: Optional[torch.Tensor] = None) -> dict:
        """Advance W stacked walk states (a leading walk axis on every
        tensor, ``states["rng"]`` a tuple of W generators) in ONE batched
        transition, each walk on the Eq.-7 rows of its own Lipschitz
        vector.  The ``(W, 3 + r)`` block is injected or drawn row by row
        from the walkers' generators."""
        w = int(states["node"].shape[0])
        if uniforms is None:
            p_j = states.get("p_j")
            uniforms = torch.cat([
                self._block(gen, self.p_j if p_j is None else p_j[i])
                for i, gen in enumerate(states["rng"])])
        if tuple(uniforms.shape) != (w, num_uniforms(self.r)):
            raise ValueError(f"uniforms must be ({w}, {num_uniforms(self.r)}), "
                             f"got {tuple(uniforms.shape)}")
        fleet = WalkFleet(engine=self.engine(), nodes=states["node"],
                          num_walks=w)
        fleet, hops = fleet.advance(uniforms=uniforms,
                                    lipschitz=states["lipschitz"])
        return {
            **states,
            "node": fleet.nodes.to(torch.int32),
            "hops": states["hops"] + hops,
            "updates": states["updates"] + 1,
        }

    def weight(self, state: dict) -> torch.Tensor:
        """Importance weight w(v) = L_bar / L_v (Eq. 12), clipped when the
        online estimator is active (exact L_v needs no clip)."""
        lips = state["lipschitz"]
        w = lips.mean() / lips[state["node"].long()]
        if self.online_lipschitz and self.weight_clip is not None:
            w = torch.clamp(w, *self.weight_clip)
        return w

    def update_lipschitz(self, state: dict, grad_norm, param_fp) -> dict:
        """Online EMA secant estimate of L_v at the current node."""
        if not self.online_lipschitz:
            return state
        v = state["node"].long()
        prev_g = state["last_grad_norm"][v]
        prev_f = state["last_param_fp"][v]
        seen = state["visited"][v]
        secant = torch.abs(grad_norm - prev_g) / torch.clamp(
            torch.abs(param_fp - prev_f), min=1e-8)
        secant = torch.clamp(secant, 1e-3, 1e3)
        old = state["lipschitz"][v]
        new = torch.where(
            seen,
            self.lipschitz_ema * old + (1 - self.lipschitz_ema) * secant, old)

        def put(x, value):
            return x.index_put((v,), torch.as_tensor(value, dtype=x.dtype,
                                                     device=x.device))

        return {
            **state,
            "lipschitz": put(state["lipschitz"], new),
            "last_grad_norm": put(state["last_grad_norm"], grad_norm),
            "last_param_fp": put(state["last_param_fp"], param_fp),
            "visited": put(state["visited"], True),
        }


def init_walk_state(
    n_nodes: int,
    lipschitz: Optional[np.ndarray] = None,
    v0: int = 0,
    seed: int = 0,
    online: bool = False,
    *,
    device="cuda",
) -> dict:
    """A walk at ``v0`` with its generator seeded ``seed`` on ``device``."""
    device = torch.device(device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {
        "node": torch.tensor(v0, dtype=torch.int32, device=device),
        "rng": torch.Generator(device=device).manual_seed(seed),
        "lipschitz": (
            torch.as_tensor(np.asarray(lipschitz, np.float32), device=device)
            if lipschitz is not None
            else torch.ones((n_nodes,), dtype=torch.float32, device=device)
        ),
        "hops": zeros((), torch.int32),
        "updates": zeros((), torch.int32),
    }
    if online:
        state.update(
            last_grad_norm=zeros((n_nodes,), torch.float32),
            last_param_fp=zeros((n_nodes,), torch.float32),
            visited=zeros((n_nodes,), torch.bool),
        )
    return state


def make_train_step(
    model,
    optimizer: GradientTransformation,
    walk: WalkContext,
    advance_walk: bool = True,
    *,
    projections: Optional[Sequence[torch.Tensor]] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> Callable:
    """``(params, opt_state, walk_state, batch, uniforms=None) -> (params,
    opt_state, walk_state, metrics)``.

    ``params`` is a pytree of the model's structure
    (``repro_torch.models.base.param_tree``): the model's own parameters,
    or a walker's tensors, which must require grad.  They and
    ``opt_state`` are updated in place.  ``uniforms`` is the walk's
    injected ``(1, 3 + r)`` block; ``projections`` replace the
    fingerprint's own draw (``param_fingerprint``, one per tensor of
    ``leaves(params)``).  ``advance_walk=False`` leaves the walk where it
    is, for a caller that advances W walks in one batched transition.
    ``on_phase(name)``, when given, is called as each phase ends:
    ``"forward_backward"``, ``"optimizer"``, ``"fingerprint"`` (online
    only) and ``"advance"``.
    """

    def mark(name):
        if on_phase is not None:
            on_phase(name)

    def train_step(params, opt_state, walk_state, batch, uniforms=None):
        flat = leaves(params)
        with torch.enable_grad():
            loss, aux = model.loss_with(params, batch)
            grads = torch.autograd.grad(loss, flat)
        mark("forward_backward")
        with torch.no_grad():
            w = walk.weight(walk_state)
            grads = unflatten(params, _scaled(grads, w))
            updates, opt_state = optimizer.update(grads, opt_state, params)
            apply_updates(params, updates)
            mark("optimizer")
            if walk.online_lipschitz:
                gn = global_norm(grads)
                # a random projection, not ||params||: equal-norm parameter
                # states must not collapse the secant's denominator
                fp = param_fingerprint(flat, projections=projections)
                walk_state = walk.update_lipschitz(walk_state, gn, fp)
                mark("fingerprint")
            if advance_walk:
                walk_state = walk.advance(walk_state, uniforms=uniforms)
                mark("advance")
        metrics = {"loss": loss.detach(), "weight": w,
                   **{k: v.detach() for k, v in aux.items()}}
        return params, opt_state, walk_state, metrics

    return train_step


def _scaled(grads, w: torch.Tensor) -> list:
    """``g * w`` with ``w`` cast to each gradient's dtype, one multi-tensor
    launch per dtype."""
    out = list(grads)
    for dtype in {g.dtype for g in grads}:
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        for i, g in zip(idx, torch._foreach_mul([grads[i] for i in idx],
                                                w.to(dtype))):
            out[i] = g
    return out


def make_serve_step(model) -> Callable:
    """Batched greedy decode step ``(cache, tokens, pos) -> (next_tokens
    (B, 1) int32, cache)`` on the model's own weights."""

    def serve_step(cache, tokens, pos):
        logits, cache = model.decode_step(tokens, cache, pos)
        # on a mesh each device takes the argmax over the whole vocabulary
        logits = constrain(logits, ("data", None))
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tokens, cache

    return serve_step
