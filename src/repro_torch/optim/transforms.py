"""Composable gradient transforms: clipping, weight decay, scaling."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.optim.base import (GradientTransformation, global_norm,
                                    leaves, unflatten, zeros_count)

__all__ = ["clip_by_global_norm", "add_weight_decay", "scale",
           "scale_by_schedule", "ScheduleState"]


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        del params
        return ()

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        norm = global_norm(grads)
        factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return unflatten(grads, torch._foreach_mul(leaves(grads), factor)), state

    return GradientTransformation(init, update)


def add_weight_decay(weight_decay: float) -> GradientTransformation:
    """Adds wd * params to the *gradients* (L2, pre-preconditioner)."""

    def init(params):
        del params
        return ()

    @torch.no_grad()
    def update(grads, state, params):
        gs = leaves(grads)
        upd = torch._foreach_add(gs, torch._foreach_mul(
            [p.to(g.dtype) for g, p in zip(gs, leaves(params))], weight_decay))
        return unflatten(grads, upd), state

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:
    def init(params):
        del params
        return ()

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        return unflatten(grads, torch._foreach_mul(leaves(grads), factor)), state

    return GradientTransformation(init, update)


class ScheduleState(NamedTuple):
    count: torch.Tensor


def scale_by_schedule(schedule: Callable) -> GradientTransformation:
    def init(params):
        return ScheduleState(count=zeros_count(params))

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        s = schedule(state.count)
        state.count.add_(1)
        return unflatten(grads, torch._foreach_mul(leaves(grads), s)), state

    return GradientTransformation(init, update)
