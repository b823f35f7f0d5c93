"""Adafactor (factored second moments), the memory-lean optimizer.

It factors whole leaves of the reference's pytree: a per-layer leaf is the
stacked ``(L, ...)`` tensor (a stack in a stack, the hybrid's, the
``(P, n, ...)`` one), so a stacked norm scale ``(L, D)`` is factored (its
column statistic is a mean over the layer axis) and the update's RMS clip
is taken over all layers of a leaf.  The state holds
the reference's leaves and shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.base import leaf_shape, stack_leaf, unstack_like
from repro_torch.optim.base import GradientTransformation, leaves, zeros_count
from repro_torch.optim.sgd import ScalarOrSchedule, _lr_at

__all__ = ["adafactor", "AdafactorState"]


class AdafactorState(NamedTuple):
    count: torch.Tensor
    row: dict  # factored second moment (rows), a 0-d zero for < 2-D leaves
    col: dict
    full: dict  # unfactored second moment of < 2-D leaves


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(
    learning_rate: ScalarOrSchedule,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
) -> GradientTransformation:
    def init(params):
        device = leaves(params)[0].device

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        row, col, full = {}, {}, {}
        for path, leaf in params.items():
            shape = leaf_shape(leaf)
            fac = _factored(shape)
            row[path] = zeros(shape[:-1] if fac else ())
            col[path] = zeros(shape[:-2] + shape[-1:] if fac else ())
            full[path] = zeros(() if fac else shape)
        return AdafactorState(count=zeros_count(params), row=row, col=col,
                              full=full)

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        lr = _lr_at(learning_rate, state.count)
        state.count.add_(1)
        beta = 1.0 - torch.pow(state.count.to(torch.float32), -decay)
        updates = {}
        for path, leaf in grads.items():
            g = stack_leaf(leaf).float()
            g2 = torch.square(g) + eps
            r, c, f = state.row[path], state.col[path], state.full[path]
            if _factored(g.shape):
                r.copy_(beta * r + (1 - beta) * g2.mean(dim=-1))
                c.copy_(beta * c + (1 - beta) * g2.mean(dim=-2))
                r_factor = r / torch.clamp(r.mean(dim=-1, keepdim=True), min=eps)
                v = r_factor[..., None] * c[..., None, :]
            else:
                f.copy_(beta * f + (1 - beta) * g2)
                v = f
            u = g / torch.sqrt(torch.clamp(v, min=eps))
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            upd = -lr * u
            updates[path] = unstack_like(upd, leaf)
        return updates, state

    return GradientTransformation(init, update)
