"""SGD and heavy-ball momentum."""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.optim.base import (GradientTransformation, leaves, tree_map,
                                    unflatten, zeros_count)

__all__ = ["sgd", "momentum", "SGDState", "MomentumState", "ScalarOrSchedule"]

ScalarOrSchedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: ScalarOrSchedule, count):
    return lr(count) if callable(lr) else lr


class SGDState(NamedTuple):
    count: torch.Tensor


def sgd(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    def init(params):
        return SGDState(count=zeros_count(params))

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        lr = _lr_at(learning_rate, state.count)
        updates = unflatten(grads, torch._foreach_mul(leaves(grads), -lr))
        state.count.add_(1)
        return updates, state

    return GradientTransformation(init, update)


class MomentumState(NamedTuple):
    count: torch.Tensor
    trace: dict


def momentum(
    learning_rate: ScalarOrSchedule,
    beta: float = 0.9,
    nesterov: bool = False,
    dtype: torch.dtype = torch.float32,
) -> GradientTransformation:
    """Heavy-ball momentum; ``dtype`` is the trace's precision."""

    def init(params):
        trace = tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)
        return MomentumState(count=zeros_count(params), trace=trace)

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        lr = _lr_at(learning_rate, state.count)
        gs, ts = leaves(grads), leaves(state.trace)
        # beta * t + g in float32, stored in the trace's dtype
        new = torch._foreach_add(
            torch._foreach_mul([t.float() for t in ts], beta),
            [g.float() for g in gs])
        torch._foreach_copy_(ts, new)
        if nesterov:
            upd = torch._foreach_mul(
                torch._foreach_add(
                    torch._foreach_mul([t.float() for t in ts], beta),
                    [g.float() for g in gs]),
                -lr)
        else:
            upd = torch._foreach_mul([t.float() for t in ts], -lr)
        state.count.add_(1)
        return unflatten(grads, upd), state

    return GradientTransformation(init, update)
