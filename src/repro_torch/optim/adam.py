"""Adam / AdamW."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding.constraints import is_dtensor
from repro_torch.optim.base import (GradientTransformation, leaves, tree_map,
                                    unflatten, zeros_count)
from repro_torch.optim.sgd import ScalarOrSchedule, _lr_at

__all__ = ["adam", "adamw", "AdamState"]


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict


def adam(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    mu_dtype: torch.dtype = torch.float32,
) -> GradientTransformation:
    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(count=zeros_count(params), mu=mu, nu=nu)

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        lr = _lr_at(learning_rate, state.count)
        state.count.add_(1)
        count = state.count.to(torch.float32)
        gs = [g.float() for g in leaves(grads)]
        mus, nus = leaves(state.mu), leaves(state.nu)
        # mu <- b1 m + (1 - b1) g, nu <- b2 v + (1 - b2) g^2 (float32)
        new_mu = torch._foreach_add(
            torch._foreach_mul([m.float() for m in mus], b1),
            torch._foreach_mul(gs, 1 - b1))
        if mus and is_dtensor(mus[0]):  # DTensor has no _foreach_copy_
            for m, n in zip(mus, new_mu):
                m.copy_(n)
        else:
            torch._foreach_copy_(mus, new_mu)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                                    1 - b2))
        c1 = 1 - torch.pow(b1, count)
        c2 = 1 - torch.pow(b2, count)
        # -lr * (m / c1) / (sqrt(v / c2) + eps)
        upd = torch._foreach_mul(
            torch._foreach_div([m.float() for m in mus], c1), -lr)
        den = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        return unflatten(grads, upd), state

    return GradientTransformation(init, update)


def adamw(
    learning_rate: ScalarOrSchedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    mu_dtype: torch.dtype = torch.float32,
) -> GradientTransformation:
    inner = adam(learning_rate, b1=b1, b2=b2, eps=eps, mu_dtype=mu_dtype)

    def init(params):
        return inner.init(params)

    @torch.no_grad()
    def update(grads, state, params):
        lr = _lr_at(learning_rate, state.count)  # before inner counts the step
        updates, new_state = inner.update(grads, state, params)
        ups = leaves(updates)
        torch._foreach_sub_(ups, torch._foreach_mul(
            [p.float() for p in leaves(params)], lr * weight_decay))
        return unflatten(updates, ups), new_state

    return GradientTransformation(init, update)
