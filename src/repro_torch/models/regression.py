"""The paper's models: linear least squares (Eq. 17-18) and logistic regression.

  linear:   f_v(x) = (y_v - x^T A_v)^2        L_v = 2 ||A_v||^2
  logistic: f_v(x) = -[y_v x^T A_v - log(1 + exp(x^T A_v))]   L_v = ||A_v||^2/4

Losses and closed-form gradients act on a batch of W models at once:
``x`` (W, dim), ``feature`` (W, dim), ``target`` (W,).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "linear_loss",
    "linear_grad",
    "logistic_loss",
    "logistic_grad",
    "mse_objective",
]

# rows of the (n, W) residual that mse_objective holds at once
MSE_CHUNK_ROWS = 8192


def linear_loss(x: torch.Tensor, feature: torch.Tensor, target: torch.Tensor):
    resid = target - (feature * x).sum(dim=-1)
    return resid**2


def linear_grad(x: torch.Tensor, feature: torch.Tensor, target: torch.Tensor):
    """d/dx (y - x·a)^2 = -2 (y - x·a) a."""
    resid = target - (feature * x).sum(dim=-1)
    return feature * (-(2.0 * resid))[:, None]


def logistic_loss(x: torch.Tensor, feature: torch.Tensor, target: torch.Tensor):
    z = (feature * x).sum(dim=-1)
    return F.softplus(z) - target * z


def logistic_grad(x: torch.Tensor, feature: torch.Tensor, target: torch.Tensor):
    """d/dx [softplus(x·a) - y x·a] = (sigmoid(x·a) - y) a."""
    z = (feature * x).sum(dim=-1)
    return feature * (torch.sigmoid(z) - target)[:, None]


def mse_objective(
    xs: torch.Tensor,
    features: torch.Tensor,
    targets: torch.Tensor,
) -> torch.Tensor:
    """Paper's reported metric per model: sum_v (y_v - A_v x)^2 / |V|.

    ``xs`` is (W, dim) and the result (W,); a single (dim,) model gives a
    scalar.  The (n, W) residual is taken in chunks of ``MSE_CHUNK_ROWS`` rows
    so large graphs never hold it whole.
    """
    single = xs.ndim == 1
    xs = xs[None] if single else xs
    n = features.shape[0]
    total = torch.zeros(xs.shape[0], dtype=xs.dtype, device=xs.device)
    for a in range(0, n, MSE_CHUNK_ROWS):
        b = a + MSE_CHUNK_ROWS
        resid = targets[a:b, None] - features[a:b] @ xs.T
        total += (resid**2).sum(dim=0)
    out = total / n
    return out[0] if single else out
