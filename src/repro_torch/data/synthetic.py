"""Paper Appendix-D synthetic regression data.

Homogeneous:   A_v ~ N(0, sigma^2 I_d),        y_v = A_v^T x* + eps, eps ~ N(0,1)
Heterogeneous: A_v | sigma_v^2 ~ N(0, sigma_v^2 I_d), where sigma_v^2 = sigma_H^2
               with probability p_high (paper: Fig 3 uses p=0.002, Appendix
               uses p=0.005) and sigma_L^2 otherwise.

One data point per node (paper: "For each node v, we assign one data point").
L_v = 2 ||A_v||^2 for the squared loss f_v(x) = (y_v - x^T A_v)^2.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.importance import linear_regression_lipschitz

__all__ = [
    "RegressionData",
    "make_homogeneous_regression",
    "make_heterogeneous_regression",
]


@dataclasses.dataclass(frozen=True)
class RegressionData:
    """Per-node least-squares data (paper Eq. 17-18)."""

    features: np.ndarray  # (n, d)  A_v
    targets: np.ndarray  # (n,)     y_v
    x_star: np.ndarray  # (d,)      ground-truth regressor
    lipschitz: np.ndarray  # (n,)   L_v = 2 ||A_v||^2
    high_variance_mask: np.ndarray  # (n,) bool — which nodes got sigma_H^2

    @property
    def n(self) -> int:
        return int(self.features.shape[0])

    @property
    def dim(self) -> int:
        return int(self.features.shape[1])

    def mse(self, x: np.ndarray) -> float:
        """Paper Fig-3 metric: sum_v (y_v - A_v x)^2 / |V|."""
        resid = self.targets - self.features @ np.asarray(x)
        return float((resid**2).mean())

    def optimum(self) -> np.ndarray:
        """Least-squares minimizer of the average loss (ridge-free pinv)."""
        return np.linalg.pinv(self.features) @ self.targets


def _finish(features, rng, x_star, mask) -> RegressionData:
    noise = rng.normal(size=features.shape[0])
    targets = features @ x_star + noise
    return RegressionData(
        features=features,
        targets=targets,
        x_star=x_star,
        lipschitz=linear_regression_lipschitz(features),
        high_variance_mask=mask,
    )


def make_homogeneous_regression(
    n: int, dim: int = 10, sigma_sq: float = 1.0, seed: int = 0,
    x_star_scale: float = 10.0,
) -> RegressionData:
    rng = np.random.default_rng(seed)
    x_star = x_star_scale * rng.normal(size=dim)
    features = rng.normal(scale=np.sqrt(sigma_sq), size=(n, dim))
    return _finish(features, rng, x_star, np.zeros(n, dtype=bool))


def make_heterogeneous_regression(
    n: int,
    dim: int = 10,
    sigma_low_sq: float = 1.0,
    sigma_high_sq: float = 100.0,
    p_high: float = 0.002,
    seed: int = 0,
    force_min_high: int = 1,
    high_nodes: np.ndarray | None = None,
    x_star_scale: float = 10.0,
) -> RegressionData:
    """Paper heterogeneous scheme; Fig 3 uses (sigma_H^2=100, p=0.002) on n=1000.

    ``force_min_high`` guarantees at least that many high-variance nodes so
    small-n test instances still exhibit heterogeneity.  ``high_nodes`` pins
    the high-variance node ids (e.g. Fig-2's node 1 on a 5-ring).
    ``x_star_scale`` sets ||x*|| so the initial MSE matches the paper's
    ~1e4 starting point (x0 = 0).
    """
    rng = np.random.default_rng(seed)
    x_star = x_star_scale * rng.normal(size=dim)
    if high_nodes is not None:
        mask = np.zeros(n, dtype=bool)
        mask[np.asarray(high_nodes)] = True
    else:
        mask = rng.random(n) < p_high
        if mask.sum() < force_min_high:
            extra = rng.choice(n, size=force_min_high - int(mask.sum()), replace=False)
            mask[extra] = True
    scale = np.where(mask, np.sqrt(sigma_high_sq), np.sqrt(sigma_low_sq))
    features = rng.normal(size=(n, dim)) * scale[:, None]
    return _finish(features, rng, x_star, mask)
