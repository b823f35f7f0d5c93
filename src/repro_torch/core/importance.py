"""Importance measures: gradient-Lipschitz constants L_v and pi_IS (paper §III).

Closed forms (paper §II.B, Appendix D):
* linear regression   f_v(x) = (y_v - x^T A_v)^2        ->  L_v = 2 ||A_v||^2
* logistic regression f_v(x) = y_v x^T A_v - log(1+e^{x^T A_v}) -> L_v = ||A_v||^2 / 4

The online Lipschitz estimator of the LLM path is not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "linear_regression_lipschitz",
    "logistic_regression_lipschitz",
    "importance_distribution",
]


def linear_regression_lipschitz(features: np.ndarray) -> np.ndarray:
    """L_v = 2 ||A_v||^2 for f_v(x) = (y_v - x^T A_v)^2 (paper Appendix D)."""
    features = np.asarray(features)
    return 2.0 * (features**2).sum(axis=-1)


def logistic_regression_lipschitz(features: np.ndarray) -> np.ndarray:
    """L_v = ||A_v||^2 / 4 (paper §II.B)."""
    features = np.asarray(features)
    return 0.25 * (features**2).sum(axis=-1)


def importance_distribution(lipschitz: np.ndarray) -> np.ndarray:
    """pi_IS(v) = L_v / sum_u L_u (paper Eq. 5)."""
    lipschitz = np.asarray(lipschitz, dtype=np.float64)
    if np.any(lipschitz <= 0):
        raise ValueError("Lipschitz constants must be strictly positive")
    return lipschitz / lipschitz.sum()
