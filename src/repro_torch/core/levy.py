"""Lévy jump machinery (paper §V).

The jump distance is drawn from a truncated geometric distribution

    P(D = d) = p_d (1 - p_d)^{d-1} / (1 - (1 - p_d)^r),   1 <= d <= r,

and the jump performs ``d`` consecutive uniform simple-random-walk hops
with no model updates.  The law's host-side constants are numpy;
:func:`trunc_geom_icdf` is the one float32 formula every sampler of the
port (the engine's plain path and the CUDA kernel) shares.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "trunc_geom_pmf",
    "trunc_geom_mean",
    "trunc_geom_icdf",
    "icdf_constants",
    "expected_transitions_per_update",
    "remark1_bound",
]


def trunc_geom_pmf(p_d: float, r: int) -> np.ndarray:
    """PMF of TruncGeom(p_d, r) over support {1, ..., r}."""
    if not (0.0 < p_d < 1.0):
        raise ValueError(f"p_d must be in (0,1), got {p_d}")
    if r < 1:
        raise ValueError(f"r must be >= 1, got {r}")
    d = np.arange(1, r + 1, dtype=np.float64)
    pmf = p_d * (1.0 - p_d) ** (d - 1.0)
    pmf /= 1.0 - (1.0 - p_d) ** r
    return pmf


def trunc_geom_mean(p_d: float, r: int) -> float:
    """E[D] for D ~ TruncGeom(p_d, r): ``sum_d d * pmf(d)``, floored at 1.

    For r >= 2 the sum is the reference's, bit for bit.  At r=1 the support
    is {1} and E[D] is exactly 1.0: the pmf's single entry may round off
    1.0 either way (the reference then returns 0.9999999999999999 or
    1.0000000000000004).
    """
    pmf = trunc_geom_pmf(p_d, r)
    if r == 1:
        return 1.0
    return max(1.0, float(np.dot(np.arange(1, r + 1), pmf)))


def icdf_constants(p_d: float, r: int) -> tuple[float, float]:
    """``(z, 1 - p_d)`` of the inverse CDF, each rounded to float32.

    ``z = 1 - (1-p_d)^r`` is computed in double and then rounded, and the
    second value is the float32 ``1 - p_d`` whose float32 log is the
    denominator — the rounding the reference's traced formula applies.
    """
    z = 1.0 - (1.0 - p_d) ** r
    return float(np.float32(z)), float(np.float32(1.0 - p_d))


def trunc_geom_icdf(u: torch.Tensor, p_d: float, r: int) -> torch.Tensor:
    """Inverse CDF of TruncGeom(p_d, r): maps U(0,1) draws to d in {1..r}.

    F(d) = (1 - (1-p_d)^d) / (1 - (1-p_d)^r), so
    d = ceil(log1p(-u * Z) / log(1 - p_d)) with Z = 1 - (1-p_d)^r, in
    float32: ``-u*Z`` rounds as its own product and ``log(1 - p_d)`` is
    the float32 log of the float32 ``1 - p_d``, taken on ``u``'s device.
    """
    z32, q32 = icdf_constants(p_d, r)
    den = torch.log(torch.full((), q32, dtype=torch.float32, device=u.device))
    d = torch.ceil(torch.log1p(-u * z32) / den).to(torch.int32)
    return torch.clamp(d, 1, r)


def expected_transitions_per_update(p_j: float, p_d: float, r: int) -> float:
    """Remark 1: exact expected node visits per SGD update.

    (1-p_J)*1 + p_J*E[D], as the reference computes it, floored at 1 so
    the value is never below 1 in floating point.  The paper's bound is
    :func:`remark1_bound`.
    """
    return max(1.0, (1.0 - p_j) * 1.0 + p_j * trunc_geom_mean(p_d, r))


def remark1_bound(p_j: float, p_d: float, r: int) -> float:
    """Paper Remark 1 upper bound: 1 + p_J (1/p_d - 1)."""
    del r
    return 1.0 + p_j * (1.0 / p_d - 1.0)
