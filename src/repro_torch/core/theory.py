"""Theorem-1 machinery: convergence-bound and error-gap evaluation (paper §VI).

E||x^T - x*||^2 <= O~( L_bar^2 tau_mix sigma*^2 / (L_min T) )
                 + O( p_J^2 ||P_IS - P_Levy||_1^2 )

A numpy copy of ``repro.core.theory`` over the port's laws.  Both terms
are evaluated with explicit constants-free scaling, to check the
*predicted scalings* (1/T rate; p_J^2 gap slope; tau_mix reduction from
jumps) against measured curves, which is what the paper itself validates
(Figs 3, 6).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import levy as levy_mod
from repro_torch.core import mixing
from repro_torch.core import transition as trans_mod
from repro_torch.core.graphs import Graph

__all__ = [
    "matrix_l1_norm",
    "perturbation_l1",
    "theorem1_terms",
    "needell_rates",
    "regression_fixed_point",
    "error_gap_exact",
]


def matrix_l1_norm(m: np.ndarray) -> float:
    """Induced L1 norm (max absolute column sum) — the paper's ||.||_1."""
    return float(np.abs(m).sum(axis=0).max())


def perturbation_l1(graph: Graph, lipschitz: np.ndarray, params: trans_mod.MHLJParams) -> float:
    """||P_IS - P_Levy||_1 — what sets the error gap in Theorem 1 (bounded by n^2)."""
    p_is = trans_mod.mh_importance(graph, lipschitz)
    p_levy = levy_mod.levy_matrix_chained(graph, params.p_d, params.r)
    return matrix_l1_norm(p_is - p_levy)


@dataclasses.dataclass(frozen=True)
class Theorem1Terms:
    """Evaluated scaling terms of Eq. (9) plus the chain statistics behind them."""

    rate_term: float  # L_bar^2 tau_mix sigma*^2 / (L_min T)
    gap_term: float  # p_J^2 ||P_IS - P_Levy||_1^2
    tau_mix: int
    tau_mix_mh: int  # mixing time of the unperturbed P_IS chain, for comparison
    spectral_gap: float
    spectral_gap_mh: float
    perturbation_l1: float
    l_bar: float
    l_min: float
    l_max: float


def theorem1_terms(
    graph: Graph,
    lipschitz: np.ndarray,
    params: trans_mod.MHLJParams,
    *,
    sigma_star_sq: float = 1.0,
    num_iters: int = 1,
    eps: float = 0.25,
    max_t: int = 1 << 22,
) -> Theorem1Terms:
    """Evaluate both Theorem-1 terms for a concrete (graph, L, params) instance."""
    lipschitz = np.asarray(lipschitz, dtype=np.float64)
    p_is = trans_mod.mh_importance(graph, lipschitz)
    p = trans_mod.mhlj(graph, lipschitz, params)
    tau = mixing.mixing_time_tv(p, eps=eps, max_t=max_t)
    tau_mh = mixing.mixing_time_tv(p_is, eps=eps, max_t=max_t)
    pert = perturbation_l1(graph, lipschitz, params)
    l_bar = float(lipschitz.mean())
    l_min = float(lipschitz.min())
    rate = (l_bar**2) * tau * sigma_star_sq / (l_min * num_iters)
    gap = (params.p_j**2) * (pert**2)
    return Theorem1Terms(
        rate_term=float(rate),
        gap_term=float(gap),
        tau_mix=int(tau),
        tau_mix_mh=int(tau_mh),
        spectral_gap=mixing.spectral_gap(p),
        spectral_gap_mh=mixing.spectral_gap(p_is),
        perturbation_l1=pert,
        l_bar=l_bar,
        l_min=l_min,
        l_max=float(lipschitz.max()),
    )


def regression_fixed_point(
    features: np.ndarray,  # (n, d) A_v
    targets: np.ndarray,  # (n,) y_v
    nu: np.ndarray,  # (n,) sampling distribution of the walk
    weights: np.ndarray,  # (n,) importance weights w(v) = L_bar / L_v
) -> np.ndarray:
    """Exact expected fixed point of weighted RW-SGD for least squares.

    SGD with sampling distribution nu and gradient weights w converges (in
    expectation, for small gamma) to the solution of
        sum_v nu_v w_v A_v (A_v^T x - y_v) = 0,
    i.e. weighted normal equations.  When nu = pi_IS and w = L_bar/L_v the
    weights cancel the bias exactly (nu_v w_v = const) and x~ equals the true
    least-squares optimum; MHLJ's perturbed nu leaves an O(p_J) residual in
    nu_v w_v and hence an O(p_J^2) squared error gap — Theorem 1's second
    term, computable in closed form here."""
    c = nu * weights  # (n,)
    gram = (features * c[:, None]).T @ features
    rhs = (features * c[:, None]).T @ targets
    return np.linalg.solve(gram, rhs)


def error_gap_exact(
    graph: Graph,
    features: np.ndarray,
    targets: np.ndarray,
    lipschitz: np.ndarray,
    params: trans_mod.MHLJParams,
) -> float:
    """||x~(p_J) - x_LS||^2: the exact asymptotic error gap of MHLJ on a
    least-squares instance (zero when p_J = 0)."""
    p = trans_mod.mhlj(graph, lipschitz, params)
    nu = mixing.stationary_distribution(p)
    w = lipschitz.mean() / lipschitz
    x_tilde = regression_fixed_point(features, targets, nu, w)
    x_ls = np.linalg.pinv(features) @ targets
    return float(((x_tilde - x_ls) ** 2).sum())


def needell_rates(lipschitz: np.ndarray, num_iters: int) -> dict:
    """Centralized reference rates (paper §III.A, Needell et al. Thm 2.1).

    uniform:    O~(L_max / T)
    importance: O~(L_bar^2 / (L_min T))
    """
    lipschitz = np.asarray(lipschitz, dtype=np.float64)
    l_bar = lipschitz.mean()
    return {
        "uniform": float(lipschitz.max() / num_iters),
        "importance": float(l_bar**2 / (lipschitz.min() * num_iters)),
        "speedup_predicted": float(
            lipschitz.max() * lipschitz.min() / (l_bar**2)
        ),
    }
