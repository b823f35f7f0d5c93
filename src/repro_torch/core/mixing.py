"""Markov-chain mixing analysis (paper §VI uses tau_mix in Theorem 1).

A numpy copy of ``repro.core.mixing``: the same input gives the same bits.

Quantities:

* stationary distribution (left eigenvector / power iteration),
* absolute spectral gap and the standard mixing-time bounds
    t_mix(eps) <= log(1/(eps pi_min)) / gap        (reversible upper bound)
    t_mix(eps) >= (1/gap - 1) log(1/(2 eps))       (lower bound)
* empirical mixing time: smallest t with max_v ||P^t(v,.) - pi||_TV <= eps,
* conductance (bottleneck ratio) via sweep cuts — explains WHY entrapment
  slows mixing on sparse graphs.

MHLJ's chain is non-reversible (jumps break detailed balance), so eigenvalue
bounds use the absolute second-largest modulus; the empirical TV mixing time
is exact regardless and is what the paper's Theorem-1 check reports.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "stationary_distribution",
    "spectral_gap",
    "mixing_time_tv",
    "mixing_time_bounds",
    "tv_distance",
    "conductance",
    "is_reversible",
    "NotMixedError",
]


class NotMixedError(RuntimeError):
    """Raised when a chain has not reached the TV threshold by ``max_t``.

    Carries the horizon and the worst-case TV distance still standing there,
    so callers can distinguish "does not mix" (disconnected, periodic,
    absorbing) from "mixes slowly — raise max_t" without parsing strings.
    """

    def __init__(self, max_t: int, worst_tv: float, eps: float):
        self.max_t = int(max_t)
        self.worst_tv = float(worst_tv)
        self.eps = float(eps)
        super().__init__(
            f"chain has not mixed by t={max_t}: worst-case TV distance "
            f"{worst_tv:.4g} > eps={eps} — the chain may be reducible or "
            "periodic; if it merely mixes slowly, raise max_t"
        )


def stationary_distribution(p: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """Left Perron vector of a row-stochastic matrix via eig + power polish."""
    vals, vecs = np.linalg.eig(p.T)
    idx = int(np.argmin(np.abs(vals - 1.0)))
    pi = np.real(vecs[:, idx])
    pi = np.abs(pi)
    pi = pi / pi.sum()
    # power-iteration polish for numerical hygiene
    for _ in range(1000):
        nxt = pi @ p
        if np.abs(nxt - pi).max() < tol:
            pi = nxt
            break
        pi = nxt
    return pi / pi.sum()


def is_reversible(p: np.ndarray, pi: np.ndarray | None = None, atol: float = 1e-8) -> bool:
    """Detailed balance check: pi_i P_ij == pi_j P_ji."""
    pi = stationary_distribution(p) if pi is None else pi
    flow = pi[:, None] * p
    return bool(np.allclose(flow, flow.T, atol=atol))


def spectral_gap(p: np.ndarray) -> float:
    """Absolute spectral gap 1 - max_{i>=2} |lambda_i|."""
    vals = np.linalg.eigvals(p)
    mags = np.sort(np.abs(vals))[::-1]
    # the top eigenvalue is 1 (row stochastic); guard numerical noise
    slem = mags[1] if len(mags) > 1 else 0.0
    return float(max(0.0, 1.0 - slem))


def tv_distance(mu: np.ndarray, nu: np.ndarray) -> float:
    return float(0.5 * np.abs(mu - nu).sum())


def mixing_time_tv(
    p: np.ndarray,
    eps: float = 0.25,
    max_t: int = 1_000_000,
) -> int:
    """Exact empirical mixing time: min t s.t. max_v ||P^t(v,.) - pi||_TV <= eps.

    Uses repeated squaring of P to reach large t in O(log t) matmuls, then
    refines by bisection over the doubling bracket.  Worst-case distance is
    monotone non-increasing in t, which makes bisection valid.

    Raises :class:`NotMixedError` when the chain is still above ``eps`` at
    ``max_t`` — a reducible/periodic chain never mixes, and returning
    ``max_t`` for it (as this function once did) is indistinguishable from
    "mixed at exactly max_t", silently corrupting every tau_mix consumer
    (Theorem-1 terms, entrapment comparisons).
    """
    pi = stationary_distribution(p)

    def worst_tv(pt: np.ndarray) -> float:
        return float(0.5 * np.abs(pt - pi[None, :]).sum(axis=1).max())

    # bracket by doubling
    powers = [p]  # powers[k] = P^(2^k)
    t = 1
    pt = p
    while worst_tv(pt) > eps:
        if t >= max_t:
            raise NotMixedError(max_t, worst_tv(pt), eps)
        pt = pt @ pt
        powers.append(pt)
        t *= 2
    if t == 1:
        return 1
    # bisect in (t/2, t]: build P^m from binary expansion using cached squares
    lo, hi = t // 2, t

    def p_pow(m: int) -> np.ndarray:
        out = None
        k = 0
        while m:
            if m & 1:
                out = powers[k] if out is None else out @ powers[k]
            m >>= 1
            k += 1
        return out

    while hi - lo > 1:
        mid = (lo + hi) // 2
        if worst_tv(p_pow(mid)) <= eps:
            hi = mid
        else:
            lo = mid
    return hi


def mixing_time_bounds(p: np.ndarray, eps: float = 0.25) -> dict:
    """Spectral upper/lower bounds on t_mix(eps) (Levin-Peres Thm 12.4/12.5)."""
    gap = spectral_gap(p)
    pi = stationary_distribution(p)
    pi_min = float(pi.min())
    if gap <= 0:
        return {"gap": gap, "upper": float("inf"), "lower": float("inf"), "pi_min": pi_min}
    t_rel = 1.0 / gap
    upper = t_rel * np.log(1.0 / (eps * pi_min))
    lower = (t_rel - 1.0) * np.log(1.0 / (2.0 * eps))
    return {"gap": gap, "upper": float(upper), "lower": float(max(lower, 0.0)), "pi_min": pi_min}


def conductance(p: np.ndarray, pi: np.ndarray | None = None) -> float:
    """Bottleneck ratio Phi = min_S Q(S, S^c) / pi(S) over sweep cuts.

    Exact conductance is NP-hard; we use the standard spectral sweep-cut
    heuristic (order nodes by the second eigenvector, evaluate all prefix
    cuts), which upper-bounds the true conductance and is tight enough to
    explain ring/grid entrapment.
    """
    pi = stationary_distribution(p) if pi is None else pi
    # second eigenvector of the additive reversibilization for ordering
    q = pi[:, None] * p
    sym = 0.5 * (q + q.T)
    lap = sym / np.sqrt(np.outer(pi, pi))
    vals, vecs = np.linalg.eigh(lap)
    order = np.argsort(vecs[:, -2])
    best = np.inf
    s_mask = np.zeros(len(pi), dtype=bool)
    for v in order[:-1]:
        s_mask[v] = True
        pi_s = pi[s_mask].sum()
        denom = min(pi_s, 1.0 - pi_s)
        if denom <= 0:
            continue
        flow = q[s_mask][:, ~s_mask].sum()
        best = min(best, flow / denom)
    return float(best)
