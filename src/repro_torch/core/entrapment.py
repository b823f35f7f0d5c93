"""Entrapment diagnostics (paper §IV), a numpy copy of
``repro.core.entrapment``.

The entrapment problem: under P_IS on a sparse graph with heterogeneous L_v,
detailed balance (Eq. 8) makes the exit probability from high-L nodes tiny, so
the walk dwells there and the model overfits local data.  These diagnostics
quantify it:

* ``escape_probability`` — 1 - P(v, v): per-node one-step exit mass.
* ``expected_dwell_time`` — geometric dwell 1 / (1 - P(v,v)).
* ``occupancy_concentration`` — from a trajectory: max/topk node visit share
  vs its stationary share.
* ``trap_score`` — analytic: pi(v) * dwell(v) ranking; the paper's Fig 2
  5-node ring example has node 1 dominating.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.mixing import stationary_distribution

__all__ = [
    "escape_probability",
    "expected_dwell_time",
    "trap_score",
    "occupancy_concentration",
    "visit_fractions",
]


def escape_probability(p: np.ndarray) -> np.ndarray:
    """One-step probability of leaving each node: 1 - diag(P)."""
    return 1.0 - np.diag(p)


def expected_dwell_time(p: np.ndarray) -> np.ndarray:
    """Expected consecutive steps spent at v once entered: 1 / (1 - P(v,v))."""
    esc = escape_probability(p)
    return 1.0 / np.maximum(esc, 1e-300)


def trap_score(p: np.ndarray) -> np.ndarray:
    """pi(v) * dwell(v): long-run update mass concentrated per visit-run."""
    pi = stationary_distribution(p)
    return pi * expected_dwell_time(p)


def visit_fractions(trajectory: np.ndarray, n: int) -> np.ndarray:
    """Empirical node-visit distribution of a trajectory of node ids.

    Ids must lie in ``[0, n)``: an out-of-range id means the trajectory and
    the graph disagree (wrong n, stale trajectory, transposed axes) and every
    downstream concentration statistic would be silently wrong — ``bincount``
    would happily grow past ``n`` and the returned vector would have the
    wrong length.
    """
    traj = np.asarray(trajectory).ravel()
    if traj.size == 0:
        raise ValueError("empty trajectory has no visit distribution")
    lo, hi = int(traj.min()), int(traj.max())
    if lo < 0 or hi >= n:
        raise ValueError(
            f"trajectory node ids must lie in [0, {n}): found range "
            f"[{lo}, {hi}] — trajectory and graph size disagree"
        )
    counts = np.bincount(traj, minlength=n).astype(np.float64)
    return counts / counts.sum()


def occupancy_concentration(trajectory: np.ndarray, n: int, topk: int = 1) -> dict:
    """Concentration stats of a walk trajectory.

    Returns top-k visit share, the empirical/uniform ratio for the most
    visited node, and the Herfindahl index (sum of squared shares) — a scalar
    entrapment severity measure (1/n = perfectly even, 1 = fully trapped).
    """
    frac = visit_fractions(trajectory, n)
    order = np.argsort(frac)[::-1]
    top = frac[order[:topk]].sum()
    return {
        "topk_share": float(top),
        "max_over_uniform": float(frac.max() * n),
        "herfindahl": float((frac**2).sum()),
        "argmax": int(order[0]),
    }
