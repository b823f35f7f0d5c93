"""Paper Fig. 6: annealing p_J -> 0 eliminates the error gap.

Two measurements: (1) the exact asymptotic bias ||x~(p_J) - x_LS||^2 in
closed form (slope -> 2 on log-log: Theorem 1's O(p_J^2) term); (2) a
seed-averaged simulation comparing constant vs annealed p_J tails — all
replicas run as one batched fleet through the walk engine
(``run_rw_sgd_multi`` with a scheduled p_J).  The port of the reference's
``benchmarks/fig6_annealing.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import schedules
from repro_torch.core.graphs import ring
from repro_torch.core.theory import error_gap_exact
from repro_torch.core.transition import MHLJParams
from repro_torch.data import make_heterogeneous_regression
from repro_torch.paper.common import train

NAME = "fig6_annealing"
PAPER_CLAIM = (
    "C5: the MHLJ error gap scales O(p_J^2) and annealing p_J -> 0 removes "
    "it without losing convergence speed."
)


def run(
    quick: bool = False,
    *,
    num_steps: Optional[int] = None,
    device="cuda",
    blocks=None,
) -> dict:
    """``num_steps`` cuts the simulation's T (to fit a time limit)."""
    n = 64
    graph = ring(n)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, 6)) * np.where(rng.random(n) < 0.1, 2.0, 1.0)[:, None]
    targs = feats @ (3 * rng.normal(size=6)) + rng.normal(size=n)
    lips = 2 * (feats**2).sum(1)
    pjs = [0.2, 0.1, 0.05, 0.025, 0.0125]
    gaps = [
        error_gap_exact(graph, feats, targs, lips, MHLJParams(pj, 0.5, 3))
        for pj in pjs
    ]
    slopes = [
        float(np.log(gaps[i] / gaps[i - 1]) / np.log(pjs[i] / pjs[i - 1]))
        for i in range(1, len(gaps))
    ]

    T = num_steps or (20_000 if quick else 40_000)
    n_replicas = 3 if quick else 6
    data = make_heterogeneous_regression(
        n, dim=6, sigma_high_sq=100.0, p_high=0.05, seed=5, x_star_scale=3.0
    )
    gamma = 0.3 / data.lipschitz.mean()

    def tails(tag, schedule):
        # one batched engine run services all replicas (independent models,
        # no averaging); tail = per-replica median, averaged over replicas
        res = train(
            blocks, tag, "mhlj", graph, data, gamma, T,
            num_walks=n_replicas, mhlj_params=MHLJParams(0.3, 0.5, 3),
            p_j_schedule=schedule, v0s=np.zeros(n_replicas, np.int32),
            seed=0, device=device,
        )
        return float(np.mean(np.median(res.mse[:, -4000:], axis=1)))

    const_tail = tails("const", None)
    ann_tail = tails(
        "annealed", schedules.polynomial_decay(0.3, T, power=1.0, t0=2000)
    )
    return {
        "claim": PAPER_CLAIM,
        "p_j_sweep": dict(zip(map(str, pjs), gaps)),
        "loglog_slopes": slopes,
        "const_pj_tail_mse": const_tail,
        "annealed_tail_mse": ann_tail,
        "derived": {
            "final_slope": slopes[-1],
            "gap_shrink": gaps[-1] / gaps[0],
            "annealed_vs_const": ann_tail / const_tail,
        },
    }
