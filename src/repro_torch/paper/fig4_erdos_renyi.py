"""Paper Fig. 4: Erdos-Renyi(1000, 0.1) — well-connected control.

(a) homogeneous data: uniform-MH and IS-MH converge at similar rates.
(b) heterogeneous data: IS-MH beats uniform-MH (the Needell centralized
    speedup survives decentralization when the graph is well-connected —
    no entrapment).

The port of the reference's ``benchmarks/fig4_erdos_renyi.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graphs import erdos_renyi
from repro_torch.data import make_heterogeneous_regression, make_homogeneous_regression
from repro_torch.paper.common import milestones, train

NAME = "fig4_erdos_renyi"
PAPER_CLAIM = (
    "C1/C2: on ER(1000,0.1), homogeneous data -> uniform ~= IS; "
    "heterogeneous data -> IS faster than uniform."
)


def _auc_log(mse, lo, hi):
    return float(np.log(np.maximum(mse[lo:hi], 1e-12)).mean())


def run(quick: bool = False, *, device="cuda", blocks=None) -> dict:
    n = 256 if quick else 1000
    T = 10_000 if quick else 20_000
    graph = erdos_renyi(n, 0.1, seed=0)
    out = {"n": n, "T": T, "claim": PAPER_CLAIM}

    homo = make_homogeneous_regression(n, dim=10, seed=0, x_star_scale=10.0)
    het = make_heterogeneous_regression(
        n, dim=10, sigma_high_sq=100.0, p_high=0.005, seed=1,
        force_min_high=3, x_star_scale=10.0,
    )
    for tag, data in (("homogeneous", homo), ("heterogeneous", het)):
        gamma_u = 0.5 / data.lipschitz.max()
        gamma = 0.5 / data.lipschitz.mean()
        res_u = train(blocks, tag, "uniform", graph, data, gamma_u, T,
                      seed=2, device=device)
        res_i = train(blocks, tag, "importance", graph, data, gamma, T,
                      seed=2, device=device)
        out[tag] = {
            "uniform": milestones(res_u.mse),
            "importance": milestones(res_i.mse),
            "auc_log_uniform": _auc_log(res_u.mse, 200, T // 2),
            "auc_log_importance": _auc_log(res_i.mse, 200, T // 2),
        }
    out["derived"] = {
        "homo_auc_gap": out["homogeneous"]["auc_log_importance"]
        - out["homogeneous"]["auc_log_uniform"],
        "hetero_is_advantage": out["heterogeneous"]["auc_log_uniform"]
        - out["heterogeneous"]["auc_log_importance"],
    }
    return out
