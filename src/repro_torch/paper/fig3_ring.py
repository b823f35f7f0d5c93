"""Paper Fig. 3: ring(1000), heterogeneous data, uniform vs IS vs MHLJ.

Exact paper setting: A_v ~ N(0, sigma^2 I_10) with sigma^2 = 100 w.p. 0.002
(else 1), y = A^T x* + eps, (p_J, p_d, r) = (0.1, 0.5, 3), MSE metric
sum_v (y_v - A_v x)^2 / |V|.  Entrapment makes MH-IS slower than uniform on
the ring; MHLJ restores fast convergence with a small error gap.  The port
of the reference's ``benchmarks/fig3_ring.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.entrapment import occupancy_concentration
from repro_torch.core.graphs import ring
from repro_torch.core.transition import MHLJParams
from repro_torch.data import make_heterogeneous_regression
from repro_torch.paper.common import milestones, train

NAME = "fig3_ring"
PAPER_CLAIM = (
    "C3: on a sparse ring with heterogeneous data, MH-IS suffers entrapment "
    "(high top-node occupancy, slowed mid-phase convergence); MHLJ escapes "
    "and converges fastest, with a bounded error gap (Remark 1 overhead <=1.1)."
)


def run(quick: bool = False, *, device="cuda", blocks=None) -> dict:
    n = 256 if quick else 1000
    T = 20_000 if quick else 40_000
    graph = ring(n)
    data = make_heterogeneous_regression(
        n, dim=10, sigma_high_sq=100.0, p_high=0.002, seed=0,
        force_min_high=2, x_star_scale=10.0,
    )
    gamma_u = 0.5 / data.lipschitz.max()
    gamma = 0.5 / data.lipschitz.mean()
    params = MHLJParams(0.1, 0.5, 3)

    out = {"n": n, "T": T, "num_high": int(data.high_variance_mask.sum()),
           "claim": PAPER_CLAIM, "methods": {}}
    for method, g in (("uniform", gamma_u), ("importance", gamma), ("mhlj", gamma)):
        res = train(
            blocks, "ring", method, graph, data, g, T,
            mhlj_params=params if method == "mhlj" else None,
            seed=1, v0=int(np.argmax(data.lipschitz)), device=device,
        )
        occ = occupancy_concentration(res.update_nodes, n)
        out["methods"][method] = {
            **milestones(res.mse),
            "top_node_occupancy": occ["topk_share"],
            "transitions_per_update": res.transitions_per_update,
        }
    m = out["methods"]
    out["derived"] = {
        # occupancy: IS concentrates on ONE node of n (x n = ratio-to-uniform)
        "is_entrapped_occupancy": m["importance"]["top_node_occupancy"],
        "mhlj_occupancy": m["mhlj"]["top_node_occupancy"],
        # early-phase speed (paper Fig 3's x-axis story): MSE after 1k updates
        "mhlj_vs_is_early_ratio": m["mhlj"]["mse@1000"] / m["importance"]["mse@1000"],
        "mhlj_vs_uniform_early_ratio": m["mhlj"]["mse@1000"] / m["uniform"]["mse@1000"],
        # late phase: IS oscillates at the trap while uniform passes it
        "is_vs_uniform_late_ratio": m["importance"]["mse@20000"] / m["uniform"]["mse@20000"],
        "mhlj_comm_overhead": m["mhlj"]["transitions_per_update"],
    }
    return out
