"""Paper Fig. 5 + trap-prone extensions: entrapment and the MHLJ fix on
sparse topologies.

Same protocol as Fig 3 on the paper's other sparse topologies —
(a) 2-d grid (25x40 = 1000 nodes), (b) Watts-Strogatz(1000, 4, 0.1) — plus
the graph families the entrapment literature studies: hub-heavy
Barabasi-Albert, bottlenecked stochastic block models, and the dumbbell
worst case.  The port of the reference's ``benchmarks/fig5_sparse_graphs.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.entrapment import occupancy_concentration
from repro_torch.core.graphs import barabasi_albert, dumbbell, grid2d, sbm, watts_strogatz
from repro_torch.core.transition import MHLJParams
from repro_torch.data import make_heterogeneous_regression
from repro_torch.paper.common import milestones, train

NAME = "fig5_sparse_graphs"
PAPER_CLAIM = (
    "C4: the entrapment problem and the MHLJ fix replicate on 2-d grid and "
    "Watts-Strogatz sparse networks (not ring-specific), and extend to the "
    "trap-prone families (Barabasi-Albert hubs, SBM bottlenecks, dumbbell)."
)


def _graphs(scale: str) -> dict:
    if scale == "smoke":
        return {
            "grid2d": grid2d(8, 8),
            "sbm": sbm([32, 32], 0.3, 0.02, seed=0),
        }
    if scale == "quick":
        return {
            "grid2d": grid2d(16, 16),
            "watts_strogatz": watts_strogatz(256, 4, 0.1, 0),
            "barabasi_albert": barabasi_albert(256, 3, seed=0),
            "sbm": sbm([64] * 4, 0.2, 0.01, seed=0),
            "dumbbell": dumbbell(32, 16),
        }
    return {
        "grid2d": grid2d(25, 40),
        "watts_strogatz": watts_strogatz(1000, 4, 0.1, 0),
        "barabasi_albert": barabasi_albert(1000, 3, seed=0),
        "sbm": sbm([250] * 4, 0.1, 0.004, seed=0),
        "dumbbell": dumbbell(64, 128),
    }


def run_graph(tag: str, graph, T: int, *, device="cuda", blocks=None) -> dict:
    """One graph's protocol: uniform, importance and mhlj runs from the
    top-L node, each with its MSE milestones and top-node occupancy."""
    params = MHLJParams(0.1, 0.5, 3)
    n = graph.n
    data = make_heterogeneous_regression(
        n, dim=10, sigma_high_sq=100.0, p_high=0.002, seed=3,
        force_min_high=2, x_star_scale=10.0,
    )
    gamma_u = 0.5 / data.lipschitz.max()
    gamma = 0.5 / data.lipschitz.mean()
    v0 = int(np.argmax(data.lipschitz))
    sub = {}
    for method, g in (("uniform", gamma_u), ("importance", gamma), ("mhlj", gamma)):
        res = train(
            blocks, tag, method, graph, data, g, T,
            mhlj_params=params if method == "mhlj" else None, seed=4,
            v0=v0, device=device,
        )
        sub[method] = {
            **milestones(res.mse),
            "top_node_occupancy":
                occupancy_concentration(res.update_nodes, n)["topk_share"],
        }
    return sub


def derived(out: dict, tags) -> dict:
    """The figure's ``derived`` keys from the per-graph results in ``out``."""
    return {
        f"{tag}_is_occ": out[tag]["importance"]["top_node_occupancy"]
        for tag in tags
    } | {
        f"{tag}_mhlj_occ": out[tag]["mhlj"]["top_node_occupancy"] for tag in tags
    }


def run(
    quick: bool = False,
    scale: Optional[str] = None,
    *,
    num_steps: Optional[int] = None,
    device="cuda",
    blocks=None,
) -> dict:
    """``num_steps`` cuts the tier's T (to fit a time limit); the graphs
    keep their size."""
    scale = scale or ("quick" if quick else "full")
    T = num_steps or {"smoke": 800, "quick": 20_000, "full": 40_000}[scale]
    graphs = _graphs(scale)
    out = {"T": T, "claim": PAPER_CLAIM}
    for tag, graph in graphs.items():
        out[tag] = run_graph(tag, graph, T, device=device, blocks=blocks)
    out["derived"] = derived(out, graphs)
    return out


def run_smoke(*, device="cuda", blocks=None) -> dict:
    """The reference's tiny tier (2 graphs, T = 800)."""
    return run(scale="smoke", device=device, blocks=blocks)
