"""Convergence against the chain law, with entrapment telemetry: the port of
the reference's ``benchmarks/law_sweep.py``.

Every transition law of the repo — simple RW, MH-uniform, P_IS (Eq. 7),
MHLJ (Algorithm 1), the heterogeneity-aware law (arXiv:2204.06477) and
the private weighted walk (arXiv:2009.01790) at two privacy levels — on
the trap-prone families: hub-heavy Barabasi-Albert, the dumbbell and the
lollipop.  Per (family, law) the MSE milestones and the entrapment
telemetry of the update-node sequence (Herfindahl index, top-3 visit
share).  The graphs are dense ``Graph``s, so every training step is one
``walk_transition_sparse`` launch on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.entrapment import occupancy_concentration
from repro_torch.core.graphs import barabasi_albert, dumbbell, lollipop
from repro_torch.core.transition import MHLJParams
from repro_torch.data import make_heterogeneous_regression
from repro_torch.paper.common import milestones, train

NAME = "law_sweep"
PAPER_CLAIM = (
    "C7: the chain law is an open design axis — simple RW, MH-uniform, "
    "P_IS, MHLJ, heterogeneity-aware and private weighted walks run the "
    "same trap-prone protocol, and the entrapment telemetry (Herfindahl, "
    "top-k share) separates the laws the convergence curves alone blur."
)

# (label, trainer method, law_kwargs)
LAWS = (
    ("simple", "simple", None),
    ("uniform", "uniform", None),
    ("importance", "importance", None),
    ("mhlj", "mhlj", None),
    ("heterogeneity", "heterogeneity", None),
    ("private_g0.1", "private", {"gamma": 0.1}),
    ("private_g1.0", "private", {"gamma": 1.0}),
)

STEPS = {"smoke": 600, "quick": 15_000, "full": 40_000}


def _graphs(scale: str) -> dict:
    if scale == "smoke":
        return {
            "ba": barabasi_albert(48, 3, seed=0),
            "dumbbell": dumbbell(12, 6),
            "lollipop": lollipop(16, 9),
        }
    if scale == "quick":
        return {
            "ba": barabasi_albert(256, 3, seed=0),
            "dumbbell": dumbbell(48, 32),
            "lollipop": lollipop(96, 64),
        }
    return {
        "ba": barabasi_albert(1000, 3, seed=0),
        "dumbbell": dumbbell(128, 64),
        "lollipop": lollipop(256, 128),
    }


def step_size(method: str, law_kwargs, data) -> float:
    """The reference's per-law rate: the mean-L rate for the laws whose
    weights cancel the smoothness (P_IS, MHLJ; the private walk divided by
    its (1 + gamma) weight inflation), the max-L rate for the others."""
    if method in ("importance", "mhlj"):
        return 0.5 / data.lipschitz.mean()
    if method == "private":
        return 0.5 / data.lipschitz.mean() / (1.0 + law_kwargs["gamma"])
    return 0.5 / data.lipschitz.max()


def run_graph(tag: str, graph, T: int, *, device="cuda",
              blocks=None) -> tuple:
    """Every law of :data:`LAWS` on one graph from the top-L node; returns
    the per-law results and their ``{tag}_{law}_herfindahl`` derived
    keys."""
    data = make_heterogeneous_regression(
        graph.n, dim=10, sigma_high_sq=100.0, p_high=0.002, seed=3,
        force_min_high=2, x_star_scale=10.0,
    )
    v0 = int(np.argmax(data.lipschitz))  # start inside the trap
    sub, derived = {}, {}
    for label, method, law_kwargs in LAWS:
        res = train(
            blocks, tag, method, graph, data,
            step_size(method, law_kwargs, data), T,
            mhlj_params=MHLJParams(0.1, 0.5, 3) if method == "mhlj" else None,
            law_kwargs=law_kwargs, seed=4, v0=v0, device=device,
        )
        conc = occupancy_concentration(res.update_nodes, graph.n, topk=3)
        sub[label] = {
            **milestones(res.mse),
            "herfindahl": conc["herfindahl"],
            "topk_share": conc["topk_share"],
        }
        derived[f"{tag}_{label}_herfindahl"] = conc["herfindahl"]
    return sub, derived


def run(
    quick: bool = False,
    *,
    scale: Optional[str] = None,
    device="cuda",
    blocks=None,
) -> dict:
    """The sweep at ``scale`` (``"smoke"``, ``"quick"`` or ``"full"``)."""
    scale = scale or ("quick" if quick else "full")
    T = STEPS[scale]
    out = {"T": T, "claim": PAPER_CLAIM, "laws": [law[0] for law in LAWS]}
    derived: dict = {}
    for tag, graph in _graphs(scale).items():
        out[tag], d = run_graph(tag, graph, T, device=device, blocks=blocks)
        derived.update(d)
    out["derived"] = derived
    return out


def run_smoke(*, device="cuda", blocks=None) -> dict:
    """The reference's tiny tier: every law on every family, T = 600."""
    return run(scale="smoke", device=device, blocks=blocks)
