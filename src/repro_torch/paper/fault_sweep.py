"""Convergence under node failures, with the Lévy-jump rescue on and off:
the training leg of the reference's ``benchmarks/fault_sweep.py``.

The fleet loop under a Markov node-fault process
(``repro_torch.core.faults.FaultModel``: a per-tick crash probability and
a slow recovery) on the two fault-sensitive families: the dumbbell (one
bridge; a single death disconnects the cliques) and Barabasi-Albert (hub
deaths take out the shortcuts).  Per failure rate the same seeded run
goes three ways — fault-free, faults with the rescue, faults without —
and reports the *convergence excess*: the tail-window fleet-averaged MSE
less the exact least-squares optimum.  The data is homogeneous on
purpose (docs/faults.md, "rescue bias").

The serving leg of the reference's sweep needs the walk-routed
``ServeSimulator``, which the port does not have yet; :func:`run` says so
in its result.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.faults import FaultModel
from repro_torch.core.graphs import barabasi_albert, dumbbell
from repro_torch.core.transition import MHLJParams
from repro_torch.data.synthetic import make_homogeneous_regression
from repro_torch.models import regression as reg
from repro_torch.walk_sgd import trainer as trainer_mod
from repro_torch.walk_sgd.fleet import WalkFleet

NAME = "fault_sweep"
PAPER_CLAIM = (
    "Node failures re-create the entrapment problem at runtime: a walker "
    "blocked by dead nodes stops mixing exactly like a trapped one.  The "
    "Lévy-jump rescue (forced jump to the live set after `patience` "
    "blocked steps) restores convergence to within ~2x of the fault-free "
    "run at a 5% per-tick failure rate, while the rescue-off fleet "
    "stalls; on the serving side the same faults show up as p99/shed-rate "
    "degradation that trace-replayed legs make directly comparable."
)

RATES = {"smoke": (0.05,), "quick": (0.05,), "full": (0.01, 0.05, 0.10)}

# the training leg's settings of the reference's SCALES (its serve= part is
# the serving leg's)
SCALES = {
    "smoke": dict(dumbbell=(10, 1), ba=(96, 2), dim=4, steps=240, walks=6,
                  avg_every=20, recovery=0.05, patience=2),
    "quick": dict(dumbbell=(30, 2), ba=(500, 3), dim=8, steps=800, walks=8,
                  avg_every=25, recovery=0.05, patience=2),
    "full": dict(dumbbell=(60, 2), ba=(2000, 3), dim=10, steps=600, walks=16,
                 avg_every=25, recovery=0.02, patience=2),
}

MHLJ = MHLJParams()  # the law every leg trains under (the trainer's default)

SERVING_LEG = ("not ported: the serving leg needs the walk-routed "
               "ServeSimulator (ROADMAP Queue 1 item 11)")


def _graphs(p):
    """``(family, graph, data)`` for the two families, homogeneous data."""
    c, plen = p["dumbbell"]
    g_dumb = dumbbell(c, path_len=plen)
    d_dumb = make_homogeneous_regression(g_dumb.n, dim=p["dim"], seed=0)
    n, m = p["ba"]
    g_ba = barabasi_albert(n, m, seed=0, layout="ragged")
    d_ba = make_homogeneous_regression(n, dim=p["dim"], seed=1)
    return (("dumbbell", g_dumb, d_dumb), ("ba", g_ba, d_ba))


def _mse_opt(data) -> float:
    """Exact least-squares optimum of the reported MSE metric."""
    F = np.asarray(data.features, np.float64)
    y = np.asarray(data.targets, np.float64)
    x_opt, *_ = np.linalg.lstsq(F, y, rcond=None)
    return float(np.mean((y - F @ x_opt) ** 2))


def _train_leg(graph, data, p, *, seed=0, fault_model=None, device="cuda",
               streams: Optional[dict] = None) -> dict:
    """One fleet run (mhlj law): the tail-window averaged MSE and, under
    faults, the rescue and blocked totals.  ``streams`` injects the run's
    blocks (``uniforms=``, ``fault_uniforms=``, ``rescue_uniforms=`` of
    ``run_fleet``); without it the run draws from a generator seeded
    ``seed``."""
    steps, walks = p["steps"], p["walks"]
    row_probs, weights, p_j_sched, p_d, r, use_weights = (
        trainer_mod._setup_method("mhlj", graph, data, None, None, steps)
    )
    engine = trainer_mod._build_engine(graph, p_d, r, row_probs, None, device)
    dev = engine.device
    fleet = WalkFleet.create(engine, walks, seed=seed,
                             avg_every=p["avg_every"])
    gamma = 0.3 / float(np.asarray(data.lipschitz, np.float64).mean())
    draw: dict = dict(streams or {})
    if not draw:
        draw["generator"] = torch.Generator(device=dev).manual_seed(seed)
    _xs, _mses, avg_mses, _nodes, _hops, final = trainer_mod.run_fleet(
        torch.zeros((walks, data.dim), device=dev),
        torch.as_tensor(np.asarray(data.features, np.float32), device=dev),
        torch.as_tensor(np.asarray(data.targets, np.float32), device=dev),
        torch.as_tensor(weights, device=dev),
        fleet, steps, gamma, torch.as_tensor(p_j_sched, device=dev),
        use_weights, reg.linear_grad, faults=fault_model, **draw,
    )
    tail = max(1, steps // 10)  # the plateau, not one noisy last sample
    out = {"final_avg_mse": float(avg_mses[-tail:].cpu().numpy().mean())}
    if fault_model is not None:
        out["rescues"] = int(final["rescued"].sum())
        out["blocked_steps"] = int(final["blocked"].sum())
    return out


def legs(rates):
    """``(tag, rate, rescue)`` of every leg: fault-free, then each rate
    with and without the rescue."""
    yield "fault_free", None, None
    for rate in rates:
        pct = int(round(rate * 100))
        for tag, rescue in (("with_rescue", True), ("no_rescue", False)):
            yield f"f{pct}_{tag}", rate, rescue


def run(
    quick: bool = False,
    scale: Optional[str] = None,
    *,
    device="cuda",
    blocks: Optional[Callable] = None,
) -> dict:
    """The training leg at ``scale``.  ``blocks(*, family, leg, seed,
    steps, walks, n, r, p_j, markov, rescue)`` may return a leg's
    ``run_fleet`` streams (a dict, see :func:`_train_leg`) or None to let
    the leg draw from its generator."""
    scale = scale or ("quick" if quick else "full")
    p = SCALES[scale]
    rates = RATES[scale]
    out = {
        "scale": scale, "claim": PAPER_CLAIM, "rates": list(rates),
        "recovery_rate": p["recovery"], "patience": p["patience"],
        "train": {}, "serve": SERVING_LEG,
    }
    derived: dict = {}
    for fam, graph, data in _graphs(p):
        opt = _mse_opt(data)
        fam_out = {"mse_opt": opt}
        free_excess = None
        for leg, rate, rescue in legs(rates):
            fm = None if rate is None else FaultModel(
                crash_rate=rate, recovery_rate=p["recovery"],
                patience=p["patience"], rescue=rescue,
            )
            streams = None if blocks is None else blocks(
                family=fam, leg=leg, seed=0, steps=p["steps"],
                walks=p["walks"], n=graph.n, r=MHLJ.r,
                p_j=np.full(p["steps"], MHLJ.p_j, np.float32),
                markov=fm is not None, rescue=bool(rescue),
            )
            res = _train_leg(graph, data, p, fault_model=fm, device=device,
                             streams=streams)
            excess = max(res["final_avg_mse"] - opt, 1e-12)
            res["excess"] = excess
            if free_excess is None:
                free_excess = excess
            else:
                res["excess_vs_fault_free"] = excess / free_excess
            fam_out[leg] = res
            derived[f"{fam}_excess_{leg}"] = excess
        out["train"][fam] = fam_out
    if 0.05 in rates:
        d = out["train"]["dumbbell"]
        out["criterion"] = {
            "dumbbell_f5_with_rescue_vs_fault_free":
                d["f5_with_rescue"]["excess_vs_fault_free"],
            "dumbbell_f5_no_rescue_vs_fault_free":
                d["f5_no_rescue"]["excess_vs_fault_free"],
        }
    out["derived"] = derived
    return out


def run_smoke(*, device="cuda", blocks=None) -> dict:
    """The reference's tiny tier, training leg only."""
    return run(scale="smoke", device=device, blocks=blocks)
