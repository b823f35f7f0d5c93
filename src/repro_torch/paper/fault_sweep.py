"""Convergence and serving under node failures, with the Lévy-jump rescue on
and off: the port of the reference's ``benchmarks/fault_sweep.py``.

Training leg — the fleet loop under a Markov node-fault process
(``repro_torch.core.faults.FaultModel``: a per-tick crash probability and
a slow recovery) on the two fault-sensitive families: the dumbbell (one
bridge; a single death disconnects the cliques) and Barabasi-Albert (hub
deaths take out the shortcuts).  Per failure rate the same seeded run
goes three ways — fault-free, faults with the rescue, faults without —
and reports the *convergence excess*: the tail-window fleet-averaged MSE
less the exact least-squares optimum.  The data is homogeneous on
purpose (docs/faults.md, "rescue bias").

Serving leg — one fault-free ``ServeSimulator`` run (mhlj routing on a
ragged BA graph, the reduced mamba2-370m decoding) records its arrival
trace, then every (failure rate × rescue) leg replays that identical
workload under faults, so p99 ticks and the shed rate (queue-full +
deadline + node_down over offered) isolate the policy.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.faults import FaultModel
from repro_torch.core.graphs import barabasi_albert, dumbbell
from repro_torch.core.transition import MHLJParams
from repro_torch.data.synthetic import make_homogeneous_regression
from repro_torch.launch.serve import ServeEngine, ServeSimulator
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

SCALES = {
    "smoke": dict(
        dumbbell=(10, 1), ba=(96, 2), dim=4, steps=240, walks=6,
        avg_every=20, recovery=0.05, patience=2,
        serve=dict(
            n=96, m=2, walkers=8, ticks=60, drain=30, rate=1.0, pickup=2,
            batch=2, cache_len=64, max_queue=16, deadline=50,
            prompt_len=(3, 6), max_new=4, relocate_after=2,
        ),
    ),
    "quick": dict(
        dumbbell=(30, 2), ba=(500, 3), dim=8, steps=800, walks=8,
        avg_every=25, recovery=0.05, patience=2,
        serve=dict(
            n=500, m=3, walkers=24, ticks=200, drain=80, rate=1.2, pickup=4,
            batch=4, cache_len=96, max_queue=32, deadline=150,
            prompt_len=(4, 10), max_new=6, relocate_after=3,
        ),
    ),
    "full": dict(
        dumbbell=(60, 2), ba=(2000, 3), dim=10, steps=600, walks=16,
        avg_every=25, recovery=0.02, patience=2,
        serve=dict(
            n=2000, m=3, walkers=64, ticks=500, drain=200, rate=1.5,
            pickup=4, batch=8, cache_len=128, max_queue=64, deadline=350,
            prompt_len=(4, 16), max_new=8, relocate_after=3,
        ),
    ),
}

MHLJ = MHLJParams()  # the law every leg trains under (the trainer's default)

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


def _serve_leg(graph, sp, engine, *, fault_model=None, trace=None,
               streams: Optional[dict] = None) -> dict:
    """One serving run (mhlj routing): the simulator's metrics, the shed
    rate and the run's arrival log.  ``streams`` injects the walk's
    per-tick streams (:meth:`ServeSimulator.inject`)."""
    sim = ServeSimulator(
        graph,
        engine.reset(),
        method="mhlj",
        num_walkers=sp["walkers"],
        rate=sp["rate"],
        pickup=sp["pickup"],
        deadline_ticks=sp["deadline"],
        prompt_len=sp["prompt_len"],
        max_new_tokens=sp["max_new"],
        seed=0,
        fault_model=fault_model,
        relocate_after=sp["relocate_after"],
        arrival_trace=trace,
    )
    if streams is not None:
        sim.inject(streams)
    m = sim.run(sp["ticks"], drain_ticks=sp["drain"])
    shed = m["shed_queue_full"] + m["shed_deadline"] + m["shed_node_down"]
    m["shed_rate"] = shed / max(1, m["offered"])
    m["arrival_log"] = sim.arrival_log
    return m


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
    """Both legs at ``scale``.  ``blocks(*, family, leg, seed, steps,
    walks, n, r, p_j, markov, rescue)`` may return a leg's streams or None
    to let the leg draw from its generator: for a training family
    (``"dumbbell"``, ``"ba"``) ``run_fleet``'s (see :func:`_train_leg`),
    for ``family="serve"`` (``steps`` the ticks, ``walks`` the walkers)
    :meth:`ServeSimulator.inject`'s."""
    scale = scale or ("quick" if quick else "full")
    p = SCALES[scale]
    rates = RATES[scale]
    out = {
        "scale": scale, "claim": PAPER_CLAIM, "rates": list(rates),
        "recovery_rate": p["recovery"], "patience": p["patience"],
        "train": {}, "serve": {},
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

    # -- serving leg: one recorded trace replayed across the rescue legs ----
    sp = p["serve"]
    graph = barabasi_albert(sp["n"], sp["m"], seed=0, layout="ragged")
    engine = ServeEngine(reduced(get_arch("mamba2-370m")), sp["batch"],
                         sp["cache_len"], seed=0, max_queue=sp["max_queue"],
                         device=device)
    ticks = sp["ticks"] + sp["drain"]
    trace = None
    for leg, rate, rescue in legs(rates):
        fm = None if rate is None else FaultModel(
            crash_rate=rate, recovery_rate=p["recovery"],
            patience=p["patience"], rescue=rescue,
        )
        streams = None if blocks is None else blocks(
            family="serve", leg=leg, seed=0, steps=ticks,
            walks=sp["walkers"], n=graph.n, r=MHLJ.r,
            p_j=np.full(ticks, MHLJ.p_j, np.float32),
            markov=fm is not None, rescue=bool(rescue),
        )
        m = _serve_leg(graph, sp, engine, fault_model=fm, trace=trace,
                       streams=streams)
        log = m.pop("arrival_log")
        if trace is None:  # the fault-free leg records the workload
            trace = np.asarray(log, np.int64)
        out["serve"][leg] = m
        derived[f"serve_p99_{leg}"] = m["p99_ticks"]
        derived[f"serve_shed_rate_{leg}"] = m["shed_rate"]
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
    """The reference's tiny tier: both families train through every fault
    leg, and the serving trace replays across the rescue legs."""
    return run(scale="smoke", device=device, blocks=blocks)
