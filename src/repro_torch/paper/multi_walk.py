"""Beyond the paper: W parallel MHLJ walks with their models averaged.

The paper runs ONE walk.  Averaging W walks' models divides Theorem 1's
variance term by ~W while the O(p_J^2) bias term stays, so it should cut
the noisy part of the error, not the floor.  On the paper's regression
setting (ring(128), heterogeneous data), each repetition trains all W
walks in one ``run_rw_sgd_multi`` call — one batched engine step serves
every walk each iteration, the walker batch sharded over ``mesh`` (a
``repro_torch.launch.mesh.make_walker_mesh``) when one is given — and
the models are averaged at the end, against the single walk.  Each W row
records the fleet's aggregate update rate (W x T over the fastest
repetition's wall clock).  The port of the reference's
``benchmarks/multi_walk.py``.
"""
from __future__ import annotations

import math
import time

import numpy as np

from repro_torch.core.graphs import ring
from repro_torch.core.transition import MHLJParams
from repro_torch.data import make_heterogeneous_regression
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.paper.common import train

NAME = "multi_walk"
PAPER_CLAIM = (
    "Beyond-paper: averaging W parallel MHLJ walks reduces the variance "
    "component of the error (~1/W) without touching the O(p_J^2) bias floor."
)
WALKERS = (1, 2, 4, 8)


def run(quick: bool = False, *, device="cuda", blocks=None, mesh=None,
        num_steps=None, reps=None, walkers=WALKERS) -> dict:
    """The reference's sweep: T = 20,000 (10,000 quick), 5 (3)
    repetitions, W in ``walkers``; ``num_steps`` and ``reps`` override T
    and the repetitions.  ``mesh`` shards every run's walkers (every rank
    calls ``run`` alike); ``blocks`` injects uniforms
    (``paper.common.train``).  ``derived`` compares W = 1 with the
    largest W (``excess_w8`` and ``variance_reduction_w8`` by default)."""
    n = 128
    graph = ring(n)
    data = make_heterogeneous_regression(
        n, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7, x_star_scale=3.0
    )
    gamma = 0.3 / data.lipschitz.mean()
    T = num_steps or (10_000 if quick else 20_000)
    params = MHLJParams(0.1, 0.5, 3)
    reps = reps or (3 if quick else 5)
    kw = {} if mesh is None else {"mesh": mesh}

    rng = np.random.default_rng(0)
    out_w = {}
    for w in walkers:
        final_mses, hops_per_update, rep_secs = [], [], []
        for rep in range(reps):
            t0 = time.perf_counter()
            res = train(
                blocks, "ring", "mhlj", graph, data, gamma, T,
                mhlj_params=params, seed=1000 * rep, num_walks=w,
                v0s=rng.integers(0, n, size=w), device=device, **kw,
            )
            rep_secs.append(time.perf_counter() - t0)
            final_mses.append(data.mse(res.x_avg))
            hops_per_update.append(res.transitions_per_update)
        out_w[w] = {
            "num_walkers": w,
            "mean_final_mse": float(np.mean(final_mses)),
            "std_final_mse": float(np.std(final_mses)),
            "hops_per_update": float(np.mean(hops_per_update)),
            # the fastest repetition: the first builds the kernels
            "aggregate_walk_steps_per_sec": float(w * T / min(rep_secs)),
        }

    floor = data.mse(data.optimum())
    excess = {w: out_w[w]["mean_final_mse"] - floor for w in out_w}
    w1, wmax = min(walkers), max(walkers)
    return {
        "claim": PAPER_CLAIM,
        "T": T,
        "reps": reps,
        "mesh_devices": 1 if mesh is None else math.prod(
            mesh_sizes(mesh).values()),
        "walks": out_w,
        "ls_floor_mse": floor,
        "excess_over_floor": {str(w): float(e) for w, e in excess.items()},
        "derived": {
            f"excess_w{w1}": excess[w1],
            f"excess_w{wmax}": excess[wmax],
            f"variance_reduction_w{wmax}": excess[w1] / max(excess[wmax], 1e-12),
            f"aggregate_walk_steps_per_sec_w{wmax}": (
                out_w[wmax]["aggregate_walk_steps_per_sec"]
            ),
        },
    }
