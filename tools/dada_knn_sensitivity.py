"""How close to ties is the Dada kNN rewire at the Dada scale?

    PYTHONPATH=src python tools/dada_knn_sensitivity.py [--trials 3]

Runs ``repro_torch.walk_sgd.run_dada`` on the CPU at ``chip_smoke.py``
phase 11's Dada setting (BA(2000,3), phase 3's data recipe at n=2000, 4
rounds x 500 steps, W=64, k=3, avg_every 25, seed 0), keeps every round's
personalized models, and prints one JSON line: the edges inserted and
deleted per round, the smallest gap between the k-th and (k+1)-th squared
model distance of each rewire beside the median k-th squared distance,
and, for ``--trials`` runs in which each personalized model entry moves
one float32 ulp up with probability 1/2, the edges those runs insert and
delete.  A change of the edge counts says that last-bit differences in the
models (another device's float32 reductions) can flip kNN edges.  About
half a minute per run.
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.graphs import barabasi_albert
from repro_torch.data import make_heterogeneous_regression
from repro_torch.walk_sgd import graph_learning as gl

DADA_KW = dict(rounds=4, num_steps=500, num_walks=64, k=3, avg_every=25,
               seed=0, device="cpu")


def knn_gaps(models, k):
    x = np.asarray(models, np.float64)
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, np.inf)
    srt = np.sort(d2, axis=1)
    return float(np.min(srt[:, k] - srt[:, k - 1])), float(np.median(
        srt[:, k - 1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    g = barabasi_albert(2000, 3, seed=0, layout="ragged")
    data = make_heterogeneous_regression(
        2000, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
        x_star_scale=3.0)
    personalize = gl.personalize_models
    models = []

    def recording(*a, **k):
        models.append(personalize(*a, **k))
        return models[-1]

    gl.personalize_models = recording
    base = gl.run_dada(g, data, **DADA_KW)
    rng = np.random.default_rng(0)

    def one_ulp(*a, **k):
        out = personalize(*a, **k)
        up = rng.random(out.shape) < 0.5
        return np.where(up, np.nextafter(out, np.float32(np.inf)),
                        out).astype(np.float32)

    gl.personalize_models = one_ulp
    trials = []
    for _ in range(args.trials):
        res = gl.run_dada(g, data, **DADA_KW)
        trials.append({"edges_inserted": res.edges_inserted.tolist(),
                       "edges_deleted": res.edges_deleted.tolist()})
    gl.personalize_models = personalize
    gaps = [knn_gaps(m, DADA_KW["k"]) for m in models[:-1]]
    print(json.dumps({
        "edges_inserted": base.edges_inserted.tolist(),
        "edges_deleted": base.edges_deleted.tolist(),
        "smallest_knn_gap": [gp for gp, _ in gaps],
        "median_kth_sq_distance": [md for _, md in gaps],
        "one_ulp_trials": trials,
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
