"""Quickstart: the paper's experiment in miniature, on the port.

Trains a decentralized least-squares model over a ring of 64 nodes with
heterogeneous data, comparing the three transition designs the paper
studies (Section I) plus the proposed MHLJ (Algorithm 1):

  uniform     MH targeting the uniform distribution
  importance  MH targeting pi_IS(v) ~ L_v  (entrapment-prone on the ring)
  mhlj        importance + Levy jumps  (the paper's fix)

The walks run on the card (one ``walk_transition_sparse`` launch a step)
unless ``--device cpu``; ``--small`` cuts T to 4,000 steps.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--small]
"""
import argparse

import numpy as np

from repro_torch.core import MHLJParams, ring
from repro_torch.core.entrapment import occupancy_concentration
from repro_torch.data.synthetic import make_heterogeneous_regression
from repro_torch.walk_sgd import comm_report, run_rw_sgd

N = 64
PARAMS = MHLJParams(p_j=0.1, p_d=0.5, r=3)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="T = 4,000 steps")
    args = ap.parse_args(argv)
    t = 4_000 if args.small else 20_000
    checkpoints = tuple(c * t // 20_000 for c in (500, 2_000, 5_000, 10_000, 19_500))
    window = 500 * t // 20_000

    graph = ring(N)
    data = make_heterogeneous_regression(
        N, dim=6, sigma_high_sq=1e3, high_nodes=np.array([0]), seed=3,
        x_star_scale=3.0,
    )
    print(f"graph={graph.name}  nodes={N}  L_max/L_bar="
          f"{data.lipschitz.max() / data.lipschitz.mean():.1f}  "
          f"device={args.device}  T={t}\n")

    # the paper's step-size protocol: uniform takes the largest stable step
    # (1/L_max); importance-weighted methods step with 1/L_bar
    gamma = 0.3 / data.lipschitz.mean()
    gamma_u = 0.3 / data.lipschitz.max()

    print("median MSE around iteration t   (walk starts AT the L-spike node)")
    print(f"{'method':<12}" + "".join(f"t={c:>7}  " for c in checkpoints)
          + f"{'occupancy(v0)':>14}{'hops/upd':>10}")
    out = {}
    for method, g in (("uniform", gamma_u), ("importance", gamma), ("mhlj", gamma)):
        res = run_rw_sgd(
            method, graph, data, g, t,
            mhlj_params=PARAMS if method == "mhlj" else None,
            seed=1, v0=0, device=args.device,
        )
        occ = occupancy_concentration(res.update_nodes, N, topk=1)
        meds = [float(np.median(res.mse[max(0, c - window):c + window]))
                for c in checkpoints]
        out[method] = {"occupancy": float(occ["topk_share"]),
                       "spike_share": float(np.mean(res.update_nodes == 0)),
                       "mse": meds,
                       "transitions_per_update": float(res.transitions_per_update)}
        print(f"{method:<12}" + "".join(f"{m:>9.4g}  " for m in meds)
              + f"{occ['topk_share']:>14.2%}{res.transitions_per_update:>10.3f}")

    rep = comm_report(
        run_rw_sgd("mhlj", graph, data, gamma, t // 4, mhlj_params=PARAMS,
                   seed=2, device=args.device).transitions,
        PARAMS.p_j, PARAMS.p_d, PARAMS.r,
    )
    out["remark1"] = rep
    print("\nRemark 1: measured transitions/update = "
          f"{rep['transitions_per_update_measured']:.3f} "
          f"<= bound {rep['transitions_per_update_bound']:.3f}  "
          f"(within_bound={rep['within_bound']})")
    print("\nEntrapment: 'importance' freezes at the L-spike node (occupancy ~1);"
          "\nMHLJ's jumps break detailed balance and restore convergence.")
    return out


if __name__ == "__main__":
    main()
