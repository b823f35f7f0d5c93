"""Entrapment anatomy (paper Section IV + Theorem 1 quantities), on the port.

For each sparse topology the paper studies (ring, 2-d grid, Watts-Strogatz)
this demo computes, exactly, from the transition matrices (host numpy),

  * the trap escape probability / expected dwell time at the L-spike node,
  * spectral gaps + mixing-time bounds of MH-IS vs the MHLJ chain
    (Theorem 1: tau_mix of the perturbed chain is smaller),
  * the error-gap driver ||P_IS - P_Levy||_1 and the predicted O(p_J^2) gap,

and then confirms the walk-level picture by simulation (occupancy): the
walks run on the card unless ``--device cpu``, drawn from a
``torch.Generator`` seeded 0 where the JAX package passes
``PRNGKey(0)``.  ``--small`` simulates 4,000 steps in place of 40,000.

Run:  PYTHONPATH=src python examples/torch/entrapment_demo.py [--device cpu] [--small]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import transition as trans
from repro_torch.core.entrapment import expected_dwell_time, occupancy_concentration
from repro_torch.core.graphs import grid2d, ring, watts_strogatz
from repro_torch.core.mixing import mixing_time_bounds, spectral_gap
from repro_torch.core.theory import perturbation_l1
from repro_torch.core.transition import MHLJParams
from repro_torch.core.walk import graph_tensors, walk_markov, walk_mhlj

PARAMS = MHLJParams(p_j=0.1, p_d=0.5, r=3)


def graphs():
    return (ring(100), grid2d(10, 10), watts_strogatz(100, 4, 0.1, seed=0))


def analyze(graph, t_sim: int, device, spike=50.0) -> dict:
    n = graph.n
    lips = np.ones(n)
    spike_node = n // 2
    lips[spike_node] = spike

    p_is = trans.mh_importance(graph, lips)
    p_mhlj = trans.mhlj(graph, lips, PARAMS)

    dwell_is = expected_dwell_time(p_is)[spike_node]
    dwell_mhlj = expected_dwell_time(p_mhlj)[spike_node]
    gap_is, gap_mhlj = spectral_gap(p_is), spectral_gap(p_mhlj)
    tmix_is = mixing_time_bounds(p_is)
    tmix_mhlj = mixing_time_bounds(p_mhlj)
    pert = perturbation_l1(graph, lips, PARAMS)

    # simulate the actual walks
    rp_is = torch.as_tensor(trans.row_probs_padded(p_is, graph), device=device)
    nbrs, degs = graph_tensors(graph, device=device)
    traj_is = walk_markov(
        rp_is, nbrs, spike_node, t_sim,
        generator=torch.Generator(device=device).manual_seed(0),
    ).cpu().numpy()
    nodes_mhlj, _ = walk_mhlj(
        rp_is, nbrs, degs, spike_node, t_sim, PARAMS.p_j, PARAMS.p_d, PARAMS.r,
        generator=torch.Generator(device=device).manual_seed(0),
    )
    occ_is = occupancy_concentration(traj_is, n)["topk_share"]
    occ_mhlj = occupancy_concentration(nodes_mhlj.cpu().numpy(), n)["topk_share"]

    print(f"\n== {graph.name}  (n={n}, L spike x{spike:.0f} at node {spike_node})")
    print(f"   escape: E[dwell at spike]     MH-IS {dwell_is:10.1f}   "
          f"MHLJ {dwell_mhlj:10.1f}   ({dwell_is / dwell_mhlj:.1f}x shorter)")
    print(f"   mixing: spectral gap          MH-IS {gap_is:10.2e}   MHLJ {gap_mhlj:10.2e}")
    print(f"   mixing: t_mix upper bound     MH-IS {tmix_is['upper']:10.1f}   "
          f"MHLJ {tmix_mhlj['upper']:10.1f}")
    print(f"   occupancy of top node (sim)   MH-IS {occ_is:10.2%}   MHLJ {occ_mhlj:10.2%}")
    print(f"   error-gap driver ||P_IS - P_Levy||_1 = {pert:.3f}  "
          f"-> predicted gap O(p_J^2 ||.||^2) = {PARAMS.p_j**2 * pert**2:.3f}")
    return {"dwell_is": dwell_is, "dwell_mhlj": dwell_mhlj, "gap_is": gap_is,
            "gap_mhlj": gap_mhlj, "tmix_is": tmix_is, "tmix_mhlj": tmix_mhlj,
            "perturbation_l1": pert, "occupancy_is": occ_is,
            "occupancy_mhlj": occ_mhlj}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="simulate 4,000 steps")
    args = ap.parse_args(argv)
    t_sim = 4_000 if args.small else 40_000
    out = {g.name: analyze(g, t_sim, torch.device(args.device)) for g in graphs()}
    print(
        "\nTakeaway: on every sparse topology the MH-IS chain's dwell time at"
        "\nthe important node explodes with the L ratio (detailed balance,"
        "\nEq. 8) while MHLJ caps it near 1/p_J; the spectral gap improves by"
        "\norders of magnitude, at the price of a bounded O(p_J^2) error gap."
    )
    return out


if __name__ == "__main__":
    main()
