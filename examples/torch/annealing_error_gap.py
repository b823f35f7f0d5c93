"""Paper Fig. 6 + Theorem 1's error gap, measured exactly, on the port.

MHLJ's jumps perturb the stationary distribution away from pi_IS, so
weighted RW-SGD converges to a biased fixed point; Theorem 1 bounds the
squared bias by O(p_J^2 ||P_IS - P_Levy||_1^2).  Simulated endpoints are
noisy (SGD variance), so this demo computes the bias IN CLOSED FORM from
the weighted normal equations (``core.theory.error_gap_exact``, host
numpy):

  part 1  log-log sweep of p_J -> slope approaches 2 (the O(p_J^2) law)
  part 2  Fig-6 simulation: annealing p_J -> 0 tracks the unbiased optimum
          while keeping the early-phase escape speed (seed-averaged); the
          walks run on the card unless ``--device cpu``

``--small`` runs part 2 at T = 8,000 over 2 seeds (40,000 over 6).

Run:  PYTHONPATH=src python examples/torch/annealing_error_gap.py [--device cpu] [--small]
"""
import argparse

import numpy as np

from repro_torch.core import MHLJParams, ring, schedules
from repro_torch.core.theory import error_gap_exact
from repro_torch.data.synthetic import make_heterogeneous_regression
from repro_torch.walk_sgd import run_rw_sgd

N = 64
PJS = (0.2, 0.1, 0.05, 0.025, 0.0125)


def exact_gaps(graph) -> tuple:
    """Part 1's problem and its exact gaps at each p_J of :data:`PJS`."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, 6)) * np.where(rng.random(N) < 0.1, 2.0, 1.0)[:, None]
    targs = feats @ (3 * rng.normal(size=6)) + rng.normal(size=N)
    lips = 2 * (feats**2).sum(1)
    gaps = [error_gap_exact(graph, feats, targs, lips, MHLJParams(pj, 0.5, 3))
            for pj in PJS]
    return lips, gaps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="part 2 at T = 8,000 over 2 seeds")
    args = ap.parse_args(argv)
    t = 8_000 if args.small else 40_000
    seeds = range(2 if args.small else 6)
    graph = ring(N)

    # --- part 1: exact O(p_J^2) error gap --------------------------------
    # moderate heterogeneity keeps the chain in Theorem 1's linear-response
    # regime (p_J below the trap-exit scale L_min/L_max)
    lips, gaps = exact_gaps(graph)
    print("exact asymptotic error gap ||x~(p_J) - x_LS||^2  "
          f"(ring {N}, L_max/L_min = {lips.max() / lips.min():.0f})")
    print(f"{'p_J':>9}{'gap':>12}{'log-log slope':>15}")
    slopes = []
    for i, (pj, gap) in enumerate(zip(PJS, gaps)):
        if i:
            slopes.append(np.log(gaps[i] / gaps[i - 1]) / np.log(PJS[i] / PJS[i - 1]))
        print(f"{pj:>9.4f}{gap:>12.3e}" + (f"{slopes[-1]:>15.2f}" if i else ""))
    print("  -> slope approaches 2: the paper's O(p_J^2) gap term.\n")

    # --- part 2: Fig-6 annealing simulation ------------------------------
    data = make_heterogeneous_regression(
        N, dim=6, sigma_high_sq=100.0, p_high=0.05, seed=5, x_star_scale=3.0
    )
    gamma = 0.3 / data.lipschitz.mean()
    mid = slice(t // 20, t // 4)

    def run(schedule):
        tails, mids = [], []
        for s in seeds:
            res = run_rw_sgd(
                "mhlj", graph, data, gamma, t,
                mhlj_params=MHLJParams(0.3, 0.5, 3),
                p_j_schedule=schedule, seed=s, device=args.device,
            )
            mids.append(np.median(res.mse[mid]))
            tails.append(np.median(res.mse[-t // 10:]))
        return float(np.mean(mids)), float(np.mean(tails))

    const_mid, const_tail = run(None)
    ann_mid, ann_tail = run(schedules.polynomial_decay(0.3, t, power=1.0,
                                                       t0=t // 20))
    print(f"Fig-6 simulation (mean over {len(seeds)} seeds, T={t}):")
    print(f"{'variant':<22}{'mid MSE':>12}{'tail MSE':>12}")
    print(f"{'constant p_J=0.3':<22}{const_mid:>12.4g}{const_tail:>12.4g}")
    print(f"{'annealed 0.3->0':<22}{ann_mid:>12.4g}{ann_tail:>12.4g}")
    print("\nannealing keeps the early speed and lowers the asymptotic floor.")
    return {"gaps": gaps, "slopes": slopes,
            "constant": (const_mid, const_tail), "annealed": (ann_mid, ann_tail)}


if __name__ == "__main__":
    main()
