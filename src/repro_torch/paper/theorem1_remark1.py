"""Theorem 1 + Remark 1 quantitative checks (paper §V-VI).

* tau_mix / spectral gap of MHLJ vs MH-IS on trap graphs (jumps improve
  conductance — 'tau_mix is smaller than its MH counterpart').
* Remark 1: measured transitions/update vs 1 + p_J(1/p_d - 1) bound.
* Needell centralized reference rates for the same L distribution.

The port of the reference's ``benchmarks/theorem1_remark1.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graphs import ring, watts_strogatz
from repro_torch.core.theory import needell_rates, theorem1_terms
from repro_torch.core.transition import MHLJParams
from repro_torch.data import make_heterogeneous_regression
from repro_torch.paper.common import train
from repro_torch.walk_sgd.comm_model import comm_report

NAME = "theorem1_remark1"
PAPER_CLAIM = (
    "C6/C7: tau_mix(MHLJ) < tau_mix(MH-IS) on trap graphs; measured "
    "transitions/update within Remark 1's bound."
)


def run(quick: bool = False, *, device="cuda", blocks=None) -> dict:
    n = 64 if quick else 128
    params = MHLJParams(0.1, 0.5, 3)
    out = {"claim": PAPER_CLAIM}

    for tag, graph in (("ring", ring(n)), ("ws", watts_strogatz(n, 4, 0.1, 0))):
        lips = np.ones(n)
        lips[n // 2] = 60.0
        t1 = theorem1_terms(graph, lips, params, num_iters=10_000)
        out[tag] = {
            "tau_mix_mhlj": t1.tau_mix,
            "tau_mix_mh_is": t1.tau_mix_mh,
            "spectral_gap_mhlj": t1.spectral_gap,
            "spectral_gap_mh_is": t1.spectral_gap_mh,
            "perturbation_l1": t1.perturbation_l1,
            "rate_term": t1.rate_term,
            "gap_term": t1.gap_term,
        }

    data = make_heterogeneous_regression(32, dim=4, seed=0)
    res = train(
        blocks, "remark1", "mhlj", ring(32), data, 1e-3,
        5_000 if quick else 20_000, mhlj_params=params, seed=0, device=device,
    )
    out["remark1"] = comm_report(res.transitions, params.p_j, params.p_d, params.r)
    out["needell_rates"] = needell_rates(data.lipschitz, 10_000)
    out["derived"] = {
        "ring_tau_ratio": out["ring"]["tau_mix_mh_is"] / max(1, out["ring"]["tau_mix_mhlj"]),
        "ws_tau_ratio": out["ws"]["tau_mix_mh_is"] / max(1, out["ws"]["tau_mix_mhlj"]),
        "remark1_within": out["remark1"]["within_bound"],
        "hops_per_update": out["remark1"]["transitions_per_update_measured"],
    }
    return out
