"""The paper's reproduction on the port: Figs. 3–6 and the Theorem-1 /
Remark-1 checks, one module each, named as in the reference's
``benchmarks/``.

Each module keeps the reference's ``NAME``, ``PAPER_CLAIM``, settings,
seeds, step sizes and ``derived`` keys, and exposes
``run(quick=False, *, device="cuda", blocks=None) -> dict``.  Every figure
trains on a dense ``Graph``, which the trainer runs on the engine's
``sparse`` layout: one ``walk_transition_sparse`` launch per training step
on the card.  ``blocks`` injects uniform blocks (see
:func:`repro_torch.paper.common.train`).

    python -c "from repro_torch.paper import fig3_ring; print(fig3_ring.run()['derived'])"
"""
from repro_torch.paper import (
    fig3_ring,
    fig4_erdos_renyi,
    fig5_sparse_graphs,
    fig6_annealing,
    theorem1_remark1,
)

FIGURES = (
    fig3_ring,
    fig4_erdos_renyi,
    fig5_sparse_graphs,
    fig6_annealing,
    theorem1_remark1,
)

__all__ = [
    "FIGURES",
    "fig3_ring",
    "fig4_erdos_renyi",
    "fig5_sparse_graphs",
    "fig6_annealing",
    "theorem1_remark1",
]
