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

Beside the figures, three sweeps with the same ``run`` signature:
``law_sweep`` (every chain law on the trap-prone families),
``fault_sweep`` (training and walk-routed serving under node faults,
rescue on and off) and ``serve_throughput`` (walk-routed serving under
every routing law); ``multi_walk`` (W averaged walks against one, its
walkers sharded over ``mesh=``); and ``llm_walk_throughput``
(``run(quick=False, *, device="cuda")``: walk-orchestrated LLM training
steps/s per method, the sampler on both backends, serving).
"""
from repro_torch.paper import (
    fault_sweep,
    fig3_ring,
    fig4_erdos_renyi,
    fig5_sparse_graphs,
    fig6_annealing,
    law_sweep,
    llm_walk_throughput,
    multi_walk,
    serve_throughput,
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
    "fault_sweep",
    "fig3_ring",
    "fig4_erdos_renyi",
    "fig5_sparse_graphs",
    "fig6_annealing",
    "law_sweep",
    "llm_walk_throughput",
    "multi_walk",
    "serve_throughput",
    "theorem1_remark1",
]
