"""Port parity: Fig. 6 (``repro_torch.paper.fig6_annealing``) at the
reference's quick tier: the closed-form p_J sweep bit for bit, and the
constant and annealed fleets (ring(64), 3 replicas, T = 20,000, the
scheduled p_J) on the reference's own uniform blocks (see
``tests/test_torch_paper.py``), their tail MSEs at the trainer's
``rtol=1e-4``.
"""
import torch

from benchmarks import fig6_annealing as ref_fig6
from repro_torch.paper import fig6_annealing
from test_torch_paper import ReferenceBlocks, assert_same


def test_fig6_quick_matches_reference():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        blocks = ReferenceBlocks()
        port = fig6_annealing.run(quick=True, device="cpu", blocks=blocks)
    finally:
        torch.set_num_threads(old)
    ref = ref_fig6.run(quick=True)
    assert_same(ref, port, mse_keys=(
        "const_pj_tail_mse", "annealed_tail_mse", "annealed_vs_const"))
    assert blocks.calls == [("const", "mhlj", 0, 20_000, 3, 3),
                            ("annealed", "mhlj", 0, 20_000, 3, 3)]
    gaps = list(port["p_j_sweep"].values())
    assert all(a > b for a, b in zip(gaps, gaps[1:]))
    assert port["derived"]["final_slope"] > 1.5
    assert port["derived"]["gap_shrink"] < 0.05
