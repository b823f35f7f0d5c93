"""Port parity: Fig. 3 (``repro_torch.paper.fig3_ring``) at the reference's
quick tier, ring(256), T = 20,000, on the reference's own uniform blocks
(see ``tests/test_torch_paper.py``).  Occupancies and hops are held with
``==``; MSE milestones and their ratios at the trainer's ``rtol=1e-4``.
"""
import torch

from benchmarks import fig3_ring as ref_fig3
from repro_torch.paper import fig3_ring
from test_torch_paper import ReferenceBlocks, assert_same


def test_fig3_quick_matches_reference():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        blocks = ReferenceBlocks()
        port = fig3_ring.run(quick=True, device="cpu", blocks=blocks)
    finally:
        torch.set_num_threads(old)
    ref = ref_fig3.run(quick=True)
    assert_same(ref, port, mse_keys=(
        "mhlj_vs_is_early_ratio", "mhlj_vs_uniform_early_ratio",
        "is_vs_uniform_late_ratio"))
    assert [c[1] for c in blocks.calls] == ["uniform", "importance", "mhlj"]
    assert {c[3:] for c in blocks.calls} == {(20_000, 1, 1), (20_000, 1, 3)}
    d = port["derived"]
    assert d["is_entrapped_occupancy"] > d["mhlj_occupancy"]
    assert d["mhlj_vs_is_early_ratio"] < 1
    assert d["mhlj_comm_overhead"] <= 1.1
