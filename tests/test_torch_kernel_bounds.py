"""The kernels' bounds as package code (``repro_torch.utils.kernel_bounds``):
the moved helpers reproduce the bound column of PERF.md's kernel table at
its shapes, on one H100's published figures (``launch.mesh.HW``), to the
five digits the table prints; and the priced regions of ``op_cost`` add
the same work the helpers count."""
import pytest
import torch

from repro_torch.launch.mesh import HW
from repro_torch.utils import kernel_bounds as kb
from repro_torch.utils.op_cost import count_ops


@pytest.mark.parametrize("name, work, peak, want, by", [
    # flash attention, minitron-8b's layer: B=1, S=4096, N=32, K=8, h=128,
    # causal, bf16
    ("flash_attention", lambda: kb.flash_bound(1, 4096, 4096, 32, 8, 128, 2,
                                               True, 0),
     HW.PEAK_FLOPS_BF16, 0.13900, "operations"),
    # the same layer in float32, at the split-TF32 rate (495 / 3 TFLOP/s)
    ("flash_attention float32", lambda: kb.flash_bound(1, 4096, 4096, 32, 8,
                                                       128, 4, True, 0),
     kb.flash_ops_per_s(4), 0.83317, "operations"),
    # ssd_scan at mamba2's B=4, L=4096, H=32, P=64, N=128, chunk 256, bf16
    ("ssd_scan", lambda: kb.ssd_bound(4, 32, 4096, 64, 128, 256, 2, 1),
     HW.PEAK_FLOPS_BF16, 0.06385, "bytes"),
    # the same ssd_scan in float32, at the split-TF32 rate (495 / 3 TFLOP/s)
    ("ssd_scan float32", lambda: kb.ssd_bound(4, 32, 4096, 64, 128, 256, 4, 1),
     kb.ssd_ops_per_s(4), 0.26091, "operations"),
    # ssd_scan at jamba's H=256, G=8, B=1
    ("ssd_scan jamba", lambda: kb.ssd_bound(1, 256, 4096, 64, 128, 256, 2, 8),
     HW.PEAK_FLOPS_BF16, 0.12771, "bytes"),
    # rmsnorm_fused at (4096, 4096) bf16 (float32 arithmetic)
    ("rmsnorm_fused", lambda: kb.rmsnorm_bound(4096, 4096, 2),
     HW.PEAK_FLOPS_FP32, 0.02004, "bytes"),
])
def test_bounds_reproduce_the_kernel_table(name, work, peak, want, by):
    ms, bound_by = kb.bound(*work(), peak)
    assert round(ms, 5) == want, (name, ms)
    assert bound_by == by


def test_priced_regions_add_the_helpers_work():
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd.ops import ssd_scan

    q = torch.zeros(1, 64, 4, 64)
    k = torch.zeros(1, 64, 2, 64)
    with count_ops() as c:
        mha(q, k, k, causal=True)
    nbytes, ops = kb.flash_bound(1, 64, 64, 4, 2, 64, 4, True, 0)
    assert (c.cost.bytes, c.cost.flops) == (nbytes, ops)

    x = torch.zeros(1, 2, 64, 16)
    d = torch.zeros(1, 2, 64)
    bc = torch.zeros(1, 2, 64, 16)
    with count_ops() as c:
        ssd_scan(x, d, d, bc, bc, chunk=32)
    assert (c.cost.bytes, c.cost.flops) == kb.ssd_bound(1, 2, 64, 16, 16, 32,
                                                         4, 2)
    x, scale = torch.zeros(8, 32), torch.ones(32)
    with count_ops() as c:
        rmsnorm(x, scale)
    assert (c.cost.bytes, c.cost.flops) == kb.rmsnorm_bound(8, 32, 4)


def test_walk_step_work_is_shape_only():
    a = kb.walk_step_work(128, 16, 3)
    assert a == kb.walk_step_work(128, 16, 3)
    assert kb.walk_step_work(256, 16, 3) == (2 * a[0], 2 * a[1])
    assert kb.walk_step_work(128, 32, 3)[0] > a[0]
