"""The float16 build of the SSD's ``mma_bf16`` route past float16's range.

``csrc/ssd_scan_mma.cu`` splits three float32 operands (B (.) w, the
entering state and att) into float16 hi + lo.  Unscaled, an operand past
65504 rounds to inf.  The kernel scales each operand block by a power of
two before its split and undoes it on the float32 product; its numerics
model (``_ssd_mma_bf16_numerics``, scaled by default for float16) applies
the same scales.  Here, at inputs whose operands pass 65504
(``tests/test_torch_cuda.py::SSD_RANGE_CASES``), the JAX package's kernel
(interpret mode) is finite, the scaled model is finite and the unscaled
model is not.  The scaled model is held to the float16 tolerance (2e-3,
atol = rtol) of the JAX kernel and of the float64 chunked scan where the
JAX kernel itself is within it of the float64 result ("probe"); where it is
not, two float32 summation orders of these magnitudes differ by more than
the tolerance, and the model's float64 error is held to at most twice the
JAX kernel's (there the JAX kernel misses the float64 result by 5.1e-2 of
1 + |y| at "strong" and 2.3e-3 at "growing").  ``ssd_ref``, the float32
sequential recurrence, is no yardstick at these magnitudes: at "probe" it
misses the JAX kernel by 2.3e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_scan as jssd_scan
from repro_torch.kernels.ssd.ref import ssd_scan_ref
from tests.test_torch_cuda import SSD_RANGE_CASES, _ssd_range_head_major
from tests.test_torch_llm_kernels import (
    E_MIN,
    _scaled_halves,
    _split_exp,
    _ssd_mma_bf16_numerics,
)

TOL = 2e-3  # tests/test_torch_kernel_dtypes.py's SSD float16 tolerance
FLOAT16_MAX = 65504.0


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    """max |d| / (1 + |want|): the tolerance's measure (atol = rtol)."""
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


@pytest.mark.parametrize("case", sorted(SSD_RANGE_CASES))
def test_ssd_mma_float16_scaled_splits_match_jax_kernel(case):
    (xs, da, dt, bs, cs), chunk = _ssd_range_head_major(case)
    ref = np.asarray(jssd_scan(*(jnp.asarray(t) for t in (xs, da, dt, bs, cs)),
                               chunk=chunk, interpret=True), np.float64)
    assert np.isfinite(ref).all()
    args = [torch.from_numpy(t) for t in (xs, da, dt, bs, cs)]
    peaks = {}
    model = _ssd_mma_bf16_numerics(*args, chunk=chunk, dtype=torch.float16,
                                   peaks=peaks)
    assert torch.isfinite(model).all(), case
    assert max(peaks.values()) > FLOAT16_MAX, peaks
    if case == "strong":
        assert peaks["enter"] > 1e6, peaks
    unscaled = _ssd_mma_bf16_numerics(*args, chunk=chunk, dtype=torch.float16,
                                      scaled=False)
    assert not torch.isfinite(unscaled).all()  # what the scales repair
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk).numpy()
    model = model.double().numpy()
    err = {"model": np.abs(model - exact).max(), "jax": np.abs(ref - exact).max()}
    rel = {"model vs jax": _rel(model, ref), "jax vs float64": _rel(ref, exact),
           "model vs float64": _rel(model, exact)}
    print(f"{case}: peaks {peaks}, max |y| {np.abs(exact).max():.4e}, "
          f"unscaled non-finite {float((~torch.isfinite(unscaled)).double().mean()):.4f}, "
          f"float64 errors {err}, {rel}")
    assert err["model"] <= 2 * err["jax"], err
    if rel["jax vs float64"] <= TOL:
        assert rel["model vs jax"] <= TOL and rel["model vs float64"] <= TOL, rel
    assert case != "probe" or rel["jax vs float64"] <= TOL, rel


@pytest.mark.parametrize("magnitude", [1e-30, 1e-8, 0.3, 7e4, 3e9, 1e30, 1e38])
def test_scaled_split_error_is_relative_to_the_block(magnitude):
    """A float32 block of largest magnitude m, split at 2^-e (the kernel's
    exponent for it): hi + lo is finite and within 2^-22 m of each value,
    or 2^-38 where m < 2 (the exponent's lower clamp)."""
    rng = np.random.default_rng(int(np.log10(magnitude)) + 40)
    v = torch.from_numpy((magnitude * rng.standard_normal(4096) /
                          np.abs(rng.standard_normal(4096)).clip(1e-3))
                         .clip(-3e38, 3e38).astype(np.float32))
    m = v.abs().max()
    e = _split_exp(m)
    assert int(e) >= E_MIN
    hi, lo = _scaled_halves(v, e, torch.float16)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    err = (hi.double() + lo.double() - v.double()).abs().max().item()
    assert err <= max(2.0 ** -22 * float(m), 2.0 ** -38), (err, float(m))
    if float(m) > FLOAT16_MAX:  # unscaled, the split overflows
        hi0, _ = _scaled_halves(v, None, torch.float16)
        assert not torch.isfinite(hi0).all()
