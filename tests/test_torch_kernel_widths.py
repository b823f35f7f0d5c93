"""Port parity at the widened shapes of the two LLM kernels: flash
attention at head_dims 1 to 256 and the SSD scan at head_dim up to 128 and
d_state up to 256.

The plain versions (what the wrappers run on CPU tensors) are held against
the JAX package's Pallas kernels in interpret mode, as
``tests/test_torch_llm_kernels.py`` holds them at the narrower shapes, with
its tolerances: flash attention 2e-5 (float32) / 2e-2 (bfloat16), SSD 2e-4 /
6e-2, each as both atol and rtol.  Each case prints its mismatch rate (the
share of elements beyond the tolerance), which must be 0.  Inputs are made
with numpy from a seed and handed to both packages.

The CUDA kernels' padding is checked on their CPU numerics models: the
bf16 attention kernel's (``_wgmma_bf16_numerics``) at a head_dim zero-padded
to the one it is built at, with the scale of the true head_dim, and the
float32 SSD kernel's (``_ssd_f32_cuda_core_numerics``) split into slabs of
64 head channels and at a d_state zero-padded to a multiple of 16: each
equals the unpadded model bit for bit.  The kernels themselves are held on
the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.ssd.kernel import ssd_scan as jssd_scan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from tests.test_torch_cuda import _ssd_f32_cuda_core_numerics, _ssd_head_major
from tests.test_torch_llm_kernels import _mma_sync_numerics, _wgmma_bf16_numerics

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"flash": {"float32": 2e-5, "bfloat16": 2e-2},
       "ssd": {"float32": 2e-4, "bfloat16": 6e-2}}
MASKS = {"causal": (True, 0), "windowed": (True, 48), "bidirectional": (False, 0)}


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _hold(port: torch.Tensor, ref, tol: float, where: str) -> None:
    """Print the share of elements beyond ``tol`` (atol = rtol) and require
    it to be 0."""
    got = port.float().numpy()
    want = np.asarray(ref, np.float32)
    bad = np.abs(got - want) > tol + tol * np.abs(want)
    print(f"{where}: mismatch rate {bad.mean():.3e} ({int(bad.sum())} of "
          f"{bad.size} beyond {tol}), max abs err "
          f"{float(np.abs(got - want).max()):.3e}")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=where)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [32, 80, 96, 100, 256])
def test_plain_mha_matches_jax_kernel_at_head_dim(h, dtype, mask):
    """``mha`` on CPU tensors (its plain version) against the JAX kernel in
    interpret mode, GQA 2:1, S = 160 (a tail past the 128-row block)."""
    causal, window = MASKS[mask]
    rng = np.random.default_rng(h + len(mask))
    b, s, nq, nkv = 1, 160, 2, 1
    q, k, v = (rng.standard_normal((b, s, n, h)).astype(np.float32)
               for n in (nq, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    ref = jflash(*(t.swapaxes(1, 2) for t in (jq, jk, jv)), causal=causal,
                 window=window, interpret=True).swapaxes(1, 2)
    out = fa_ops.mha(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _hold(out, ref, TOL["flash"][dtype], f"mha h={h} {dtype} {mask}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,n", [(128, 256), (80, 200), (32, 24)])
def test_plain_ssd_scan_matches_jax_kernel_at_width(p, n, dtype):
    """``ssd_scan`` on CPU tensors (its plain version) against the JAX
    kernel in interpret mode, head-major, two chunks of 32."""
    b, h, l, chunk = 1, 2, 64, 32
    xs, da, dt, bs, cs = _ssd_head_major(b, h, l, p, n, p + n)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, dtype) for t in (xs, bs, cs))
    ref = jssd_scan(jx, jnp.asarray(da), jnp.asarray(dt), jb, jc, chunk=chunk,
                    interpret=True)
    out = ssd_ops.ssd_scan(tx, torch.from_numpy(da), torch.from_numpy(dt),
                           tb, tc, chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (b, h, l, p)
    _hold(out, ref, TOL["ssd"][dtype], f"ssd_scan P={p} N={n} {dtype}")


@pytest.mark.parametrize("h,hd,bk", [(96, 128, 128), (80, 128, 128),
                                     (200, 256, 64), (8, 64, 128)])
def test_wgmma_numerics_zero_padded_head_dim_equal_unpadded(h, hd, bk):
    """The bf16 kernel runs head_dim h at its build's HD >= h on columns
    that TMA fills with zeros, scaled by h^-1/2: the numerics model on the
    padded inputs equals the model at h bit for bit (zero columns add
    exact zeros to q k^T; the output's extra columns are dropped)."""
    rng = np.random.default_rng(h)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 300, h)).astype(
        np.float32)).to(torch.bfloat16) for n in (4, 2, 2))
    for causal, window in MASKS.values():
        plain = _wgmma_bf16_numerics(q, k, v, causal=causal, window=window,
                                     bk=bk)
        padded = _wgmma_bf16_numerics(
            *(F.pad(t, (0, hd - h)) for t in (q, k, v)), causal=causal,
            window=window, bk=bk, scale_dim=h)
        assert torch.equal(padded[..., :h], plain), (causal, window)
        assert not padded[..., h:].any()


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_wgmma_numerics_at_head_dim_256_match_jax_kernel(mask):
    """At HD = 256 the bf16 kernel takes 64-row key blocks: its numerics
    model there stays within the bf16 tolerance of the JAX kernel."""
    causal, window = MASKS[mask]
    rng = np.random.default_rng(256 + len(mask))
    q, k, v = (rng.standard_normal((1, n, 200, 256)).astype(np.float32)
               for n in (2, 1, 1))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (q, k, v))
    ref = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    out = _wgmma_bf16_numerics(tq, tk, tv, causal=causal, window=window, bk=64)
    _hold(out, ref, TOL["flash"]["bfloat16"], f"wgmma model h=256 {mask}")


@pytest.mark.parametrize("dtype,h", [(d, h) for d in ("float32", "bfloat16")
                                     for h in (1, 100, 136, 320)]
                         + [("float32", 256), ("float32", 512)])
def test_mma_sync_numerics_at_head_dim_match_jax_kernel(h, dtype):
    """The ``mma_sync`` kernel's arithmetic at head_dims off the wgmma
    builds (bf16: the wgmma rounding at h padded to a multiple of 16, the
    true h's scale; float32: split TF32, past 128 columns at its wider
    slices' tiles) within the dtype's tolerance of the JAX kernel in
    interpret mode; GQA 2:1, S = 160, causal with a 48-key window."""
    rng = np.random.default_rng(h + len(dtype))
    q, k, v = (rng.standard_normal((1, n, 160, h)).astype(np.float32)
               for n in (2, 1, 1))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    ref = jflash(jq, jk, jv, causal=True, window=48, interpret=True)
    out = _mma_sync_numerics(tq, tk, tv, causal=True, window=48)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _hold(out, ref, TOL["flash"][dtype], f"mma_sync model h={h} {dtype}")


def test_ssd_f32_numerics_model_in_slabs_and_padded_states():
    """The float32 SSD kernel's numerics model at head_dim 128 equals the
    model on each 64-channel slab, and at d_state 24 equals the model on
    B and C zero-padded to 32, bit for bit."""
    args = [torch.from_numpy(t) for t in _ssd_head_major(1, 2, 64, 128, 24, 7)]
    xs, da, dt, bs, cs = args
    whole = _ssd_f32_cuda_core_numerics(*args, chunk=32)
    slabs = torch.cat([_ssd_f32_cuda_core_numerics(
        xs[..., sl].contiguous(), da, dt, bs, cs, chunk=32)
        for sl in (slice(0, 64), slice(64, 128))], dim=-1)
    assert torch.equal(whole, slabs)
    padded = _ssd_f32_cuda_core_numerics(xs, da, dt, F.pad(bs, (0, 8)),
                                         F.pad(cs, (0, 8)), chunk=32)
    assert torch.equal(whole, padded)


def test_flash_route_of_by_head_dim():
    """Past 256 (the widest wgmma build) every dtype takes the ``mma_sync``
    route, whose kernel runs any head_dim; only a head_dim of 0
    raises, on either device, and a head_dim of 264 runs on the CPU to the
    JAX kernel's result."""
    bf16, f32 = torch.bfloat16, torch.float32
    for h in (64, 80, 96, 256):
        assert fa_ops.route_of(bf16, head_dim=h) == "wgmma_bf16"
    assert fa_ops.route_of(bf16, head_dim=100) == "mma_sync"
    for h in (100, 256):
        assert fa_ops.route_of(f32, head_dim=h) == "mma_sync"
    for dtype in (bf16, f32):
        assert fa_ops.route_of(dtype, head_dim=264) == "mma_sync"
        with pytest.raises(ValueError, match="head_dim"):
            fa_ops.route_of(dtype, head_dim=0)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.mha(*(torch.zeros((1, 8, 2, 0)),) * 3)
    rng = np.random.default_rng(264)
    q = rng.standard_normal((1, 8, 2, 264)).astype(np.float32)
    (jq, tq) = _both(q, "float32")
    ref = jflash(jq.swapaxes(1, 2), jq.swapaxes(1, 2), jq.swapaxes(1, 2),
                 interpret=True).swapaxes(1, 2)
    _hold(fa_ops.mha(tq, tq, tq), ref, TOL["flash"]["float32"], "mha h=264")


@pytest.mark.parametrize("p,n", [(136, 64), (64, 264), (0, 16)])
def test_ssd_scan_raises_past_its_limits(p, n):
    """The sizes the port once refused: past head_dim 128 and d_state 256
    it now gives the JAX kernel's result (interpret mode); a head_dim of 0
    raises, as the JAX kernel does (its chunk arithmetic divides by P)."""
    if p == 0:
        xs = torch.zeros((1, 1, 32, p))
        da = dt = torch.zeros((1, 1, 32))
        bs = torch.zeros((1, 1, 32, n))
        with pytest.raises(ValueError, match="head_dim 0"):
            ssd_ops.ssd_scan(xs, da, dt, bs, bs, chunk=32)
        with pytest.raises(ZeroDivisionError):
            jssd_scan(*(jnp.asarray(t.numpy()) for t in (xs, da, dt, bs, bs)),
                      chunk=32, interpret=True)
        return
    xs, da, dt, bs, cs = _ssd_head_major(1, 1, 64, p, n, p + n)
    ref = jssd_scan(*(jnp.asarray(t) for t in (xs, da, dt, bs, cs)), chunk=32,
                    interpret=True)
    out = ssd_ops.ssd_scan(*(torch.from_numpy(t) for t in (xs, da, dt, bs, cs)),
                           chunk=32)
    _hold(out, ref, TOL["ssd"]["float32"], f"ssd_scan P={p} N={n}")
