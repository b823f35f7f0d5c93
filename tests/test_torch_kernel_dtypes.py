"""Port parity for every input the reference's three LLM kernels take:
float16 on flash attention, the SSD scan and RMSNorm; attention at head_dims
past 256; the SSD scan at head_dims past 128 and d_states past 256; and da
and dt in bfloat16 or float16.

The wrappers' CPU legs (the plain versions) are held against the JAX
package's Pallas kernels in interpret mode, as
``tests/test_torch_kernel_widths.py`` holds them, with inputs made by numpy
from a seed and handed to both packages.  The float32 and bfloat16
tolerances are ``tests/test_kernels.py``'s (flash 2e-5 / 2e-2, SSD 2e-4 /
6e-2, RMSNorm 1e-5 / 3e-2).  The float16 ones, each as both atol and rtol,
are set here from measurement and are tighter than bfloat16's:

- flash 2e-3: the plain version misses the JAX kernel by at most 3.1e-4
  (max of |d| / (1 + |ref|) over the parity cases, one float16 ulp of the
  output), the wgmma kernel's numerics model by 5.7e-4;
- SSD 2e-3: the plain version and the mma kernel's numerics model miss it
  by at most 1.7e-4 (float32 summation order: x, B and C are the same
  float16 values in both);
- RMSNorm 2e-3: two float16 ulps of the output (the plain version is equal
  to the JAX kernel on these inputs);
- whole reduced models 1.5e-2: the reduced minitron and mamba2 in float16
  miss the JAX package's models by at most 3.7e-3 and 5.4e-3 (bfloat16,
  the same weights rounded: 3.3e-2 and 3.9e-2).

The CUDA kernels' new arithmetic is checked on CPU models: the ``mma_sync``
attention kernel's float32 split over output-column slices
(``_split_mma_sync_numerics``), and the tensor-core kernels' float16
rounding (``_wgmma_bf16_numerics`` and ``_mma_sync_numerics`` for
attention, ``_ssd_mma_bf16_numerics`` for the SSD, with
``dtype=torch.float16``).  The kernels themselves are held on the card
(``tests/test_torch_cuda.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ops import mha as jmha
from repro.kernels.rmsnorm.ops import rmsnorm as jrmsnorm
from repro.kernels.ssd.kernel import ssd_scan as jssd_scan
from repro.kernels.ssd.ops import ssd as jssd
from repro.models.factory import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_ref, ssd_scan_ref
from tests.test_torch_cuda import (
    _mma_sync_numerics,
    _split_tf32_numerics,
    _ssd_head_major,
)
from tests.test_torch_llm_kernels import (
    FLASH_CASES,
    _ssd_inputs,
    _ssd_mma_bf16_numerics,
    _wgmma_bf16_numerics,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
TOL = {"flash": {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3},
       "ssd": {"float32": 2e-4, "bfloat16": 6e-2, "float16": 2e-3},
       "rmsnorm": {"float32": 1e-5, "bfloat16": 3e-2, "float16": 2e-3}}
MODEL_TOL = 1.5e-2  # reduced models in float16, as atol and rtol
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
    """Print the largest |d| / (1 + |ref|) and require every element within
    ``tol`` (atol = rtol)."""
    got = port.float().numpy()
    want = np.asarray(ref, np.float32)
    rel = np.abs(got - want) / (1 + np.abs(want))
    print(f"{where}: max |d| / (1 + |ref|) {float(rel.max()):.3e}, max abs "
          f"err {float(np.abs(got - want).max()):.3e} (tol {tol})")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=where)


# ---------------------------------------------------------------- float16

@pytest.mark.parametrize("b,s,nq,nkv,h,causal,window", FLASH_CASES)
def test_plain_mha_float16_matches_jax(b, s, nq, nkv, h, causal, window):
    """``mha`` on CPU tensors in float16 against the JAX package's ``mha``
    (its Pallas kernel in interpret mode) on the same float16 inputs."""
    rng = np.random.default_rng(s + nq + h)
    q, k, v = (rng.standard_normal((b, s, n, h)).astype(np.float32)
               for n in (nq, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float16") for a in (q, k, v))
    ref = jmha(jq, jk, jv, causal=causal, window=window)
    out = fa_ops.mha(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.float16 and out.shape == tq.shape
    _hold(out, ref, TOL["flash"]["float16"], f"mha float16 h={h}")


@pytest.mark.parametrize("b,s,nq,nkv,h,causal,window", FLASH_CASES)
def test_wgmma_float16_numerics_match_jax_kernel(b, s, nq, nkv, h, causal,
                                                 window):
    """The wgmma kernel's float16 build rounds P to float16 (11 bits)
    before P v; its numerics model stays within the float16 tolerance of
    the JAX kernel, which keeps P in float32."""
    rng = np.random.default_rng(s + nq + h)
    q, k, v = (rng.standard_normal((b, n, s, h)).astype(np.float32)
               for n in (nq, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float16") for a in (q, k, v))
    ref = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    out = _wgmma_bf16_numerics(tq, tk, tv, causal=causal, window=window,
                               dtype=torch.float16)
    assert out.dtype == torch.float16 and out.shape == tq.shape
    _hold(out, ref, TOL["flash"]["float16"], f"wgmma float16 model h={h}")


@pytest.mark.parametrize(
    "b,s,nq,nkv,h,causal,window",
    FLASH_CASES + [(1, 160, 2, 1, h, True, 48) for h in (1, 100, 136, 320)])
def test_mma_sync_float16_numerics_match_jax_kernel(b, s, nq, nkv, h, causal,
                                                    window):
    """The ``mma_sync`` kernel's float16 build (P rounded to float16 before
    P v, h padded to a multiple of 16, its own tiles): its numerics model
    stays within the float16 tolerance of the JAX kernel."""
    rng = np.random.default_rng(s + nq + h)
    q, k, v = (rng.standard_normal((b, n, s, h)).astype(np.float32)
               for n in (nq, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float16") for a in (q, k, v))
    ref = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    out = _mma_sync_numerics(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.float16 and out.shape == tq.shape
    _hold(out, ref, TOL["flash"]["float16"], f"mma_sync float16 model h={h}")


@pytest.mark.parametrize("shape", [(4, 128), (2, 17, 256), (3, 384), (5, 1001)])
def test_plain_rmsnorm_float16_matches_jax(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, tx = _both(x, "float16")
    ref = jrmsnorm(jx, jnp.asarray(scale))
    out = rms_ops.rmsnorm(tx, torch.from_numpy(scale))
    assert out.dtype == torch.float16
    _hold(out, ref, TOL["rmsnorm"]["float16"], f"rmsnorm float16 {shape}")


def test_rmsnorm_kernel_for_float16_is_bf16s():
    """A float16 row has bf16's 16-byte vector width: the same kernel."""
    for d in (128, 1001, 2048, 4096, 16384, 20000):
        for aligned in (True, False):
            assert (rms_ops.kernel_for(d, torch.float16, aligned)
                    == rms_ops.kernel_for(d, torch.bfloat16, aligned))


@pytest.mark.parametrize(
    "b,l,heads,groups,p,n,chunk",
    [(1, 128, 4, 1, 32, 16, 32), (2, 96, 4, 2, 64, 32, 32),
     (1, 256, 2, 1, 64, 128, 64)])
def test_plain_ssd_float16_matches_jax(b, l, heads, groups, p, n, chunk):
    """The model-layout ``ssd`` on CPU tensors, x, B, C in float16, against
    the JAX package's ``ssd`` (its Pallas kernel in interpret mode)."""
    xs, dt, a, bs, cs = _ssd_inputs(b, l, heads, groups, p, n, l + p)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, "float16") for t in (xs, bs, cs))
    ref, _ = jssd(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, chunk=chunk)
    out, _ = ssd_ops.ssd(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
                         chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == tx.shape
    _hold(out, ref, TOL["ssd"]["float16"], f"ssd float16 P={p} N={n}")


@pytest.mark.parametrize(
    "b,h,l,p,n,chunk,cancel",
    [(1, 2, 256, 64, 128, 64, False), (1, 3, 128, 64, 64, 128, False),
     (1, 2, 512, 64, 128, 256, False), (1, 2, 512, 64, 128, 256, True)])
def test_ssd_mma_float16_numerics_match_jax_kernel(b, h, l, p, n, chunk,
                                                   cancel):
    """The mma kernel's float16 build (x, B, C in float16; att, B w and the
    entering state split into float16 hi + lo) stays within the float16
    tolerance of the JAX kernel and of the exact recurrence, and the
    plain version does too."""
    xs, da, dt, bs, cs = _ssd_head_major(b, h, l, p, n, l + n + chunk, cancel)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, "float16") for t in (xs, bs, cs))
    tda, tdt = torch.from_numpy(da), torch.from_numpy(dt)
    ref = jssd_scan(jx, jnp.asarray(da), jnp.asarray(dt), jb, jc, chunk=chunk,
                    interpret=True)
    tol = TOL["ssd"]["float16"]
    model = _ssd_mma_bf16_numerics(tx, tda, tdt, tb, tc, chunk=chunk,
                                   dtype=torch.float16)
    _hold(model, ref, tol, "mma float16 model vs the JAX kernel")
    _hold(model, ssd_ref(tx, tda, tdt, tb, tc), tol, "mma float16 model vs ssd_ref")
    _hold(ssd_ops.ssd_scan(tx, tda, tdt, tb, tc, chunk=chunk), ref, tol,
          "plain float16 vs the JAX kernel")


@pytest.mark.parametrize("ddtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16", "float16"])
def test_ssd_scan_takes_16_bit_da_dt(xdtype, ddtype):
    """da and dt in bfloat16 or float16, as the JAX kernel takes them (it
    casts them to float32 first): ``ssd_scan`` gives its result."""
    xs, da, dt, bs, cs = _ssd_head_major(1, 2, 128, 32, 24, 11)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, xdtype) for t in (xs, bs, cs))
    (jda, tda), (jdt, tdt) = (_both(t, ddtype) for t in (da, dt))
    ref = jssd_scan(jx, jda, jdt, jb, jc, chunk=32, interpret=True)
    out = ssd_ops.ssd_scan(tx, tda, tdt, tb, tc, chunk=32)
    assert out.dtype == torch.float32
    _hold(out, ref, TOL["ssd"]["float32"] if xdtype == "float32" else
          TOL["ssd"][xdtype], f"ssd_scan x {xdtype}, da/dt {ddtype}")


def test_routes_take_float16_and_unaligned_bases():
    """float16 rides bf16's routes; a base TMA or cp.async cannot read sends
    either 16-bit type to the ``mma_sync`` attention route (which float32
    takes at any base) and to the SSD's split-TF32 route."""
    for dtype in (torch.bfloat16, torch.float16):
        assert fa_ops.route_of(dtype, 128) == "wgmma_bf16"
        assert fa_ops.route_of(dtype, 128, aligned=False) == "mma_sync"
        assert fa_ops.route_of(dtype, 320) == "mma_sync"
        assert ssd_ops.route_of(dtype, 64, 128, 256) == "mma_bf16"
        assert ssd_ops.route_of(dtype, 64, 128, 256,
                                aligned=False) == "mma_tf32"
    assert fa_ops.route_of(torch.float32, 128, aligned=False) == "mma_sync"
    assert ssd_ops.route_of(torch.float32, 64, 128, 256) == "mma_tf32"


# ------------------------------------------------ head_dim past 256 (attention)

@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("h", [257, 320, 512])
def test_plain_mha_matches_jax_kernel_past_256(h, dtype, mask):
    """``mha`` on CPU tensors against the JAX kernel in interpret mode at
    head_dims the wgmma builds do not reach; GQA 2:1, S = 160."""
    causal, window = MASKS[mask]
    rng = np.random.default_rng(h + len(mask) + len(dtype))
    q, k, v = (rng.standard_normal((1, 160, n, h)).astype(np.float32)
               for n in (2, 1, 1))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    ref = jflash(*(t.swapaxes(1, 2) for t in (jq, jk, jv)), causal=causal,
                 window=window, interpret=True).swapaxes(1, 2)
    assert fa_ops.route_of(tq.dtype, h) == "mma_sync"
    out = fa_ops.mha(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _hold(out, ref, TOL["flash"][dtype], f"mha h={h} {dtype} {mask}")


def _split_mma_sync_numerics(q, k, v, *, causal, window, sw=256):
    """The float32 model of ``csrc/flash_attention.cu``'s split route (past
    h = 256 the output columns in ceil(h / 256) slices of equal width,
    rounded to 16, one CTA each), (B, N, S, h) in, float32 out: per slice,
    :func:`_split_tf32_numerics` over the whole head_dim for the scores and
    v's slice of columns for P v.  Returns the output and each slice's final
    (m, l), (slices, B, N, S) each."""
    h = q.shape[-1]
    slices = -(-h // sw)
    width = -(-(-(-h // slices)) // 16) * 16
    outs, stats = [], []
    for c0 in range(0, h, width):
        out, m, l = _split_tf32_numerics(
            q, k, v[..., c0:c0 + width], causal=causal, window=window, bq=64,
            bk=32 if h > 256 else 16, scale_dim=h, stats=True)
        outs.append(out)
        stats.append((m, l))
    return torch.cat(outs, dim=-1), stats


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("h", [257, 320, 512])
def test_split_cuda_core_numerics(h, mask):
    """The split route's model (``mma_sync``, float32): every slice forms
    bitwise the same running max and sum, and the output equals the
    unsplit plain version (and the JAX kernel) within float32's
    tolerance."""
    causal, window = MASKS[mask]
    rng = np.random.default_rng(h + 7 * len(mask))
    q, k, v = (rng.standard_normal((1, n, 130, h)).astype(np.float32)
               for n in (2, 1, 1))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, stats = _split_mma_sync_numerics(tq, tk, tv, causal=causal,
                                          window=window)
    assert len(stats) == -(-h // 256) >= 2
    for m, l in stats[1:]:
        assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])
    tol = TOL["flash"]["float32"]
    plain = mha_ref(*(x.transpose(1, 2) for x in (tq, tk, tv)), causal=causal,
                    window=window).transpose(1, 2)
    _hold(out, plain.numpy(), tol, f"split model h={h} {mask} vs mha_ref")
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                 window=window, interpret=True)
    _hold(out, ref, tol, f"split model h={h} {mask} vs the JAX kernel")


# ------------------------------------ head_dim past 128, d_state past 256 (SSD)

@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("p", [192, 256])
@pytest.mark.parametrize("n", [320, 512])
def test_plain_ssd_scan_matches_jax_past_the_old_limits(n, p, dtype):
    """``ssd_scan`` on CPU tensors against the JAX kernel in interpret
    mode at head_dims past two slabs and d_states past one 256-row piece;
    two chunks of 32."""
    xs, da, dt, bs, cs = _ssd_head_major(1, 2, 64, p, n, p + n)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, dtype) for t in (xs, bs, cs))
    ref = jssd_scan(jx, jnp.asarray(da), jnp.asarray(dt), jb, jc, chunk=32,
                    interpret=True)
    assert ssd_ops.route_of(tx.dtype, p, n, 32) == "mma_tf32"
    out = ssd_ops.ssd_scan(tx, torch.from_numpy(da), torch.from_numpy(dt), tb,
                           tc, chunk=32)
    assert out.dtype == torch.float32 and out.shape == (1, 2, 64, p)
    _hold(out, ref, TOL["ssd"][dtype], f"ssd_scan P={p} N={n} {dtype}")


def test_pieced_state_sums_in_the_whole_states_order():
    """The CUDA-core route past d_state 256 sums over the state's rows in
    pieces of 256, n ascending: the float32 scores and the state term
    formed piece by piece equal, bit for bit, the same sums taken over all
    rows at once in the same order (each product and add rounded alone)."""
    rng = np.random.default_rng(5)
    c = torch.from_numpy(rng.standard_normal((64, 320)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 320)).astype(np.float32))
    st = torch.from_numpy(rng.standard_normal((320, 64)).astype(np.float32))
    whole_s, whole_y = torch.zeros((64, 64)), torch.zeros((64, 64))
    for nn in range(320):
        whole_s = whole_s + c[:, nn, None] * b[None, :, nn]
        whole_y = whole_y + c[:, nn, None] * st[None, nn, :]
    s, y = torch.zeros((64, 64)), torch.zeros((64, 64))
    for n0 in range(0, 320, 256):
        cp, bp, sp = c[:, n0:n0 + 256], b[:, n0:n0 + 256], st[n0:n0 + 256]
        for nn in range(cp.shape[1]):
            s = s + cp[:, nn, None] * bp[None, :, nn]
            y = y + cp[:, nn, None] * sp[None, nn, :]
    assert torch.equal(s, whole_s) and torch.equal(y, whole_y)


# ---------------------------------------------------- reduced models in float16

@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m"])
def test_reduced_model_float16_with_kernels_matches_reference(arch):
    """A reduced minitron and mamba2 built in float16 by the JAX package,
    carried into the port (``interop.model_from_reference_params``), both
    with ``use_kernels=True``: the port's prefill (its kernels' plain
    versions on the CPU) against the reference's (its Pallas kernels in
    interpret mode), float16 hidden states."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_arch(arch)),
                               use_kernels=True)
    jm = jbuild(jcfg, dtype=jnp.float16)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch(arch)),
                               use_kernels=True)
    tm = interop.model_from_reference_params(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    assert tm.embedding["table"].dtype == torch.float16
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 96))
    ref = jax.jit(jm.apply)(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    out = tm.apply({"tokens": torch.from_numpy(tokens)})
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    _hold(out, ref, MODEL_TOL, f"reduced {arch} float16")
