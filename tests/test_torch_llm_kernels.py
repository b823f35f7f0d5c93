"""Port parity: the plain versions of the three LLM kernels against the
JAX package's ops, which run their Pallas kernels in interpret mode on the
CPU (``repro/kernels/*/ops.py``), as ``tests/test_kernels.py`` runs them.

Each case makes its inputs with numpy from a seed and hands the same
values to both packages (bfloat16 cases round the same float32 draws in
both).  Tolerances are those of ``tests/test_kernels.py``: flash attention
2e-5 (float32) / 2e-2 (bfloat16), SSD 2e-4 / 6e-2, RMSNorm 1e-5 / 3e-2,
each as both atol and rtol.  The CUDA kernels themselves are held against
these plain versions on the card (``tests/test_torch_cuda.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ops import mha as jmha
from repro.kernels.rmsnorm.ops import rmsnorm as jrmsnorm
from repro.kernels.ssd.kernel import ssd_scan as jssd_scan
from repro.kernels.ssd.ops import ssd as jssd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_ref, ssd_scan_ref
from tests.test_torch_cuda import (
    _mma_sync_numerics,
    _ssd_f32_cuda_core_numerics,
    _ssd_head_major,
    _ssd_tf32_numerics,
    _wgmma_bf16_numerics,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {
    "flash": {"float32": 2e-5, "bfloat16": 2e-2},
    "ssd": {"float32": 2e-4, "bfloat16": 6e-2},
    "rmsnorm": {"float32": 1e-5, "bfloat16": 3e-2},
}


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------- flash attn
FLASH_CASES = [
    (1, 128, 4, 4, 64, True, 0),      # MHA
    (2, 256, 8, 2, 64, True, 0),      # GQA 4:1
    (1, 256, 4, 1, 128, True, 0),     # MQA
    (2, 128, 4, 4, 64, False, 0),     # bidirectional
    (1, 384, 4, 2, 64, True, 128),    # sliding window 128
    (1, 160, 4, 4, 64, True, 0),      # S not a block multiple
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nq,nkv,h,causal,window", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(b, s, nq, nkv, h, causal, window, dtype):
    rng = np.random.default_rng(s + nq + h)
    q, k, v = (rng.standard_normal((b, s, n, h)).astype(np.float32)
               for n in (nq, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    ref = jmha(jq, jk, jv, causal=causal, window=window)
    out = fa_ops.mha(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref, TOL["flash"][dtype])


@pytest.mark.parametrize("b,s,nq,nkv,h,causal,window", FLASH_CASES)
def test_wgmma_bf16_numerics_match_jax_kernel(b, s, nq, nkv, h, causal, window):
    """Before the card: the bf16 kernel's rounding (bf16 P, base-2 exp, l
    from the float32 P) stays within the bf16 tolerance of the JAX kernel
    (interpret mode), on the plain-parity cases above."""
    rng = np.random.default_rng(s + nq + h)
    q, k, v = (rng.standard_normal((b, n, s, h)).astype(np.float32)
               for n in (nq, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (q, k, v))
    ref = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    out = _wgmma_bf16_numerics(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    _close(out, ref, TOL["flash"]["bfloat16"])


@functools.lru_cache(maxsize=None)
def _jax_flash_case(case: tuple, dtype: str):
    """A ``FLASH_CASES`` case's (B, N, S, h) inputs in ``dtype`` (the draws
    of the test above) and the JAX kernel's output on them (interpret
    mode), made once a worker."""
    b, s, nq, nkv, h, causal, window = case
    rng = np.random.default_rng(s + nq + h)
    q, k, v = (rng.standard_normal((b, n, s, h)).astype(np.float32)
               for n in (nq, nkv, nkv))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    ref = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    return (tq, tk, tv), np.asarray(ref, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nq,nkv,h,causal,window", FLASH_CASES)
def test_mma_sync_numerics_match_jax_kernel(b, s, nq, nkv, h, causal, window,
                                            dtype):
    """Before the card: the ``mma_sync`` kernel's arithmetic (bf16: the
    wgmma kernel's rounding at its own tiles; float32: split TF32) stays
    within the dtype's tolerance of the JAX kernel (interpret mode)."""
    (tq, tk, tv), ref = _jax_flash_case((b, s, nq, nkv, h, causal, window),
                                        dtype)
    out = _mma_sync_numerics(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref, TOL["flash"][dtype])


def test_one_pass_tf32_misses_the_float32_tolerance():
    """Why the float32 build splits each operand: with one TF32 product a
    k-step (10 mantissa bits an operand) the kernel's model misses the JAX
    kernel by more than 2e-5 on a case where the split model (three
    products) holds it."""
    tol = TOL["flash"]["float32"]
    missed = []
    for case in FLASH_CASES:
        (tq, tk, tv), ref = _jax_flash_case(case, "float32")
        causal, window = case[-2:]
        one = _mma_sync_numerics(tq, tk, tv, causal=causal, window=window,
                                 split=False)
        err = float(np.abs(one.numpy() - ref).max())
        print(f"one-pass TF32 {case}: max abs err {err:.3e} (tol {tol})")
        if not np.allclose(one.numpy(), ref, atol=tol, rtol=tol):
            missed.append(case)
    assert missed, "one TF32 product a k-step met the float32 tolerance"


def test_flash_routes_by_dtype_table():
    """float16 rides bf16's route (the reference's kernel takes any float
    dtype); float64 and integers, which the reference never sees with JAX's
    x64 off, still raise."""
    assert fa_ops.route_of(torch.bfloat16) == "wgmma_bf16"
    assert fa_ops.route_of(torch.float16) == "wgmma_bf16"
    assert fa_ops.route_of(torch.float32) == "mma_sync"
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(TypeError):
            fa_ops.route_of(dtype)
    assert set(fa_ops.mha.launches_by_route) == {"wgmma_bf16", "mma_sync"}


def test_flash_wrapper_rejects_other_devices():
    q = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa_ops.mha(q, q, q)


# ------------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 17, 256), (3, 384)])
def test_rmsnorm_plain_matches_jax_kernel(shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, tx = _both(x, dtype)
    ref = jrmsnorm(jx, jnp.asarray(scale))
    out = rms_ops.rmsnorm(tx, torch.from_numpy(scale))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, ref, TOL["rmsnorm"][dtype])


@pytest.mark.parametrize(
    "d,dtype,aligned,kernel",
    [
        (1024, torch.bfloat16, True, "warp"),
        (2048, torch.float32, True, "warp"),
        (1020, torch.float32, True, "warp"),     # 255 float32 vectors
        (1020, torch.bfloat16, True, "scalar"),  # not a multiple of 8
        (1001, torch.float32, True, "scalar"),
        (2056, torch.float32, True, "cta"),
        (4096, torch.bfloat16, True, "cta"),
        (16384, torch.bfloat16, True, "cta"),    # 2048 vectors, the most held
        (16392, torch.bfloat16, True, "scalar"),
        (8196, torch.float32, True, "scalar"),
        (1024, torch.bfloat16, False, "scalar"),  # a base not 16-byte aligned
    ],
)
def test_rmsnorm_kernel_by_shape(d, dtype, aligned, kernel):
    assert rms_ops.kernel_for(d, dtype, aligned) == kernel


# ----------------------------------------------------------------------- ssd
def _ssd_inputs(b, l, heads, groups, p, n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, l, heads, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, heads)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(heads) * 0.3)).astype(np.float32)
    bs = rng.standard_normal((b, l, groups, n)).astype(np.float32)
    cs = rng.standard_normal((b, l, groups, n)).astype(np.float32)
    return xs, dt, a, bs, cs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,l,heads,groups,p,n,chunk",
    [
        (2, 96, 4, 2, 64, 32, 32),    # grouped B/C, L not a chunk multiple
        (1, 128, 4, 1, 32, 16, 32),
    ],
)
def test_ssd_plain_matches_jax_kernel(b, l, heads, groups, p, n, chunk, dtype):
    xs, dt, a, bs, cs = _ssd_inputs(b, l, heads, groups, p, n, l + heads)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, dtype) for t in (xs, bs, cs))
    ref, _ = jssd(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, chunk=chunk)
    out, _ = ssd_ops.ssd(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
                         chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == tx.shape
    _close(out, ref, TOL["ssd"][dtype])


def test_ssd_scan_plain_matches_jax_kernel_and_recurrence():
    """Head-major, at the kernel's own interface: the port's per-chunk plain
    version against the JAX kernel and against the exact recurrence."""
    rng = np.random.default_rng(5)
    b, h, l, p, n, chunk = 1, 3, 64, 32, 16, 16
    xs = rng.standard_normal((b, h, l, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, l)))).astype(np.float32)
    da = (dt * -np.exp(rng.standard_normal(h) * 0.3)[None, :, None]).astype(np.float32)
    bs, cs = (rng.standard_normal((b, h, l, n)).astype(np.float32) for _ in range(2))
    ref = jssd_scan(*(jnp.asarray(t) for t in (xs, da, dt, bs, cs)),
                    chunk=chunk, interpret=True)
    args = [torch.from_numpy(t) for t in (xs, da, dt, bs, cs)]
    out = ssd_scan_ref(*args, chunk=chunk)
    _close(out, ref, TOL["ssd"]["float32"])
    _close(ssd_ref(*args), ref, TOL["ssd"]["float32"])
    assert ssd_ops.ssd_scan(*args, chunk=chunk).equal(out)  # CPU -> plain
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_ref(*args, chunk=24)


def test_ssd_padding_rows_leave_the_state_alone():
    """Zero dt/da rows appended past L change neither y before them nor the
    carried state (so the wrapper's padding is exact)."""
    xs, dt, a, bs, cs = _ssd_inputs(1, 40, 2, 1, 16, 16, 3)
    t = [torch.from_numpy(v) for v in (xs, dt, a, bs, cs)]
    y_pad, _ = ssd_ops.ssd(*t, chunk=16)  # L=40 -> 48
    y_exact = ssd_ops.ssd_oracle(*t)
    _close(y_pad, y_exact.numpy(), TOL["ssd"]["float32"])


def _split_bf16(v: torch.Tensor, dtype=torch.bfloat16):
    """float32 v -> (hi, lo) in bf16 (or ``dtype``): hi = bf16(v), lo =
    bf16(v - hi)."""
    hi = v.to(dtype)
    return hi, (v - hi.float()).to(dtype)


# csrc/ssd_scan_mma.cu's float16 split scales (SPLIT_TOP, E_MIN, E_MAX,
# ATT_SLACK there): a block whose largest magnitude is m is scaled by 2^-e,
# e = ilogb(m) - 14 clamped to [-13, 113], before its split; att's running
# exponent per row, when a tile needs a larger one, is set 8 above it
SPLIT_TOP, E_MIN, E_MAX, ATT_SLACK = 14, -13, 113, 8


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 from its bits, exactly (e int, in [-126, 127])."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _need_exp(m: torch.Tensor) -> torch.Tensor:
    """ilogb(m) - SPLIT_TOP from the bits of float32 m >= 0 (zero and
    subnormals read as 2^-127), as the kernel reads them."""
    return (m.float().contiguous().view(torch.int32) >> 23) - 127 - SPLIT_TOP


def _split_exp(m: torch.Tensor) -> torch.Tensor:
    return _need_exp(m).clamp(E_MIN, E_MAX)


def _scaled_halves(v: torch.Tensor, e=None, dtype=torch.float16):
    """float32 v -> its split (hi, lo) in ``dtype``, taken at 2^-e (``e``
    broadcast to v; None: unscaled), each scaled back in float32."""
    if e is None:
        hi, lo = _split_bf16(v, dtype)
        return hi.float(), lo.float()
    hi, lo = _split_bf16(v * _pow2(-e), dtype)
    return hi.float() * _pow2(e), lo.float() * _pow2(e)


def _att_exponents(att: torch.Tensor) -> torch.Tensor:
    """Per element of att (..., Q, Q), the running exponent of its row at
    its 16-column tile, as pass 3 keeps it over the tiles in order: E_MIN
    at first; a tile whose largest |att| in the row needs a larger one
    raises it to min(need + ATT_SLACK, E_MAX)."""
    q = att.shape[-1]
    need = _need_exp(att.abs().reshape(*att.shape[:-1], q // 16, 16).amax(-1))
    r = torch.full(need.shape[:-1], E_MIN, dtype=torch.int32)
    out = torch.empty_like(need)
    for t in range(q // 16):
        r = torch.where(need[..., t] > r,
                        (need[..., t] + ATT_SLACK).clamp(max=E_MAX), r)
        out[..., t] = r
    return out.repeat_interleave(16, dim=-1)


def _ssd_mma_bf16_numerics(xs, da, dt, bs, cs, *, chunk, split=True,
                           dtype=torch.bfloat16, scaled=None, peaks=None):
    """A plain model of ``csrc/ssd_scan_mma.cu``'s arithmetic, head-major
    bf16 x/B/C and float32 da/dt in, y (B, H, L, P) float32 out.  Pass 1:
    per chunk, w_j = exp(cum_Q - cum_j) dt_j, B (.) w in float32, split into
    bf16 hi + lo, S_c = (B w)^T x summed in float32; pass 2: the entering
    states in float32, in order; pass 3: y = exp(cum_i) (C @ enter) with
    enter split likewise, then att = select(j <= i, (C B^T) exp(cum_i -
    cum_j), 0) dt_j in float32, split, y += att @ x.  ``split=False`` rounds
    each float32 operand once to bf16 instead.  ``dtype`` is the kernel's
    16-bit type (float16: x, B, C and the splits in float16).

    ``scaled`` (default: on for float16, the kernel's float16 build) scales
    each float32 operand block by a power of two before its split and
    undoes it after the product, as the kernel does: B (.) w by 16 state
    rows of a chunk (a warp's), enter by chunk, att by row with the
    running exponent of :func:`_att_exponents`.  A dict ``peaks`` gets the largest |B (.) w|,
    |enter| and |att| before scaling."""
    if scaled is None:
        scaled = dtype == torch.float16

    def halves(v, e=None):
        if not split:
            return v.to(dtype).float(), torch.zeros_like(v)
        return _scaled_halves(v, e, dtype)

    def products(v, rhs, e=None):  # v (float32) @ rhs (dtype-exact)
        hi, lo = halves(v, e)
        return hi @ rhs if not split else hi @ rhs + lo @ rhs

    b, h, l, p = xs.shape
    n = bs.shape[-1]
    x, bb, cc = (t.float().reshape(b, h, l // chunk, chunk, -1)
                 for t in (xs, bs, cs))
    dtc = dt.reshape(b, h, l // chunk, chunk)
    cum = torch.cumsum(da.reshape(b, h, l // chunk, chunk), dim=-1)
    # pass 1: the chunk states and decays
    w = torch.exp(cum[..., -1:] - cum) * dtc
    bw = (bb * w[..., None]).transpose(-1, -2)  # (..., N, Q)
    e_bw = None
    if scaled:  # one exponent per 16 state rows
        e_bw = _split_exp(bw.abs().reshape(*bw.shape[:-2], n // 16, -1).amax(-1))
        e_bw = e_bw.repeat_interleave(16, dim=-1)[..., None]
    states = products(bw, x, e_bw)
    decay = torch.exp(cum[..., -1])
    # pass 2: the states entering each chunk
    enter = torch.zeros_like(states)
    state = torch.zeros((b, h, n, p))
    for c in range(l // chunk):
        enter[:, :, c] = state
        state = decay[:, :, c, None, None] * state + states[:, :, c]
    # pass 3: y
    e_enter = _split_exp(enter.abs().amax((-1, -2)))[..., None, None] if scaled else None
    ehi, elo = halves(enter, e_enter)
    y_state = torch.exp(cum)[..., None] * (cc @ ehi + cc @ elo)
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    scores = cc @ bb.transpose(-1, -2)
    decay_ij = torch.exp(cum[..., :, None] - cum[..., None, :])
    att = torch.where(causal, scores * decay_ij, 0.0) * dtc[..., None, :]
    y_att = products(att, x, _att_exponents(att) if scaled else None)
    if peaks is not None:
        peaks.update({"b_w": float(bw.abs().max()), "enter": float(enter.abs().max()),
                      "att": float(att.abs().max())})
    return (y_state + y_att).reshape(b, h, l, p)


@pytest.mark.parametrize(
    "b,h,l,p,n,chunk,cancel",
    [
        (1, 2, 256, 64, 128, 64, False),
        (1, 3, 128, 64, 64, 128, False),
        (1, 2, 512, 64, 128, 256, False),
        (1, 2, 512, 64, 128, 256, True),   # outputs that cancel
    ],
)
def test_ssd_mma_bf16_numerics_match_jax_kernel(b, h, l, p, n, chunk, cancel):
    """Before the card: the bf16 route's rounding (B w, att and the entering
    state each split into bf16 hi + lo) stays within the bf16 tolerance of
    the JAX kernel (interpret mode) and of the exact recurrence."""
    xs, da, dt, bs, cs = _ssd_head_major(b, h, l, p, n, l + n + chunk, cancel)
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, "bfloat16") for t in (xs, bs, cs))
    tda, tdt = torch.from_numpy(da), torch.from_numpy(dt)
    ref = np.asarray(jssd_scan(jx, jnp.asarray(da), jnp.asarray(dt), jb, jc,
                               chunk=chunk, interpret=True), np.float32)
    out = _ssd_mma_bf16_numerics(tx, tda, tdt, tb, tc, chunk=chunk)
    exact = ssd_scan_ref(*(t.double() for t in (tx, tda, tdt, tb, tc)),
                         chunk=chunk)
    err64 = float((out.double() - exact).abs().max())
    tol = TOL["ssd"]["bfloat16"]
    for name, want in (("the JAX kernel", ref),
                       ("ssd_ref", ssd_ref(tx, tda, tdt, tb, tc).numpy())):
        np.testing.assert_allclose(
            out.numpy(), want, atol=tol, rtol=tol,
            err_msg=f"against {name}; max abs err against the float64 "
                    f"ssd_scan_ref {err64:.3e}")
    if cancel:  # one bf16 rounding per float32 operand is not enough here
        once = _ssd_mma_bf16_numerics(tx, tda, tdt, tb, tc, chunk=chunk,
                                      split=False)
        bad = (once.double() - exact).abs() > tol + tol * exact.abs()
        assert bad.any(), f"split {err64:.3e}"


# The float32 route's first design (csrc/ssd_scan.cu on the CUDA cores,
# before its split-TF32 redesign) at d_state 64, chunk 128: its numerics
# model (_ssd_f32_cuda_core_numerics, kept beside the card tests, as the
# GPU machine has no JAX) reproduced the card's output bit for bit with
# that kernel's first, float32 within-chunk cumsum, whose error reached
# 2.1x the plain version's (the card test's rule is 2x): the order of the
# cumsum, not a fault.  The kernel then accumulated the cumsum in float64,
# as its split-TF32 successor does; the model shows both on the CPU.
@pytest.mark.parametrize("decay", ["model", "slow", "cancel"])
def test_ssd_f32_numerics_model_matches_jax_kernel(decay):
    """The model of the float32 route stays within the float32 tolerance of
    the JAX kernel (interpret mode) at d_state 64, chunk 128."""
    args = _ssd_head_major(1, 2, 512, 64, 64, 3, cancel=decay == "cancel",
                           slow=decay == "slow")
    ref = jssd_scan(*(jnp.asarray(t) for t in args), chunk=128, interpret=True)
    out = _ssd_f32_cuda_core_numerics(*(torch.from_numpy(t) for t in args),
                                      chunk=128)
    _close(out, ref, TOL["ssd"]["float32"])


def test_ssd_f32_numerics_model_cumsum_order():
    """At d_state 64, chunk 128 under the model's decay (cum_Q ~ -100): with
    a float32 cumsum the model misses the float64 result by more than twice
    the plain version's error on one of three inputs; with the float64
    cumsum the kernel takes, within twice on all three."""
    ratio = {False: [], True: []}
    for seed in range(3):
        args = [torch.from_numpy(t) for t in
                _ssd_head_major(1, 2, 512, 64, 64, seed)]
        exact = ssd_scan_ref(*(t.double() for t in args), chunk=128)
        err_p = (ssd_scan_ref(*args, chunk=128).double() - exact).abs().max()
        for cum_f64 in ratio:
            y = _ssd_f32_cuda_core_numerics(*args, chunk=128, cum_f64=cum_f64)
            ratio[cum_f64].append(float((y.double() - exact).abs().max() / err_p))
    assert max(ratio[False]) > 2, ratio
    assert max(ratio[True]) <= 2, ratio


def _mamba2_layer0_ssd_args(seed: int, l: int) -> tuple:
    """Head-major ssd_scan inputs as mamba2-370m's layer 0 makes them (B=1,
    H=32, P=64, N=128): its mixer from the port's init law (dt in [1e-3,
    0.1], a = -1 .. -32 by head) under torch's ``seed``, applied to a
    normalised N(0, 1) residual stream of length ``l``; x, B and C rounded
    through bf16 as the model's weights are."""
    import torch.nn.functional as F

    from repro_torch.configs import MAMBA2_370M
    from repro_torch.models.layers import mamba2 as mamba_mod
    from repro_torch.models.mamba_model import mamba_dims_from_cfg

    dims = mamba_dims_from_cfg(MAMBA2_370M)
    gen = torch.Generator().manual_seed(seed)
    mixer = mamba_mod.mamba_init(dims, torch.float32, "cpu", gen)
    x = torch.randn(1, l, dims.d_model, generator=gen)
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5)
    _, conv_in, dt_raw = mamba_mod._split_proj(mixer, x, dims)
    conv = F.silu(mamba_mod._causal_conv(conv_in, mixer["conv_w"],
                                         mixer["conv_b"]))
    xs, bs, cs = mamba_mod._split_conv_out(conv, dims)
    dt = F.softplus(dt_raw + mixer["dt_bias"])
    args = ssd_ops._head_major(xs, dt, -torch.exp(mixer["a_log"]), bs, cs)
    return tuple(t.bfloat16().float() if t.ndim == 4 else t for t in args)


# The float32 route's error at mamba2's layer 0 rose on the card from 1.0x
# to 1.39x the plain version's when its cumsum went to float64.  There the
# decay reaches cum ~ -800 within a chunk (head 31), where half an ulp of
# |cum| is 3e-5, and exp(cum_i - cum_j) carries cum's rounding into the
# output whichever order rounds it: which cumsum lands ahead at the single
# largest error depends on the input.  (torch's CPU cumsum accumulates
# float32 in float64, so the CPU plain version rounds cum as the kernel
# now does; on the card its cumsum is a float32 scan.)
def test_ssd_f32_numerics_model_cumsum_at_mamba2_layer0():
    """At mamba2-370m's layer-0 shape and decay law, the model's error with
    the float32 cumsum is above the float64 cumsum's on some inputs and
    below it on others, and both stay within twice the plain version's."""
    ratio = []
    for seed in range(4):
        args = _mamba2_layer0_ssd_args(seed, 512)
        exact = ssd_scan_ref(*(t.double() for t in args), chunk=256)
        err_p = (ssd_scan_ref(*args, chunk=256).double() - exact).abs().max()
        err = {}
        for cum_f64 in (False, True):
            y = _ssd_f32_cuda_core_numerics(*args, chunk=256, cum_f64=cum_f64)
            err[cum_f64] = float((y.double() - exact).abs().max())
            assert err[cum_f64] <= 2 * err_p, (seed, cum_f64, err, float(err_p))
        ratio.append(err[False] / err[True])
    print(f"float32 / float64 cumsum, max error at mamba2 layer 0: {ratio}")
    assert min(ratio) < 1 < max(ratio), ratio


# The split-TF32 route (csrc/ssd_scan.cu, ``mma_tf32``): its numerics
# model (_ssd_tf32_numerics, kept beside the card tests, which hold the
# kernel to it) at d_state 64, chunk 128 under the three decays of the
# card's float32 cases.  float32 operands split into two TF32 parts: three
# products a product, four for att @ x, whose operands decide the
# cancelling cases; each block of 64 k summed from zero.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["model", "slow", "cancel"])
def test_ssd_tf32_numerics_model_matches_jax_kernel(decay, dtype):
    """The split-TF32 model stays within the dtype's tolerance of the JAX
    kernel (interpret mode); bf16 x, B and C are exact in TF32, unsplit."""
    xs, da, dt, bs, cs = _ssd_head_major(1, 2, 512, 64, 64, 3,
                                         cancel=decay == "cancel",
                                         slow=decay == "slow")
    (jx, tx), (jb, tb), (jc, tc) = (_both(t, dtype) for t in (xs, bs, cs))
    ref = jssd_scan(jx, jnp.asarray(da), jnp.asarray(dt), jb, jc, chunk=128,
                    interpret=True)
    out = _ssd_tf32_numerics(tx, torch.from_numpy(da), torch.from_numpy(dt),
                             tb, tc, chunk=128)
    _close(out, ref, TOL["ssd"][dtype])


def _tf32_errors(args, chunk):
    """Max abs errors against the float64 result of the split-TF32 model,
    of its one-TF32-product form and of the plain version."""
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    ys = (_ssd_tf32_numerics(*args, chunk=chunk),
          _ssd_tf32_numerics(*args, chunk=chunk, split=False),
          ssd_scan_ref(*args, chunk=chunk))
    return tuple(float((y.double() - exact).abs().max()) for y in ys)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("decay", ["model", "slow", "cancel"])
def test_ssd_tf32_numerics_within_twice_the_plain_error(decay, seed):
    """The split-TF32 model's float64 error is within twice the plain
    version's on the card tests' float32 inputs (the rule the card holds
    the kernel to)."""
    args = [torch.from_numpy(t) for t in _ssd_head_major(
        1, 2, 512, 64, 64, seed, cancel=decay == "cancel",
        slow=decay == "slow")]
    err, _, err_p = _tf32_errors(args, 128)
    assert err <= 2 * err_p, (err, err_p)


@pytest.mark.parametrize("decay", ["model", "slow", "cancel"])
def test_ssd_one_tf32_product_misses_the_float64_rule(decay):
    """One TF32 product a product (TF32's 11 bits) misses twice the plain
    version's float64 error by far: the split is what holds the rule."""
    args = [torch.from_numpy(t) for t in _ssd_head_major(
        1, 2, 512, 64, 64, 0, cancel=decay == "cancel",
        slow=decay == "slow")]
    err, err_one, err_p = _tf32_errors(args, 128)
    assert err <= 2 * err_p < err_one / 10, (err, err_one, err_p)


def test_ssd_tf32_numerics_at_mamba2_layer0():
    """At mamba2-370m's layer-0 shape and decay law (cum ~ -800 within a
    chunk of 256), the split-TF32 model's float64 error is within twice the
    plain version's, and the one-TF32 model's is not."""
    args = _mamba2_layer0_ssd_args(0, 512)
    err, err_one, err_p = _tf32_errors(args, 256)
    print(f"mamba2 layer 0, split TF32: {err:.3e}, one TF32 {err_one:.3e}, "
          f"plain {err_p:.3e}")
    assert err <= 2 * err_p < err_one, (err, err_one, err_p)


def test_ssd_routes_table():
    """float16 rides bf16's routes; float64 and integers still raise."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    for n in (64, 128):
        for chunk in (64, 128, 256):
            assert ssd_ops.route_of(bf16, 64, n, chunk) == "mma_bf16"
            assert ssd_ops.route_of(f16, 64, n, chunk) == "mma_bf16"
            assert ssd_ops.route_of(f32, 64, n, chunk) == "mma_tf32"
    # 16-bit shapes the mma kernel does not take go to the split-TF32 kernel
    for p, n, chunk in ((32, 16, 32), (64, 32, 32), (64, 128, 32),
                        (32, 128, 256), (64, 96, 256), (64, 128, 512)):
        assert ssd_ops.route_of(bf16, p, n, chunk) == "mma_tf32"
        assert ssd_ops.route_of(f16, p, n, chunk) == "mma_tf32"
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(TypeError):
            ssd_ops.route_of(dtype, 64, 128, 256)
    assert ssd_ops.ROUTES == ("mma_bf16", "mma_tf32")
    assert set(ssd_ops.ssd_scan.launches_by_route) == set(ssd_ops.ROUTES)


def test_ssd_scan_cpu_launches_nothing():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch on any route."""
    xs, da, dt, bs, cs = (torch.from_numpy(t) for t in
                          _ssd_head_major(1, 2, 128, 64, 64, 0, False))
    before = (ssd_ops.ssd_scan.launches, dict(ssd_ops.ssd_scan.launches_by_route))
    y = ssd_ops.ssd_scan(xs.bfloat16(), da, dt, bs.bfloat16(), cs.bfloat16(),
                         chunk=64)
    assert y.dtype == torch.float32 and y.shape == xs.shape
    assert (ssd_ops.ssd_scan.launches,
            dict(ssd_ops.ssd_scan.launches_by_route)) == before


def test_rmsnorm_cpu_takes_a_bf16_scale():
    """The CPU leg casts a bf16 scale to float32, as the reference does (the
    CUDA leg casts it before the launch)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    scale = rng.standard_normal(256).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    tscale = torch.from_numpy(scale).to(torch.bfloat16)
    ref = jrmsnorm(jx, jnp.asarray(tscale.float().numpy()).astype(jnp.bfloat16))
    out = rms_ops.rmsnorm(tx, tscale)
    assert out.dtype == torch.bfloat16
    _close(out, ref, TOL["rmsnorm"]["bfloat16"])
    torch.testing.assert_close(out, rms_ops.rmsnorm(tx, tscale.float()))
