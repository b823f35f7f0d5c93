"""Port parity: the ragged engine, its kernel's plain version and its RNG.

The reference draws each step's ``(W, 3 + r)`` uniform block from
``jax.random`` and replaces slot 0 by the flag ``u < p_j``
(``repro/core/engine.py`` ``step``), with per-step keys from
``split(key, T)`` (``run``).  Here those exact blocks are drawn with the
reference and injected into the port, and the port is handed the
reference's own per-edge CDF, so the index math and gathers must agree
bit for bit.  The one float formula that may round differently is the
Lévy distance ``d`` (float32 ``log1p``/``log``); its agreement rate is
measured and asserted separately.
"""
import ast
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import graphs as jg
from repro.core import levy as jlevy
from repro.core import transition as jtr
from repro.kernels.walk_transition.ref import walk_transition_ragged_ref as jref
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import graphs as tg
from repro_torch.core import levy as tlevy
from repro_torch.core import transition as ttr
from repro.kernels.walk_transition import ops as jops
from repro_torch.kernels.walk_transition import kernel as tkernel
from repro_torch.kernels.walk_transition import ops as tops
from repro_torch.kernels.walk_transition.ref import walk_transition_ragged_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _ba_hub(n=400, m=3, seed=0):
    """A BA graph with a hub, its P_IS rows and the reference's CDF
    (cached: the reference builds its CDF eagerly, op by op)."""
    g = jg.barabasi_albert(n, m, seed=seed, layout="ragged")
    lips = np.exp(np.random.default_rng(seed + 1).normal(size=g.n))
    lips[int(np.argmax(g.degrees))] = 60.0
    rows = jtr.mh_importance_rows_ragged(g, lips)
    cdf = np.array(
        jeng.ragged_edge_cdf(g.indptr, g.indices, g.degrees, row_probs=rows)
    )
    return g, lips, rows, cdf


def _ref_blocks(key, num_steps, w, r, p_j):
    """(T, W, 3 + r) blocks exactly as the reference's ``run`` draws them:
    ``split(key, T)``, one uniform draw per key, slot 0 -> ``u < p_j``."""
    keys = jax.random.split(key, num_steps)
    p = jnp.broadcast_to(jnp.asarray(p_j, jnp.float32), (num_steps,))

    def one(k, pj):
        u = jax.random.uniform(k, (w, jeng.num_uniforms(r)), jnp.float32)
        return u.at[:, jeng.U_JUMP].set((u[:, jeng.U_JUMP] < pj).astype(jnp.float32))

    return np.array(jax.vmap(one)(keys, p))


def _d_mismatch(u, p_d, r):
    """Mask of draws whose Lévy distance differs between the packages,
    restricted to the walks that jump (elsewhere d is never used)."""
    d_ref = np.asarray(jlevy.trunc_geom_icdf(jnp.asarray(u[..., 2]), p_d, r))
    d_port = tlevy.trunc_geom_icdf(torch.from_numpy(u[..., 2]), p_d, r).numpy()
    return (d_ref != d_port) & (u[..., 0] > 0.5)


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


# -- the per-edge CDF builder -------------------------------------------------


@pytest.mark.parametrize("source", ["flat", "lipschitz"])
def test_edge_cdf_matches_reference_within_tolerance(source):
    """Within 1e-5 of each row's total; the sum order is PyTorch's, so the
    bits need not match (the bitwise share is printed)."""
    g, lips, rows, _ = _ba_hub()
    kw = dict(row_probs=rows) if source == "flat" else dict(lipschitz=lips)
    ref = np.asarray(jeng.ragged_edge_cdf(g.indptr, g.indices, g.degrees, **kw))
    port = teng.ragged_edge_cdf(
        g.indptr, g.indices, g.degrees, device="cpu", **kw
    ).numpy()
    totals = np.repeat(ref[g.indptr[1:] - 1], g.degrees)
    assert np.all(np.abs(port - ref) <= 1e-5 * totals)
    print(f"CDF bitwise share ({source}): {(port == ref).mean():.4f}")


def test_edge_cdf_chunking_and_width(monkeypatch):
    """The CDF does not depend on how rows are chunked, every row is
    materialized whole (its last entry is the row's total), and a missing
    row source raises."""
    g, lips, rows, _ = _ba_hub()
    base = teng.ragged_edge_cdf(
        g.indptr, g.indices, g.degrees, row_probs=rows, device="cpu"
    )
    monkeypatch.setattr(
        teng, "_ragged_row_chunks",
        lambda n, max_deg: tg._ragged_row_chunks(n, max_deg, 50),
    )
    chunked = teng.ragged_edge_cdf(
        g.indptr, g.indices, g.degrees, row_probs=rows, device="cpu"
    )
    torch.testing.assert_close(chunked, base, rtol=0, atol=1e-6)
    totals = np.add.reduceat(rows.astype(np.float64), g.indptr[:-1])
    np.testing.assert_allclose(
        base.numpy()[g.indptr[1:] - 1], totals, rtol=0, atol=1e-5
    )
    with pytest.raises(ValueError):
        teng.ragged_edge_cdf(g.indptr, g.indices, g.degrees, device="cpu")


# -- the kernel's plain version -------------------------------------------------


@pytest.mark.parametrize(
    "w,r,p_j", [(1, 3, 0.3), (257, 1, 0.5), (257, 3, 0.3), (1024, 5, 0.6)]
)
def test_plain_kernel_bitwise_vs_reference(w, r, p_j):
    g, _, _, cdf = _ba_hub()
    p_d = 0.4
    rng = np.random.default_rng(w * 10 + r)
    nodes = rng.integers(0, g.n, w).astype(np.int32)
    hub = int(np.argmax(g.degrees))
    nodes[: max(1, w // 8)] = hub  # many walks on the hub's long segment
    u = _ref_blocks(jax.random.PRNGKey(w + r), 1, w, r, p_j)[0]
    max_deg = int(g.degrees.max())
    nxt_ref, hops_ref = jax.jit(
        jref, static_argnames=("p_d", "r", "max_degree")
    )(
        jnp.asarray(nodes), jnp.asarray(g.indptr, jnp.int32),
        jnp.asarray(g.degrees), jnp.asarray(g.indices), jnp.asarray(cdf),
        jnp.asarray(u), p_d=p_d, r=r, max_degree=max_deg,
    )
    nxt, hops = walk_transition_ragged_ref(
        _t(nodes), _t(g.indptr), _t(g.degrees), _t(g.indices),
        torch.from_numpy(cdf), torch.from_numpy(u),
        p_d=p_d, r=r, max_degree=max_deg,
    )
    ok = ~_d_mismatch(u, p_d, r)
    np.testing.assert_array_equal(nxt.numpy()[ok], np.asarray(nxt_ref)[ok])
    np.testing.assert_array_equal(hops.numpy()[ok], np.asarray(hops_ref)[ok])
    assert nxt.dtype == hops.dtype == torch.int32
    # the wrapper runs exactly this on CPU tensors, and launches nothing
    before = tkernel.walk_transition_ragged.launches
    nxt_w, hops_w = tkernel.walk_transition_ragged(
        _t(nodes), _t(g.indptr), _t(g.degrees), _t(g.indices),
        torch.from_numpy(cdf), torch.from_numpy(u),
        p_d=p_d, r=r, max_degree=max_deg,
    )
    assert torch.equal(nxt_w, nxt) and torch.equal(hops_w, hops)
    assert tkernel.walk_transition_ragged.launches == before


@pytest.mark.parametrize(
    "p_d,r", [(0.5, 3), (0.1, 10), (0.3, 5), (0.5, 1), (0.05, 16)]
)
def test_levy_distance_agreement_rate(p_d, r):
    """float32 ``log1p``/``log`` may round one ulp apart between XLA and
    PyTorch; over 10^6 draws d must agree in at least 1 - 1e-5 of them."""
    u = np.random.default_rng(int(p_d * 1000) + r).random(
        1_000_000, dtype=np.float32
    )
    d_ref = np.asarray(jlevy.trunc_geom_icdf(jnp.asarray(u), p_d, r))
    d_port = tlevy.trunc_geom_icdf(torch.from_numpy(u), p_d, r).numpy()
    assert d_port.dtype == np.int32
    assert d_port.min() >= 1 and d_port.max() <= r
    rate = float((d_ref != d_port).mean())
    print(f"d mismatch rate p_d={p_d} r={r}: {rate:.2e}")
    assert rate <= 1e-5


# -- the engine ---------------------------------------------------------------


@pytest.mark.parametrize(
    "graph_kind,w,r,p_j",
    [("ba", 64, 5, 0.3), ("ring", 16, 1, 0.4),
     ("dumbbell", 20, 3, "schedule")],
)
def test_engine_run_bitwise_vs_scan(graph_kind, w, r, p_j):
    if graph_kind == "ba":
        g, lips, rows, _ = _ba_hub()
    else:
        g = (
            jg.ring(50, layout="ragged") if graph_kind == "ring"
            else jg.dumbbell(10, 4, layout="ragged")
        )
        lips = np.linspace(1.0, 9.0, g.n)
        rows = jtr.mh_importance_rows_ragged(g, lips)
    num_steps = 40
    if p_j == "schedule":
        p_j = np.linspace(0.9, 0.0, num_steps).astype(np.float32)
    params = jtr.MHLJParams(0.0, 0.5, r)
    ref_eng = jeng.WalkEngine.from_graph(
        g, params, row_probs=rows, backend="scan", layout="ragged"
    )
    v0s = np.arange(w, dtype=np.int32) * 7 % g.n
    key = jax.random.PRNGKey(21)
    nodes_ref, hops_ref = ref_eng.run(key, jnp.asarray(v0s), num_steps, p_j=p_j)
    blocks = _ref_blocks(key, num_steps, w, r, p_j)
    eng, _, _ = interop.from_reference_state(
        indptr=np.asarray(ref_eng.indptr), indices=np.asarray(ref_eng.indices),
        degrees=np.asarray(ref_eng.degrees),
        edge_cdf=np.asarray(ref_eng.edge_cdf),
        max_degree=ref_eng.max_degree, cdf_width=ref_eng.cdf_width,
        p_d=ref_eng.p_d, r=ref_eng.r, device="cpu",
    )
    nodes, hops = eng.run(torch.from_numpy(v0s), num_steps,
                          uniforms=torch.from_numpy(blocks))
    assert nodes.shape == hops.shape == (w, num_steps)
    # compare up to (and including) the first step where a jumping walk's
    # d differs between the packages; after it trajectories may diverge
    bad = np.nonzero(_d_mismatch(blocks, 0.5, r).any(axis=1))[0]
    upto = int(bad[0]) if bad.size else num_steps
    np.testing.assert_array_equal(
        nodes.numpy()[:, : upto + 1 if bad.size else upto],
        np.asarray(nodes_ref)[:, : upto + 1 if bad.size else upto],
    )
    np.testing.assert_array_equal(
        hops.numpy()[:, :upto], np.asarray(hops_ref)[:, :upto]
    )


def test_engine_from_graph_matches_reference_cdf_build():
    """``from_graph`` on the port builds its own CDF; its walks equal the
    reference's wherever the two CDFs do not straddle a search target."""
    g_ref = jg.ring(30, layout="ragged")
    g_port = tg.ring(30, layout="ragged")
    rows = ttr.mh_uniform_rows_ragged(g_port)
    params = ttr.MHLJParams(0.3, 0.5, 2)
    eng = teng.WalkEngine.from_graph(g_port, params, row_probs=rows, device="cpu")
    ref_eng = jeng.WalkEngine.from_graph(
        g_ref, jtr.MHLJParams(0.3, 0.5, 2), row_probs=rows, backend="scan"
    )
    assert eng.max_degree == ref_eng.max_degree == 3
    assert ref_eng.cdf_width == eng.max_degree  # the port builds at max degree
    for name in ("indptr", "indices", "degrees"):
        np.testing.assert_array_equal(
            getattr(eng, name).numpy(), np.asarray(getattr(ref_eng, name))
        )
    # a ring's rows are 1/3 each: the CDF prefixes are exact sums here
    np.testing.assert_array_equal(eng.edge_cdf.numpy(),
                                  np.asarray(ref_eng.edge_cdf))
    key = jax.random.PRNGKey(5)
    v0s = np.arange(12, dtype=np.int32)
    nodes_ref, hops_ref = ref_eng.run(key, jnp.asarray(v0s), 20)
    blocks = _ref_blocks(key, 20, 12, 2, 0.3)
    nodes, hops = eng.run(torch.from_numpy(v0s), 20,
                          uniforms=torch.from_numpy(blocks))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(nodes_ref))
    np.testing.assert_array_equal(hops.numpy(), np.asarray(hops_ref))


def test_engine_step_validates_inputs():
    g = tg.ring(20, layout="ragged")
    eng = teng.WalkEngine.from_graph(
        g, ttr.MHLJParams(0.1, 0.5, 3), row_probs=ttr.simple_rw_rows_ragged(g),
        device="cpu",
    )
    nodes = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="uniforms= .* or generator="):
        eng.step(nodes)
    with pytest.raises(ValueError, match="shape"):
        eng.step(nodes, uniforms=torch.zeros(4, 5))
    with pytest.raises(ValueError, match="row_probs or lipschitz"):
        teng.WalkEngine.from_graph(g, ttr.MHLJParams(), device="cpu")
    gen = torch.Generator().manual_seed(0)
    nxt, hops = eng.step(nodes, generator=gen, p_j=0.0)
    assert int(hops.max()) == 1
    nxt, hops = eng.step(nodes, generator=gen, p_j=1.0)
    assert int(hops.min()) >= 1 and int(hops.max()) <= 3
    _, hops_t = eng.run(nodes, 50, generator=gen,
                        p_j=torch.linspace(1.0, 0.0, 50))
    assert hops_t[:, -10:].max() == 1  # the schedule reaches p_J ~ 0


@pytest.mark.parametrize("layout", ["ragged", "sparse", "dense"])
def test_scalar_node_step_and_run_match_reference(layout):
    """A 0-d node gives 0-d outputs, as the reference's ``step`` and ``run``
    squeeze a scalar node (``repro/core/engine.py`` ``step``, ``run``);
    the values equal the reference's under its own uniforms."""
    g = jg.ring(40, layout="ragged" if layout == "ragged" else "csr")
    g_port = tg.ring(40, layout="ragged" if layout == "ragged" else "csr")
    lips = np.linspace(1.0, 5.0, g.n)
    params = jtr.MHLJParams(0.5, 0.5, 3)
    ref_eng = jeng.WalkEngine.from_graph(g, params, lipschitz=lips,
                                         backend="scan", layout=layout)
    eng = teng.WalkEngine.from_graph(
        g_port, ttr.MHLJParams(0.5, 0.5, 3), lipschitz=lips, layout=layout,
        device="cpu",
    )
    key = jax.random.PRNGKey(8)
    nxt_ref, hops_ref = ref_eng.step(key, jnp.int32(7))
    assert np.shape(nxt_ref) == np.shape(hops_ref) == ()
    # step(key) draws (1, 3 + r) from key itself: run's per-step block
    # without the split
    u = np.array(jax.random.uniform(key, (1, jeng.num_uniforms(3)), jnp.float32))
    u[:, 0] = (u[:, 0] < 0.5).astype(np.float32)
    for block in (u, u[0]):  # (1, 3 + r) or (3 + r,)
        nxt, hops = eng.step(torch.tensor(7, dtype=torch.int32),
                             uniforms=torch.from_numpy(block))
        assert nxt.shape == hops.shape == ()
        assert int(nxt) == int(nxt_ref) and int(hops) == int(hops_ref)
    nodes_ref, hops_t_ref = ref_eng.run(key, jnp.int32(3), 30)
    assert np.shape(nodes_ref) == (30,)
    blocks = _ref_blocks(key, 30, 1, 3, 0.5)
    assert not _d_mismatch(blocks, 0.5, 3).any()
    nodes, hops_t = eng.run(torch.tensor(3), 30,
                            uniforms=torch.from_numpy(blocks[:, 0]))
    assert nodes.shape == hops_t.shape == (30,)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(nodes_ref))
    np.testing.assert_array_equal(hops_t.numpy(), np.asarray(hops_t_ref))


def test_run_overflow_vector_matches_reference_scan():
    """The compacted bucketed engine's ``run`` under a capacity that some
    steps overflow: walks, hops and the (T,) ``compact_overflow`` vector
    (a device tensor, decided on the device) against the reference's
    ``run(..., with_aux=True)`` on the reference's blocks (its
    ``split(key, T)``), on an SBM whose rows stay <= 17 wide."""
    params = (0.3, 0.5, 3)
    g_ref = jg.sbm([40] * 3, 0.2, 0.01, seed=0, layout="csr")
    g = tg.sbm([40] * 3, 0.2, 0.01, seed=0, layout="csr")
    lips = np.exp(np.random.default_rng(1).normal(size=g.n))
    rows = ttr.mh_importance_rows(g, lips)
    kw = dict(layout="bucketed", compact=True, capacity_factor=1.0)
    ref = jeng.WalkEngine.from_graph(g_ref, jtr.MHLJParams(*params),
                                     row_probs=jnp.asarray(rows),
                                     backend="scan", **kw)
    eng = teng.WalkEngine.from_graph(g, ttr.MHLJParams(*params),
                                     row_probs=rows, device="cpu", **kw)
    w, steps = 96, 40
    v0s = (np.arange(w) * 7 % g.n).astype(np.int32)
    key = jax.random.PRNGKey(3)
    nodes_ref, hops_ref, aux_ref = ref.run(key, jnp.asarray(v0s), steps,
                                           with_aux=True)
    over_ref = np.asarray(aux_ref["compact_overflow"])
    assert over_ref.any() and not over_ref.all()
    blocks = _ref_blocks(key, steps, w, 3, params[0])
    assert not _d_mismatch(blocks, 0.5, 3).any()
    nodes, hops, aux = eng.run(torch.from_numpy(v0s), steps,
                               uniforms=torch.from_numpy(blocks),
                               with_aux=True)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(nodes_ref))
    np.testing.assert_array_equal(hops.numpy(), np.asarray(hops_ref))
    over = aux["compact_overflow"]
    assert over.dtype == torch.bool and over.device == eng.device
    np.testing.assert_array_equal(over.numpy(), over_ref)


MHLJ_STEP_GRAPHS = {
    "ring": lambda m: m.ring(16),
    "grid2d": lambda m: m.grid2d(6, 6),
    "ba": lambda m: m.barabasi_albert(40, 2, seed=1),  # rows <= 17 wide
}


@pytest.mark.parametrize("graph", sorted(MHLJ_STEP_GRAPHS))
def test_mhlj_step_views_match_reference(graph):
    """Every ``mhlj_step_*`` view of the port on the reference's block
    equals the reference's ``mhlj_step_oracle`` on its key, bit for bit
    (as ``tests/test_kernels.py`` holds the reference's views), and a
    view of the wrong engine raises."""
    g_ref, g = MHLJ_STEP_GRAPHS[graph](jg), MHLJ_STEP_GRAPHS[graph](tg)
    lips = np.ones(g.n)
    lips[g.n // 2] = 40.0
    rows = ttr.row_probs_padded(ttr.mh_importance(g, lips), g)
    np.testing.assert_array_equal(
        rows, jtr.row_probs_padded(jtr.mh_importance(g_ref, lips), g_ref))
    p = dict(p_j=0.2, p_d=0.5, r=3)
    w = 48
    nodes = (np.arange(w) % g.n).astype(np.int32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jops.mhlj_step_oracle(
        key, jnp.asarray(nodes), jnp.asarray(rows, jnp.float32),
        jnp.asarray(g_ref.neighbors), jnp.asarray(g_ref.degrees), **p))
    u = np.array(jax.random.uniform(key, (w, 6), jnp.float32))
    u[:, 0] = (u[:, 0] < np.float32(0.2)).astype(np.float32)
    assert not _d_mismatch(u, 0.5, 3).any()
    u = torch.from_numpy(u)
    tables = (_t(nodes), torch.from_numpy(rows.astype(np.float32)),
              _t(g.neighbors), _t(g.degrees))
    params = ttr.MHLJParams(0.2, 0.5, 3)
    bucketed = teng.WalkEngine.from_graph(g.to_csr().to_bucketed(), params,
                                          row_probs=rows, device="cpu")
    ragged = teng.WalkEngine.from_graph(g, params, row_probs=rows,
                                        layout="ragged", device="cpu")
    got = {
        "batched": tops.mhlj_step_batched(*tables, **p, uniforms=u),
        "sparse": tops.mhlj_step_sparse(*tables, **p, uniforms=u),
        "dense": tops.mhlj_step_dense(*tables, **p, uniforms=u),
        "bucketed": tops.mhlj_step_bucketed(tables[0], bucketed, uniforms=u),
        "ragged": tops.mhlj_step_ragged(tables[0], ragged, uniforms=u),
        "oracle": tops.mhlj_step_oracle(*tables, **p, uniforms=u),
    }
    for name, nxt in got.items():
        np.testing.assert_array_equal(nxt.numpy(), want, err_msg=name)
    # a generator draws the block the engine's step draws
    gen_a, gen_b = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(tops.mhlj_step_oracle(*tables, **p, generator=gen_a),
                       tops.mhlj_step_sparse(*tables, **p, generator=gen_b))
    with pytest.raises(ValueError, match="bucketed"):
        tops.mhlj_step_bucketed(tables[0], ragged, uniforms=u)
    with pytest.raises(ValueError, match="ragged"):
        tops.mhlj_step_ragged(tables[0], bucketed, uniforms=u)


def _chi_square_stat(counts, probs, min_expected=10.0):
    total = counts.sum()
    expected = probs * total
    big = expected >= min_expected
    obs = np.concatenate([counts[big], [counts[~big].sum()]])
    exp = np.concatenate([expected[big], [expected[~big].sum()]])
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    return float(((obs - exp) ** 2 / exp).sum()), len(obs) - 1


@pytest.mark.parametrize("start", ["hub", "leaf"])
def test_port_rng_one_step_law_matches_dense_chain(start):
    """The port's own ``torch.Generator`` draws realize the MHLJ law: the
    one-step distribution from a node against the row of the reference's
    dense chain (chained Lévy), by chi-square at ~4 sigma and by TV."""
    n = 60
    g_dense = jg.barabasi_albert(n, 2, seed=3)
    g = tg.barabasi_albert(n, 2, seed=3, layout="ragged")
    lips = np.ones(n)
    lips[7] = 40.0
    params = ttr.MHLJParams(0.3, 0.5, 3)
    v = int(np.argmax(g.degrees)) if start == "hub" else int(np.argmin(g.degrees))
    expected = jtr.mhlj(g_dense, lips, jtr.MHLJParams(0.3, 0.5, 3),
                        chained_levy=True)[v]
    eng = teng.WalkEngine.from_graph(
        g, params, row_probs=ttr.mh_importance_rows_ragged(g, lips),
        device="cpu",
    )
    w = 100_000
    gen = torch.Generator().manual_seed(17)
    nxt, hops = eng.step(torch.full((w,), v, dtype=torch.int32), generator=gen)
    counts = np.bincount(nxt.numpy(), minlength=n).astype(np.float64)
    stat, dof = _chi_square_stat(counts, expected)
    assert stat < dof + 4.0 * np.sqrt(2.0 * dof), (stat, dof)
    tv = 0.5 * np.abs(counts / w - expected).sum()
    assert tv < 0.02, tv
    # Remark 1: mean hops per update
    exact = tlevy.expected_transitions_per_update(0.3, 0.5, 3)
    assert abs(float(hops.double().mean()) - exact) < 0.02


# -- no fallback, no JAX --------------------------------------------------------


def test_wrapper_rejects_mixed_devices_and_meta():
    g = tg.ring(10, layout="ragged")
    eng = teng.WalkEngine.from_graph(
        g, ttr.MHLJParams(), row_probs=ttr.simple_rw_rows_ragged(g),
        device="cpu",
    )
    u = torch.rand(4, 6)
    with pytest.raises(ValueError, match="one device"):
        tkernel.walk_transition_ragged(
            torch.zeros(4, dtype=torch.int32, device="meta"), eng.indptr,
            eng.degrees, eng.indices, eng.edge_cdf, u, p_d=0.5, r=3,
            max_degree=3,
        )


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    examples = os.path.join(REPO, "examples", "torch")
    for f in sorted(os.listdir(examples)):
        if f.endswith(".py"):
            yield os.path.join(examples, f)


def test_port_sources_import_no_jax_or_reference():
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "for info in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "expected = {'repro_torch.configs', 'repro_torch.configs.minitron_8b',\n"
        "            'repro_torch.models.factory', 'repro_torch.models.transformer',\n"
        "            'repro_torch.models.mamba_model', 'repro_torch.models.layers.attention',\n"
        "            'repro_torch.models.layers.mamba2', 'repro_torch.models.layers.embedding',\n"
        "            'repro_torch.kernels.flash_attention.ops', 'repro_torch.kernels.ssd.ops',\n"
        "            'repro_torch.kernels.rmsnorm.ops', 'repro_torch.launch.serve',\n"
        "            'repro_torch.paper.serve_throughput', 'repro_torch.interop'}\n"
        "assert expected <= set(sys.modules), expected - set(sys.modules)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import glob\n"
        "for path in sorted(glob.glob('examples/torch/*.py')):\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import torch.distributed as dist\n"
        "assert not (dist.is_available() and dist.is_initialized())\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in sys.modules\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
