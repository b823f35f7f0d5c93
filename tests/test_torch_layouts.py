"""Port parity: the sparse, dense and bucketed engine layouts.

The port's row-CDF rule is a sequential, left-to-right float32
accumulation along each row (``engine.row_cdf``); the reference inverts
``jnp.cumsum`` rows, whose XLA order on the CPU is sequential only for
short rows.  So the port is held bit for bit against the reference where
rows are at most 17 wide (ring, grid2d, dumbbell, a sparse SBM), and at a
measured, printed pick-mismatch rate on the hub rows of a BA graph.  The
Lévy branch, the hop counts, the bucket merge and the compaction are
integer index math and are held bit for bit everywhere; walks whose Lévy
distance ``d`` rounds differently in the two packages' float32 ``log1p``
are left out of a comparison (their rate is measured in
``test_torch_engine.py``).  The uniform blocks are drawn with the
reference exactly as its ``step``/``run``/fleet draw them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import graphs as jg
from repro.core import levy as jlevy
from repro.core import transition as jtr
from repro.data import make_heterogeneous_regression as j_data
from repro.kernels.walk_transition import kernel as jkernel
from repro.kernels.walk_transition import ref as jref
from repro.walk_sgd import run_rw_sgd as j_run
from repro.walk_sgd import run_rw_sgd_multi as j_run_multi
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import graphs as tg
from repro_torch.core import levy as tlevy
from repro_torch.core import transition as ttr
from repro_torch.data import make_heterogeneous_regression as t_data
from repro_torch.kernels.walk_transition import kernel as tkernel
from repro_torch.kernels.walk_transition import ref as tref
from repro_torch.walk_sgd import run_rw_sgd, run_rw_sgd_multi

# Pick-mismatch bound on hub rows (widths 61 here): a pick differs only
# when u·total falls between two CDF values that round differently in the
# two orders, a gap of a few ulps of the row total.
HUB_MISMATCH_BOUND = 1e-3

NARROW = [
    ("ring", lambda m, layout="csr": m.ring(64, layout=layout)),
    ("grid2d", lambda m, layout="csr": m.grid2d(8, 8, layout=layout)),
    ("dumbbell", lambda m, layout="csr": m.dumbbell(12, 3, layout=layout)),
    ("sbm", lambda m, layout="csr": m.sbm([40] * 3, 0.2, 0.01, seed=0,
                                          layout=layout)),
]
NARROW_IDS = [x[0] for x in NARROW]


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _lips(n, seed=1):
    lips = np.exp(np.random.default_rng(seed).normal(size=n))
    lips[n // 5] = 30.0  # a trap node
    return lips


@functools.lru_cache(maxsize=None)
def _ba_hub():
    """BA(400,3) as CSR in both packages, Lipschitz constants with a trap
    at the hub, and the padded P_IS rows (numpy, identical in both)."""
    g_ref = jg.barabasi_albert(400, 3, seed=0, layout="csr")
    g = tg.barabasi_albert(400, 3, seed=0, layout="csr")
    lips = _lips(g.n)
    lips[int(np.argmax(g.degrees))] = 60.0
    return g_ref, g, lips, ttr.mh_importance_rows(g, lips)


def _block(key, w, r, p_j):
    """The (W, 3 + r) block the reference's ``step`` draws from ``key``."""
    u = jax.random.uniform(key, (w, jeng.num_uniforms(r)), jnp.float32)
    return np.array(u.at[:, 0].set((u[:, 0] < p_j).astype(jnp.float32)))


def _fleet_blocks(seed, total, w, r, p_j_sched):
    """Blocks as the reference fleet draws them: ``split(key, total)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), total)
    return np.stack([_block(k, w, r, float(p))
                     for k, p in zip(keys, np.asarray(p_j_sched, np.float32))])


def _d_ok(u, p_d, r):
    """Walks whose Lévy distance rounds the same in both packages (or that
    do not jump)."""
    d_ref = np.asarray(jlevy.trunc_geom_icdf(jnp.asarray(u[..., 2]), p_d, r))
    d_port = tlevy.trunc_geom_icdf(torch.from_numpy(u[..., 2]), p_d, r).numpy()
    return ~((d_ref != d_port) & (u[..., 0] > 0.5))


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _port_engine(g, rows, params, layout, **kw):
    """Port engine of ``layout`` from the padded numpy rows of ``g``."""
    if layout == "ragged":
        rows = tg.flat_edge_values(g.indptr, g.degrees, rows)
    return teng.WalkEngine.from_graph(
        g, params, row_probs=rows, layout=layout, device="cpu", **kw
    )


def _from_reference(e):
    """A port engine over a reference engine's own fields (interop)."""
    def a(x):
        return None if x is None else np.asarray(x)

    return interop.from_reference_state(
        layout=e.layout, degrees=a(e.degrees), p_j=float(e.p_j), p_d=e.p_d,
        r=e.r, indptr=a(e.indptr), indices=a(e.indices),
        edge_cdf=a(e.edge_cdf), max_degree=e.max_degree,
        cdf_width=e.cdf_width, neighbors=a(e.neighbors),
        row_probs=a(e.row_probs), node_bucket=a(e.node_bucket),
        node_slot=a(e.node_slot),
        bucket_neighbors=None if e.bucket_neighbors is None
        else [a(b) for b in e.bucket_neighbors],
        bucket_rows=None if e.bucket_rows is None
        else [a(b) for b in e.bucket_rows],
        bucket_share=e.bucket_share, compact=e.compact,
        capacity_factor=e.capacity_factor, device="cpu",
    )[0]


# -- the row-CDF rule -----------------------------------------------------------


def test_row_cdf_is_sequential_and_width_independent():
    rng = np.random.default_rng(0)
    rows = rng.random((50, 37), dtype=np.float32)
    rows[:, 30:] = 0.0
    seq = np.zeros_like(rows)
    acc = np.zeros(50, np.float32)
    for j in range(rows.shape[1]):
        acc = (acc + rows[:, j]).astype(np.float32)
        seq[:, j] = acc
    cdf = teng.row_cdf(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(cdf, seq)
    # the trailing zero columns change no prefix: width does not matter
    np.testing.assert_array_equal(
        teng.row_cdf(torch.from_numpy(rows[:, :30])).numpy(), seq[:, :30]
    )
    np.testing.assert_array_equal(
        teng.row_cdf(torch.from_numpy(np.pad(rows, ((0, 0), (0, 9))))).numpy()[
            :, :37
        ],
        seq,
    )
    assert teng.row_cdf(torch.zeros(0, 4)).shape == (0, 4)


@pytest.mark.parametrize("width", [2, 8, 13, 16, 17, 31, 1196])
def test_xla_cumsum_order_against_the_rule(width):
    """Re-checks the finding the rule is built on: XLA's CPU ``cumsum``
    equals the sequential float32 sum for rows up to 17 wide; wider rows
    differ (the equal share is printed)."""
    rows = np.random.default_rng(width).random((2048, width), dtype=np.float32)
    xla = np.asarray(jnp.cumsum(jnp.asarray(rows), axis=1))
    port = teng.row_cdf(torch.from_numpy(rows)).numpy()
    share = float((xla == port).mean())
    print(f"width {width}: XLA cumsum == sequential on {share:.4f} of entries")
    if width <= 17:
        assert share == 1.0
    else:
        assert share > 0.0


# -- the sparse tile kernel's plain version -------------------------------------


def _tile_inputs(g, rows, w, seed, hub_share=0.125):
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, g.n, w)
    nodes[: int(w * hub_share)] = int(np.argmax(g.degrees))
    u = rng.random(w, dtype=np.float32)
    return (np.ascontiguousarray(rows[nodes]),
            np.ascontiguousarray(g.neighbors[nodes]).astype(np.int32), u)


@pytest.mark.parametrize("gr", NARROW, ids=NARROW_IDS)
def test_sparse_plain_bitwise_vs_reference_pallas(gr):
    """Where rows are at most 17 wide the plain version equals the
    reference's Pallas tile kernel (interpret mode) and its
    ``mh_cdf_invert`` bit for bit; the wrapper on CPU tensors is the plain
    version and launches nothing."""
    g = gr[1](tg)
    assert g.max_degree <= 17
    rows = ttr.mh_importance_rows(g, _lips(g.n))
    t_rows, t_nbrs, u = _tile_inputs(g, rows, 300, 3)
    pallas = np.asarray(jkernel.walk_transition_sparse(
        jnp.asarray(t_rows), jnp.asarray(t_nbrs), jnp.asarray(u),
        block_w=128, interpret=True,
    ))
    oracle = np.asarray(jref.walk_transition_sparse_ref(
        jnp.asarray(t_rows), jnp.asarray(t_nbrs), jnp.asarray(u)
    ))
    before = tkernel.walk_transition_sparse.launches
    port = tkernel.walk_transition_sparse(
        torch.from_numpy(t_rows), torch.from_numpy(t_nbrs), torch.from_numpy(u)
    )
    assert tkernel.walk_transition_sparse.launches == before
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), pallas)
    np.testing.assert_array_equal(port.numpy(), oracle)


def test_sparse_plain_hub_mismatch_rate():
    """On the BA hub rows (width 61) the two CDF orders may straddle a
    pick: over 1.2 x 10^5 picks the mismatch rate against the reference's
    ``mh_cdf_invert`` stays under the bound (printed), and a slice of them
    agrees with the reference's Pallas kernel as its oracle does."""
    _, g, lips, rows = _ba_hub()
    picks, bad = 0, 0
    for seed in range(4):
        rows_s = ttr.mh_uniform_rows(g) if seed % 2 else rows
        t_rows, t_nbrs, u = _tile_inputs(g, rows_s, 30_000, seed, 0.5)
        ref = np.asarray(jeng.mh_cdf_invert(
            jnp.asarray(t_rows), jnp.asarray(t_nbrs), jnp.asarray(u)
        ))
        port = tref.walk_transition_sparse_ref(
            torch.from_numpy(t_rows), torch.from_numpy(t_nbrs),
            torch.from_numpy(u),
        ).numpy()
        picks += u.size
        bad += int((ref != port).sum())
        if seed == 0:
            pallas = np.asarray(jkernel.walk_transition_sparse(
                jnp.asarray(t_rows[:1024]), jnp.asarray(t_nbrs[:1024]),
                jnp.asarray(u[:1024]), block_w=256, interpret=True,
            ))
            np.testing.assert_array_equal(pallas, ref[:1024])
    rate = bad / picks
    print(f"sparse hub pick mismatch: {bad} of {picks} ({rate:.2e})")
    assert picks >= 100_000
    assert rate <= HUB_MISMATCH_BOUND


# -- the dense kernel's plain version ------------------------------------------


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("gr", NARROW + [("ba", None)],
                         ids=NARROW_IDS + ["ba_hub"])
def test_dense_plain_vs_reference_ref(gr, r):
    """``walk_transition`` on CPU tensors (its plain version) against the
    reference's ``ref.walk_transition_ref``: bit for bit on narrow rows,
    at the stated mismatch bound on the BA hub graph."""
    if gr[1] is None:
        _, g, lips, rows = _ba_hub()
    else:
        g = gr[1](tg)
        rows = ttr.mh_importance_rows(g, _lips(g.n))
    w, p_d = 257, 0.4
    rng = np.random.default_rng(r)
    nodes = rng.integers(0, g.n, w).astype(np.int32)
    nodes[:32] = int(np.argmax(g.degrees))
    u = _block(jax.random.PRNGKey(r), w, r, 0.4)
    ref_n, ref_h = jref.walk_transition_ref(
        jnp.asarray(nodes), jnp.asarray(rows), jnp.asarray(g.neighbors),
        jnp.asarray(g.degrees), jnp.asarray(u), p_d=p_d, r=r,
    )
    before = tkernel.walk_transition.launches
    nxt, hops = tkernel.walk_transition(
        _t(nodes), torch.from_numpy(rows), _t(g.neighbors), _t(g.degrees),
        torch.from_numpy(u), p_d=p_d, r=r,
    )
    assert tkernel.walk_transition.launches == before
    ok = _d_ok(u, p_d, r)
    np.testing.assert_array_equal(hops.numpy()[ok], np.asarray(ref_h)[ok])
    diff = (nxt.numpy() != np.asarray(ref_n)) & ok
    jump = u[:, 0] > 0.5
    assert not (diff & jump).any()  # the Lévy branch is bitwise everywhere
    if gr[1] is None:
        print(f"dense hub MH mismatch: {int(diff.sum())} of {w}")
        assert diff.mean() <= HUB_MISMATCH_BOUND
    else:
        assert not diff.any()


# -- engines against the reference's scan backend ------------------------------


def _ref_engine(g_ref, rows, params, layout, **kw):
    rp = rows if layout == "bucketed" and isinstance(rows, tuple) else (
        jnp.asarray(rows))
    return jeng.WalkEngine.from_graph(
        g_ref, params, row_probs=rp, backend="scan", layout=layout, **kw
    )


LAYOUT_CASES = [
    ("sparse", {}),
    ("dense", {}),
    ("bucketed", {"compact": True}),
    ("bucketed_full", {"compact": False}),
    ("ragged", {}),
]


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
@pytest.mark.parametrize("gr", NARROW, ids=NARROW_IDS)
def test_engine_step_bitwise_vs_reference_scan(gr, case):
    """One step of every port layout, built by the port from the shared
    numpy rows, against the reference's scan engine of the same layout on
    the same key, at W values that are not block multiples."""
    name, kw = case
    layout = name.split("_")[0]
    g_ref, g = gr[1](jg), gr[1](tg)
    rows = ttr.mh_importance_rows(g, _lips(g.n))
    params = ttr.MHLJParams(0.3, 0.5, 3)
    eng = _port_engine(g, rows, params, layout, **kw)
    ref_rows = (tg.flat_edge_values(g.indptr, g.degrees, rows)
                if layout == "ragged" else rows)
    ref = _ref_engine(g_ref, ref_rows, jtr.MHLJParams(0.3, 0.5, 3), layout,
                      **kw)
    for w, seed in ((37, 0), (300, 1)):
        key = jax.random.PRNGKey(seed)
        nodes = (np.arange(w) * 5 % g.n).astype(np.int32)
        ref_n, ref_h = ref.step(key, jnp.asarray(nodes))
        u = _block(key, w, 3, 0.3)
        nxt, hops = eng.step(_t(nodes), uniforms=torch.from_numpy(u))
        ok = _d_ok(u, 0.5, 3)
        np.testing.assert_array_equal(nxt.numpy()[ok], np.asarray(ref_n)[ok])
        np.testing.assert_array_equal(hops.numpy()[ok], np.asarray(ref_h)[ok])


@pytest.mark.parametrize("case", LAYOUT_CASES[:4],
                         ids=[c[0] for c in LAYOUT_CASES[:4]])
def test_engine_run_bitwise_vs_reference_scan(case):
    """Whole trajectories (``run``, p_J schedule) on the dumbbell and the
    SBM, against the reference's scan ``run`` on the same key."""
    name, kw = case
    layout = name.split("_")[0]
    params = ttr.MHLJParams(0.0, 0.5, 3)
    steps = 40
    sched = np.linspace(0.6, 0.0, steps).astype(np.float32)
    for build in (NARROW[2][1], NARROW[3][1]):
        g_ref, g = build(jg), build(tg)
        rows = ttr.mh_importance_rows(g, _lips(g.n, 2))
        eng = _port_engine(g, rows, params, layout, **kw)
        ref = _ref_engine(g_ref, rows, jtr.MHLJParams(0.0, 0.5, 3), layout,
                          **kw)
        v0s = (np.arange(24) * 7 % g.n).astype(np.int32)
        key = jax.random.PRNGKey(9)
        ref_n, ref_h = ref.run(key, jnp.asarray(v0s), steps, p_j=sched)
        # the reference's run: one key per step, each draw's flag u < p_j[t]
        keys = jax.random.split(key, steps)
        blocks = np.stack([_block(k, 24, 3, float(p))
                           for k, p in zip(keys, sched)])
        assert _d_ok(blocks, 0.5, 3).all()
        nodes, hops, aux = eng.run(_t(v0s), steps,
                                   uniforms=torch.from_numpy(blocks),
                                   with_aux=True)
        np.testing.assert_array_equal(nodes.numpy(), np.asarray(ref_n))
        np.testing.assert_array_equal(hops.numpy(), np.asarray(ref_h))
        assert aux["compact_overflow"].shape == (steps,)


@pytest.mark.parametrize("layout", ["sparse", "dense", "bucketed", "ragged"])
def test_interop_engine_steps_like_the_reference(layout):
    """A port engine rebuilt from a reference engine's own fields (interop)
    steps exactly as the reference does on the same key."""
    build = NARROW[2][1]
    g_ref = build(jg)
    rows = jtr.mh_importance_rows(g_ref, _lips(g_ref.n))
    if layout == "ragged":
        rows = jg.flat_edge_values(g_ref.indptr, g_ref.degrees, rows)
    ref = _ref_engine(g_ref, rows, jtr.MHLJParams(0.3, 0.5, 2), layout)
    eng = _from_reference(ref)
    assert eng.layout == layout
    w = 129
    nodes = (np.arange(w) * 3 % g_ref.n).astype(np.int32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref_n, ref_h = ref.step(key, jnp.asarray(nodes))
        u = _block(key, w, 2, 0.3)
        nxt, hops = eng.step(_t(nodes), uniforms=torch.from_numpy(u))
        ok = _d_ok(u, 0.5, 2)
        np.testing.assert_array_equal(nxt.numpy()[ok], np.asarray(ref_n)[ok])
        np.testing.assert_array_equal(hops.numpy()[ok], np.asarray(ref_h)[ok])


# -- compaction (the analogues of the reference's compaction tests) -----------


def _hub_engines(**bucketed_kw):
    """Port sparse engine and compacted bucketed engine on the BA hub
    graph, plus the reference's scan engines of both."""
    g_ref, g, lips, rows = _ba_hub()
    params = ttr.MHLJParams(0.25, 0.5, 3)
    jparams = jtr.MHLJParams(0.25, 0.5, 3)
    sparse = _port_engine(g, rows, params, "sparse")
    bucketed = _port_engine(g, rows, params, "bucketed", **bucketed_kw)
    ref = _ref_engine(g_ref, rows, jparams, "bucketed", **bucketed_kw)
    return g, sparse, bucketed, ref


def _compacted_parity(nodes, seed, **bucketed_kw):
    """Port bucketed == port sparse bit for bit; port vs the reference's
    bucketed scan engine at the hub mismatch bound.  Returns the port
    bucketed engine and this step's aux."""
    g, sparse, bucketed, ref = _hub_engines(**bucketed_kw)
    key = jax.random.PRNGKey(seed)
    w = nodes.shape[0]
    u = torch.from_numpy(_block(key, w, 3, 0.25))
    n_sp, h_sp = sparse.step(_t(nodes), uniforms=u)
    n_bk, h_bk, aux = bucketed.step(_t(nodes), uniforms=u, with_aux=True)
    assert torch.equal(n_sp, n_bk) and torch.equal(h_sp, h_bk)
    ref_n, ref_h = ref.step(key, jnp.asarray(nodes))
    ok = _d_ok(u.numpy(), 0.5, 3)
    np.testing.assert_array_equal(h_bk.numpy()[ok], np.asarray(ref_h)[ok])
    diff = (n_bk.numpy() != np.asarray(ref_n)) & ok
    assert diff.mean() <= HUB_MISMATCH_BOUND
    return bucketed, aux


def _overflow(aux) -> bool:
    """A step's ``compact_overflow``: a 0-d bool tensor on the engine's
    device, read here on the host."""
    flag = aux["compact_overflow"]
    assert flag.shape == () and flag.dtype == torch.bool
    return bool(flag)


@pytest.mark.parametrize("w", [37, 300, 129])
def test_compacted_parity_w_not_block_multiple(w):
    nodes = (np.arange(w) % 400).astype(np.int32)
    eng, aux = _compacted_parity(nodes, w, compact=True)
    assert eng.compact and len(eng.bucket_neighbors) >= 3


@pytest.mark.parametrize("bucket_factor", [2, 4])
def test_compacted_parity_bucket_factor(bucket_factor):
    nodes = (np.arange(200) % 400).astype(np.int32)
    eng, _ = _compacted_parity(nodes, 5, compact=True,
                               bucket_factor=bucket_factor)
    widths = tuple(int(b.shape[1]) for b in eng.bucket_neighbors)
    assert widths == tg.barabasi_albert(
        400, 3, seed=0, layout="csr").to_bucketed(
            bucket_factor=bucket_factor).bucket_widths


def test_compacted_all_walks_in_one_bucket():
    """Every walk on the hub: one bucket holds all W walks and every other
    bucket is empty.  The hub bucket's capacity is below W, so the step
    overflows and takes the full dispatch — still bitwise."""
    g = _ba_hub()[1]
    hub = int(np.argmax(g.degrees))
    nodes = np.full(160, hub, np.int32)
    eng, aux = _compacted_parity(nodes, 7, compact=True)
    caps = eng.bucket_capacities(160)
    _, _, counts = teng.compact_plan(eng.node_bucket[_t(nodes)], len(caps))
    counts = counts.numpy()
    assert np.count_nonzero(counts) == 1 and counts.max() == 160
    assert (counts == 0).sum() == len(caps) - 1
    assert _overflow(aux) is (caps[int(np.argmax(counts))] < 160)


def test_compacted_empty_bucket():
    g = _ba_hub()[1]
    deg = np.asarray(g.degrees)
    low = np.nonzero(deg <= np.median(deg))[0][:64]
    nodes = np.resize(low, 100).astype(np.int32)
    eng, aux = _compacted_parity(nodes, 11, compact=True)
    _, _, counts = teng.compact_plan(
        eng.node_bucket[_t(nodes)], len(eng.bucket_neighbors)
    )
    assert (counts.numpy() == 0).any()
    assert _overflow(aux) is False


def test_compacted_capacity_overflow_falls_back():
    """A tiny capacity_factor overflows: the step takes the full dispatch,
    says so through ``compact_overflow``, and stays bitwise."""
    nodes = (np.arange(300) % 400).astype(np.int32)
    eng, aux = _compacted_parity(nodes, 13, compact=True,
                                 capacity_factor=1e-6)
    caps = np.asarray(eng.bucket_capacities(300))
    _, _, counts = teng.compact_plan(eng.node_bucket[_t(nodes)], len(caps))
    assert (counts.numpy() > caps).any()
    assert _overflow(aux) is True


def test_compacted_run_matches_uncompacted_and_sparse_run():
    g, sparse, _, _ = _hub_engines()
    rows = _ba_hub()[3]
    params = ttr.MHLJParams(0.25, 0.5, 3)
    v0s = _t(np.arange(24) % g.n)
    gen = torch.Generator().manual_seed(3)
    blocks = torch.stack([teng.draw_uniforms(24, 3, 0.25, gen,
                                             torch.device("cpu"))
                          for _ in range(60)])
    n_sp, h_sp = sparse.run(v0s, 60, uniforms=blocks)
    for compact in (False, True):
        eng = _port_engine(g, rows, params, "bucketed", compact=compact)
        n_bk, h_bk, aux = eng.run(v0s, 60, uniforms=blocks, with_aux=True)
        assert torch.equal(n_sp, n_bk) and torch.equal(h_sp, h_bk)
        assert not aux["compact_overflow"].any()


def test_compacted_dispatch_matches_its_plain_version():
    """``walk_transition_bucketed_compacted`` on CPU tensors against its
    ref on hand-built compacted tiles, slop lanes included, and the full
    dispatch against its ref."""
    g, _, eng, _ = _hub_engines(compact=True)
    w = 150
    nodes = _t(np.arange(w) * 7 % g.n)
    u_mh = torch.rand(w, generator=torch.Generator().manual_seed(0))
    caps = eng.bucket_capacities(w)
    order, starts, counts = teng.compact_plan(eng.node_bucket[nodes], len(caps))
    ins = eng.compacted_bucket_inputs(nodes, u_mh, caps, order, starts, counts)
    widx, valid, rows, tiles, u_by = ins
    assert any((~v).any() for v in valid)  # slop lanes exist
    got = tkernel.walk_transition_bucketed_compacted(
        rows, tiles, u_by, widx, valid, w
    )
    want = tref.walk_transition_bucketed_compacted_ref(
        rows, tiles, u_by, widx, valid, w
    )
    assert torch.equal(got, want)
    bid, rows_f, tiles_f = eng._bucket_tiles(nodes)
    full = tkernel.walk_transition_bucketed(bid, rows_f, tiles_f, u_mh)
    assert torch.equal(full, tref.walk_transition_bucketed_ref(
        bid, rows_f, tiles_f, u_mh))
    assert torch.equal(full, got)


def test_compaction_helpers_bitwise_vs_reference():
    rng = np.random.default_rng(0)
    bid = rng.integers(0, 5, 300).astype(np.int32)
    bid[bid == 3] = 2  # an empty bucket
    order, starts, counts = teng.compact_plan(_t(bid), 5)
    j_order, j_starts, j_counts = jeng.compact_plan(jnp.asarray(bid), 5)
    for a, b in ((order, j_order), (starts, j_starts), (counts, j_counts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.int32
    for args in ((300, (0.5, 0.3, 0.01), 1.25), (37, (1.0,), 2.0),
                 (10, (0.1, 0.9), 1e-6)):
        assert teng.bucket_capacities(*args) == jeng.bucket_capacities(*args)
    res = [_t(rng.integers(0, 99, 8)) for _ in range(2)]
    widx = [_t([0, 2, 4, 0, 0, 0, 0, 0]), _t([1, 3, 5, 0, 0, 0, 0, 0])]
    valid = [torch.arange(8) < 3, torch.arange(8) < 3]
    out = teng.scatter_compacted(6, widx, valid, res)
    ref = jeng.scatter_compacted(
        6, [jnp.asarray(x.numpy()) for x in widx],
        [jnp.asarray(v.numpy()) for v in valid],
        [jnp.asarray(x.numpy()) for x in res],
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    merged = teng.combine_bucketed(_t([0, 1, 1, 0]), [_t([1, 2, 3, 4]),
                                                      _t([5, 6, 7, 8])])
    np.testing.assert_array_equal(merged.numpy(), [1, 6, 7, 4])


# -- the port's own layouts are one sampler --------------------------------------


@pytest.mark.parametrize("source", ["rows", "lipschitz", "live"])
def test_port_layouts_bitwise_equal_per_block(source):
    """All four port layouts walk identically per block on the BA hub graph
    (widths up to 61, where the reference's own order is not sequential):
    from shared numpy rows, from a static Lipschitz vector (rows built by
    the engine), and from live per-step rows."""
    _, g, lips, rows = _ba_hub()
    params = ttr.MHLJParams(0.3, 0.5, 4)
    engines = []
    for layout in ("sparse", "dense", "bucketed", "ragged"):
        for kw in ({"compact": True}, {"compact": False}) if (
                layout == "bucketed") else ({},):
            if source == "rows":
                e = _port_engine(g, rows, params, layout, **kw)
            elif source == "lipschitz" or layout == "ragged":
                e = teng.WalkEngine.from_graph(
                    g, params, lipschitz=lips, layout=layout, device="cpu",
                    **kw,
                )
            else:
                e = teng.WalkEngine.from_graph(
                    g, params, layout=layout, device="cpu", **kw
                )
            engines.append(e)
    live = torch.as_tensor(lips, dtype=torch.float32) if source == "live" else None
    gen = torch.Generator().manual_seed(11)
    hub = int(np.argmax(g.degrees))
    for _ in range(10):
        nodes = torch.randint(0, g.n, (257,), generator=gen, dtype=torch.int32)
        nodes[:40] = hub
        u = teng.draw_uniforms(257, 4, 0.3, gen, torch.device("cpu"))
        outs = [e.step(nodes, uniforms=u, lipschitz=live) for e in engines]
        for nxt, hops in outs[1:]:
            assert torch.equal(nxt, outs[0][0]) and torch.equal(hops, outs[0][1])


def test_edge_cdf_follows_the_rule():
    """The ragged CDF is the padded rows' sequential CDF with the pads
    dropped — from flat rows, a padded table, or Lipschitz — and the
    Lipschitz-built rows match the padded layout's live rows bit for bit."""
    _, g, lips, rows = _ba_hub()
    want = tg.flat_edge_values(
        g.indptr, g.degrees, teng.row_cdf(torch.from_numpy(rows)).numpy()
    )
    flat = tg.flat_edge_values(g.indptr, g.degrees, rows)
    for kw in ({"row_probs": flat}, {"row_probs": rows}):
        got = teng.ragged_edge_cdf(g.indptr, g.indices, g.degrees,
                                   device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    lips_t = torch.as_tensor(lips, dtype=torch.float32)
    live = teng.p_is_rows(_t(g.neighbors), _t(g.degrees), lips_t)
    want_live = tg.flat_edge_values(
        g.indptr, g.degrees, teng.row_cdf(live).numpy()
    )
    got = teng.ragged_edge_cdf(g.indptr, g.indices, g.degrees, lipschitz=lips,
                               device="cpu")
    np.testing.assert_array_equal(got.numpy(), want_live)
    # live rows: the reference's float32 Eq.-7 math, to within rounding
    ref_live = np.asarray(jeng.p_is_rows(
        jnp.asarray(g.neighbors), jnp.asarray(g.degrees),
        jnp.asarray(lips, jnp.float32),
    ))
    np.testing.assert_allclose(live.numpy(), ref_live, rtol=0, atol=1e-6)


# -- the port's own RNG -----------------------------------------------------------


def _chi_square_stat(counts, probs, min_expected=10.0):
    total = counts.sum()
    expected = probs * total
    big = expected >= min_expected
    obs = np.concatenate([counts[big], [counts[~big].sum()]])
    exp = np.concatenate([expected[big], [expected[~big].sum()]])
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    return float(((obs - exp) ** 2 / exp).sum()), len(obs) - 1


@pytest.mark.parametrize("layout", ["sparse", "dense", "bucketed"])
def test_port_rng_one_step_law_matches_dense_chain(layout):
    """The port's ``torch.Generator`` draws on the padded and bucketed
    layouts realize the MHLJ law: one-step distribution from a trap node
    against the reference's dense chain (chained Lévy), chi-square at ~4
    sigma and TV."""
    g_dense = jg.barabasi_albert(48, 3, seed=1)
    g = tg.barabasi_albert(48, 3, seed=1, layout="dense").to_csr()
    lips = np.ones(g.n)
    lips[5] = 35.0
    expected = jtr.mhlj(g_dense, lips, jtr.MHLJParams(0.25, 0.5, 3))[5]
    rows = ttr.row_probs_padded(ttr.mh_importance(g.to_dense(), lips),
                                g.to_dense())
    eng = _port_engine(g, rows, ttr.MHLJParams(0.25, 0.5, 3), layout)
    w = 60_000
    gen = torch.Generator().manual_seed(23)
    nxt, _ = eng.step(torch.full((w,), 5, dtype=torch.int32), generator=gen)
    counts = np.bincount(nxt.numpy(), minlength=g.n).astype(np.float64)
    stat, dof = _chi_square_stat(counts, expected)
    assert stat < dof + 4.0 * np.sqrt(2.0 * dof), (stat, dof)
    assert 0.5 * np.abs(counts / w - expected).sum() < 0.02


# -- engine construction and misuse -------------------------------------------


def test_bucketed_engine_carries_no_full_width_tensor(monkeypatch):
    bg = tg.barabasi_albert(100, 3, seed=5, layout="bucketed")
    params = ttr.MHLJParams(0.2, 0.5, 3)
    eng = teng.WalkEngine.from_graph(bg, params, lipschitz=np.ones(bg.n),
                                     device="cpu")
    assert eng.layout == "bucketed"
    assert eng.neighbors is None and eng.row_probs is None
    with pytest.raises(ValueError, match="bucketed layout"):
        eng.rows_table()
    for b, nbrs in enumerate(eng.bucket_neighbors):
        assert nbrs.shape[1] == bg.buckets[b].width <= bg.max_degree
    # the sparse layout with live rows never builds the full table
    csr = bg.to_csr()

    def boom(self, lipschitz=None):
        raise AssertionError("sparse layout materialized the full row table")

    monkeypatch.setattr(teng.WalkEngine, "rows_table", boom)
    live = teng.WalkEngine.from_graph(csr, params, device="cpu")
    assert live.layout == "sparse" and live.row_probs is None
    nxt, hops = live.step(
        _t(np.arange(33) % csr.n), generator=torch.Generator().manual_seed(1),
        lipschitz=torch.ones(csr.n),
    )
    assert ((nxt >= 0) & (nxt < csr.n)).all()
    assert ((hops >= 1) & (hops <= 3)).all()


def test_from_graph_picks_layout_by_graph_class():
    params = ttr.MHLJParams()
    lips = np.ones(30)
    for layout, expect in (("dense", "sparse"), ("csr", "sparse"),
                           ("bucketed", "bucketed"), ("ragged", "ragged")):
        g = tg.ring(30, layout=layout)
        e = teng.WalkEngine.from_graph(g, params, lipschitz=lips, device="cpu")
        assert e.layout == expect
        assert e.n == 30 and e.device == torch.device("cpu")
    e = teng.WalkEngine.from_graph(
        tg.ring(30, layout="ragged"), params, lipschitz=lips, layout="dense",
        device="cpu",
    )
    assert e.layout == "dense" and e.row_probs.shape == (30, 3)
    e = teng.WalkEngine.from_graph(
        tg.barabasi_albert(100, 3, layout="csr"), params, lipschitz=np.ones(100),
        layout="bucketed", bucket_factor=4, device="cpu",
    )
    assert len(e.bucket_share) == len(e.bucket_neighbors)


def test_engine_rejects_misuse():
    g = tg.ring(12, layout="csr")
    params = ttr.MHLJParams(0.2, 0.5, 2)
    nodes = _t(np.arange(4))
    u = torch.rand(4, 5)
    with pytest.raises(ValueError, match="unknown layout"):
        teng.WalkEngine.from_graph(g, params, layout="blocked", device="cpu")
    with pytest.raises(ValueError, match="row_probs or lipschitz"):
        teng.WalkEngine.from_graph(g, params, layout="ragged", device="cpu")
    with pytest.raises(ValueError, match="row_probs must be"):
        teng.WalkEngine.from_graph(g, params, row_probs=np.ones(36),
                                   device="cpu")
    with pytest.raises(ValueError, match="needs"):
        teng.WalkEngine(degrees=_t([1, 1]), layout="bucketed")
    with pytest.raises(ValueError, match="bucketed layout"):
        teng.WalkEngine.from_graph(
            g, params, row_probs=ttr.mh_uniform_rows_bucketed(g.to_bucketed()),
            device="cpu",
        )
    for layout in ("sparse", "dense", "bucketed"):
        e = teng.WalkEngine.from_graph(g, params, layout=layout, device="cpu")
        with pytest.raises(ValueError, match="lipschitz"):
            e.step(nodes, uniforms=u)
    with pytest.raises(ValueError, match="full-width"):
        e.rows_for(nodes)
    with pytest.raises(ValueError, match="exactly one"):
        teng.levy_jump_batched(nodes, u, _t(g.degrees), 0.5, 2)
    with pytest.raises(ValueError, match="one device"):
        tkernel.walk_transition_sparse(
            torch.rand(3, 4), torch.zeros(3, 4, dtype=torch.int32,
                                          device="meta"), torch.rand(3),
        )


# -- the trainer on the three new layouts --------------------------------------


def _data(m, n):
    return m(n, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
             x_star_scale=3.0)


TRAIN_CASES = [
    ("dense_ring", lambda m: m.ring(40), {}),
    ("csr_grid2d", lambda m: m.grid2d(8, 8, layout="csr"), {}),
    ("bucketed_dumbbell", lambda m: m.dumbbell(12, 3, layout="bucketed"), {}),
    ("bucketed_full_sbm",
     lambda m: m.sbm([40] * 3, 0.2, 0.01, seed=0, layout="bucketed"),
     {"compact": False}),
    ("csr_dense_layout", lambda m: m.grid2d(6, 7, layout="csr"),
     {"layout": "dense"}),
    ("dense_bucketed_layout", lambda m: m.dumbbell(12, 3),
     {"layout": "bucketed", "bucket_factor": 4}),
]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_run_rw_sgd_multi_layouts_match_reference(case):
    """``run_rw_sgd_multi("mhlj")`` with the same graph class and
    ``engine_kwargs`` in both packages: the port builds its own engine
    from its own rows; walks bitwise, MSE traces at rtol 1e-4."""
    _, build, kw = case
    g_ref, g = build(jg), build(tg)
    d_ref, d_port = _data(j_data, g.n), _data(t_data, g.n)
    gamma = float(0.3 / d_ref.lipschitz.mean())
    steps, w, (p_j, p_d, r) = 150, 8, (0.1, 0.5, 3)
    ref = j_run_multi(
        "mhlj", g_ref, d_ref, gamma, steps, w,
        mhlj_params=jtr.MHLJParams(p_j, p_d, r), avg_every=5, seed=0,
        engine_kwargs={"backend": "scan", **kw},
    )
    blocks = _fleet_blocks(0, steps, w, r, np.full(steps, p_j, np.float32))
    assert _d_ok(blocks, p_d, r).all()
    port = run_rw_sgd_multi(
        "mhlj", g, d_port, gamma, steps, w,
        mhlj_params=ttr.MHLJParams(p_j, p_d, r), avg_every=5, seed=0,
        engine_kwargs=kw or None, uniforms=torch.from_numpy(blocks),
        device="cpu",
    )
    np.testing.assert_array_equal(port.update_nodes, ref.update_nodes)
    np.testing.assert_array_equal(port.transitions, ref.transitions)
    np.testing.assert_allclose(port.mse, ref.mse, rtol=1e-4)
    np.testing.assert_allclose(port.avg_mse, ref.avg_mse, rtol=1e-4)
    assert port.avg_mse[-1] < port.avg_mse[0]


@pytest.mark.parametrize("method", ["uniform", "simple", "importance"])
@pytest.mark.parametrize("kind", ["dense", "csr", "bucketed"])
def test_run_rw_sgd_layouts_match_reference(kind, method):
    """The W=1 case over the non-jump laws, per graph class."""
    g_ref = jg.dumbbell(12, 3, layout=kind)
    g = tg.dumbbell(12, 3, layout=kind)
    d_ref, d_port = _data(j_data, g.n), _data(t_data, g.n)
    gamma = float(0.3 / d_ref.lipschitz.mean())
    steps = 120
    ref = j_run(method, g_ref, d_ref, gamma, steps, v0=5, seed=3,
                engine_kwargs={"backend": "scan"})
    blocks = _fleet_blocks(3, steps, 1, 1, np.zeros(steps, np.float32))
    port = run_rw_sgd(method, g, d_port, gamma, steps, v0=5, seed=3,
                      uniforms=torch.from_numpy(blocks), device="cpu")
    np.testing.assert_array_equal(port.update_nodes, ref.update_nodes)
    np.testing.assert_array_equal(port.transitions, ref.transitions)
    np.testing.assert_allclose(port.mse, ref.mse, rtol=1e-4)


def test_trainer_engine_kwargs_and_own_rng():
    g = tg.barabasi_albert(300, 3, seed=0, layout="csr")
    data = _data(t_data, g.n)
    gamma = float(0.3 / data.lipschitz.mean())
    runs = {}
    for kw in (None, {"layout": "dense"}, {"layout": "ragged"},
               {"layout": "bucketed"},
               {"layout": "bucketed", "compact": False, "bucket_factor": 4}):
        runs[str(kw)] = run_rw_sgd_multi(
            "mhlj", g, data, gamma, 200, 8, mhlj_params=ttr.MHLJParams(),
            avg_every=5, seed=1, engine_kwargs=kw, device="cpu",
        )
    base = runs["None"]
    assert base.avg_mse[-1] < 0.2 * base.avg_mse[0]
    for res in runs.values():  # one sampler: the same walks on every layout
        np.testing.assert_array_equal(res.update_nodes, base.update_nodes)
    eng = teng.WalkEngine.from_graph(g, ttr.MHLJParams(), lipschitz=np.ones(g.n),
                                     device="cpu")
    with pytest.raises(ValueError, match="not both"):
        run_rw_sgd("simple", g, data, 0.01, 5, engine=eng,
                   engine_kwargs={"compact": False}, device="cpu")
    with pytest.raises(TypeError):
        run_rw_sgd("simple", g, data, 0.01, 5, engine_kwargs={"backend": "x"},
                   device="cpu")
