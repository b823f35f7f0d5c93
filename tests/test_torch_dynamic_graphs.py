"""Port parity: dynamic graphs — churn, the CDF patch, walk continuity, Dada.

The churn itself (``graphs.apply_edge_churn``), the restricted row
builders (``node_ids=``), the continuity rule (``migrate_walk_nodes``)
and Dada's kNN rewire (``similarity_edges``) are host numpy and are held
bit for bit against the reference.  The port's CDF patch
(``engine.ragged_edge_cdf_update`` / ``WalkEngine.apply_churn``) is held
bit for bit against the port's own from-scratch ``ragged_edge_cdf``,
whose oracle each test names:

* "lipschitz": the from-scratch build from the same live Eq.-7 rows;
* "fresh rows": the from-scratch build from a fresh
  ``mh_importance_rows_ragged(new_graph)`` — the same values as the
  restricted ``touched_probs`` only because the host numpy rows do not
  change bits with the padded width (measured below, and on BA(100k,3) by
  ``tools/touched_probs_width.py``).

Against the reference's patched buffer the rule is the slice's CDF
contract: bitwise where rows are at most 17 wide, a measured and printed
pick-mismatch rate on BA hub rows.  The reference runs on its ``scan``
backend, its blocks (``split(key, T)``, slot 0 -> ``u < p_j``) injected
into the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # dev-only dependency (requirements-dev.txt)
    given = settings = st = None

from repro.core import engine as jeng
from repro.core import graphs as jg
from repro.core import levy as jlevy
from repro.core import transition as jtr
from repro.data import make_heterogeneous_regression as j_data
from repro.walk_sgd import fleet as jfleet
from repro.walk_sgd import graph_learning as jgl
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import graphs as tg
from repro_torch.core import levy as tlevy
from repro_torch.core import mixing as tmix
from repro_torch.core import transition as ttr
from repro_torch.core.walk import empirical_distribution
from repro_torch.data import make_heterogeneous_regression as t_data
from repro_torch.walk_sgd import fleet as tfleet
from repro_torch.walk_sgd import graph_learning as tgl
from repro_torch.walk_sgd import run_rw_sgd_multi

PARAMS = (0.25, 0.5, 3)  # (p_j, p_d, r)
# Pick-mismatch bound on BA hub rows, the slice's CDF contract.
HUB_MISMATCH_BOUND = 1e-3
# personalize_models: float32 ops in another order than XLA's
PERSONALIZE_RTOL = 1e-5
# round_mse / x_final of run_dada: the trainer tests' tolerance
TRAINER_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tparams(p=PARAMS):
    return ttr.MHLJParams(*p)


def _jparams(p=PARAMS):
    return jtr.MHLJParams(*p)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _undirected_pairs(core):
    n = core.n
    src = np.repeat(np.arange(n, dtype=np.int64),
                    np.diff(np.asarray(core.indptr, np.int64)))
    dst = np.asarray(core.indices, np.int64)
    keep = src < dst
    return np.stack([src[keep], dst[keep]], axis=1)


def _random_churn(core, rng, k_del, k_ins):
    """The reference tests' legal random batch: deletes between nodes of
    degree >= 4 that keep the graph connected (halved and retried),
    uniform non-edge inserts; either side may be None."""
    n = core.n
    deg = np.asarray(core.degrees, np.int64)
    pairs = _undirected_pairs(core)
    codes = set((pairs[:, 0] * n + pairs[:, 1]).tolist())
    cand = pairs[(deg[pairs[:, 0]] >= 4) & (deg[pairs[:, 1]] >= 4)]
    dele = None
    k_del = min(k_del, cand.shape[0])
    while k_del:
        sel = rng.choice(cand.shape[0], size=k_del, replace=False)
        try:
            tg.apply_edge_churn(core, delete=cand[sel], check_connectivity=True)
        except ValueError:
            k_del //= 2
            continue
        dele = cand[sel]
        break
    ins = []
    attempts = 0
    while len(ins) < k_ins and attempts < 50 * (k_ins + 1):
        attempts += 1
        a, b = (int(x) for x in rng.integers(0, n, size=2))
        if a == b:
            continue
        lo, hi = min(a, b), max(a, b)
        if lo * n + hi in codes:
            continue
        codes.add(lo * n + hi)
        ins.append((lo, hi))
    return (np.asarray(ins, np.int64) if ins else None), dele


def _same_churn(port, ref):
    """Graph arrays and every EdgeChurn field, bit for bit."""
    (g_t, c_t), (g_j, c_j) = port, ref
    assert type(g_t).__name__ == type(g_j).__name__
    for f in ("indptr", "indices", "degrees") + (
            ("neighbors",) if hasattr(g_j, "neighbors") else ()):
        a, b = np.asarray(getattr(g_t, f)), np.asarray(getattr(g_j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("inserted", "deleted", "endpoints", "degree_changed",
              "touched_rows"):
        a, b = getattr(c_t, f), getattr(c_j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert c_t.num_edges_before == c_j.num_edges_before
    assert c_t.num_edges_after == c_j.num_edges_after


def _lips(n, seed=0):
    lips = np.ones(n)
    lips[5] = 35.0  # a trap node
    return lips * np.exp(np.random.default_rng(seed).normal(0, 0.3, n))


# -- 1. the churn: bit for bit with the reference, and the patch --------------


def _check_churn_sequence(seed, k_del, k_ins, batches=3):
    """A random churn sequence on BA(60,3), both graph classes: the port's
    churn equals the reference's after every batch, and the port's
    patched CDF equals its from-scratch build — oracle "lipschitz" for the
    live-row engine, "fresh rows" for the ``touched_probs`` one (fed as
    the reference's ``run_dada`` feeds it: restricted unless the batch
    outgrew ``cdf_width``).  The width is the reference's sticky rule
    (held against the reference's engine in
    :func:`test_patch_equals_rebuild_at_any_width`)."""
    g_t = tg.barabasi_albert(60, 3, seed=seed, layout="csr")
    g_j = jg.barabasi_albert(60, 3, seed=seed, layout="csr")
    core_t, core_j = g_t.to_ragged(), g_j.to_ragged()
    lips = _lips(g_t.n, seed)
    rng = np.random.default_rng(seed + 100)
    eng_lip = teng.WalkEngine.from_graph(core_t, _tparams(), lipschitz=lips,
                                         device="cpu")
    eng_flat = teng.WalkEngine.from_graph(
        core_t, _tparams(), row_probs=ttr.mh_importance_rows_ragged(core_t, lips),
        device="cpu")
    width = core_t.max_degree
    assert eng_lip.cdf_width == eng_flat.cdf_width == width
    for batch in range(batches):
        ins, dele = _random_churn(core_t, rng, k_del, k_ins)
        out_t = tg.apply_edge_churn(core_t, insert=ins, delete=dele)
        out_j = jg.apply_edge_churn(core_j, insert=ins, delete=dele)
        _same_churn(out_t, out_j)
        pad_t = g_t.apply_edge_churn(insert=ins, delete=dele)
        pad_j = g_j.apply_edge_churn(insert=ins, delete=dele)
        _same_churn(pad_t, pad_j)
        (core_t, churn), (core_j, _) = out_t, out_j
        g_t, g_j = pad_t[0], pad_j[0]
        core_t.validate()
        g_t.validate()
        eng_lip = eng_lip.apply_churn(core_t, churn, lipschitz=lips)
        need_full = core_t.max_degree > eng_flat.cdf_width
        eng_flat = eng_flat.apply_churn(
            core_t, churn,
            touched_probs=ttr.mh_importance_rows_ragged(
                core_t, lips, node_ids=None if need_full else churn.touched_rows))
        width = max(width, core_t.max_degree)
        assert eng_lip.graph_version == eng_flat.graph_version == batch + 1
        assert eng_lip.cdf_width == eng_flat.cdf_width == width
        assert eng_lip.max_degree == eng_flat.max_degree == core_t.max_degree
        # from-scratch oracles on a graph rebuilt from the edge list
        pairs = _undirected_pairs(core_t)
        rebuilt = tg.from_edges(core_t.n, pairs[:, 0], pairs[:, 1],
                                layout="ragged")
        for f in ("indptr", "indices", "degrees"):
            assert np.array_equal(getattr(rebuilt, f), getattr(core_t, f))
        lip_oracle = teng.ragged_edge_cdf(
            rebuilt.indptr, rebuilt.indices, rebuilt.degrees,
            lipschitz=lips, device="cpu")
        fresh_oracle = teng.ragged_edge_cdf(
            rebuilt.indptr, rebuilt.indices, rebuilt.degrees,
            row_probs=ttr.mh_importance_rows_ragged(rebuilt, lips),
            device="cpu")
        assert np.array_equal(_bits(eng_lip.edge_cdf), _bits(lip_oracle))
        assert np.array_equal(_bits(eng_flat.edge_cdf), _bits(fresh_oracle))
        # and a plain from_graph engine, whatever the sticky width
        fresh = teng.WalkEngine.from_graph(rebuilt, _tparams(),
                                           lipschitz=lips, device="cpu")
        assert np.array_equal(_bits(fresh.edge_cdf), _bits(eng_lip.edge_cdf))


@pytest.mark.parametrize(
    "seed,k_del,k_ins",
    [(1, 5, 5), (2, 8, 0), (3, 0, 8), (4, 1, 1), (5, 0, 0)],
)
def test_churn_sequence_matches_reference_and_rebuild(seed, k_del, k_ins):
    """Pinned draws: delete-only, insert-only, mixed and empty batches."""
    _check_churn_sequence(seed, k_del, k_ins)


if st is not None:

    @given(seed=st.integers(0, 7), k_del=st.integers(0, 8),
           k_ins=st.integers(0, 8))
    @settings(max_examples=10, deadline=None)
    def test_churn_sequence_hypothesis(seed, k_del, k_ins):
        _check_churn_sequence(seed, k_del, k_ins, batches=2)


def test_churn_contract_errors_match_reference():
    """Every malformed batch raises the reference's ValueError, the same
    first one when a batch breaks several rules, and leaves the graph as
    it was."""
    g_t = tg.barabasi_albert(30, 3, seed=2, layout="ragged")
    g_j = jg.barabasi_albert(30, 3, seed=2, layout="ragged")
    n = g_t.n
    pairs = _undirected_pairs(g_t)
    present = pairs[:1]
    codes = set((pairs[:, 0] * n + pairs[:, 1]).tolist())
    absent = next(np.asarray([[a, b]], np.int64) for a in range(n)
                  for b in range(a + 1, n) if a * n + b not in codes)
    before = [a.copy() for a in (g_t.indptr, g_t.indices, g_t.degrees)]
    cases = [
        dict(insert=present),  # present insert
        dict(delete=absent),  # absent delete
        dict(insert=np.asarray([[3, 3]])),  # self-pair
        dict(insert=np.concatenate([absent, absent[:, ::-1]])),  # duplicate
        dict(insert=np.asarray([[0, n]])),  # out of range
        dict(insert=present, delete=present),  # insert ∩ delete
        dict(insert=np.asarray([[0, 1, 2]])),  # not (k, 2)
        # several rules at once: the reference's order decides
        dict(insert=np.asarray([[3, 3], [0, n]])),
        dict(insert=np.asarray([[3, 3]]), delete=absent),
        dict(insert=present, delete=np.asarray([[0, n]])),
        dict(insert=absent, delete=absent),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as ej:
            jg.apply_edge_churn(g_j, **kw)
        with pytest.raises(ValueError) as et:
            tg.apply_edge_churn(g_t, **kw)
        assert str(et.value) == str(ej.value), kw
    for a, b in zip(before, (g_t.indptr, g_t.indices, g_t.degrees)):
        assert np.array_equal(a, b)
    with pytest.raises(TypeError, match="to_csr"):
        tg.apply_edge_churn(g_t.to_dense(), insert=absent)


def test_churn_connectivity_gate_and_departure():
    """A path tip's last non-loop edge: with ``check_connectivity`` the
    batch raises, without it the tip departs with degree 1 — as the
    reference."""
    core_t = tg.lollipop(6, 3, layout="ragged")
    core_j = jg.lollipop(6, 3, layout="ragged")
    tip = core_t.n - 1
    nbrs = _undirected_pairs(core_t)
    tip_edges = nbrs[(nbrs[:, 0] == tip) | (nbrs[:, 1] == tip)]
    with pytest.raises(ValueError, match="disconnects"):
        tg.apply_edge_churn(core_t, delete=tip_edges, check_connectivity=True)
    out_t = tg.apply_edge_churn(core_t, delete=tip_edges)
    _same_churn(out_t, jg.apply_edge_churn(core_j, delete=tip_edges))
    assert int(out_t[0].degrees[tip]) == 1
    assert tip in out_t[1].endpoints and tip in out_t[1].degree_changed


def test_churn_padded_width_grows_and_shrinks():
    """On a ``CSRGraph`` the padded width grows past the old max degree
    and shrinks back, equal to the reference and to a rebuild."""
    g_t, g_j = tg.ring(12, layout="csr"), jg.ring(12, layout="csr")
    ins = np.asarray([[0, u] for u in (3, 5, 6, 7, 9)], np.int64)
    out_t, out_j = tg.apply_edge_churn(g_t, insert=ins), jg.apply_edge_churn(
        g_j, insert=ins)
    _same_churn(out_t, out_j)
    assert out_t[0].neighbors.shape[1] > g_t.neighbors.shape[1]
    back_t = tg.apply_edge_churn(out_t[0], delete=ins)
    _same_churn(back_t, jg.apply_edge_churn(out_j[0], delete=ins))
    assert np.array_equal(back_t[0].neighbors, g_t.neighbors)


# -- 2. the patch: widths, escalation, sources --------------------------------


def _hub_churn(kind, seed=4):
    """BA(40,3) and a batch that keeps, lowers or raises the max degree."""
    core = tg.barabasi_albert(40, 3, seed=seed, layout="ragged")
    n = core.n
    deg = np.asarray(core.degrees, np.int64)
    hub = int(deg.argmax())
    nbrs = core.row(hub)
    if kind == "raise":
        targets = [v for v in range(n) if v != hub and v not in set(nbrs)][:2]
        ins = np.asarray([[min(hub, v), max(hub, v)] for v in targets])
        return core, dict(insert=ins)
    if kind == "lower":
        victims = [int(v) for v in nbrs if v != hub and deg[v] >= 4][:3]
        return core, dict(delete=np.asarray(
            [[min(hub, v), max(hub, v)] for v in victims]))
    ins, dele = _random_churn(core, np.random.default_rng(seed), 3, 3)
    hubs = deg >= deg.max() - 1
    dele = dele[~(hubs[dele[:, 0]] | hubs[dele[:, 1]])]
    ins = ins[~(hubs[ins[:, 0]] | hubs[ins[:, 1]])]
    assert ins.size and dele.size
    return core, dict(insert=ins, delete=dele)


@pytest.mark.parametrize("source", ["lipschitz", "touched_probs"])
@pytest.mark.parametrize("kind", ["keep", "lower", "raise"])
def test_patch_equals_rebuild_at_any_width(kind, source):
    """The patched CDF equals the port's from-scratch build bit for bit
    whether the churn keeps the max degree, lowers it (``cdf_width`` stays
    sticky, the reference's rule) or raises it past ``cdf_width`` (the
    escalated full rebuild; a restricted ``touched_probs`` then raises).
    Oracle: "lipschitz" or "fresh rows", by the source."""
    core, batch = _hub_churn(kind)
    lips = _lips(core.n)
    kw = (dict(lipschitz=lips) if source == "lipschitz"
          else dict(row_probs=ttr.mh_importance_rows_ragged(core, lips)))
    eng = teng.WalkEngine.from_graph(core, _tparams(), device="cpu", **kw)
    w0 = eng.cdf_width
    core2, churn = tg.apply_edge_churn(core, **batch)
    new_max = core2.max_degree
    assert {"keep": new_max == w0, "lower": new_max < w0,
            "raise": new_max > w0}[kind]
    if source == "lipschitz":
        eng2 = eng.apply_churn(core2, churn, lipschitz=lips)
        oracle = teng.ragged_edge_cdf(core2.indptr, core2.indices,
                                      core2.degrees, lipschitz=lips,
                                      device="cpu")
    else:
        restricted = ttr.mh_importance_rows_ragged(
            core2, lips, node_ids=churn.touched_rows)
        full = ttr.mh_importance_rows_ragged(core2, lips)
        if kind == "raise":
            with pytest.raises(ValueError, match="full-length"):
                eng.apply_churn(core2, churn, touched_probs=restricted)
            eng2 = eng.apply_churn(core2, churn, touched_probs=full)
        else:
            eng2 = eng.apply_churn(core2, churn, touched_probs=restricted)
        oracle = teng.ragged_edge_cdf(core2.indptr, core2.indices,
                                      core2.degrees, row_probs=full,
                                      device="cpu")
    assert np.array_equal(_bits(eng2.edge_cdf), _bits(oracle))
    assert eng2.cdf_width == max(w0, new_max) and eng2.max_degree == new_max
    assert eng2.graph_version == 1 and eng.graph_version == 0
    if source == "lipschitz":  # the reference's engine keeps the same width
        lj = jnp.asarray(lips, jnp.float32)
        core_j = jg.barabasi_albert(40, 3, seed=4, layout="ragged")
        ref = jeng.WalkEngine.from_graph(core_j, _jparams(), lipschitz=lj,
                                         backend="scan", layout="ragged")
        ref2 = ref.apply_churn(*jg.apply_edge_churn(core_j, **batch),
                               lipschitz=lj)
        assert (ref2.cdf_width, ref2.max_degree, ref2.graph_version) == (
            eng2.cdf_width, eng2.max_degree, eng2.graph_version)
    # the width is checked only: any width that covers gives the same bits
    for width in (new_max, new_max + 7, 4 * new_max):
        kw = (dict(lipschitz=lips) if source == "lipschitz"
              else dict(row_probs=full))
        again = teng.ragged_edge_cdf(core2.indptr, core2.indices,
                                     core2.degrees, width=width,
                                     device="cpu", **kw)
        assert np.array_equal(_bits(again), _bits(oracle))
    with pytest.raises(ValueError, match="cannot cover"):
        teng.ragged_edge_cdf(core2.indptr, core2.indices, core2.degrees,
                             lipschitz=lips, width=new_max - 1, device="cpu")


def test_patch_leaves_the_old_engine_alone():
    """``apply_churn`` reads the old engine and writes fresh tensors: the
    old CDF, CSR arrays and device constants are untouched and unshared."""
    core, batch = _hub_churn("keep")
    lips = _lips(core.n)
    eng = teng.WalkEngine.from_graph(core, _tparams(), lipschitz=lips,
                                     device="cpu")
    eng._consts["marker"] = 1
    saved = {f: getattr(eng, f).clone()
             for f in ("edge_cdf", "indptr", "indices", "degrees")}
    core2, churn = tg.apply_edge_churn(core, **batch)
    eng2 = eng.apply_churn(core2, churn, lipschitz=lips)
    for f, t in saved.items():
        assert torch.equal(getattr(eng, f), t)
        assert getattr(eng2, f).data_ptr() != getattr(eng, f).data_ptr()
    assert "marker" not in eng2._consts


def test_patch_contract_errors():
    """The reference's messages: another layout, a missing or a doubled
    row source, a touched set that misses a changed row, a changed node
    count, touched rows out of order, a short ``touched_probs``."""
    core, batch = _hub_churn("keep")
    lips = _lips(core.n)
    core2, churn = tg.apply_edge_churn(core, **batch)
    sparse = teng.WalkEngine.from_graph(core.to_csr(), _tparams(),
                                        lipschitz=lips, device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        sparse.apply_churn(core2, churn, lipschitz=lips)
    eng = teng.WalkEngine.from_graph(core, _tparams(), lipschitz=lips,
                                     device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        eng.apply_churn(core2, churn)
    with pytest.raises(ValueError, match="exactly one"):
        eng.apply_churn(core2, churn, lipschitz=lips, touched_probs=np.ones(3))
    with pytest.raises(TypeError, match="post-churn"):
        eng.apply_churn(core2.to_dense(), churn, lipschitz=lips)
    old = (core.indptr, core.degrees, eng.edge_cdf)
    new = (core2.indptr, core2.indices, core2.degrees)
    with pytest.raises(ValueError, match="touched"):
        teng.ragged_edge_cdf_update(*old, *new, np.asarray([], np.int64),
                                    lipschitz=lips)
    with pytest.raises(ValueError, match="ascending"):
        teng.ragged_edge_cdf_update(*old, *new, churn.touched_rows[::-1],
                                    lipschitz=lips)
    with pytest.raises(ValueError, match="node count"):
        teng.ragged_edge_cdf_update(core.indptr[:-1], core.degrees[:-1],
                                    eng.edge_cdf, *new, churn.touched_rows,
                                    lipschitz=lips)
    with pytest.raises(ValueError, match="flat"):
        teng.ragged_edge_cdf_update(*old, *new, churn.touched_rows,
                                    touched_probs=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="cover"):
        teng.ragged_edge_cdf_update(*old, *new, churn.touched_rows,
                                    lipschitz=lips, width=2)


def test_host_rows_do_not_change_bits_with_width():
    """The ``touched_probs`` finding the "fresh rows" oracle rests on: the
    host numpy Eq.-7 rows (``_mh_rows_block``, pairwise float64 sums) give
    the same float32 bits at every padded width from the max degree up,
    on BA(400,3) and BA(60,3) (the count of differing entries is printed;
    BA(100k,3) is measured by ``tools/touched_probs_width.py``)."""
    for n, seed in ((400, 0), (60, 1), (60, 2)):
        g = tg.barabasi_albert(n, 3, seed=seed, layout="ragged")
        lips = _lips(n, seed)
        deg = np.asarray(g.degrees, np.int64)
        ids = np.arange(n, dtype=np.int64)
        base = None
        diff = 0
        for width in range(g.max_degree, g.max_degree + 40):
            nbrs = tg._pad_neighbor_lists(g.indptr, g.indices, deg,
                                          node_ids=ids, width=width)
            rows = ttr._mh_rows_block(nbrs, ids, deg, deg, lips)
            flat = tg.flat_edge_values(g.indptr, deg, rows)
            if base is None:
                base = flat
            diff += int((_bits(flat) != _bits(base)).sum())
        print(f"BA({n},3) seed {seed}: {diff} entries differ across widths "
              f"{g.max_degree}..{g.max_degree + 39}")
        assert diff == 0


@pytest.mark.parametrize("name", ["ring", "grid2d", "sbm"])
def test_patch_matches_reference_bitwise_on_narrow_rows(name):
    """Where rows are at most 17 wide the port's patched CDF equals the
    reference's patched buffer bit for bit (XLA's cumsum is sequential
    there), through both row sources."""
    make = {"ring": lambda m: m.ring(64, layout="ragged"),
            "grid2d": lambda m: m.grid2d(8, 8, layout="ragged"),
            "sbm": lambda m: m.sbm([40] * 3, 0.2, 0.01, seed=0,
                                   layout="ragged")}[name]
    core_t, core_j = make(tg), make(jg)
    lips = _lips(core_t.n)
    rng = np.random.default_rng(7)
    ins, dele = _random_churn(core_t, rng, 6, 6)
    c2_t, ch_t = tg.apply_edge_churn(core_t, insert=ins, delete=dele)
    c2_j, ch_j = jg.apply_edge_churn(core_j, insert=ins, delete=dele)
    assert c2_t.max_degree <= 17
    for src in ("lipschitz", "touched_probs"):
        if src == "lipschitz":
            kt, kj = dict(lipschitz=lips), dict(
                lipschitz=jnp.asarray(lips, jnp.float32))
            pt, pj = kt, kj
        else:
            # restricted rows unless the batch outgrew the build width
            ids = (None if c2_t.max_degree > core_t.max_degree
                   else ch_t.touched_rows)
            kt = kj = dict(row_probs=ttr.mh_importance_rows_ragged(core_t, lips))
            pt = dict(touched_probs=ttr.mh_importance_rows_ragged(
                c2_t, lips, node_ids=ids))
            pj = dict(touched_probs=jtr.mh_importance_rows_ragged(
                c2_j, lips, node_ids=ids))
        e_t = teng.WalkEngine.from_graph(core_t, _tparams(), device="cpu", **kt)
        e_j = jeng.WalkEngine.from_graph(core_j, _jparams(), backend="scan",
                                         layout="ragged", **kj)
        p_t = e_t.apply_churn(c2_t, ch_t, **pt)
        p_j = e_j.apply_churn(c2_j, ch_j, **pj)
        assert np.array_equal(_bits(p_t.edge_cdf), _bits(p_j.edge_cdf)), src


def test_patch_matches_reference_pick_rate_on_ba_hub():
    """On BA(400,3) the hub rows are ~60 wide, where XLA's cumsum and the
    row-CDF rule differ in the last bits: the port's patched CDF picks the
    reference's neighbor but for a measured share of draws (printed),
    under the bound, and it equals the port's rebuild bit for bit."""
    core_t = tg.barabasi_albert(400, 3, seed=0, layout="ragged")
    core_j = jg.barabasi_albert(400, 3, seed=0, layout="ragged")
    lips = _lips(core_t.n)
    ins, dele = _random_churn(core_t, np.random.default_rng(3), 8, 8)
    c2_t, ch_t = tg.apply_edge_churn(core_t, insert=ins, delete=dele)
    c2_j, ch_j = jg.apply_edge_churn(core_j, insert=ins, delete=dele)
    e_t = teng.WalkEngine.from_graph(core_t, _tparams(), lipschitz=lips,
                                     device="cpu").apply_churn(
        c2_t, ch_t, lipschitz=lips)
    lj = jnp.asarray(lips, jnp.float32)
    e_j = jeng.WalkEngine.from_graph(core_j, _jparams(), lipschitz=lj,
                                     backend="scan", layout="ragged"
                                     ).apply_churn(c2_j, ch_j, lipschitz=lj)
    oracle = teng.ragged_edge_cdf(c2_t.indptr, c2_t.indices, c2_t.degrees,
                                  lipschitz=lips, device="cpu")
    assert np.array_equal(_bits(e_t.edge_cdf), _bits(oracle))
    rng = np.random.default_rng(11)
    w = 120_000
    nodes = rng.integers(0, c2_t.n, w)
    nodes[: w // 2] = int(np.argmax(c2_t.degrees))  # half on the hub
    nodes = torch.as_tensor(nodes.astype(np.int32))
    u = torch.as_tensor(rng.random(w, dtype=np.float32))
    csr = (e_t.indptr, e_t.degrees, e_t.indices)
    mine = teng.ragged_mh_invert(*csr, e_t.edge_cdf, nodes, u,
                                 max_degree=e_t.max_degree)
    theirs = teng.ragged_mh_invert(
        *csr, torch.as_tensor(np.array(e_j.edge_cdf)), nodes, u,
        max_degree=e_t.max_degree)
    bad = int((mine != theirs).sum())
    print(f"patched BA hub pick mismatch: {bad} of {w} ({bad / w:.2e})")
    assert bad / w <= HUB_MISMATCH_BOUND


# -- 3. walks on a churned reference engine, four layouts ----------------------


def _ref_blocks(key, num_steps, w, r, p_j):
    keys = jax.random.split(key, num_steps)

    def one(k):
        u = jax.random.uniform(k, (w, jeng.num_uniforms(r)), jnp.float32)
        return u.at[:, 0].set((u[:, 0] < p_j).astype(jnp.float32))

    return np.array(jax.vmap(one)(keys))


def _d_mismatch(u, p_d, r):
    d_ref = np.asarray(jlevy.trunc_geom_icdf(jnp.asarray(u[..., 2]), p_d, r))
    d_port = tlevy.trunc_geom_icdf(torch.from_numpy(u[..., 2]), p_d, r).numpy()
    return (d_ref != d_port) & (u[..., 0] > 0.5)


def _from_reference(e):
    def a(x):
        return None if x is None else np.asarray(x)

    return interop.from_reference_state(
        layout=e.layout, degrees=a(e.degrees), p_j=float(e.p_j), p_d=e.p_d,
        r=e.r, indptr=a(e.indptr), indices=a(e.indices),
        edge_cdf=a(e.edge_cdf), max_degree=e.max_degree,
        cdf_width=e.cdf_width, graph_version=e.graph_version,
        neighbors=a(e.neighbors), row_probs=a(e.row_probs),
        node_bucket=a(e.node_bucket), node_slot=a(e.node_slot),
        bucket_neighbors=None if e.bucket_neighbors is None
        else [a(b) for b in e.bucket_neighbors],
        bucket_rows=None if e.bucket_rows is None
        else [a(b) for b in e.bucket_rows],
        bucket_share=e.bucket_share, compact=e.compact,
        capacity_factor=e.capacity_factor, device="cpu",
    )[0]


@functools.lru_cache(maxsize=None)
def _churned_reference():
    """A reference ragged engine after two churn batches on an SBM of 48
    nodes (rows at most 17 wide, where XLA's cumsum is the row-CDF rule's
    sequential sum; the max degree kept), and the churned dense graph's
    padded P_IS rows."""
    g = jg.sbm([16] * 3, 0.35, 0.03, seed=0, layout="csr")
    core = g.to_ragged()
    lips = _lips(g.n)
    rng = np.random.default_rng(3)
    eng = jeng.WalkEngine.from_graph(
        core, _jparams(), row_probs=jtr.mh_importance_rows_ragged(core, lips),
        backend="scan", layout="ragged")
    max_deg = core.max_degree
    for _ in range(2):
        deg = np.asarray(core.degrees, np.int64)
        hub = deg >= max_deg
        ins, dele = _random_churn(tg.RaggedCSRGraph(
            indptr=core.indptr, indices=core.indices, degrees=core.degrees),
            rng, 4, 4)
        dele = dele[~(hub[dele[:, 0]] | hub[dele[:, 1]])]
        ins = ins[~(hub[ins[:, 0]] | hub[ins[:, 1]])]
        core, churn = jg.apply_edge_churn(core, insert=ins, delete=dele)
        eng = eng.apply_churn(core, churn, touched_probs=(
            jtr.mh_importance_rows_ragged(core, lips,
                                          node_ids=churn.touched_rows)))
    assert core.max_degree == max_deg <= 17 and eng.graph_version == 2
    pairs = _undirected_pairs(core)
    dense = jg.from_edges(core.n, pairs[:, 0], pairs[:, 1], layout="dense")
    rp = jtr.row_probs_padded(jtr.mh_importance(dense, lips), dense)
    return eng, dense, rp


@pytest.mark.parametrize("layout", ["ragged", "sparse", "dense", "bucketed"])
def test_walks_on_churned_reference_engine(layout):
    """The reference's churned engine (``graph_version`` 2, carried by
    ``interop``) for the ragged layout, and fresh reference engines of the
    other layouts on the churned graph, run 50 steps on the reference's
    blocks: ``(next_nodes, hops)`` bit for bit with the reference's run."""
    eng, dense, rp = _churned_reference()
    if layout != "ragged":
        eng = jeng.WalkEngine.from_graph(dense.to_csr(), _jparams(),
                                         row_probs=jnp.asarray(rp),
                                         backend="scan", layout=layout)
    port = _from_reference(eng)
    assert port.graph_version == eng.graph_version
    p_j, p_d, r = PARAMS
    w, steps = 37, 50
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        blocks = _ref_blocks(key, steps, w, r, p_j)
        if not _d_mismatch(blocks, p_d, r).any():
            break
    v0 = jnp.arange(w, dtype=jnp.int32) % dense.n
    ref_nodes, ref_hops = eng.run(key, v0, steps)
    nodes, hops = port.run(torch.as_tensor(np.array(v0)), steps,
                           uniforms=torch.from_numpy(blocks))
    assert np.array_equal(nodes.numpy(), np.asarray(ref_nodes))
    assert np.array_equal(hops.numpy(), np.asarray(ref_hops))


# -- 4. node_ids= restricted row buffers --------------------------------------


BUILDERS = {
    "simple_rw": lambda m, g, lips, ids: m.simple_rw_rows_ragged(
        g, node_ids=ids),
    "mh_uniform": lambda m, g, lips, ids: m.mh_uniform_rows_ragged(
        g, node_ids=ids),
    "mh_importance": lambda m, g, lips, ids: m.mh_importance_rows_ragged(
        g, lips, node_ids=ids),
    "heterogeneity": lambda m, g, lips, ids: m.heterogeneity_rows_ragged(
        g, lips / lips.sum(), node_ids=ids),
    "private_weighted": lambda m, g, lips, ids: m.private_weighted_rows_ragged(
        g, lips, 0.3, seed=4, node_ids=ids),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_node_ids_rows_match_reference(builder):
    """Each restricted builder equals the reference's bit for bit, and
    each row equals its entry of the port's full build; bad ids raise."""
    g = tg.barabasi_albert(200, 3, seed=1, layout="ragged")
    gj = jg.barabasi_albert(200, 3, seed=1, layout="ragged")
    lips = _lips(g.n)
    _, churn = tg.apply_edge_churn(
        g, insert=np.asarray([[0, 150], [7, 99]]))
    ids = churn.touched_rows
    fn = BUILDERS[builder]
    port = fn(ttr, g, lips, ids)
    assert np.array_equal(_bits(port), _bits(fn(jtr, gj, lips, ids)))
    full = fn(ttr, g, lips, None)
    pos = tg._concat_ranges(np.asarray(g.indptr)[ids],
                            np.asarray(g.degrees, np.int64)[ids])
    assert np.array_equal(_bits(port), _bits(full[pos]))
    with pytest.raises(ValueError, match="ascending"):
        fn(ttr, g, lips, ids[::-1])


# -- 5. walk continuity --------------------------------------------------------


def test_migrate_walk_nodes_matches_reference_and_pins_the_formula():
    core_t = tg.lollipop(6, 3, layout="ragged")
    tip = core_t.n - 1
    nbrs = _undirected_pairs(core_t)
    tip_edges = nbrs[(nbrs[:, 0] == tip) | (nbrs[:, 1] == tip)]
    core2, churn = tg.apply_edge_churn(core_t, delete=tip_edges)
    deg2 = np.asarray(core2.degrees)
    nodes = np.asarray([0, tip, 3, tip], np.int32)
    new, disp = tfleet.migrate_walk_nodes(nodes, deg2, seed=11)
    ref_new, ref_disp = jfleet.migrate_walk_nodes(nodes, deg2, seed=11)
    assert new.dtype == ref_new.dtype and np.array_equal(new, ref_new)
    assert np.array_equal(disp, ref_disp)
    assert np.array_equal(disp, [False, True, False, True])
    active = np.nonzero(deg2 > 1)[0].astype(np.int32)
    draws = tfleet.sample_initial_nodes(int(active.size), 4, seed=11)
    assert new[1] == active[draws[1]] and new[3] == active[draws[3]]
    assert new[0] == 0 and new[2] == 3
    for args, kw in (((np.asarray([core_t.n + 3]), deg2), {}),
                     ((nodes, np.ones(core_t.n, np.int64)), {})):
        with pytest.raises(ValueError) as et:
            tfleet.migrate_walk_nodes(*args, **kw)
        with pytest.raises(ValueError) as ej:
            jfleet.migrate_walk_nodes(*args, **kw)
        assert str(et.value) == str(ej.value)

    # the fleet: engine swap + migration, W=2 and the W=1 scalar shape
    lips = np.ones(core_t.n)
    eng = teng.WalkEngine.from_graph(core_t, _tparams(), lipschitz=lips,
                                     device="cpu")
    eng2 = eng.apply_churn(core2, churn, lipschitz=lips)
    fleet = tfleet.WalkFleet(engine=eng, nodes=torch.tensor(
        [0, tip], dtype=torch.int32), num_walks=2)
    fleet2, disp = fleet.migrate(eng2, seed=11)
    assert fleet2.engine is eng2 and fleet2.engine.graph_version == 1
    assert np.array_equal(disp, [False, True])
    assert fleet2.nodes.tolist() == [0, int(active[
        tfleet.sample_initial_nodes(int(active.size), 2, seed=11)[1]])]
    one = tfleet.WalkFleet(engine=eng, nodes=torch.tensor(tip,
                                                          dtype=torch.int32))
    one2, disp1 = one.migrate(eng2, seed=11)
    ref_one, _ = jfleet.migrate_walk_nodes(np.int32(tip), deg2, seed=11)
    assert one2.nodes.ndim == 0 and int(one2.nodes) == int(ref_one[0])
    assert disp1.tolist() == [True]


def test_churned_fleet_checkpoint_round_trips(tmp_path):
    """A churned fleet whose max degree fell keeps its sticky
    ``cdf_width`` and ``graph_version`` through ``save``/``load``, on the
    port and in the reference's reader, the CDF bit for bit."""
    core, batch = _hub_churn("lower")
    lips = _lips(core.n)
    eng = teng.WalkEngine.from_graph(core, _tparams(), lipschitz=lips,
                                     device="cpu")
    core2, churn = tg.apply_edge_churn(core, **batch)
    eng2 = eng.apply_churn(core2, churn, lipschitz=lips)
    assert eng2.cdf_width > eng2.max_degree
    fleet = tfleet.WalkFleet.create(eng2, 4, seed=2, avg_every=5)
    ckpt = fleet.checkpoint()
    assert ckpt["engine_meta"]["cdf_width"] == eng.cdf_width
    assert ckpt["engine_meta"]["graph_version"] == 1
    path = tfleet.save_fleet_checkpoint(str(tmp_path / "f.npz"), fleet,
                                        step=3)
    back, step, _ = tfleet.load_fleet_checkpoint(path, device="cpu")
    assert step == 3
    assert back.engine.cdf_width == eng2.cdf_width
    assert back.engine.graph_version == 1
    assert torch.equal(back.engine.edge_cdf, eng2.edge_cdf)
    assert torch.equal(back.nodes, fleet.nodes)
    ref_fleet, ref_step, _ = jfleet.load_fleet_checkpoint(path)
    assert ref_step == 3 and ref_fleet.engine.graph_version == 1
    assert ref_fleet.engine.cdf_width == eng2.cdf_width
    assert np.array_equal(_bits(ref_fleet.engine.edge_cdf),
                          _bits(eng2.edge_cdf))


# -- 6. Dada -------------------------------------------------------------------


def _dada_inputs(n=40, seed=2, data_seed=3):
    return (tg.barabasi_albert(n, 3, seed=seed, layout="csr"),
            jg.barabasi_albert(n, 3, seed=seed, layout="csr"),
            t_data(n, dim=5, seed=data_seed), j_data(n, dim=5, seed=data_seed))


def _dada_blocks(seed, rounds, num_steps, w, p_j=0.1, r=3):
    """The reference run_dada's per-round blocks: round rnd's fleet keys
    ``split(PRNGKey(seed + rnd), num_steps)``."""
    return [torch.from_numpy(_ref_blocks(jax.random.PRNGKey(seed + rnd),
                                         num_steps, w, r, p_j))
            for rnd in range(rounds)]


def test_personalize_models_matches_reference():
    """float32 local steps: within ``PERSONALIZE_RTOL`` of the reference
    (max |Δ| printed)."""
    _, _, d_t, d_j = _dada_inputs(200)
    x = np.random.default_rng(0).normal(size=5).astype(np.float32)
    lr = 0.5 / float(np.max(d_t.lipschitz))
    mine = tgl.personalize_models(x, d_t.features, d_t.targets,
                                  local_steps=5, lr=lr, device="cpu")
    ref = jgl.personalize_models(x, d_j.features, d_j.targets,
                                 local_steps=5, lr=lr)
    print(f"personalize max |d| {np.max(np.abs(mine - ref)):.3e}")
    np.testing.assert_allclose(mine, ref, rtol=PERSONALIZE_RTOL, atol=1e-6)
    with pytest.raises(ValueError):
        tgl.personalize_models(x, d_t.features, d_t.targets, local_steps=-1,
                               device="cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_similarity_edges_bitwise(k):
    """Given the same models, the kNN edges (the bridges of a fragmented
    kNN graph too, k=1) equal the reference's bit for bit."""
    rng = np.random.default_rng(k)
    models = np.concatenate([rng.normal(0, 0.1, (30, 4)),
                             rng.normal(5, 0.1, (30, 4))]).astype(np.float32)
    mine = tgl.similarity_edges(models, k)
    assert mine.dtype == np.int64
    assert np.array_equal(mine, jgl.similarity_edges(models, k))
    for bad_k in (0, 60):
        with pytest.raises(ValueError):
            tgl.similarity_edges(models, bad_k)


def _knn_gap(models, k):
    """Smallest gap between the k-th and (k+1)-th squared distance."""
    x = np.asarray(models, np.float64)
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, np.inf)
    s = np.sort(d2, axis=1)
    return float(np.min(s[:, k] - s[:, k - 1]))


def _same_dada(mine, ref, walk_exact=True):
    for f in ("edges_inserted", "edges_deleted", "walks_displaced",
              "graph_versions"):
        assert np.array_equal(getattr(mine, f), getattr(ref, f)), f
    np.testing.assert_allclose(mine.round_mse, ref.round_mse,
                               rtol=TRAINER_RTOL)
    np.testing.assert_allclose(mine.personalized_mse, ref.personalized_mse,
                               rtol=TRAINER_RTOL)
    np.testing.assert_allclose(mine.x_final, ref.x_final, rtol=TRAINER_RTOL,
                               atol=1e-5)


def test_run_dada_matches_reference_on_its_blocks(monkeypatch):
    """The port's ``run_dada`` on the reference's per-round blocks: edges
    inserted and deleted, walks displaced, graph versions and every
    round's update nodes equal; ``round_mse``, ``personalized_mse`` and
    ``x_final`` at the trainer tests' tolerance.  Near kNN ties could flip
    an edge: the smallest k-th/(k+1)-th gap is printed."""
    g_t, g_j, d_t, d_j = _dada_inputs()
    kw = dict(rounds=3, num_steps=40, num_walks=4, k=3, method="mhlj",
              avg_every=10, seed=5)
    seen_t, seen_j, models_t = [], [], []
    walk = tgl._walk_round
    pers = tgl.personalize_models
    monkeypatch.setattr(tgl, "_walk_round", lambda **a: seen_t.append(
        walk(**a)) or seen_t[-1])
    monkeypatch.setattr(tgl, "personalize_models", lambda *a, **b: (
        models_t.append(pers(*a, **b)) or models_t[-1]))
    j_multi = jgl.run_rw_sgd_multi
    monkeypatch.setattr(jgl, "run_rw_sgd_multi", lambda *a, **b: seen_j.append(
        j_multi(*a, **b)) or seen_j[-1])
    ref = jgl.run_dada(g_j, d_j, backend="scan", **kw)
    mine = tgl.run_dada(g_t, d_t, device="cpu",
                        uniforms=_dada_blocks(5, 3, 40, 4), **kw)
    _same_dada(mine, ref)
    assert ref.edges_inserted[:-1].sum() > 0 and ref.graph_versions[-1] == 2
    for a, b in zip(seen_t, seen_j):
        assert np.array_equal(a.update_nodes, np.asarray(b.update_nodes))
        assert np.array_equal(a.transitions, np.asarray(b.transitions))
    gaps = [_knn_gap(m, 3) for m in models_t]
    print(f"run_dada kNN: smallest k-th/(k+1)-th gap per round {gaps}")


def test_run_dada_round_one_is_plain_trainer():
    """Round one of the port's Dada loop equals a plain
    ``run_rw_sgd_multi`` on the same seed bit for bit (the port's own
    generator)."""
    g_t, _, d_t, _ = _dada_inputs()
    lips = np.asarray(d_t.lipschitz, np.float64)
    res = run_rw_sgd_multi(
        "mhlj", g_t.to_ragged(), d_t, 0.3 / float(lips.mean()), 40, 4,
        mhlj_params=ttr.MHLJParams(0.1, 0.5, 3), avg_every=10, seed=5,
        device="cpu")
    dada = tgl.run_dada(g_t, d_t, rounds=1, num_steps=40, num_walks=4, k=3,
                        avg_every=10, seed=5, device="cpu")
    assert np.array_equal(res.x_final, dada.x_final)
    assert float(res.avg_mse[-1]) == dada.round_mse[0]
    with pytest.raises(ValueError, match="mhlj"):
        tgl.run_dada(g_t, d_t, method="uniform", device="cpu")


@pytest.mark.parametrize("stream", ["seeds", "generator"])
def test_run_dada_kill_and_resume(tmp_path, monkeypatch, stream):
    """A run killed after round 2 resumes from its checkpoint at round 3
    and equals the uninterrupted run bit for bit, drawing per-round seeds
    or one generator (whose state the checkpoint carries); a rerun past
    the end returns the result; another config is refused."""
    g_t, _, d_t, _ = _dada_inputs()
    kw = dict(rounds=4, num_steps=30, num_walks=4, k=3, avg_every=10,
              seed=9, device="cpu")

    def gen():
        return torch.Generator().manual_seed(3) if stream == "generator" \
            else None

    full = tgl.run_dada(g_t, d_t, generator=gen(), **kw)
    path = str(tmp_path / "dada.npz")
    calls = []
    walk = tgl._walk_round

    def dying(**a):
        if len(calls) == 2:
            raise KeyboardInterrupt("killed")
        calls.append(1)
        return walk(**a)

    monkeypatch.setattr(tgl, "_walk_round", dying)
    with pytest.raises(KeyboardInterrupt):
        tgl.run_dada(g_t, d_t, checkpoint_path=path, generator=gen(), **kw)
    monkeypatch.setattr(tgl, "_walk_round", walk)
    _, step, _ = tfleet.load_fleet_checkpoint(path, device="cpu")
    assert step == 2
    resumed = tgl.run_dada(g_t, d_t, checkpoint_path=path, generator=gen(),
                           **kw)
    for f in ("round_mse", "personalized_mse", "edges_inserted",
              "edges_deleted", "walks_displaced", "graph_versions",
              "x_final"):
        assert np.array_equal(getattr(resumed, f), getattr(full, f)), f
    again = tgl.run_dada(g_t, d_t, checkpoint_path=path, generator=gen(),
                         **kw)
    assert np.array_equal(again.x_final, full.x_final)
    with pytest.raises(ValueError, match="different run_dada config"):
        tgl.run_dada(g_t, d_t, checkpoint_path=path,
                     **{**kw, "seed": 10})


def test_run_dada_resumes_reference_checkpoint(tmp_path, monkeypatch):
    """The reference's ``run_dada`` checkpoint after round 1 (its churned
    engine, ``graph_version`` 1) resumed by the port on the reference's
    blocks equals the reference's uninterrupted run, as
    :func:`_same_dada` holds it; the resumed rounds' update nodes equal."""
    g_t, g_j, d_t, d_j = _dada_inputs()
    kw = dict(rounds=3, num_steps=40, num_walks=4, k=3, avg_every=10, seed=5)
    seen_j = []
    j_multi = jgl.run_rw_sgd_multi
    monkeypatch.setattr(jgl, "run_rw_sgd_multi", lambda *a, **b: seen_j.append(
        j_multi(*a, **b)) or seen_j[-1])
    full = jgl.run_dada(g_j, d_j, backend="scan", **kw)
    # the reference killed in round 2: its file holds round 1's state
    path1 = str(tmp_path / "ref1.npz")
    calls = []

    def stop_after_one(*a, **b):
        if len(calls) == 1:
            raise KeyboardInterrupt("killed")
        calls.append(1)
        return j_multi(*a, **b)

    monkeypatch.setattr(jgl, "run_rw_sgd_multi", stop_after_one)
    with pytest.raises(KeyboardInterrupt):
        jgl.run_dada(g_j, d_j, backend="scan", checkpoint_path=path1, **kw)
    ref_fleet, step, _ = jfleet.load_fleet_checkpoint(path1)
    assert step == 1 and ref_fleet.engine.graph_version == 1
    seen_t = []
    walk = tgl._walk_round
    monkeypatch.setattr(tgl, "_walk_round", lambda **a: seen_t.append(
        walk(**a)) or seen_t[-1])
    mine = tgl.run_dada(g_t, d_t, device="cpu", checkpoint_path=path1,
                        uniforms=_dada_blocks(5, 3, 40, 4), **kw)
    _same_dada(mine, full)
    assert len(seen_t) == 2
    for a, b in zip(seen_t, seen_j[1:]):
        assert np.array_equal(a.update_nodes, np.asarray(b.update_nodes))


# -- 7. the law on the churned chain (slow) ------------------------------------


def _chi_square_stat(counts, probs, min_expected=10.0):
    total = counts.sum()
    expected = probs * total
    big = expected >= min_expected
    obs = np.concatenate([counts[big], [counts[~big].sum()]])
    exp = np.concatenate([expected[big], [expected[~big].sum()]])
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    return float(((obs - exp) ** 2 / exp).sum()), len(obs) - 1


def _churned_engine_and_dense():
    g = tg.barabasi_albert(48, 3, seed=1, layout="csr")
    core = g.to_ragged()
    lips = _lips(g.n)
    eng = teng.WalkEngine.from_graph(core, _tparams(), lipschitz=lips,
                                     device="cpu")
    ins, dele = _random_churn(core, np.random.default_rng(17), 6, 6)
    core, churn = tg.apply_edge_churn(core, insert=ins, delete=dele)
    eng = eng.apply_churn(core, churn, lipschitz=lips)
    pairs = _undirected_pairs(core)
    dense = tg.from_edges(core.n, pairs[:, 0], pairs[:, 1], layout="dense")
    return eng, dense, lips


@pytest.mark.slow
def test_post_churn_one_step_law_chi_square():
    """The churned engine's one-step law from the trap node, on the port's
    own generator, matches the rebuilt graph's dense ``mhlj()`` row at
    ~4 sigma."""
    eng, dense, lips = _churned_engine_and_dense()
    w = 30_000
    nodes = torch.full((w,), 5, dtype=torch.int32)
    expected = ttr.mhlj(dense, lips, _tparams())[5]
    nxt, _ = eng.step(nodes, generator=torch.Generator().manual_seed(23))
    counts = np.bincount(nxt.numpy(), minlength=dense.n).astype(np.float64)
    stat, dof = _chi_square_stat(counts, expected)
    crit = dof + 4.0 * np.sqrt(2.0 * dof)
    print(f"post-churn chi2 {stat:.1f} (dof {dof}, crit {crit:.1f})")
    assert stat < crit


@pytest.mark.slow
def test_post_churn_update_occupancy_matches_chain_pi():
    """Long-run update occupancy of the churned engine on the port's own
    generator matches the rebuilt chain's stationary pi (TV < 0.08)."""
    eng, dense, lips = _churned_engine_and_dense()
    pi = tmix.stationary_distribution(ttr.mhlj(dense, lips, _tparams()))
    rng = np.random.default_rng(29)
    v0 = torch.as_tensor(rng.choice(pi.size, size=256, p=pi).astype(np.int32))
    nodes, _ = eng.run(v0, 800, generator=torch.Generator().manual_seed(31))
    emp = empirical_distribution(nodes.T.numpy(), dense.n)
    tv = tmix.tv_distance(emp, pi)
    print(f"post-churn TV(emp, mhlj-pi) {tv:.4f}")
    assert tv < 0.08
