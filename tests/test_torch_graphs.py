"""Port parity: the host-side numpy substrate of ``repro_torch``.

Graphs, chain-law rows, synthetic data, fleet seeding, schedules and the
Lévy law's constants are numpy in both packages and must agree bit for
bit on the same seeds.
"""
import numpy as np
import pytest
import torch

from repro.core import graphs as jg
from repro.core import importance as jimp
from repro.core import levy as jlevy
from repro.core import schedules as jsched
from repro.core import transition as jtr
from repro.data import synthetic as jsyn
from repro.walk_sgd.fleet import sample_initial_nodes as j_sample
from repro_torch.core import graphs as tg
from repro_torch.core import importance as timp
from repro_torch.core import levy as tlevy
from repro_torch.core import schedules as tsched
from repro_torch.core import transition as ttr
from repro_torch.data import synthetic as tsyn
from repro_torch.walk_sgd.fleet import sample_initial_nodes as t_sample


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


FAMILIES = [
    ("ring", lambda m, layout: m.ring(40, layout=layout)),
    ("ba", lambda m, layout: m.barabasi_albert(300, 3, seed=5, layout=layout)),
    ("ba_m1", lambda m, layout: m.barabasi_albert(64, 1, seed=1, layout=layout)),
    ("dumbbell", lambda m, layout: m.dumbbell(8, 3, layout=layout)),
    ("dumbbell_direct", lambda m, layout: m.dumbbell(5, 0, layout=layout)),
]


def _assert_same_arrays(a, b, fields):
    assert type(a).__name__ == type(b).__name__
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


@pytest.mark.parametrize("fam", FAMILIES, ids=[f[0] for f in FAMILIES])
@pytest.mark.parametrize("layout", ["dense", "csr", "ragged"])
def test_graph_families_bitwise(fam, layout):
    _, build = fam
    ref, port = build(jg, layout), build(tg, layout)
    fields = {
        "dense": ("adj", "neighbors", "degrees"),
        "csr": ("indptr", "indices", "degrees", "neighbors"),
        "ragged": ("indptr", "indices", "degrees"),
    }[layout]
    _assert_same_arrays(ref, port, fields)
    port.validate()


def test_graph_conversions_bitwise():
    ref = jg.barabasi_albert(200, 2, seed=3, layout="csr")
    port = tg.barabasi_albert(200, 2, seed=3, layout="csr")
    _assert_same_arrays(
        ref.to_ragged(), port.to_ragged(), ("indptr", "indices", "degrees")
    )
    _assert_same_arrays(
        ref.to_ragged().to_csr(), port.to_ragged().to_csr(),
        ("indptr", "indices", "degrees", "neighbors"),
    )
    dense = tg.ring(12)
    _assert_same_arrays(
        jg.ring(12).to_csr(), dense.to_csr(),
        ("indptr", "indices", "degrees", "neighbors"),
    )


def test_flat_edge_values_and_chunks_bitwise():
    g = jg.barabasi_albert(500, 3, seed=2, layout="csr")
    rng = np.random.default_rng(0)
    table = rng.random(g.neighbors.shape).astype(np.float32)
    ids = np.arange(17, 230, dtype=np.int64)
    np.testing.assert_array_equal(
        jg.flat_edge_values(g.indptr, g.degrees, table),
        tg.flat_edge_values(g.indptr, g.degrees, table),
    )
    np.testing.assert_array_equal(
        jg.flat_edge_values(g.indptr, g.degrees, table[ids], node_ids=ids),
        tg.flat_edge_values(g.indptr, g.degrees, table[ids], node_ids=ids),
    )
    for n, width, chunk in ((500, 40, None), (100_000, 3000, None), (900, 7, 64)):
        a = list(jg._ragged_row_chunks(n, width, chunk))
        b = list(tg._ragged_row_chunks(n, width, chunk))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        jg._pad_neighbor_lists(g.indptr, g.indices, g.degrees, ids, 50),
        tg._pad_neighbor_lists(g.indptr, g.indices, g.degrees, ids, 50),
    )


def test_graph_validation_rejects_bad_input():
    with pytest.raises(ValueError):
        tg.ring(2)
    with pytest.raises(ValueError):
        tg.barabasi_albert(10, 10)
    with pytest.raises(ValueError):
        tg.from_edges(4, [0, 1], [1, 2])  # node 3 disconnected
    with pytest.raises(ValueError):
        tg.from_edges(4, [0], [7])
    with pytest.raises(ValueError, match="layout must be one of"):
        tg.ring(10, layout="blocked")


LAWS = [
    ("simple", lambda m, g, lips: m.simple_rw_rows_ragged(g)),
    ("uniform", lambda m, g, lips: m.mh_uniform_rows_ragged(g)),
    ("importance", lambda m, g, lips: m.mh_importance_rows_ragged(g, lips)),
    (
        "importance_chunked",
        lambda m, g, lips: m.mh_importance_rows_ragged(g, lips, chunk_rows=37),
    ),
]


@pytest.mark.parametrize("law", LAWS, ids=[l[0] for l in LAWS])
@pytest.mark.parametrize("fam", FAMILIES[:4], ids=[f[0] for f in FAMILIES[:4]])
def test_ragged_rows_bitwise(law, fam):
    _, build = fam
    _, rows = law
    g_ref, g_port = build(jg, "ragged"), build(tg, "ragged")
    lips = np.exp(np.random.default_rng(4).normal(size=g_ref.n))
    lips[g_ref.n // 3] = 80.0
    a, b = rows(jtr, g_ref, lips), rows(ttr, g_port, lips)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_rows_reject_bad_lipschitz():
    g = tg.ring(10, layout="ragged")
    with pytest.raises(ValueError):
        ttr.mh_importance_rows_ragged(g, np.ones(9))
    with pytest.raises(ValueError):
        ttr.mh_importance_rows_ragged(g, np.zeros(10))
    with pytest.raises(ValueError):
        ttr.MHLJParams(p_j=1.5).validate()


@pytest.mark.parametrize(
    "kind,kwargs",
    [
        ("het", dict(n=300, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
                     x_star_scale=3.0)),
        ("het_default", dict(n=64, seed=1)),
        ("het_pinned", dict(n=20, dim=4, high_nodes=np.array([1, 5]), seed=2)),
        ("hom", dict(n=50, dim=3, sigma_sq=2.0, seed=3)),
    ],
)
def test_synthetic_data_bitwise(kind, kwargs):
    name = (
        "make_homogeneous_regression" if kind == "hom"
        else "make_heterogeneous_regression"
    )
    a = getattr(jsyn, name)(**kwargs)
    b = getattr(tsyn, name)(**kwargs)
    for f in ("features", "targets", "x_star", "lipschitz",
              "high_variance_mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    x = np.linspace(-1, 1, a.dim)
    assert a.mse(x) == b.mse(x)


def test_importance_measures_bitwise():
    feats = np.random.default_rng(9).normal(size=(40, 5))
    np.testing.assert_array_equal(
        jimp.linear_regression_lipschitz(feats),
        timp.linear_regression_lipschitz(feats),
    )
    np.testing.assert_array_equal(
        jimp.logistic_regression_lipschitz(feats),
        timp.logistic_regression_lipschitz(feats),
    )
    lips = timp.linear_regression_lipschitz(feats)
    np.testing.assert_array_equal(
        jimp.importance_distribution(lips), timp.importance_distribution(lips)
    )
    with pytest.raises(ValueError):
        timp.importance_distribution(np.array([1.0, 0.0]))


@pytest.mark.parametrize(
    "n,w,seed,v0s",
    [(100, 8, 0, None), (10, 32, 3, None), (500, 2048, 1, None),
     (30, 3, 0, [0, 29, 4])],
)
def test_sample_initial_nodes_bitwise(n, w, seed, v0s):
    a = j_sample(n, w, seed=seed, v0s=v0s)
    b = t_sample(n, w, seed=seed, v0s=v0s)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_sample_initial_nodes_rejects_bad_input():
    with pytest.raises(ValueError):
        t_sample(0, 4)
    with pytest.raises(ValueError):
        t_sample(10, 2, v0s=[1, 10])
    with pytest.raises(ValueError):
        t_sample(10, 3, v0s=[1, 2])


@pytest.mark.parametrize(
    "name,args",
    [
        ("constant", (0.1, 50)),
        ("polynomial_decay", (0.3, 100, 0.7, 5)),
        ("step_decay", (0.2, 90, 10, 0.5)),
        ("linear_to_zero", (0.25, 77, 0.6)),
    ],
)
def test_schedules_bitwise(name, args):
    a, b = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p_d,r", [(0.5, 3), (0.1, 10), (0.3, 1), (0.05, 16)])
def test_levy_constants(p_d, r):
    np.testing.assert_array_equal(
        jlevy.trunc_geom_pmf(p_d, r), tlevy.trunc_geom_pmf(p_d, r)
    )
    _assert_levy_means_equal(p_d, r, (0.0, 0.1, 0.7, 1.0))
    for p_j in (0.0, 0.1, 0.7, 1.0):
        assert tlevy.remark1_bound(p_j, p_d, r) == jlevy.remark1_bound(
            p_j, p_d, r
        )


def _assert_levy_means_equal(p_d, r, p_js):
    """E[D] and the Remark-1 count equal the reference's bit for bit for
    r >= 2; at r=1 both are exactly 1.0 (the reference's E[D] may round to
    0.9999999999999999 there, a reference fault the port does not copy)."""
    mean = tlevy.trunc_geom_mean(p_d, r)
    assert mean == (1.0 if r == 1 else jlevy.trunc_geom_mean(p_d, r))
    for p_j in p_js:
        got = tlevy.expected_transitions_per_update(p_j, p_d, r)
        want = (1.0 if r == 1
                else jlevy.expected_transitions_per_update(p_j, p_d, r))
        assert got == want, (p_j, p_d, r, got, want)
        assert got >= 1.0


@pytest.mark.parametrize("r", range(1, 21))
def test_levy_means_bitwise_on_grid(r):
    """p_d in {0.01, ..., 0.99} x r in 1..20 x p_J in {0, ..., 1}."""
    for p_d in np.round(np.arange(1, 100) * 0.01, 2):
        _assert_levy_means_equal(float(p_d), r,
                                 (0.0, 0.05, 0.1, 0.3, 0.5, 0.7, 1.0))


def test_remark1_bound_holds_including_r1():
    """1 <= exact <= bound on a grid that includes r=1 (where E[D] = 1)."""
    for p_j in np.linspace(0.0, 1.0, 11):
        for p_d in np.linspace(0.05, 0.95, 19):
            for r in (1, 2, 3, 7, 20):
                exact = tlevy.expected_transitions_per_update(p_j, p_d, r)
                bound = tlevy.remark1_bound(p_j, p_d, r)
                assert 1.0 <= exact <= bound + 1e-12
    assert tlevy.trunc_geom_mean(0.3, 1) == 1.0
