"""Port parity: the degree-bucketed graph layout, the new graph families,
and the dense, padded and per-bucket row builders.

All host-side numpy in both packages, so every array must agree bit for
bit on the same seeds.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import graphs as jg
from repro.core import transition as jtr
from repro_torch.core import graphs as tg
from repro_torch.core import transition as ttr

FAMILIES = [
    ("ring", lambda m, layout, f=2: m.ring(64, layout=layout, bucket_factor=f)),
    ("grid2d", lambda m, layout, f=2: m.grid2d(8, layout=layout, bucket_factor=f)),
    ("grid2d_rect", lambda m, layout, f=2: m.grid2d(5, 7, layout=layout,
                                                   bucket_factor=f)),
    ("ba", lambda m, layout, f=2: m.barabasi_albert(400, 3, seed=0,
                                                    layout=layout,
                                                    bucket_factor=f)),
    ("sbm", lambda m, layout, f=2: m.sbm([40] * 3, 0.2, 0.01, seed=0,
                                         layout=layout, bucket_factor=f)),
    ("dumbbell", lambda m, layout, f=2: m.dumbbell(12, 3, layout=layout,
                                                   bucket_factor=f)),
]
IDS = [f[0] for f in FAMILIES]
CORE = ("indptr", "indices", "degrees")


def _same(a, b, fields):
    assert type(a).__name__ == type(b).__name__
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name


def _same_buckets(a, b):
    _same(a, b, CORE + ("node_bucket", "node_slot"))
    assert (a.min_width, a.bucket_factor) == (b.min_width, b.bucket_factor)
    assert a.bucket_widths == b.bucket_widths
    for x, y in zip(a.buckets, b.buckets):
        assert x.width == y.width
        np.testing.assert_array_equal(x.node_ids, y.node_ids)
        np.testing.assert_array_equal(x.neighbors, y.neighbors)
        assert x.node_ids.dtype == y.node_ids.dtype
        assert x.neighbors.dtype == y.neighbors.dtype


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
@pytest.mark.parametrize("bucket_factor", [2, 4])
def test_bucketed_families_bitwise(fam, bucket_factor):
    _, build = fam
    ref = build(jg, "bucketed", bucket_factor)
    port = build(tg, "bucketed", bucket_factor)
    _same_buckets(ref, port)
    port.validate()
    assert port.max_degree == ref.max_degree and port.n == ref.n
    assert port.num_edges == ref.num_edges
    v = int(np.argmax(port.degrees))
    np.testing.assert_array_equal(port.row(v), ref.row(v))


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
@pytest.mark.parametrize("layout", ["dense", "csr", "ragged"])
def test_new_families_other_layouts_bitwise(fam, layout):
    _, build = fam
    ref, port = build(jg, layout), build(tg, layout)
    fields = {
        "dense": ("adj", "neighbors", "degrees"),
        "csr": CORE + ("neighbors",),
        "ragged": CORE,
    }[layout]
    _same(ref, port, fields)


@pytest.mark.parametrize("n,p,seed", [(60, 0.1, 0), (40, 0.2, 3)])
def test_erdos_renyi_bitwise(n, p, seed):
    ref, port = jg.erdos_renyi(n, p, seed=seed), tg.erdos_renyi(n, p, seed=seed)
    _same(ref, port, ("adj", "neighbors", "degrees"))


@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_bucketed_conversions_bitwise(fam):
    """to_bucketed / to_csr / to_ragged / to_dense round trips, from every
    sparse class, bit for bit against the reference's."""
    _, build = fam
    ref_csr, port_csr = build(jg, "csr"), build(tg, "csr")
    for f in (2, 4):
        _same_buckets(ref_csr.to_bucketed(bucket_factor=f),
                      port_csr.to_bucketed(bucket_factor=f))
        _same_buckets(ref_csr.to_ragged().to_bucketed(bucket_factor=f),
                      port_csr.to_ragged().to_bucketed(bucket_factor=f))
    bk = port_csr.to_bucketed()
    assert bk.to_bucketed() is bk
    _same_buckets(ref_csr.to_bucketed().to_bucketed(bucket_factor=4),
                  bk.to_bucketed(bucket_factor=4))
    _same(port_csr, bk.to_csr(), CORE + ("neighbors",))
    _same(ref_csr.to_bucketed().to_ragged(), bk.to_ragged(), CORE)
    if port_csr.n <= 400:
        _same(ref_csr.to_dense(), port_csr.to_dense(),
              ("adj", "neighbors", "degrees"))
        _same(ref_csr.to_dense(), bk.to_dense(), ("adj", "neighbors", "degrees"))
        _same(ref_csr.to_dense(), port_csr.to_ragged().to_dense(),
              ("adj", "neighbors", "degrees"))


def test_bucket_ladder_and_rows_are_truncations():
    for args in ((1196, 8, 2), (1196, 8, 4), (7, 8, 2), (64, 8, 2), (65, 3, 3)):
        np.testing.assert_array_equal(
            tg._bucket_widths_ladder(*args), jg._bucket_widths_ladder(*args)
        )
    for bad in ((10, 0, 2), (10, 8, 1)):
        with pytest.raises(ValueError):
            tg._bucket_widths_ladder(*bad)
    g = tg.barabasi_albert(400, 3, seed=0, layout="csr")
    bk = g.to_bucketed()
    assert len(bk.buckets) >= 3
    for b in bk.buckets:
        np.testing.assert_array_equal(
            b.neighbors, g.neighbors[b.node_ids][:, : b.width]
        )


def test_bucketed_validate_rejects_bad_tables():
    bk = tg.barabasi_albert(200, 3, seed=2, layout="bucketed")
    bk.validate()
    b0 = bk.buckets[0]
    bad_rows = dataclasses.replace(
        b0, neighbors=np.roll(b0.neighbors, 1, axis=1)
    )
    cases = [
        dataclasses.replace(bk, buckets=(bad_rows,) + bk.buckets[1:]),
        dataclasses.replace(bk, buckets=bk.buckets[::-1]),
        dataclasses.replace(bk, node_slot=np.zeros_like(bk.node_slot)),
        dataclasses.replace(bk, node_bucket=np.zeros_like(bk.node_bucket)),
        dataclasses.replace(bk, buckets=bk.buckets[1:]),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case.validate()


DENSE_LAWS = [
    ("simple", lambda m, g, lips: m.simple_rw(g)),
    ("uniform", lambda m, g, lips: m.mh_uniform(g)),
    ("importance", lambda m, g, lips: m.mh_importance(g, lips)),
    ("mh_pi", lambda m, g, lips: m.mh(g, lips ** 2)),
]
DENSE_GRAPHS = [
    ("ba", lambda m: m.barabasi_albert(120, 3, seed=1)),
    ("grid2d", lambda m: m.grid2d(6)),
    ("er", lambda m: m.erdos_renyi(50, 0.15, seed=2)),
    ("dumbbell", lambda m: m.dumbbell(6, 2)),
]


def _lips(n, seed=0):
    lips = np.exp(np.random.default_rng(seed).normal(size=n))
    lips[n // 3] = 40.0
    return lips


@pytest.mark.parametrize("law", DENSE_LAWS, ids=[x[0] for x in DENSE_LAWS])
@pytest.mark.parametrize("gr", DENSE_GRAPHS, ids=[x[0] for x in DENSE_GRAPHS])
def test_dense_laws_and_padded_gather_bitwise(law, gr):
    _, build = gr
    _, fn = law
    g_ref, g_port = build(jg), build(tg)
    lips = _lips(g_port.n)
    p_ref, p_port = fn(jtr, g_ref, lips), fn(ttr, g_port, lips)
    np.testing.assert_array_equal(p_ref, p_port)
    assert ttr.is_row_stochastic(p_port)
    assert ttr.supported_on_graph(p_port, g_port)
    np.testing.assert_array_equal(
        jtr.row_probs_padded(p_ref, g_ref), ttr.row_probs_padded(p_port, g_port)
    )


PADDED_LAWS = [
    ("simple", "simple_rw_rows", lambda fn, g, lips: fn(g)),
    ("uniform", "mh_uniform_rows", lambda fn, g, lips: fn(g)),
    ("importance", "mh_importance_rows", lambda fn, g, lips: fn(g, lips)),
]


@pytest.mark.parametrize("law", PADDED_LAWS, ids=[x[0] for x in PADDED_LAWS])
@pytest.mark.parametrize("fam", FAMILIES, ids=IDS)
def test_padded_and_bucketed_rows_bitwise(law, fam):
    _, name, call = law
    _, build = fam
    g_ref, g_port = build(jg, "csr"), build(tg, "csr")
    lips = _lips(g_port.n, 4)
    padded = call(getattr(ttr, name), g_port, lips)
    np.testing.assert_array_equal(call(getattr(jtr, name), g_ref, lips), padded)
    for f in (2, 4):
        b_ref = call(getattr(jtr, name + "_bucketed"),
                     g_ref.to_bucketed(bucket_factor=f), lips)
        bk = g_port.to_bucketed(bucket_factor=f)
        b_port = call(getattr(ttr, name + "_bucketed"), bk, lips)
        assert len(b_ref) == len(b_port) == len(bk.buckets)
        for x, y, b in zip(b_ref, b_port, bk.buckets):
            np.testing.assert_array_equal(x, y)
            # each bucket row is the column truncation of the padded row
            np.testing.assert_array_equal(y, padded[b.node_ids][:, : b.width])
    flat = call(getattr(ttr, name + "_ragged"), g_port.to_ragged(), lips)
    np.testing.assert_array_equal(
        flat, tg.flat_edge_values(g_port.indptr, g_port.degrees, padded)
    )


def test_dense_law_checks_reject_bad_input():
    g = tg.ring(8)
    with pytest.raises(ValueError, match="pi must have shape"):
        ttr.mh(g, np.ones(7))
    with pytest.raises(ValueError, match="strictly positive"):
        ttr.mh(g, np.zeros(8))
    with pytest.raises(ValueError, match="row-stochastic"):
        ttr.mh(g, np.ones(8), q=np.full((8, 8), 0.5))
    with pytest.raises(ValueError, match="non-edges"):
        ttr.mh(g, np.ones(8), q=np.full((8, 8), 1.0 / 8))
    with pytest.raises(ValueError, match="proposal q must have shape"):
        ttr.mh(g, np.ones(8), q=np.eye(4))
    with pytest.raises(ValueError, match="lipschitz"):
        ttr.mh_importance(g, np.ones(3))
    with pytest.raises(ValueError, match="1-hop"):
        ttr.row_probs_padded(np.full((8, 8), 1.0 / 8), g)
    q = ttr.simple_rw(g)
    np.testing.assert_array_equal(
        ttr.mh(g, np.arange(1.0, 9.0), q=q),
        jtr.mh(jg.ring(8), np.arange(1.0, 9.0), q=q),
    )
    assert not ttr.is_row_stochastic(np.full((3, 3), 0.5))
