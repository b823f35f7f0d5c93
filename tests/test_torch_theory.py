"""Port parity: the chain analysis of the paper's reproduction.

The Lévy matrices, the dense MHLJ law, the five graph families the paper
path adds, and all of ``mixing``, ``entrapment``, ``theory`` and
``comm_model`` are host numpy in both packages, so the port must give the
reference's arrays and numbers exactly — held with ``==`` and
``assert_array_equal``, never a tolerance.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import entrapment as jent
from repro.core import graphs as jg
from repro.core import levy as jlevy
from repro.core import mixing as jmix
from repro.core import theory as jthe
from repro.core import transition as jtr
from repro.walk_sgd import comm_model as jcomm
from repro_torch.core import entrapment as tent
from repro_torch.core import graphs as tg
from repro_torch.core import levy as tlevy
from repro_torch.core import mixing as tmix
from repro_torch.core import theory as tthe
from repro_torch.core import transition as ttr
from repro_torch.walk_sgd import comm_model as tcomm

# dense graphs of the paper path, built by each package (m = module)
FAMILIES = {
    "ring": lambda m: m.ring(24),
    "grid2d": lambda m: m.grid2d(4, 6),
    "ws": lambda m: m.watts_strogatz(30, 4, 0.1, 0),
    "ba": lambda m: m.barabasi_albert(40, 3, seed=1, layout="dense"),
    "sbm": lambda m: m.sbm([12, 12], 0.4, 0.05, seed=2, layout="dense"),
    "dumbbell": lambda m: m.dumbbell(6, 4, layout="dense"),
    "lollipop": lambda m: m.lollipop(8, 6, layout="dense"),
}


def _lips(n, seed=0):
    lips = np.exp(np.random.default_rng(seed).normal(size=n))
    lips[n // 2] = 60.0
    return lips


def _assert_same_graph(a, b):
    assert a.name == b.name
    for field in ("adj", "neighbors", "degrees", "indptr", "indices"):
        if hasattr(a, field):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            assert getattr(a, field).dtype == getattr(b, field).dtype


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_levy_matrices_and_mhlj_bitwise(family):
    g_ref, g_port = FAMILIES[family](jg), FAMILIES[family](tg)
    _assert_same_graph(g_ref, g_port)
    lips = _lips(g_ref.n)
    for p_d, r in ((0.5, 3), (0.2, 1), (0.7, 5)):
        np.testing.assert_array_equal(
            jlevy.levy_weights(p_d, r), tlevy.levy_weights(p_d, r))
        np.testing.assert_array_equal(
            jlevy.levy_matrix(g_ref, p_d, r), tlevy.levy_matrix(g_port, p_d, r))
        np.testing.assert_array_equal(
            jlevy.levy_matrix_chained(g_ref, p_d, r),
            tlevy.levy_matrix_chained(g_port, p_d, r))
    for p_j in (0.0, 0.1, 1.0):
        for chained in (True, False):
            np.testing.assert_array_equal(
                jtr.mhlj(g_ref, lips, jtr.MHLJParams(p_j, 0.5, 3),
                         chained_levy=chained),
                ttr.mhlj(g_port, lips, ttr.MHLJParams(p_j, 0.5, 3),
                         chained_levy=chained))


def test_mhlj_rejects_bad_params():
    g = tg.ring(8)
    with pytest.raises(ValueError, match="p_j"):
        ttr.mhlj(g, np.ones(8), ttr.MHLJParams(1.5, 0.5, 3))
    with pytest.raises(ValueError, match="p_d"):
        ttr.mhlj(g, np.ones(8), ttr.MHLJParams(0.1, 1.0, 3))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_new_families_bitwise(seed):
    constructions = [
        lambda m: m.watts_strogatz(50, 4, 0.1, seed),
        lambda m: m.watts_strogatz(40, 6, 0.3, seed),
        lambda m: m.expander(20, 6, seed=seed),
        lambda m: m.expander(16, 3, seed=seed),
        lambda m: m.star(5 + seed),
        lambda m: m.complete(4 + seed),
    ] + [
        (lambda layout: lambda m: m.lollipop(4 + seed, 3 + seed, layout=layout))(
            layout)
        for layout in ("dense", "csr", "bucketed", "ragged")
    ]
    for build in constructions:
        _assert_same_graph(build(jg), build(tg))


def test_watts_strogatz_retry_matches(monkeypatch):
    """WS(12, 2, 0.5) at seed 2 disconnects on its first draw, so both
    packages retry at seed 3 and must land on the same graph."""
    seeds = []
    orig = tg.watts_strogatz

    def counting(n, k, p, seed=0):
        seeds.append(seed)
        return orig(n, k, p, seed=seed)

    monkeypatch.setattr(tg, "watts_strogatz", counting)
    g_port = tg.watts_strogatz(12, 2, 0.5, 2)
    assert seeds == [2, 3]
    _assert_same_graph(jg.watts_strogatz(12, 2, 0.5, 2), g_port)


def test_new_families_reject_bad_arguments():
    with pytest.raises(ValueError, match="even k"):
        tg.watts_strogatz(10, 3, 0.1)
    with pytest.raises(ValueError, match="even n"):
        tg.expander(11)
    with pytest.raises(ValueError, match="clique_n"):
        tg.lollipop(2, 3)
    with pytest.raises(ValueError, match="path_len"):
        tg.lollipop(4, 0)


def _chains():
    """(tag, P) pairs: MH-IS and MHLJ on each family, built by both."""
    for family, build in sorted(FAMILIES.items()):
        g_ref, g_port = build(jg), build(tg)
        lips = _lips(g_ref.n, seed=3)
        params = (jtr.MHLJParams(0.2, 0.5, 3), ttr.MHLJParams(0.2, 0.5, 3))
        yield (f"{family}-is", jtr.mh_importance(g_ref, lips),
               ttr.mh_importance(g_port, lips))
        yield (f"{family}-mhlj", jtr.mhlj(g_ref, lips, params[0]),
               ttr.mhlj(g_port, lips, params[1]))


def test_mixing_bitwise():
    for tag, p_ref, p_port in _chains():
        np.testing.assert_array_equal(p_ref, p_port, err_msg=tag)
        pi_ref = jmix.stationary_distribution(p_ref)
        pi_port = tmix.stationary_distribution(p_port)
        np.testing.assert_array_equal(pi_ref, pi_port, err_msg=tag)
        assert jmix.is_reversible(p_ref) == tmix.is_reversible(p_port), tag
        assert jmix.spectral_gap(p_ref) == tmix.spectral_gap(p_port), tag
        uniform = np.full(len(pi_ref), 1.0 / len(pi_ref))
        assert (jmix.tv_distance(pi_ref, uniform)
                == tmix.tv_distance(pi_port, uniform)), tag
        for eps in (0.25, 0.05):
            assert (jmix.mixing_time_tv(p_ref, eps=eps)
                    == tmix.mixing_time_tv(p_port, eps=eps)), tag
        assert (jmix.mixing_time_bounds(p_ref)
                == tmix.mixing_time_bounds(p_port)), tag
        assert jmix.conductance(p_ref) == tmix.conductance(p_port), tag


@pytest.mark.parametrize("p, max_t", [
    (np.eye(4), 64),  # reducible: TV to pi never decays
    (np.array([[0.0, 1.0], [1.0, 0.0]]), 128),  # periodic 2-cycle
])
def test_not_mixed_error_matches(p, max_t):
    with pytest.raises(jmix.NotMixedError) as ref:
        jmix.mixing_time_tv(p, max_t=max_t)
    with pytest.raises(tmix.NotMixedError) as port:
        tmix.mixing_time_tv(p, max_t=max_t)
    assert (port.value.max_t, port.value.worst_tv, port.value.eps) == (
        ref.value.max_t, ref.value.worst_tv, ref.value.eps)
    assert str(port.value) == str(ref.value)
    assert isinstance(port.value, RuntimeError)


def test_entrapment_bitwise():
    rng = np.random.default_rng(5)
    for tag, p_ref, p_port in _chains():
        n = p_ref.shape[0]
        for fn in ("escape_probability", "expected_dwell_time", "trap_score"):
            np.testing.assert_array_equal(
                getattr(jent, fn)(p_ref), getattr(tent, fn)(p_port),
                err_msg=f"{tag} {fn}")
        traj = rng.integers(0, n, size=(3, 500))
        np.testing.assert_array_equal(
            jent.visit_fractions(traj, n), tent.visit_fractions(traj, n))
        for topk in (1, 3):
            assert (jent.occupancy_concentration(traj, n, topk=topk)
                    == tent.occupancy_concentration(traj, n, topk=topk)), tag


@pytest.mark.parametrize("traj, n", [
    (np.array([0, 1, 5]), 5),  # id >= n
    (np.array([0, -1, 2]), 5),  # negative id
    (np.array([], dtype=np.int64), 5),  # empty
])
def test_visit_fractions_range_check(traj, n):
    with pytest.raises(ValueError) as ref:
        jent.visit_fractions(traj, n)
    with pytest.raises(ValueError) as port:
        tent.visit_fractions(traj, n)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("family", ["ring", "ws", "dumbbell", "lollipop"])
def test_theorem1_terms_field_by_field(family):
    g_ref, g_port = FAMILIES[family](jg), FAMILIES[family](tg)
    lips = _lips(g_ref.n, seed=4)
    for p_j in (0.1, 0.3):
        ref = jthe.theorem1_terms(g_ref, lips, jtr.MHLJParams(p_j, 0.5, 3),
                                  num_iters=10_000)
        port = tthe.theorem1_terms(g_port, lips, ttr.MHLJParams(p_j, 0.5, 3),
                                   num_iters=10_000)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (jthe.perturbation_l1(g_ref, lips, jtr.MHLJParams(p_j, 0.5, 3))
                == tthe.perturbation_l1(g_port, lips,
                                        ttr.MHLJParams(p_j, 0.5, 3)))
    m = np.random.default_rng(1).normal(size=(7, 7))
    assert jthe.matrix_l1_norm(m) == tthe.matrix_l1_norm(m)


def test_error_gap_over_fig6_sweep():
    """Fig. 6's closed-form p_J sweep: the same gaps, bit for bit."""
    n = 64
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, 6)) * np.where(rng.random(n) < 0.1, 2.0, 1.0)[:, None]
    targs = feats @ (3 * rng.normal(size=6)) + rng.normal(size=n)
    lips = 2 * (feats**2).sum(1)
    g_ref, g_port = jg.ring(n), tg.ring(n)
    gaps = []
    for pj in (0.2, 0.1, 0.05, 0.025, 0.0125, 0.0):
        ref = jthe.error_gap_exact(g_ref, feats, targs, lips,
                                   jtr.MHLJParams(pj, 0.5, 3))
        port = tthe.error_gap_exact(g_port, feats, targs, lips,
                                    ttr.MHLJParams(pj, 0.5, 3))
        assert port == ref, pj
        gaps.append(port)
    assert all(a > b for a, b in zip(gaps, gaps[1:]))  # shrinks with p_J
    nu = np.random.default_rng(2).dirichlet(np.ones(n))
    np.testing.assert_array_equal(
        jthe.regression_fixed_point(feats, targs, nu, lips.mean() / lips),
        tthe.regression_fixed_point(feats, targs, nu, lips.mean() / lips))


def test_needell_rates_bitwise():
    for seed in range(3):
        lips = np.exp(np.random.default_rng(seed).normal(size=100))
        for t in (1, 10_000):
            assert jthe.needell_rates(lips, t) == tthe.needell_rates(lips, t)


def test_comm_model_bitwise():
    rng = np.random.default_rng(3)
    comm_ref, comm_port = jcomm.CommModel(4096), tcomm.CommModel(4096)
    for p_j, p_d, r in ((0.1, 0.5, 3), (0.3, 0.2, 5), (0.0, 0.5, 2)):
        hops = rng.integers(1, r + 1, size=2000)
        for comm in (None, "with"):
            assert jcomm.comm_report(
                hops, p_j, p_d, r, comm and comm_ref
            ) == tcomm.comm_report(hops, p_j, p_d, r, comm and comm_port)
    for w, steps, every, d in ((1, 100, 10, 1), (8, 1000, 50, 4),
                               (3, 1000, 0, 8), (16, 0, 5, 2)):
        for comm in (None, "with"):
            ref = jcomm.fleet_averaging_traffic(
                w, steps, every, 1 << 20, mesh_devices=d,
                comm=comm and comm_ref)
            port = tcomm.fleet_averaging_traffic(
                w, steps, every, 1 << 20, mesh_devices=d,
                comm=comm and comm_port)
            assert port == ref
    with pytest.raises(ValueError, match="num_walks"):
        tcomm.fleet_averaging_traffic(0, 10, 1, 8)
