"""Port parity: the heterogeneity-aware and private chain laws, and the
online Lipschitz estimator.

``repro_torch.core.heterogeneity`` and the laws' row functions are host
numpy copies of the reference's, so every array is held with ``==`` on
numpy-seeded inputs: the dissimilarity matrix, the simplex projection,
the optimized target, the Gamma noise and the rows of both laws on all
four layouts plus the dense law, on every graph family.  The online
Lipschitz update is gathers, scatters and elementwise float32 math, held
bit for bit too.  The fingerprint is a float32 dot product whose
reduction order differs between XLA and torch; on the reference's own
projections it is held at ``rtol=1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jg
from repro.core import heterogeneity as jhet
from repro.core import importance as jimp
from repro.core import transition as jtr
from repro.data import make_heterogeneous_regression as j_data
from repro_torch.core import graphs as tg
from repro_torch.core import heterogeneity as thet
from repro_torch.core import importance as timp
from repro_torch.core import transition as ttr
from repro_torch.data import make_heterogeneous_regression as t_data

FAMILIES = {
    "ring": lambda m, layout: m.ring(30, layout=layout),
    "grid2d": lambda m, layout: m.grid2d(5, 6, layout=layout),
    "ba": lambda m, layout: m.barabasi_albert(60, 3, seed=1, layout=layout),
    "dumbbell": lambda m, layout: m.dumbbell(8, 3, layout=layout),
    "lollipop": lambda m, layout: m.lollipop(10, 6, layout=layout),
    "sbm": lambda m, layout: m.sbm([20, 20], 0.3, 0.05, seed=2, layout=layout),
}
ROW_LAYOUTS = ("csr", "bucketed", "ragged")


def _data(m, n, seed=5):
    return m(n, dim=5, sigma_high_sq=100.0, p_high=0.05, seed=seed,
             force_min_high=2, x_star_scale=3.0)


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- core/heterogeneity.py ----------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 4), (3, 7, 4)])
def test_pairwise_dissimilarity_matches_reference(shape):
    grads = np.random.default_rng(0).normal(size=shape)
    _equal(thet.pairwise_gradient_dissimilarity(grads),
           jhet.pairwise_gradient_dissimilarity(grads))
    with pytest.raises(ValueError, match="num_probes"):
        thet.pairwise_gradient_dissimilarity(np.zeros((2, 2, 2, 2)))


@pytest.mark.parametrize("num_probes", [1, 4])
def test_measure_and_optimize_match_reference(num_probes):
    d_ref, d_port = _data(j_data, 40), _data(t_data, 40)
    h_ref = jhet.measure_dissimilarity(d_ref, num_probes=num_probes, seed=3)
    h = thet.measure_dissimilarity(d_port, num_probes=num_probes, seed=3)
    _equal(h, h_ref)
    _equal(thet.mean_dissimilarity(h), jhet.mean_dissimilarity(h_ref))
    _equal(thet.optimal_pi_closed_form(h), jhet.optimal_pi_closed_form(h_ref))
    for floor in (0.0, 0.25):
        _equal(thet.optimize_pi(h, floor=floor, steps=60),
               jhet.optimize_pi(h_ref, floor=floor, steps=60))
    init = np.random.default_rng(1).random(40)
    _equal(thet.optimize_pi(h, steps=10, init=init),
           jhet.optimize_pi(h_ref, steps=10, init=init))
    _equal(thet.heterogeneity_pi(d_port, num_probes=num_probes, steps=30),
           jhet.heterogeneity_pi(d_ref, num_probes=num_probes, steps=30))


def test_simplex_projection_and_degenerate_cases_match_reference():
    rng = np.random.default_rng(2)
    for floor in (0.0, 0.1, 0.9):
        v = rng.normal(size=25)
        pi = thet.project_to_simplex(v, floor)
        _equal(pi, jhet.project_to_simplex(v, floor))
        assert abs(pi.sum() - 1.0) < 1e-12 and pi.min() >= floor / 25 - 1e-15
    zero = np.zeros((6, 6))
    _equal(thet.optimize_pi(zero), jhet.optimize_pi(zero))
    _equal(thet.optimal_pi_closed_form(zero), jhet.optimal_pi_closed_form(zero))
    for bad, match in ((lambda: thet.project_to_simplex(np.ones(3), 1.0),
                        "floor"),
                       (lambda: thet.mean_dissimilarity(-np.ones((3, 3))),
                        "nonnegative"),
                       (lambda: thet.mean_dissimilarity(np.ones((3, 2))),
                        "square"),
                       (lambda: thet.optimize_pi(np.ones((3, 3)), steps=-1),
                        "steps"),
                       (lambda: thet.measure_dissimilarity(
                           _data(t_data, 10), num_probes=0), "num_probes")):
        with pytest.raises(ValueError, match=match):
            bad()


# -- core/transition.py: the two laws on every layout -------------------------


@pytest.mark.parametrize("gamma", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("seed", [0, 7])
def test_private_weights_match_reference(gamma, seed):
    w = np.exp(np.random.default_rng(seed).normal(size=50))
    _equal(ttr.private_weights(w, gamma, seed=seed),
           jtr.private_weights(w, gamma, seed=seed))
    for bad, match in (((w[:, None], 0.1), "weights"),
                       ((-w, 0.1), "positive"), ((w, -1.0), "gamma")):
        with pytest.raises(ValueError, match=match):
            ttr.private_weights(*bad)


def _targets(n):
    rng = np.random.default_rng(n)
    lips = np.exp(rng.normal(size=n))
    pi = thet.project_to_simplex(rng.random(n), 0.25)
    return lips, pi


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_law_rows_match_reference_on_every_layout(family):
    """Dense law, padded, bucketed and flat ragged rows of both laws."""
    g_ref = FAMILIES[family](jg, "dense")
    g_port = FAMILIES[family](tg, "dense")
    lips, pi = _targets(g_ref.n)
    _equal(ttr.heterogeneity_mh(g_port, pi), jtr.heterogeneity_mh(g_ref, pi))
    for gamma in (0.1, 1.0):
        _equal(ttr.private_weighted_mh(g_port, lips, gamma, seed=3),
               jtr.private_weighted_mh(g_ref, lips, gamma, seed=3))
    _equal(ttr.heterogeneity_rows(g_port, pi), jtr.heterogeneity_rows(g_ref, pi))
    for layout in ROW_LAYOUTS:
        g_ref = FAMILIES[family](jg, layout)
        g_port = FAMILIES[family](tg, layout)
        sfx = {"csr": "", "bucketed": "_bucketed", "ragged": "_ragged"}[layout]
        _equal(getattr(ttr, "heterogeneity_rows" + sfx)(g_port, pi),
               getattr(jtr, "heterogeneity_rows" + sfx)(g_ref, pi))
        _equal(getattr(ttr, "private_weighted_rows" + sfx)(
                   g_port, lips, 0.5, seed=1),
               getattr(jtr, "private_weighted_rows" + sfx)(
                   g_ref, lips, 0.5, seed=1))


def test_law_rows_refuse_bad_targets():
    g = tg.ring(10, layout="ragged")
    for bad, match in ((np.ones(9), "shape"), (np.zeros(10), "positive")):
        with pytest.raises(ValueError, match=match):
            ttr.heterogeneity_rows_ragged(g, bad)
    with pytest.raises(ValueError, match="shape"):
        ttr.private_weighted_rows_ragged(g, np.ones(9), 0.1)


# -- core/importance.py ---------------------------------------------------------


def test_importance_weights_match_reference():
    lips = np.exp(np.random.default_rng(4).normal(size=333))
    port = timp.importance_weights(lips)
    ref = np.asarray(jimp.importance_weights(lips))
    assert port.dtype == torch.float32
    _equal(port.numpy(), ref)


def test_online_lipschitz_update_matches_reference():
    """A sequence of secant updates, revisits included, bit for bit."""
    rng = np.random.default_rng(6)
    n = 12
    ref = jimp.online_lipschitz_init(n, init=2.0, proj_seed=3)
    port = timp.online_lipschitz_init(n, init=2.0, proj_seed=3, device="cpu")
    kw = dict(ema=0.8, clip_min=1e-2, clip_max=50.0)
    for _ in range(40):
        node = int(rng.integers(0, n))
        g, f = np.float32(rng.gamma(2.0)), np.float32(rng.normal())
        if rng.random() < 0.1:
            f = np.float32(0.0)  # the 1e-8 floor of the denominator
        ref = jimp.online_lipschitz_update(ref, jnp.int32(node), g, f, **kw)
        port = timp.online_lipschitz_update(port, node, g, f, **kw)
    for name in ("lipschitz", "last_grad_norm", "last_param_fingerprint",
                 "visited"):
        _equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    assert port.proj_seed == ref.proj_seed == 3
    assert 0 < int(port.visited.sum()) <= n


def test_param_fingerprint_on_reference_projections():
    """The fingerprint of a module's parameters, or a list of tensors, with
    the reference's ``jax.random.normal`` projections injected."""
    rng = np.random.default_rng(8)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((6, 5), (5,), (3, 2, 4))]
    seed = timp.FINGERPRINT_SEED
    base = jax.random.PRNGKey(seed)
    proj = [np.array(jax.random.normal(jax.random.fold_in(base, i), x.shape,
                                         dtype=jnp.float32))
            for i, x in enumerate(leaves)]
    ref = float(jimp.param_fingerprint(leaves, seed=seed))
    tensors = [torch.from_numpy(x) for x in leaves]
    port = timp.param_fingerprint(tensors, projections=proj)
    assert port.dtype == torch.float32 and port.shape == ()
    np.testing.assert_allclose(float(port), ref, rtol=1e-6)

    module = torch.nn.Linear(5, 6)
    with torch.no_grad():
        module.weight.copy_(tensors[0])
        module.bias.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
    own = timp.param_fingerprint(module, seed=4)
    assert float(own) == float(timp.param_fingerprint(module, seed=4))
    assert float(own) != float(timp.param_fingerprint(module, seed=5))
    with pytest.raises(ValueError, match="projections"):
        timp.param_fingerprint(tensors, projections=proj[:2])
