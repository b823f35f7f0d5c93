"""Port parity: the trainers under the heterogeneity and private laws, and
the law sweep (``repro_torch.paper.law_sweep``).

The reference trains at ``engine_kwargs={"backend": "scan"}`` (its Pallas
walk kernels do not trace under jax 0.9.0); its uniform blocks are drawn
exactly as its fleet draws them and injected into the port
(``tests/test_torch_trainer.py::_fleet_blocks``).  Every graph of the
trainer tests keeps its rows at most 17 wide, where XLA's row cumsum
equals the port's sequential row CDF, so the update nodes and hops are
held bit for bit on each layout, and the MSE traces at the trainer's
``rtol=1e-4``.  The law sweep's smoke tier adds BA(48,3), whose hub rows
are 20 wide: its picks are held bit for bit too (a differing last bit
moves a pick only when a threshold falls between the two sums).
"""
import numpy as np
import pytest
import torch

from benchmarks import law_sweep as ref_sweep
from repro.core import graphs as jg
from repro.core import heterogeneity as jhet
from repro.data import make_heterogeneous_regression as j_data
from repro.walk_sgd import run_rw_sgd as j_run
from repro.walk_sgd import run_rw_sgd_multi as j_run_multi
from repro_torch.core import graphs as tg
from repro_torch.data import make_heterogeneous_regression as t_data
from repro_torch.paper import law_sweep
from repro_torch.walk_sgd import run_rw_sgd, run_rw_sgd_multi
from test_torch_paper import ReferenceBlocks, assert_same
from test_torch_trainer import _fleet_blocks

MSE_RTOL = 1e-4
STEPS = 150

# graph class -> the layout the trainer picks; "dense" runs a CSRGraph on
# the engine's dense layout
LAYOUTS = {
    "sparse": ("dense", None),
    "csr": ("csr", None),
    "dense": ("csr", "dense"),
    "bucketed": ("bucketed", None),
    "ragged": ("ragged", None),
}
LAWS = {
    "heterogeneity_pi": ("heterogeneity", lambda d: {
        "pi": jhet.project_to_simplex(d.lipschitz / d.lipschitz.sum(), 0.25)}),
    "heterogeneity_measured": ("heterogeneity", lambda d: {
        "num_probes": 3, "steps": 40}),
    "private": ("private", lambda d: {"gamma": 0.5, "noise_seed": 2}),
}


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _graph(m, graph_layout):
    return m.dumbbell(8, 4, layout=graph_layout)


def _data(m, n):
    return m(n, dim=5, sigma_high_sq=100.0, p_high=0.1, seed=9,
             force_min_high=2, x_star_scale=3.0)


def _kwargs(layout):
    _, engine_layout = LAYOUTS[layout]
    ref = {"backend": "scan"}
    port = None
    if engine_layout is not None:
        ref["layout"] = engine_layout
        port = {"layout": engine_layout}
    return ref, port


@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_run_rw_sgd_law_matches_reference(law, layout):
    graph_layout, _ = LAYOUTS[layout]
    g_ref, g_port = _graph(jg, graph_layout), _graph(tg, graph_layout)
    d_ref, d_port = _data(j_data, g_ref.n), _data(t_data, g_port.n)
    method, law_kwargs = LAWS[law]
    law_kwargs = law_kwargs(d_ref)
    gamma = float(0.2 / d_ref.lipschitz.max())
    ref_kw, port_kw = _kwargs(layout)
    ref = j_run(method, g_ref, d_ref, gamma, STEPS, v0=3, seed=5,
                engine_kwargs=ref_kw, law_kwargs=law_kwargs)
    blocks = _fleet_blocks(5, STEPS, 1, 1, np.zeros(STEPS, np.float32))
    port = run_rw_sgd(method, g_port, d_port, gamma, STEPS, v0=3, seed=5,
                      engine_kwargs=port_kw, law_kwargs=law_kwargs,
                      uniforms=torch.from_numpy(blocks), device="cpu")
    np.testing.assert_array_equal(port.update_nodes, ref.update_nodes)
    np.testing.assert_array_equal(port.transitions, ref.transitions)
    np.testing.assert_allclose(port.mse, ref.mse, rtol=MSE_RTOL)
    np.testing.assert_allclose(port.x_final, ref.x_final, rtol=MSE_RTOL,
                               atol=1e-5)
    assert len(set(port.update_nodes.tolist())) > 3  # the walk moves


@pytest.mark.parametrize("law", ["heterogeneity_pi", "private"])
@pytest.mark.parametrize("layout", ["sparse", "bucketed", "ragged"])
def test_run_rw_sgd_multi_law_matches_reference(law, layout):
    graph_layout, _ = LAYOUTS[layout]
    g_ref, g_port = _graph(jg, graph_layout), _graph(tg, graph_layout)
    d_ref, d_port = _data(j_data, g_ref.n), _data(t_data, g_port.n)
    method, law_kwargs = LAWS[law]
    law_kwargs = law_kwargs(d_ref)
    gamma = float(0.2 / d_ref.lipschitz.max())
    w, avg_every = 6, 7
    ref = j_run_multi(method, g_ref, d_ref, gamma, STEPS, w,
                      avg_every=avg_every, seed=1,
                      engine_kwargs={"backend": "scan"},
                      law_kwargs=law_kwargs)
    blocks = _fleet_blocks(1, STEPS, w, 1, np.zeros(STEPS, np.float32))
    port = run_rw_sgd_multi(method, g_port, d_port, gamma, STEPS, w,
                            avg_every=avg_every, seed=1,
                            law_kwargs=law_kwargs,
                            uniforms=torch.from_numpy(blocks), device="cpu")
    np.testing.assert_array_equal(port.update_nodes, ref.update_nodes)
    np.testing.assert_array_equal(port.transitions, ref.transitions)
    np.testing.assert_allclose(port.mse, ref.mse, rtol=MSE_RTOL)
    np.testing.assert_allclose(port.avg_mse, ref.avg_mse, rtol=MSE_RTOL)


def test_law_kwargs_checks_match_reference():
    g = tg.ring(12, layout="ragged")
    data = _data(t_data, 12)
    for method, kw, match in (
        ("mhlj", {"gamma": 0.1}, "not consumed"),
        ("heterogeneity", {"pi": np.ones(12), "floor": 0.1}, "besides pi"),
        ("private", {"sigma": 1.0}, "unknown private"),
        ("heterogeneity", {"pi": np.zeros(12)}, "positive"),
    ):
        with pytest.raises(ValueError, match=match):
            run_rw_sgd(method, g, data, 0.01, 5, law_kwargs=kw, device="cpu")


def test_law_weights_follow_the_chain_target():
    """w = mean(target) / target: the optimized pi for the heterogeneity
    law, the noised weights for the private law (never the true L_v)."""
    from repro_torch.core import transition as ttr
    from repro_torch.walk_sgd import trainer as ttrain

    g = tg.ring(12, layout="ragged")
    data = _data(t_data, 12)
    pi = np.linspace(1.0, 2.0, 12) / np.linspace(1.0, 2.0, 12).sum()
    _, w_het, *_ = ttrain._setup_method("heterogeneity", g, data, None, None,
                                        5, {"pi": pi})
    np.testing.assert_array_equal(w_het, (pi.mean() / pi).astype(np.float32))
    _, w_priv, *_ = ttrain._setup_method("private", g, data, None, None, 5,
                                         {"gamma": 1.0})
    w_hat = ttr.private_weights(data.lipschitz, 1.0)
    np.testing.assert_array_equal(w_priv,
                                  (w_hat.mean() / w_hat).astype(np.float32))


def test_law_sweep_smoke_matches_reference():
    """Every law on every smoke family, on the reference's blocks:
    Herfindahl and top-3 shares equal, MSE milestones at rtol 1e-4."""
    blocks = ReferenceBlocks()
    port = law_sweep.run_smoke(device="cpu", blocks=blocks)
    ref = ref_sweep.run(scale="smoke")
    assert_same(ref, port, mse_keys=())
    assert (law_sweep.NAME, law_sweep.PAPER_CLAIM) == (ref_sweep.NAME,
                                                       ref_sweep.PAPER_CLAIM)
    assert law_sweep.LAWS == ref_sweep.LAWS
    assert len(blocks.calls) == 3 * len(law_sweep.LAWS)
    assert {c[5] for c in blocks.calls} == {1, 3}  # r: the jump law's is 3
    for scale in ("smoke", "quick", "full"):
        for tag, g in ref_sweep._graphs(scale).items():
            np.testing.assert_array_equal(
                law_sweep._graphs(scale)[tag].neighbors, g.neighbors)
