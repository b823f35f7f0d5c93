"""Port parity: the fleet loop and the RW-SGD trainer.

The reference trains with per-step keys ``split(key, total)[start:]``
(``repro/walk_sgd/fleet.py``), one uniform block per key with slot 0
replaced by the flag ``u < p_j``.  Those blocks are drawn with the
reference and injected into the port, and the port gets the reference's
own per-edge CDF through ``repro_torch.interop``.  The walk (update nodes
and hop counts) must then agree bit for bit; the MSE traces agree to
``rtol=1e-4``, because float32 reductions run in another order and the
reference's ``jax.grad`` is not the port's closed-form gradient.
"""
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
from repro.walk_sgd import fleet as jfleet
from repro.walk_sgd import run_rw_sgd as j_run
from repro.walk_sgd import run_rw_sgd_multi as j_run_multi
from repro_torch import interop
from repro_torch.core import graphs as tg
from repro_torch.core import levy as tlevy
from repro_torch.core.transition import MHLJParams
from repro_torch.data import make_heterogeneous_regression as t_data
from repro_torch.models import regression as treg
from repro_torch.walk_sgd import fleet as tfleet
from repro_torch.walk_sgd import run_rw_sgd, run_rw_sgd_multi

PARAMS = (0.1, 0.5, 3)  # (p_j, p_d, r)
STEPS = 200


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


GRAPHS = {
    "ring": lambda m: m.ring(64, layout="ragged"),
    "ba": lambda m: m.barabasi_albert(300, 3, seed=0, layout="ragged"),
}


def _data(m, n):
    return m(n, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
             x_star_scale=3.0)


def _key_streams(k, pj, w, r, fault_nodes=None):
    """One step's streams from the reference's step key ``k``: the ``(W, 3 +
    r)`` block, slot 0 -> ``u < pj``; with ``fault_nodes=n`` a faulted
    step's three (``repro/walk_sgd/fleet.py`` ``_fleet_scan``,
    ``repro/core/engine.py`` ``step``): ``key_t, key_f = split(k)``,
    ``key_t`` split again into the walk's key and the rescue's, returning
    ``(block, Markov (n,) uniforms from key_f, rescue (W,) uniforms)``."""
    def block(key):
        u = jax.random.uniform(key, (w, jeng.num_uniforms(r)), jnp.float32)
        return u.at[:, 0].set((u[:, 0] < pj).astype(jnp.float32))

    if fault_nodes is None:
        return block(k)
    key_t, key_f = jax.random.split(k)
    key_w, key_r = jax.random.split(key_t)
    return (block(key_w),
            jax.random.uniform(key_f, (fault_nodes,), jnp.float32),
            jax.random.uniform(key_r, (w,), jnp.float32))


def _fleet_blocks(seed, total, w, r, p_j_sched, start=0, fault_nodes=None):
    """Blocks as the reference fleet draws them: ``split(key, total)[start:]``,
    one :func:`_key_streams` per key.  Returns the blocks ``(T, W, 3 + r)``,
    or with ``fault_nodes=n`` ``(blocks, Markov uniforms (T, n), rescue
    uniforms (T, W))``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), total)
    keys = keys[start:start + len(p_j_sched)]
    out = jax.vmap(lambda k, pj: _key_streams(k, pj, w, r, fault_nodes))(
        keys, jnp.asarray(p_j_sched, jnp.float32))
    if fault_nodes is None:
        return np.array(out)
    return tuple(np.array(x) for x in out)


def _serve_blocks(seed, ticks, w, r, p_j, *, n=None, markov=False,
                  rescue=False):
    """The walk streams of the reference's ``ServeSimulator``: tick ``t``
    keys ``fold_in(PRNGKey(seed), t)`` (``repro/launch/serve.py`` ``tick``);
    under faults (``n``, the node count) the faulted step's three streams
    of that key.  Returns the dict ``ServeSimulator.inject`` takes: the
    Markov uniforms only when ``markov``, the rescue's only when
    ``rescue``."""
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda t: jax.random.fold_in(base, t))(jnp.arange(ticks))
    pj = jnp.float32(p_j)
    out = jax.vmap(lambda k: _key_streams(k, pj, w, r, n))(keys)
    if n is None:
        return {"uniforms": np.array(out)}
    u, fu, ru = (np.array(x) for x in out)
    return {"uniforms": u, "fault_uniforms": fu if markov else None,
            "rescue_uniforms": ru if rescue else None}


def _port_engine(g, rows, p_d, r):
    """The port's engine over the reference's own CDF (via interop)."""
    cdf = np.asarray(
        jeng.ragged_edge_cdf(g.indptr, g.indices, g.degrees, row_probs=rows)
    )
    eng, _, _ = interop.from_reference_state(
        indptr=g.indptr, indices=g.indices, degrees=g.degrees, edge_cdf=cdf,
        max_degree=int(g.degrees.max()), cdf_width=int(g.degrees.max()),
        p_d=p_d, r=r, device="cpu",
    )
    return eng


def _no_d_mismatch(blocks, p_d, r):
    d_ref = np.asarray(jlevy.trunc_geom_icdf(jnp.asarray(blocks[..., 2]), p_d, r))
    d_port = tlevy.trunc_geom_icdf(torch.from_numpy(blocks[..., 2]), p_d, r)
    bad = (d_ref != d_port.numpy()) & (blocks[..., 0] > 0.5)
    return not bad.any()


@pytest.mark.parametrize("graph", ["ring", "ba"])
def test_run_rw_sgd_multi_matches_reference(graph):
    p_j, p_d, r = PARAMS
    g_ref, g_port = GRAPHS[graph](jg), GRAPHS[graph](tg)
    d_ref, d_port = _data(j_data, g_ref.n), _data(t_data, g_port.n)
    gamma = float(0.3 / d_ref.lipschitz.mean())
    w, avg_every = 8, 5
    ref = j_run_multi(
        "mhlj", g_ref, d_ref, gamma, STEPS, w,
        mhlj_params=jtr.MHLJParams(p_j, p_d, r), avg_every=avg_every, seed=0,
        engine_kwargs={"backend": "scan"},
    )
    blocks = _fleet_blocks(0, STEPS, w, r, np.full(STEPS, p_j, np.float32))
    assert _no_d_mismatch(blocks, p_d, r)
    rows = jtr.mh_importance_rows_ragged(g_ref, d_ref.lipschitz)
    port = run_rw_sgd_multi(
        "mhlj", g_port, d_port, gamma, STEPS, w,
        mhlj_params=MHLJParams(p_j, p_d, r), avg_every=avg_every, seed=0,
        engine=_port_engine(g_ref, rows, p_d, r),
        uniforms=torch.from_numpy(blocks), device="cpu",
    )
    np.testing.assert_array_equal(port.update_nodes, ref.update_nodes)
    np.testing.assert_array_equal(port.transitions, ref.transitions)
    np.testing.assert_allclose(port.mse, ref.mse, rtol=1e-4)
    np.testing.assert_allclose(port.avg_mse, ref.avg_mse, rtol=1e-4)
    np.testing.assert_allclose(port.x_final, ref.x_final, rtol=1e-4, atol=1e-5)
    assert port.avg_mse[-1] < 0.5 * port.avg_mse[0]


@pytest.mark.parametrize("method", ["uniform", "simple", "importance"])
def test_run_rw_sgd_matches_reference(method):
    """The W=1 case, over the non-jump laws (engine at p_J = 0, r = 1)."""
    g_ref, g_port = GRAPHS["ba"](jg), GRAPHS["ba"](tg)
    d_ref, d_port = _data(j_data, g_ref.n), _data(t_data, g_port.n)
    gamma = float(0.3 / d_ref.lipschitz.mean())
    steps = 150
    ref = j_run(
        method, g_ref, d_ref, gamma, steps, v0=5, seed=3,
        engine_kwargs={"backend": "scan"},
    )
    blocks = _fleet_blocks(3, steps, 1, 1, np.zeros(steps, np.float32))
    rows = {
        "uniform": lambda: jtr.mh_uniform_rows_ragged(g_ref),
        "simple": lambda: jtr.simple_rw_rows_ragged(g_ref),
        "importance": lambda: jtr.mh_importance_rows_ragged(
            g_ref, d_ref.lipschitz
        ),
    }[method]()
    port = run_rw_sgd(
        method, g_port, d_port, gamma, steps, v0=5, seed=3,
        engine=_port_engine(g_ref, rows, 0.5, 1),
        uniforms=torch.from_numpy(blocks), device="cpu",
    )
    np.testing.assert_array_equal(port.update_nodes, ref.update_nodes)
    np.testing.assert_array_equal(port.transitions, ref.transitions)
    assert port.transitions.max() == 1
    np.testing.assert_allclose(port.mse, ref.mse, rtol=1e-4)


def test_trainer_own_rng_converges_and_counts_hops():
    g = GRAPHS["ba"](tg)
    data = _data(t_data, g.n)
    gamma = float(0.3 / data.lipschitz.mean())
    res = run_rw_sgd_multi(
        "mhlj", g, data, gamma, 300, 8, mhlj_params=MHLJParams(*PARAMS),
        avg_every=5, seed=1, device="cpu",
    )
    assert np.isfinite(res.avg_mse).all()
    assert res.avg_mse[-1] < 0.2 * res.avg_mse[0]
    exact = tlevy.expected_transitions_per_update(*PARAMS)
    assert abs(res.transitions_per_update - exact) < 0.05
    again = run_rw_sgd_multi(
        "mhlj", g, data, gamma, 300, 8, mhlj_params=MHLJParams(*PARAMS),
        avg_every=5, seed=1, device="cpu",
    )
    np.testing.assert_array_equal(res.update_nodes, again.update_nodes)
    sched = np.linspace(0.5, 0.0, 300).astype(np.float32)
    annealed = run_rw_sgd(
        "mhlj", g, data, gamma, 300, p_j_schedule=sched, seed=2, device="cpu"
    )
    assert annealed.transitions[-30:].max() == 1


def test_trainer_rejects_bad_arguments():
    g = tg.ring(10, layout="ragged")
    data = _data(t_data, 10)
    with pytest.raises(ValueError, match="method"):
        run_rw_sgd("nope", g, data, 0.01, 5, device="cpu")
    with pytest.raises(ValueError, match="p_j_schedule"):
        run_rw_sgd("mhlj", g, data, 0.01, 5, p_j_schedule=np.zeros(4),
                   device="cpu")
    with pytest.raises(ValueError, match="loss"):
        run_rw_sgd("simple", g, data, 0.01, 5, loss="hinge", device="cpu")
    with pytest.raises(ValueError, match="uniforms"):
        run_rw_sgd("simple", g, data, 0.01, 5, device="cpu",
                   uniforms=torch.zeros(5, 2, 4))


def test_regression_gradients_match_autograd(monkeypatch):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(5, 4)), dtype=torch.float64,
                     requires_grad=True)
    a = torch.tensor(rng.normal(size=(5, 4)), dtype=torch.float64)
    y = torch.tensor(rng.normal(size=5), dtype=torch.float64)
    for loss, grad in ((treg.linear_loss, treg.linear_grad),
                       (treg.logistic_loss, treg.logistic_grad)):
        (auto,) = torch.autograd.grad(loss(x, a, y).sum(), x)
        torch.testing.assert_close(grad(x.detach(), a, y), auto)
    feats = torch.tensor(rng.normal(size=(1000, 4)))
    targs = torch.tensor(rng.normal(size=1000))
    xs = torch.tensor(rng.normal(size=(3, 4)))
    full = ((targs[:, None] - feats @ xs.T) ** 2).mean(dim=0)
    monkeypatch.setattr(treg, "MSE_CHUNK_ROWS", 128)
    torch.testing.assert_close(treg.mse_objective(xs, feats, targs), full)
    torch.testing.assert_close(
        treg.mse_objective(xs[1], feats, targs), full[1]
    )


def test_interop_carries_fleet_and_models():
    g = jg.ring(20, layout="ragged")
    rows = jtr.mh_uniform_rows_ragged(g)
    cdf = np.asarray(
        jeng.ragged_edge_cdf(g.indptr, g.indices, g.degrees, row_probs=rows)
    )
    nodes = np.array([0, 5, 19], np.int32)
    models = np.arange(6, dtype=np.float32).reshape(3, 2)
    eng, fleet, xs = interop.from_reference_state(
        indptr=g.indptr, indices=g.indices, degrees=g.degrees, edge_cdf=cdf,
        max_degree=3, cdf_width=3, p_d=0.5, r=2, nodes=nodes, models=models,
        avg_every=4, device="cpu",
    )
    assert fleet.num_walks == 3 and fleet.avg_every == 4
    np.testing.assert_array_equal(fleet.nodes.numpy(), nodes)
    np.testing.assert_array_equal(xs.numpy(), models)
    assert eng.indptr.dtype == torch.int32 and eng.edge_cdf.dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    nxt, hops = fleet.engine.step(fleet.nodes, generator=gen, p_j=0.5)
    assert nxt.shape == (3,) and hops.shape == (3,)
    with pytest.raises(ValueError):
        interop.from_reference_state(
            indptr=g.indptr, indices=g.indices, degrees=g.degrees,
            edge_cdf=cdf[:-1], max_degree=3, cdf_width=3, p_d=0.5, r=2,
            device="cpu",
        )
    avg = tfleet.fleet_average(torch.tensor([[1.0, 2.0], [3.0, 6.0]]))
    torch.testing.assert_close(avg, torch.tensor([[2.0, 4.0], [2.0, 4.0]]))


@pytest.mark.parametrize("do_avg", [None, True, False])
def test_fleet_average_matches_reference(do_avg):
    """``fleet_average(xs, do_avg)``: the reference's traced ``do_avg``
    (``repro/walk_sgd/fleet.py`` ``fleet_average``) as a 0-d device bool,
    the mean where it holds, else ``xs``."""
    xs = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32)
    ref = jfleet.fleet_average(
        jnp.asarray(xs), None if do_avg is None else jnp.asarray(do_avg))
    port = tfleet.fleet_average(
        torch.from_numpy(xs), None if do_avg is None else torch.tensor(do_avg))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    if do_avg is False:
        np.testing.assert_array_equal(port.numpy(), xs)


ADVANCE_GRAPHS = {
    "ring": lambda m: m.ring(64, layout="ragged"),
    "grid2d": lambda m: m.grid2d(8, 8, layout="ragged"),
    "ba": lambda m: m.barabasi_albert(40, 2, seed=1, layout="ragged"),
}


@pytest.mark.parametrize("graph", sorted(ADVANCE_GRAPHS))
def test_fleet_advance_matches_reference(graph):
    """Three ``WalkFleet.advance`` calls on the reference's blocks (its
    ``step`` draws from the key itself) walk as the reference's fleet
    does, bit for bit (``advance(faults=)``: ``tests/test_torch_faults.py``)."""
    p_j, p_d, r = 0.3, 0.5, 3
    g_ref = ADVANCE_GRAPHS[graph](jg)
    lips = np.exp(np.random.default_rng(3).normal(size=g_ref.n))
    rows = jtr.mh_importance_rows_ragged(g_ref, lips)
    ref_eng = jeng.WalkEngine.from_graph(
        g_ref, jtr.MHLJParams(p_j, p_d, r), row_probs=rows, backend="scan")
    ref = jfleet.WalkFleet.create(ref_eng, 12, seed=2)
    port = tfleet.WalkFleet.create(_port_engine(g_ref, rows, p_d, r), 12,
                                   seed=2)
    np.testing.assert_array_equal(port.nodes.numpy(), np.asarray(ref.nodes))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref, hops_ref = ref.advance(key, p_j=p_j)
        u = jax.random.uniform(key, (12, jeng.num_uniforms(r)), jnp.float32)
        u = np.array(u.at[:, 0].set((u[:, 0] < p_j).astype(jnp.float32)))
        assert _no_d_mismatch(u, p_d, r)
        port, hops = port.advance(uniforms=torch.from_numpy(u))
        np.testing.assert_array_equal(port.nodes.numpy(),
                                      np.asarray(ref.nodes))
        np.testing.assert_array_equal(hops.numpy(), np.asarray(hops_ref))
    gen = torch.Generator().manual_seed(0)
    moved, hops = port.advance(generator=gen, p_j=1.0)
    assert moved.num_walks == 12 and int(hops.min()) >= 1
