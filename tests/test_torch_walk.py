"""Port parity: the walk simulators of ``repro_torch.core.walk``.

``walk_mhlj`` / ``walk_mhlj_batched`` are the engine's ``run``, so they
are held bit for bit against the reference's (backend ``scan``) on blocks
drawn exactly as the reference's ``WalkEngine.run`` draws them:
``split(key, T)``, one ``(W, 3 + r)`` uniform per key, slot 0 -> the flag
``u < p_j[t]``.  The graphs keep every padded row at most 17 wide, where
the reference's cumsum equals the port's sequential row CDF.

The reference's ``walk_markov`` draws by a Gumbel categorical, whose
stream the port cannot match; the port's is the engine at p_J = 0 on the
same rows, held by law: chi-square and TV against the dense chain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import engine as jeng
from repro.core import graphs as jg
from repro.core import levy as jlevy
from repro.core import transition as jtr
from repro.core import walk as jwalk
from repro_torch.core import graphs as tg
from repro_torch.core import levy as tlevy
from repro_torch.core import mixing as tmix
from repro_torch.core import transition as ttr
from repro_torch.core import walk as twalk

GRAPHS = {
    "ring": lambda m: m.ring(24),
    "grid2d": lambda m: m.grid2d(5, 6),
    "sbm": lambda m: m.sbm([16, 16], 0.3, 0.03, seed=1, layout="dense"),
    "lollipop": lambda m: m.lollipop(8, 10, layout="dense"),
}


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ref_blocks(key, num_steps, w, r, p_j):
    keys = jax.random.split(key, num_steps)
    p = jnp.broadcast_to(jnp.asarray(p_j, jnp.float32), (num_steps,))

    def one(k, pj):
        u = jax.random.uniform(k, (w, jeng.num_uniforms(r)), jnp.float32)
        return u.at[:, jeng.U_JUMP].set((u[:, jeng.U_JUMP] < pj).astype(jnp.float32))

    return np.array(jax.vmap(one)(keys, p))


def _no_d_mismatch(u, p_d, r):
    d_ref = np.asarray(jlevy.trunc_geom_icdf(jnp.asarray(u[..., 2]), p_d, r))
    d_port = tlevy.trunc_geom_icdf(torch.from_numpy(u[..., 2]), p_d, r).numpy()
    return not ((d_ref != d_port) & (u[..., 0] > 0.5)).any()


def _setup(tag):
    g_ref, g_port = GRAPHS[tag](jg), GRAPHS[tag](tg)
    assert int(g_ref.degrees.max()) <= 17
    lips = np.exp(np.random.default_rng(3).normal(size=g_ref.n))
    lips[g_ref.n // 3] = 40.0
    rows = jtr.row_probs_padded(jtr.mh_importance(g_ref, lips), g_ref)
    np.testing.assert_array_equal(
        rows, ttr.row_probs_padded(ttr.mh_importance(g_port, lips), g_port))
    return g_ref, g_port, lips, rows


def test_graph_tensors_match():
    for tag in GRAPHS:
        g_ref, g_port = GRAPHS[tag](jg), GRAPHS[tag](tg)
        nbrs_ref, deg_ref = jwalk.graph_tensors(g_ref)
        nbrs, deg = twalk.graph_tensors(g_port, device="cpu")
        np.testing.assert_array_equal(np.asarray(nbrs_ref), nbrs.numpy())
        np.testing.assert_array_equal(np.asarray(deg_ref), deg.numpy())
        assert nbrs.dtype == deg.dtype == torch.int32
    with pytest.raises(TypeError, match="padded neighbor"):
        twalk.graph_tensors(tg.ring(8, layout="bucketed"), device="cpu")
    with pytest.raises(TypeError, match="padded neighbor"):
        twalk.graph_tensors(tg.ring(8, layout="ragged"), device="cpu")


@pytest.mark.parametrize("tag", sorted(GRAPHS))
@pytest.mark.parametrize("schedule", [False, True])
def test_walk_mhlj_bitwise(tag, schedule):
    g_ref, g_port, _, rows = _setup(tag)
    p_j, p_d, r, steps = 0.2, 0.5, 3, 300
    if schedule:
        p_j = np.linspace(0.5, 0.0, steps, dtype=np.float32)
    key = jax.random.PRNGKey(len(tag) + 10 * schedule)
    v0 = g_ref.n // 2
    ref_nodes, ref_hops = jwalk.walk_mhlj(
        key, jnp.asarray(rows), *jwalk.graph_tensors(g_ref), v0, steps,
        jnp.asarray(p_j), p_d, r,
    )
    blocks = _ref_blocks(key, steps, 1, r, p_j)
    assert _no_d_mismatch(blocks, p_d, r)
    nbrs, deg = twalk.graph_tensors(g_port, device="cpu")
    nodes, hops = twalk.walk_mhlj(
        torch.from_numpy(rows), nbrs, deg, v0, steps, p_j, p_d, r,
        uniforms=torch.from_numpy(blocks),
    )
    assert nodes.shape == hops.shape == (steps,)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(ref_nodes))
    np.testing.assert_array_equal(hops.numpy(), np.asarray(ref_hops))
    # a (T, 3 + r) block for the single walk is the same walk
    nodes2, _ = twalk.walk_mhlj(
        torch.from_numpy(rows), nbrs, deg, v0, steps, p_j, p_d, r,
        uniforms=torch.from_numpy(blocks[:, 0]),
    )
    np.testing.assert_array_equal(nodes2.numpy(), nodes.numpy())


@pytest.mark.parametrize("tag", sorted(GRAPHS))
def test_walk_mhlj_batched_bitwise(tag):
    g_ref, g_port, _, rows = _setup(tag)
    p_j, p_d, r, steps, w = 0.3, 0.4, 4, 120, 33
    key = jax.random.PRNGKey(7 + len(tag))
    v0s = np.random.default_rng(1).integers(0, g_ref.n, size=w).astype(np.int32)
    ref_nodes, ref_hops = jwalk.walk_mhlj_batched(
        key, jnp.asarray(rows), *jwalk.graph_tensors(g_ref), jnp.asarray(v0s),
        steps, p_j, p_d, r, backend="scan",
    )
    blocks = _ref_blocks(key, steps, w, r, p_j)
    assert _no_d_mismatch(blocks, p_d, r)
    nbrs, deg = twalk.graph_tensors(g_port, device="cpu")
    nodes, hops = twalk.walk_mhlj_batched(
        torch.from_numpy(rows), nbrs, deg, torch.from_numpy(v0s), steps,
        p_j, p_d, r, uniforms=torch.from_numpy(blocks),
    )
    assert nodes.shape == (w, steps)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(ref_nodes))
    np.testing.assert_array_equal(hops.numpy(), np.asarray(ref_hops))


def _law(tag, law):
    g = GRAPHS[tag](tg)
    lips = np.exp(np.random.default_rng(3).normal(size=g.n))
    lips[g.n // 3] = 40.0
    p = {"simple": lambda: ttr.simple_rw(g),
         "uniform": lambda: ttr.mh_uniform(g),
         "importance": lambda: ttr.mh_importance(g, lips)}[law]()
    return g, p


@pytest.mark.parametrize("tag", ["ring", "grid2d", "lollipop"])
@pytest.mark.parametrize("law", ["simple", "uniform", "importance"])
def test_walk_markov_law_chi_square(tag, law):
    """4000 independent walks, all from node 0: after t steps their
    positions are Multinomial(W, P^t[0]) exactly; after the stationary
    start, Multinomial(W, pi) at every step."""
    g, p = _law(tag, law)
    rows = torch.from_numpy(ttr.row_probs_padded(p, g))
    nbrs, _ = twalk.graph_tensors(g, device="cpu")
    gen = torch.Generator().manual_seed(11)
    w, t = 4000, 3
    traj = twalk.walk_markov_batched(
        rows, nbrs, torch.zeros(w, dtype=torch.int32), t, generator=gen)
    assert traj.shape == (w, t + 1) and bool((traj[:, 0] == 0).all())
    exact = np.linalg.matrix_power(p, t)[0]
    counts = np.bincount(traj[:, -1].numpy(), minlength=g.n)
    assert counts[exact == 0].sum() == 0  # no step leaves the support
    live = exact > 0
    assert stats.chisquare(counts[live], w * exact[live]).pvalue > 1e-3

    pi = tmix.stationary_distribution(p)
    v0s = np.random.default_rng(5).choice(g.n, size=w, p=pi)
    traj = twalk.walk_markov_batched(
        rows, nbrs, torch.from_numpy(v0s.astype(np.int32)), 20, generator=gen)
    counts = np.bincount(traj[:, -1].numpy(), minlength=g.n)
    assert stats.chisquare(counts, w * pi).pvalue > 1e-3
    emp = twalk.empirical_distribution(traj.numpy(), g.n)
    assert 0.5 * np.abs(emp - pi).sum() < 0.03


def test_walk_markov_single_reaches_stationary():
    """One long walk on ring(16) under MH-IS with an L spike: its
    occupancy approaches pi_IS, as the reference's simulation test asks."""
    g = tg.ring(16)
    lips = np.ones(16)
    lips[3] = 50.0
    rows = torch.from_numpy(ttr.row_probs_padded(ttr.mh_importance(g, lips), g))
    nbrs, _ = twalk.graph_tensors(g, device="cpu")
    traj = twalk.walk_markov(rows, nbrs, 0, 20_000,
                             generator=torch.Generator().manual_seed(1))
    assert traj.shape == (20_001,) and int(traj[0]) == 0
    emp = twalk.empirical_distribution(traj.numpy(), g.n, burn_in=2_000)
    assert 0.5 * np.abs(emp - lips / lips.sum()).sum() < 0.08


def test_walk_markov_injected_block_is_the_mhlj_walk_at_pj_zero():
    """With an injected block the Markov walk is the engine's MH move: the
    same numbers give ``walk_mhlj``'s walk at p_J = 0, r = 1."""
    g_ref, g_port, _, rows = _setup("sbm")
    nbrs, deg = twalk.graph_tensors(g_port, device="cpu")
    u = torch.rand((50, 9, 4), generator=torch.Generator().manual_seed(2))
    u[..., 0] = 0.0
    v0s = torch.arange(9, dtype=torch.int32)
    traj = twalk.walk_markov_batched(torch.from_numpy(rows), nbrs, v0s, 50,
                                     uniforms=u)
    nodes, hops = twalk.walk_mhlj_batched(
        torch.from_numpy(rows), nbrs, deg, v0s, 50, 0.0, 0.5, 1, uniforms=u)
    np.testing.assert_array_equal(traj[:, :-1].numpy(), nodes.numpy())
    assert bool((hops == 1).all())
    single = twalk.walk_markov(torch.from_numpy(rows), nbrs, 0, 50,
                               uniforms=u[:, 0])
    np.testing.assert_array_equal(single.numpy(), traj[0].numpy())
    u[3, 2, 0] = 1.0
    with pytest.raises(ValueError, match="zero jump flag"):
        twalk.walk_markov_batched(torch.from_numpy(rows), nbrs, v0s, 50,
                                  uniforms=u)
    with pytest.raises(ValueError, match="uniforms must be"):
        twalk.walk_markov_batched(torch.from_numpy(rows), nbrs, v0s, 49,
                                  uniforms=u)
    with pytest.raises(ValueError, match="generator"):
        twalk.walk_markov_batched(torch.from_numpy(rows), nbrs, v0s, 50)


def test_empirical_distribution_bitwise():
    rng = np.random.default_rng(4)
    for shape, burn in (((500,), 0), ((500,), 100), ((7, 300), 40)):
        seq = rng.integers(0, 30, size=shape)
        np.testing.assert_array_equal(
            jwalk.empirical_distribution(seq, 30, burn_in=burn),
            twalk.empirical_distribution(seq, 30, burn_in=burn))
