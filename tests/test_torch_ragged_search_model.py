"""The arithmetic of the ragged kernel's MH search, on the CPU.

``csrc/walk_transition_ragged.cu`` gives each walk a group of G lanes.
Round 1 reads G entries of the walk's CDF segment at once: the whole
segment when deg <= G, else G entries spaced evenly and ending at deg-1,
so the row's total arrives in the same round.  A ballot counts the
entries below ``t = u * total``; each later round probes G entries of the
one interval left between two probes, until at most G entries remain and
all of them are read.  :func:`model_pick` repeats those rounds (probe
positions, ballot counts, the total from round 1) in float32 numpy
scalars, and the tests hold it bit for bit against the plain version's
binary search (``engine.ragged_mh_invert``) on the port's CDF and against
the reference's ``walk_transition_ragged_ref`` on the reference's own CDF.

The two searches agree because every segment is non-decreasing: the
probes below ``t`` then form a prefix, and both find ``count(cdf < t)``.
That fact is tested here on every buffer the model is held on.  The
kernel is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import graphs as jg
from repro.core import transition as jtr
from repro.kernels.walk_transition.ref import walk_transition_ragged_ref as jref
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.kernels.walk_transition import kernel as tkernel

GROUPS = tkernel.RAGGED_GROUPS
U_EDGES = {"zero": np.float32(0.0), "half": np.float32(0.5),
           "below_one": np.nextafter(np.float32(1.0), np.float32(0.0))}
# degrees of the synthetic rows: 1 to 4097, each G and G+1 among them
EDGE_DEGREES = sorted({1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63,
                       64, 65, 100, 255, 256, 257, 1000, 1196, 3799, 4096,
                       4097})


def model_pick(segment: np.ndarray, u, g: int) -> tuple:
    """The kernel's pick in ``segment`` (a walk's CDF entries) for the
    uniform ``u`` with groups of ``g`` lanes: ``(index, rounds)``, the
    index being ``count(cdf < u * total)`` clamped to ``deg - 1``."""
    seg = np.asarray(segment, np.float32)
    lanes = np.arange(g)
    lo, n, t, rounds = 0, seg.size, None, 0
    while True:
        rounds += 1
        last = n <= g  # this round reads every entry left
        on = lanes < n if last else np.ones(g, bool)
        q = lo + lanes if last else lo + ((lanes + 1) * n) // g - 1
        c = np.where(on, seg[np.where(on, q, lo)], np.float32(0.0))
        if t is None:  # entry deg-1 sits on lane n-1 (last) or g-1
            t = np.float32(np.float32(u) * c[n - 1 if last else g - 1])
        below = int(np.count_nonzero(on & (c < t)))
        if last:
            lo += below
            break
        if below == g:
            lo += n
            break
        next_lo = lo + (below * n) // g  # one past probe below-1
        n = lo + ((below + 1) * n) // g - 1 - next_lo
        lo = next_lo
    return min(lo, seg.size - 1), rounds


def _plain_picks(indptr, degrees, cdf, nodes, u) -> np.ndarray:
    """The plain version's index in each walk's segment: its binary search
    run over ``indices = arange(nnz)``, less the segment's start."""
    nnz = cdf.size
    got = teng.ragged_mh_invert(
        torch.as_tensor(indptr.astype(np.int32)),
        torch.as_tensor(degrees.astype(np.int32)),
        torch.arange(nnz, dtype=torch.int32),
        torch.as_tensor(np.array(cdf, np.float32)),
        torch.as_tensor(nodes.astype(np.int32)),
        torch.as_tensor(u), max_degree=int(degrees.max()),
    ).numpy()
    return got - indptr[nodes]


def _edge_rows(rng) -> np.ndarray:
    """One flat buffer of probability rows at :data:`EDGE_DEGREES`, each
    degree three times: random, with runs of zeros inside, and dyadic
    (entries ``1/deg`` at powers of two, so ``u = 0.5`` hits a CDF value
    exactly) or, elsewhere, a single nonzero entry in the middle."""
    rows = []
    for deg in EDGE_DEGREES:
        rows.append(rng.random(deg).astype(np.float32))
        runs = rng.random(deg).astype(np.float32)
        runs[rng.random(deg) < 0.6] = 0.0  # flat runs of the CDF
        rows.append(runs)
        if deg & (deg - 1) == 0:
            rows.append(np.full(deg, 1.0 / deg, np.float32))
        else:
            one = np.zeros(deg, np.float32)
            one[deg // 2] = 1.0
            rows.append(one)
    return rows


@functools.lru_cache(maxsize=None)
def _buffers(kind: str) -> tuple:
    """``(indptr, degrees, indices, port_cdf, ref_cdf)`` of one family:
    the port's per-edge CDF and the reference's, from the same rows."""
    if kind == "edge_rows":
        rows = _edge_rows(np.random.default_rng(3))
        degrees = np.array([r.size for r in rows], np.int64)
        indptr = np.concatenate([[0], np.cumsum(degrees)])
        indices = np.arange(indptr[-1], dtype=np.int64) % degrees.size
        flat = np.concatenate(rows)
    else:
        g = {"ba": lambda: jg.barabasi_albert(20_000, 3, seed=0,
                                               layout="ragged"),
             "ring": lambda: jg.ring(64, layout="ragged"),
             "dumbbell": lambda: jg.dumbbell(20, 3, layout="ragged")}[kind]()
        lips = np.exp(np.random.default_rng(1).normal(size=g.n))
        lips[int(np.argmax(g.degrees))] = 60.0  # a trap at the hub
        flat = np.asarray(jtr.mh_importance_rows_ragged(g, lips), np.float32)
        indptr, degrees, indices = g.indptr, g.degrees, g.indices
    indptr = np.asarray(indptr, np.int64)
    degrees = np.asarray(degrees, np.int64)
    port = teng.ragged_edge_cdf(indptr, indices, degrees, row_probs=flat,
                                device="cpu").numpy()
    ref = np.asarray(jeng.ragged_edge_cdf(indptr, indices, degrees,
                                          row_probs=flat), np.float32)
    return indptr, degrees, np.asarray(indices, np.int64), port, ref


def _walk_nodes(degrees, rng, size=600) -> np.ndarray:
    """Every node of a small family; else the widest 64 rows and a random
    draw."""
    n = degrees.size
    if n <= size:
        return np.arange(n)
    top = np.argsort(degrees)[-64:]
    return np.concatenate([top, rng.integers(0, n, size - top.size)])


def _draws(kind: str, rows: int, rng) -> np.ndarray:
    if kind == "random":
        return rng.random(rows, dtype=np.float32)
    return np.full(rows, U_EDGES[kind], np.float32)


FAMILIES = ["ba", "ring", "dumbbell", "edge_rows"]


def _inner_steps(indptr, cdf) -> np.ndarray:
    """``cdf[i+1] - cdf[i]`` for every pair inside one segment, else 0."""
    steps = np.diff(cdf)
    steps[indptr[1:-1] - 1] = 0.0
    return steps


def _decreasing_rows(indptr, cdf) -> np.ndarray:
    """The rows whose CDF segment decreases somewhere."""
    at = np.flatnonzero(_inner_steps(indptr, cdf) < 0)
    return np.unique(np.searchsorted(indptr, at, side="right") - 1)


@pytest.mark.parametrize("kind", FAMILIES)
def test_every_segment_is_non_decreasing(kind):
    """The fact the kernel's search rests on: every segment of the port's
    buffers, and of the reference's (XLA's cumsum) on the graph families'
    P_IS rows, hub rows included, never decreases.  The reference's cumsum
    does decrease inside the synthetic rows with runs of zeros at widths
    from 1000 (printed), which is why ``interop.from_reference_state``
    refuses such a buffer."""
    indptr, _, _, port, ref = _buffers(kind)
    assert _decreasing_rows(indptr, port).size == 0 and np.all(port >= 0)
    bad = _decreasing_rows(indptr, ref)
    if kind == "edge_rows":
        print(f"reference cumsum decreases, by up to "
              f"{-float(_inner_steps(indptr, ref).min()):.3g}, in rows of "
              f"degree "
              f"{sorted({int(d) for d in np.diff(indptr)[bad]})}")
    else:
        assert bad.size == 0 and np.all(ref >= 0)


def test_interop_refuses_a_decreasing_cdf():
    """A ragged reference state whose CDF decreases inside a row raises;
    a decrease across two rows does not."""
    indptr, degrees, indices, port, _ = _buffers("edge_rows")
    state = dict(degrees=degrees, p_d=0.5, r=3, indptr=indptr,
                 indices=indices, max_degree=int(degrees.max()), device="cpu")
    interop.from_reference_state(edge_cdf=port, **state)  # across rows: fine
    row = int(np.flatnonzero(degrees == 64)[0])
    bad = port.copy()
    bad[indptr[row] + 10] = np.nextafter(bad[indptr[row] + 9], np.float32(0))
    with pytest.raises(ValueError, match="decreases inside a row"):
        interop.from_reference_state(edge_cdf=bad, **state)


@pytest.mark.parametrize("u_kind", ["zero", "half", "below_one", "random"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_model_equals_plain_search(kind, u_kind):
    """On the port's CDF, at every group width: the model's pick equals
    the plain version's binary search bit for bit."""
    indptr, degrees, _, port, _ = _buffers(kind)
    rng = np.random.default_rng(len(kind) + len(u_kind))
    nodes = _walk_nodes(degrees, rng)
    u = _draws(u_kind, nodes.size, rng)
    want = _plain_picks(indptr, degrees, port, nodes, u)
    for g in GROUPS:
        got = [model_pick(port[indptr[v]:indptr[v + 1]], uv, g)[0]
               for v, uv in zip(nodes, u)]
        np.testing.assert_array_equal(got, want, err_msg=f"G={g}")


@pytest.mark.parametrize("kind", FAMILIES)
def test_model_equals_reference_on_its_own_cdf(kind):
    """On the reference's CDF, at every row whose segment there does not
    decrease: the model's neighbor equals the reference's
    ``walk_transition_ragged_ref`` (every walk an MH move), and the port's
    plain version equals both."""
    indptr, degrees, indices, _, ref = _buffers(kind)
    rng = np.random.default_rng(11)
    nodes = _walk_nodes(degrees, rng)
    nodes = nodes[~np.isin(nodes, _decreasing_rows(indptr, ref))]
    r = 3
    u = rng.random((nodes.size, teng.num_uniforms(r)), dtype=np.float32)
    u[:, teng.U_JUMP] = 0.0
    u[: nodes.size // 4, teng.U_MH] = U_EDGES["below_one"]
    want, hops = jref(*(jnp.asarray(np.asarray(x, np.int32))
                        for x in (nodes, indptr, degrees, indices)),
                      jnp.asarray(ref), jnp.asarray(u), p_d=0.5, r=r,
                      max_degree=int(degrees.max()))
    assert np.all(np.asarray(hops) == 1)
    plain = indices[indptr[nodes] + _plain_picks(indptr, degrees, ref, nodes,
                                                 u[:, teng.U_MH])]
    np.testing.assert_array_equal(plain, np.asarray(want))
    for g in GROUPS:
        got = [indices[indptr[v] + model_pick(ref[indptr[v]:indptr[v + 1]],
                                              uv, g)[0]]
               for v, uv in zip(nodes, u[:, teng.U_MH])]
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"G={g}")


def test_model_at_an_exact_cdf_value_and_its_rounds():
    """``t`` equal to a CDF value counts only the entries strictly below
    it; a segment of deg <= G takes one round, and the BA(1M,3) hub's
    degree 3799 takes at most four at G=8 and three at G=32 (the
    wrapper's)."""
    for deg in (4, 8, 16, 32, 64, 4096):
        seg = np.cumsum(np.full(deg, 1.0 / deg, np.float32), dtype=np.float32)
        for g in GROUPS:
            assert model_pick(seg, np.float32(0.5), g)[0] == deg // 2 - 1
            assert model_pick(seg, np.float32(0.0), g)[0] == 0
            rounds = model_pick(seg, np.float32(0.3), g)[1]
            assert rounds == 1 if deg <= g else rounds >= 2
    seg = np.linspace(0, 1, 3799, dtype=np.float32)
    draws = np.random.default_rng(0).random(200)
    assert max(model_pick(seg, u, 8)[1] for u in draws) == 4
    assert max(model_pick(seg, u, 32)[1] for u in draws) == 3

