"""The arithmetic of the sparse and dense walk kernels' row inversion, on
the CPU.

``csrc/walk_row_cdf.cuh`` inverts a row's CDF with a warp: it adds only
the row's nonzero entries, in column order, keeps the running sum at the
end of each checkpoint block (segments of 128 columns, at most 32
blocks), finds the first block whose
checkpoint reaches ``thr = u * total``, adds that block again from its
predecessor's checkpoint and stops at the first crossing.  That is
bitwise the port's row-CDF rule (``engine.mh_cdf_invert``: a sequential
float32 sum over every entry, ``count(cdf < thr)``, clamped) by two exact
facts: ``acc + 0.0f == acc`` for ``acc >= 0``, and the rounded CDF never
decreases.  :func:`model_count` is a plain model of that arithmetic, with
the kernel's segments and checkpoint blocks, and the tests
hold it bit for bit against the plain version on the reference's BA
tiles and on edge rows (interior zeros, all-zero and -0.0 rows, denormals,
a lone last-column entry, ``u`` at 0, 0.5 and the largest float32 below
1, widths 1 to 4097).  The CUDA kernels are held against the plain
version on the card (``tests/test_torch_cuda.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jg
from repro.core import transition as jtr
from repro.kernels.walk_transition import ref as jref
from repro_torch.core import engine as teng
from repro_torch.kernels.walk_transition import kernel as tkernel
from tests.test_torch_cuda import EDGE_WIDTHS, _edge_rows

SEG = 128  # columns a warp's segment covers (walk_row_cdf.cuh)
U_EDGES = {"zero": np.float32(0.0), "half": np.float32(0.5),
           "below_one": np.nextafter(np.float32(1.0), np.float32(0.0))}
# Pick-mismatch bound against the reference on BA hub rows (as in
# tests/test_torch_layouts.py): XLA's cumsum adds wide rows in another
# order, so a pick may differ where u * total falls between two CDF values
# a few ulps apart.
HUB_MISMATCH_BOUND = 1e-3


def model_count(row: np.ndarray, u: np.float32) -> int:
    """``walk_row_cdf::row_cdf_count`` in float32 numpy scalars: the count
    of ``cdf < u * total`` over ``row`` under the row-CDF rule, from the
    nonzero entries only and a checkpoint search."""
    width = row.size
    seg = SEG
    nseg = -(-width // seg)
    per = -(-nseg // 32)  # segments per checkpoint block, one per lane
    nonzero = np.flatnonzero(row != 0)  # column order; NaN counts, -0.0 not
    acc, cps, k = np.float32(0.0), [], 0
    for s in range(nseg):
        while k < nonzero.size and nonzero[k] < (s + 1) * seg:
            acc = np.float32(acc + row[nonzero[k]])
            k += 1
        if (s + 1) % per == 0 or s + 1 == nseg:
            cps.append(acc)
    thr = np.float32(np.float32(u) * acc)
    if not thr > 0:
        return 0
    j = next((j for j, cp in enumerate(cps) if not cp < thr), None)
    if j is None:
        return width
    acc = cps[j - 1] if j else np.float32(0.0)
    lo, hi = j * per * seg, min((j + 1) * per * seg, width)
    for c in nonzero[(nonzero >= lo) & (nonzero < hi)]:
        acc = np.float32(acc + row[c])
        if not acc < thr:
            return int(c)
    return width


def model_invert(rows: np.ndarray, neigh_rows: np.ndarray,
                 u_mh: np.ndarray) -> np.ndarray:
    """The sparse kernel's ``v_mh``: the count clamped to ``width - 1``
    and the neighbor there."""
    width = rows.shape[1]
    idx = [min(model_count(r, u), width - 1) for r, u in zip(rows, u_mh)]
    return neigh_rows[np.arange(rows.shape[0]), idx].astype(np.int32)


def _plain(rows, neigh_rows, u_mh) -> np.ndarray:
    return teng.mh_cdf_invert(torch.from_numpy(rows),
                              torch.from_numpy(neigh_rows),
                              torch.from_numpy(u_mh)).numpy()


@functools.lru_cache(maxsize=None)
def _ba():
    """BA(2000,3) in the reference, its padded P_IS rows (numpy) and
    neighbor table."""
    g = jg.barabasi_albert(2000, 3, seed=0, layout="csr")
    lips = np.exp(np.random.default_rng(5).normal(size=g.n))
    lips[int(np.argmax(g.degrees))] = 60.0  # a trap at the hub
    rows = np.asarray(jtr.mh_importance_rows(g, lips), np.float32)
    return g, rows, np.asarray(g.neighbors, np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_on_reference_ba_tiles(seed):
    """On the reference's BA(2000,3) P_IS tiles (a quarter of the walks at
    the hub): the model equals the plain version bit for bit, and the
    reference's ``walk_transition_sparse_ref`` within the pick-mismatch
    bound."""
    g, rows, nbrs = _ba()
    rng = np.random.default_rng(seed)
    w = 512
    nodes = rng.integers(0, g.n, w)
    nodes[: w // 4] = int(np.argmax(g.degrees))
    t_rows, t_nbrs = rows[nodes], nbrs[nodes]
    u = rng.random(w, dtype=np.float32)
    got = model_invert(t_rows, t_nbrs, u)
    np.testing.assert_array_equal(got, _plain(t_rows, t_nbrs, u))
    ref = np.asarray(jref.walk_transition_sparse_ref(
        jnp.asarray(t_rows), jnp.asarray(t_nbrs), jnp.asarray(u)))
    assert (got != ref).mean() <= HUB_MISMATCH_BOUND


def test_model_on_dense_rows_read_to_degree():
    """The dense kernel inverts only the first deg(v) entries of row v and
    clamps to max_deg - 1: the model so equals the full-width plain
    version on every node of BA(2000,3), at three draws of u each."""
    g, rows, nbrs = _ba()
    deg, max_deg = np.asarray(g.degrees), rows.shape[1]
    rng = np.random.default_rng(7)
    for u in (rng.random(g.n, dtype=np.float32) for _ in range(3)):
        idx = [min(model_count(rows[v, : deg[v]], u[v]), max_deg - 1)
               for v in range(g.n)]
        got = nbrs[np.arange(g.n), idx]
        np.testing.assert_array_equal(got, _plain(rows, nbrs, u))


@pytest.mark.parametrize("u_kind", ["zero", "half", "below_one", "random"])
@pytest.mark.parametrize("width", EDGE_WIDTHS)
def test_model_on_edge_rows(width, u_kind):
    """Every edge row, at every width, under each edge value of u (and
    under 16 random draws): the model equals the plain version bit for
    bit, and so does the wrapper on CPU tensors, which launches nothing."""
    rng = np.random.default_rng(width)
    rows = _edge_rows(width, rng)
    if u_kind == "random":
        rows = np.repeat(rows, 16, axis=0)
        u = rng.random(rows.shape[0], dtype=np.float32)
    else:
        u = np.full(rows.shape[0], U_EDGES[u_kind], np.float32)
    nbrs = rng.integers(0, 10**6, rows.shape).astype(np.int32)
    want = _plain(rows, nbrs, u)
    np.testing.assert_array_equal(model_invert(rows, nbrs, u), want)
    before = tkernel.walk_transition_sparse.launches
    port = tkernel.walk_transition_sparse(
        torch.from_numpy(rows), torch.from_numpy(nbrs), torch.from_numpy(u))
    assert tkernel.walk_transition_sparse.launches == before
    np.testing.assert_array_equal(port.numpy(), want)


@pytest.mark.parametrize("width", [1, 32, 1196, 4097])
def test_model_count_is_the_first_crossing(width):
    """Fact 2 on its own: on a non-negative row with ``thr > 0`` the
    count of ``cdf < thr`` (the full sequential CDF) is the column of the
    first nonzero entry whose running sum reaches ``thr``."""
    rng = np.random.default_rng(width + 1)
    for row in _edge_rows(width, rng):
        cdf = teng.row_cdf(torch.from_numpy(row)[None])[0].numpy()
        for u in (np.float32(0.5), rng.random(dtype=np.float32)):
            thr = np.float32(u * cdf[-1])
            count = int((cdf < thr).sum())
            assert model_count(row, u) == count
            if thr > 0:
                assert row[count] != 0 and not cdf[count] < thr
