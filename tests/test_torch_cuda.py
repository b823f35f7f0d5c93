"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; without them they skip.  On
the GPU machine run them with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the shared conftest imports
the JAX package, which the GPU machine need not have).
``chip_smoke.py`` drives the same checks at the main path's full sizes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core.graphs import barabasi_albert
from repro_torch.core.transition import (
    MHLJParams,
    mh_importance_rows,
    mh_importance_rows_ragged,
)
from repro_torch.kernels.walk_transition import kernel as wt
from repro_torch.kernels.walk_transition.ref import (
    walk_transition_ragged_ref,
    walk_transition_ref,
    walk_transition_sparse_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def engine(dev):
    g = barabasi_albert(20_000, 3, seed=0, layout="ragged")
    lips = np.exp(np.random.default_rng(0).normal(size=g.n))
    return teng.WalkEngine.from_graph(
        g, MHLJParams(0.3, 0.5, 3),
        row_probs=mh_importance_rows_ragged(g, lips), device=dev,
    )


@pytest.mark.parametrize("w,r", [(1, 3), (257, 1), (4096, 5)])
def test_kernel_bitwise_vs_plain(engine, dev, w, r):
    gen = torch.Generator(device=dev).manual_seed(w + r)
    nodes = torch.randint(0, engine.n, (w,), generator=gen, device=dev,
                          dtype=torch.int32)
    u = teng.draw_uniforms(w, r, 0.4, gen, dev)
    args = (nodes, engine.indptr, engine.degrees, engine.indices,
            engine.edge_cdf, u)
    kw = dict(p_d=0.5, r=r, max_degree=engine.max_degree)
    before = wt.walk_transition_ragged.launches
    nxt, hops = wt.walk_transition_ragged(*args, **kw)
    assert wt.walk_transition_ragged.launches == before + 1
    nxt_p, hops_p = walk_transition_ragged_ref(*args, **kw)
    ok = ~((u[:, 0] > 0.5) & (hops != hops_p))  # d rounded differently
    assert torch.equal(nxt[ok], nxt_p[ok]) and torch.equal(hops[ok], hops_p[ok])


def test_engine_step_launches_kernel_or_raises(engine, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.zeros(64, dtype=torch.int32, device=dev)
    before = wt.walk_transition_ragged.launches
    engine.run(v, 10, generator=gen)
    assert wt.walk_transition_ragged.launches == before + 10
    u = teng.draw_uniforms(64, 3, 0.3, gen, dev)
    with pytest.raises(TypeError):
        wt.walk_transition_ragged(
            v.long(), engine.indptr, engine.degrees, engine.indices,
            engine.edge_cdf, u, p_d=0.5, r=3, max_degree=engine.max_degree,
        )
    with pytest.raises(ValueError):
        wt.walk_transition_ragged(
            v, engine.indptr, engine.degrees, engine.indices,
            engine.edge_cdf, u[:, :5], p_d=0.5, r=3,
            max_degree=engine.max_degree,
        )


@pytest.fixture(scope="module")
def padded():
    """BA(20k,3) as CSR with its padded P_IS table (max degree ~600), on
    the card when there is one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the GPU")
    dev = torch.device("cuda")
    g = barabasi_albert(20_000, 3, seed=0, layout="csr")
    lips = np.exp(np.random.default_rng(0).normal(size=g.n))
    rows = torch.as_tensor(mh_importance_rows(g, lips), device=dev)
    nbrs = torch.as_tensor(g.neighbors.astype(np.int32), device=dev)
    deg = torch.as_tensor(g.degrees.astype(np.int32), device=dev)
    return g, rows, nbrs, deg


def _walk_nodes(g, w, gen, dev):
    nodes = torch.randint(0, g.n, (w,), generator=gen, device=dev,
                          dtype=torch.int32)
    nodes[: w // 8 + 1] = int(np.argmax(g.degrees))  # hub walks
    return nodes


@pytest.mark.parametrize("w", [1, 257, 4096])
def test_sparse_kernel_bitwise_vs_plain(padded, w):
    g, rows, nbrs, _ = padded
    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(w)
    nodes = _walk_nodes(g, w, gen, dev)
    t_rows, t_nbrs = rows[nodes], nbrs[nodes]
    u_mh = torch.rand(w, generator=gen, device=dev)
    before = wt.walk_transition_sparse.launches
    got = wt.walk_transition_sparse(t_rows, t_nbrs, u_mh)
    assert wt.walk_transition_sparse.launches == before + 1
    assert torch.equal(got, walk_transition_sparse_ref(t_rows, t_nbrs, u_mh))
    with pytest.raises(ValueError):
        wt.walk_transition_sparse(t_rows[:, :-1].contiguous(), t_nbrs, u_mh)


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("w", [1, 257, 4096])
def test_dense_kernel_bitwise_vs_full_width_plain(padded, w, r):
    """The dense kernel stops each row at deg(v); its plain version
    inverts the full max-degree row.  Bitwise outside d differences."""
    g, rows, nbrs, deg = padded
    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(10 * w + r)
    nodes = _walk_nodes(g, w, gen, dev)
    u = teng.draw_uniforms(w, r, 0.4, gen, dev)
    before = wt.walk_transition.launches
    nxt, hops = wt.walk_transition(nodes, rows, nbrs, deg, u, p_d=0.5, r=r)
    assert wt.walk_transition.launches == before + 1
    nxt_p, hops_p = walk_transition_ref(nodes, rows, nbrs, deg, u, p_d=0.5,
                                        r=r)
    ok = ~((u[:, 0] > 0.5) & (hops != hops_p))  # d rounded differently
    assert torch.equal(nxt[ok], nxt_p[ok]) and torch.equal(hops[ok], hops_p[ok])


def test_layout_engines_launch_their_kernels(padded):
    """Each layout's step launches its kernel (never a plain version), and
    the four layouts walk identically on the card."""
    g, _, _, _ = padded
    dev = torch.device("cuda")
    lips = np.exp(np.random.default_rng(0).normal(size=g.n))
    params = MHLJParams(0.3, 0.5, 3)
    engines = {
        name: teng.WalkEngine.from_graph(g, params, lipschitz=lips,
                                         device=dev, **kw)
        for name, kw in (
            ("sparse", {}), ("dense", {"layout": "dense"}),
            ("bucketed", {"layout": "bucketed"}),
            ("ragged", {"layout": "ragged"}),
        )
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    nodes = _walk_nodes(g, 2048, gen, dev)
    u = teng.draw_uniforms(2048, 3, 0.3, gen, dev)
    counters = (wt.walk_transition_sparse, wt.walk_transition,
                wt.walk_transition_ragged)
    outs = {}
    for name, eng in engines.items():
        before = [c.launches for c in counters]
        outs[name] = eng.step(nodes, uniforms=u)
        launched = [c.launches - b for c, b in zip(counters, before)]
        expect = {
            "sparse": [1, 0, 0], "dense": [0, 1, 0], "ragged": [0, 0, 1],
        }.get(name)
        if expect is None:  # one tile launch per bucket pass
            assert launched[1:] == [0, 0] and launched[0] >= 1
        else:
            assert launched == expect
    for nxt, hops in outs.values():
        assert torch.equal(nxt, outs["sparse"][0])
        assert torch.equal(hops, outs["sparse"][1])
