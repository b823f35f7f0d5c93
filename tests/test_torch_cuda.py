"""The port's CUDA kernel on the card, held against its plain version.

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
from repro_torch.core.transition import MHLJParams, mh_importance_rows_ragged
from repro_torch.kernels.walk_transition import kernel as wt
from repro_torch.kernels.walk_transition.ref import walk_transition_ragged_ref

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
