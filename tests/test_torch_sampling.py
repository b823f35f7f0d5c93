"""Port parity: the device graph samplers (``core.torch_sampling``).

Given the reference's own uniforms (``jax.random.uniform(key, ...)`` as
``repro.core.jax_sampling`` draws them, and ``fold_in(key, a)`` for the
SBM's retry ``a``), the port's BA edges, SBM mask and graphs equal the
reference's bit for bit: the arithmetic is one float32 product, a
truncation and integer gathers.  Draws from a ``torch.Generator`` are
another stream and are held at the family level, as the reference holds
its own samplers against the numpy ones.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import jax_sampling as js
from repro_torch.core import graphs as tg
from repro_torch.core import torch_sampling as ts


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ba_uniforms(n, m, key):
    return np.asarray(jax.random.uniform(key, (m * (n - m),)))


@pytest.mark.parametrize("n,m,seed", [(50, 1, 0), (300, 3, 1), (2000, 3, 2),
                                      (500, 7, 3)])
def test_ba_edges_bitwise_on_reference_uniforms(n, m, seed):
    key = jax.random.PRNGKey(seed)
    src_j, dst_j = js.barabasi_albert_edges(n, m, key)
    src, dst = ts.barabasi_albert_edges(
        n, m, uniforms=_ba_uniforms(n, m, key), device="cpu")
    assert src.dtype == dst.dtype == torch.int32
    assert np.array_equal(src.numpy(), np.asarray(src_j))
    assert np.array_equal(dst.numpy(), np.asarray(dst_j))


@pytest.mark.parametrize("layout", ["csr", "ragged", "bucketed"])
def test_ba_graph_equals_reference(layout):
    key = jax.random.PRNGKey(5)
    ref = js.barabasi_albert_jax(400, 3, key, layout=layout)
    g = ts.barabasi_albert_torch(400, 3, uniforms=_ba_uniforms(400, 3, key),
                                 layout=layout, device="cpu")
    assert type(g).__name__ == type(ref).__name__
    for f in ("indptr", "indices", "degrees"):
        assert np.array_equal(getattr(g, f), getattr(ref, f))


def _sbm_uniforms(sizes, key, attempts):
    n = sum(sizes)
    shape = (n * (n - 1) // 2,)
    return [np.asarray(jax.random.uniform(
        key if a == 0 else jax.random.fold_in(key, a), shape))
        for a in range(attempts)]


def test_sbm_mask_and_graph_bitwise_on_reference_uniforms():
    """The mask of one draw, and the graph of the retry loop (a sparse
    setting that needs retries: every attempt's uniforms injected)."""
    sizes, key = [30, 30, 40], jax.random.PRNGKey(3)
    mask_j = np.asarray(js.sbm_pair_mask(sizes, 0.3, 0.02, key))
    mask = ts.sbm_pair_mask(sizes, 0.3, 0.02,
                            uniforms=_sbm_uniforms(sizes, key, 1)[0],
                            device="cpu")
    assert mask.dtype == torch.bool
    assert np.array_equal(mask.numpy(), mask_j)
    for sizes, p_in, p_out in (([250] * 4, 0.1, 0.002), ([12] * 4, 0.25,
                                                          0.01)):
        ref = js.sbm_jax(sizes, p_in, p_out, key, layout="ragged")
        g = ts.sbm_torch(sizes, p_in, p_out,
                         uniforms=_sbm_uniforms(sizes, key, 64),
                         layout="ragged", device="cpu")
        for f in ("indptr", "indices", "degrees"):
            assert np.array_equal(getattr(g, f), getattr(ref, f))


def test_family_level_on_generator_draws():
    """Generator draws: BA has m(n-m) attachment edges, validates, is
    connected with every node's degree at least m + 1 (its self-loop
    included) and a hub; SBM validates and its within-block density
    exceeds the across-block one."""
    gen = torch.Generator().manual_seed(0)
    for n, m in ((1000, 3), (300, 1)):
        src, dst = ts.barabasi_albert_edges(n, m, generator=gen, device="cpu")
        assert src.shape == dst.shape == (m * (n - m),)
        assert bool((dst < src).all()) and bool((dst >= 0).all())
        g = ts.barabasi_albert_torch(n, m, generator=gen, layout="ragged",
                                     device="cpu")
        g.validate()
        assert int(np.asarray(g.degrees).min()) >= 2
        assert g.max_degree > 4 * (2 * m + 1)  # preferential attachment
    sizes = [50] * 4
    g = ts.sbm_torch(sizes, 0.3, 0.01, generator=gen, layout="csr",
                     device="cpu")
    g.validate()
    block = np.repeat(np.arange(4), 50)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    off = src != dst
    same = block[src[off]] == block[dst[off]]
    d_in = same.sum() / (4 * 50 * 49)
    d_out = (~same).sum() / (200 * 150)
    print(f"SBM generator draw: density in {d_in:.4f}, across {d_out:.4f}")
    assert d_in > 10 * d_out


def test_sampler_contract_errors():
    with pytest.raises(ValueError, match="1 <= m < n"):
        ts.barabasi_albert_edges(3, 3, generator=torch.Generator(),
                                 device="cpu")
    with pytest.raises(ValueError, match="uniforms"):
        ts.barabasi_albert_edges(10, 2, uniforms=np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        ts.barabasi_albert_edges(10, 2, device="cpu")
    with pytest.raises(ValueError, match="p_in"):
        ts.sbm_torch([5, 5], 1.5, 0.1, generator=torch.Generator(),
                     device="cpu")
    with pytest.raises(ValueError, match="block_sizes"):
        ts.sbm_pair_mask([], 0.5, 0.1, generator=torch.Generator(),
                         device="cpu")
    with pytest.raises(RuntimeError, match="connected"):
        ts.sbm_torch([10, 10], 0.0, 0.0, generator=torch.Generator(),
                     max_retries=2, device="cpu")
    assert isinstance(ts.barabasi_albert_torch(
        20, 2, generator=torch.Generator(), device="cpu"), tg.CSRGraph)
