"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; without them they skip.  On
the GPU machine run them with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the shared conftest imports
the JAX package, which the GPU machine need not have).
``chip_smoke.py`` drives the same checks at the main path's full sizes.
The LLM kernels are held at ``tests/test_kernels.py``'s tolerances
(flash 2e-5 / 2e-2, SSD 2e-4 / 6e-2, RMSNorm 1e-5 / 3e-2 for float32 /
bfloat16, as atol and rtol), and in float16 at the tolerances
``tests/test_torch_kernel_dtypes.py`` sets from measurement (2e-3 each).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core import scan as tscan
from repro_torch.core.graphs import barabasi_albert, from_edges
from repro_torch.core.transition import (
    MHLJParams,
    mh_importance_rows,
    mh_importance_rows_bucketed,
    mh_importance_rows_ragged,
)
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_scan_ref
from repro_torch.kernels.walk_transition import kernel as wt
from repro_torch.kernels.walk_transition.ref import (
    walk_transition_ragged_ref,
    walk_transition_ref,
    walk_transition_sparse_ref,
)
from repro_torch.models.factory import build_model

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


def _hold_ragged(engine, nodes, u, r, monkeypatch):
    """The ragged kernel at every lane-group width against its plain
    version: bitwise outside a differing d, one launch a call."""
    args = (nodes, engine.indptr, engine.degrees, engine.indices,
            engine.edge_cdf, u)
    kw = dict(p_d=0.5, r=r, max_degree=engine.max_degree)
    nxt_p, hops_p = walk_transition_ragged_ref(*args, **kw)
    for group in wt.RAGGED_GROUPS:
        monkeypatch.setattr(wt, "RAGGED_GROUP", group)
        before = wt.walk_transition_ragged.launches
        nxt, hops = wt.walk_transition_ragged(*args, **kw)
        torch.cuda.synchronize()
        assert wt.walk_transition_ragged.launches == before + 1
        ok = ~((u[:, 0] > 0.5) & (hops != hops_p))  # d rounded differently
        assert torch.equal(nxt[ok], nxt_p[ok]), group
        assert torch.equal(hops[ok], hops_p[ok]), group


# r per W: past the kernel's 16 hop uniforms held in registers at W=33
R_OF_W = {1: 3, 31: 16, 32: 3, 33: 20, 257: 1, 4096: 5}


@pytest.mark.parametrize("p_j", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("w", sorted(R_OF_W))
def test_kernel_bitwise_vs_plain(engine, dev, w, p_j, monkeypatch):
    r = R_OF_W[w]
    gen = torch.Generator(device=dev).manual_seed(w + r)
    nodes = torch.randint(0, engine.n, (w,), generator=gen, device=dev,
                          dtype=torch.int32)
    u = teng.draw_uniforms(w, r, p_j, gen, dev)
    _hold_ragged(engine, nodes, u, r, monkeypatch)


@pytest.mark.parametrize("p_j", [0.0, 0.4, 1.0])
def test_kernel_with_every_walk_on_the_hub(engine, dev, p_j, monkeypatch):
    """4096 walks on BA(20k,3)'s hub: every MH walk searches the widest
    segment in several rounds."""
    gen = torch.Generator(device=dev).manual_seed(17)
    hub = int(torch.argmax(engine.degrees))
    nodes = torch.full((4096,), hub, dtype=torch.int32, device=dev)
    u = teng.draw_uniforms(4096, 3, p_j, gen, dev)
    _hold_ragged(engine, nodes, u, 3, monkeypatch)


def _group_width_graph():
    """A path of centers, each with leaves, built by ``from_edges`` (which
    adds a self-loop to every node) so the centers' degrees are G-1, G,
    G+1, 2G and 2G+1 for every lane-group width G."""
    degs = sorted({d for g in wt.RAGGED_GROUPS
                   for d in (g - 1, g, g + 1, 2 * g, 2 * g + 1)})
    k = len(degs)
    src, dst = list(range(k - 1)), list(range(1, k))
    leaf = k
    for i, d in enumerate(degs):
        for _ in range(d - 1 - (i > 0) - (i < k - 1)):
            src.append(i)
            dst.append(leaf)
            leaf += 1
    g = from_edges(leaf, np.array(src), np.array(dst), layout="ragged")
    assert list(g.degrees[:k]) == degs
    return g, k


@pytest.mark.parametrize("p_j", [0.0, 0.4, 1.0])
def test_kernel_on_rows_of_group_width(dev, p_j, monkeypatch):
    """Rows of degree G and G+1 (one round, and past it) for every G."""
    g, k = _group_width_graph()
    lips = np.exp(np.random.default_rng(2).normal(size=g.n))
    eng = teng.WalkEngine.from_graph(g, MHLJParams(p_j, 0.5, 3),
                                     lipschitz=lips, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    nodes = torch.randint(0, k, (4096,), generator=gen, device=dev,
                          dtype=torch.int32)
    u = teng.draw_uniforms(4096, 3, p_j, gen, dev)
    _hold_ragged(eng, nodes, u, 3, monkeypatch)


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


# widths inside one 128-column segment of a warp (below, at and past 32
# lanes), a main-path tile width (ten segments), and one past the warp's
# 32 checkpoint blocks of one segment each (two segments a block)
EDGE_WIDTHS = [1, 31, 32, 33, 1196, 4097]


def _edge_rows(width: int, rng) -> np.ndarray:
    """Non-negative float32 rows of ``width`` that stress the row
    inversion: a degree-like prefix with pads, scattered entries with
    interior zeros, a fully dense row, an all-zero row, a row of -0.0 (with
    one +0.0), denormals, denormals beside one normal entry, a lone entry
    at the last column, and entries from 2^-30 to 2^29."""
    rows = []
    r = np.zeros(width, np.float32)
    deg = max(1, width // 3)
    r[:deg] = rng.random(deg, dtype=np.float32)
    rows.append(r)
    rows.append(np.where(rng.random(width) < 0.2, rng.random(width),
                         0).astype(np.float32))
    rows.append(rng.random(width, dtype=np.float32) + np.float32(1e-3))
    rows.append(np.zeros(width, np.float32))
    r = np.full(width, -0.0, np.float32)
    r[width // 2] = 0.0
    rows.append(r)
    tiny = np.float32(1e-45)  # the smallest denormal
    r = np.where(rng.random(width) < 0.5, tiny * rng.integers(1, 1000, width),
                 0).astype(np.float32)
    r[::7] = np.float32(2.0 ** -126) * rng.random(r[::7].size, dtype=np.float32)
    rows.append(r)
    r = r.copy()
    r[rng.integers(0, width)] = np.float32(0.25)
    rows.append(r)
    r = np.zeros(width, np.float32)
    r[-1] = np.float32(0.7)
    rows.append(r)
    r = np.zeros(width, np.float32)
    r[::5] = np.float32(2.0) ** rng.integers(-30, 30, r[::5].size).astype(
        np.float32)
    rows.append(r)
    return np.stack(rows)


def _edge_u(w: int, rng) -> np.ndarray:
    """w uniforms: random, with 0, 0.5 and the largest float32 below 1
    among them."""
    u = rng.random(w, dtype=np.float32)
    u[::7] = 0.0
    u[1::7] = 0.5
    u[2::7] = np.nextafter(np.float32(1.0), np.float32(0.0))
    return u


def _hold_sparse(rows_t, nbrs_t, u_mh):
    before = wt.walk_transition_sparse.launches
    got = wt.walk_transition_sparse(rows_t, nbrs_t, u_mh)
    assert wt.walk_transition_sparse.launches == before + 1
    want = walk_transition_sparse_ref(rows_t, nbrs_t, u_mh)
    assert torch.equal(got, want), (tuple(rows_t.shape),
                                    int((got != want).sum()))


@pytest.fixture(scope="module")
def bucket_tiles(padded):
    """The P_IS rows and neighbor tiles of every degree bucket of the
    ``padded`` graph as a ``BucketedCSRGraph``, on the card."""
    g = padded[0]
    bg = g.to_bucketed()
    lips = np.exp(np.random.default_rng(0).normal(size=g.n))
    rows_by = mh_importance_rows_bucketed(bg, lips)
    dev = padded[1].device
    return [(torch.as_tensor(rb, device=dev),
             torch.as_tensor(b.neighbors.astype(np.int32), device=dev))
            for rb, b in zip(rows_by, bg.buckets)]


@pytest.mark.parametrize("w", [1, 257, 2049, 4096])
def test_sparse_kernel_bitwise_vs_plain(padded, bucket_tiles, w):
    """On BA tiles (hub walks included), on W walks' tiles at every bucket
    width, and on edge rows at every ``EDGE_WIDTHS`` width with u at 0,
    0.5 and the largest float32 below 1: bitwise equal to the plain
    version.  W=257 and W=2049 leave a block of 8 walks part-filled."""
    g, rows, nbrs, _ = padded
    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(w)
    nodes = _walk_nodes(g, w, gen, dev)
    t_rows, t_nbrs = rows[nodes], nbrs[nodes]
    u_mh = torch.rand(w, generator=gen, device=dev)
    _hold_sparse(t_rows, t_nbrs, u_mh)
    for rows_b, nbrs_b in bucket_tiles:
        pick = torch.randint(0, rows_b.shape[0], (w,), generator=gen,
                             device=dev)
        _hold_sparse(rows_b[pick], nbrs_b[pick], u_mh)
    rng = np.random.default_rng(w)
    for width in EDGE_WIDTHS:
        edge = np.resize(_edge_rows(width, rng), (w, width))
        _hold_sparse(
            torch.as_tensor(edge, device=dev),
            torch.as_tensor(rng.integers(0, 10**6, (w, width)).astype(np.int32),
                            device=dev),
            torch.as_tensor(_edge_u(w, rng), device=dev))
    with pytest.raises(ValueError):
        wt.walk_transition_sparse(t_rows[:, :-1].contiguous(), t_nbrs, u_mh)


def test_sparse_kernel_on_unaligned_rows(padded):
    """Rows whose bases are not 16-byte aligned take the kernel's scalar
    loads: column slices of a wider tile made contiguous at odd widths
    (row w starts at w * width * 4 bytes), and the same tiles copied one
    float past an aligned base."""
    g, rows, nbrs, _ = padded
    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(17)
    nodes = _walk_nodes(g, 2049, gen, dev)
    wide, wide_n = rows[nodes], nbrs[nodes]
    u_mh = torch.rand(2049, generator=gen, device=dev)
    last = wide.shape[1] - 4 - (wide.shape[1] % 2 == 0)  # odd, most columns
    for lo, width in ((0, 301), (1, 33), (3, last)):
        t_rows = wide[:, lo:lo + width].contiguous()
        t_nbrs = wide_n[:, lo:lo + width].contiguous()
        _hold_sparse(t_rows, t_nbrs, u_mh)
        buf = torch.zeros(1 + t_rows.numel(), device=dev)
        off = buf[1:].view(t_rows.shape)
        off.copy_(t_rows)
        assert off.is_contiguous() and off.data_ptr() % 16 == 4
        _hold_sparse(off, t_nbrs, u_mh)


def _edge_table(width: int, rng) -> tuple:
    """A dense-layout table from edge rows: (rows, neighbors, degrees) of
    36 nodes, deg(v) one past the row's last nonzero entry (at least 1),
    the pads past it exact zeros in the rows and v in the neighbor table."""
    rows = np.concatenate([_edge_rows(width, rng) for _ in range(4)])
    n = rows.shape[0]
    nz = rows != 0
    deg = np.where(nz.any(1), width - np.argmax(nz[:, ::-1], 1), 1)
    nbrs = rng.integers(0, n, (n, width))
    pad = np.arange(width)[None, :] >= deg[:, None]
    nbrs = np.where(pad, np.arange(n)[:, None], nbrs)
    return rows, nbrs.astype(np.int32), deg.astype(np.int32)


def _hold_dense(nodes, rows, nbrs, deg, u, r):
    """The dense kernel against its full-width plain version: bitwise
    outside walks whose Lévy distance d rounds differently."""
    before = wt.walk_transition.launches
    nxt, hops = wt.walk_transition(nodes, rows, nbrs, deg, u, p_d=0.5, r=r)
    assert wt.walk_transition.launches == before + 1
    nxt_p, hops_p = walk_transition_ref(nodes, rows, nbrs, deg, u, p_d=0.5,
                                        r=r)
    ok = ~((u[:, 0] > 0.5) & (hops != hops_p))  # d rounded differently
    assert torch.equal(nxt[ok], nxt_p[ok]) and torch.equal(hops[ok], hops_p[ok])


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("w", [1, 257, 2049, 4096])
def test_dense_kernel_bitwise_vs_full_width_plain(padded, w, r):
    """The dense kernel stops each row at deg(v); its plain version
    inverts the full max-degree row.  Bitwise outside d differences, on
    the BA table (hub walks included) and on edge-row tables at every
    ``EDGE_WIDTHS`` width, with u_mh at 0, 0.5 and the largest float32
    below 1 among the draws."""
    g, rows, nbrs, deg = padded
    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(10 * w + r)
    nodes = _walk_nodes(g, w, gen, dev)
    u = teng.draw_uniforms(w, r, 0.4, gen, dev)
    _hold_dense(nodes, rows, nbrs, deg, u, r)
    rng = np.random.default_rng(10 * w + r)
    for width in EDGE_WIDTHS:
        e_rows, e_nbrs, e_deg = (torch.as_tensor(t, device=dev)
                                 for t in _edge_table(width, rng))
        e_nodes = torch.as_tensor(
            rng.integers(0, e_rows.shape[0], w).astype(np.int32), device=dev)
        u[:, teng.U_MH] = torch.as_tensor(_edge_u(w, rng), device=dev)
        _hold_dense(e_nodes, e_rows, e_nbrs, e_deg, u, r)


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


def test_sparse_kernel_gate(padded):
    """The device gate of ``walk_transition_sparse``: live, the kernel's
    pick equals the plain version's; gated off, every pick is 0 (as the
    plain version's ``where``), and each call is one launch."""
    g, rows, nbrs, deg = padded
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    nodes = _walk_nodes(g, 2049, gen, dev)
    u_mh = torch.rand(2049, generator=gen, device=dev)
    tiles = (rows[nodes], nbrs[nodes], u_mh)
    for live in (True, False):
        flag = torch.tensor(live, device=dev)
        before = wt.walk_transition_sparse.launches
        got = wt.walk_transition_sparse(*tiles, flag)
        torch.cuda.synchronize()
        assert wt.walk_transition_sparse.launches == before + 1
        want = walk_transition_sparse_ref(*tiles, live=flag)
        assert torch.equal(got, want)
        assert bool((got == 0).all()) is not live
    with pytest.raises(TypeError):
        wt.walk_transition_sparse(*tiles, torch.tensor(1, device=dev))


# the six engines of chip_smoke.py's layout phase; the compacted ones at a
# capacity that the injected blocks below overflow on about half the steps
CAPTURE_ENGINES = {
    "sparse": dict(layout="sparse"),
    "dense": dict(layout="dense"),
    "bucketed": dict(layout="bucketed", compact=False),
    "bucketed_compact": dict(layout="bucketed", compact=True,
                             capacity_factor=0.85),
    "bucketed_compact_f4": dict(layout="bucketed", compact=True,
                                bucket_factor=4, capacity_factor=0.85),
    "ragged": dict(layout="ragged"),
}
# 50 steps: the first, 8 replays of a 6-step graph, and a 1-step tail
CAPTURE_STEPS = 50


@pytest.fixture(scope="module")
def capture_engines(padded):
    g = padded[0]
    lips = np.exp(np.random.default_rng(0).normal(size=g.n))
    return {name: teng.WalkEngine.from_graph(
                g, MHLJParams(0.3, 0.5, 3), lipschitz=lips,
                device=torch.device("cuda"), **kw)
            for name, kw in CAPTURE_ENGINES.items()}


@pytest.mark.parametrize("name", sorted(CAPTURE_ENGINES))
def test_captured_run_equals_uncaptured(padded, capture_engines, name):
    """``WalkEngine.run`` replayed from CUDA graphs against the same loop
    uncaptured, bit for bit (walks, hops, the (T,) overflow vector), from
    one generator state, whose state after either run is the same; the
    captured run holds no host read (under sync debug mode "error"), and
    each kernel's count equals its launches.  On injected blocks that
    overflow the compacted capacities on some steps only, again."""
    g = padded[0]
    eng = capture_engines[name]
    dev = torch.device("cuda")
    k, replays, tail = tscan.plan(CAPTURE_STEPS)
    assert replays > 1 and tail > 0
    v0 = _walk_nodes(g, 512, torch.Generator(device=dev).manual_seed(1), dev)
    counters = (wt.walk_transition_sparse, wt.walk_transition,
                wt.walk_transition_ragged)
    runs = {}
    for capture in (True, False):
        gen = torch.Generator(device=dev).manual_seed(7)
        before = [c.launches for c in counters]
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error" if capture else old)
        try:
            out = eng.run(v0, CAPTURE_STEPS, generator=gen, with_aux=True,
                          capture=capture)
        finally:
            torch.cuda.set_sync_debug_mode(old)
        torch.cuda.synchronize()
        runs[capture] = (out, gen.get_state(),
                         [c.launches - b for c, b in zip(counters, before)])
    (nc, hc, ac), state_c, launched_c = runs[True]
    (nu, hu, au), state_u, launched_u = runs[False]
    assert torch.equal(nc, nu) and torch.equal(hc, hu)
    assert torch.equal(ac["compact_overflow"], au["compact_overflow"])
    assert torch.equal(state_c, state_u)
    per_step = {"sparse": (1, 0, 0), "dense": (0, 1, 0), "ragged": (0, 0, 1),
                "bucketed": (len(eng.bucket_neighbors or ()), 0, 0)}
    if eng.layout == "bucketed" and eng.compact:
        # both branches of the dispatch: compacted and gated full passes
        want = (2 * len(eng.bucket_neighbors), 0, 0)
    else:
        want = per_step[eng.layout]
    assert launched_c == launched_u == [CAPTURE_STEPS * x for x in want]
    # injected blocks drawn on the CPU
    gen = torch.Generator().manual_seed(3)
    blocks = torch.stack([teng.draw_uniforms(512, 3, 0.3, gen,
                                             torch.device("cpu"))
                          for _ in range(CAPTURE_STEPS)]).to(dev)
    got = [eng.run(v0, CAPTURE_STEPS, uniforms=blocks, with_aux=True,
                   capture=capture) for capture in (True, False)]
    for a, b in zip(*got[:2]):
        if isinstance(a, dict):
            a, b = a["compact_overflow"], b["compact_overflow"]
        assert torch.equal(a, b)
    if eng.layout == "bucketed" and eng.compact:
        over = got[0][2]["compact_overflow"][1:].cpu()
        assert over.any() and not over.all()  # both branches in the graph


def test_captured_launch_counts_equal_the_kernels_the_card_ran(
        capture_engines):
    """Under replay the counts equal the kernel instances CUPTI records."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    v0 = torch.arange(256, dtype=torch.int32, device=dev)
    for name, symbol, counter in (
            ("ragged", "walk_transition_ragged_kernel",
             wt.walk_transition_ragged),
            ("bucketed_compact", "walk_transition_sparse_kernel",
             wt.walk_transition_sparse)):
        eng = capture_engines[name]
        gen = torch.Generator(device=dev).manual_seed(0)
        eng.run(v0, 3, generator=gen)  # builds and loads the library
        torch.cuda.synchronize()
        before = counter.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(v0, CAPTURE_STEPS, generator=gen)
            torch.cuda.synchronize()
        ran = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and symbol in e.name)
        assert counter.launches - before == ran >= CAPTURE_STEPS


def test_captured_trainer_equals_uncaptured(monkeypatch):
    """``run_rw_sgd_multi`` (W=64, avg_every=5, 101 steps: 14 replays of a
    7-step graph and a 2-step tail) replayed from CUDA graphs against
    its uncaptured loop: walks, hops, MSE traces and models bit for bit."""
    from repro_torch.core.graphs import barabasi_albert as ba
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import fleet as tfleet
    from repro_torch.walk_sgd import run_rw_sgd_multi
    from repro_torch.walk_sgd import trainer as ttrain

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the captured loop runs only on the GPU")
    dev = torch.device("cuda")
    g = ba(2_000, 3, seed=0, layout="ragged")
    data = make_heterogeneous_regression(g.n, dim=6, sigma_high_sq=100.0,
                                         p_high=0.03, seed=7, x_star_scale=3.0)
    kw = dict(mhlj_params=MHLJParams(0.1, 0.5, 3), avg_every=5, seed=0,
              device=dev)
    gamma = float(0.3 / data.lipschitz.mean())
    captured = run_rw_sgd_multi("mhlj", g, data, gamma, 101, 64, **kw)
    monkeypatch.setattr(ttrain, "run_fleet",
                        functools.partial(tfleet.run_fleet, capture=False))
    plain = run_rw_sgd_multi("mhlj", g, data, gamma, 101, 64, **kw)
    assert tscan.plan(101) == (7, 14, 2)
    for name in ("update_nodes", "transitions", "mse", "avg_mse", "x_final"):
        np.testing.assert_array_equal(getattr(captured, name),
                                      getattr(plain, name), err_msg=name)
    assert captured.avg_mse[-1] < captured.avg_mse[0]


def test_one_rank_nccl_mesh_trainer_equals_unsharded(dev):
    """``run_rw_sgd_multi(mesh=)`` on a one-rank NCCL walker mesh: the loop
    is captured with its all-reduces in the CUDA graphs, and every field
    equals ``mesh=None``'s bit for bit (under faults too: ``run_fleet``)."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.faults import FaultModel
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.launch.mesh import make_walker_mesh
    from repro_torch.models import regression as treg
    from repro_torch.walk_sgd import fleet as tfleet
    from repro_torch.walk_sgd import run_rw_sgd_multi

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_walker_mesh()
        g = barabasi_albert(2_000, 3, seed=0, layout="ragged")
        data = make_heterogeneous_regression(g.n, dim=6, sigma_high_sq=100.0,
                                             p_high=0.03, seed=7,
                                             x_star_scale=3.0)
        kw = dict(mhlj_params=MHLJParams(0.1, 0.5, 3), avg_every=5, seed=0,
                  device=dev)
        gamma = float(0.3 / data.lipschitz.mean())
        stats = []
        scan = tscan.scan

        def recording(*a, **k):
            out = scan(*a, **k)
            stats.append(out[2])
            return out

        tscan.scan = recording
        try:
            sharded = run_rw_sgd_multi("mhlj", g, data, gamma, 101, 64,
                                       mesh=mesh, **kw)
        finally:
            tscan.scan = scan
        assert stats[0].captured
        plain = run_rw_sgd_multi("mhlj", g, data, gamma, 101, 64, **kw)
        for name in ("update_nodes", "transitions", "mse", "avg_mse",
                     "x_final"):
            np.testing.assert_array_equal(getattr(sharded, name),
                                          getattr(plain, name), err_msg=name)
        fleet = tfleet.WalkFleet.create(
            teng.WalkEngine.from_graph(
                g, MHLJParams(0.1, 0.5, 3),
                row_probs=mh_importance_rows_ragged(g, data.lipschitz),
                device=dev), 64, avg_every=5)
        args = (torch.as_tensor(np.asarray(data.features, np.float32),
                                device=dev),
                torch.as_tensor(np.asarray(data.targets, np.float32),
                                device=dev),
                torch.as_tensor((data.lipschitz.mean() / data.lipschitz)
                                .astype(np.float32), device=dev),
                fleet, 101, gamma,
                torch.full((101,), 0.1, device=dev), True, treg.linear_grad)
        fm = FaultModel(crash_rate=0.05, recovery_rate=0.2, patience=2)
        runs = [tfleet.run_fleet(torch.zeros(64, 6, device=dev), *args,
                                 faults=fm, mesh=m,
                                 generator=torch.Generator(dev).manual_seed(3))
                for m in (mesh, None)]
        for a, b in zip(runs[0][:5], runs[1][:5]):
            assert torch.equal(a, b)
        assert bool(torch.isfinite(runs[0][0]).all())
        assert torch.equal(runs[0][5]["fault_state"].blocked,
                           runs[1][5]["fault_state"].blocked)
    finally:
        dist.destroy_process_group()


def _faulted_case(dev, n=2_000, w=64):
    """A ragged BA(n,3) fleet under Markov faults, the 10 top hubs killed
    for 30 ticks and an edge window over the cut ``id < n/2``."""
    from repro_torch.core import faults as tfaults
    from repro_torch.core.graphs import barabasi_albert as ba
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import trainer as ttrain
    from repro_torch.walk_sgd.fleet import WalkFleet

    g = ba(n, 3, seed=0, layout="ragged")
    data = make_heterogeneous_regression(g.n, dim=6, sigma_high_sq=100.0,
                                         p_high=0.03, seed=7, x_star_scale=3.0)
    rows, weights, sched, p_d, r, _ = ttrain._setup_method(
        "mhlj", g, data, MHLJParams(0.1, 0.5, 3), None, 101)
    eng = ttrain._build_engine(g, p_d, r, rows, None, dev)
    hubs = tfaults.kill_top_hubs(g.degrees, 10, at=20, duration=30,
                                 device=dev)
    cut = tfaults.partition_groups(g.indptr, g.indices,
                                   np.arange(g.n) < g.n // 2, at=10,
                                   duration=40, device=dev)
    fm = dataclasses.replace(hubs, crash_rate=0.05, recovery_rate=0.02,
                             patience=2, edge_down_at=cut.edge_down_at,
                             edge_up_at=cut.edge_up_at)
    fleet = WalkFleet.create(eng, w, seed=0, avg_every=5)
    args = (torch.as_tensor(data.features, dtype=torch.float32, device=dev),
            torch.as_tensor(data.targets, dtype=torch.float32, device=dev),
            torch.as_tensor(weights, device=dev))
    return g, fm, fleet, args, torch.as_tensor(sched, device=dev)


def test_captured_faulted_fleet_equals_uncaptured(dev):
    """``run_fleet(faults=)`` replayed from CUDA graphs (the fault state in
    the carry, three draws a step) against its uncaptured loop from the
    same generator state: walks, hops, models, rescue and blocked totals,
    the final fault state and the generator's state bit for bit; and with
    the rescue off, no rescue."""
    from repro_torch.models import regression as treg
    from repro_torch.walk_sgd import fleet as tfleet

    g, fm, fleet, args, sched = _faulted_case(dev)
    runs = {}
    for rescue in (True, False):
        model = dataclasses.replace(fm, rescue=rescue)
        for capture in (None, False):
            gen = torch.Generator(device=dev).manual_seed(3)
            out = tfleet.run_fleet(
                torch.zeros(64, 6, device=dev), *args, fleet, 101, 0.01,
                sched, True, treg.linear_grad, generator=gen, faults=model,
                capture=capture)
            runs[rescue, capture] = (out, gen.get_state())
    for rescue in (True, False):
        (c, c_gen), (u, u_gen) = runs[rescue, None], runs[rescue, False]
        for i in range(5):
            assert torch.equal(c[i], u[i]), i
        for k in ("nodes", "rescued", "blocked"):
            assert torch.equal(c[5][k], u[5][k]), k
        for k in ("live", "blocked", "t"):
            assert torch.equal(getattr(c[5]["fault_state"], k),
                               getattr(u[5]["fault_state"], k)), k
        assert torch.equal(c_gen, u_gen)
        assert int(c[5]["blocked"].sum()) > 0
        assert (int(c[5]["rescued"].sum()) > 0) == rescue


def test_faulted_fleet_card_equals_cpu_and_resumes_from_disk(dev, tmp_path):
    """The faulted loop on injected streams walks on the card as on the
    CPU; and a kill-and-restore on the card ([0, 50), a checkpoint with the
    models, the FaultState and the generator's state, [50, 101)) equals
    the uninterrupted run bit for bit."""
    from repro_torch import interop
    from repro_torch.models import regression as treg
    from repro_torch.walk_sgd import fleet as tfleet

    g, fm, fleet, args, sched = _faulted_case(dev, n=500, w=16)
    blk = torch.Generator().manual_seed(9)
    u = torch.rand((101, 16, 6), generator=blk)
    u[..., 0] = (u[..., 0] < np.float32(0.1)).to(torch.float32)
    streams = dict(uniforms=u, fault_uniforms=torch.rand((101, g.n),
                                                         generator=blk),
                   rescue_uniforms=torch.rand((101, 16), generator=blk))
    cpu_fleet = tfleet.WalkFleet.restore(fleet.checkpoint(), device="cpu")
    outs = {}
    for d, fl, a in ((dev, fleet, args),
                     ("cpu", cpu_fleet, tuple(x.cpu() for x in args))):
        outs[str(d)] = tfleet.run_fleet(
            torch.zeros(16, 6, device=d), *a, fl, 101, 0.01, sched.to(d),
            True, treg.linear_grad, faults=fm,
            **{k: v.to(d) for k, v in streams.items()})
    card, cpu = outs[str(dev)], outs["cpu"]
    for i in (3, 4):
        assert torch.equal(card[i].cpu(), cpu[i])
    assert torch.equal(card[5]["rescued"].cpu(), cpu[5]["rescued"])

    def run(fl, steps, start, xs, gen, state=None):
        return tfleet.run_fleet(xs, *args, fl, steps, 0.01,
                                sched[start:start + steps], True,
                                treg.linear_grad, generator=gen, faults=fm,
                                fault_state=state, start_step=start,
                                total_steps=101)

    full = run(fleet, 101, 0, torch.zeros(16, 6, device=dev),
               torch.Generator(device=dev).manual_seed(4))
    gen = torch.Generator(device=dev).manual_seed(4)
    a = run(fleet, 50, 0, torch.zeros(16, 6, device=dev), gen)
    st = a[5]["fault_state"]
    path = tfleet.save_fleet_checkpoint(
        str(tmp_path / "card.npz"),
        dataclasses.replace(fleet, nodes=a[5]["nodes"]), step=50,
        extras={"xs": a[0], "fault_live": st.live,
                "fault_blocked": st.blocked, "fault_t": st.t,
                "generator": gen.get_state()})
    loaded, step, ex = tfleet.load_fleet_checkpoint(path, device=dev)
    gen_b = torch.Generator(device=dev)
    gen_b.set_state(torch.from_numpy(ex["generator"]))
    state = interop.fault_state_from_reference(
        live=ex["fault_live"], blocked=ex["fault_blocked"], t=ex["fault_t"],
        device=dev)
    b = run(loaded, 51, 50, torch.as_tensor(ex["xs"], device=dev), gen_b,
            state)
    assert step == 50 and torch.equal(b[0], full[0])
    assert torch.equal(torch.cat([a[3], b[3]], dim=1), full[3])
    assert torch.equal(torch.cat([a[5]["blocked"], b[5]["blocked"]]),
                       full[5]["blocked"])


def test_fig3_mhlj_setting_card_equals_cpu(dev):
    """Fig. 3's mhlj run (``repro_torch.paper.fig3_ring``'s data, step and
    start) at ring(256), T = 2,000, on one injected block: the card's walk
    (through the sparse kernel, once a step) equals the CPU's bit for bit,
    and its MSE trace agrees to 1e-4 relative."""
    from repro_torch.core.graphs import ring
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import run_rw_sgd

    n, steps = 256, 2_000
    data = make_heterogeneous_regression(
        n, dim=10, sigma_high_sq=100.0, p_high=0.002, seed=0,
        force_min_high=2, x_star_scale=10.0,
    )
    u = torch.rand((steps, 1, 6), generator=torch.Generator().manual_seed(1))
    u[..., 0] = (u[..., 0] < np.float32(0.1)).to(torch.float32)
    kw = dict(mhlj_params=MHLJParams(0.1, 0.5, 3), seed=1,
              v0=int(np.argmax(data.lipschitz)))
    gamma = 0.5 / data.lipschitz.mean()
    before = wt.walk_transition_sparse.launches
    card = run_rw_sgd("mhlj", ring(n), data, gamma, steps, uniforms=u.to(dev),
                      device=dev, **kw)
    assert wt.walk_transition_sparse.launches - before == steps
    cpu = run_rw_sgd("mhlj", ring(n), data, gamma, steps, uniforms=u,
                     device="cpu", **kw)
    np.testing.assert_array_equal(card.update_nodes, cpu.update_nodes)
    np.testing.assert_array_equal(card.transitions, cpu.transitions)
    np.testing.assert_allclose(card.mse, cpu.mse, rtol=1e-4)


def test_walk_markov_card_equals_cpu(dev):
    """``core.walk.walk_markov_batched`` on the card launches the sparse
    kernel once a step and walks as the CPU does on the same block."""
    from repro_torch.core import walk as twalk
    from repro_torch.core.graphs import lollipop
    from repro_torch.core.transition import mh_uniform, row_probs_padded

    g = lollipop(40, 30)
    rows = torch.from_numpy(row_probs_padded(mh_uniform(g), g))
    nbrs, _ = twalk.graph_tensors(g, device="cpu")
    u = torch.rand((300, 64, 4), generator=torch.Generator().manual_seed(2))
    u[..., 0] = 0.0
    v0s = torch.arange(64, dtype=torch.int32)
    cpu = twalk.walk_markov_batched(rows, nbrs, v0s, 300, uniforms=u)
    before = wt.walk_transition_sparse.launches
    card = twalk.walk_markov_batched(rows.to(dev), nbrs.to(dev), v0s.to(dev),
                                     300, uniforms=u.to(dev))
    assert wt.walk_transition_sparse.launches - before == 300
    assert torch.equal(card.cpu(), cpu)


# -- dynamic graphs ----------------------------------------------------------


def _churn_case(n=20_000, seed=5):
    """BA(n,3) ragged, Lipschitz exp(N(0,1)) and one batch of 0.1% of the
    undirected edges: deletes between nodes of degree >= 4 (halved on a
    disconnect), then as many non-edge inserts."""
    from repro_torch.core.graphs import apply_edge_churn

    g = barabasi_albert(n, 3, seed=0, layout="ragged")
    rng = np.random.default_rng(seed)
    lips = np.exp(rng.normal(0.0, 1.0, n))
    deg = np.asarray(g.degrees, np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = g.indices.astype(np.int64)
    pairs = np.stack([src, dst], axis=1)[src < dst]
    budget = max(2, int(0.001 * pairs.shape[0]))
    cand = pairs[(deg[pairs[:, 0]] >= 4) & (deg[pairs[:, 1]] >= 4)]
    k = budget // 2
    while True:
        dele = cand[rng.choice(cand.shape[0], size=k, replace=False)]
        try:
            apply_edge_churn(g, delete=dele, check_connectivity=True)
            break
        except ValueError:
            k //= 2
    codes = set((pairs[:, 0] * n + pairs[:, 1]).tolist())
    ins = []
    while len(ins) < budget - k:
        a, b = sorted(int(x) for x in rng.integers(0, n, size=2))
        if a != b and a * n + b not in codes:
            codes.add(a * n + b)
            ins.append((a, b))
    g2, churn = apply_edge_churn(g, insert=np.asarray(ins), delete=dele)
    return g, g2, churn, lips


@pytest.mark.parametrize("source", ["lipschitz", "touched_probs"])
def test_churn_patch_card_equals_cpu(dev, source):
    """The segment-local patch on the card equals the CPU's patch and the
    card's from-scratch build, bit for bit, from both row sources."""
    g, g2, churn, lips = _churn_case()
    if source == "lipschitz":
        kw, patch = dict(lipschitz=lips), dict(lipschitz=lips)
        scratch = dict(lipschitz=lips)
    else:
        kw = dict(row_probs=mh_importance_rows_ragged(g, lips))
        patch = dict(touched_probs=mh_importance_rows_ragged(
            g2, lips, node_ids=churn.touched_rows))
        scratch = dict(row_probs=mh_importance_rows_ragged(g2, lips))
    outs = {}
    for d in (dev, "cpu"):
        e = teng.WalkEngine.from_graph(g, MHLJParams(0.1, 0.5, 3),
                                       device=d, **kw)
        outs[str(d)] = e.apply_churn(g2, churn, **patch).edge_cdf.cpu()
    rebuilt = teng.ragged_edge_cdf(g2.indptr, g2.indices, g2.degrees,
                                   device=dev, **scratch).cpu()
    assert torch.equal(outs[str(dev)].view(torch.int32),
                       outs["cpu"].view(torch.int32))
    assert torch.equal(outs[str(dev)].view(torch.int32),
                       rebuilt.view(torch.int32))


def test_churned_engine_captured_equals_uncaptured(dev):
    """On the churned engine (fresh buffers) ``run`` captures anew: the
    captured loop equals the uncaptured one from the same generator state
    (walks, hops, generator), and launches the ragged kernel every step."""
    g, g2, churn, lips = _churn_case()
    e = teng.WalkEngine.from_graph(g, MHLJParams(0.1, 0.5, 3),
                                   lipschitz=lips, device=dev)
    e2 = e.apply_churn(g2, churn, lipschitz=lips)
    v0 = torch.arange(2048, dtype=torch.int32, device=dev) * 7 % g.n
    e.run(v0, 20, generator=torch.Generator(device=dev).manual_seed(1))
    runs = {}
    for capture in (None, False):
        gen = torch.Generator(device=dev).manual_seed(2)
        before = wt.walk_transition_ragged.launches
        nodes, hops = e2.run(v0, 200, generator=gen, capture=capture)
        torch.cuda.synchronize()
        runs[capture] = (nodes, hops, gen.get_state(),
                         wt.walk_transition_ragged.launches - before)
    (n_c, h_c, s_c, l_c), (n_u, h_u, s_u, l_u) = runs[None], runs[False]
    assert torch.equal(n_c, n_u) and torch.equal(h_c, h_u)
    assert torch.equal(s_c, s_u) and l_c == l_u == 200


def test_run_dada_captured_equals_uncaptured(dev):
    """``run_dada`` on the card, captured against ``capture=False``: every
    ``DadaResult`` field bit for bit (each round re-captures)."""
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import run_dada

    g = barabasi_albert(300, 3, seed=2, layout="csr")
    data = make_heterogeneous_regression(300, dim=5, seed=3)
    res = {c: run_dada(g, data, rounds=3, num_steps=100, num_walks=16, k=3,
                       avg_every=10, seed=5, capture=c, device=dev)
           for c in (None, False)}
    for f in ("round_mse", "personalized_mse", "edges_inserted",
              "edges_deleted", "walks_displaced", "graph_versions",
              "x_final"):
        assert np.array_equal(getattr(res[None], f), getattr(res[False], f)), f
    assert res[None].graph_versions.tolist() == [0, 1, 2]


def test_samplers_card_equal_cpu(dev):
    """BA(20k,3) edges and an SBM 4x250 mask and graph from the same
    uniforms: the card equals the CPU bit for bit."""
    from repro_torch.core import torch_sampling as ts

    gen = torch.Generator().manual_seed(0)
    u = torch.rand(3 * (20_000 - 3), generator=gen)
    card = ts.barabasi_albert_edges(20_000, 3, uniforms=u, device=dev)
    cpu = ts.barabasi_albert_edges(20_000, 3, uniforms=u, device="cpu")
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)
    sizes = [250] * 4
    us = [torch.rand(1000 * 999 // 2, generator=gen) for _ in range(8)]
    g_card = ts.sbm_torch(sizes, 0.1, 0.002, uniforms=us, device=dev)
    g_cpu = ts.sbm_torch(sizes, 0.1, 0.002, uniforms=us, device="cpu")
    for f in ("indptr", "indices", "degrees"):
        assert np.array_equal(getattr(g_card, f), getattr(g_cpu, f))


# -- the LLM kernels ------------------------------------------------------------

LLM_TOL = {"flash": {torch.float32: 2e-5, torch.bfloat16: 2e-2,
                     torch.float16: 2e-3},
           "ssd": {torch.float32: 2e-4, torch.bfloat16: 6e-2,
                   torch.float16: 2e-3},
           "rmsnorm": {torch.float32: 1e-5, torch.bfloat16: 3e-2,
                       torch.float16: 2e-3}}


def _randn(shape, dtype, gen, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


# -- plain models of the two attention kernels' arithmetic (any device; the
# CPU tests hold them to the JAX kernel, the card tests hold the kernels to
# them) --

def _wgmma_bf16_numerics(q, k, v, *, causal, window, bq=128, bk=128,
                         scale_dim=None, dtype=torch.bfloat16):
    """A plain blockwise model of ``csrc/flash_attention_wgmma.cu``'s
    arithmetic, (B, N, S, h) bf16 in and out: float32 scores of the bf16
    inputs; per 128-row q block, the kernel's live 128-row k blocks with an
    online softmax in base 2 (m on the unscaled scores, p = 2^((s - m) *
    h^-1/2 * log2 e)); l summed from the float32 p; p rounded to bf16
    before p @ v, summed in float32; acc / max(l, 1e-30) in bf16.
    ``scale_dim`` replaces h in the scale (the kernel's true head_dim when
    the inputs are zero-padded to the head_dim it is built at); ``dtype``
    is the 16-bit type p and the output are rounded to (float16 for the
    kernel's float16 build)."""
    b, n, s, h = q.shape
    kh, t = k.shape[1], k.shape[2]
    c = torch.tensor((scale_dim or h)**-0.5 * 1.4426950408889634,
                     dtype=torch.float32)
    dev = q.device
    out = torch.empty((b, n, s, h), dtype=torch.float32, device=dev)
    for head in range(n):
        qh = q[:, head].float()
        kk, vv = k[:, head * kh // n].float(), v[:, head * kh // n].float()
        for i0 in range(0, s, bq):
            rows = torch.arange(i0, min(i0 + bq, s), device=dev)[:, None]
            m = torch.full((b, len(rows), 1), -1e30, device=dev)
            l = torch.zeros((b, len(rows), 1), device=dev)
            acc = torch.zeros((b, len(rows), h), device=dev)
            for j0 in range(0, t, bk):
                if causal and j0 > i0 + bq - 1:
                    break
                if causal and window > 0 and j0 + bk - 1 < i0 - window + 1:
                    continue
                cols = torch.arange(j0, min(j0 + bk, t), device=dev)[None, :]
                sc = qh[:, rows[:, 0]] @ kk[:, cols[0]].transpose(1, 2)
                keep = (cols < t).expand(len(rows), -1)
                if causal:
                    keep = keep & (cols <= rows)
                    if window > 0:
                        keep = keep & (cols > rows - window)
                sc = torch.where(keep, sc, torch.tensor(-1e30))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha = torch.exp2((m - m_new) * c)
                p = torch.exp2((sc - m_new) * c)
                l = alpha * l + p.sum(-1, keepdim=True)
                acc = alpha * acc + p.to(dtype).float() @ vv[:, cols[0]]
                m = m_new
            out[:, head, rows[:, 0]] = acc / torch.clamp(l, min=1e-30)
    return out.to(dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 x rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero, as integer arithmetic on the
    float32 bits (the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, split: bool = True,
                 apart: bool = False, step: int = 8) -> torch.Tensor:
    """a @ b in float32 as the mma_sync kernel's float32 build forms it:
    each operand x as big = tf32(x) and small = tf32(x - big), and per
    k-step of ``step`` columns small·big, then big·small, then big·big
    added to a float32 sum from zero; ``apart``: the small terms into a sum
    of their own, added to the big terms' at the end (the scores);
    ``split=False``: one TF32 product a k-step."""
    ab, bb = _tf32(a), _tf32(b)
    sa, sb = _tf32(a.float() - ab), _tf32(b.float() - bb)
    big = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                      device=a.device)
    small = big.clone()
    for d0 in range(0, a.shape[-1], step):
        ka = (slice(None),) * (a.ndim - 1) + (slice(d0, d0 + step),)
        kb = (slice(None),) * (b.ndim - 2) + (slice(d0, d0 + step), slice(None))
        if split and apart:
            small = small + sa[ka] @ bb[kb]
            small = small + ab[ka] @ sb[kb]
        elif split:
            big = big + sa[ka] @ bb[kb]
            big = big + ab[ka] @ sb[kb]
        big = big + ab[ka] @ bb[kb]
    return big + small if split and apart else big


def _split_tf32_numerics(q, k, v, *, causal, window, split=True, bq=128,
                         bk=16, scale_dim=None, stats=False):
    """A plain blockwise model of ``csrc/flash_attention.cu``'s float32
    arithmetic, (B, N, S, h) float32 in (v may be a slice of the columns),
    float32 out: per ``bq``-row q block and live ``bk``-row key block, the
    scores by :func:`_tf32_matmul` (split TF32 with the small terms summed
    apart, or one TF32 product with ``split=False``), scaled by h^-1/2
    (``scale_dim`` in place of h) and masked to -1e30; the online softmax in
    float32 (p = exp(s - m)); acc * alpha + the block's P v by
    :func:`_tf32_matmul` on the float32 p, from zero; acc / max(l, 1e-30).
    ``stats``: also the final running max and sum, (B, N, S) each."""
    b, n, s, h = q.shape
    kh, t, hv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    scale = torch.tensor((scale_dim or h)**-0.5, dtype=torch.float32)
    out = torch.empty((b, n, s, hv), dtype=torch.float32, device=dev)
    m_all = torch.empty((b, n, s), dtype=torch.float32, device=dev)
    l_all = torch.empty((b, n, s), dtype=torch.float32, device=dev)
    for head in range(n):
        qh = q[:, head].float()
        kk, vv = k[:, head * kh // n].float(), v[:, head * kh // n].float()
        for i0 in range(0, s, bq):
            rows = torch.arange(i0, min(i0 + bq, s), device=dev)[:, None]
            m = torch.full((b, len(rows), 1), -1e30, device=dev)
            l = torch.zeros((b, len(rows), 1), device=dev)
            acc = torch.zeros((b, len(rows), hv), device=dev)
            for j0 in range(0, t, bk):
                if causal and j0 > i0 + bq - 1:
                    break
                if causal and window > 0 and j0 + bk - 1 < i0 - window + 1:
                    continue
                cols = torch.arange(j0, min(j0 + bk, t), device=dev)[None, :]
                sc = _tf32_matmul(qh[:, rows[:, 0]],
                                  kk[:, cols[0]].transpose(1, 2), split,
                                  apart=True)
                keep = (cols < t).expand(len(rows), -1)
                if causal:
                    keep = keep & (cols <= rows)
                    if window > 0:
                        keep = keep & (cols > rows - window)
                sc = torch.where(keep, sc * scale, torch.tensor(-1e30))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                l = alpha * l + p.sum(-1, keepdim=True)
                acc = alpha * acc + _tf32_matmul(p, vv[:, cols[0]], split)
                m = m_new
            out[:, head, rows[:, 0]] = acc / torch.clamp(l, min=1e-30)
            m_all[:, head, rows[:, 0]] = m[..., 0]
            l_all[:, head, rows[:, 0]] = l[..., 0]
    return (out, m_all, l_all) if stats else out


def _mma_sync_numerics(q, k, v, *, causal, window, split=True):
    """A plain model of ``csrc/flash_attention.cu`` (the ``mma_sync``
    route), (B, N, S, h) in, q's dtype out: float32 by
    :func:`_split_tf32_numerics` at the kernel's tiles (128 q rows and
    16 keys to h = 128, 64 and 16 to 256, 64 and 32 past it); bf16 and
    float16 by :func:`_wgmma_bf16_numerics` at its tiles (128 q rows and 48
    keys to h = 128, 64 and 64 past it) with h zero-padded to a multiple
    of 16 and the true h's scale.  Past h = 256
    the kernel's slices form the same scores, and each output column
    depends on its own column of v only, so one model covers them."""
    h = q.shape[-1]
    wide = -(-h // -(-h // 256)) > 128  # the slices' width past 128
    if q.dtype == torch.float32:
        return _split_tf32_numerics(
            q, k, v, causal=causal, window=window, split=split,
            bq=64 if wide else 128, bk=32 if h > 256 else 16)
    pad = -h % 16
    padded = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    return _wgmma_bf16_numerics(
        *padded, causal=causal, window=window, bq=64 if wide else 128,
        bk=64 if wide else 48, scale_dim=h, dtype=q.dtype)[..., :h]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,nq,nkv,h,causal,window",
    [
        (1, 128, 4, 4, 64, True, 0),      # MHA
        (2, 256, 8, 2, 64, True, 0),      # GQA 4:1
        (1, 256, 4, 1, 128, True, 0),     # MQA
        (2, 128, 4, 4, 64, False, 0),     # bidirectional
        (1, 384, 4, 2, 64, True, 128),    # sliding window
        (1, 1000, 8, 2, 128, True, 0),    # S not a block multiple
        (2, 150, 4, 4, 64, False, 0),     # tail mask, bidirectional
    ],
)
def test_flash_kernel_vs_plain(dev, b, s, nq, nkv, h, causal, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(s + nq)
    q = _randn((b, s, nq, h), dtype, gen, dev)
    k, v = (_randn((b, s, nkv, h), dtype, gen, dev) for _ in range(2))
    before = fa_ops.mha.launches
    out = fa_ops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches == before + 1
    tol = LLM_TOL["flash"][dtype]
    torch.testing.assert_close(out.float(), mha_ref(q, k, v, causal=causal,
                                                    window=window).float(),
                               atol=tol, rtol=tol)


def test_flash_kernel_raises_on_what_it_does_not_take(dev):
    """A head_dim of 0, a non-contiguous input, mixed dtypes, and float64
    (which the reference's kernel never sees with JAX's x64 off) raise,
    unlaunched; float16 and head_dims past 256 are taken (below)."""
    before = fa_ops.mha.launches
    q = torch.zeros((1, 64, 4, 0), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.mha(q, q, q)
    q = torch.zeros((1, 64, 4, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.mha(q.transpose(1, 2), q, q)
    with pytest.raises(TypeError):
        fa_ops.mha(q, q.half(), q)
    with pytest.raises(TypeError):
        fa_ops.mha(q.double(), q.double(), q.double())
    assert fa_ops.mha.launches == before


# q/k/v shapes the two routes meet beyond the cases above: qwen2.5-32b's
# grouping (N/K = 5), one query row, minitron-8b's full layer in bf16, a
# window at h=128, and T != S, not a multiple of the 128-row key block,
# without the causal mask.
@pytest.mark.parametrize(
    "dtype,b,s,t,nq,nkv,h,causal,window",
    [
        (torch.bfloat16, 1, 300, 300, 40, 8, 128, True, 0),
        (torch.float32, 1, 300, 300, 40, 8, 128, True, 0),
        (torch.bfloat16, 2, 1, 1, 8, 2, 128, True, 0),
        (torch.bfloat16, 2, 1, 1, 8, 2, 64, True, 0),
        (torch.float32, 2, 1, 1, 8, 2, 64, True, 0),
        (torch.bfloat16, 1, 4096, 4096, 32, 8, 128, True, 0),
        (torch.bfloat16, 1, 700, 700, 8, 2, 128, True, 128),
        (torch.float32, 1, 700, 700, 8, 2, 128, True, 128),
        (torch.bfloat16, 2, 200, 333, 4, 2, 128, False, 0),
        (torch.bfloat16, 1, 130, 77, 4, 4, 64, False, 0),
        (torch.float32, 2, 200, 333, 4, 2, 64, False, 0),
    ],
)
def test_flash_routes_vs_plain(dev, dtype, b, s, t, nq, nkv, h, causal, window):
    gen = torch.Generator(device=dev).manual_seed(s + t + nq + h)
    q = _randn((b, s, nq, h), dtype, gen, dev)
    k, v = (_randn((b, t, nkv, h), dtype, gen, dev) for _ in range(2))
    route = fa_ops.route_of(dtype)
    before = fa_ops.mha.launches_by_route[route]
    out = fa_ops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.mha.launches_by_route[route] == before + 1
    tol = LLM_TOL["flash"][dtype]
    torch.testing.assert_close(out.float(), mha_ref(q, k, v, causal=causal,
                                                    window=window).float(),
                               atol=tol, rtol=tol)


def test_flash_routes_by_dtype(dev):
    """bf16 launches the wgmma kernel, float32 the mma.sync kernel."""
    q = torch.randn((1, 64, 4, 64), device=dev)
    for dtype, route in ((torch.bfloat16, "wgmma_bf16"),
                         (torch.float32, "mma_sync")):
        x = q.to(dtype)
        before = dict(fa_ops.mha.launches_by_route)
        fa_ops.mha(x, x, x)
        after = fa_ops.mha.launches_by_route
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bf16_raises_on_unaligned_base(dev, dtype):
    """TMA needs 16-byte aligned bases: a q 2 bytes off goes to the
    mma.sync kernel (one launch there, none on wgmma), which reads any
    base, and agrees with the plain version."""
    shape = (1, 300, 4, 64)
    gen = torch.Generator(device=dev).manual_seed(2)
    buf = torch.randn(1 + int(np.prod(shape)), generator=gen,
                      device=dev).to(dtype)
    q = buf[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    k, v = (_randn((1, 300, 2, 64), dtype, gen, dev) for _ in range(2))
    assert fa_ops.route_of(dtype, 64, aligned=False) == "mma_sync"
    before = dict(fa_ops.mha.launches_by_route)
    out = fa_ops.mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    after = fa_ops.mha.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        "wgmma_bf16": 0, "mma_sync": 1}
    tol = LLM_TOL["flash"][dtype]
    torch.testing.assert_close(out.float(), mha_ref(q, k, v).float(),
                               atol=tol, rtol=tol)


# The head_dims the two routes take beyond 64 and 128: paligemma-3b's
# attention layer at full width (h=256, MQA), h=256 windowed and with T != S
# on the wgmma kernel's 64-row key blocks, h=80 and 96 (multiples of 8,
# zero-filled by TMA up to 128), the smallest wgmma head_dim, and the
# head_dims that are not multiples of 8 on the mma.sync kernel in bf16, as
# float32 does at any head_dim.
@pytest.mark.parametrize(
    "dtype,b,s,t,nq,nkv,h,causal,window,route",
    [
        (torch.bfloat16, 1, 4096, 4096, 8, 1, 256, True, 0, "wgmma_bf16"),
        (torch.bfloat16, 2, 300, 300, 4, 1, 256, True, 128, "wgmma_bf16"),
        (torch.bfloat16, 1, 130, 257, 2, 2, 256, False, 0, "wgmma_bf16"),
        (torch.bfloat16, 1, 700, 700, 8, 2, 80, True, 0, "wgmma_bf16"),
        (torch.bfloat16, 2, 300, 300, 4, 2, 96, True, 128, "wgmma_bf16"),
        (torch.bfloat16, 1, 333, 200, 4, 4, 96, False, 0, "wgmma_bf16"),
        (torch.bfloat16, 1, 200, 200, 4, 2, 8, True, 0, "wgmma_bf16"),
        (torch.bfloat16, 1, 500, 500, 4, 2, 100, True, 0, "mma_sync"),
        (torch.bfloat16, 1, 150, 150, 2, 1, 1, False, 0, "mma_sync"),
        (torch.float32, 1, 1000, 1000, 8, 2, 256, True, 0, "mma_sync"),
        (torch.float32, 1, 300, 300, 4, 2, 96, True, 64, "mma_sync"),
        (torch.float32, 2, 130, 77, 2, 2, 33, False, 0, "mma_sync"),
    ],
)
def test_flash_widened_head_dims_vs_plain(dev, dtype, b, s, t, nq, nkv, h,
                                          causal, window, route):
    gen = torch.Generator(device=dev).manual_seed(s + t + nq + h)
    q = _randn((b, s, nq, h), dtype, gen, dev)
    k, v = (_randn((b, t, nkv, h), dtype, gen, dev) for _ in range(2))
    assert fa_ops.route_of(dtype, h) == route
    before = dict(fa_ops.mha.launches_by_route)
    out = fa_ops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = fa_ops.mha.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    tol = LLM_TOL["flash"][dtype]
    torch.testing.assert_close(out.float(), mha_ref(q, k, v, causal=causal,
                                                    window=window).float(),
                               atol=tol, rtol=tol)


# bf16 shapes of the cases below that the mma kernel takes: every
# (d_state, chunk) it compiles for, at P=64 (the rest, and every float32
# case, go to the split-TF32 kernel)
SSD_MMA_SHAPES = {(64, n, chunk) for n in (64, 128) for chunk in (64, 128, 256)}


# (4, 32, 1024, 64, 128, 256): mamba2-370m's layer at L=1024
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,l,p,n,chunk", [(1, 4, 128, 32, 16, 32),
                                             (2, 3, 96, 64, 32, 32),
                                             (1, 2, 512, 64, 64, 128),
                                             (1, 2, 512, 64, 128, 256),
                                             (4, 32, 1024, 64, 128, 256)])
def test_ssd_kernel_vs_plain(dev, b, h, l, p, n, chunk, dtype):
    gen = torch.Generator(device=dev).manual_seed(l + n)
    xs = _randn((b, h, l, p), dtype, gen, dev)
    dt = torch.nn.functional.softplus(torch.randn((b, h, l), generator=gen,
                                                  device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    da = dt * a[None, :, None]
    bs, cs = (_randn((b, h, l, n), dtype, gen, dev) for _ in range(2))
    route = ("mma_bf16" if dtype == torch.bfloat16 and (p, n, chunk) in
             SSD_MMA_SHAPES else "mma_tf32")
    assert ssd_ops.route_of(dtype, p, n, chunk) == route
    before = ssd_ops.ssd_scan.launches
    by_route = dict(ssd_ops.ssd_scan.launches_by_route)
    y = ssd_ops.ssd_scan(xs, da, dt, bs, cs, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches == before + 1
    after = ssd_ops.ssd_scan.launches_by_route
    assert {r: after[r] - by_route[r] for r in after} == {
        r: int(r == route) for r in after}
    plain = ssd_scan_ref(xs, da, dt, bs, cs, chunk=chunk)
    if dtype == torch.float32 and n * chunk > 64 * 64:
        # at the main path's N=128, chunk 256 each output sums ~3e4 float32
        # products of N(0,1) data, and two summation orders differ by up to
        # ~6e-4 where terms cancel (measured on an H100): hold the kernel to
        # the float64 result, no worse than twice the plain version's error.
        # At N=64, chunk 128 the kernel's float32 within-chunk cumsum missed
        # this rule by 2.1x (measured on an H100, where the numerics model
        # _ssd_f32_cuda_core_numerics with that cumsum gave the kernel's
        # output bit for bit): summation order, as exp(cum_i - cum_j) turns
        # cum's rounding (~ulp(100)) into a relative error.  The kernel now
        # accumulates the cumsum in float64 and holds the rule here too.
        exact = ssd_scan_ref(*(t.double() for t in (xs, da, dt, bs, cs)),
                             chunk=chunk)
        err_k = (y.double() - exact).abs().max().item()
        err_p = (plain.double() - exact).abs().max().item()
        assert err_k <= 2 * err_p, (err_k, err_p)
    else:
        tol = LLM_TOL["ssd"][dtype]
        torch.testing.assert_close(y, plain, atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.ssd_scan(xs, da, dt, bs, cs, chunk=l + 1)


# The shapes the float32 route's kernel takes beyond head_dim 64 and
# d_state 128: head_dim 128 and 80 (two slabs of at most 64 channels),
# d_state 256 and 200 and 24 (zero-padded to a multiple of 16), in float32
# and in bf16 (every bf16 shape outside the mma table goes there).  The
# float32 cases at N * chunk > 64 * 64 are held to the float64 result, no
# worse than twice the plain version's error, as test_ssd_kernel_vs_plain
# holds them.
@pytest.mark.parametrize(
    "dtype,b,h,l,p,n,chunk",
    [
        (torch.float32, 1, 2, 512, 128, 256, 256),
        (torch.float32, 1, 2, 512, 80, 200, 256),
        (torch.float32, 2, 3, 96, 100, 40, 32),
        (torch.bfloat16, 1, 4, 128, 32, 24, 32),
        (torch.bfloat16, 1, 2, 512, 128, 256, 256),
    ],
)
def test_ssd_widened_shapes_vs_plain(dev, dtype, b, h, l, p, n, chunk):
    gen = torch.Generator(device=dev).manual_seed(l + n + p)
    xs = _randn((b, h, l, p), dtype, gen, dev)
    dt = torch.nn.functional.softplus(torch.randn((b, h, l), generator=gen,
                                                  device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    da = dt * a[None, :, None]
    bs, cs = (_randn((b, h, l, n), dtype, gen, dev) for _ in range(2))
    assert ssd_ops.route_of(dtype, p, n, chunk) == "mma_tf32"
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    y = ssd_ops.ssd_scan(xs, da, dt, bs, cs, chunk=chunk)
    torch.cuda.synchronize()
    after = ssd_ops.ssd_scan.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        "mma_bf16": 0, "mma_tf32": 1}
    plain = ssd_scan_ref(xs, da, dt, bs, cs, chunk=chunk)
    if dtype == torch.float32 and n * chunk > 64 * 64:
        exact = ssd_scan_ref(*(t.double() for t in (xs, da, dt, bs, cs)),
                             chunk=chunk)
        err_k = (y.double() - exact).abs().max().item()
        err_p = (plain.double() - exact).abs().max().item()
        assert err_k <= 2 * err_p, (err_k, err_p)
    else:
        tol = LLM_TOL["ssd"][dtype]
        torch.testing.assert_close(y, plain, atol=tol, rtol=tol)


def test_ssd_slabs_and_padded_states_keep_the_narrow_bits(dev):
    """Head_dim 128 runs as two slabs of 64 channels, each column with the
    adds of a 64-channel run: its halves equal two runs at head_dim 64 bit
    for bit.  d_state 24 is padded to 32 with zero columns of B and C:
    equal bit for bit to a run at d_state 32 with B and C zero-padded."""
    gen = torch.Generator(device=dev).manual_seed(29)
    b, h, l, chunk = 1, 3, 256, 128
    xs = torch.randn((b, h, l, 128), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, h, l), generator=gen,
                                                  device=dev))
    da = dt * -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))[:, None]
    bs, cs = (torch.randn((b, h, l, 24), generator=gen, device=dev)
              for _ in range(2))
    wide = ssd_ops.ssd_scan(xs, da, dt, bs, cs, chunk=chunk)
    for half in (slice(0, 64), slice(64, 128)):
        narrow = ssd_ops.ssd_scan(xs[..., half].contiguous(), da, dt, bs, cs,
                                  chunk=chunk)
        assert torch.equal(wide[..., half], narrow)
    pad = torch.nn.functional.pad
    padded = ssd_ops.ssd_scan(xs, da, dt, pad(bs, (0, 8)), pad(cs, (0, 8)),
                              chunk=chunk)
    assert torch.equal(wide, padded)


def _ssd_head_major(b, h, l, p, n, seed, cancel=False, slow=False):
    """Head-major x, da, dt, B, C as float32 numpy arrays from numpy's
    ``seed``.  With ``slow`` the decay rate is cut 100-fold, so the state
    carried into a chunk still weighs on outputs several chunks on; with
    ``cancel`` (slow too) rows come in pairs with equal B and dt and
    opposite x, so each output is a small difference of large terms."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, h, l, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, l)))).astype(np.float32)
    bs, cs = (rng.standard_normal((b, h, l, n)).astype(np.float32)
              for _ in range(2))
    rate = -np.exp(rng.standard_normal(h) * 0.3)
    if cancel:
        xs[:, :, 1::2] = -xs[:, :, ::2]
        bs[:, :, 1::2] = bs[:, :, ::2]
        dt[:, :, 1::2] = dt[:, :, ::2]
    if cancel or slow:
        rate = rate * 1e-2
    da = (dt * rate[None, :, None]).astype(np.float32)
    return xs, da, dt, bs, cs


# float16 inputs whose float32 operands in the mma route pass float16's
# 65504: ((B, H, L, P, N, chunk), the scale of |x| and |B|, da); dt = 1, C
# = 0.01 N(0, 1).  In "probe" the entering state reaches ~7e4, in "strong"
# ~2e6; in "growing" da > 0, so att (~1e5) is largest in a row's first
# tile and the state grows by ~4e5 a chunk.
SSD_RANGE_CASES = {
    "probe": ((1, 2, 512, 64, 64, 64), 16.0, -1e-3),
    "strong": ((1, 2, 1024, 64, 128, 256), 64.0, -1e-4),
    "growing": ((1, 2, 256, 64, 64, 64), 4.0, 0.2),
}


def _ssd_range_head_major(case: str) -> tuple:
    """``SSD_RANGE_CASES[case]``'s head-major x, da, dt, B, C as numpy
    arrays (x, B, C float16; da, dt float32), drawn from numpy's seed L +
    N + chunk, and the chunk."""
    (b, h, l, p, n, chunk), scale, rate = SSD_RANGE_CASES[case]
    rng = np.random.default_rng(l + n + chunk)
    xs = (scale * np.abs(rng.standard_normal((b, h, l, p)))).astype(np.float16)
    bs = (scale * np.abs(rng.standard_normal((b, h, l, n)))).astype(np.float16)
    cs = (0.01 * rng.standard_normal((b, h, l, n))).astype(np.float16)
    dt = np.ones((b, h, l), np.float32)
    da = np.full((b, h, l), rate, np.float32)
    return (xs, da, dt, bs, cs), chunk


def _ssd_inputs(b, h, l, p, n, seed, dev, cancel=False, slow=False):
    """``_ssd_head_major`` on ``dev``: x, B, C in bf16, da and dt float32."""
    return tuple(torch.from_numpy(t).to(dev).to(
        torch.bfloat16 if t.ndim == 4 else torch.float32)
        for t in _ssd_head_major(b, h, l, p, n, seed, cancel, slow))


def _ssd_f32_cuda_core_numerics(xs, da, dt, bs, cs, *, chunk, cum_f64=True):
    """A plain model of the float32 arithmetic of ``csrc/ssd_scan.cu``'s
    first design (route ``cuda_core_f32``: float32 on the CUDA cores, one
    CTA per slab walking its chunks in order; since replaced by the
    arithmetic :func:`_ssd_tf32_numerics` models): head-major inputs on
    any device, y (B, H, L, P) float32 out.  Every sum runs in the
    kernel's order with each product and add rounded alone (the kernel
    built with --fmad=false): the scores C_i . B_j and the state term
    C_i @ state over n; y_i = exp(cum_i) (C_i @ state), then + att[i, j] x_j over j in order, with att =
    (scores exp(cum_i - cum_j)) dt_j; the state update over j in order,
    (B_j w_j) x_j with w_j = exp(cum_Q - cum_j) dt_j, then
    exp(cum_Q) state + that.  The within-chunk cumsum is accumulated in
    float64 and rounded once (``cum_f64``, the kernel's), or in float32 as
    the kernel's first version did: per-lane sequential sums of
    ceil(Q/32) entries, a 32-lane Hillis-Steele scan of the lane totals,
    and each lane's exclusive prefix added to its sums."""
    b, h, l, p = xs.shape
    n = bs.shape[-1]
    dev = xs.device
    x_all, b_all, c_all = (t.float() for t in (xs, bs, cs))
    state = torch.zeros((b, h, n, p), device=dev)
    y = torch.empty((b, h, l, p), device=dev)
    per = -(-chunk // 32)
    lane = torch.arange(32, device=dev)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    for c0 in range(0, l, chunk):
        sl = slice(c0, c0 + chunk)
        x, bb, cc = x_all[:, :, sl], b_all[:, :, sl], c_all[:, :, sl]
        dtc = dt[:, :, sl].float()
        if cum_f64:
            cum = torch.cumsum(da[:, :, sl].double(), dim=-1).float()
        else:
            d = torch.nn.functional.pad(da[:, :, sl].float(),
                                        (0, 32 * per - chunk))
            local = d.reshape(b, h, 32, per).clone()
            for k in range(1, per):
                local[..., k] = local[..., k - 1] + local[..., k]
            incl = local[..., -1]
            for off in (1, 2, 4, 8, 16):
                incl = torch.where(lane >= off,
                                   incl + torch.roll(incl, off, dims=-1), incl)
            excl = torch.where(lane >= 1, torch.roll(incl, 1, dims=-1), 0.0)
            cum = (local + excl[..., None]).reshape(b, h, -1)[..., :chunk]
        scores = torch.zeros((b, h, chunk, chunk), device=dev)
        carried = torch.zeros((b, h, chunk, p), device=dev)
        for k in range(n):
            scores = scores + cc[..., :, k, None] * bb[..., None, :, k]
            carried = carried + cc[..., :, k, None] * state[..., None, k, :]
        decay = torch.exp(cum[..., :, None] - cum[..., None, :])
        att = torch.where(causal, (scores * decay) * dtc[..., None, :], 0.0)
        yc = torch.exp(cum)[..., None] * carried
        for j in range(chunk):
            yc = yc + att[..., :, j, None] * x[..., None, j, :]
        y[:, :, sl] = yc
        last = cum[..., -1:]
        w = torch.exp(last - cum) * dtc
        update = torch.zeros_like(state)
        for j in range(chunk):
            update = update + (bb[..., j, :, None] * w[..., j, None, None]) * (
                x[..., j, None, :])
        state = torch.exp(last)[..., None] * state + update
    return y


def _tf32_blocks(a, b, run=None, *, four=False, split=True, block=64,
                 step=8):
    """a @ b in float32 as ``csrc/ssd_scan.cu`` forms its products: each
    operand v as big = tf32(v) and small = tf32(v - big) (a bf16 or
    float16 value is exact in TF32, its small part 0); per k-step of
    ``step``, small·small (``four``), then small·big, then big·small
    added to a float32 sum of their own, big·big to another; each block of
    ``block`` k summed from zero and added to ``run`` (zeros if None) as
    run + (big + small).  ``split=False``: big·big alone, one TF32 product
    a product."""
    a, b = a.float(), b.float()
    ab, bb = _tf32(a), _tf32(b)
    sa, sb = _tf32(a - ab), _tf32(b - bb)
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (
        a.shape[-2], b.shape[-1])
    if run is None:
        run = torch.zeros(shape, device=a.device)
    k = a.shape[-1]
    for k0 in range(0, k, block):
        big = torch.zeros(shape, device=a.device)
        small = torch.zeros_like(big)
        for d0 in range(k0, min(k0 + block, k), step):
            ka = (..., slice(d0, d0 + step))
            kb = (..., slice(d0, d0 + step), slice(None))
            if split:
                if four:
                    small = small + sa[ka] @ sb[kb]
                small = small + sa[ka] @ bb[kb]
                small = small + ab[ka] @ sb[kb]
            big = big + ab[ka] @ bb[kb]
        run = run + (big + small)
    return run


def _ssd_tf32_numerics(xs, da, dt, bs, cs, *, chunk, split=True):
    """A plain model of ``csrc/ssd_scan.cu``'s arithmetic (route
    ``mma_tf32``): head-major inputs on any device, y (B, H, L, P) float32
    out.  Per chunk: cum accumulated in float64 and rounded once; the
    scores C B^T by :func:`_tf32_blocks` over d_state; att = select(j <= i,
    (scores exp(cum_i - cum_j)) dt_j, 0); y = exp(cum_i) (C @ enter) (the
    entering state, by :func:`_tf32_blocks`; zero in the first chunk), then
    + att @ x over the chunk's rows in blocks of 64 with four products a
    product; the chunk's state (B (.) w)^T x, w_j = exp(cum_Q - cum_j) dt_j,
    and the state pass exp(cum_Q) state + that in float32.  ``split=False``
    forms every product from one TF32 product."""
    b, h, l, p = xs.shape
    dev = xs.device
    prod = functools.partial(_tf32_blocks, split=split)
    state = None
    y = torch.empty((b, h, l, p), device=dev)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    for c0 in range(0, l, chunk):
        sl = slice(c0, c0 + chunk)
        x, bb, cc = (t[:, :, sl].float() for t in (xs, bs, cs))
        dtc = dt[:, :, sl].float()
        cum = torch.cumsum(da[:, :, sl].double(), dim=-1).float()
        scores = prod(cc, bb.transpose(-1, -2))
        decay = torch.exp(torch.where(
            causal, cum[..., :, None] - cum[..., None, :], 0.0))
        att = torch.where(causal, (scores * decay) * dtc[..., None, :], 0.0)
        yc = None
        if state is not None:
            yc = torch.exp(cum)[..., None] * prod(cc, state)
        y[:, :, sl] = prod(att, x, yc, four=True)
        last = cum[..., -1:]
        w = torch.exp(last - cum) * dtc
        s_c = prod((bb * w[..., None]).transpose(-1, -2), x)
        state = s_c if state is None else (
            torch.exp(last)[..., None] * state + s_c)
    return y


# The float32 route at d_state 64, chunk 128 on N(0,1) data, under the
# model's decay (cum_Q ~ -100), a slow one and a cancelling one: the
# kernel follows its numerics model (their gap at most a tenth of the
# distance of a one-TF32-product model to float64: the tensor cores sum in
# their own order and truncate, which the model leaves out) and stays
# within twice the plain version's float64 error.
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("decay", ["model", "slow", "cancel"])
def test_ssd_f32_route_follows_its_numerics_model(dev, decay, seed):
    b, h, l, p, n, chunk = 1, 2, 512, 64, 64, 128
    args = tuple(torch.from_numpy(t).to(dev) for t in _ssd_head_major(
        b, h, l, p, n, seed, cancel=decay == "cancel", slow=decay == "slow"))
    _hold_to_tf32_model(args, chunk, f"ssd f32 {decay} seed {seed}")


def _hold_to_tf32_model(args, chunk, label):
    """One float32 ``mma_tf32`` launch on head-major ``args``, held to
    :func:`_ssd_tf32_numerics` (within a tenth of the one-TF32 model's
    float64 error) and to twice the plain version's float64 error."""
    p, n = args[0].shape[-1], args[3].shape[-1]
    assert ssd_ops.route_of(torch.float32, p, n, chunk) == "mma_tf32"
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert _route_diff(ssd_ops.ssd_scan, before) == {"mma_bf16": 0,
                                                     "mma_tf32": 1}
    model = _ssd_tf32_numerics(*args, chunk=chunk)
    one = _ssd_tf32_numerics(*args, chunk=chunk, split=False)
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    plain = ssd_scan_ref(*args, chunk=chunk)
    err_k, err_m, err_one, err_p = ((t.double() - exact).abs().max().item()
                                    for t in (y, model, one, plain))
    gap = (y - model).abs().max().item()
    print(f"{label}: kernel {err_k:.4e} model {err_m:.4e} one-TF32 model "
          f"{err_one:.4e} plain {err_p:.4e} from float64; kernel - model "
          f"{gap:.4e}")
    assert gap <= 0.1 * err_one, (gap, err_one)
    assert err_k <= 2 * err_p, (err_k, err_p)


# every (d_state, chunk) the mma route takes, under the model's decay
# (a chunk's decay e^-50 or less), a slow one (the carried state and each
# chunk's decay reach across several chunks) and a slow one whose outputs
# cancel.  Besides the bf16 tolerance, the float64 result bounds the error
# at 1e-4 of the largest output: seven times the worst of the CPU numerics
# model of the kernel on these inputs (1.4e-5, N=128, chunk 256,
# cancelling), where dropping the carried state or taking a neighbouring
# chunk's decay misses by percents of it.  One bf16 rounding of att, B w or
# the entering state, without the hi/lo split, misses the float64 result by
# 0.7 to 1.2 under the slow decays.
@pytest.mark.parametrize("decay", ["model", "slow", "cancel"])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_ssd_mma_route_vs_plain(dev, n, chunk, decay):
    args = _ssd_inputs(2, 3, 512, 64, n, n + chunk, dev,
                       cancel=decay == "cancel", slow=decay == "slow")
    assert ssd_ops.route_of(torch.bfloat16, 64, n, chunk) == "mma_bf16"
    before = ssd_ops.ssd_scan.launches_by_route["mma_bf16"]
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches_by_route["mma_bf16"] == before + 1
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    tol = LLM_TOL["ssd"][torch.bfloat16]
    torch.testing.assert_close(y.double(), exact, atol=tol, rtol=tol)
    torch.testing.assert_close(y, ssd_scan_ref(*args, chunk=chunk), atol=tol,
                               rtol=tol)
    err, top = (y.double() - exact).abs().max().item(), exact.abs().max().item()
    assert err <= 1e-4 * top, (err, top)


def test_ssd_mma_route_through_ops_ssd_padding(dev):
    """The model layout at L=4000 (padded to 4096 inside ``ops.ssd``) on the
    mma route, against the plain version of the unpadded rows."""
    gen = torch.Generator(device=dev).manual_seed(4)
    b, l, h, g, p, n = 1, 4000, 4, 1, 64, 128
    xs = _randn((b, l, h, p), torch.bfloat16, gen, dev)
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen,
                                                  device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    bs, cs = (_randn((b, l, g, n), torch.bfloat16, gen, dev) for _ in range(2))
    before = ssd_ops.ssd_scan.launches_by_route["mma_bf16"]
    y, _ = ssd_ops.ssd(xs, dt, a, bs, cs, chunk=256)
    assert ssd_ops.ssd_scan.launches_by_route["mma_bf16"] == before + 1
    args = ssd_ops._head_major(xs, dt, a, bs, cs)
    args = [torch.nn.functional.pad(t, (0, 0, 0, 96) if t.ndim == 4 else (0, 96))
            for t in args]
    want = ssd_scan_ref(*args, chunk=256)[:, :, :l].transpose(1, 2)
    tol = LLM_TOL["ssd"][torch.bfloat16]
    torch.testing.assert_close(y, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ssd_mma_raises_on_unaligned_base(dev, dtype):
    """cp.async copies 16-byte pieces: an x 2 bytes off goes to the
    split-TF32 kernel (one launch there, none on the mma route) and agrees
    with the plain version."""
    xs, da, dt, bs, cs = _ssd_inputs(1, 1, 64, 64, 64, 0, dev)
    xs, bs, cs = (t.to(dtype) for t in (xs, bs, cs))
    buf = torch.zeros(1 + xs.numel(), dtype=dtype, device=dev)
    x_off = buf[1:].view(xs.shape)
    x_off.copy_(xs)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16 == 2
    assert ssd_ops.route_of(dtype, 64, 64, 64, aligned=False) == "mma_tf32"
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    y = ssd_ops.ssd_scan(x_off, da, dt, bs, cs, chunk=64)
    torch.cuda.synchronize()
    after = ssd_ops.ssd_scan.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        "mma_bf16": 0, "mma_tf32": 1}
    tol = LLM_TOL["ssd"][dtype]
    torch.testing.assert_close(y, ssd_scan_ref(x_off, da, dt, bs, cs, chunk=64),
                               atol=tol, rtol=tol)


# (64, 1024) and (13, 1024): the warp kernel, 13 rows not a multiple of
# its 2 rows per CTA; (300, 4096) and (9, 4096): the CTA kernel; (5, 1001):
# D not a multiple of the vector width, the scalar kernel
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 128), (2, 17, 256), (300, 4096),
                                   (64, 1024), (13, 1024), (9, 4096),
                                   (5, 1001)])
def test_rmsnorm_kernel_vs_plain(dev, shape, dtype):
    gen = torch.Generator(device=dev).manual_seed(shape[-1])
    x = _randn(shape, dtype, gen, dev)
    scale = torch.randn(shape[-1], generator=gen, device=dev)
    kernel = rms_ops.kernel_for(shape[-1], dtype)
    before = rms_ops.rmsnorm_fused.launches
    by_kernel = rms_ops.rmsnorm_fused.launches_by_kernel[kernel]
    out = rms_ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm_fused.launches == before + 1
    assert rms_ops.rmsnorm_fused.launches_by_kernel[kernel] == by_kernel + 1
    tol = LLM_TOL["rmsnorm"][dtype]
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, scale).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [1024, 4096])
def test_rmsnorm_kernel_takes_a_bf16_scale(dev, d):
    """A bf16 scale is cast to float32 before the launch, as the reference
    and the CPU leg cast it."""
    gen = torch.Generator(device=dev).manual_seed(d)
    x = _randn((64, d), torch.bfloat16, gen, dev)
    scale = torch.randn(d, generator=gen, device=dev).to(torch.bfloat16)
    before = rms_ops.rmsnorm_fused.launches
    out = rms_ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm_fused.launches == before + 1
    tol = LLM_TOL["rmsnorm"][torch.bfloat16]
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, scale).float(),
                               atol=tol, rtol=tol)


# -- every input the reference's kernels take: float16, head_dims past 256,
# the SSD past head_dim 128 and d_state 256, 16-bit da and dt --------------

def _route_diff(counter, before) -> dict:
    after = counter.launches_by_route
    return {r: after[r] - before[r] for r in after}


def _hold_ssd(y, args, chunk, dtype, n):
    """The float32 rule of the SSD cases above: at N * chunk > 64 * 64 on
    float32 arithmetic (float32 inputs, and 16 bits on the split-TF32
    route, whose float32 operands are split the same way) the kernel's
    float64 error no worse than twice the plain version's; else the kernel
    against the plain version at the dtype's tolerance."""
    plain = ssd_scan_ref(*args, chunk=chunk)
    if n * chunk > 64 * 64 and (dtype == torch.float32 or ssd_ops.route_of(
            dtype, args[0].shape[-1], n, chunk) == "mma_tf32"):
        exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
        err_k = (y.double() - exact).abs().max().item()
        err_p = (plain.double() - exact).abs().max().item()
        assert err_k <= 2 * err_p, (err_k, err_p)
    else:
        tol = LLM_TOL["ssd"][dtype]
        torch.testing.assert_close(y, plain, atol=tol, rtol=tol)


# float16 on both attention routes: wgmma at multiples of 8 (minitron's
# layer, GQA, a window, T != S, the HD = 256 build), the mma.sync kernel at
# other head_dims
@pytest.mark.parametrize(
    "b,s,t,nq,nkv,h,causal,window,route",
    [
        (1, 4096, 4096, 32, 8, 128, True, 0, "wgmma_bf16"),
        (2, 300, 300, 8, 2, 64, True, 0, "wgmma_bf16"),
        (1, 700, 700, 8, 2, 128, True, 128, "wgmma_bf16"),
        (1, 200, 333, 4, 2, 80, False, 0, "wgmma_bf16"),
        (1, 300, 300, 4, 1, 256, True, 0, "wgmma_bf16"),
        (1, 500, 500, 4, 2, 100, True, 0, "mma_sync"),
        (2, 130, 77, 2, 2, 33, False, 0, "mma_sync"),
    ],
)
def test_flash_float16_vs_plain(dev, b, s, t, nq, nkv, h, causal, window, route):
    dtype = torch.float16
    gen = torch.Generator(device=dev).manual_seed(s + t + h)
    q = _randn((b, s, nq, h), dtype, gen, dev)
    k, v = (_randn((b, t, nkv, h), dtype, gen, dev) for _ in range(2))
    assert fa_ops.route_of(dtype, h) == route
    before = dict(fa_ops.mha.launches_by_route)
    out = fa_ops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _route_diff(fa_ops.mha, before) == {
        r: int(r == route) for r in before}
    assert out.dtype == dtype
    tol = LLM_TOL["flash"][dtype]
    torch.testing.assert_close(out.float(), mha_ref(q, k, v, causal=causal,
                                                    window=window).float(),
                               atol=tol, rtol=tol)


# head_dims past 256: the mma.sync kernel's split route (output columns in
# slices of at most 256, each forming the same scores) in every dtype
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "b,s,t,nq,nkv,h,causal,window",
    [
        (1, 1000, 1000, 4, 1, 320, True, 0),
        (1, 300, 300, 4, 2, 512, True, 128),
        (2, 130, 77, 2, 2, 257, False, 0),
        (1, 200, 200, 2, 1, 600, True, 0),
    ],
)
def test_flash_split_head_dims_vs_plain(dev, dtype, b, s, t, nq, nkv, h,
                                        causal, window):
    gen = torch.Generator(device=dev).manual_seed(s + t + h)
    q = _randn((b, s, nq, h), dtype, gen, dev)
    k, v = (_randn((b, t, nkv, h), dtype, gen, dev) for _ in range(2))
    assert fa_ops.route_of(dtype, h) == "mma_sync"
    before = dict(fa_ops.mha.launches_by_route)
    out = fa_ops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _route_diff(fa_ops.mha, before) == {"wgmma_bf16": 0,
                                               "mma_sync": 1}
    tol = LLM_TOL["flash"][dtype]
    torch.testing.assert_close(out.float(), mha_ref(q, k, v, causal=causal,
                                                    window=window).float(),
                               atol=tol, rtol=tol)


def test_flash_split_slices_share_their_softmax(dev):
    """Every slice's CTA forms the same scores in the same order, so its
    running max and sum are bitwise every other slice's: with v's columns
    256..511 a copy of 0..255, the two slices' outputs are equal bit for
    bit."""
    gen = torch.Generator(device=dev).manual_seed(512)
    q, k = (torch.randn((1, 700, 4, 512), generator=gen, device=dev)
            for _ in range(2))
    half = torch.randn((1, 700, 4, 256), generator=gen, device=dev)
    v = torch.cat([half, half], dim=-1).contiguous()
    out = fa_ops.mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out[..., :256], out[..., 256:])


# The mma.sync kernel (csrc/flash_attention.cu) at head_dims and bases the
# wgmma build does not take, in both 16-bit types: h 1 and 100 (not
# multiples of 8), 8, 136 and 200 from an unaligned q (multiples of 8 the
# wgmma build would take aligned), past 256 (the slices; at 1100 q and k
# too wide for shared memory at once, staged in pieces), unaligned bases
# at 64, 100, 128 and 320 (q, or k and v), a window and GQA; and float32 at
# 64, 128, 256 and 512.  (dtype, (B, S, T, N, K, h), causal, window, which
# of q / k / v start 2 bytes off)
MMA_SYNC_CASES = [
    (dtype, shape, causal, window, off)
    for dtype in (torch.bfloat16, torch.float16)
    for shape, causal, window, off in [
        ((1, 300, 300, 4, 2, 1), True, 0, ""),
        ((2, 257, 257, 4, 1, 100), True, 64, ""),
        ((1, 400, 400, 4, 2, 8), True, 0, "q"),
        ((1, 300, 333, 4, 4, 136), False, 0, "q"),
        ((1, 500, 500, 8, 2, 200), True, 128, "q"),
        ((1, 300, 300, 4, 2, 264), True, 0, ""),
        ((1, 700, 700, 4, 1, 320), True, 0, ""),
        ((1, 300, 300, 2, 2, 512), True, 100, ""),
        ((1, 200, 200, 4, 2, 600), False, 0, ""),
        ((1, 200, 200, 2, 1, 1100), True, 0, ""),
        ((1, 600, 600, 8, 2, 64), True, 0, "kv"),
        ((1, 500, 500, 4, 1, 100), True, 0, "qkv"),
        ((2, 300, 300, 8, 2, 128), True, 96, "q"),
        ((1, 400, 400, 4, 2, 320), True, 0, "v"),
    ]
] + [
    (torch.float32, shape, causal, window, "")
    for shape, causal, window in [
        ((1, 600, 600, 8, 2, 64), True, 0),
        ((2, 300, 300, 8, 2, 128), True, 128),
        ((1, 500, 500, 4, 1, 256), True, 0),
        ((1, 300, 333, 4, 2, 512), False, 0),
    ]
]


def _mma_sync_inputs(dtype, shape, off, gen, dev):
    b, s, t, n, kh, h = shape
    return tuple(_randn_at(sh, dtype, gen, dev, name in off)
                 for name, sh in (("q", (b, s, n, h)), ("k", (b, t, kh, h)),
                                  ("v", (b, t, kh, h))))


def _randn_at(shape, dtype, gen, dev, unaligned=False):
    """N(0, 1) of ``shape`` in ``dtype``, from a base 2 bytes past a 16-byte
    boundary where ``unaligned``."""
    n = int(np.prod(shape))
    buf = torch.randn(n + int(unaligned), generator=gen, device=dev).to(dtype)
    x = (buf[1:] if unaligned else buf).view(shape)
    assert (x.data_ptr() % 16 != 0) == unaligned
    return x


@pytest.mark.parametrize("dtype,shape,causal,window,off", MMA_SYNC_CASES)
def test_flash_mma_sync_vs_plain(dev, dtype, shape, causal, window, off):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    q, k, v = _mma_sync_inputs(dtype, shape, off, gen, dev)
    aligned = not off
    assert fa_ops.route_of(dtype, shape[-1], aligned) == "mma_sync"
    before = dict(fa_ops.mha.launches_by_route)
    out = fa_ops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _route_diff(fa_ops.mha, before) == {"wgmma_bf16": 0, "mma_sync": 1}
    tol = LLM_TOL["flash"][dtype]
    torch.testing.assert_close(out.float(), mha_ref(q, k, v, causal=causal,
                                                    window=window).float(),
                               atol=tol, rtol=tol)


def _attention_f64(q, k, v, *, causal, window):
    """Softmax attention in float64 (model layout, GQA, the masks)."""
    n, s, t = q.shape[2], q.shape[1], k.shape[1]
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    kd, vd = (x.repeat_interleave(n // k.shape[2], dim=1) for x in (kd, vd))
    sc = (qd @ kd.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        row = torch.arange(s, device=q.device)[:, None]
        col = torch.arange(t, device=q.device)[None, :]
        keep = col <= row
        if window > 0:
            keep = keep & (col > row - window)
        sc = sc.masked_fill(~keep, float("-inf"))
    return (sc.softmax(-1) @ vd).transpose(1, 2)


# The kernel against its plain numerics model (_mma_sync_numerics), on the
# card.  16 bits: the model's rounding (P and the output in the 16-bit
# type) is the error that matters, so the kernel's mean distance to the
# model is held within a tenth of the model's own mean distance to float64
# (outputs that round the other way sit one ulp apart; the kernel's float32
# sums in the tensor cores' order do not move the rest).  float32: the
# split model's float32-level error is of the size of the kernel's own
# summation order, so there the kernel's distance to the split model is
# held within a tenth of a one-TF32-product model's distance to float64
# (the kernel splits its operands), and the kernel within 2e-5 of float64.
@pytest.mark.parametrize("dtype,shape,causal,window,off", [
    (torch.bfloat16, (1, 512, 512, 4, 2, 100), True, 0, ""),
    (torch.float16, (1, 512, 512, 4, 2, 100), True, 0, ""),
    (torch.bfloat16, (1, 384, 384, 4, 1, 320), True, 64, ""),
    (torch.float16, (1, 384, 400, 2, 2, 136), False, 0, "q"),
    (torch.float32, (1, 512, 512, 4, 2, 128), True, 0, ""),
    (torch.float32, (1, 256, 256, 2, 1, 512), True, 96, ""),
])
def test_flash_mma_sync_follows_its_numerics_model(dev, dtype, shape, causal,
                                                   window, off):
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + 1)
    q, k, v = _mma_sync_inputs(dtype, shape, off, gen, dev)
    out = fa_ops.mha(q, k, v, causal=causal, window=window)
    exact = _attention_f64(q, k, v, causal=causal, window=window)
    heads = tuple(x.transpose(1, 2) for x in (q, k, v))
    model = _mma_sync_numerics(*heads, causal=causal,
                               window=window).transpose(1, 2)
    if dtype == torch.float32:
        one = _mma_sync_numerics(*heads, causal=causal, window=window,
                                 split=False).transpose(1, 2)
        gap = (out - model).abs().max().item()
        err_one = (one.double() - exact).abs().max().item()
        err_k = (out.double() - exact).abs().max().item()
        print(f"mma_sync float32 {shape}: kernel - split model {gap:.3e}, "
              f"one-TF32 model from float64 {err_one:.3e}, kernel from "
              f"float64 {err_k:.3e}")
        assert gap <= 0.1 * err_one, (gap, err_one)
        torch.testing.assert_close(out.double(), exact, atol=2e-5, rtol=2e-5)
    else:
        gap = (out.float() - model.float()).abs().mean().item()
        err_m = (model.double() - exact).abs().mean().item()
        print(f"mma_sync {dtype} {shape}: mean |kernel - model| {gap:.3e}, "
              f"mean |model - float64| {err_m:.3e}")
        assert gap <= 0.1 * err_m, (gap, err_m)


def test_flash_mma_sync_sass_holds_tensor_core_products(dev):
    """The mma.sync library runs on the tensor cores: its SASS holds HMMA
    in bf16 and float16 (m16n8k16) and in TF32 (m16n8k8, the float32
    build)."""
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    _build.build(["flash_attention"])
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(_build._target("flash_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for op in ("HMMA.16816.F32.BF16", "HMMA.16816.F32 ", "HMMA.1688.F32.TF32"):
        assert op in sass, op


# float16 on both SSD routes: every (d_state, chunk) of the mma kernel, and
# split-TF32 shapes (head_dim 32 and two slabs, d_state 24 and 256)
@pytest.mark.parametrize(
    "b,h,l,p,n,chunk",
    [(1, 2, 512, 64, n, chunk) for n in (64, 128) for chunk in (64, 128, 256)]
    + [(1, 4, 128, 32, 24, 32), (1, 2, 512, 128, 256, 256),
       (4, 32, 1024, 64, 128, 256)])
def test_ssd_float16_vs_plain(dev, b, h, l, p, n, chunk):
    dtype = torch.float16
    gen = torch.Generator(device=dev).manual_seed(l + n + p + chunk)
    xs = _randn((b, h, l, p), dtype, gen, dev)
    dt = torch.nn.functional.softplus(torch.randn((b, h, l), generator=gen,
                                                  device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    da = dt * a[None, :, None]
    bs, cs = (_randn((b, h, l, n), dtype, gen, dev) for _ in range(2))
    route = "mma_bf16" if (p, n, chunk) in SSD_MMA_SHAPES else "mma_tf32"
    assert ssd_ops.route_of(dtype, p, n, chunk) == route
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    y = ssd_ops.ssd_scan(xs, da, dt, bs, cs, chunk=chunk)
    torch.cuda.synchronize()
    assert _route_diff(ssd_ops.ssd_scan, before) == {
        r: int(r == route) for r in before}
    _hold_ssd(y, (xs, da, dt, bs, cs), chunk, dtype, n)
    if route == "mma_bf16":  # and the float64 bound of the bf16 mma cases
        exact = ssd_scan_ref(*(t.double() for t in (xs, da, dt, bs, cs)),
                             chunk=chunk)
        err, top = ((y.double() - exact).abs().max().item(),
                    exact.abs().max().item())
        assert err <= 1e-4 * top, (err, top)


@pytest.mark.parametrize("decay", ["model", "slow", "cancel"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_ssd_mma_float16_route_vs_float64(dev, chunk, decay):
    """The float16 mma route under the three decays of the bf16 cases,
    against the float64 result at the float16 tolerance and within 1e-4
    of the largest output."""
    args = tuple(t.to(torch.float16) if t.ndim == 4 else t for t in
                 _ssd_inputs(2, 3, 512, 64, 128, 128 + chunk, dev,
                             cancel=decay == "cancel", slow=decay == "slow"))
    before = ssd_ops.ssd_scan.launches_by_route["mma_bf16"]
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches_by_route["mma_bf16"] == before + 1
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    tol = LLM_TOL["ssd"][torch.float16]
    torch.testing.assert_close(y.double(), exact, atol=tol, rtol=tol)
    err, top = (y.double() - exact).abs().max().item(), exact.abs().max().item()
    assert err <= 1e-4 * top, (err, top)


@pytest.mark.parametrize("case", sorted(SSD_RANGE_CASES))
def test_ssd_mma_float16_range_vs_float64(dev, case):
    """Operands past float16's 65504 (the scaled splits): one ``mma_bf16``
    launch, a finite y within 1e-4 of the largest output from the float64
    result (the rule above), and at "probe" within the float16 tolerance of
    it.  At "strong" and "growing" (|y| to 9.2e5 and 1.7e23) no float32
    summation order is within that tolerance where outputs cancel: on the
    CPU the float32 plain version misses the float64 result by up to 3.0e-2
    and 4.8e-3 of 1 + |y|, the JAX kernel by 5.1e-2 and 2.3e-3; and on
    the card the kernel's float32 sums in the tensor cores miss it by 4.3x
    and 6.1x the plain version's error (its bf16 build on the same draws by
    7.2x and 8.9x; ``tools/ssd_float16_range.py``)."""
    (xs, da, dt, bs, cs), chunk = _ssd_range_head_major(case)
    args = tuple(torch.from_numpy(t).to(dev) for t in (xs, da, dt, bs, cs))
    before = ssd_ops.ssd_scan.launches_by_route["mma_bf16"]
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches_by_route["mma_bf16"] == before + 1
    assert torch.isfinite(y).all()
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    err, err_plain = ((t.double() - exact).abs().max().item() for t in
                      (y, ssd_scan_ref(*args, chunk=chunk)))
    top = exact.abs().max().item()
    print(f"ssd float16 range {case}: max |y| {top:.4e}, max abs err from "
          f"float64 {err:.4e}, plain {err_plain:.4e}")
    if case == "probe":
        tol = LLM_TOL["ssd"][torch.float16]
        torch.testing.assert_close(y.double(), exact, atol=tol, rtol=tol)
    assert err <= 1e-4 * top, (err, top)


# past d_state 256 (the state in pieces of 256 rows in a device scratch), or
# at 256 with a chunk too long for the whole state in shared memory; past
# head_dim 128 (more than two slabs)
@pytest.mark.parametrize(
    "dtype,b,h,l,p,n,chunk",
    [
        (torch.float32, 1, 2, 512, 64, 320, 256),
        (torch.float32, 1, 2, 512, 64, 512, 256),
        (torch.float32, 2, 3, 192, 40, 300, 64),
        (torch.float32, 1, 2, 1024, 64, 256, 512),
        (torch.float32, 1, 2, 512, 192, 128, 256),
        (torch.float32, 1, 2, 256, 256, 512, 128),
        (torch.bfloat16, 1, 2, 512, 192, 512, 256),
        (torch.float16, 1, 2, 512, 64, 512, 256),
    ],
)
def test_ssd_pieced_states_and_wide_heads_vs_plain(dev, dtype, b, h, l, p, n,
                                                   chunk):
    gen = torch.Generator(device=dev).manual_seed(l + n + p + chunk)
    xs = _randn((b, h, l, p), dtype, gen, dev)
    dt = torch.nn.functional.softplus(torch.randn((b, h, l), generator=gen,
                                                  device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    da = dt * a[None, :, None]
    bs, cs = (_randn((b, h, l, n), dtype, gen, dev) for _ in range(2))
    assert ssd_ops.route_of(dtype, p, n, chunk) == "mma_tf32"
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    y = ssd_ops.ssd_scan(xs, da, dt, bs, cs, chunk=chunk)
    torch.cuda.synchronize()
    assert _route_diff(ssd_ops.ssd_scan, before) == {"mma_bf16": 0,
                                                     "mma_tf32": 1}
    _hold_ssd(y, (xs, da, dt, bs, cs), chunk, dtype, n)


@pytest.mark.parametrize("n", [320, 512])
def test_ssd_pieced_state_follows_its_numerics_model(dev, n):
    """Past d_state 256 the kernel streams the state's rows in k-tiles of
    64 as it does below: it follows its numerics model (the gap at most a
    tenth of the one-TF32 model's float64 error) and stays within twice the
    plain version's float64 error."""
    args = tuple(torch.from_numpy(t).to(dev) for t in _ssd_head_major(
        1, 2, 256, 64, n, n))
    _hold_to_tf32_model(args, 128, f"ssd N={n}")


# The split-TF32 route at shapes the cases above leave out: head_dim 1,
# 100 and 300 (one slab of 64 channels nearly empty, two, five), d_state 8
# and 1000 (one k-step; sixteen k-tiles of 64 states, the last of 40),
# chunks of 16 and 48 rows (the row and column blocks cut short), and x, B
# and C from bases off a 16-byte boundary (float32 by 4 bytes: cp.async of
# 4 bytes; 16 bits by 2: realigned in registers), against the plain
# version and, at N * chunk > 64 * 64, the float64 rule.
@pytest.mark.parametrize(
    "dtype,b,h,l,p,n,chunk,unaligned",
    [
        (torch.float32, 1, 2, 256, 1, 64, 128, False),
        (torch.float32, 1, 2, 256, 100, 64, 128, False),
        (torch.float32, 1, 2, 256, 300, 32, 64, False),
        (torch.float32, 1, 2, 256, 64, 8, 64, False),
        (torch.float32, 1, 2, 256, 64, 1000, 128, False),
        (torch.float32, 2, 3, 192, 64, 64, 16, False),
        (torch.float32, 1, 2, 240, 48, 100, 48, False),
        (torch.float32, 1, 2, 256, 64, 128, 128, True),
        (torch.float16, 1, 2, 512, 64, 128, 128, True),
        (torch.bfloat16, 1, 2, 256, 300, 1000, 64, True),
    ],
)
def test_ssd_tf32_route_more_shapes_vs_plain(dev, dtype, b, h, l, p, n, chunk,
                                             unaligned):
    gen = torch.Generator(device=dev).manual_seed(l + n + p + chunk)
    xs = _randn_at((b, h, l, p), dtype, gen, dev, unaligned)
    dt = torch.nn.functional.softplus(torch.randn((b, h, l), generator=gen,
                                                  device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    da = dt * a[None, :, None]
    bs, cs = (_randn_at((b, h, l, n), dtype, gen, dev, unaligned)
              for _ in range(2))
    assert ssd_ops.route_of(dtype, p, n, chunk, not unaligned) == "mma_tf32"
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    y = ssd_ops.ssd_scan(xs, da, dt, bs, cs, chunk=chunk)
    torch.cuda.synchronize()
    assert _route_diff(ssd_ops.ssd_scan, before) == {"mma_bf16": 0,
                                                     "mma_tf32": 1}
    args = (xs, da, dt, bs, cs)
    _hold_ssd(y, args, chunk, dtype, n)
    if n * chunk > 64 * 64:
        exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
        plain = ssd_scan_ref(*args, chunk=chunk)
        err_k = (y.double() - exact).abs().max().item()
        err_p = (plain.double() - exact).abs().max().item()
        assert err_k <= 2 * err_p, (err_k, err_p)


def test_ssd_scan_sass_holds_tf32_products(dev):
    """The ``mma_tf32`` SSD library runs on the tensor cores: its SASS
    holds HMMA on TF32 operands (m16n8k8)."""
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    _build.build(["ssd_scan"])
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build._target("ssd_scan"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    assert "HMMA.1688.F32.TF32" in sass


@pytest.mark.parametrize("route_shape", [(64, 128, 256), (32, 24, 32)])
@pytest.mark.parametrize("ddtype", [torch.bfloat16, torch.float16])
def test_ssd_takes_16_bit_da_dt(dev, ddtype, route_shape):
    """da and dt in bf16 or float16 are cast once to float32 (as the
    reference's kernel casts them): the result equals, bit for bit, the
    call on the float32 casts, on either route."""
    p, n, chunk = route_shape
    xs, da, dt, bs, cs = _ssd_inputs(1, 2, 256, p, n, 3, dev)
    da16, dt16 = da.to(ddtype), dt.to(ddtype)
    y16 = ssd_ops.ssd_scan(xs, da16, dt16, bs, cs, chunk=chunk)
    y32 = ssd_ops.ssd_scan(xs, da16.float(), dt16.float(), bs, cs, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y16, y32)


@pytest.mark.parametrize("shape", [(4, 128), (2, 17, 256), (300, 4096),
                                   (13, 1024), (9, 4096), (5, 1001)])
def test_rmsnorm_float16_vs_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(shape[-1])
    x = _randn(shape, torch.float16, gen, dev)
    scale = torch.randn(shape[-1], generator=gen, device=dev)
    kernel = rms_ops.kernel_for(shape[-1], torch.float16)
    by_kernel = rms_ops.rmsnorm_fused.launches_by_kernel[kernel]
    out = rms_ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm_fused.launches_by_kernel[kernel] == by_kernel + 1
    assert out.dtype == torch.float16
    tol = LLM_TOL["rmsnorm"][torch.float16]
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, scale).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch,counter,route", [
    ("minitron-8b", "flash", "wgmma_bf16"), ("mamba2-370m", "ssd", None)])
def test_reduced_model_float16_kernel_path_matches_einsum_path(dev, arch,
                                                               counter, route):
    """float16 on the card: ``use_kernels`` launches one kernel per layer
    on the 16-bit route and agrees with the einsum path at the reduced
    models' float16 tolerance (1.5e-2, tests/test_torch_kernel_dtypes.py)."""
    cfg = reduced(get_arch(arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, torch.float16, device=dev, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen, device=dev)
    ref = model.apply({"tokens": tokens})
    model.cfg = dataclasses.replace(cfg, use_kernels=True)
    c = fa_ops.mha if counter == "flash" else ssd_ops.ssd_scan
    if route is None:
        d = model.mdims
        route = ssd_ops.route_of(torch.float16, d.head_dim, d.d_state, d.chunk)
    before = dict(c.launches_by_route)
    out = model.apply({"tokens": tokens})
    assert _route_diff(c, before) == {r: cfg.num_layers * (r == route)
                                      for r in before}
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=1.5e-2,
                               rtol=1.5e-2)


@pytest.mark.parametrize("arch,counter", [("minitron-8b", "flash"),
                                          ("mamba2-370m", "ssd"),
                                          ("jamba-1.5-large-398b", "ssd")])
def test_reduced_model_kernel_path_matches_einsum_path(dev, arch, counter):
    """float32 on the card: ``use_kernels`` launches one kernel per
    attention or mamba layer (the hybrid's 7 mamba sublayers a period) and
    agrees with the einsum path at 2e-4."""
    cfg = reduced(get_arch(arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, torch.float32, device=dev, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen, device=dev)
    ref = model.apply({"tokens": tokens})
    model.cfg = dataclasses.replace(cfg, use_kernels=True)
    c = fa_ops.mha if counter == "flash" else ssd_ops.ssd_scan
    before = c.launches
    out = model.apply({"tokens": tokens})
    layers = (model.counts["mamba"] * len(model.periods)
              if cfg.family == "hybrid" else cfg.num_layers)
    assert c.launches == before + layers
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared,cf", [(0, 1.25), (2, 0.25)])
def test_moe_layer_card_equals_cpu(dev, shared, cf, dtype):
    """``moe_apply`` on the card against the CPU on the same weights and
    inputs: the same experts, the output at 2e-4 (float32) or bf16's 2e-2,
    the aux entries; and the router's float32 product stays exact (TF32
    off inside it) when TF32 is on outside, where the expert products do
    take TF32."""
    from repro_torch.models.layers import moe as tmoe

    dims = tmoe.MoEDims(64, 8, 2, 32, num_shared_experts=shared,
                        capacity_factor=cf)
    gen = torch.Generator().manual_seed(0)
    params = tmoe.moe_init(dims, dtype, "cpu", gen)
    x = torch.randn((2, 48, 64), generator=gen).to(dtype)
    on_card = {k: (v.to(dev) if torch.is_tensor(v) else
                   {kk: vv.to(dev) for kk, vv in v.items()})
               for k, v in params.items()}
    card = tmoe.moe_apply(on_card, x.to(dev), dims)
    cpu = tmoe.moe_apply(params, x, dims)
    probs, _, idx = tmoe.moe_route(params, x, dims)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(card[0].cpu().float(), cpu[0].float(), atol=tol,
                               rtol=tol)
    for k in cpu[1]:
        torch.testing.assert_close(card[1][k].cpu(), cpu[1][k], atol=2e-4, rtol=2e-4)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        probs_tf32, _, idx_tf32 = tmoe.moe_route(on_card, x.to(dev), dims)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(idx_tf32.cpu(), idx)
    torch.testing.assert_close(probs_tf32.cpu(), probs, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b", "whisper-tiny"])
def test_new_families_card_equal_cpu(dev, arch):
    """Reduced, float32, the same weights: ``apply``, ``loss`` with its aux
    and 20 decode steps through a 16-slot cache on the card against the
    CPU at 2e-4."""
    cfg = reduced(get_arch(arch))
    cpu_model = build_model(cfg, torch.float32, device="cpu")
    card_model = build_model(cfg, torch.float32, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_len, cfg.d_model),
                                      generator=gen)
    out = {}
    for m in (cpu_model, card_model):
        b = {k: v.to(m.device) for k, v in batch.items()}
        loss, aux = m.loss(b)
        cache = m.init_cache(2, 16)
        logits = []
        for pos in range(20):
            lg, cache = m.decode_step(b["tokens"][:, pos:pos + 1], cache, pos)
            logits.append(lg.cpu())
        out[m.device.type] = (m.apply(b).cpu(), loss.detach().cpu(),
                              {k: v.detach().cpu() for k, v in aux.items()}, logits)
    (hc, lc, ac, gc), (hg, lg_, ag, gg) = out["cpu"], out["cuda"]
    close = functools.partial(torch.testing.assert_close, atol=2e-4, rtol=2e-4)
    close(hg, hc)
    close(lg_, lc)
    assert set(ag) == set(ac) and ("moe_aux" in ac) == bool(cfg.num_experts)
    for k in ac:
        close(ag[k], ac[k])
    for a, b in zip(gg, gc):
        close(a, b)


# -- walk-routed serving on the card ----------------------------------------------

def _routed_sims(devices, *, faults):
    """One ``ServeSimulator`` per device on BA(300,3) with the reduced
    mamba2-370m in float32, the same weights on each (a ``state_dict``
    copy)."""
    from repro_torch.core.faults import FaultModel
    from repro_torch.launch.serve import ServeEngine, ServeSimulator

    cfg = reduced(get_arch("mamba2-370m"))
    g = barabasi_albert(300, 3, seed=0, layout="ragged")
    base = build_model(cfg, torch.float32, device="cpu")
    sims = []
    for d in devices:
        model = build_model(cfg, torch.float32, device=d)
        model.load_state_dict(base.state_dict())
        fm = FaultModel(crash_rate=0.05, recovery_rate=0.1,
                        patience=2) if faults else None
        sims.append(ServeSimulator(
            g, ServeEngine(cfg, 4, 64, max_queue=16, model=model, device=d),
            num_walkers=32, rate=1.0, deadline_ticks=40, prompt_len=(4, 8),
            max_new_tokens=4, seed=0, fault_model=fm, relocate_after=2))
    return sims


def _same_routing(a, b, ma, mb):
    """Visits every tick, every request's schedule and the fault totals."""
    for t, (va, vb) in enumerate(zip(a.visits, b.visits)):
        assert np.array_equal(va, vb), f"tick {t}"

    def records(sim):
        e = sim.engine
        reqs = (e.completed + e.shed_requests + e.queue
                + [s for s in e.slots if s is not None]
                + [r for dq in sim.pending.values() for r in dq])
        return sorted((r.rid, r.node, r.submit_tick, r.admit_tick,
                       r.done_tick, r.shed_reason) for r in reqs)

    assert records(a) == records(b)
    wall = ("requests_per_sec", "tokens_per_sec", "walk_steps_per_sec")
    assert ({k: v for k, v in ma.items() if k not in wall}
            == {k: v for k, v in mb.items() if k not in wall})
    for k in ("rescues", "blocked_steps", "relocated", "down_node_ticks"):
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("faults", [False, True])
def test_routed_ticks_on_the_card_equal_the_cpu(dev, faults):
    """The same injected per-tick streams on the card and on the CPU: the
    card's ragged kernel routes as the CPU's plain version does."""
    card, cpu = _routed_sims([dev, "cpu"], faults=faults)
    streams = cpu.draw_streams(60, torch.Generator().manual_seed(4))
    card.inject(streams)
    cpu.inject(streams)
    before = wt.walk_transition_ragged.launches
    m_card = card.run(45, drain_ticks=15)
    assert wt.walk_transition_ragged.launches == before + 60
    _same_routing(card, cpu, m_card, cpu.run(45, drain_ticks=15))
    assert m_card["completed"] > 0
    assert (m_card["walker_blocked_steps"] > 0) == faults


@pytest.mark.parametrize("faults", [False, True])
def test_routed_generator_run_equals_its_streams_injected(dev, faults):
    """Per tick the card's generator draws the Markov uniforms, the walk
    block, then the rescue's: the same draws, injected, give the same run."""
    a, b = _routed_sims([dev, dev], faults=faults)
    drawn = torch.Generator(device=dev).manual_seed(0)
    b.inject(b.draw_streams(60, drawn))
    ma, mb = a.run(45, drain_ticks=15), b.run(45, drain_ticks=15)
    _same_routing(a, b, ma, mb)
    assert torch.equal(a.generator.get_state(), drawn.get_state())


def test_routed_main_on_the_card(dev, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cuda", "--nodes", "2000", "--walkers",
                       "32", "--ticks", "60", "--drain", "20",
                       "--crash-rate", "0.02", "--recovery-rate", "0.1"]) == 0
    assert "completed: 0" not in capsys.readouterr().out


# -- training: the kernels' grad guard, the fleet step, the resume -----------------


def _grad_inputs(dev, which):
    """A kernel's inputs on the card, one of them requiring grad."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    if which == "flash":
        q, k, v = rand(1, 64, 4, 64), rand(1, 64, 2, 64), rand(1, 64, 2, 64)
        return fa_ops.mha, (q.requires_grad_(), k, v), {"causal": True}
    if which == "ssd":
        xs, dt = rand(1, 64, 4, 32), rand(1, 64, 4).abs() * 0.1
        a, bs, cs = -rand(4).abs(), rand(1, 64, 1, 16), rand(1, 64, 1, 16)
        return ssd_ops.ssd, (xs.requires_grad_(), dt, a, bs, cs), {"chunk": 32}
    x, scale = rand(8, 256), torch.ones(256, device=dev)
    return rms_ops.rmsnorm, (x, scale.requires_grad_()), {}


@pytest.mark.parametrize("which", ["flash", "ssd", "rmsnorm"])
def test_kernels_raise_under_grad(dev, which):
    """No CUDA kernel has a backward: with gradients recorded and an input
    that requires grad, ``mha``, ``ssd`` and ``ops.rmsnorm`` raise and
    launch nothing; under ``no_grad`` the same call launches."""
    fn, args, kw = _grad_inputs(dev, which)
    counted = {"flash": fa_ops.mha, "ssd": ssd_ops.ssd_scan,
               "rmsnorm": rms_ops.rmsnorm_fused}[which]
    before = counted.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, **kw)
    assert counted.launches == before
    with torch.no_grad():
        fn(*args, **kw)
    assert counted.launches == before + 1


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m"])
def test_use_kernels_training_raises(dev, arch):
    """``use_kernels=True`` under grad raises (the reference's ``jax.grad``
    through its kernels fails); the plain layers train."""
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, torch.float32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    model.cfg = dataclasses.replace(cfg, use_kernels=True)
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(batch)
    model.cfg = cfg
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", ["mamba2-370m", "olmoe-1b-7b"])
def test_fleet_step_on_the_card_equals_the_cpu(dev, arch):
    """Three LLM fleet steps (reduced, float32, W=3, AdamW, averaging every
    2) on the card and on the CPU from the same weights and blocks: the
    walks bit for bit, one sparse launch a fleet step, losses and
    parameters at 1e-4."""
    from repro_torch import optim as topt
    from repro_torch.core.graphs import ring
    from repro_torch.models.base import param_tree
    from repro_torch.optim.base import leaves
    from repro_torch.walk_sgd import fleet as tfleet
    from repro_torch.walk_sgd import llm_trainer as tllm

    cfg = reduced(get_arch(arch))
    base = build_model(cfg, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    blocks = teng.draw_uniforms(9, 3, 0.3, gen, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (3, 3, 2, 32), generator=gen)
    runs = {}
    for d in (dev, torch.device("cpu")):
        model = build_model(cfg, torch.float32, device=d)
        model.load_state_dict(base.state_dict())
        walk = tllm.WalkContext.from_graph(ring(8), MHLJParams(0.3, 0.5, 3),
                                           device=d)
        opt = topt.adamw(1e-3)
        tree = param_tree(model)
        pw = tfleet.stack_params(tree, 3)
        ow = tfleet.stack_params(opt.init(tree), 3)
        ws = tfleet.init_fleet_walk_state(8, 3, seed=1, device=d)
        step = tfleet.make_fleet_step(model, opt, walk, avg_every=2)
        losses, nodes = [], []
        for t in range(3):
            before = wt.walk_transition_sparse.launches
            batch = {"tokens": tokens[t].to(d), "labels": tokens[t].to(d)}
            pw, ow, ws, m = step(pw, ow, ws, batch, t,
                                 uniforms=blocks[3 * t:3 * t + 3].to(d))
            if d.type == "cuda":
                assert wt.walk_transition_sparse.launches == before + 1
            losses.append(m["loss"].cpu())
            nodes.append(ws["node"].cpu())
        runs[d.type] = (losses, nodes, [x.cpu() for x in leaves(pw)])
    (lc, nc, pc), (lp, np_, pp) = runs["cuda"], runs["cpu"]
    for a, b in zip(nc, np_):
        assert torch.equal(a, b)
    for a, b in zip(lc, lp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for a, b in zip(pc, pp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-370m", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b"])
def test_deterministic_resume_on_the_card(dev, tmp_path, monkeypatch, arch):
    """Under ``torch.use_deterministic_algorithms(True)`` (the embedding's
    and the cross-entropy gather's backward otherwise accumulate with
    atomics; the MoE's dispatch and combine must run there too) a run
    killed after its step-6 checkpoint and resumed equals the
    uninterrupted run bit for bit."""
    from repro_torch.launch import train as ttrain

    class Killed(Exception):
        pass

    def killer(at):
        seen = [0]

        def on_phase(name):
            if name == "step":
                if seen[0] == at:
                    raise Killed
                seen[0] += 1
        return on_phase

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = reduced(get_arch(arch))
    kw = dict(graph_kind="ring", n_silos=8, method="mhlj", steps=12,
              batch_size=2, seq_len=32, lr=1e-3, log_every=0, seed=9,
              device=dev)
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        full = ttrain.run_training(cfg, **kw)
        root = str(tmp_path / "ck")
        with pytest.raises(Killed):
            ttrain.run_training(cfg, **kw, checkpoint_dir=root,
                                checkpoint_every=6, on_phase=killer(6))
        resumed = ttrain.run_training(cfg, **kw, checkpoint_dir=root,
                                      checkpoint_every=6, resume=True)
    finally:
        torch.use_deterministic_algorithms(old)
    assert np.array_equal(resumed["update_nodes"], full["update_nodes"][6:])
    assert np.array_equal(resumed["losses"], full["losses"][6:])
    from repro_torch.optim.base import leaves
    for a, b in zip(leaves(resumed["params"]), leaves(full["params"])):
        assert torch.equal(a, b)
    assert torch.equal(resumed["walk_state"]["lipschitz"],
                       full["walk_state"]["lipschitz"])
    assert torch.equal(resumed["walk_state"]["rng"].get_state(),
                       full["walk_state"]["rng"].get_state())


# -- the dry-run tooling on the card (phase 16 (a) of chip_smoke.py) ---------


@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m"])
def test_op_cost_kernel_path_counts_the_plain_paths_work(dev, arch):
    """The priced regions: a reduced bf16 prefill counts the same FLOPs and
    bytes with ``use_kernels`` True (the CUDA kernels launch) and False."""
    from repro_torch.launch import dryrun
    from repro_torch.utils.op_cost import count_ops

    cfg = dataclasses.replace(reduced(get_arch(arch)), use_kernels=True,
                              head_dim=64 if arch == "minitron-8b" else 0)
    if arch == "mamba2-370m":
        cfg = dataclasses.replace(cfg, ssm_state=64, ssm_head_dim=64,
                                  ssd_chunk=64)
    model = build_model(cfg, torch.bfloat16, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    step = dryrun.make_prefill_step(model)
    counts = {}
    for use_kernels in (True, False):
        model.cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
        fa_ops.mha.launches, ssd_ops.ssd_scan.launches = 0, 0
        with torch.no_grad(), count_ops() as c:
            logits = step({"tokens": tokens})
        torch.cuda.synchronize()
        launched = fa_ops.mha.launches + ssd_ops.ssd_scan.launches
        assert (launched > 0) == use_kernels
        assert torch.isfinite(logits).all()
        counts[use_kernels] = (c.cost.flops, c.cost.bytes)
    assert counts[True] == counts[False]


def test_plan_argument_bytes_equal_the_cards(dev):
    """The (1, 1) plan's argument bytes equal the bytes of the same model's
    parameters and batch built on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = reduced(get_arch("mamba2-370m"))
    shape = ShapeConfig("small_prefill", 256, 1, "prefill")
    _, _, info = dryrun.lower_case(cfg, shape, False, mesh=make_smoke_mesh())
    model = build_model(cfg, torch.bfloat16, device=dev)
    measured = sum(p.numel() * p.element_size() for p in model.parameters())
    measured += 2 * 256 * 4  # tokens and labels, int32
    assert info["memory"]["argument_size_in_bytes"] == measured
    assert info["collectives"]["num_ops"] == 0
