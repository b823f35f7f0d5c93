"""The port's device-resident loop (``repro_torch.core.scan``) on the CPU,
and the steps it drives: no step reads the device on the host.

On the card :func:`scan` captures the loop in CUDA graphs
(``tests/test_torch_cuda.py`` holds the captured loop against the
uncaptured one); here the same step runs as a plain loop.  A CUDA graph
cannot hold a host read, so every layout's step, ``WalkFleet.advance``
and ``run_fleet``'s step run here under a dispatch mode that raises on
the operators that read a device value on the host or size their output
from the data: ``_local_scalar_dense`` (``.item()``, ``bool()``,
``int()``), ``nonzero``, ``bincount``, ``unique``, ``masked_select`` and
``repeat_interleave`` without an output size.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import engine as teng
from repro_torch.core import graphs as tg
from repro_torch.core import scan as tscan
from repro_torch.core import transition as ttr
from repro_torch.data import make_heterogeneous_regression
from repro_torch.models import regression as treg
from repro_torch.walk_sgd import fleet as tfleet

HOST_READS = ("_local_scalar_dense", "nonzero", "bincount", "unique",
              "masked_select")


class NoHostReads(TorchDispatchMode):
    """Raise on every operator that reads the device from the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if any(name.lstrip("_").startswith(h.lstrip("_")) for h in HOST_READS):
            raise AssertionError(f"host read: aten.{name}")
        if name == "repeat_interleave" and kwargs.get("output_size") is None:
            raise AssertionError("host read: aten.repeat_interleave without "
                                 "output_size")
        return func(*args, **kwargs)


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# -- the loop ----------------------------------------------------------------


def _counter_step(inputs):
    """A step that reads input row t, carries a running sum and emits the
    sum before the update and t itself."""
    def step(carry):
        t, acc = carry
        x = inputs.index_select(0, t.view(1))[0]
        return (t + 1, acc + x), (acc, t)
    return step


def test_scan_runs_the_step_as_a_plain_loop_on_the_cpu():
    inputs = torch.arange(12.0).reshape(6, 2)
    t0 = torch.zeros((), dtype=torch.int64)
    acc0 = torch.ones(2)
    (sums, ts), (t, acc), stats = tscan.scan(
        _counter_step(inputs), (t0, acc0), 6, (acc0, t0)
    )
    want = torch.ones(2) + torch.cumsum(inputs, 0) - inputs
    assert torch.equal(sums, want) and torch.equal(ts, torch.arange(6))
    assert int(t) == 6 and torch.equal(acc, 1.0 + inputs.sum(0))
    assert int(t0) == 0 and torch.equal(acc0, torch.ones(2))  # untouched
    assert not stats.captured and stats.chunk == 0
    assert stats.replay_ms() is None
    (empty,), _, _ = tscan.scan(_counter_step(inputs), (t0, acc0), 0, (acc0,))
    assert empty.shape == (0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tscan.scan(_counter_step(inputs), (t0, acc0), 6, (acc0, t0),
                   capture=True)


@pytest.mark.parametrize("steps,chunk,want", [
    (1, None, (0, 0, 0)),
    (5, None, (1, 4, 0)),  # fewer steps than MIN_REPLAYS: one a graph
    (97, None, (8, 12, 0)),
    (200, None, (7, 28, 3)),
    (40_000, None, (7, 5714, 1)),
    (2_000, 50, (50, 39, 49)),
    (3, 10, (2, 1, 0)),  # a chunk is at most the steps left
])
def test_scan_plan(steps, chunk, want):
    k, r, tail = tscan.plan(steps, chunk)
    assert (k, r, tail) == want
    if k:
        assert 1 + r * k + tail == steps and tail < k
        assert chunk is not None or k <= tscan.MAX_CHUNK


# -- no step reads the device on the host -------------------------------------


def _lips(n):
    lips = np.exp(np.random.default_rng(1).normal(size=n))
    lips[n // 5] = 30.0
    return lips


def _engines():
    g = tg.sbm([40] * 3, 0.2, 0.01, seed=0, layout="csr")
    rows = ttr.mh_importance_rows(g, _lips(g.n))
    params = ttr.MHLJParams(0.3, 0.5, 3)

    def build(layout, **kw):
        rp = (tg.flat_edge_values(g.indptr, g.degrees, rows)
              if layout == "ragged" else rows)
        return teng.WalkEngine.from_graph(g, params, row_probs=rp,
                                          layout=layout, device="cpu", **kw)

    return g, {
        "ragged": build("ragged"),
        "sparse": build("sparse"),
        "dense": build("dense"),
        "bucketed": build("bucketed", compact=False),
        "compacted": build("bucketed", compact=True),
        "compacted_overflowing": build("bucketed", compact=True,
                                       capacity_factor=1e-6),
        "live_rows": teng.WalkEngine.from_graph(
            g, params, layout="bucketed", device="cpu"),
    }


@pytest.mark.parametrize("name", ["ragged", "sparse", "dense", "bucketed",
                                  "compacted", "compacted_overflowing",
                                  "live_rows"])
def test_no_layout_step_reads_the_device(name):
    """One step of every layout, drawn from a generator at a device p_J
    (as ``run`` draws) and on an injected block, then a whole ``run``:
    no host read.  The compacted engines overflow (a tiny capacity) and
    do not."""
    g, engines = _engines()
    eng = engines[name]
    lips = (torch.as_tensor(_lips(g.n), dtype=torch.float32)
            if name == "live_rows" else None)
    w = 200
    nodes = torch.as_tensor(np.arange(w) * 7 % g.n, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    block = teng.draw_uniforms(w, 3, 0.3, torch.Generator().manual_seed(1),
                               torch.device("cpu"))
    with NoHostReads():
        _, _, aux = eng.step(nodes, generator=gen, p_j=torch.tensor([0.3]),
                             lipschitz=lips, with_aux=True)
        _, _, aux_b = eng.step(nodes, uniforms=block, lipschitz=lips,
                               with_aux=True)
        _, _, aux_r = eng.run(nodes, 4, generator=gen, lipschitz=lips,
                              with_aux=True)
    for flag in (aux["compact_overflow"], aux_b["compact_overflow"]):
        assert flag.shape == () and flag.dtype == torch.bool
        assert bool(flag) is (name == "compacted_overflowing")
    assert aux_r["compact_overflow"].shape == (4,)


def test_no_host_read_in_advance_or_the_fleet_step():
    """``WalkFleet.advance`` and ``run_fleet``'s step, with averaging on
    some steps (avg_every=2) and without it."""
    g, engines = _engines()
    data = make_heterogeneous_regression(g.n, dim=4, seed=0)
    feats = torch.as_tensor(data.features, dtype=torch.float32)
    targs = torch.as_tensor(data.targets, dtype=torch.float32)
    weights = torch.ones(g.n)
    gen = torch.Generator().manual_seed(2)
    for avg_every in (0, 2):
        fleet = tfleet.WalkFleet.create(engines["compacted"], 8, seed=0,
                                        avg_every=avg_every)
        with NoHostReads():
            advanced, hops = fleet.advance(generator=gen, p_j=0.3)
            out = tfleet.run_fleet(
                torch.zeros(8, 4), feats, targs, weights, fleet, 3, 1e-3,
                torch.full((3,), 0.3), True, treg.linear_grad, generator=gen,
            )
        assert advanced.nodes.shape == hops.shape == (8,)
        assert out[1].shape == (8, 4) and out[3].shape == (8, 3)


@pytest.mark.parametrize("name", ["ragged", "sparse", "compacted"])
def test_no_host_read_in_the_faulted_fleet_step(name):
    """The faulted loop (``run_fleet(faults=)``: the Markov advance, the
    masked update and average, the rejection and the rescue's live-set
    draw with its device gate) and ``advance(faults=)``, on a model with
    Markov rates and scripted hub windows; on the ragged engine with an
    edge window over a cut too (the ``(W, max_degree)`` slot lookup)."""
    from repro_torch.core import faults as tfaults

    g, engines = _engines()
    eng = engines[name]
    never = np.full(g.n, tfaults.NEVER, np.int32)
    down, up = never.copy(), never.copy()
    down[np.argsort(-g.degrees, kind="stable")[:3]], up[:] = 1, 4
    kw = dict(crash_rate=0.2, recovery_rate=0.3, patience=1,
              down_at=torch.as_tensor(down), up_at=torch.as_tensor(up))
    if name == "ragged":
        side = np.arange(g.n) < g.n // 2
        edges = tfaults.partition_groups(g.indptr, g.indices, side, at=0,
                                         duration=3, device="cpu")
        kw.update(edge_down_at=edges.edge_down_at,
                  edge_up_at=edges.edge_up_at)
    fm = tfaults.FaultModel(**kw)
    data = make_heterogeneous_regression(g.n, dim=4, seed=0)
    feats = torch.as_tensor(data.features, dtype=torch.float32)
    targs = torch.as_tensor(data.targets, dtype=torch.float32)
    fleet = tfleet.WalkFleet.create(eng, 8, seed=0, avg_every=2)
    gen = torch.Generator().manual_seed(2)
    state = fm.init_state(g.n, 8, device="cpu")
    with NoHostReads():
        advanced, hops, aux = fleet.advance(generator=gen, p_j=0.3,
                                            faults=(fm, state))
        out = tfleet.run_fleet(
            torch.zeros(8, 4), feats, targs, torch.ones(g.n), fleet, 6,
            1e-3, torch.full((6,), 0.3), True, treg.linear_grad,
            generator=gen, faults=fm,
        )
    assert aux["blocked_steps"].shape == hops.shape == (8,)
    final = out[5]
    assert final["rescued"].shape == final["blocked"].shape == (6,)
    assert int(final["blocked"].sum()) > 0
    assert int(final["fault_state"].t) == 6


def test_the_guard_catches_the_reads_it_names():
    """The dispatch mode sees the host reads a capture cannot hold."""
    x = torch.tensor([1, 0, 2])
    for read in (lambda: bool(x.any()), lambda: torch.bincount(x),
                 lambda: x.nonzero(), lambda: torch.unique(x),
                 lambda: x.repeat_interleave(x)):
        with NoHostReads(), pytest.raises(AssertionError, match="host read"):
            read()
