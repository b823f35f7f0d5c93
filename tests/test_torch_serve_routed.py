"""Port parity: walk-routed serving (``repro_torch.launch.serve``'s
``ServeSimulator``, ``build_route_engine`` and arrival traces, the routed
``main``, ``paper.serve_throughput`` and ``paper.fault_sweep``'s serving
leg).

The reference is driven as its own tests drive it (``tests/test_serve.py``,
``tests/test_faults.py``): the reduced mamba2-370m, one ``ServeEngine`` per
module reused through ``reset()``, the route engine on its ``"auto"``
backend.  Its weights cross into the port through ``interop``, as in
``tests/test_torch_serve.py``.  Each tick of the reference keys its walk
``fold_in(PRNGKey(seed), t)`` (under faults split into the Markov, walk and
rescue streams); ``tests/test_torch_trainer.py::_serve_blocks`` draws them
as the reference does and the port takes them through
``ServeSimulator.inject``.

What must be equal, with ``==``: the arrival log, the walker positions of
every tick, every request's ``(rid, node, submit_tick, admit_tick,
done_tick, shed_reason)``, the metrics but their three wall-clock keys
(``requests_per_sec``, ``tokens_per_sec``, ``walk_steps_per_sec``) and the
fault totals.  A request finishes on its token count alone, so scheduling
does not depend on the logits; the greedy tokens are held by
``tests/test_torch_serve.py``'s rule: logits at atol = rtol = 2e-4 up to
the first engine step whose argmax differs, which must be a near-tie of
the reference's logits (a top-two gap under twice that tolerance).

The route engines' walks on the reference's blocks: bitwise from nodes of
degree at most 17 (where XLA's row cumsum equals the port's sequential
row CDF), a pick-mismatch rate of at most 1e-3 from wider rows (measured
and printed: run with ``-s``).  BA(96,3) reaches degree 27, and the
simulators' walks were equal on every case all the same.

The port's own generator (the CLI's and the card's path) is held by law
and invariant, as the reference's tests hold theirs: conservation,
shed-exactly-once, zero fault telemetry without faults, the refusals.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fault_sweep as ref_fault_sweep
from benchmarks import serve_throughput as ref_serve_throughput
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import faults as jf
from repro.core.graphs import barabasi_albert as jba
from repro.launch import serve as js
from repro.walk_sgd import trainer as jtrainer
from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.core import faults as tf
from repro_torch.core import heterogeneity as thet
from repro_torch.core.graphs import barabasi_albert as tba
from repro_torch.launch import serve as ts
from repro_torch.paper import fault_sweep, serve_throughput
from repro_torch.walk_sgd import trainer as ttrainer
from test_torch_trainer import _serve_blocks

CFG = reduced(get_arch("mamba2-370m"))
LOGIT_TOL = 2e-4
MISMATCH_RATE = 1e-3  # route walks from rows wider than 17
WALL_CLOCK = ("requests_per_sec", "tokens_per_sec", "walk_steps_per_sec")
METHODS = ("simple", "uniform", "importance", "mhlj", "heterogeneity",
           "private")
LAW_KWARGS = {"private": {"gamma": 0.5}}
TICKS, DRAIN = 60, 30


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class Engines:
    """The reference's ServeEngine and the port's on its weights, each
    recording the logits of every decode step."""

    def __init__(self, batch, cache_len, max_queue):
        self.ref = js.ServeEngine(jreduced(jget_arch("mamba2-370m")), batch,
                                  cache_len, seed=0, max_queue=max_queue)
        self.ref_logits, self.port_logits = [], []
        decode = jax.jit(
            lambda p, c, t, pos: self.ref.model.decode_step(p, t, c, pos))

        def recording_step(params, cache, tokens, pos):
            logits, cache = decode(params, cache, tokens, pos)
            self.ref_logits.append(np.asarray(logits))
            return (jnp.argmax(logits, axis=-1).astype(jnp.int32).reshape(-1),
                    cache)

        self.ref._step = recording_step
        model = interop.model_from_reference_params(
            CFG, jax.tree_util.tree_map(np.asarray, self.ref.params),
            device="cpu")
        port_decode = model.decode_step

        def recording_decode(tokens, cache, pos):
            logits, cache = port_decode(tokens, cache, pos)
            self.port_logits.append(logits.numpy().copy())
            return logits, cache

        model.decode_step = recording_decode
        self.port = ts.ServeEngine(CFG, batch, cache_len, max_queue=max_queue,
                                   model=model, device="cpu")

    def reset(self):
        self.ref_logits.clear()
        self.port_logits.clear()
        return self.ref.reset(), self.port.reset()


@pytest.fixture(scope="module")
def engines():
    return Engines(2, 64, 4)


@pytest.fixture(scope="module")
def graphs():
    return (jba(96, 3, seed=0, layout="ragged"),
            tba(96, 3, seed=0, layout="ragged"))


def _port_fault_model(fm):
    return None if fm is None else tf.FaultModel(
        crash_rate=fm.crash_rate, recovery_rate=fm.recovery_rate,
        patience=fm.patience, rescue=fm.rescue)


def _records(sim):
    """Every offered request's scheduling record, by rid."""
    eng = sim.engine
    reqs = (list(eng.completed) + list(eng.shed_requests) + list(eng.queue)
            + [s for s in eng.slots if s is not None]
            + [r for dq in sim.pending.values() for r in dq])
    recs = sorted((r.rid, r.node, r.submit_tick, r.admit_tick, r.done_tick,
                   r.shed_reason) for r in reqs)
    assert [r[0] for r in recs] == list(range(sim.offered))  # each once
    return recs


def _conserved(m, sim):
    """The reference's invariant: every offered request accounted once."""
    eng = sim.engine
    shed = m["shed_queue_full"] + m["shed_deadline"] + m["shed_node_down"]
    assert shed == len(eng.shed_requests)
    rids = [r.rid for r in eng.shed_requests] + [r.rid for r in eng.completed]
    assert len(rids) == len(set(rids))  # nothing shed or completed twice
    assert m["offered"] == (
        m["completed"] + shed + m["pending_left"] + m["queued_left"]
        + sum(s is not None for s in eng.slots))


def _same_tokens(eng: Engines, jsim, tsim):
    """Greedy tokens under the near-tie rule (module docstring)."""
    assert len(eng.ref_logits) == len(eng.port_logits)
    for step, (jl, tl) in enumerate(zip(eng.ref_logits, eng.port_logits)):
        np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"logits at engine step {step}")
        differ = np.nonzero(jl.argmax(-1) != tl.argmax(-1))[0]
        if differ.size:
            for row in differ:
                top2 = np.sort(jl[row])[-2:]
                tie_tol = 2 * (LOGIT_TOL + LOGIT_TOL * abs(top2[1]))
                assert top2[1] - top2[0] < tie_tol, (
                    f"greedy token differs at engine step {step}, slot "
                    f"{row}, with a reference top-two gap {top2[1] - top2[0]}")
            return
    assert ({r.rid: r.generated for r in jsim.engine.completed}
            == {r.rid: r.generated for r in tsim.engine.completed})


def _same_run(jsim, tsim, jm, tm):
    assert tsim.arrival_log == jsim.arrival_log
    assert len(tsim.visits) == len(jsim.visits)
    for t, (a, b) in enumerate(zip(tsim.visits, jsim.visits)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"tick {t}")
    assert _records(tsim) == _records(jsim)
    assert set(tm) == set(jm)
    for k in jm:
        if k not in WALL_CLOCK:
            assert tm[k] == jm[k], k
    for k in ("rescues", "blocked_steps", "relocated", "down_node_ticks"):
        assert getattr(tsim, k) == getattr(jsim, k), k


def _both_sims(engines, graphs, method, *, fault_model=None, trace=None,
               seed=0, **kw):
    """The reference's simulator and the port's on its blocks."""
    jeng, teng = engines.reset()
    jg, tg = graphs
    kw = dict(method=method, num_walkers=16, rate=1.0, pickup=4,
              deadline_ticks=30, prompt_len=(4, 8), max_new_tokens=4,
              seed=seed, law_kwargs=LAW_KWARGS.get(method), relocate_after=2,
              arrival_trace=trace, **kw)
    jsim = js.ServeSimulator(jg, jeng, fault_model=fault_model, **kw)
    tsim = ts.ServeSimulator(tg, teng, fault_model=_port_fault_model(
        fault_model), **kw)
    fm = fault_model
    tsim.inject(_serve_blocks(
        seed, TICKS + DRAIN, 16, tsim.route_engine.r, tsim.p_j,
        n=None if fm is None else jg.n,
        markov=fm is not None and (fm.crash_rate > 0 or fm.recovery_rate > 0),
        rescue=fm is not None and fm.rescue))
    return jsim, tsim


# -- the route seam --------------------------------------------------------------


def _rows_of(monkeypatch, module):
    """Record the host rows ``module._setup_method`` returns."""
    seen = []
    setup = module._setup_method

    def recording(*args, **kw):
        out = setup(*args, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(module, "_setup_method", recording)
    return seen


@pytest.mark.parametrize("method", METHODS)
def test_build_route_engine_matches_reference(method, graphs, monkeypatch):
    """The host row buffers bit for bit, ``p_j`` equal, and walks on the
    reference's blocks through both engines."""
    jg, tg = graphs
    load = np.asarray(jg.degrees, np.float64)
    kw = {"law_kwargs": ({"pi": load / load.sum()} if method == "heterogeneity"
                         else LAW_KWARGS.get(method))}
    ref_rows, port_rows = (_rows_of(monkeypatch, m)
                           for m in (jtrainer, ttrainer))
    jeng, jpj = js.build_route_engine(jg, method, load, **kw)
    teng, tpj = ts.build_route_engine(tg, method, load, device="cpu", **kw)
    assert tpj == jpj
    assert (jpj > 0) == (method == "mhlj")
    (rr,), (pr,) = ref_rows, port_rows
    rr = np.asarray(rr)
    assert pr.dtype == rr.dtype and pr.shape == rr.shape
    bits = f"u{rr.dtype.itemsize}"
    np.testing.assert_array_equal(pr.view(bits), rr.view(bits))
    assert (teng.r, teng.p_d) == (jeng.r, jeng.p_d)
    # walks: each step from the reference's positions, on its key's block
    w, steps = 64, 40
    rng = np.random.default_rng(5)
    deg = np.asarray(jg.degrees)
    wide = differ = 0
    for step in range(steps):
        nodes = rng.integers(0, jg.n, w).astype(np.int32)
        key = jax.random.PRNGKey(100 + step)
        nxt_r, hops_r = jeng.step(key, jnp.asarray(nodes), p_j=jpj)
        u = jax.random.uniform(key, (w, 3 + jeng.r), jnp.float32)
        u = np.array(u.at[:, 0].set((u[:, 0] < jpj).astype(jnp.float32)))
        nxt_p, hops_p = teng.step(torch.from_numpy(nodes),
                                  uniforms=torch.from_numpy(u))
        narrow = deg[nodes] <= 17
        np.testing.assert_array_equal(nxt_p.numpy()[narrow],
                                      np.asarray(nxt_r)[narrow])
        np.testing.assert_array_equal(hops_p.numpy(), np.asarray(hops_r))
        wide += int((~narrow).sum())
        differ += int((nxt_p.numpy() != np.asarray(nxt_r))[~narrow].sum())
    rate = differ / max(wide, 1)
    print(f"route {method}: {differ} of {wide} walks from rows wider than 17 "
          f"pick differently (rate {rate:.3g}, held <= {MISMATCH_RATE})")
    assert rate <= MISMATCH_RATE


def test_build_route_engine_refusals_match_reference(graphs):
    jg, tg = graphs
    for args in (("no-such-law", np.ones(jg.n)),
                 ("uniform", np.zeros(jg.n)),
                 ("uniform", np.ones(jg.n + 1))):
        with pytest.raises(ValueError) as ref_err:
            js.build_route_engine(jg, *args)
        with pytest.raises(ValueError) as port_err:
            ts.build_route_engine(tg, *args, device="cpu")
        assert str(port_err.value) == str(ref_err.value)


# -- the simulator on the reference's blocks ------------------------------------

FAULT_CASES = {
    "fault_free": None,
    "faults_rescue": jf.FaultModel(crash_rate=0.04, recovery_rate=0.1,
                                   patience=2),
    "faults_no_rescue": jf.FaultModel(crash_rate=0.04, recovery_rate=0.1,
                                      patience=2, rescue=False),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
@pytest.mark.parametrize("method", METHODS)
def test_simulator_matches_reference_on_its_blocks(method, case, engines,
                                                   graphs):
    fm = FAULT_CASES[case]
    jsim, tsim = _both_sims(engines, graphs, method, fault_model=fm)
    jm = jsim.run(TICKS, drain_ticks=DRAIN)
    tm = tsim.run(TICKS, drain_ticks=DRAIN)
    _same_run(jsim, tsim, jm, tm)
    _same_tokens(engines, jsim, tsim)
    _conserved(tm, tsim)
    assert tm["offered"] > 0 and tm["completed"] > 0
    assert tm["shed_deadline"] + tm["shed_node_down"] > 0  # a deadline sheds
    if fm is None:
        assert tm["walker_blocked_steps"] == tm["node_downtime_frac"] == 0
    else:
        assert tm["walker_blocked_steps"] > 0 and tm["relocated_requests"] > 0
        assert (tm["walker_rescues"] > 0) == fm.rescue


# -- arrival traces ---------------------------------------------------------------


def test_reference_trace_replays_equal_in_the_port(engines, graphs, tmp_path):
    """A trace the reference records and writes, loaded by the port and
    replayed under faults on the reference's blocks, equals the reference's
    replay; the port's file loads in the reference."""
    jsim, tsim = _both_sims(engines, graphs, "mhlj")
    jsim.run(30, drain_ticks=10)
    ref_path = str(tmp_path / "ref_trace.npz")
    js.save_arrival_trace(ref_path, jsim.arrival_log)
    loaded = ts.load_arrival_trace(ref_path)
    np.testing.assert_array_equal(loaded, js.load_arrival_trace(ref_path))
    assert loaded.dtype == np.int64 and loaded.shape == (jsim.offered, 3)
    port_path = str(tmp_path / "port_trace.npz")
    assert ts.save_arrival_trace(port_path, loaded) == port_path
    np.testing.assert_array_equal(js.load_arrival_trace(port_path), loaded)

    fm = FAULT_CASES["faults_rescue"]
    jsim, tsim = _both_sims(engines, graphs, "mhlj", fault_model=fm,
                            trace=loaded)
    jm = jsim.run(TICKS, drain_ticks=DRAIN)
    tm = tsim.run(TICKS, drain_ticks=DRAIN)
    _same_run(jsim, tsim, jm, tm)
    assert tm["offered"] == len(loaded)


def test_trace_order_and_empty_case_match_reference(tmp_path):
    """Unsorted rows load stably sorted by tick in both packages; the empty
    trace is ``(0, 3)``; a wrong shape is the same ``ValueError``."""
    rows = np.array([[5, 1, 4], [2, 7, 3], [5, 0, 6], [2, 3, 5]], np.int64)
    for save in (js.save_arrival_trace, ts.save_arrival_trace):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, rows)
        got = ts.load_arrival_trace(path)
        np.testing.assert_array_equal(got, js.load_arrival_trace(path))
        np.testing.assert_array_equal(got, rows[[1, 3, 0, 2]])
    empty = str(tmp_path / "empty.npz")
    ts.save_arrival_trace(empty, [])
    assert js.load_arrival_trace(empty).shape == (0, 3)
    with pytest.raises(ValueError) as ref_err:
        js.save_arrival_trace(str(tmp_path / "bad.npz"), [[1, 2]])
    with pytest.raises(ValueError) as port_err:
        ts.save_arrival_trace(str(tmp_path / "bad.npz"), [[1, 2]])
    assert str(port_err.value) == str(ref_err.value)


# -- the port's own generator: laws and invariants -------------------------------


@pytest.fixture(scope="module")
def serve_graph():
    return tba(96, 2, seed=0, layout="ragged")


def _serve_sim(graph, *, fault_model=None, trace=None, seed=0):
    """``tests/test_faults.py``'s serving scenario on the port."""
    eng = ts.ServeEngine(CFG, 2, 64, seed=0, max_queue=8, device="cpu")
    return ts.ServeSimulator(
        graph, eng, method="mhlj", num_walkers=6, rate=1.2, pickup=2,
        deadline_ticks=40, prompt_len=(3, 6), max_new_tokens=4, seed=seed,
        fault_model=fault_model, relocate_after=2, arrival_trace=trace,
    )


def test_simulator_serves_requests_end_to_end(engines, graphs):
    _, teng = engines.reset()
    sim = ts.ServeSimulator(
        graphs[1], teng, method="mhlj", num_walkers=16, rate=1.0, pickup=4,
        deadline_ticks=60, prompt_len=(4, 8), max_new_tokens=4, seed=0,
    )
    m = sim.run(60, drain_ticks=30)
    assert m["offered"] > 0 and m["completed"] > 0
    assert m["requests_per_sec"] > 0
    assert 0.0 < m["herfindahl"] <= 1.0
    assert m["p99_ticks"] >= m["p50_ticks"] > 0
    _conserved(m, sim)
    assert sum(sim.tick_seconds.values()) <= sim._wall


def test_faulted_serving_degrades_gracefully(serve_graph):
    """Faults produce degradation telemetry while every offered request is
    accounted for exactly once, under recycle, deadline and node_down."""
    fm = tf.FaultModel(crash_rate=0.04, recovery_rate=0.1, patience=2)
    sim = _serve_sim(serve_graph, fault_model=fm)
    m = sim.run(80, drain_ticks=40)
    assert m["completed"] > 0
    assert m["walker_blocked_steps"] > 0
    assert m["walker_rescues"] > 0
    assert m["node_downtime_frac"] > 0
    _conserved(m, sim)
    assert sim.route_engine.device.type == "cpu"
    assert sim._fault_state.live.device.type == "cpu"


def test_no_fault_serving_keeps_fault_telemetry_zero(serve_graph):
    m = _serve_sim(serve_graph).run(30, drain_ticks=10)
    assert m["walker_rescues"] == 0
    assert m["walker_blocked_steps"] == 0
    assert m["shed_node_down"] == 0
    assert m["node_downtime_frac"] == 0.0
    assert m["relocated_requests"] == 0


def test_arrival_trace_roundtrip_and_replay_identity(serve_graph, tmp_path):
    """Record a fault-free trace, replay it under two rescue policies: every
    leg sees the identical workload and identical seeds give identical
    completions."""
    src = _serve_sim(serve_graph)
    src.run(30, drain_ticks=10)
    trace = np.asarray(src.arrival_log, np.int64)
    assert trace.shape[1] == 3
    path = str(tmp_path / "trace.npz")
    ts.save_arrival_trace(path, trace)
    loaded = ts.load_arrival_trace(path)
    np.testing.assert_array_equal(loaded, trace)

    fm_on = tf.FaultModel(crash_rate=0.04, recovery_rate=0.1, patience=2)
    fm_off = dataclasses.replace(fm_on, rescue=False)
    a = _serve_sim(serve_graph, fault_model=fm_on, trace=loaded)
    a.run(30, drain_ticks=10)
    b = _serve_sim(serve_graph, fault_model=fm_on, trace=loaded)
    b.run(30, drain_ticks=10)
    assert a.arrival_log == b.arrival_log
    pa = [(r.rid, r.prompt.tolist()) for r in a.engine.completed]
    pb = [(r.rid, r.prompt.tolist()) for r in b.engine.completed]
    assert pa == pb
    c = _serve_sim(serve_graph, fault_model=fm_off, trace=loaded)
    c.run(30, drain_ticks=10)
    assert a.arrival_log == c.arrival_log
    assert a.offered == c.offered == len(loaded)
    assert c.rescues == 0


def test_save_arrival_trace_validates(tmp_path):
    path = str(tmp_path / "empty.npz")
    ts.save_arrival_trace(path, [])
    assert ts.load_arrival_trace(path).shape == (0, 3)
    with pytest.raises(ValueError):
        ts.save_arrival_trace(str(tmp_path / "bad.npz"), [[1, 2]])
    with pytest.raises(ValueError, match="arrival_trace"):
        _serve_sim(tba(96, 2, seed=0, layout="ragged"),
                   trace=np.zeros((3, 2), np.int64))


def test_simulator_rejects_bad_requests(engines, graphs):
    _, teng = engines.reset()
    sim = ts.ServeSimulator(graphs[1], teng, num_walkers=4, seed=0,
                            prompt_len=(4, 6), max_new_tokens=3)
    rng = np.random.default_rng(0)

    def req(rid, node, plen, max_new):
        return ts.Request(rid=rid, prompt=rng.integers(
            0, CFG.vocab_size, plen).astype(np.int32),
            max_new_tokens=max_new, node=node)

    with pytest.raises(ValueError, match="outside"):
        sim.offer(req(0, graphs[1].n, 4, 3))
    with pytest.raises(ValueError, match="cache budget"):
        sim.offer(req(1, 0, teng.cache_len, 1))
    assert sim.offered == 0 and not sim.pending


def test_heterogeneity_never_measures_pi(engines, graphs, monkeypatch):
    """The serving graph's pi defaults to the normalized load: the dense
    (n, n) dissimilarity measurement never runs."""
    def refuse(*a, **k):
        raise AssertionError("heterogeneity_pi ran on a serving graph")

    monkeypatch.setattr(thet, "heterogeneity_pi", refuse)
    _, teng = engines.reset()
    sim = ts.ServeSimulator(graphs[1], teng, method="heterogeneity",
                            num_walkers=8, rate=0.5, prompt_len=(4, 6),
                            max_new_tokens=3, seed=1)
    m = sim.run(30, drain_ticks=10)
    assert m["ticks"] == 40 and m["offered"] > 0


@pytest.mark.parametrize("faults", [False, True])
def test_generator_run_equals_its_streams_injected(engines, graphs, faults):
    """The generator-driven run draws, per tick, the Markov uniforms, the
    walk block, then the rescue's: ``draw_streams`` from a generator of the
    same seed, injected, gives the same run."""
    runs = []
    drawn = torch.Generator().manual_seed(3)
    for inject in (False, True):
        _, teng = engines.reset()
        fm = tf.FaultModel(crash_rate=0.05, recovery_rate=0.1,
                           patience=2) if faults else None
        sim = ts.ServeSimulator(graphs[1], teng, num_walkers=16, rate=1.0,
                                deadline_ticks=30, prompt_len=(4, 8),
                                max_new_tokens=4, seed=3, fault_model=fm)
        if inject:
            sim.inject(sim.draw_streams(TICKS, drawn))
        m = sim.run(TICKS - 10, drain_ticks=10)
        runs.append((sim, m))
    (a, ma), (b, mb) = runs
    for t, (va, vb) in enumerate(zip(a.visits, b.visits)):
        np.testing.assert_array_equal(va, vb, err_msg=f"tick {t}")
    assert _records(a) == _records(b)
    assert {k: v for k, v in ma.items() if k not in WALL_CLOCK} == {
        k: v for k, v in mb.items() if k not in WALL_CLOCK}
    # the run consumed exactly the streams draw_streams drew
    assert torch.equal(a.generator.get_state(), drawn.get_state())


def test_inject_refuses_streams_the_walk_does_not_consume(engines, graphs):
    _, teng = engines.reset()
    fm = tf.FaultModel(crash_rate=0.05, recovery_rate=0.1, rescue=False)
    sim = ts.ServeSimulator(graphs[1], teng, num_walkers=4, fault_model=fm)
    good = sim.draw_streams(5, torch.Generator().manual_seed(0))
    assert sorted(good) == ["fault_uniforms", "uniforms"]
    with pytest.raises(ValueError, match="consumes the streams"):
        sim.inject({**good, "rescue_uniforms": torch.zeros(5, 4)})
    with pytest.raises(ValueError, match="must be"):
        sim.inject({**good, "uniforms": torch.zeros(5, 4, 3)})
    with pytest.raises(ValueError, match="same number of ticks"):
        sim.inject({**good, "fault_uniforms": torch.zeros(4, graphs[1].n)})
    sim.inject(good)
    sim.run(5)
    with pytest.raises(ValueError, match="hold 5 ticks"):
        sim.tick()


# -- the sweeps on the reference's blocks ----------------------------------------


def _no_wall_clock(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if k not in WALL_CLOCK and not k.endswith("_requests_per_sec")}


def test_serve_throughput_smoke_matches_reference():
    ref = ref_serve_throughput.run_smoke()
    calls = []

    def blocks(*, law, seed, ticks, walkers, n, r, p_j):
        calls.append(law)
        return _serve_blocks(seed, ticks, walkers, r, p_j)

    port = serve_throughput.run_smoke(device="cpu", blocks=blocks)
    assert calls == [law[0] for law in serve_throughput.LAWS]
    assert set(port["derived"]) == set(ref["derived"])
    assert _no_wall_clock(port["derived"]) == _no_wall_clock(ref["derived"])
    for law in port["laws"]:
        assert _no_wall_clock(port[law]) == _no_wall_clock(ref[law]), law
        assert port[law]["completed"] > 0
    for k in ("scale", "graph", "n", "walkers", "ticks", "claim", "laws"):
        assert port[k] == ref[k], k
    assert set(port["route_setup_s"]) == set(port["laws"])
    assert (serve_throughput.NAME, serve_throughput.PAPER_CLAIM,
            serve_throughput.SCALES) == (
        ref_serve_throughput.NAME, ref_serve_throughput.PAPER_CLAIM,
        ref_serve_throughput.SCALES)
    assert serve_throughput.LAWS == ref_serve_throughput.LAWS


def test_fault_sweep_serving_leg_smoke_matches_reference():
    """The serving leg of the smoke tier on the reference's blocks: every
    leg's non-wall-clock metrics and shed rate, and the derived keys."""
    p = ref_fault_sweep.SCALES["smoke"]
    sp = p["serve"]
    graph = jba(sp["n"], sp["m"], seed=0, layout="ragged")
    engine = js.ServeEngine(jreduced(jget_arch("mamba2-370m")), sp["batch"],
                            sp["cache_len"], seed=0,
                            max_queue=sp["max_queue"])
    ref = {"fault_free": ref_fault_sweep._serve_leg(graph, sp, engine)}
    trace = np.asarray(ref["fault_free"].pop("arrival_log"), np.int64)
    for leg, rate, rescue in fault_sweep.legs(ref_fault_sweep.RATES["smoke"]):
        if rate is None:
            continue
        ref[leg] = ref_fault_sweep._serve_leg(
            graph, sp, engine, trace=trace, fault_model=jf.FaultModel(
                crash_rate=rate, recovery_rate=p["recovery"],
                patience=p["patience"], rescue=rescue))
        ref[leg].pop("arrival_log")

    def blocks(*, family, leg, seed, steps, walks, n, r, p_j, markov,
               rescue):
        if family != "serve":
            return None  # the training leg is held in test_torch_faults.py
        return _serve_blocks(seed, steps, walks, r, float(p_j[0]),
                             n=n if markov or rescue else None,
                             markov=markov, rescue=rescue)

    port = fault_sweep.run_smoke(device="cpu", blocks=blocks)
    assert list(port["serve"]) == list(ref)
    for leg, m in ref.items():
        assert _no_wall_clock(port["serve"][leg]) == _no_wall_clock(m), leg
        assert port["derived"][f"serve_p99_{leg}"] == m["p99_ticks"]
        assert port["derived"][f"serve_shed_rate_{leg}"] == m["shed_rate"]
        assert port["serve"][leg]["offered"] == len(trace)
    assert port["serve"]["f5_no_rescue"]["walker_rescues"] == 0
    assert port["serve"]["f5_with_rescue"]["walker_rescues"] > 0


# -- the routed CLI --------------------------------------------------------------


def _offered(out: str) -> int:
    return int(re.search(r"^offered: (\d+)$", out, re.M).group(1))


def test_routed_main_records_and_replays_a_trace(capsys, tmp_path):
    path = str(tmp_path / "cli_trace.npz")
    base = ["--device", "cpu", "--nodes", "200", "--walkers", "8",
            "--ticks", "30", "--drain", "10", "--batch", "2",
            "--cache-len", "64", "--max-new", "4"]
    assert ts.main(base + ["--record-trace", path]) == 0
    recorded = _offered(capsys.readouterr().out)
    assert recorded == len(ts.load_arrival_trace(path)) > 0
    assert ts.main(base + ["--trace", path, "--crash-rate", "0.05",
                           "--recovery-rate", "0.1", "--patience", "2",
                           "--no-rescue", "--relocate-after", "2",
                           "--deadline", "20"]) == 0
    out = capsys.readouterr().out
    assert _offered(out) == recorded
    assert "walker_rescues: 0" in out
