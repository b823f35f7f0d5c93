"""Port parity: node and edge faults, the Lévy-jump rescue, the faulted
fleet loop and fleet checkpoints (``repro_torch.core.faults``,
``WalkEngine.step(faults=)``, ``walk_sgd.fleet``, ``paper.fault_sweep``).

A faulted step of the reference draws three streams: the fleet splits
each step key into ``key_t, key_f``; ``key_f`` gives the ``(n,)`` Markov
uniforms (only when a rate is positive) and the engine splits ``key_t``
into the walk's key and the rescue's ``(W,)`` uniforms (whenever the
rescue is on).  ``tests/test_torch_trainer.py::_fleet_blocks`` draws all
three as the reference does, and the port takes them injected.  The
fault process, the rejection rule, the rescue and the walks are compares,
integer math, gathers and one exact float32 prefix sum of 0/1 weights,
so nodes, hops, ``blocked``, ``rescued`` and the final ``FaultState`` are
held with ``==``.  The models are float32 SGD in another reduction order:
``rtol=1e-4``, as in the trainer tests; the masked average is held at the
same tolerance.  Every graph here keeps its rows at most 17 wide, where
XLA's row cumsum equals the port's row CDF, except the fault sweep's
BA(96,2) (21 wide; held bit for bit all the same, see
``tests/test_torch_laws.py``).  Checkpoints the reference saves are built
on graphs whose XLA CDF never decreases inside a row, which
``interop.from_reference_state`` requires.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fault_sweep as ref_sweep
from repro.core import engine as jeng
from repro.core import faults as jf
from repro.core import graphs as jg
from repro.core.transition import MHLJParams as JParams
from repro.models import regression as jreg
from repro.walk_sgd import fleet as jfleet
from repro_torch import interop
from repro_torch.core import faults as tf
from repro_torch.core import graphs as tg
from repro_torch.models import regression as treg
from repro_torch.paper import fault_sweep
from repro_torch.walk_sgd import fleet as tfleet
from test_torch_trainer import _fleet_blocks

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_array_equal(port, np.asarray(ref))


def _port_model(fm: jf.FaultModel, **kw) -> tf.FaultModel:
    """The port's model of a reference model, through interop."""
    leaf = (lambda x: None if x is None else np.asarray(x))
    return interop.fault_model_from_reference(
        crash_rate=fm.crash_rate, recovery_rate=fm.recovery_rate,
        down_at=leaf(fm.down_at), up_at=leaf(fm.up_at),
        edge_down_at=leaf(fm.edge_down_at), edge_up_at=leaf(fm.edge_up_at),
        patience=fm.patience, rescue=fm.rescue, device="cpu", **kw)


def _port_state(fs: jf.FaultState) -> tf.FaultState:
    return interop.fault_state_from_reference(
        live=np.asarray(fs.live), blocked=np.asarray(fs.blocked),
        t=np.asarray(fs.t), device="cpu")


def _same_state(port: tf.FaultState, ref: jf.FaultState):
    _eq(port.live, ref.live)
    _eq(port.blocked, ref.blocked)
    _eq(port.t, ref.t)
    assert port.t.dtype == torch.int32 and port.blocked.dtype == torch.int32


# -- core/faults.py -------------------------------------------------------------


def test_fault_model_validation_and_init_state():
    for kw, match in ((dict(down_at=np.zeros(3, np.int32)), "together"),
                      (dict(edge_up_at=np.zeros(3, np.int32)), "together"),
                      (dict(patience=0), "patience")):
        with pytest.raises(ValueError, match=match):
            tf.FaultModel(**kw)
    st = tf.FaultModel().init_state(7, 3, start=5, device="cpu")
    ref = jf.FaultModel().init_state(7, 3)
    _eq(st.live, ref.live)
    _eq(st.blocked, ref.blocked)
    assert st.t.dtype == torch.int32 and int(st.t) == 5
    assert tf.NEVER == jf.NEVER


@pytest.mark.parametrize("rates", [(0.1, 0.3), (0.5, 0.0), (0.0, 0.0)])
def test_markov_advance_matches_reference(rates):
    n = 200
    ref_m = jf.FaultModel(crash_rate=rates[0], recovery_rate=rates[1])
    port_m = tf.FaultModel(crash_rate=rates[0], recovery_rate=rates[1])
    ref = ref_m.init_state(n, 4)
    port = port_m.init_state(n, 4, device="cpu")
    for step in range(12):
        key = jax.random.PRNGKey(step)
        ref = ref_m.advance(key, ref)
        u = np.array(jax.random.uniform(key, (n,), jnp.float32))
        port = port_m.advance(port, uniforms=u if port_m.markov else None)
        _same_state(port, ref)
    assert port_m.markov == any(r > 0 for r in rates)


def test_scripted_windows_match_reference():
    g_ref, g_port = jg.dumbbell(6, 2, layout="ragged"), tg.dumbbell(
        6, 2, layout="ragged")
    side = jf.dumbbell_bridge_mask(g_ref.n, 6, 2)
    _eq(tf.dumbbell_bridge_mask(g_port.n, 6, 2), side)
    hubs_ref = jf.kill_top_hubs(np.asarray(g_ref.degrees), 3, at=4,
                                duration=5)
    hubs = tf.kill_top_hubs(g_port.degrees, 3, at=4, duration=5,
                            device="cpu")
    part_ref = jf.partition_groups(g_ref.indptr, g_ref.indices, side, at=2,
                                   duration=6, patience=2)
    part = tf.partition_groups(g_port.indptr, g_port.indices, side, at=2,
                               duration=6, patience=2, device="cpu")
    for port_m, ref_m in ((hubs, hubs_ref), (part, part_ref)):
        for f in ("down_at", "up_at", "edge_down_at", "edge_up_at"):
            if getattr(ref_m, f) is None:
                assert getattr(port_m, f) is None
            else:
                _eq(getattr(port_m, f), getattr(ref_m, f))
                assert getattr(port_m, f).dtype == torch.int32
        assert port_m.patience == ref_m.patience
        ref_s = ref_m.init_state(g_ref.n, 2)
        port_s = port_m.init_state(g_ref.n, 2, device="cpu")
        for _ in range(14):
            _eq(port_m.live_mask(port_s), ref_m.live_mask(ref_s))
            e_ref = ref_m.edge_live_mask(ref_s)
            e = port_m.edge_live_mask(port_s)
            assert (e is None) == (e_ref is None)
            if e is not None:
                _eq(e, e_ref)
            ref_s = ref_m.advance(jax.random.PRNGKey(0), ref_s)
            port_s = port_m.advance(port_s)
    for bad, match in ((lambda: tf.kill_top_hubs(np.ones(4), 0, at=0), "k"),
                       (lambda: tf.partition_groups(
                           g_port.indptr, g_port.indices, side[:-1], at=0),
                        "side"),
                       (lambda: tf.partition_groups(
                           g_port.indptr, g_port.indices,
                           np.zeros(g_port.n, bool), at=0), "cuts no edge"),
                       (lambda: tf.dumbbell_bridge_mask(10, 6, 1),
                        "not a dumbbell")):
        with pytest.raises(ValueError, match=match):
            bad()


@pytest.mark.parametrize("n", [1, 7, 300])
def test_live_uniform_choice_matches_reference(n):
    rng = np.random.default_rng(n)
    for p_live in (0.05, 0.5, 1.0):
        live = rng.random(n) < p_live
        u = np.array(jax.random.uniform(jax.random.PRNGKey(n), (999,)))
        u[:3] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
        _eq(tf.live_uniform_choice(_t(u), _t(live)),
            jf.live_uniform_choice(jnp.asarray(u), jnp.asarray(live)))


def test_edge_slot_lookup_matches_reference():
    g = jg.barabasi_albert(80, 3, seed=2, layout="ragged")
    rng = np.random.default_rng(0)
    src = rng.integers(0, g.n, 400).astype(np.int32)
    ip, ix = np.asarray(g.indptr), np.asarray(g.indices)
    # half true neighbors (self-loops included), half arbitrary nodes
    dst = np.where(rng.random(400) < 0.5,
                   ix[ip[src] + rng.integers(0, 1 << 30, 400)
                      % np.diff(ip)[src]],
                   rng.integers(0, g.n, 400)).astype(np.int32)
    md = int(np.asarray(g.degrees).max())
    slot_r, found_r = jf.edge_slot_lookup(jnp.asarray(ip), jnp.asarray(ix),
                                          jnp.asarray(src), jnp.asarray(dst),
                                          md)
    slot, found = tf.edge_slot_lookup(_t(ip, torch.int32),
                                      _t(ix, torch.int32), _t(src), _t(dst),
                                      md)
    _eq(found, found_r)
    f = np.asarray(found_r)
    _eq(slot.numpy()[f], np.asarray(slot_r)[f])
    assert 0.4 < f.mean() < 1.0


@pytest.mark.parametrize("rescue", [True, False])
@pytest.mark.parametrize("edges", [False, True])
def test_apply_liveness_matches_reference(rescue, edges):
    g = jg.barabasi_albert(60, 2, seed=4, layout="ragged")
    ip, ix = np.asarray(g.indptr), np.asarray(g.indices)
    rng = np.random.default_rng(int(rescue) + 2 * int(edges))
    w = 500
    nodes = rng.integers(0, g.n, w).astype(np.int32)
    nxt = ix[ip[nodes] + rng.integers(0, 1 << 30, w) % np.diff(ip)[nodes]]
    nxt = np.where(rng.random(w) < 0.2, rng.integers(0, g.n, w), nxt)
    nxt = nxt.astype(np.int32)
    hops = rng.integers(1, 4, w).astype(np.int32)
    blocked = rng.integers(0, 4, w).astype(np.int32)
    live = rng.random(g.n) < 0.7
    live[nodes[:5]] = False
    kw = dict(patience=2, rescue=rescue, rescue_hops=3)
    if edges:
        edge_live = rng.random(ix.size) < 0.6
        kw.update(max_degree=int(np.asarray(g.degrees).max()))
    key = jax.random.PRNGKey(9)
    ref = jf.apply_liveness(
        key, jnp.asarray(nodes), jnp.asarray(nxt), jnp.asarray(hops),
        jnp.asarray(blocked), jnp.asarray(live),
        **kw, **(dict(edge_live=jnp.asarray(edge_live),
                      indptr=jnp.asarray(ip), indices=jnp.asarray(ix))
                 if edges else {}))
    u = np.array(jax.random.uniform(key, (w,), jnp.float32))
    port = tf.apply_liveness(
        _t(nodes), _t(nxt), _t(hops), _t(blocked), _t(live),
        uniforms=u if rescue else None,
        **kw, **(dict(edge_live=_t(edge_live), indptr=_t(ip, torch.int32),
                      indices=_t(ix, torch.int32)) if edges else {}))
    for a, b in zip(port, ref):
        _eq(a, b)
    assert bool(port[3].any()) and (bool(port[4].any()) == rescue)
    with pytest.raises(ValueError, match="CSR-bearing"):
        tf.apply_liveness(_t(nodes), _t(nxt), _t(hops), _t(blocked),
                          _t(live), patience=2, rescue=False,
                          edge_live=_t(np.ones(ix.size, bool)))


def test_total_failure_parks_even_with_rescue():
    live = torch.zeros(3, dtype=torch.bool)
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    out, _, blocked, was, rescued = tf.apply_liveness(
        idx, torch.tensor([1, 2, 0], dtype=torch.int32),
        torch.ones(3, dtype=torch.int32), torch.full((3,), 5, dtype=torch.int32),
        live, patience=1, rescue=True, uniforms=torch.rand(3))
    _eq(out, [0, 1, 2])
    assert bool(was.all()) and not bool(rescued.any())
    _eq(blocked, [6, 6, 6])


# -- WalkEngine.step(faults=) on every layout ----------------------------------

ENGINE_LAYOUTS = {
    "sparse": ("dense", None),
    "dense": ("dense", "dense"),
    "bucketed": ("bucketed", None),
    "ragged": ("ragged", None),
}


def _ref_engine(layout, clique=8, path=3, p_j=0.3, r=2):
    graph_layout, engine_layout = ENGINE_LAYOUTS[layout]
    g = jg.dumbbell(clique, path, layout=graph_layout)
    lips = np.exp(np.random.default_rng(1).normal(size=g.n))
    eng = jeng.WalkEngine.from_graph(
        g, JParams(p_j=p_j, p_d=0.5, r=r), lipschitz=lips, backend="scan",
        **({"layout": engine_layout} if engine_layout else {}))
    return g, eng


def _port_fleet(ref_fleet):
    """The reference's fleet in the port, through its checkpoint dict."""
    return tfleet.WalkFleet.restore(ref_fleet.checkpoint(), device="cpu")


def _scenario(g, markov=True, rescue=True, edges=False):
    kw = dict(crash_rate=0.15 if markov else 0.0,
              recovery_rate=0.2 if markov else 0.0, patience=2,
              rescue=rescue)
    if edges:
        side = jf.dumbbell_bridge_mask(g.n, 8, 3)
        return jf.partition_groups(g.indptr, g.indices, side, at=0, **kw)
    down = np.full(g.n, jf.NEVER, np.int32)
    up = np.full(g.n, jf.NEVER, np.int32)
    down[:3], up[:3] = 1, 6
    return jf.FaultModel(down_at=jnp.asarray(down), up_at=jnp.asarray(up),
                         **kw)


@pytest.mark.parametrize("layout", sorted(ENGINE_LAYOUTS))
@pytest.mark.parametrize("rescue", [True, False])
def test_engine_step_with_faults_matches_reference(layout, rescue):
    """Eight faulted steps: ``step(key, faults=)`` of the reference against
    the port's on the key's two streams, the fault state carried along."""
    g, eng = _ref_engine(layout)
    ref_fleet = jfleet.WalkFleet.create(eng, 16, seed=3)
    port_fleet = _port_fleet(ref_fleet)
    fm = _scenario(g, rescue=rescue, edges=layout == "ragged")
    pm = _port_model(fm)
    fs, ps = fm.init_state(g.n, 16), pm.init_state(g.n, 16, device="cpu")
    nodes_r, nodes_p = ref_fleet.nodes, port_fleet.nodes
    total_blocked = 0
    for step in range(8):
        key = jax.random.PRNGKey(100 + step)
        key_f = jax.random.fold_in(key, 1)
        fs = fm.advance(key_f, fs)
        ps = pm.advance(ps, uniforms=np.array(
            jax.random.uniform(key_f, (g.n,), jnp.float32)))
        nxt_r, hops_r, aux_r = eng.step(key, nodes_r, with_aux=True,
                                        faults=(fm, fs))
        key_w, key_r = jax.random.split(key)
        u = jax.random.uniform(key_w, (16, jeng.num_uniforms(eng.r)))
        u = np.array(u.at[:, 0].set((u[:, 0] < eng.p_j).astype(jnp.float32)))
        nxt_p, hops_p, aux_p = port_fleet.engine.step(
            nodes_p, uniforms=torch.from_numpy(u), with_aux=True,
            faults=(pm, ps),
            rescue_uniforms=np.array(jax.random.uniform(key_r, (16,))))
        _eq(nxt_p, nxt_r)
        _eq(hops_p, hops_r)
        for k in ("blocked_steps", "fault_blocked", "rescued"):
            _eq(aux_p[k], aux_r[k])
        assert not bool(aux_p["compact_overflow"])
        total_blocked += int(aux_p["fault_blocked"].sum())
        fs = dataclasses.replace(fs, blocked=aux_r["blocked_steps"])
        ps = dataclasses.replace(ps, blocked=aux_p["blocked_steps"])
        nodes_r, nodes_p = nxt_r, nxt_p
    assert total_blocked > 0


def test_engine_step_faults_refusals_and_generator():
    g, eng = _ref_engine("sparse")
    port = _port_fleet(jfleet.WalkFleet.create(eng, 4, seed=0))
    pm = _port_model(_scenario(g))
    ps = pm.init_state(g.n, 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="with_aux"):
        port.engine.step(port.nodes, generator=gen, faults=(pm, ps))
    with pytest.raises(ValueError, match="rescue_uniforms"):
        port.engine.step(port.nodes, uniforms=torch.zeros(4, 5),
                         with_aux=True, faults=(pm, ps))
    g_r, eng_r = _ref_engine("ragged")
    pe = _port_model(_scenario(g_r, edges=True))
    with pytest.raises(ValueError, match="CSR-bearing"):
        port.engine.step(port.nodes, generator=gen, with_aux=True,
                         faults=(pe, pe.init_state(g.n, 4, device="cpu")))
    # the generator path: the walk's block, then the rescue's draw
    gen_a, gen_b = (torch.Generator().manual_seed(5) for _ in range(2))
    nxt, hops, aux = port.engine.step(port.nodes, generator=gen_a,
                                      with_aux=True, faults=(pm, ps))
    u = torch.rand((4, 5), generator=gen_b)
    u[:, 0] = (u[:, 0] < float(np.float32(eng.p_j))).to(torch.float32)
    again = port.engine.step(port.nodes, uniforms=u, with_aux=True,
                             faults=(pm, ps),
                             rescue_uniforms=torch.rand(4, generator=gen_b))
    _eq(nxt, again[0])
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


def test_fleet_advance_with_faults_matches_reference():
    g, eng = _ref_engine("ragged")
    ref = jfleet.WalkFleet.create(eng, 10, seed=1)
    port = _port_fleet(ref)
    fm = _scenario(g, edges=True)
    pm = _port_model(fm)
    fs, ps = fm.init_state(g.n, 10), pm.init_state(g.n, 10, device="cpu")
    for step in range(4):
        key = jax.random.PRNGKey(step)
        ref, hops_r, aux_r = ref.advance(key, faults=(fm, fs))
        key_w, key_r = jax.random.split(key)
        u = jax.random.uniform(key_w, (10, jeng.num_uniforms(eng.r)))
        u = np.array(u.at[:, 0].set((u[:, 0] < eng.p_j).astype(jnp.float32)))
        port, hops, aux = port.advance(
            uniforms=torch.from_numpy(u), faults=(pm, ps),
            rescue_uniforms=np.array(jax.random.uniform(key_r, (10,))))
        _eq(port.nodes, ref.nodes)
        _eq(hops, hops_r)
        _eq(aux["blocked_steps"], aux_r["blocked_steps"])
        fs = dataclasses.replace(fs, blocked=aux_r["blocked_steps"])
        ps = dataclasses.replace(ps, blocked=aux["blocked_steps"])


# -- the faulted fleet loop, resume and checkpoints ------------------------------


def test_masked_average_matches_reference_formula():
    """``fleet_average(xs, do_avg, live)`` against the reference's masked
    average (``repro/walk_sgd/fleet.py:536-545``, its lines in jnp) on 200
    random fleets: dead walkers keep their models bit for bit; the live
    mean's column sums run in another order, so some entries differ in
    the last bits (the share and the largest error are printed: run with
    ``-s``); held at 1e-6 of the column's mean |x|."""
    rng = np.random.default_rng(0)
    differ = compared = 0
    worst = 0.0
    for trial in range(200):
        w, d = int(rng.integers(1, 40)), int(rng.integers(1, 12))
        xs = rng.normal(size=(w, d)).astype(np.float32)
        live = rng.random(w) < rng.random()
        do = bool(trial % 4)
        xj, al = jnp.asarray(xs), jnp.asarray(live)
        w_live = al.astype(xj.dtype)[:, None]
        mean = (xj * w_live).sum(axis=0, keepdims=True) / (
            jnp.maximum(w_live.sum(), 1.0))
        ref = np.asarray(jnp.where(jnp.asarray(do) & al[:, None],
                                   jnp.broadcast_to(mean, xj.shape), xj))
        port = tfleet.fleet_average(torch.from_numpy(xs), torch.tensor(do),
                                    torch.from_numpy(live)).numpy()
        _eq(port[~live], xs[~live])
        if not (do and live.any()):
            _eq(port, xs)
            continue
        scale = np.abs(xs[live]).mean(axis=0)
        differ += int((port[live] != ref[live]).sum())
        compared += port[live].size
        worst = max(worst, float(np.max(np.abs(port - ref)[live] / scale)))
    print(f"masked average: {differ} of {compared} averaged entries differ "
          f"from the reference's; largest error {worst:.3g} of the column's "
          "mean |x|")
    assert worst <= 1e-6


FLEET_CASES = ("sparse_markov", "ragged_edges", "bucketed_no_rescue")


def _fleet_case(name):
    layout = name.split("_")[0]
    g, eng = _ref_engine(layout, p_j=0.2)
    fm = _scenario(g, rescue=name != "bucketed_no_rescue",
                   edges=name == "ragged_edges")
    ref_fleet = jfleet.WalkFleet.create(eng, 5, seed=2, avg_every=4)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.n, 3)).astype(np.float32)
    targs = rng.normal(size=g.n).astype(np.float32)
    weights = np.exp(rng.normal(size=g.n) * 0.3).astype(np.float32)
    return g, eng, fm, ref_fleet, feats, targs, weights


def _ref_run(case, steps, start=0, total=None, fleet=None, xs=None,
             fault_state=None, faults=True):
    g, eng, fm, ref_fleet, feats, targs, weights = case
    sched = np.full(steps, eng.p_j, np.float32)
    return jfleet.run_fleet(
        jax.random.PRNGKey(7),
        np.zeros((5, 3), np.float32) if xs is None else xs, feats, targs,
        weights, fleet or ref_fleet, steps, 0.05, sched, True,
        jreg.linear_grad, faults=fm if faults else None,
        fault_state=fault_state, start_step=start, total_steps=total)


def _port_run(case, port_fleet, steps, start=0, total=None, xs=None,
              fault_state=None, **draw):
    g, eng, fm, _, feats, targs, weights = case
    if not draw:
        u, fu, ru = _fleet_blocks(
            7, total or steps, 5, eng.r, np.full(steps, eng.p_j, np.float32),
            start=start, fault_nodes=g.n)
        draw = dict(uniforms=torch.from_numpy(u),
                    fault_uniforms=torch.from_numpy(fu) if fm.crash_rate
                    else None,
                    rescue_uniforms=torch.from_numpy(ru) if fm.rescue
                    else None)
    return tfleet.run_fleet(
        torch.zeros(5, 3) if xs is None else torch.as_tensor(xs),
        torch.from_numpy(feats), torch.from_numpy(targs),
        torch.from_numpy(weights), port_fleet, steps, 0.05,
        torch.full((steps,), float(np.float32(eng.p_j))), True,
        treg.linear_grad, faults=_port_model(fm), fault_state=fault_state,
        start_step=start, total_steps=total, **draw)


def _same_run(port, ref, masked_avg=True):
    xs, mse, avg, nodes, hops, final = port
    _eq(nodes, ref[3])
    _eq(hops, ref[4])
    _eq(final["nodes"], ref[5]["nodes"])
    _eq(final["rescued"], ref[5]["rescued"])
    _eq(final["blocked"], ref[5]["blocked"])
    _same_state(final["fault_state"], ref[5]["fault_state"])
    np.testing.assert_allclose(mse.numpy(), np.asarray(ref[1]), rtol=RTOL)
    np.testing.assert_allclose(avg.numpy(), np.asarray(ref[2]), rtol=RTOL)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref[0]), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("name", FLEET_CASES)
def test_faulted_run_fleet_matches_reference(name):
    case = _fleet_case(name)
    ref = _ref_run(case, 60)
    port = _port_run(case, _port_fleet(case[3]), 60)
    _same_run(port, ref)
    rescued, blocked = port[5]["rescued"], port[5]["blocked"]
    assert rescued.dtype == blocked.dtype == torch.int32
    assert int(blocked.sum()) > 0
    assert (int(rescued.sum()) > 0) == case[2].rescue


def test_faulted_run_fleet_window_resumes_bitwise():
    """[0, 25) then [25, 60) of a 60-step run on the reference's window
    streams, against the reference's uninterrupted run."""
    case = _fleet_case("sparse_markov")
    ref = _ref_run(case, 60)
    port_fleet = _port_fleet(case[3])
    a = _port_run(case, port_fleet, 25, total=60)
    mid = dataclasses.replace(port_fleet, nodes=a[5]["nodes"])
    b = _port_run(case, mid, 35, start=25, total=60, xs=a[0],
                  fault_state=a[5]["fault_state"])
    _eq(torch.cat([a[3], b[3]], dim=1), ref[3])
    _eq(torch.cat([a[5]["rescued"], b[5]["rescued"]]), ref[5]["rescued"])
    _same_state(b[5]["fault_state"], ref[5]["fault_state"])
    np.testing.assert_allclose(b[0].numpy(), np.asarray(ref[0]), rtol=RTOL,
                               atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="start_step"):
        _port_run(case, port_fleet, 5, start=-1, generator=gen)
    with pytest.raises(ValueError, match="exceeds"):
        _port_run(case, port_fleet, 10, start=5, total=10, generator=gen)
    with pytest.raises(ValueError, match="fault_uniforms"):
        _port_run(case, port_fleet, 5, uniforms=torch.zeros(5, 5, 5))


def test_reference_checkpoint_resumes_bitwise_in_the_port(tmp_path):
    """The reference runs [0, 30) of a faulted 70-step run and saves its
    fleet with the models and the FaultState leaves as extras; the port
    loads the file and runs [30, 70) on the reference's window streams:
    equal to the reference's uninterrupted run.  The ragged CDF the file
    carries is XLA's (never decreasing inside a row on this dumbbell),
    kept as it is."""
    case = _fleet_case("ragged_edges")
    ref = _ref_run(case, 70)
    a = _ref_run(case, 30, total=70)
    st = a[5]["fault_state"]
    path = jfleet.save_fleet_checkpoint(
        str(tmp_path / "ref.npz"),
        dataclasses.replace(case[3], nodes=a[5]["nodes"]), step=30,
        extras={"xs": np.asarray(a[0]), "fault_live": np.asarray(st.live),
                "fault_blocked": np.asarray(st.blocked),
                "fault_t": np.asarray(st.t)})
    fleet, step, ex = tfleet.load_fleet_checkpoint(path, device="cpu")
    assert step == 30 and fleet.num_walks == 5 and fleet.avg_every == 4
    _eq(fleet.engine.edge_cdf, case[1].edge_cdf)
    state = interop.fault_state_from_reference(
        live=ex["fault_live"], blocked=ex["fault_blocked"], t=ex["fault_t"],
        device="cpu")
    b = _port_run(case, fleet, 40, start=30, total=70, xs=ex["xs"],
                  fault_state=state)
    _eq(b[3], np.asarray(ref[3])[:, 30:])
    _eq(b[4], np.asarray(ref[4])[:, 30:])
    _eq(b[5]["blocked"], np.asarray(ref[5]["blocked"])[30:])
    _same_state(b[5]["fault_state"], ref[5]["fault_state"])
    np.testing.assert_allclose(b[0].numpy(), np.asarray(ref[0]), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("layout", sorted(ENGINE_LAYOUTS))
def test_port_checkpoint_round_trip_resumes_bitwise(layout, tmp_path):
    """The port's own kill-and-restore, drawing from a generator: [0, 20),
    save (models, FaultState leaves and the generator's state as extras),
    load, [20, 45) — equal to the uninterrupted run, every output."""
    g, eng = _ref_engine(layout)
    fm = _port_model(_scenario(g, edges=layout == "ragged"))
    fleet = _port_fleet(jfleet.WalkFleet.create(eng, 6, seed=4, avg_every=3))
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.normal(size=(g.n, 3)).astype(np.float32))
    targs = torch.from_numpy(rng.normal(size=g.n).astype(np.float32))
    sched = torch.full((45,), 0.3)

    def run(fl, steps, start, xs, gen, state=None):
        return tfleet.run_fleet(xs, feats, targs, torch.ones(g.n), fl, steps,
                                0.05, sched[start:start + steps], False,
                                treg.linear_grad, generator=gen, faults=fm,
                                fault_state=state, start_step=start,
                                total_steps=45)

    full = run(fleet, 45, 0, torch.zeros(6, 3),
               torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    a = run(fleet, 20, 0, torch.zeros(6, 3), gen)
    st = a[5]["fault_state"]
    path = tfleet.save_fleet_checkpoint(
        str(tmp_path / "port.npz"),
        dataclasses.replace(fleet, nodes=a[5]["nodes"]), step=20,
        extras={"xs": a[0], "fault_live": st.live,
                "fault_blocked": st.blocked, "fault_t": st.t,
                "generator": gen.get_state()})
    loaded, step, ex = tfleet.load_fleet_checkpoint(path, device="cpu")
    assert step == 20 and loaded.engine.layout == layout
    for f in tfleet._ENGINE_DATA_FIELDS:
        mine, theirs = getattr(fleet.engine, f), getattr(loaded.engine, f)
        if isinstance(mine, tuple):
            assert all(torch.equal(x, y) for x, y in zip(mine, theirs))
        elif isinstance(mine, torch.Tensor):
            assert torch.equal(mine, theirs)
        else:
            assert mine == theirs
    gen_b = torch.Generator()
    gen_b.set_state(torch.from_numpy(ex["generator"]))
    state = interop.fault_state_from_reference(
        live=ex["fault_live"], blocked=ex["fault_blocked"], t=ex["fault_t"],
        device="cpu")
    b = run(loaded, 25, 20, torch.from_numpy(ex["xs"]), gen_b, state)
    assert torch.equal(b[0], full[0])
    assert torch.equal(torch.cat([a[3], b[3]], dim=1), full[3])
    assert torch.equal(torch.cat([a[1], b[1][:, 1:]], dim=1), full[1])
    assert torch.equal(torch.cat([a[5]["blocked"], b[5]["blocked"]]),
                       full[5]["blocked"])
    assert torch.equal(b[5]["fault_state"].live, full[5]["fault_state"].live)


def test_checkpoint_refuses_what_the_port_cannot_honour(tmp_path):
    g, eng = _ref_engine("ragged")
    ckpt = jfleet.WalkFleet.create(eng, 3, seed=0).checkpoint()
    fleet = tfleet.WalkFleet.restore(ckpt, device="cpu")  # JAX-only statics
    assert fleet.engine.layout == "ragged"
    # a churned engine keeps its graph version and its sticky cdf_width
    churned = tfleet.WalkFleet.restore(
        {**ckpt, "engine_meta": {**ckpt["engine_meta"], "graph_version": 1}},
        device="cpu")
    assert churned.engine.graph_version == 1
    assert churned.engine.cdf_width == ckpt["engine_meta"]["cdf_width"]
    for change, match in (
        (dict(version=2), "version"),
        (dict(engine_meta={**ckpt["engine_meta"], "cdf_width":
                           ckpt["engine_meta"]["max_degree"] - 1}),
         "cover"),
        (dict(engine_meta={**ckpt["engine_meta"], "walker_sharding": "x"}),
         "sharded"),
        (dict(engine_meta={**ckpt["engine_meta"], "novel": 1}), "know"),
    ):
        with pytest.raises(ValueError, match=match):
            tfleet.WalkFleet.restore({**ckpt, **change}, device="cpu")
    path = tfleet.save_fleet_checkpoint(str(tmp_path / "a" / "f.npz"), fleet)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["f.npz"]
    ref_fleet, step, extras = jfleet.load_fleet_checkpoint(path)
    assert step == 0 and extras == {}
    _eq(ref_fleet.engine.edge_cdf, eng.edge_cdf)
    _eq(ref_fleet.nodes, fleet.nodes)


# -- the fault sweep's training leg ---------------------------------------------


def test_fault_sweep_smoke_matches_reference():
    """Every training leg of the smoke tier on the reference's streams:
    the excess, the rescue and blocked totals and the criterion."""
    p = ref_sweep.SCALES["smoke"]
    ref_train, ref_derived = {}, {}
    for fam, graph, data in ref_sweep._graphs(p):
        opt = ref_sweep._mse_opt(data)
        out = {"mse_opt": opt}
        for leg, rate, rescue in fault_sweep.legs(ref_sweep.RATES["smoke"]):
            fm = None if rate is None else jf.FaultModel(
                crash_rate=rate, recovery_rate=p["recovery"],
                patience=p["patience"], rescue=rescue)
            res = ref_sweep._train_leg(graph, data, p, fault_model=fm)
            res["excess"] = max(res["final_avg_mse"] - opt, 1e-12)
            out[leg] = res
            ref_derived[f"{fam}_excess_{leg}"] = res["excess"]
        ref_train[fam] = out

    calls = []

    def blocks(*, family, leg, seed, steps, walks, n, r, p_j, markov, rescue):
        calls.append((family, leg))
        if not markov:
            return {"uniforms": torch.from_numpy(
                _fleet_blocks(seed, steps, walks, r, p_j))}
        u, fu, ru = _fleet_blocks(seed, steps, walks, r, p_j, fault_nodes=n)
        return {"uniforms": torch.from_numpy(u),
                "fault_uniforms": torch.from_numpy(fu),
                "rescue_uniforms": torch.from_numpy(ru) if rescue else None}

    port = fault_sweep.run_smoke(device="cpu", blocks=blocks)
    assert len(calls) == 6 and port["serve"].startswith("not ported")
    assert set(port["derived"]) == set(ref_derived)
    for fam, legs in ref_train.items():
        for leg, res in legs.items():
            if leg == "mse_opt":
                assert port["train"][fam][leg] == res
                continue
            mine = port["train"][fam][leg]
            for k in ("rescues", "blocked_steps"):
                assert mine.get(k) == res.get(k), (fam, leg, k)
            np.testing.assert_allclose(mine["excess"], res["excess"],
                                       rtol=RTOL)
    assert (fault_sweep.NAME, fault_sweep.PAPER_CLAIM) == (
        ref_sweep.NAME, ref_sweep.PAPER_CLAIM)
    assert fault_sweep.RATES == ref_sweep.RATES
    for scale, settings in ref_sweep.SCALES.items():
        assert fault_sweep.SCALES[scale] == {
            k: v for k, v in settings.items() if k != "serve"}
