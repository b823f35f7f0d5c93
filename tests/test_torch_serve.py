"""The port's ``ServeEngine``: the JAX package's scheduling contract
(``tests/test_serve.py``'s engine cases, on the port) and greedy tokens
equal to the JAX engine's on the same weights.

The contract cases run the port's reduced mamba2-370m on the CPU in
float32.  The parity cases build the JAX ``ServeEngine`` (its own random
init), carry its params into the port (``interop``), submit the same
requests to both, and record every decode step's logits.  Logits must
agree at atol = rtol = 2e-4 up to the first step whose greedy token
differs; a token may differ only where the reference's top-two logit gap
at that step is under twice that tolerance (a near-tie), else the test
fails.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Request, ServeEngine, latency_percentiles

CFG = reduced(get_arch("mamba2-370m"))
LOGIT_TOL = 2e-4


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def engine():
    return ServeEngine(CFG, 2, 64, seed=0, max_queue=4, device="cpu")


def _req(rid, plen=4, max_new=3, **kw):
    rng = np.random.default_rng(100 + rid)
    prompt = rng.integers(0, CFG.vocab_size, plen).astype(np.int32)
    return Request(rid=rid, prompt=prompt, max_new_tokens=max_new, **kw)


# -- the scheduling contract ---------------------------------------------------


def test_finished_slot_immediately_refilled(engine):
    eng = engine.reset()
    for rid in range(4):  # 2 slots, 4 equal-length requests
        assert eng.submit(_req(rid, plen=4, max_new=3))
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
    stats = eng.stats()
    assert stats["completed"] == 4
    # 4 requests x (4 + 3 - 1) busy steps over 2 always-busy slots
    assert stats["engine_steps"] == 12
    assert stats["slot_utilization"] == 1.0


def test_queue_empty_idle_slots_are_noops(engine):
    eng = engine.reset()
    eng.step()  # fully idle
    assert eng.engine_steps == 0 and eng.cache_pos == 0
    assert eng.submit(_req(0, plen=4, max_new=3))
    eng.run()
    stats = eng.stats()
    assert stats["completed"] == 1
    assert len(eng.completed[0].generated) == 3
    assert stats["slot_utilization"] == pytest.approx(0.5)


def test_oversized_prompt_rejected_loudly(engine):
    eng = engine.reset()
    with pytest.raises(ValueError, match="cache budget"):
        eng.submit(_req(0, plen=eng.cache_len, max_new=1))
    with pytest.raises(ValueError, match="cache budget"):
        eng.submit(_req(1, plen=4, max_new=eng.cache_len))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(_req(2, plen=0))
    assert not eng.queue and not eng.shed_requests


def test_deadline_expired_shed_exactly_once(engine):
    eng = engine.reset()
    expired = _req(0, deadline=5)
    live = _req(1, deadline=50)
    assert eng.submit(expired, tick=0)
    assert eng.submit(live, tick=0)
    eng.step(tick=10)
    assert expired.shed and expired.shed_reason == "deadline"
    assert eng.stats()["shed_deadline"] == 1
    assert eng.slots[0] is live
    with pytest.raises(RuntimeError, match="shed twice"):
        eng.shed(expired, "queue_full")
    assert eng.stats()["shed_deadline"] == 1
    assert eng.stats()["shed_queue_full"] == 0


def test_bounded_queue_backpressure(engine):
    eng = engine.reset()  # max_queue=4
    assert all(eng.submit(_req(rid)) for rid in range(4))
    overflow = _req(99)
    assert eng.submit(overflow) is False
    assert overflow.shed and overflow.shed_reason == "queue_full"
    assert eng.stats()["shed_queue_full"] == 1
    assert len(eng.queue) == 4


def test_cache_recycle_preempts_and_completes(engine):
    eng = engine.reset()
    # 4 x (8 + 30) busy steps over 2 slots, beyond the 63-row cache epoch
    for rid in range(4):
        assert eng.submit(_req(rid, plen=8, max_new=30))
    stats = eng.run()
    assert stats["completed"] == 4
    assert stats["cache_recycles"] >= 1
    for req in eng.completed:
        assert len(req.generated) == 30


def test_latency_percentiles_bookkeeping(engine):
    eng = engine.reset()
    for rid in range(3):
        assert eng.submit(_req(rid, plen=4, max_new=3), tick=0)
    eng.run()
    lat = latency_percentiles(eng.completed)
    assert lat["p50_ticks"] > 0
    assert lat["p50_ticks"] <= lat["p95_ticks"] <= lat["p99_ticks"]
    assert latency_percentiles([]) == {
        "p50_ticks": 0.0, "p95_ticks": 0.0, "p99_ticks": 0.0
    }


def test_standalone_main_and_routed_mode_run(capsys):
    assert tserve.main(["--standalone", "--device", "cpu", "--requests", "3",
                        "--max-new", "4"]) == 0
    assert "completed: 3" in capsys.readouterr().out
    # the routed mode (the default): a BA graph, a walker fleet, exit 0 iff
    # something completed
    assert tserve.main(["--device", "cpu", "--nodes", "200", "--walkers", "8",
                        "--ticks", "30", "--drain", "10"]) == 0
    out = capsys.readouterr().out
    assert "walk_steps_per_sec" in out and "completed: 0" not in out


# -- greedy tokens against the JAX engine ----------------------------------------


def _serve_both(arch, batch, cache_len, requests, max_new):
    jcfg = jreduced(jget_arch(arch))
    jeng = JServeEngine(jcfg, batch, cache_len, seed=0)
    jlogits, tlogits = [], []
    decode = jax.jit(lambda p, c, t, pos: jeng.model.decode_step(p, t, c, pos))

    def recording_step(params, cache, tokens, pos):
        logits, cache = decode(params, cache, tokens, pos)
        jlogits.append(np.asarray(logits))
        return jnp.argmax(logits, axis=-1).astype(jnp.int32).reshape(-1), cache

    jeng._step = recording_step
    model = interop.model_from_reference_params(
        reduced(get_arch(arch)), jax.tree_util.tree_map(np.asarray, jeng.params),
        device="cpu")
    decode_t = model.decode_step

    def recording_decode(tokens, cache, pos):
        logits, cache = decode_t(tokens, cache, pos)
        tlogits.append(logits.numpy().copy())
        return logits, cache

    model.decode_step = recording_decode
    teng = ServeEngine(reduced(get_arch(arch)), batch, cache_len, model=model,
                       device="cpu")
    reqs = tserve.standalone_requests(requests, jcfg.vocab_size, max_new, seed=0)
    for r in reqs:
        jeng.submit(JRequest(rid=r.rid, prompt=r.prompt.copy(),
                             max_new_tokens=r.max_new_tokens))
        teng.submit(r)
    return jeng, jeng.run(), jlogits, teng, teng.run(), tlogits


@pytest.mark.parametrize("arch", ["mamba2-370m", "minitron-8b"])
def test_greedy_tokens_match_jax_engine(arch):
    # 8 requests of 4-23 prompt tokens and 16 new, 4 slots (the standalone
    # demo's defaults) in a 64-row cache, so the run also recycles the cache
    jeng, jstats, jlogits, teng, tstats, tlogits = _serve_both(
        arch, batch=4, cache_len=64, requests=8, max_new=16)
    for step, (jl, tl) in enumerate(zip(jlogits, tlogits)):
        np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"logits at engine step {step}")
        differ = np.nonzero(jl.argmax(-1) != tl.argmax(-1))[0]
        if differ.size:
            # a near-tie in the reference is the only excuse; the runs
            # diverge from here, so stop comparing
            for row in differ:
                top2 = np.sort(jl[row])[-2:]
                tie_tol = 2 * (LOGIT_TOL + LOGIT_TOL * abs(top2[1]))
                assert top2[1] - top2[0] < tie_tol, (
                    f"greedy token differs at engine step {step}, slot {row}, "
                    f"with a reference top-two gap of {top2[1] - top2[0]}")
            return
    assert jstats["completed"] == tstats["completed"] == 8
    assert {r.rid: r.generated for r in jeng.completed} == {
        r.rid: r.generated for r in teng.completed}
    for key in ("engine_steps", "cache_recycles", "p50_ticks", "p99_ticks"):
        assert jstats[key] == tstats[key], key
    assert jstats["cache_recycles"] >= 1
