"""The port's examples (``examples/torch/``) run with ``--device cpu
--small``.

Host-numpy outputs are held bit for bit against the JAX package's own
functions on the same graphs and seeds: ``entrapment_demo``'s dwell
times, spectral gaps, mixing bounds and perturbation norms, and
``annealing_error_gap``'s exact error gaps.  Walk-trained outputs are held
to the examples' own claims: in ``quickstart`` the ``importance`` walk
spends at least 90% of its updates at the L-spike node and ``mhlj`` less,
and MHLJ's measured transitions per update stay within Remark 1's bound.
``llm_decentralized`` and ``serve_demo`` are in
``tests/test_torch_examples_llm.py``.
"""
import importlib.util
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(name: str, *argv) -> dict:
    path = os.path.join(REPO, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main(["--device", "cpu", "--small", *argv])


def test_quickstart_claims():
    out = run_example("quickstart")
    assert out["importance"]["spike_share"] >= 0.9
    assert out["mhlj"]["spike_share"] < out["importance"]["spike_share"]
    rep = out["remark1"]
    assert rep["within_bound"]
    assert (rep["transitions_per_update_measured"]
            <= rep["transitions_per_update_bound"])
    assert all(np.isfinite(m).all() for k in ("uniform", "importance", "mhlj")
               for m in out[k]["mse"])


def test_entrapment_demo_matches_reference_bit_for_bit():
    from repro.core import transition as jtrans
    from repro.core.entrapment import expected_dwell_time
    from repro.core.graphs import grid2d, ring, watts_strogatz
    from repro.core.mixing import mixing_time_bounds, spectral_gap
    from repro.core.theory import perturbation_l1
    from repro.core.transition import MHLJParams

    out = run_example("entrapment_demo")
    params = MHLJParams(p_j=0.1, p_d=0.5, r=3)
    for graph in (ring(100), grid2d(10, 10), watts_strogatz(100, 4, 0.1, seed=0)):
        got = out[graph.name]
        lips = np.ones(graph.n)
        spike = graph.n // 2
        lips[spike] = 50.0
        p_is = jtrans.mh_importance(graph, lips)
        p_mhlj = jtrans.mhlj(graph, lips, params)
        assert got["dwell_is"] == expected_dwell_time(p_is)[spike]
        assert got["dwell_mhlj"] == expected_dwell_time(p_mhlj)[spike]
        assert got["gap_is"] == spectral_gap(p_is)
        assert got["gap_mhlj"] == spectral_gap(p_mhlj)
        assert got["tmix_is"] == mixing_time_bounds(p_is)
        assert got["tmix_mhlj"] == mixing_time_bounds(p_mhlj)
        assert got["perturbation_l1"] == perturbation_l1(graph, lips, params)
        # the walk-level picture: MHLJ's top node holds fewer updates
        assert got["occupancy_mhlj"] < got["occupancy_is"]


def test_annealing_error_gap_matches_reference_bit_for_bit():
    from repro.core.graphs import ring
    from repro.core.theory import error_gap_exact
    from repro.core.transition import MHLJParams

    out = run_example("annealing_error_gap")
    n = 64
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, 6)) * np.where(rng.random(n) < 0.1, 2.0, 1.0)[:, None]
    targs = feats @ (3 * rng.normal(size=6)) + rng.normal(size=n)
    lips = 2 * (feats**2).sum(1)
    want = [error_gap_exact(ring(n), feats, targs, lips, MHLJParams(pj, 0.5, 3))
            for pj in (0.2, 0.1, 0.05, 0.025, 0.0125)]
    assert out["gaps"] == want
    # "slope approaches 2": each halving of p_J steepens it toward 2
    assert all(a < b < 2.0 for a, b in zip(out["slopes"], out["slopes"][1:]))
    assert all(np.isfinite(v) for pair in (out["constant"], out["annealed"])
               for v in pair)
