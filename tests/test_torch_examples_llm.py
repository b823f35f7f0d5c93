"""The port's model examples (``examples/torch/llm_decentralized.py`` and
``serve_demo.py``) run with ``--device cpu --small``, held to their own
claims: both routings train (finite losses, one update a step, MH-uniform
one hop an update), the online L_v estimates move off their start, and
every routing law serves requests without losing any (completed + shed +
still queued = offered)."""
import numpy as np

from test_torch_examples import run_example


def test_llm_decentralized_small():
    out = run_example("llm_decentralized")
    for method in ("uniform", "mhlj"):
        losses = np.asarray(out[method]["losses"])
        assert losses.shape == (10,) and np.isfinite(losses).all()
        assert out[method]["transitions_per_update"] >= 1.0
    assert out["uniform"]["transitions_per_update"] == 1.0
    assert np.ptp(out["mhlj"]["final_lipschitz"]) > 0


def test_serve_demo_small():
    out = run_example("serve_demo")
    assert set(out) == {"simple", "uniform", "mhlj", "private_g0.5"}
    for m in out.values():
        assert m["completed"] > 0
        assert m["completed"] <= m["offered"]
        assert 0 < m["herfindahl"] < 1
