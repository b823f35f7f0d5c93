"""Port parity: ``repro_torch.paper.multi_walk`` (the reference's
``benchmarks/multi_walk.py``) at its smallest size on the CPU.

T = 200, one repetition, W in {1, 2}, on the reference's own blocks
(``test_torch_paper.ReferenceBlocks``), against the reference's
``run_rw_sgd_multi`` called as its benchmark calls it (same seeds, same
start nodes) but unsharded: the reference's sharded path fails on jax
0.9.0.  Hops are held with ``==``, the final MSEs at the
trainer's rtol 1e-4, the excess over the floor (a difference) at 1e-4 of
the floor.  A one-rank gloo mesh gives the unsharded bits.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import graphs as jg
from repro.core.transition import MHLJParams as JParams
from repro.data import make_heterogeneous_regression as j_data
from repro.walk_sgd import run_rw_sgd_multi as j_run_multi
from repro_torch.launch.mesh import make_walker_mesh
from repro_torch.paper import multi_walk
from test_torch_paper import MSE_RTOL, ReferenceBlocks

SMALL = dict(num_steps=200, reps=1, walkers=(1, 2))


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _reference(num_steps, reps, walkers):
    n = 128
    graph = jg.ring(n)
    data = j_data(n, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
                  x_star_scale=3.0)
    gamma = 0.3 / data.lipschitz.mean()
    rng = np.random.default_rng(0)
    out = {}
    for w in walkers:
        runs = [j_run_multi("mhlj", graph, data, gamma, num_steps, w,
                            mhlj_params=JParams(0.1, 0.5, 3), seed=1000 * rep,
                            v0s=rng.integers(0, n, size=w))
                for rep in range(reps)]
        out[w] = {"mean_final_mse": float(np.mean([data.mse(r.x_avg)
                                                   for r in runs])),
                  "hops_per_update": float(np.mean(
                      [r.transitions_per_update for r in runs]))}
    return out, data.mse(data.optimum())


def test_multi_walk_smallest_matches_reference():
    blocks = ReferenceBlocks()
    port = multi_walk.run(device="cpu", blocks=blocks, **SMALL)
    ref, floor = _reference(**SMALL)
    assert blocks.calls == [("ring", "mhlj", 0, 200, 1, 3),
                            ("ring", "mhlj", 0, 200, 2, 3)]
    assert port["mesh_devices"] == 1 and port["claim"] == multi_walk.PAPER_CLAIM
    np.testing.assert_allclose(port["ls_floor_mse"], floor, rtol=1e-12)
    for w in SMALL["walkers"]:
        got = port["walks"][w]
        assert got["num_walkers"] == w
        assert got["hops_per_update"] == ref[w]["hops_per_update"]
        np.testing.assert_allclose(got["mean_final_mse"],
                                   ref[w]["mean_final_mse"], rtol=MSE_RTOL)
        np.testing.assert_allclose(
            port["excess_over_floor"][str(w)],
            ref[w]["mean_final_mse"] - floor, rtol=0, atol=MSE_RTOL * floor)
        assert got["aggregate_walk_steps_per_sec"] > 0
    d = port["derived"]
    assert set(d) == {"excess_w1", "excess_w2", "variance_reduction_w2",
                      "aggregate_walk_steps_per_sec_w2"}
    assert d["variance_reduction_w2"] == d["excess_w1"] / d["excess_w2"]


def test_multi_walk_on_a_one_rank_mesh_equals_unsharded(tmp_path):
    """``mesh=`` passes through to every run: one gloo rank gives the
    unsharded results bit for bit."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            world_size=1, rank=0)
    try:
        mesh = make_walker_mesh(device_type="cpu")
        a = multi_walk.run(device="cpu", mesh=mesh, **SMALL)
    finally:
        dist.destroy_process_group()
    b = multi_walk.run(device="cpu", **SMALL)
    assert a["mesh_devices"] == 1
    for w in SMALL["walkers"]:
        for k in ("mean_final_mse", "std_final_mse", "hops_per_update"):
            assert a["walks"][w][k] == b["walks"][w][k], (w, k)
    assert a["excess_over_floor"] == b["excess_over_floor"]
