"""Port parity: the paper's figures, ``repro_torch.paper``, against the
reference's ``benchmarks/`` modules on the same uniform blocks.

``blocks=`` feeds each training call the reference's own draws
(``split(PRNGKey(seed), T)``, one ``(W, 3 + r)`` uniform per key, slot 0
-> ``u < p_j[t]``), so the walks agree bit for bit: occupancies, hops,
mixing times and gaps are held with ``==``.  The MSE traces agree to the
trainer's ``rtol=1e-4`` (float32 reductions in another order), and so do
the milestones and their ratios.  Every graph here keeps its padded rows
at most 17 wide, where the reference's cumsum equals the port's
sequential row CDF, so no pick can differ.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig5_sparse_graphs as ref_fig5
from benchmarks import theorem1_remark1 as ref_thm1
from repro.core import engine as jeng
from repro_torch.paper import fig5_sparse_graphs, theorem1_remark1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def fleet_blocks(seed, total, w, r, p_j_sched):
    """Blocks as the reference trainer draws them (see
    ``tests/test_torch_trainer.py::_fleet_blocks``)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), total)

    def one(k, pj):
        u = jax.random.uniform(k, (w, jeng.num_uniforms(r)), jnp.float32)
        return u.at[:, 0].set((u[:, 0] < pj).astype(jnp.float32))

    return np.array(jax.vmap(one)(keys, jnp.asarray(p_j_sched, jnp.float32)))


class ReferenceBlocks:
    """The ``blocks=`` callable: the reference's draws, and a log of calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, *, tag, method, seed, num_steps, num_walks, r, p_j):
        assert p_j.shape == (num_steps,) and p_j.dtype == np.float32
        self.calls.append((tag, method, seed, num_steps, num_walks, r))
        return torch.from_numpy(fleet_blocks(seed, num_steps, num_walks, r, p_j))


def assert_same(ref, port, mse_keys, path=""):
    """Nested equality; floats whose key is in ``mse_keys`` (or starts with
    ``mse@``) at ``MSE_RTOL``, everything else exactly."""
    if isinstance(ref, dict):
        assert set(ref) == set(port), path
        for k in ref:
            assert_same(ref[k], port[k], mse_keys, f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(port), path
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, mse_keys, f"{path}/{i}")
    else:
        key = path.rsplit("/", 1)[-1]
        if key.startswith("mse@") or key in mse_keys:
            np.testing.assert_allclose(port, ref, rtol=MSE_RTOL, err_msg=path)
        else:
            assert port == ref, (path, ref, port)


def test_fig5_smoke_matches_reference():
    blocks = ReferenceBlocks()
    port = fig5_sparse_graphs.run_smoke(device="cpu", blocks=blocks)
    ref = ref_fig5.run_smoke()
    for graph in fig5_sparse_graphs._graphs("smoke").values():
        assert int(graph.degrees.max()) <= 17
    assert_same(ref, port, mse_keys=())
    assert [c[:2] for c in blocks.calls] == [
        (g, m) for g in ("grid2d", "sbm")
        for m in ("uniform", "importance", "mhlj")]
    assert {c[2:] for c in blocks.calls} == {(4, 800, 1, 1), (4, 800, 1, 3)}


def test_theorem1_remark1_quick_matches_reference():
    blocks = ReferenceBlocks()
    port = theorem1_remark1.run(quick=True, device="cpu", blocks=blocks)
    ref = ref_thm1.run(quick=True)
    assert_same(ref, port, mse_keys=())
    assert blocks.calls == [("remark1", "mhlj", 0, 5_000, 1, 3)]
    d = port["derived"]
    assert d["ring_tau_ratio"] > 1 and d["ws_tau_ratio"] > 1
    assert d["remark1_within"]


def test_figures_draw_from_the_generator_without_blocks():
    """``blocks=None`` (or a callable returning None) leaves each call to
    the trainer's generator, seeded with the call's seed: two runs agree."""
    a = fig5_sparse_graphs.run_smoke(device="cpu")
    b = fig5_sparse_graphs.run_smoke(
        device="cpu", blocks=lambda **kw: None)
    assert a == b
    assert set(a["derived"]) == {"grid2d_is_occ", "sbm_is_occ",
                                 "grid2d_mhlj_occ", "sbm_mhlj_occ"}


def test_paper_imports_with_jax_repro_and_benchmarks_blocked():
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.paper as paper\n"
        "for name in ('repro_torch.core.walk', 'repro_torch.core.mixing',\n"
        "             'repro_torch.core.entrapment', 'repro_torch.core.theory',\n"
        "             'repro_torch.walk_sgd.comm_model',\n"
        "             'repro_torch.paper.common'):\n"
        "    importlib.import_module(name)\n"
        "assert [f.NAME for f in paper.FIGURES] == ['fig3_ring',\n"
        "    'fig4_erdos_renyi', 'fig5_sparse_graphs', 'fig6_annealing',\n"
        "    'theorem1_remark1']\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert not [k for k in loaded if k.split('.')[0] in\n"
        "            ('jax', 'jaxlib', 'repro', 'benchmarks')], loaded\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_paper_modules_keep_the_reference_contract():
    """NAME, PAPER_CLAIM and the fig5 graph tiers are the reference's."""
    import importlib

    for name in ("fig3_ring", "fig4_erdos_renyi", "fig5_sparse_graphs",
                 "fig6_annealing", "theorem1_remark1"):
        ref = importlib.import_module(f"benchmarks.{name}")
        port = importlib.import_module(f"repro_torch.paper.{name}")
        assert (port.NAME, port.PAPER_CLAIM) == (ref.NAME, ref.PAPER_CLAIM)

    for scale in ("smoke", "quick"):
        ref_g = ref_fig5._graphs(scale)
        port_g = fig5_sparse_graphs._graphs(scale)
        assert list(ref_g) == list(port_g)
        for tag in ref_g:
            np.testing.assert_array_equal(ref_g[tag].neighbors,
                                          port_g[tag].neighbors)
