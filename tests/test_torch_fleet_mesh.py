"""Port: the walker-sharded fleet across ranks, over gloo on the CPU.

One spawn group a rank count P in {1, 2, 4} (``torch.multiprocessing``,
a ``file://`` rendezvous under the test's temporary directory, a join
limit of ``JOIN_S`` seconds that fails the test when it runs out).  Every
rank runs every case below, each with ``mesh=make_walker_mesh(
device_type="cpu")`` and again with ``mesh=None``, and rank 0 writes the
whole fleet's outputs, which the tests then read:

* the trainer on the reference's own blocks and per-edge CDF
  (``run_rw_sgd_multi(uniforms=, engine=, mesh=)``), held against the
  reference's *unsharded* ``run_rw_sgd_multi`` as
  ``tests/test_torch_trainer.py`` holds it (the reference's sharded
  test fails under jax 0.9.0);
* the trainer drawing from its generator, the faulted fleet
  (``run_fleet(faults=)``), a fleet of W = P + 1 walkers (replicated: no
  collective), a sharded checkpoint written, read back and resumed, the
  LLM fleet step on the reduced mamba2, and ``capture=True`` refused.

Walks (nodes, hops, the fault state) equal the unsharded run's bit for
bit.  The floats carry the all-reduce's order of summation, so they are
held at the reference's own tolerances for its sharded fleet
(``tests/test_fleet.py``: ``mse``/``avg_mse`` at rtol 1e-5, ``x_final``
at rtol 1e-4 / atol 1e-6); on one rank every field is bitwise.  The LLM
parameters are held at ``test_torch_llm_train``'s fleet bound (rtol 1e-4
/ atol 1e-3·lr, at most 1e-4 of the entries beyond).
"""
import dataclasses
import os
import time

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.core import engine as jeng
from repro.core import graphs as jg
from repro.core import transition as jtr
from repro.data import make_heterogeneous_regression as j_data
from repro.walk_sgd import run_rw_sgd_multi as j_run_multi
from repro_torch import interop
from repro_torch.core import graphs as tg
from repro_torch.core.engine import WalkEngine
from repro_torch.core.faults import FaultModel
from repro_torch.core.transition import MHLJParams, mh_importance_rows_ragged
from repro_torch.data import make_heterogeneous_regression as t_data
from repro_torch.launch import mesh as tmesh
from repro_torch.models import regression as treg
from repro_torch.walk_sgd import fleet as tfleet
from repro_torch.walk_sgd import run_rw_sgd_multi
from test_torch_trainer import _fleet_blocks

JOIN_S = 120.0
RANKS = (1, 2, 4)
PARAMS = (0.1, 0.5, 3)  # (p_j, p_d, r)
W, T, AVG = 8, 120, 5  # the fleets of the trainer cases
LLM = dict(walkers=4, steps=3, avg_every=2, lr=1e-3)
FIELDS = ("x_final", "mse", "avg_mse", "nodes", "hops")


def _data(m, n):
    return m(n, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
             x_star_scale=3.0)


def _reference_inputs():
    """The reference's ring(64) CDF and blocks, and its unsharded run."""
    p_j, p_d, r = PARAMS
    g = jg.ring(64, layout="ragged")
    d = _data(j_data, g.n)
    gamma = float(0.3 / d.lipschitz.mean())
    ref = j_run_multi("mhlj", g, d, gamma, T, W,
                      mhlj_params=jtr.MHLJParams(p_j, p_d, r), avg_every=AVG,
                      seed=0, engine_kwargs={"backend": "scan"})
    rows = jtr.mh_importance_rows_ragged(g, d.lipschitz)
    cdf = np.asarray(jeng.ragged_edge_cdf(g.indptr, g.indices, g.degrees,
                                          row_probs=rows))
    blocks = _fleet_blocks(0, T, W, r, np.full(T, p_j, np.float32))
    return ({"cdf": cdf, "blocks": blocks, "gamma": np.float64(gamma)},
            {"nodes": ref.update_nodes, "hops": ref.transitions,
             "mse": ref.mse, "avg_mse": ref.avg_mse, "x_final": ref.x_final})


# -- what every rank runs ------------------------------------------------------


def _gather(x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _fleet(engine, w, avg_every):
    return tfleet.WalkFleet.create(engine, w, seed=3, avg_every=avg_every)


def _fleet_run(data, fleet, steps, x0s=None, **kw):
    """``run_fleet`` of ``fleet`` for ``steps`` steps from ``x0s`` (zeros
    by default): importance-weighted linear regression at constant p_J."""
    weights = torch.as_tensor(
        (data.lipschitz.mean() / data.lipschitz).astype(np.float32))
    return tfleet.run_fleet(
        torch.zeros(fleet.num_walks, data.dim) if x0s is None else x0s,
        torch.as_tensor(np.asarray(data.features, np.float32)),
        torch.as_tensor(np.asarray(data.targets, np.float32)), weights,
        fleet, steps, float(0.3 / data.lipschitz.mean()),
        torch.full((steps,), PARAMS[0], dtype=torch.float32), True,
        treg.linear_grad, **kw)


def _outs(res) -> dict:
    return {k: v.numpy() for k, v in zip(FIELDS, res[:5])}


def _case_reference(mesh, inputs, workdir):
    p_j, p_d, r = PARAMS
    g = tg.ring(64, layout="ragged")
    engine, _, _ = interop.from_reference_state(
        indptr=g.indptr, indices=g.indices, degrees=g.degrees,
        edge_cdf=inputs["cdf"], max_degree=int(g.degrees.max()),
        cdf_width=int(g.degrees.max()), p_d=p_d, r=r, device="cpu")
    res = run_rw_sgd_multi(
        "mhlj", g, _data(t_data, g.n), float(inputs["gamma"]), T, W,
        mhlj_params=MHLJParams(*PARAMS), avg_every=AVG, seed=0,
        engine=engine, uniforms=torch.from_numpy(inputs["blocks"]),
        device="cpu", mesh=mesh)
    return {"nodes": res.update_nodes, "hops": res.transitions,
            "mse": res.mse, "avg_mse": res.avg_mse, "x_final": res.x_final}


def _ba_engine():
    g = tg.barabasi_albert(300, 3, seed=0, layout="ragged")
    data = _data(t_data, g.n)
    rows = mh_importance_rows_ragged(g, data.lipschitz)
    return WalkEngine.from_graph(g, MHLJParams(*PARAMS), row_probs=rows,
                                 device="cpu"), data


def _case_generator(mesh, inputs, workdir):
    engine, data = _ba_engine()
    out = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        gen = torch.Generator().manual_seed(11)
        res = _fleet_run(data, _fleet(engine, W, AVG), T, generator=gen,
                         mesh=m)
        out.update({f"{tag}/{k}": v for k, v in _outs(res).items()})
        out[f"{tag}/final_nodes"] = res[5]["nodes"].numpy()
        out[f"{tag}/gen"] = gen.get_state().numpy()
    return out


def _case_faults(mesh, inputs, workdir):
    engine, data = _ba_engine()
    fm = FaultModel(crash_rate=0.05, recovery_rate=0.2, patience=2,
                    rescue=True)
    out = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        res = _fleet_run(data, _fleet(engine, W, AVG), T, faults=fm, mesh=m,
                         generator=torch.Generator().manual_seed(12))
        fin = res[5]
        out.update({f"{tag}/{k}": v for k, v in _outs(res).items()})
        out.update({f"{tag}/live": fin["fault_state"].live.numpy(),
                    f"{tag}/blocked_state": fin["fault_state"].blocked.numpy(),
                    f"{tag}/t": fin["fault_state"].t.numpy(),
                    f"{tag}/rescued": fin["rescued"].numpy(),
                    f"{tag}/blocked": fin["blocked"].numpy()})
    return out


def _case_odd(mesh, inputs, workdir):
    engine, data = _ba_engine()
    w = dist.get_world_size() + 1
    out = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        fleet = _fleet(engine, w, 4)
        if m is not None:
            out["sharded"] = np.array(tfleet.shard_fleet(fleet, m).mesh
                                      is not None)
        res = _fleet_run(data, fleet, 50, mesh=m,
                         generator=torch.Generator().manual_seed(13))
        out.update({f"{tag}/{k}": v for k, v in _outs(res).items()})
    return out


def _case_resume(mesh, inputs, workdir):
    engine, data = _ba_engine()
    half = T // 2
    fleet = _fleet(engine, W, AVG)

    def window(fl, xs, start, steps, gen):
        return _fleet_run(data, fl, steps, xs, generator=gen, mesh=mesh,
                          start_step=start, total_steps=T)

    whole = window(fleet, None, 0, T, torch.Generator().manual_seed(14))
    gen = torch.Generator().manual_seed(14)
    first = window(fleet, None, 0, half, gen)
    placed = tfleet.shard_fleet(
        dataclasses.replace(fleet, nodes=first[5]["nodes"]), mesh)
    path = os.path.join(workdir, f"fleet{dist.get_rank()}.npz")
    tfleet.save_fleet_checkpoint(path, placed, step=half, extras={
        "x": first[0], "gen": gen.get_state()})
    back, step, extras = tfleet.load_fleet_checkpoint(path, device="cpu")
    gen2 = torch.Generator()
    gen2.set_state(torch.from_numpy(extras["gen"]))
    second = window(back, torch.from_numpy(extras["x"]), step, T - half, gen2)
    out = {f"whole/{k}": v for k, v in _outs(whole).items()}
    out.update({"placed_nodes": placed.nodes.numpy(), "step": np.array(step),
                "ckpt_nodes": back.nodes.numpy(),
                "ckpt_sharding": np.array(str(
                    back.engine.walker_sharding))})
    for k, a, b in zip(FIELDS, first[:5], second[:5]):
        if k in ("mse", "avg_mse"):  # both hold the model at the seam
            b = b[..., 1:]
        out[f"resumed/{k}"] = (b if k == "x_final"
                               else torch.cat([a, b], dim=-1)).numpy()
    return out


def _case_llm(mesh, inputs, workdir):
    from repro_torch import optim as topt
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.base import param_tree, stack_leaf
    from repro_torch.models.factory import build_model
    from repro_torch.walk_sgd import llm_trainer as tllm

    cfg = reduced(get_arch("mamba2-370m"))
    model = build_model(cfg, torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tree = param_tree(model)
    w, n = LLM["walkers"], 8
    walk = tllm.WalkContext.from_graph(tg.ring(n), MHLJParams(0.3, 0.5, 3),
                                       online_lipschitz=True, device="cpu")
    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (w, 2, 32))
                                    .astype(np.int32))
                for k in ("tokens", "labels")} for _ in range(LLM["steps"])]
    out = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        opt = topt.adamw(LLM["lr"])
        pw = tfleet.stack_params(tree, w)
        ow = tfleet.stack_params(opt.init(tree), w)
        ws = tfleet.init_fleet_walk_state(n, w, seed=2, online=True,
                                          device="cpu", mesh=m)
        if m is not None:
            pw, ow = (tfleet.shard_walker_batch(x, w, m) for x in (pw, ow))
        step = tfleet.make_fleet_step(model, opt, walk, LLM["avg_every"],
                                      mesh=m)
        nodes = []
        for t, batch in enumerate(batches):
            pw, ow, ws, _ = step(pw, ow, ws, batch, t)
            nodes.append(ws["node"] if m is None else _gather(ws["node"]))
        out[f"{tag}/nodes"] = torch.stack(nodes).numpy()
        for path, leaf in pw.items():
            x = stack_leaf(leaf)  # (L, W, ...) or (W, ...)
            if isinstance(leaf, tuple):
                x = x.movedim(1, 0)
            out[f"{tag}/params/{path}"] = (x if m is None else _gather(x)).numpy()
    return out


def _case_capture(mesh, inputs, workdir):
    engine, data = _ba_engine()
    try:
        _fleet_run(data, _fleet(engine, W, AVG), 10, capture=True, mesh=mesh,
                   generator=torch.Generator().manual_seed(1))
    except ValueError as err:
        return {"error": np.array(str(err))}
    return {"error": np.array("")}


CASES = {"reference": _case_reference, "generator": _case_generator,
         "faults": _case_faults, "odd": _case_odd, "resume": _case_resume,
         "llm": _case_llm, "capture": _case_capture}


def _rank_main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=world, rank=rank)
    try:
        mesh = tmesh.make_walker_mesh(device_type="cpu")
        with np.load(os.path.join(workdir, "inputs.npz")) as z:
            inputs = dict(z)
        out = {}
        for name, case in CASES.items():
            out.update({f"{name}/{k}": v
                        for k, v in case(mesh, inputs, workdir).items()})
        if rank == 0:
            np.savez(os.path.join(workdir, "outputs.npz"), **out)
    finally:
        dist.destroy_process_group()


# -- the spawn groups ----------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    return _reference_inputs()


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """``ranks(P)``: the outputs of the P-rank group, spawned once."""
    runs: dict = {}

    def run(world):
        if world not in runs:
            workdir = tmp_path_factory.mktemp(f"ranks{world}")
            np.savez(workdir / "inputs.npz", **reference[0])
            ctx = tmp.start_processes(_rank_main, args=(world, str(workdir)),
                                      nprocs=world, join=False,
                                      start_method="spawn")
            deadline = time.monotonic() + JOIN_S
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    for p in ctx.processes:
                        p.kill()
                    for p in ctx.processes:
                        p.join(10)
                    pytest.fail(f"{world} ranks did not finish in {JOIN_S} s")
            with np.load(workdir / "outputs.npz") as z:
                runs[world] = dict(z)
        return runs[world]

    return run


def _pick(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _hold(got: dict, want: dict, bitwise: bool, what: str) -> None:
    for k in ("nodes", "hops"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    for k in ("mse", "avg_mse", "x_final"):
        if bitwise:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
        elif k == "x_final":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{what} {k}")


# -- the cases -------------------------------------------------------------------


@pytest.mark.parametrize("world", RANKS)
def test_generator_fleet_equals_unsharded(ranks, world):
    """Drawing from a generator: walks bit for bit, floats at the
    all-reduce tolerance (every field bitwise on one rank), the final
    positions and the generator's state equal."""
    out = _pick(ranks(world), "generator/")
    got, want = _pick(out, "mesh/"), _pick(out, "none/")
    _hold(got, want, world == 1, f"P={world}")
    np.testing.assert_array_equal(got["final_nodes"], want["final_nodes"])
    np.testing.assert_array_equal(got["gen"], want["gen"])
    assert want["avg_mse"][-1] < want["avg_mse"][0]


@pytest.mark.parametrize("world", RANKS)
def test_reference_blocks_match_the_unsharded_reference(ranks, reference, world):
    """On the reference's blocks and CDF the sharded trainer walks as the
    reference's unsharded ``run_rw_sgd_multi`` does, bit for bit, with
    its floats at ``test_torch_trainer``'s port-against-reference rtol."""
    got, ref = _pick(ranks(world), "reference/"), reference[1]
    np.testing.assert_array_equal(got["nodes"], ref["nodes"])
    np.testing.assert_array_equal(got["hops"], ref["hops"])
    np.testing.assert_allclose(got["mse"], ref["mse"], rtol=1e-4)
    np.testing.assert_allclose(got["avg_mse"], ref["avg_mse"], rtol=1e-4)
    np.testing.assert_allclose(got["x_final"], ref["x_final"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("world", RANKS)
def test_faulted_fleet_equals_unsharded(ranks, world):
    """Markov faults with the rescue: the walks, the fault state (the
    replicated liveness, the gathered blocked counters) and the per-step
    rescue and block totals equal the unsharded run's."""
    out = _pick(ranks(world), "faults/")
    got, want = _pick(out, "mesh/"), _pick(out, "none/")
    _hold(got, want, world == 1, f"P={world} faulted")
    for k in ("live", "blocked_state", "t", "rescued", "blocked"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["rescued"].sum() > 0 and want["blocked"].sum() > 0


@pytest.mark.parametrize("world", RANKS)
def test_fleet_that_does_not_divide_is_replicated(ranks, world):
    """W = P + 1 walkers: on P > 1 ranks the fleet stays whole on every
    rank and runs no collective, so every field equals the unsharded
    run's bit for bit."""
    out = _pick(ranks(world), "odd/")
    assert bool(out["sharded"]) == (world == 1)
    _hold(_pick(out, "mesh/"), _pick(out, "none/"), True, f"P={world} odd")


@pytest.mark.parametrize("world", RANKS)
def test_sharded_checkpoint_resumes_bit_for_bit(ranks, world):
    """Half the run, the sharded fleet written (its nodes gathered, no
    placement recorded), read back unsharded and resumed under the mesh:
    every field equals the uninterrupted sharded run's."""
    out = _pick(ranks(world), "resume/")
    assert int(out["step"]) == T // 2
    assert str(out["ckpt_sharding"]) == "None"
    assert out["ckpt_nodes"].shape == (W,)
    assert out["placed_nodes"].shape == (W // world,)
    _hold(_pick(out, "resumed/"), _pick(out, "whole/"), True,
          f"P={world} resumed")


@pytest.mark.parametrize("world", RANKS)
def test_llm_fleet_step_sharded_equals_unsharded(ranks, world):
    """The reduced mamba2's fleet step, W=4, averaging every 2 steps:
    each rank's walkers draw from their own generators, so the walks are
    equal; the parameters equal the unsharded step's (bitwise on one
    rank, else at the CPU fleet test's bound)."""
    out = _pick(ranks(world), "llm/")
    np.testing.assert_array_equal(out["mesh/nodes"], out["none/nodes"])
    got, want = _pick(out, "mesh/params/"), _pick(out, "none/params/")
    assert set(got) == set(want)
    beyond = total = 0
    for k, x in want.items():
        if world == 1:
            np.testing.assert_array_equal(got[k], x, err_msg=k)
        diff = np.abs(got[k] - x)
        beyond += int((diff > 1e-3 * LLM["lr"] + 1e-4 * np.abs(x)).sum())
        total += x.size
        assert float(diff.max()) <= 2 * LLM["lr"] * LLM["steps"], k
        # after the last step's average (step 1) walkers differ again
    assert beyond <= 1e-4 * total, (beyond, total)


@pytest.mark.parametrize("world", RANKS)
def test_capture_is_refused_under_gloo(ranks, world):
    """gloo's collectives cannot be captured in CUDA graphs: ``capture=
    True`` raises, with the reason."""
    err = str(_pick(ranks(world), "capture/")["error"])
    assert "gloo" in err and "NCCL" in err, err


# -- without a process group ------------------------------------------------------


def test_walker_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is initialised in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_walker_mesh(device_type="cpu")


def test_production_and_smoke_meshes_are_abstract():
    single = tmesh.make_production_mesh()
    assert (single.shape, single.axis_names) == ((16, 16), ("data", "model"))
    assert tmesh.make_production_mesh(model_parallel=8).shape == (32, 8)
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (multi.shape, multi.axis_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    smoke = tmesh.make_smoke_mesh()
    assert tmesh.mesh_sizes(smoke) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_production_mesh(model_parallel=7)
