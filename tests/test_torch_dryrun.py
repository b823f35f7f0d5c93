"""Port parity: the dry run (``repro_torch.launch.dryrun``) against the JAX
package's plan.

* The per-device argument bytes of every architecture x input shape on
  the 16x16, 32x8 and 2x16x16 meshes equal the reference's own spec trees
  applied to ``jax.eval_shape`` of its init, optimizer state, decode cache
  and batch, exactly (ceil division per sharded dim).  No trace: the
  port's arguments are built on the ``meta`` device, and the reference's
  rules read a ``SimpleNamespace`` mesh (``tests/test_torch_sharding.py``).
* A reduced model of each family traces as train, prefill and decode on a
  fake (2, 2) mesh (``tests/test_torch_dryrun_families.py``).
* On the smoke mesh (1, 1) a plan has no collective, and its FLOPs equal
  the unsharded count of the same step (``op_cost`` without a mesh).
* ``unroll=True`` changes nothing, and no process group outlives a case.
"""
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import ARCHITECTURES, INPUT_SHAPES
from repro.configs import arch_for_shape as jarch_for_shape
from repro.configs import get_arch as jget_arch
from repro.models.factory import build_model as jbuild
from repro.sharding import rules as jrules
from repro_torch.configs import ShapeConfig, arch_for_shape, get_arch, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (
    AbstractMesh, make_production_mesh, make_smoke_mesh,
)
from repro_torch.models.factory import build_model
from repro_torch.utils.op_cost import count_ops

MESHES = {
    "16x16": dict(multi_pod=False, model_parallel=16),
    "32x8": dict(multi_pod=False, model_parallel=8),
    "2x16x16": dict(multi_pod=True, model_parallel=16),
}


def _ref_bytes(shapes, specs, sizes: dict) -> int:
    """Per-device bytes of a reference tree under its PartitionSpec tree."""
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        dims = list(leaf.shape)
        for i, entry in enumerate(tuple(spec)):
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(sizes[a] for a in axes if a is not None)
            dims[i] = -(-dims[i] // n)
        total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


def _ref_case(arch, shape, mesh):
    """The reference's per-device argument bytes by kind (params, the
    optimizer state, cache, batch) of one case."""
    cfg = jarch_for_shape(jget_arch(arch), shape)
    model = jbuild(cfg)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if shape.kind == "train":
        profile = "fsdp_tp"
        opt = (jopt.adafactor(1e-3) if cfg.optimizer == "adafactor"
               else jopt.adamw(3e-4))
        opt_shapes = jax.eval_shape(opt.init, params)
        p_spec = jrules.param_specs(params, profile, mesh)
        batch = model.input_specs(shape)
        return {
            "params": _ref_bytes(params, p_spec, sizes),
            "opt_state": _ref_bytes(opt_shapes, jrules.opt_state_specs(
                opt_shapes, p_spec, params, profile, mesh), sizes),
            "batch": _ref_bytes(batch, jrules.batch_specs(batch, profile, mesh),
                                sizes),
        }
    # the reference's _decode_profile
    profile = "fsdp_decode" if cfg.param_count() * 2 > 120e9 else "tp_decode"
    p_spec = jrules.param_specs(params, profile, mesh)
    out = {"params": _ref_bytes(params, p_spec, sizes)}
    if shape.kind == "prefill":
        batch = model.input_specs(shape)
        out["batch"] = _ref_bytes(batch, jrules.batch_specs(batch, profile, mesh),
                                  sizes)
        return out
    cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                    shape.seq_len))
    tok = model.input_specs(shape, for_decode=True)["tokens"]
    out["cache"] = _ref_bytes(cache, jrules.cache_specs(cache, profile, mesh),
                              sizes)
    out["tokens"] = _ref_bytes(tok, jrules.batch_specs({"t": tok}, profile,
                                                        mesh)["t"], sizes)
    out["pos"] = 4  # the int32 position scalar
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_argument_bytes_match_reference_spec_trees(arch, mesh_name):
    abstract = make_production_mesh(**MESHES[mesh_name])
    ref_mesh = SimpleNamespace(axis_names=abstract.axis_names,
                               devices=np.empty(abstract.shape))
    for jshape in INPUT_SHAPES:
        shape = ShapeConfig(jshape.name, jshape.seq_len, jshape.global_batch,
                            jshape.kind)
        cfg = arch_for_shape(get_arch(arch), shape)
        model = build_model(cfg, torch.bfloat16, device="meta")
        case = dryrun.case_arguments(model, cfg, shape, abstract)
        port = {k: dryrun.argument_bytes(case["args"][k], case["specs"][k],
                                         abstract) for k in case["args"]}
        port.pop("walk", None)  # a torch.Generator where the reference keeps a key
        assert port == _ref_case(arch, jshape, ref_mesh), (arch, jshape.name)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["minitron-8b", "mamba2-370m"])
def test_smoke_mesh_plan_equals_the_unsharded_count(arch, kind):
    """The (1, 1) plan issues no collective and counts the FLOPs of the
    same step run without a mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = reduced(get_arch(arch))
    shape = ShapeConfig(f"small_{kind}", 64, 4, kind)
    _, _, info = dryrun.lower_case(cfg, shape, False, mesh=make_smoke_mesh())
    assert info["collectives"]["num_ops"] == 0
    with FakeTensorMode():
        model = build_model(cfg, torch.bfloat16, device="cpu")
        case = dryrun.case_arguments(model, cfg, shape, make_smoke_mesh())
        with count_ops() as c:
            if kind == "prefill":
                dryrun.make_prefill_step(model)(case["args"]["batch"])
            else:
                from repro_torch.walk_sgd.llm_trainer import make_serve_step

                make_serve_step(model)(case["args"]["cache"],
                                       case["args"]["tokens"],
                                       shape.seq_len // 2)
    assert info["flops"] == c.cost.flops


def test_unroll_changes_nothing_and_leaves_no_group():
    cfg = reduced(get_arch("mamba2-370m"))
    shape = ShapeConfig("small_prefill", 64, 4, "prefill")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    _, a, info_a = dryrun.lower_case(cfg, shape, False, mesh=mesh)
    assert not torch.distributed.is_initialized()
    _, b, info_b = dryrun.lower_case(cfg, shape, False, unroll=True, mesh=mesh)
    assert not torch.distributed.is_initialized()
    assert info_b["unrolled"] and not info_a["unrolled"]
    assert (a.flops, a.bytes, a.coll_bytes) == (b.flops, b.bytes, b.coll_bytes)
    assert info_a["memory"] == info_b["memory"]


def test_fake_mesh_refuses_an_initialised_group(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="already|initialised"):
            with fake_device_mesh(make_smoke_mesh()):
                pass
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_main_prints_the_reference_lines(capsys, monkeypatch):
    """The CLI's [OK] lines and exit code, on a reduced config."""
    small = reduced(get_arch("mamba2-370m"))
    monkeypatch.setattr(dryrun, "get_arch", lambda name: small)
    monkeypatch.setattr(dryrun, "get_shape", lambda name: ShapeConfig(
        name, 64, 4, "prefill"))
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "p"]) == 0
    out = capsys.readouterr().out
    assert "[OK]   mamba2-370m x p x 16x16" in out
    assert "1/1 cases lowered+compiled successfully" in out
