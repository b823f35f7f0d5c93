"""Multi-pod dry run: plan every (architecture x input shape) on the
production meshes without a card, and record its cost, memory and
collectives for the roofline (the JAX package's ``launch/dryrun.py``).

A case builds the model under ``FakeTensorMode`` (shapes and dtypes, no
values), places its parameters, optimizer state, batch and cache as
DTensors by ``repro_torch.sharding.rules`` on a fake process group of the
mesh's size (``repro_torch.launch.mesh.fake_device_mesh``), and runs the
step once:

* train: the ``fsdp_tp`` profile, AdamW or Adafactor, and the walk
  context on ``ring(64)`` (``walk_sgd.llm_trainer.make_train_step``);
* prefill: the last position's logits;
* decode: ``make_serve_step`` over ``init_cache``.

The step runs under ``repro_torch.utils.op_cost.count_ops`` (FLOPs and
bytes per device, the kernels' calls priced by their formulas) and
``CommDebugMode`` (the collectives DTensor's redistributions issue,
:mod:`repro_torch.utils.collectives`).  The info dict keeps the
reference's keys: ``memory`` holds ``argument_size_in_bytes`` (exact:
every argument's local shard, ceil division per sharded dim),
``output_size_in_bytes`` and ``temp_size_in_bytes`` (the peak of the
storages the step allocates on one device, outputs included while they
live); ``compile_seconds`` holds the trace's seconds (nothing is
compiled).  ``unroll`` is accepted and recorded; eager Python runs every
layer, so it changes no count.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
          --shape all --mesh both [--out plan.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import (
    ARCHITECTURES,
    INPUT_SHAPES,
    ShapeConfig,
    arch_for_shape,
    get_arch,
    get_shape,
)
from repro_torch.core.graphs import ring
from repro_torch.core.transition import MHLJParams
from repro_torch.launch.mesh import (
    fake_device_mesh, make_production_mesh, mesh_sizes,
)
from repro_torch.models.base import named_of, param_tree, stack_paths
from repro_torch.models.factory import build_model
from repro_torch.sharding import rules as sh
from repro_torch.sharding.constraints import sharded_einsums
from repro_torch.utils.collectives import CollectiveTrace, collective_summary
from repro_torch.utils.op_cost import count_ops
from repro_torch.walk_sgd.llm_trainer import (
    WalkContext,
    init_walk_state,
    make_serve_step,
    make_train_step,
)

__all__ = ["make_optimizer", "make_prefill_step", "case_arguments",
           "lower_case", "argument_bytes", "main"]

N_SILOS = 64  # graph nodes (data silos) for the walk-orchestrated train step


def make_optimizer(cfg):
    if cfg.optimizer == "adafactor":
        return optim.adafactor(1e-3)
    return optim.adamw(3e-4)


def _decode_profile(cfg) -> str:
    # pure-TP decode needs params to fit one model-parallel group: use the
    # 2-D profile for very large archs
    return "fsdp_decode" if cfg.param_count() * 2 > 120e9 else "tp_decode"


def make_prefill_step(model):
    """``(batch) -> logits (B, V)`` float32 of the last position, on the
    model's own weights."""

    def prefill_step(batch):
        hidden = model.apply(batch)
        table = model.embedding["table"]
        return torch.einsum("bd,vd->bv", hidden[:, -1], table).float()

    return prefill_step


# ---------------------------------------------------------------------------
# Placement: spec trees -> DTensors on the mesh
# ---------------------------------------------------------------------------


def _local_shape(shape: tuple, spec: tuple, sizes: dict) -> tuple:
    """One device's shard of ``shape`` under ``spec``: each sharded dim
    divided by its axes' sizes, rounded up (the first shard's size)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes if a is not None)
        out[dim] = -(-out[dim] // n)
    return tuple(out)


def _leaf_pieces(leaf, spec: tuple):
    """``(tensor or (shape, dtype), spec of that tensor)`` for each tensor
    of a leaf: a tuple of layer tensors drops the spec's leading entry per
    level."""
    if isinstance(leaf, tuple) and not (len(leaf) == 2
                                        and isinstance(leaf[0], tuple)):
        for piece in leaf:
            yield from _leaf_pieces(piece, tuple(spec[1:]))
        return
    yield leaf, spec


def argument_bytes(tree, spec_tree, mesh) -> int:
    """Bytes of one device's shards of every tensor of ``tree`` under
    ``spec_tree`` (trees of dicts, lists and NamedTuples whose leaves are
    tensors, tuples of layer tensors or ``(shape, dtype)`` pairs), ceil
    division per sharded dim."""
    sizes = mesh_sizes(mesh)
    total = 0
    for (_, leaf), (_, spec) in zip(sh._leaves_with_path(tree),
                                    sh._leaves_with_path(spec_tree)):
        for piece, piece_spec in _leaf_pieces(leaf, spec):
            if isinstance(piece, torch.Tensor):
                shape, dtype = tuple(piece.shape), piece.dtype
            else:
                shape, dtype = tuple(piece[0]), piece[1]
            local = _local_shape(shape, piece_spec, sizes)
            total += math.prod(local) * dtype.itemsize
    return total


def _placed(tree, spec_tree, mesh, requires_grad: bool = False):
    """``tree`` with every (fake) tensor a DTensor placed by its spec: this
    device's shard made at its size (the first shard's, ceil division)."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_sizes(mesh)

    def place(leaf, spec):
        if isinstance(leaf, tuple):
            return tuple(place(piece, tuple(spec[1:])) for piece in leaf)
        local = torch.empty(_local_shape(tuple(leaf.shape), spec, sizes),
                            dtype=leaf.dtype)
        dt = DTensor.from_local(local, mesh, sh._placements(tuple(spec), mesh),
                                run_check=False, shape=leaf.shape,
                                stride=leaf.stride())
        return dt.requires_grad_(requires_grad) if requires_grad else dt

    flat_specs = iter([s for _, s in sh._leaves_with_path(spec_tree)])
    return sh._map_with_path(lambda path, leaf: place(leaf, next(flat_specs)),
                             tree)


def _set_params(model, placed: dict) -> None:
    """Make the model's parameters the DTensors of the placed tree."""
    for name, t in named_of(placed, stack_paths(model)).items():
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        module._parameters[attr] = torch.nn.Parameter(
            t, requires_grad=t.requires_grad)


def _zeros(specs: dict, device) -> dict:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in specs.items()}


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            if id(local) not in seen:
                seen.add(id(local))
                total += local.numel() * local.element_size()
    return total


# ---------------------------------------------------------------------------
# One case
# ---------------------------------------------------------------------------


def _resolve(arch, shape, extra):
    shape = get_shape(shape) if isinstance(shape, str) else shape
    base = get_arch(arch) if isinstance(arch, str) else arch
    cfg = arch_for_shape(base, shape)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    return cfg, shape


def case_arguments(model, cfg, shape: ShapeConfig, mesh) -> dict:
    """One case's profile and its step's arguments, unplaced, with their
    spec trees under ``mesh`` (an ``AbstractMesh`` or a ``DeviceMesh``):
    ``{"profile", "args": {kind: tree}, "specs": {kind: spec tree}}``, the
    kinds ``params``, ``opt_state``, ``walk`` and ``batch`` (train),
    ``params`` and ``batch`` (prefill), ``params``, ``cache``, ``tokens``
    and ``pos`` (decode).  The trees are the model's device's: ``meta``
    gives every argument of a full-size case without memory."""
    device = model.device
    params = param_tree(model)
    if shape.kind == "train":
        profile = "fsdp_tp"
        opt_state = make_optimizer(cfg).init(params)
        walk_state = init_walk_state(N_SILOS, np.ones(N_SILOS, np.float32),
                                     device="cpu")
        walk = {k: v for k, v in walk_state.items()
                if isinstance(v, torch.Tensor)}
        batch = _zeros(model.input_specs(shape), device)
        p_spec = sh.param_specs(params, profile, mesh)
        args = {"params": params, "opt_state": opt_state, "walk": walk,
                "batch": batch}
        specs = {"params": p_spec,
                 "opt_state": sh.opt_state_specs(opt_state, p_spec, params,
                                                 profile, mesh),
                 "walk": {k: () for k in walk},
                 "batch": sh.batch_specs(batch, profile, mesh)}
        return {"profile": profile, "args": args, "specs": specs,
                "walk_state": walk_state}
    profile = _decode_profile(cfg)
    p_spec = sh.param_specs(params, profile, mesh)
    if shape.kind == "prefill":
        batch = _zeros(model.input_specs(shape), device)
        return {"profile": profile,
                "args": {"params": params, "batch": batch},
                "specs": {"params": p_spec,
                          "batch": sh.batch_specs(batch, profile, mesh)}}
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    (tok_shape, tok_dtype), = model.input_specs(shape, for_decode=True).values()
    tokens = torch.zeros(tok_shape, dtype=tok_dtype, device=device)
    return {"profile": profile,
            "args": {"params": params, "cache": cache, "tokens": tokens,
                     "pos": torch.zeros((), dtype=torch.int32, device=device)},
            "specs": {"params": p_spec,
                      "cache": sh.cache_specs(cache, profile, mesh),
                      "tokens": sh.batch_specs({"t": tokens}, profile, mesh)["t"],
                      "pos": ()}}


def _case_step(model, cfg, shape: ShapeConfig, mesh, case: dict):
    """The step of one case as a thunk, its arguments placed on ``mesh``."""
    args, specs = case["args"], case["specs"]
    if shape.kind == "train":
        optimizer = make_optimizer(cfg)
        walk = WalkContext.from_graph(ring(N_SILOS), MHLJParams(0.1, 0.5, 3),
                                      device="cpu")
        uniforms = torch.zeros((1, 3 + walk.r))
        params = _placed(args["params"], specs["params"], mesh,
                         requires_grad=True)
        opt_state = _placed(args["opt_state"], specs["opt_state"], mesh)
        batch = _placed(args["batch"], specs["batch"], mesh)
        step = make_train_step(model, optimizer, walk)
        return lambda: step(params, opt_state, case["walk_state"], batch,
                            uniforms=uniforms)
    _set_params(model, _placed(args["params"], specs["params"], mesh))
    if shape.kind == "prefill":
        batch = _placed(args["batch"], specs["batch"], mesh)
        step = make_prefill_step(model)
        return lambda: step(batch)
    cache = _placed(args["cache"], specs["cache"], mesh)
    tokens = _placed({"t": args["tokens"]}, {"t": specs["tokens"]}, mesh)["t"]
    serve = make_serve_step(model)
    at = shape.seq_len // 2  # any position: the cost does not depend on it
    return lambda: serve(cache, tokens, at)


def lower_case(
    arch_name,
    shape_name,
    multi_pod: bool,
    extra: dict | None = None,
    unroll: bool = False,
    model_parallel: int = 16,
    *,
    mesh=None,
):
    """Returns ``(abstract mesh, OpCost, info)`` for one (arch, shape,
    mesh) case.

    ``arch_name`` and ``shape_name`` may also be an ``ArchConfig`` and a
    ``ShapeConfig`` (a reduced model, a shape of one's own); ``mesh`` an
    ``AbstractMesh`` in place of the production mesh (the smoke mesh).
    """
    cfg, shape = _resolve(arch_name, shape_name, extra)
    abstract = mesh or make_production_mesh(multi_pod=multi_pod,
                                            model_parallel=model_parallel)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with contextlib.ExitStack() as stack:
        device_mesh = stack.enter_context(fake_device_mesh(abstract))
        stack.enter_context(FakeTensorMode())
        model = build_model(cfg, torch.bfloat16, device="cpu")
        case = case_arguments(model, cfg, shape, abstract)
        run = _case_step(model, cfg, shape, device_mesh, case)
        t0 = time.time()
        with CollectiveTrace() as comm, count_ops(track_memory=True) as counter, \
                implicit_replication(), sharded_einsums():
            out = run()
        trace_s = time.time() - t0
        output_bytes = _nbytes(out if shape.kind != "train" else out[3])
        coll = collective_summary(comm)
    cost = counter.cost
    by_kind = {k: argument_bytes(case["args"][k], case["specs"][k], abstract)
               for k in case["args"]}
    mem_info = {
        "argument_size_in_bytes": sum(by_kind.values()),
        "output_size_in_bytes": output_bytes,
        "temp_size_in_bytes": counter.peak_bytes,
        "argument_bytes_by_kind": by_kind,
    }
    cost.coll_bytes = float(coll["total_bytes"])
    cost.coll_ring_bytes = float(coll["total_ring_cost_bytes"])
    cost.coll_counts = {k: v["count"] for k, v in coll["by_kind"].items()}
    info = {
        "arch": cfg.name,
        "shape": shape.name,
        "multi_pod": multi_pod,
        "unrolled": unroll,
        "model_parallel": model_parallel,
        "mesh": list(abstract.shape),
        "kind": shape.kind,
        "profile": case["profile"],
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "flops": cost.flops,
        "bytes_accessed": cost.bytes,
        "memory": mem_info,
        "collectives": coll,
        "compile_seconds": trace_s,
    }
    return abstract, cost, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument(
        "--unroll", action="store_true",
        help="accepted for the reference's CLI; eager Python already counts "
             "every layer",
    )
    args = ap.parse_args(argv)

    archs = list(ARCHITECTURES) if args.arch == "all" else args.arch.split(",")
    shapes = (
        [s.name for s in INPUT_SHAPES] if args.shape == "all" else args.shape.split(",")
    )
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    _, _, info = lower_case(arch, shape, mp, unroll=args.unroll)
                    info["status"] = "ok"
                    print(
                        f"[OK]   {tag}: flops={info['flops']:.3e} "
                        f"bytes={info['bytes_accessed']:.3e} "
                        f"coll={info['collectives']['total_bytes']:.3e}B "
                        f"compile={info['compile_seconds']:.1f}s",
                        flush=True,
                    )
                except Exception as e:
                    info = {
                        "arch": arch, "shape": shape, "multi_pod": mp,
                        "status": "fail", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                results.append(info)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(info) + "\n")
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} cases lowered+compiled successfully", flush=True)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
