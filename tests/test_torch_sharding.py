"""Port parity: the sharding rules' spec trees (``repro_torch.sharding``)
against the JAX package's (``repro/sharding/rules.py``).

The reference's rules read only a mesh's axis names and device shape, so
its side takes ``SimpleNamespace(axis_names=..., devices=np.empty(
shape))`` and no multi-device JAX; the port's side takes the port's
abstract meshes (``repro_torch.launch.mesh``).  Meshes: smoke (1, 1),
production (16, 16) and (32, 8), multi-pod (2, 16, 16).  Trees: every
reduced architecture that ``build_model`` builds, its parameters, its
decode cache, its batch, and its optimizer states under AdamW and
Adafactor, under every profile; and, at the full widths, every
parameter leaf of the reference's abstract init through
``spec_for_leaf``.  The reference's ``PartitionSpec`` keeps trailing
``None`` s the port's tuples drop; they are compared without them.  A
port cache keeps a list of per-layer dicts where the reference stacks a
leading layer axis: the port's layer spec is the reference's without
that leading ``None``.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import optim as jopt
from repro.configs import ARCHITECTURES, INPUT_SHAPES
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models.factory import build_model as jbuild
from repro.sharding import rules as jrules
from repro_torch import optim as topt
from repro_torch.configs import get_arch, reduced
from repro_torch.core import graphs as tg
from repro_torch.core.engine import WalkEngine
from repro_torch.core.transition import MHLJParams
from repro_torch.launch import mesh as tmesh
from repro_torch.models.base import param_tree
from repro_torch.models.factory import build_model
from repro_torch.sharding import rules as trules
from repro_torch.walk_sgd import fleet as tfleet

MESHES = {
    "smoke": (tmesh.make_smoke_mesh, ((1, 1), ("data", "model"))),
    "prod16x16": (tmesh.make_production_mesh, ((16, 16), ("data", "model"))),
    "prod32x8": (lambda: tmesh.make_production_mesh(model_parallel=8),
                 ((32, 8), ("data", "model"))),
    "multipod": (lambda: tmesh.make_production_mesh(multi_pod=True),
                 ((2, 16, 16), ("pod", "data", "model"))),
}
PROFILES = ("fsdp_tp", "tp_decode", "fsdp_decode", "fleet")
ARCHS = sorted(ARCHITECTURES)


def _meshes(name):
    make, (shape, axes) = MESHES[name]
    port = make()
    assert (port.shape, port.axis_names) == (shape, axes)
    return port, SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _norm(spec) -> tuple:
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in out)


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path): _norm(spec) for path, spec in leaves}


def _port_flat(tree, path="") -> dict:
    """The port's spec tree as ``{path: spec}`` (a spec is a tuple of axis
    names, ``None`` s and name tuples; containers are dicts, lists and
    NamedTuples)."""
    join = (lambda k: f"{path}/{k}" if path else str(k))
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in
                _port_flat(v, join(k)).items()}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and hasattr(tree, "_fields")):
        keys = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        return {p: s for k, v in zip(keys, tree) for p, s in
                _port_flat(v, join(k)).items()}
    return {path: tree}


def _same_trees(port_tree, ref_tree, what: str) -> int:
    """Every port spec equals the reference's at its path; a port path
    with list indices the reference stacks takes the reference's spec
    without its leading stacked ``None`` s.  Returns the number of leaves
    sharded on some axis."""
    port, ref = _port_flat(port_tree), _ref_flat(ref_tree)
    matched, sharded = set(), 0
    for path, spec in port.items():
        parts = path.split("/")
        key, lead = path, 0
        if key not in ref:  # per-layer entries of a stacked leaf
            kept = [p for p in parts if not p.isdigit()]
            key, lead = "/".join(kept), len(parts) - len(kept)
        assert key in ref, f"{what}: {path} has no reference leaf"
        want = ref[key]
        assert all(e is None for e in want[:lead]), (what, path, want)
        assert spec == _norm(want[lead:]), (what, path, spec, want)
        assert isinstance(spec, tuple)
        matched.add(key)
        sharded += any(e is not None for e in spec)
    assert matched == set(ref), (what, sorted(set(ref) - matched))
    return sharded


MODELS: dict = {}


def _models(arch):
    """The reduced architecture in both packages, built once: the
    reference's abstract params, the port's model."""
    if arch not in MODELS:
        jm = jbuild(jreduced(jget_arch(arch)), dtype=jax.numpy.float32)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        tm = build_model(reduced(get_arch(arch)), torch.float32, device="cpu")
        MODELS[arch] = (jm, shapes, tm)
    return MODELS[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_reference(arch, mesh):
    """Params, AdamW and Adafactor states, every profile."""
    jm, shapes, tm = _models(arch)
    port_mesh, ref_mesh = _meshes(mesh)
    tree = param_tree(tm)
    opts = {"adamw": (jopt.adamw(1e-3), topt.adamw(1e-3)),
            "adafactor": (jopt.adafactor(1e-3), topt.adafactor(1e-3))}
    for profile in PROFILES:
        p_port = trules.param_specs(tree, profile, port_mesh)
        p_ref = jrules.param_specs(shapes, profile, ref_mesh)
        _same_trees(p_port, p_ref, f"{arch} {mesh} {profile} params")
        for name, (jo, to) in opts.items():
            o_shapes = jax.eval_shape(jo.init, shapes)
            o_port = trules.opt_state_specs(to.init(tree), p_port, tree,
                                            profile, port_mesh)
            o_ref = jrules.opt_state_specs(o_shapes, p_ref, shapes, profile,
                                           ref_mesh)
            _same_trees(o_port, o_ref, f"{arch} {mesh} {profile} {name}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, mesh):
    """The decode cache and the train and decode batches, every profile."""
    jm, _, tm = _models(arch)
    port_mesh, ref_mesh = _meshes(mesh)
    b, length = 32, 64
    c_ref = jax.eval_shape(lambda: jm.init_cache(b, length))
    c_port = tm.init_cache(b, length)
    shape = INPUT_SHAPES[0]
    for profile in PROFILES:
        _same_trees(trules.cache_specs(c_port, profile, port_mesh),
                    jrules.cache_specs(c_ref, profile, ref_mesh),
                    f"{arch} {mesh} {profile} cache")
        for decode in (False, True):
            _same_trees(
                trules.batch_specs(tm.input_specs(shape, for_decode=decode),
                                   profile, port_mesh),
                jrules.batch_specs(jm.input_specs(shape, for_decode=decode),
                                   profile, ref_mesh),
                f"{arch} {mesh} {profile} batch")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_leaves_match_reference(arch):
    """Every parameter leaf of the full-width reference model (abstract)
    through ``spec_for_leaf`` on the production meshes: the rules
    themselves, at the shapes that shard."""
    jm = jbuild(jget_arch(arch), dtype=jax.numpy.bfloat16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    sharded = 0
    for mesh in ("prod16x16", "prod32x8", "multipod"):
        port_mesh, ref_mesh = _meshes(mesh)
        for profile in PROFILES:
            ref = jrules.param_specs(shapes, profile, ref_mesh)
            flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
            specs = jax.tree_util.tree_leaves(
                ref, is_leaf=lambda x: isinstance(x, P))
            for (path, leaf), want in zip(flat, specs):
                keys = [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]
                name = next(k for k in reversed(keys) if not k.isdigit())
                got = trules.spec_for_leaf(
                    name, leaf.shape, profile, port_mesh,
                    is_expert="moe" in keys and "shared" not in keys)
                assert got == _norm(want), (arch, mesh, profile, keys)
                sharded += any(e is not None for e in got)
    assert sharded > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("num_walks", [1, 2, 16, 17, 32, 256, 512])
def test_walker_specs_match_reference(num_walks, mesh):
    """The walker axis: ``resolve_walker_axis``, a walker-stacked tree
    (``walker_batch_specs``) and a fleet's specs (``fleet_specs``: nodes
    on the axis, the engine replicated), with the replication fallback
    when W does not divide the axis."""
    port_mesh, ref_mesh = _meshes(mesh)
    for profile in PROFILES:
        # the reference wraps its axis in a NamedSharding, which needs a
        # real mesh: hold the axis its resolution picks
        want = jrules._resolve_axis("walker", jrules.PROFILES[profile],
                                    jrules._mesh_sizes(ref_mesh), num_walks,
                                    set())
        got = trules.resolve_walker_axis(num_walks, port_mesh, profile)
        assert got == (None if want is None else (want,)), (profile, got)
    tree = {"x0s": np.zeros((num_walks, 6), np.float32),
            "nodes": np.zeros((num_walks,), np.int32),
            "other": np.zeros((3, num_walks), np.float32),
            "scalar": np.zeros((), np.float32)}
    port = trules.walker_batch_specs(
        {k: torch.from_numpy(v) for k, v in tree.items()}, num_walks,
        port_mesh)
    ref = jrules.walker_batch_specs(tree, num_walks, ref_mesh)
    _same_trees(port, ref, f"walkers W={num_walks} {mesh}")
    divides = num_walks % tmesh.mesh_sizes(port_mesh)["data"] == 0
    assert port["x0s"] == (("data",) if divides else ())
    engine = WalkEngine.from_graph(tg.ring(8, layout="ragged"),
                                   MHLJParams(0.1, 0.5, 3),
                                   lipschitz=np.ones(8), device="cpu")
    fleet = tfleet.WalkFleet(engine=engine, nodes=torch.zeros(
        num_walks, dtype=torch.int32), num_walks=num_walks)
    specs = trules.fleet_specs(fleet, port_mesh)
    assert specs["nodes"] == port["nodes"]
    assert specs["engine"] and all(v == () for v in specs["engine"].values())


def test_named_shardings_and_generator_tuples():
    """Placements of a spec on each mesh axis, and a walk state's tuple of
    W generators as one walker leaf."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_production_mesh(multi_pod=True)
    got = trules.named_shardings({"a": (None, ("pod", "data"), "model"),
                                  "b": ()}, mesh)
    assert got == {"a": (Shard(1), Shard(1), Shard(2)),
                   "b": (Replicate(), Replicate(), Replicate())}
    state = {"node": torch.zeros(16, dtype=torch.int32),
             "rng": tuple(torch.Generator() for _ in range(16)),
             "layers": (torch.zeros(16, 3), torch.zeros(16, 3))}
    specs = trules.walker_batch_specs(state, 16, mesh)
    assert specs == {"node": ("data",), "rng": ("data",),
                     "layers": (("data",), ("data",))}
