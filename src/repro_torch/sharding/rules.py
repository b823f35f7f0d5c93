"""Logical-axis sharding rules -> a spec for every param / cache / batch
leaf, with the divisibility fallback (the JAX package's
``repro/sharding/rules.py``, on the port's trees).

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of axis names (one dim over
several mesh axes); trailing ``None`` s are dropped, so ``()`` is fully
replicated.  Meshes are a ``torch.distributed`` ``DeviceMesh`` or a
``repro_torch.launch.mesh.AbstractMesh``: the rules read only the axis
names and sizes.

Profiles:

* ``fsdp_tp`` (training): the "embed"-like axis over ``data`` (FSDP), the
  "parallel" axis (heads / mlp / vocab / expert) over ``model`` (tensor
  parallelism); optimizer state inherits the param specs; the batch over
  (pod, data).
* ``tp_decode`` (serving): parallel axes over ``model``, embed
  replicated; KV caches shard batch over ``data`` and kv-heads over
  ``model`` (falling back to head_dim when the kv-head count does not
  divide the axis).
* ``fsdp_decode``: tp_decode with embed over ``data`` as well.
* ``fleet``: the whole mesh one walker axis (the regression fleet).

A mesh axis is given to at most one tensor dim; each rule lists logical
axes for a leaf's TRAILING dims, and the first divisible unclaimed axis
wins, the others replicating.  Leading stacked dims (layers, periods)
are padded with ``None``.

The trees are the port's own dicts: a param tree ``{path: tensor or
tuple of layer tensors}`` (``repro_torch.models.base.param_tree``, the
reference's paths) gets ``{path: spec}``, a tuple of layers being one
leaf of the reference's stacked shape; optimizer states (NamedTuples of
such dicts) map field by field, and a cache's list of per-layer dicts
layer by layer (a layer's spec is the reference's stacked leaf's without
its leading ``None``).  A leaf's rule name is the
last component of its path that is not a list index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.launch.mesh import mesh_sizes

__all__ = [
    "PARAM_RULES",
    "EXPERT_RULES",
    "CACHE_RULES",
    "PROFILES",
    "spec_for_leaf",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "opt_state_specs",
    "named_shardings",
    "resolve_walker_axis",
    "walker_batch_specs",
    "fleet_specs",
]

# logical axes for the TRAILING dims of each known leaf name
PARAM_RULES: dict = {
    "table": ("vocab", "embed"),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    "w_gate": ("embed", "mlp"),  # rank-3 (expert) handled below
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "w_in": ("embed", "mlp"),
    "w_out": ("mlp", "embed"),
    "b_in": ("mlp",),
    "b_out": (None,),
    "router": ("embed", None),
    "in_proj": ("embed", "mlp"),
    "out_proj": ("mlp", "embed"),
    "conv_w": (None, "mlp"),
    "conv_b": ("mlp",),
    "norm_scale": (None,),
    "a_log": (None,),
    "d_skip": (None,),
    "dt_bias": (None,),
    "scale": (None,),
    "bias": (None,),
    "dec_pos": (None, "embed"),
}

EXPERT_RULES: dict = {
    "w_gate": ("expert", "embed", "mlp"),
    "w_up": ("expert", "embed", "mlp"),
    "w_down": ("expert", "mlp", "embed"),
}

CACHE_RULES: dict = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "slot_pos": (None,),
    "conv": ("batch", None, "mlp"),
    "ssm": ("batch", "heads", None, None),
}

# logical -> mesh axis, per profile.  "batch" resolves to pod+data jointly;
# "walker" is the W-walker fleet axis (repro_torch.walk_sgd.fleet): the
# leading dim of every walker-batch leaf maps to the data mesh axis, so
# the periodic cross-walker average is an all-reduce along "data".
PROFILES: dict = {
    "fsdp_tp": {
        "embed": "data",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "batch": ("pod", "data"),
        "kv_seq": None,
        "walker": "data",
    },
    "tp_decode": {
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "batch": ("pod", "data"),
        "kv_seq": None,
        "walker": "data",
    },
    "fsdp_decode": {
        "embed": "data",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "batch": ("pod", "data"),
        "kv_seq": None,
        "walker": "data",
    },
    # pure walker-parallel fleet (regression path / engine sweeps): the
    # whole mesh is one walker axis, graph state replicated.
    "fleet": {
        "walker": "data",
    },
}


def _spec(entries) -> tuple:
    """A spec tuple with its trailing ``None`` s dropped."""
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _resolve_axis(logical, profile, sizes, dim_size, used):
    """One logical axis -> a mesh axis, a tuple of them, or None, by
    divisibility and single use; a tuple target (batch over (pod, data))
    drops its leading axes until the dim divides."""
    if logical is None:
        return None
    target = profile.get(logical)
    if target is None:
        return None
    if isinstance(target, tuple):
        axes = tuple(a for a in target if a in sizes and a not in used)
        for k in range(len(axes)):
            sub = axes[k:]
            if dim_size > 0 and dim_size % math.prod(sizes[a] for a in sub) == 0:
                used.update(sub)
                return sub if len(sub) > 1 else sub[0]
        return None
    if target not in sizes or target in used:
        return None
    if dim_size == 0 or dim_size % sizes[target] != 0:
        return None
    used.add(target)
    return target


def spec_for_leaf(
    name: str,
    shape: tuple,
    profile_name: str,
    mesh,
    rules: Optional[dict] = None,
    is_expert: bool = False,
) -> tuple:
    """The spec of one leaf, its leading stacked dims ``None``."""
    rules = rules or PARAM_RULES
    profile = PROFILES[profile_name]
    sizes = mesh_sizes(mesh)
    logical = rules.get(name)
    if is_expert and name in EXPERT_RULES and len(shape) >= 3:
        # routed-expert weight: trailing (E, D, F) under optional stacked dims
        logical = EXPERT_RULES[name]
    if logical is None:
        return ()
    n_lead = len(shape) - len(logical)
    if n_lead < 0:  # rule longer than the rank: replicate
        return ()
    used: set = set()
    entries = [None] * n_lead
    for logical_axis, dim in zip(logical, shape[n_lead:]):
        entries.append(_resolve_axis(logical_axis, profile, sizes, dim, used))
    return _spec(entries)


def _shape(leaf) -> tuple:
    """The reference's shape of a leaf: a tensor's, a tuple of layer
    tensors' stacked ``(L, ...)``, or a ``(shape, dtype)`` pair's
    (``Model.input_specs``)."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple):
        if len(leaf) == 2 and isinstance(leaf[0], tuple) and not hasattr(
                leaf[1], "shape"):
            return tuple(leaf[0])
        return (len(leaf),) + _shape(leaf[0])
    raise TypeError(f"not a leaf: {type(leaf).__name__}")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and NamedTuples; a
    path is the tuple of dict keys, list indices and field names above the
    leaf, a dict key ``"a/b/c"`` contributing ``"a", "b", "c"``.  A plain
    tuple is a leaf (a parameter's layers)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + tuple(str(k).split("/")))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def _leaves_with_path(tree, path=()):
    """``[(path, leaf)]`` in the order of :func:`_map_with_path`."""
    out = []
    _map_with_path(lambda p, x: out.append((p, x)), tree, path)
    return out


def _leaf_name(path: tuple) -> str:
    """The rule name of a leaf: its path's last component that is not a
    list index (the reference's last dict key or attribute)."""
    for p in reversed(path):
        if not p.isdigit():
            return p
    return ""


def param_specs(params, profile_name: str, mesh):
    """The spec tree of a param tree: ``{path: spec}``; a leaf under a
    ``moe`` path and not under ``shared`` is a routed expert's."""

    def assign(path, leaf):
        is_expert = "moe" in path and "shared" not in path
        return spec_for_leaf(_leaf_name(path), _shape(leaf), profile_name,
                             mesh, is_expert=is_expert)

    return _map_with_path(assign, params)


def cache_specs(cache, profile_name: str, mesh):
    """The spec tree of a decode cache (``Model.init_cache``)."""
    return _map_with_path(
        lambda path, leaf: spec_for_leaf(_leaf_name(path), _shape(leaf),
                                         profile_name, mesh, rules=CACHE_RULES),
        cache)


def batch_specs(batch, profile_name: str, mesh):
    """A batch dict: dim 0 the batch over (pod, data), the rest replicated."""
    profile = PROFILES[profile_name]
    sizes = mesh_sizes(mesh)

    def assign(path, leaf):
        del path
        shape = _shape(leaf)
        first = _resolve_axis("batch", profile, sizes, shape[0], set())
        return _spec((first,) + (None,) * (len(shape) - 1))

    return _map_with_path(assign, batch)


def opt_state_specs(opt_state, p_specs, params, profile_name: str, mesh):
    """Optimizer-state specs: a state leaf of a param's shape takes the
    spec of the first param of that shape; another shape (adafactor's
    factored rows and columns) re-applies its name's rule to its own
    shape; scalars replicate."""
    by_shape: dict = {}
    for (_, leaf), (_, spec) in zip(_leaves_with_path(params),
                                    _leaves_with_path(p_specs)):
        by_shape.setdefault(_shape(leaf), spec)

    def assign(path, leaf):
        shape = _shape(leaf)
        if shape == ():
            return ()
        if shape in by_shape:
            return by_shape[shape]
        return spec_for_leaf(_leaf_name(path), shape, profile_name, mesh)

    return _map_with_path(assign, opt_state)


def _placements(spec: tuple, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[names.index(axis)] = Shard(dim)
    return tuple(out)


def named_shardings(spec_tree, mesh):
    """Each spec of ``spec_tree`` as the ``DeviceMesh`` placements it
    means: one ``Shard(dim)`` or ``Replicate()`` per mesh axis."""
    return _map_with_path(
        lambda path, spec: _placements(spec, mesh), spec_tree)


# ---------------------------------------------------------------------------
# Walker-fleet specs (repro_torch.walk_sgd.fleet): the "walker" logical axis.
# ---------------------------------------------------------------------------


def resolve_walker_axis(num_walks: int, mesh, profile_name: str = "fleet"):
    """The spec of a 1-D ``(W,)`` walker-axis leaf, or ``None`` when the
    profile's walker mesh axis is absent or W does not divide it (the
    replication fallback of every logical axis here)."""
    axis = _resolve_axis("walker", PROFILES[profile_name], mesh_sizes(mesh),
                         num_walks, set())
    return None if axis is None else (axis,)


def walker_batch_specs(tree, num_walks: int, mesh, profile_name: str = "fleet"):
    """The spec tree of a walker-stacked tree: every leaf whose leading
    dim is ``num_walks`` takes the walker mesh axis on dim 0 (stacked
    per-walker params, optimizer state, walk state, ``x0s``); the others,
    and every leaf when W does not divide the axis, replicate.  A tuple
    of W generators (a fleet walk state's ``"rng"``) is one leaf of
    length W."""
    axis = resolve_walker_axis(num_walks, mesh, profile_name)

    def assign(leaf):
        if isinstance(leaf, dict):
            return {k: assign(v) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [assign(v) for v in leaf]
        if isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            return type(leaf)(*(assign(v) for v in leaf))
        if isinstance(leaf, tuple) and leaf and not isinstance(
                leaf[0], torch.Generator):
            return tuple(assign(v) for v in leaf)  # per-layer tensors
        if isinstance(leaf, tuple):
            lead = len(leaf)  # the walkers' generators
        else:
            lead = leaf.shape[0] if len(leaf.shape) else None
        return axis if axis is not None and lead == num_walks else ()

    return assign(tree)


def fleet_specs(fleet, mesh, profile_name: str = "fleet") -> dict:
    """The specs of a ``repro_torch.walk_sgd.fleet.WalkFleet``: the walk
    ``nodes`` ride the walker axis, every engine tensor (padded tables,
    ragged CSR state, the flat per-edge CDF) is replicated: walk
    positions are data-dependent gathers into the graph, so each rank
    keeps the whole graph."""
    engine = {}
    for f in dataclasses.fields(fleet.engine):
        v = getattr(fleet.engine, f.name)
        if isinstance(v, torch.Tensor):
            engine[f.name] = ()
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            engine[f.name] = tuple(() for _ in v)
    nodes = walker_batch_specs({"nodes": fleet.nodes}, fleet.num_walks, mesh,
                               profile_name)["nodes"]
    return {"nodes": nodes, "engine": engine}
