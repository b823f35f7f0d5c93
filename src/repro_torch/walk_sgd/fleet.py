"""The W-walker fleet, its training loop and its checkpoints (regression path).

W parallel walks ride one batched :class:`~repro_torch.core.engine.WalkEngine`
transition per step, each walk carrying its own model; every
``avg_every`` steps the models are averaged across walkers (local-SGD
style, :func:`fleet_average`).  :func:`run_fleet` is the one training
loop — the W=1 case is single-walk RW-SGD — and the reference's
``_fleet_scan``: a step over ``(t, xs, vs)`` on the device (with the
fault state after them under ``faults=``), driven by
``repro_torch.core.scan.scan`` (captured in CUDA graphs on the card, a
plain loop on the CPU).

Crash consistency: :func:`save_fleet_checkpoint` writes the npz layout of
``docs/faults.md`` atomically, :func:`load_fleet_checkpoint` reads it back
(the reference's files too, churned ones included), and
``run_fleet(start_step=, total_steps=, fault_state=)`` resumes a run where
it stopped, bit for bit.

Dynamic graphs: :func:`migrate_walk_nodes` / :meth:`WalkFleet.migrate`
carry the walks across an edge churn (``WalkEngine.apply_churn``).

The LLM path: :func:`make_fleet_step` trains W walkers' language models,
held as per-leaf ``(W, ...)`` storage (:func:`stack_params`), one
walker's update after another, then advances all W walks in ONE batched
:meth:`WalkFleet.advance` and averages every ``avg_every`` steps;
:func:`init_fleet_walk_state` seeds its walk states.

Across ranks: under a walker mesh (``repro_torch.launch.mesh.
make_walker_mesh``, one process a device) each rank holds W/P of the
walks and their models (:func:`shard_fleet`, :func:`shard_walker_batch`,
by ``repro_torch.sharding.rules``' walker axis), and keeps the whole
graph; its engine draws the whole ``(W, 3 + r)`` block from the shared
generator stream and keeps its rows, so the walks equal the unsharded
run's bit for bit.  The average is an all-reduce of each rank's partial
sum (:func:`fleet_average`), the one formula the unsharded fleet uses
too, so a one-rank mesh gives the unsharded bits.  When W does not
divide the rank count every rank holds every walk and no collective
runs.  ``run_fleet(mesh=)`` also all-reduces the per-step mean model for
``avg_mse`` and gathers the ``(W, ...)`` outputs at the end.  On NCCL the
loop stays captured in CUDA graphs, collectives included; gloo's
collectives cannot be captured, so a gloo mesh runs it uncaptured.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import scan as scan_mod
from repro_torch.core.engine import WalkEngine, WalkerShard, num_uniforms
from repro_torch.core.faults import FaultModel, FaultState
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import regression as reg
from repro_torch.sharding.rules import (
    PROFILES,
    fleet_specs,
    resolve_walker_axis,
    walker_batch_specs,
)

__all__ = [
    "WalkFleet",
    "sample_initial_nodes",
    "migrate_walk_nodes",
    "fleet_average",
    "run_fleet",
    "shard_fleet",
    "shard_walker_batch",
    "make_fleet_step",
    "init_fleet_walk_state",
    "stack_params",
    "save_fleet_checkpoint",
    "load_fleet_checkpoint",
]

# The reference engine's data leaves and static fields, the keys of the
# checkpoint's ``engine_data/...`` arrays and ``engine_meta`` (docs/faults.md).
_ENGINE_DATA_FIELDS = (
    "neighbors", "degrees", "p_j", "row_probs",
    "indptr", "indices", "node_bucket", "node_slot",
    "bucket_neighbors", "bucket_rows", "edge_cdf",
)
_ENGINE_META_FIELDS = (
    "p_d", "r", "layout", "compact", "capacity_factor", "bucket_share",
    "max_degree", "cdf_width", "walker_sharding", "graph_version",
)
# static fields of the reference's engine that only its JAX backends read
_JAX_ONLY_META = ("backend", "block_w", "interpret")
CHECKPOINT_VERSION = 1


def sample_initial_nodes(
    n: int,
    num_walks: int,
    *,
    seed: int = 0,
    v0s: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Initial nodes of a fleet: ``v0s`` validated, or ``num_walks`` draws
    from ``np.random.default_rng(seed)`` (without replacement while the
    fleet fits the graph, with replacement beyond)."""
    if n <= 0:
        raise ValueError(
            f"cannot seed {num_walks} walks: the active-node set is empty "
            f"(n={n})"
        )
    if v0s is None:
        rng = np.random.default_rng(seed)
        v0s = rng.choice(n, size=num_walks, replace=num_walks > n)
    v0s = np.asarray(v0s, np.int32)
    if v0s.shape != (num_walks,):
        raise ValueError(f"v0s must have shape ({num_walks},), got {v0s.shape}")
    if v0s.size and (int(v0s.min()) < 0 or int(v0s.max()) >= n):
        raise ValueError(
            f"v0s must be node ids in [0, {n}), got range "
            f"[{int(v0s.min())}, {int(v0s.max())}]"
        )
    return v0s


def migrate_walk_nodes(
    nodes,
    new_degrees,
    *,
    seed: int = 0,
):
    """The walk-continuity rule across a graph version (host numpy, the
    reference's bit for bit).

    After an edge churn a walk on a node still in the graph (degree > 1:
    an edge besides its self-loop) keeps its position.  A walk on a
    departed node (degree 1) is re-seeded: walk ``w`` lands on
    ``active[sample_initial_nodes(len(active), W, seed=seed)[w]]``,
    ``active`` the ascending ids of the nodes still in the graph.  The
    uniform streams belong to the fleet, not to a position, so a kept walk
    keeps its stream.  Returns ``(new_nodes (W,) int32, displaced (W,)
    bool)``; raises when no node has a non-loop edge or a position is out
    of range.
    """
    nodes_np = np.atleast_1d(np.asarray(nodes, np.int32))
    deg = np.asarray(new_degrees, np.int64)
    in_graph = deg > 1
    if not in_graph.any():
        raise ValueError(
            "no node of the churned graph has a non-loop edge; every walk "
            "would be displaced with nowhere to land"
        )
    if nodes_np.size and (
        int(nodes_np.min()) < 0 or int(nodes_np.max()) >= deg.size
    ):
        raise ValueError("walk positions out of range for the churned graph")
    displaced = ~in_graph[nodes_np]
    new_nodes = nodes_np.copy()
    if displaced.any():
        active = np.nonzero(in_graph)[0].astype(np.int32)
        draws = sample_initial_nodes(
            int(active.size), int(nodes_np.size), seed=seed
        )
        new_nodes[displaced] = active[draws[displaced]]
    return new_nodes, displaced


def _walker_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over its leading walker axis, all-reduced over
    ``group`` (each rank's partial sum) when one is given."""
    s = x.sum(dim=0, keepdim=True)
    if group is not None:
        dist.all_reduce(s, group=group)
    return s


def fleet_average(xs, do_avg=None, live: Optional[torch.Tensor] = None, *,
                  group=None, num_walks: Optional[int] = None):
    """Cross-walker model average, re-broadcast to all W walkers.

    ``xs`` is a (W, ...) tensor, or a pytree dict of them (the LLM fleet's
    stacked models, :func:`stack_params`), averaged leaf by leaf: the sum
    over walkers divided by W, the one formula of the sharded and the
    unsharded fleet (it gave ``Tensor.mean``'s bits on the CPU and, at
    (W, 6), on an H100).  ``do_avg=None`` averages
    unconditionally; a 0-d device bool makes the average conditional (the
    ``(t + 1) % avg_every == 0`` gate of the fleet loop), selected on the
    device: the mean where ``do_avg``, else ``xs``.  ``live``, a (W,)
    bool, restricts it to the live walkers (the faulted loop):
    ``sum(xs · live) / max(Σ live, 1)``, given to the live walkers only,
    the others keeping their models.

    Under a walker mesh ``xs`` holds this rank's walkers, ``group`` is the
    mesh's process group and ``num_walks`` the whole fleet's W: the sum
    (and under faults the live count, in the same buffer) is all-reduced
    over the ranks' partial sums.
    """
    if isinstance(xs, dict):
        from repro_torch.optim.base import tree_map

        return tree_map(lambda x: fleet_average(
            x, do_avg, live, group=group, num_walks=num_walks), xs)
    if live is None:
        w = xs.shape[0] if num_walks is None else num_walks
        mean = (_walker_sum(xs, group) / w).expand_as(xs)
        return mean.clone() if do_avg is None else torch.where(do_avg, mean, xs)
    w_live = live.to(xs.dtype)[:, None]
    total = (xs * w_live).sum(dim=0, keepdim=True)
    count = w_live.sum()
    if group is not None:
        packed = torch.cat([total.reshape(-1), count.reshape(1)])
        dist.all_reduce(packed, group=group)
        total, count = packed[:-1].view_as(total), packed[-1]
    mean = total / torch.clamp(count, min=1.0)
    take = live[:, None] if do_avg is None else do_avg & live[:, None]
    return torch.where(take, mean.expand_as(xs), xs)


def _walker_rows(num_walks: int, mesh) -> Optional[WalkerShard]:
    """This rank's rows of a ``num_walks`` batch on ``mesh``, or None when
    W does not divide the walker axis (every rank holds every walk)."""
    spec = resolve_walker_axis(num_walks, mesh)
    if spec is None:
        return None
    axis = spec[0]
    per = num_walks // mesh_sizes(mesh)[axis]
    rank = mesh.get_local_rank(axis)
    return WalkerShard(num_walks, rank * per, (rank + 1) * per)


def _walker_group(mesh):
    """The process group of the walker mesh axis."""
    return mesh.get_group(PROFILES["fleet"]["walker"])


def _gather_walkers(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (this rank's walkers on dim 0), concatenated in
    rank order: the whole fleet's."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


@dataclasses.dataclass(frozen=True, eq=False)
class WalkFleet:
    """W parallel walkers riding one batched engine (this rank's share of
    them on a walker mesh, :func:`shard_fleet`)."""

    engine: WalkEngine
    nodes: torch.Tensor  # (W,) int32 walk positions on the engine's device
    num_walks: int = 1  # W, the whole fleet's, also when sharded
    avg_every: int = 0  # 0 = never average
    # the walker mesh of a sharded fleet (shard_fleet): ``nodes`` are then
    # this rank's walks, the engine's walker_sharding says which
    mesh: Optional[object] = None

    @classmethod
    def create(
        cls,
        engine: WalkEngine,
        num_walks: int,
        *,
        v0s: Optional[Sequence[int]] = None,
        seed: int = 0,
        avg_every: int = 0,
    ) -> "WalkFleet":
        """Fleet with :func:`sample_initial_nodes` seeding/validation."""
        v0 = sample_initial_nodes(engine.n, num_walks, seed=seed, v0s=v0s)
        return cls(
            engine=engine,
            nodes=torch.as_tensor(np.array(v0), device=engine.device),
            num_walks=num_walks,
            avg_every=avg_every,
        )

    def migrate(self, engine: WalkEngine, *, seed: int = 0):
        """This fleet on a churned ``engine`` (the next graph version):
        :func:`migrate_walk_nodes` against the new degree vector.  Returns
        ``(new_fleet, displaced)``; a 0-d ``nodes`` (the W=1 shape) stays
        0-d."""
        was_scalar = self.nodes.ndim == 0
        new_nodes, displaced = migrate_walk_nodes(
            self.all_nodes().cpu().numpy(), engine.degrees.cpu().numpy(),
            seed=seed,
        )
        nodes = torch.as_tensor(
            new_nodes[0] if was_scalar else new_nodes, dtype=torch.int32,
            device=engine.device,
        )
        shard = self.engine.walker_sharding
        if shard is not None:  # the rule is the whole fleet's; keep our rows
            nodes = shard.rows(nodes)
            engine = engine.with_walker_sharding(shard)
        return dataclasses.replace(self, engine=engine, nodes=nodes), displaced

    def all_nodes(self) -> torch.Tensor:
        """The whole fleet's walk positions: ``nodes``, gathered over the
        walker mesh when the fleet is sharded (a collective: every rank
        calls it)."""
        if self.mesh is None:
            return self.nodes
        return _gather_walkers(self.nodes, _walker_group(self.mesh))

    def advance(
        self,
        *,
        uniforms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        p_j=None,
        lipschitz: Optional[torch.Tensor] = None,
        faults=None,
        rescue_uniforms: Optional[torch.Tensor] = None,
    ):
        """ONE batched MHLJ transition for all W walkers (this rank's, on
        a sharded fleet).

        The block is an injected ``(W, 3 + r)`` ``uniforms`` (slot 0 = jump
        flag) or drawn from ``generator`` at ``p_j``, in place of the
        reference's key; a sharded fleet takes and draws the whole W's.  Returns ``(advanced_fleet, hops)``; ``hops`` is
        the Remark-1 physical transition count per walker.  With
        ``faults=(FaultModel, FaultState)`` the transition is
        liveness-masked (:meth:`WalkEngine.step`; ``rescue_uniforms`` (W,)
        beside an injected block) and a third element carries the engine's
        fault aux: ``blocked_steps`` (the caller's next
        ``FaultState.blocked``), ``fault_blocked`` and ``rescued``.
        """
        if faults is None:
            nxt, hops = self.engine.step(
                self.nodes, uniforms=uniforms, generator=generator, p_j=p_j,
                lipschitz=lipschitz,
            )
            return dataclasses.replace(self, nodes=nxt), hops
        nxt, hops, aux = self.engine.step(
            self.nodes, uniforms=uniforms, generator=generator, p_j=p_j,
            lipschitz=lipschitz, with_aux=True, faults=faults,
            rescue_uniforms=rescue_uniforms,
        )
        return dataclasses.replace(self, nodes=nxt), hops, aux

    # -- crash consistency (docs/faults.md, "checkpoint format") -------------

    def checkpoint(self) -> dict:
        """Host snapshot in the reference's layout: every engine data field
        of the reference as a numpy array (tuples stay tuples; ``p_j`` a
        float), the engine's statics in ``engine_meta`` (its sticky
        ``cdf_width`` and its ``graph_version`` among them) and the fleet's
        at the top level.  A sharded fleet's walk positions are gathered
        (a collective: every rank calls it), and ``walker_sharding`` is
        None, as the reference writes it: placement is not state, and
        :func:`shard_fleet` places a restored fleet again."""
        e = self.engine
        data = {}
        for f in _ENGINE_DATA_FIELDS:
            v = getattr(e, f)
            if v is None or isinstance(v, float):
                data[f] = v
            elif isinstance(v, tuple):
                data[f] = tuple(x.cpu().numpy() for x in v)
            else:
                data[f] = v.cpu().numpy()
        meta = {f: getattr(e, f, None) for f in _ENGINE_META_FIELDS}
        meta.update(walker_sharding=None)
        return {
            "version": CHECKPOINT_VERSION,
            "num_walks": self.num_walks,
            "avg_every": self.avg_every,
            "nodes": self.all_nodes().cpu().numpy(),
            "engine_data": data,
            "engine_meta": meta,
        }

    @classmethod
    def restore(cls, ckpt: dict, *, device="cuda") -> "WalkFleet":
        """The fleet of a :meth:`checkpoint` dict (the port's or the
        reference's), on ``device``, bit for bit.

        The engine is rebuilt by ``interop.from_reference_state``, which
        keeps the stored ``edge_cdf`` buffer as it is: a rebuilt CDF may
        differ in its last bits and would not resume bitwise.  The
        reference's JAX-only statics (``backend``, ``block_w``,
        ``interpret``) are ignored.  A churned engine keeps its
        ``graph_version`` and ``cdf_width``.  The fleet is unsharded
        (:func:`shard_fleet` places it on a mesh).  Refused, with the
        reason: another checkpoint version, a ``walker_sharding`` that is
        not None (a checkpoint holds no placement), and fields the port
        does not know.
        """
        from repro_torch import interop

        if ckpt.get("version") != CHECKPOINT_VERSION:
            raise ValueError(f"checkpoint version {ckpt.get('version')!r}; "
                             f"the port reads version {CHECKPOINT_VERSION}")
        meta = dict(ckpt["engine_meta"])
        unknown = sorted(set(meta) - set(_ENGINE_META_FIELDS)
                         - set(_JAX_ONLY_META))
        unknown += sorted(set(ckpt["engine_data"]) - set(_ENGINE_DATA_FIELDS))
        if unknown:
            raise ValueError(f"checkpoint fields the port does not know: "
                             f"{unknown}")
        if meta.get("walker_sharding") is not None:
            raise ValueError("the checkpoint records a sharded placement "
                             "(walker_sharding); a checkpoint holds the whole "
                             "fleet unplaced: place it again with shard_fleet")
        data = ckpt["engine_data"]
        p_j = data.get("p_j")
        state = {f: data.get(f) for f in _ENGINE_DATA_FIELDS if f != "p_j"}
        state.update(
            {f: meta.get(f) for f in _ENGINE_META_FIELDS
             if f not in ("walker_sharding", "max_degree", "cdf_width",
                          "graph_version")},
        )
        engine, fleet, _ = interop.from_reference_state(
            **state, p_j=0.0 if p_j is None else float(np.asarray(p_j)),
            max_degree=meta.get("max_degree"), cdf_width=meta.get("cdf_width"),
            graph_version=int(meta.get("graph_version") or 0),
            nodes=np.atleast_1d(np.asarray(ckpt["nodes"])),
            avg_every=int(ckpt["avg_every"]), device=device,
        )
        if fleet.num_walks != int(ckpt["num_walks"]):
            raise ValueError(f"checkpoint num_walks={ckpt['num_walks']} but "
                             f"{fleet.num_walks} walk positions")
        return fleet


def _host_array(x) -> np.ndarray:
    """An ``extras`` value (tensor, array or scalar) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_fleet_checkpoint(
    path: str,
    fleet: WalkFleet,
    *,
    step: int = 0,
    extras: Optional[dict] = None,
) -> str:
    """A crash-consistent fleet checkpoint on disk: one ``.npz`` in the
    layout of docs/faults.md, written to a temporary file, flushed and
    fsynced, then moved into place with ``os.replace`` (a crash mid-write
    leaves any earlier checkpoint whole).

    Keys: ``nodes``; ``engine_data/<field>`` (``engine_data/<field>/<i>``
    for tuple fields such as the bucketed ladder); ``extras/<name>`` for
    the caller's arrays (per-walker models, the ``FaultState`` leaves, a
    generator's ``get_state()`` — what the loop carries); and
    ``meta_json``, the statics, the step and the layout's bookkeeping.
    """
    ckpt = fleet.checkpoint()
    arrays: dict = {"nodes": ckpt["nodes"]}
    none_fields, tuple_lens, scalar_fields = [], {}, {}
    for f, v in ckpt["engine_data"].items():
        if v is None:
            none_fields.append(f)
        elif isinstance(v, float):
            scalar_fields[f] = v
        elif isinstance(v, tuple):
            tuple_lens[f] = len(v)
            for i, x in enumerate(v):
                arrays[f"engine_data/{f}/{i}"] = x
        else:
            arrays[f"engine_data/{f}"] = v
    extras = extras or {}
    for name, x in extras.items():
        arrays[f"extras/{name}"] = _host_array(x)
    meta = {
        "version": ckpt["version"],
        "num_walks": ckpt["num_walks"],
        "avg_every": ckpt["avg_every"],
        "step": int(step),
        "engine_meta": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in ckpt["engine_meta"].items()
        },
        "meta_tuples": [
            k for k, v in ckpt["engine_meta"].items() if isinstance(v, tuple)
        ],
        "none_fields": none_fields,
        "tuple_lens": tuple_lens,
        "scalar_fields": scalar_fields,
        "extras": sorted(extras),
    }
    arrays["meta_json"] = np.asarray(json.dumps(meta))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_fleet_checkpoint(path: str, *, device="cuda"):
    """Read a :func:`save_fleet_checkpoint` file — the port's or the
    reference's — into ``(fleet, step, extras)``: the fleet on ``device``
    (:meth:`WalkFleet.restore`, which says what it refuses), the step, and
    the extras as numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta_json"]))
        data: dict = {f: None for f in meta["none_fields"]}
        data.update(meta["scalar_fields"])
        for f, k in meta["tuple_lens"].items():
            data[f] = tuple(z[f"engine_data/{f}/{i}"] for i in range(k))
        for key in z.files:
            if key.startswith("engine_data/") and key.count("/") == 1:
                data[key.split("/", 1)[1]] = z[key]
        engine_meta = {
            k: (tuple(v) if k in meta["meta_tuples"] and v is not None else v)
            for k, v in meta["engine_meta"].items()
        }
        fleet = WalkFleet.restore(
            {
                "version": meta["version"],
                "num_walks": meta["num_walks"],
                "avg_every": meta["avg_every"],
                "nodes": z["nodes"],
                "engine_data": data,
                "engine_meta": engine_meta,
            },
            device=device,
        )
        extras = {name: z[f"extras/{name}"] for name in meta["extras"]}
    return fleet, meta["step"], extras


def _place(x, spec: tuple, shard: Optional[WalkerShard]):
    """One walker-batch leaf under its walker spec: this rank's rows of a
    ``(W, ...)`` tensor or a tuple of W per-walker objects, or ``x``
    itself when the spec replicates it."""
    if not spec or shard is None:
        return x
    return shard.rows(x) if isinstance(x, torch.Tensor) else x[shard.lo:shard.hi]


def shard_fleet(fleet: WalkFleet, mesh) -> WalkFleet:
    """Place a fleet on ``mesh``: this rank's walks, the whole engine.

    By ``repro_torch.sharding.rules.fleet_specs`` the walk ``nodes`` ride
    the walker axis and every engine tensor is replicated.  The fleet
    keeps this rank's rows ``[lo, hi)`` of its ``nodes`` and ``mesh``, and
    its engine is told the rows (:meth:`WalkEngine.with_walker_sharding`),
    so each step draws and slices the whole block.  When W does not divide
    the walker axis the fleet comes back whole (every rank holds every
    walk) and unsharded: nothing of it runs a collective.  A fleet already
    on ``mesh`` comes back as it is.
    """
    if fleet.mesh is not None:
        if fleet.mesh is not mesh:
            raise ValueError("the fleet is sharded over another mesh")
        return fleet
    shard = _walker_rows(fleet.num_walks, mesh)
    if shard is None:
        return fleet
    nodes = _place(fleet.nodes, fleet_specs(fleet, mesh)["nodes"], shard)
    return dataclasses.replace(
        fleet, nodes=nodes, mesh=mesh,
        engine=fleet.engine.with_walker_sharding(shard))


def shard_walker_batch(tree, num_walks: int, mesh):
    """This rank's part of a walker-stacked tree (stacked params, optimizer
    state and walk states on the LLM path, ``x0s`` on the regression path)
    by ``repro_torch.sharding.rules.walker_batch_specs``: each leaf with a
    leading W dim, or a tuple of W generators, keeps this rank's rows;
    every leaf stays whole when W does not divide the walker axis."""
    specs = walker_batch_specs(tree, num_walks, mesh)
    shard = _walker_rows(num_walks, mesh)

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, list):
            return [place(v, sp) for v, sp in zip(x, spec)]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(place(v, sp) for v, sp in zip(x, spec)))
        if isinstance(x, tuple) and x and isinstance(x[0], (torch.Tensor, tuple)):
            return tuple(place(v, sp) for v, sp in zip(x, spec))
        return _place(x, spec, shard)

    return place(tree, specs)


def _window(name, block, shape, device) -> torch.Tensor:
    """An injected per-step block, checked against ``shape``."""
    if block is None:
        raise ValueError(f"{name}= is needed beside injected uniforms")
    if tuple(block.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(block.shape)}")
    return block.to(device, torch.float32)


def run_fleet(
    x0s: torch.Tensor,  # (W, dim)
    features: torch.Tensor,  # (n, dim) float32
    targets: torch.Tensor,  # (n,) float32
    weights: torch.Tensor,  # (n,) L_bar / L_v
    fleet: WalkFleet,
    num_steps: int,
    gamma: float,
    p_j_sched: torch.Tensor,  # (num_steps,) float32
    use_weights: bool,
    loss_grad: Callable,
    *,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    faults: Optional[FaultModel] = None,
    fault_state: Optional[FaultState] = None,
    fault_uniforms: Optional[torch.Tensor] = None,
    rescue_uniforms: Optional[torch.Tensor] = None,
    start_step: int = 0,
    total_steps: Optional[int] = None,
    capture: Optional[bool] = None,
    mesh=None,
):
    """Train the fleet for ``num_steps`` steps.

    Per step: each walker takes the (importance-weighted, when
    ``use_weights``) gradient step of its node's loss, the models are
    averaged on steps ``t`` with ``(t + 1) % avg_every == 0``, and all
    walkers advance through one engine step — with the injected block
    ``uniforms[t]`` of a ``(T, W, 3 + r)`` tensor (slot 0 = jump flag), or
    drawn from ``generator`` at ``p_j_sched[t]``.  The step is the
    reference's ``_fleet_scan`` step over ``(t, xs, vs)``, ``t`` on the
    device; ``repro_torch.core.scan.scan`` captures the loop on the card
    (``capture=False`` runs it uncaptured, for comparison only).

    ``faults`` (a :class:`~repro_torch.core.faults.FaultModel`) runs the
    liveness-masked regime (docs/faults.md).  Each step the fault process
    advances first; a walker on a dead node then makes no update and
    takes no part in the average, which is over the live walkers only
    (``sum(xs * live) / max(sum(live), 1)``); and its handoff is masked by
    :meth:`WalkEngine.step`.  The fault state rides in the carry after
    ``t``, ``xs`` and ``vs``.  ``fault_state`` resumes a recorded state
    (default: all live at tick ``start_step``).  Its streams, per step:
    ``(n,)`` Markov uniforms when a rate is positive, then the walk's
    block, then ``(W,)`` rescue uniforms when the model rescues — drawn
    from ``generator`` in that order, or injected as ``fault_uniforms``
    ``(T, n)`` and ``rescue_uniforms`` ``(T, W)`` beside ``uniforms``.

    ``start_step``/``total_steps`` are the resume seam: the window
    ``[start_step, start_step + num_steps)`` of a ``total_steps`` run
    (``start_step`` sets the averaging phase and the fault tick).  Pass
    that window's blocks and ``p_j_sched``, and, drawing from a generator,
    the generator in the state the first run left it.

    ``mesh`` (``repro_torch.launch.mesh.make_walker_mesh``; every rank
    calls with the same arguments) shards the walks and ``x0s`` over the
    walker axis (:func:`shard_fleet`, :func:`shard_walker_batch`; the
    fleet may come sharded already) and keeps the graph, the data and
    ``p_j_sched`` whole on every rank.  Each rank steps its walks, drawing
    the whole blocks as the unsharded run draws them (injected blocks are
    the whole fleet's too); the average is an all-reduce along the walker
    axis, and ``avg_mse`` takes one more a step, of the ``(dim,)`` sum of
    the models.  Every rank returns the whole fleet's outputs (gathered at
    the end).  The walks equal the unsharded run's bit for bit; the
    floats differ by the all-reduce's order of summation, and not at all
    on one rank.  On NCCL the loop is captured with its collectives; on
    gloo ``capture=None`` runs it uncaptured (``ScanStats.uncaptured_by``
    says why) and ``capture=True`` raises.  W that does not divide the
    walker axis runs whole on every rank, without a collective.

    Returns ``(x_final (W, dim), mse (W, T+1), avg_mse (T+1,),
    update_nodes (W, T), hops (W, T), final)``; ``final`` holds the walk
    positions after the last step (``"nodes"``) and, under faults, the
    final ``"fault_state"`` and the per-step ``"rescued"`` and
    ``"blocked"`` (T,) int32 totals (None without faults).
    """
    if start_step < 0:
        raise ValueError(f"start_step must be >= 0, got {start_step}")
    total = num_steps if total_steps is None else total_steps
    if start_step + num_steps > total:
        raise ValueError(
            f"window [{start_step}, {start_step + num_steps}) exceeds "
            f"total_steps={total}"
        )
    if mesh is not None:
        fleet = shard_fleet(fleet, mesh)
        x0s = shard_walker_batch(x0s, fleet.num_walks, mesh)
    engine = fleet.engine
    device = engine.device
    w = fleet.num_walks
    w_local = int(fleet.nodes.shape[0])
    n = engine.n
    shard = engine.walker_sharding
    group = None if fleet.mesh is None else _walker_group(fleet.mesh)
    uncaptured_by = None
    if group is not None and dist.get_backend(group) != "nccl":
        if capture:
            raise ValueError(
                f"capture=True under a {dist.get_backend(group)} walker mesh: "
                "only NCCL collectives can be captured in CUDA graphs")
        if device.type == "cuda":
            capture = False
            uncaptured_by = (f"{dist.get_backend(group)} collectives cannot "
                             "be captured")
    if uniforms is not None:
        uniforms = _window("uniforms", uniforms,
                           (num_steps, w, num_uniforms(engine.r)), device)
    elif generator is None:
        raise ValueError("pass uniforms= (injected blocks) or generator=")
    if faults is not None:
        faults = faults.to(device)
        if fault_state is None:
            fault_state = faults.init_state(n, w_local, start=start_step,
                                            device=device)
        elif shard is not None and fault_state.blocked.shape[0] == w:
            fault_state = dataclasses.replace(
                fault_state, blocked=shard.rows(fault_state.blocked))
        if uniforms is not None:
            if faults.markov:
                fault_uniforms = _window("fault_uniforms", fault_uniforms,
                                         (num_steps, n), device)
            if faults.rescue:
                rescue_uniforms = _window("rescue_uniforms", rescue_uniforms,
                                          (num_steps, w), device)
    avg_every = fleet.avg_every
    ones = torch.ones(w_local, device=device)

    def row_of(block, row):
        return None if block is None else block.index_select(0, row)[0]

    def update(t, xs, vs, alive_w):
        gs = loss_grad(xs, features[vs], targets[vs])  # (W, dim)
        ws = (weights[vs] if use_weights else ones)[:, None]
        xs_new = xs - gamma * ws * gs
        if alive_w is not None:
            xs_new = torch.where(alive_w[:, None], xs_new, xs)
        if avg_every > 0:  # dead walkers neither give nor take
            xs_new = fleet_average(
                xs_new, (t + start_step + 1) % avg_every == 0, alive_w,
                group=group, num_walks=w)
        return xs_new

    def draw(row):
        if uniforms is not None:
            return dict(uniforms=row_of(uniforms, row))
        return dict(generator=generator, p_j=p_j_sched.index_select(0, row))

    def objectives(xs_new):
        mean = _walker_sum(xs_new, group)[0] / w
        return (reg.mse_objective(xs_new, features, targets),
                reg.mse_objective(mean, features, targets))

    def step(carry):
        t, xs, vs = carry
        row = t.view(1)
        xs_new = update(t, xs, vs, None)
        vs_next, hops = engine.step(vs, **draw(row))  # ONE batched call
        return (t + 1, xs_new, vs_next), (*objectives(xs_new), vs, hops)

    def faulted_step(carry):
        t, xs, vs, live, blocked, ft = carry
        row = t.view(1)
        fstate = faults.advance(
            FaultState(live, blocked, ft),
            uniforms=row_of(fault_uniforms, row),
            generator=None if uniforms is not None else generator,
        )
        alive_w = faults.live_mask(fstate)[vs]
        xs_new = update(t, xs, vs, alive_w)
        vs_next, hops, aux = engine.step(
            vs, with_aux=True, faults=(faults, fstate),
            rescue_uniforms=row_of(rescue_uniforms, row), **draw(row),
        )
        return ((t + 1, xs_new, vs_next, fstate.live, aux["blocked_steps"],
                 fstate.t),
                (*objectives(xs_new), vs, hops,
                 aux["rescued"].sum(dtype=torch.int32),
                 aux["fault_blocked"].sum(dtype=torch.int32)))

    mse0, avg0 = objectives(x0s)
    t0 = torch.zeros((), dtype=torch.int64, device=device)
    carry = (t0, x0s, fleet.nodes)
    out_like = (mse0, avg0, fleet.nodes, fleet.nodes)
    if faults is not None:
        fs = fault_state
        carry += (fs.live.to(device), fs.blocked.to(device, torch.int32),
                  fs.t.to(device, torch.int32))
        count = torch.zeros((), dtype=torch.int32, device=device)
        out_like += (count, count)
    outs, final_carry, _ = scan_mod.scan(
        step if faults is None else faulted_step, carry, num_steps,
        out_like, capture=capture,
        generators=() if generator is None else (generator,),
        uncaptured_by=uncaptured_by,
    )
    mses, avg_mses, nodes, hops = outs[:4]
    by_walker = [final_carry[1], torch.cat([mse0[None], mses]).T,
                 nodes.T, hops.T, final_carry[2]]
    if faults is not None:
        by_walker.append(final_carry[4])
    if group is not None:  # every rank returns the whole fleet's
        by_walker = [_gather_walkers(x, group) for x in by_walker]
    x_final, mse, nodes, hops, final_nodes = (
        x.contiguous() for x in by_walker[:5])
    final = {"nodes": final_nodes, "fault_state": None, "rescued": None,
             "blocked": None}
    if faults is not None:
        rescued, blocked = outs[4], outs[5]
        if group is not None:
            counts = torch.stack([rescued, blocked])
            dist.all_reduce(counts, group=group)
            rescued, blocked = counts[0], counts[1]
        live, _, ft = final_carry[3:]
        final.update(fault_state=FaultState(live, by_walker[5], ft),
                     rescued=rescued, blocked=blocked)
    return (
        x_final,
        mse,
        torch.cat([avg0[None], avg_mses]),
        nodes,
        hops,
        final,
    )


# ---------------------------------------------------------------------------
# The fleet step of the LLM path: the W walkers' updates, one batched walk
# advance and the periodic average.
# ---------------------------------------------------------------------------


def _map_state(fn, obj):
    """``fn`` over every tensor of a NamedTuple / tuple / dict nest."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_state(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_state(fn, v) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_map_state(fn, v) for v in obj)
    raise TypeError(f"cannot map over {type(obj).__name__}")


def stack_params(params, num_walks: int):
    """W independent copies of ``params`` (a parameter pytree, or an
    optimizer state): every tensor ``x`` becomes a contiguous ``(W, *x.shape)``
    tensor, walker ``w``'s copy at ``[w]``."""
    return _map_state(
        lambda x: x.detach().unsqueeze(0).repeat(
            (num_walks,) + (1,) * x.ndim), params)


def make_fleet_step(model, optimizer, walk, avg_every: int = 0, *,
                    projections=None, mesh=None) -> Callable:
    """``(params_w, opt_w, walk_w, batches_w, step_idx, uniforms=None) ->
    (params_w, opt_w, walk_w, metrics)``, the W-walker fleet step.

    ``params_w``/``opt_w`` come from :func:`stack_params` (walker ``w`` at
    ``[w]`` of every tensor) and are updated in place (an average returns
    new parameter tensors); ``walk_w`` from
    :func:`init_fleet_walk_state`; ``batches_w`` holds one batch per walker
    (a leading walk axis).  Each walker takes the single-walker train step
    (``llm_trainer.make_train_step``, walk advance off) on its own views,
    one after another; then all W walks advance in ONE batched transition
    (``walk.advance_batched``: one sparse launch, ``uniforms`` an injected
    ``(W, 3 + r)`` block), and with ``avg_every > 0`` the models are
    averaged when ``(step_idx + 1) % avg_every == 0``.  ``metrics`` are
    stacked over walkers.

    Under a walker ``mesh`` (every rank calls the step) each rank holds
    W/P walkers: ``params_w``, ``opt_w`` and ``walk_w`` are its part
    (:func:`shard_walker_batch`, ``init_fleet_walk_state(mesh=)``), while
    ``batches_w`` and ``uniforms`` are the whole fleet's and the step keeps
    the rank's rows.  Each walker draws from its own generator, so the
    walks equal the unsharded step's; the average is an all-reduce per
    leaf along the walker axis, and ``metrics`` are the rank's walkers'.
    When W does not divide the axis every rank runs every walker and no
    collective runs.
    """
    from repro_torch.walk_sgd.llm_trainer import make_train_step

    single = make_train_step(model, optimizer, walk, advance_walk=False,
                             projections=projections)

    def fleet_step(params_w, opt_w, walk_w, batches_w, step_idx,
                   uniforms=None):
        num_walks = int(walk_w["node"].shape[0])
        total = int(next(iter(batches_w.values())).shape[0])
        shard = None if mesh is None else _walker_rows(total, mesh)
        if shard is not None:
            if num_walks != shard.size:
                raise ValueError(f"this rank holds walkers [{shard.lo}, "
                                 f"{shard.hi}) of {total}; got {num_walks}")
            batches_w = {k: shard.rows(v) for k, v in batches_w.items()}
            if uniforms is not None:
                uniforms = shard.rows(uniforms)
        states, metrics = [], []
        for w in range(num_walks):
            params = _map_state(
                lambda x: x[w].detach().requires_grad_(True), params_w)
            opt = _map_state(lambda x: x[w], opt_w)
            state = {k: v[w] for k, v in walk_w.items() if k != "rng"}
            batch = {k: v[w] for k, v in batches_w.items()}
            _, _, state, m = single(params, opt, state, batch)
            states.append(state)
            metrics.append(m)
        walk_w = {**{k: torch.stack([s[k] for s in states])
                     for k in states[0]}, "rng": walk_w["rng"]}
        walk_w = walk.advance_batched(walk_w, uniforms=uniforms)
        if avg_every > 0 and (int(step_idx) + 1) % avg_every == 0:
            params_w = fleet_average(
                params_w, group=None if shard is None else _walker_group(mesh),
                num_walks=total)
        metrics = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
        return params_w, opt_w, walk_w, metrics

    return fleet_step


def init_fleet_walk_state(
    n_nodes: int,
    num_walks: int,
    lipschitz: Optional[np.ndarray] = None,
    v0s: Optional[Sequence[int]] = None,
    seed: int = 0,
    online: bool = False,
    *,
    device="cuda",
    mesh=None,
) -> dict:
    """Stacked LLM walk states for a W-walker fleet.

    Start nodes come from :func:`sample_initial_nodes` (the regression
    fleet's seeding); walker ``i``'s generator is seeded ``seed * 1009 +
    i``, the reference's per-walker key seed.  Every tensor carries a
    leading walker axis; ``"rng"`` is the tuple of the W generators.
    Under a walker ``mesh`` the rank's walkers only
    (:func:`shard_walker_batch`), each seeded by its index in the fleet.
    """
    from repro_torch.walk_sgd.llm_trainer import init_walk_state

    v0s = sample_initial_nodes(n_nodes, num_walks, seed=seed, v0s=v0s)
    states = [
        init_walk_state(n_nodes, lipschitz, v0=int(v), seed=seed * 1009 + i,
                        online=online, device=device)
        for i, v in enumerate(v0s)
    ]
    out = {k: torch.stack([s[k] for s in states])
           for k in states[0] if k != "rng"}
    out["rng"] = tuple(s["rng"] for s in states)
    return out if mesh is None else shard_walker_batch(out, num_walks, mesh)
