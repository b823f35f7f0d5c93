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

The multi-device mesh is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import scan as scan_mod
from repro_torch.core.engine import WalkEngine, num_uniforms
from repro_torch.core.faults import FaultModel, FaultState
from repro_torch.models import regression as reg

__all__ = [
    "WalkFleet",
    "sample_initial_nodes",
    "migrate_walk_nodes",
    "fleet_average",
    "run_fleet",
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


def fleet_average(xs, do_avg=None, live: Optional[torch.Tensor] = None):
    """Cross-walker model average, re-broadcast to all W walkers.

    ``xs`` is a (W, ...) tensor, or a pytree dict of them (the LLM fleet's
    stacked models, :func:`stack_params`), averaged leaf by leaf.
    ``do_avg=None`` averages unconditionally; a 0-d device bool makes the
    average conditional (the ``(t + 1) % avg_every == 0`` gate of the
    fleet loop), selected on the device: the mean where ``do_avg``, else
    ``xs``.  ``live``, a (W,) bool, restricts it to the live walkers (the
    faulted loop): ``sum(xs · live) / max(Σ live, 1)``, given to the live
    walkers only, the others keeping their models.
    """
    if isinstance(xs, dict):
        from repro_torch.optim.base import tree_map

        return tree_map(lambda x: fleet_average(x, do_avg, live), xs)
    if live is None:
        mean = xs.mean(dim=0, keepdim=True).expand_as(xs)
        return mean.clone() if do_avg is None else torch.where(do_avg, mean, xs)
    w_live = live.to(xs.dtype)[:, None]
    mean = (xs * w_live).sum(dim=0, keepdim=True) / torch.clamp(
        w_live.sum(), min=1.0)
    take = live[:, None] if do_avg is None else do_avg & live[:, None]
    return torch.where(take, mean.expand_as(xs), xs)


@dataclasses.dataclass(frozen=True, eq=False)
class WalkFleet:
    """W parallel walkers riding one batched engine."""

    engine: WalkEngine
    nodes: torch.Tensor  # (W,) int32 walk positions on the engine's device
    num_walks: int = 1
    avg_every: int = 0  # 0 = never average

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
            self.nodes.cpu().numpy(), engine.degrees.cpu().numpy(), seed=seed
        )
        nodes = torch.as_tensor(
            new_nodes[0] if was_scalar else new_nodes, dtype=torch.int32,
            device=engine.device,
        )
        return dataclasses.replace(self, engine=engine, nodes=nodes), displaced

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
        """ONE batched MHLJ transition for all W walkers.

        The block is an injected ``(W, 3 + r)`` ``uniforms`` (slot 0 = jump
        flag) or drawn from ``generator`` at ``p_j``, in place of the
        reference's key.  Returns ``(advanced_fleet, hops)``; ``hops`` is
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
        at the top level.  The port has no mesh: ``walker_sharding`` is
        None."""
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
            "nodes": self.nodes.cpu().numpy(),
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
        ``graph_version`` and ``cdf_width``.  Refused, with the reason:
        another checkpoint version, a sharded fleet (``walker_sharding``;
        the port has no mesh), and fields the port does not know.
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
            raise ValueError("the checkpoint holds a sharded fleet; the port "
                             "has no multi-device fleet yet")
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
    engine = fleet.engine
    device = engine.device
    w = fleet.num_walks
    n = engine.n
    if uniforms is not None:
        uniforms = _window("uniforms", uniforms,
                           (num_steps, w, num_uniforms(engine.r)), device)
    elif generator is None:
        raise ValueError("pass uniforms= (injected blocks) or generator=")
    if faults is not None:
        faults = faults.to(device)
        if fault_state is None:
            fault_state = faults.init_state(n, w, start=start_step,
                                            device=device)
        if uniforms is not None:
            if faults.markov:
                fault_uniforms = _window("fault_uniforms", fault_uniforms,
                                         (num_steps, n), device)
            if faults.rescue:
                rescue_uniforms = _window("rescue_uniforms", rescue_uniforms,
                                          (num_steps, w), device)
    avg_every = fleet.avg_every
    ones = torch.ones(w, device=device)

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
                xs_new, (t + start_step + 1) % avg_every == 0, alive_w)
        return xs_new

    def draw(row):
        if uniforms is not None:
            return dict(uniforms=row_of(uniforms, row))
        return dict(generator=generator, p_j=p_j_sched.index_select(0, row))

    def objectives(xs_new):
        return (reg.mse_objective(xs_new, features, targets),
                reg.mse_objective(xs_new.mean(dim=0), features, targets))

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
    )
    mses, avg_mses, nodes, hops = outs[:4]
    final = {"nodes": final_carry[2], "fault_state": None, "rescued": None,
             "blocked": None}
    if faults is not None:
        final.update(fault_state=FaultState(*final_carry[3:]),
                     rescued=outs[4], blocked=outs[5])
    return (
        final_carry[1],
        torch.cat([mse0[None], mses]).T.contiguous(),
        torch.cat([avg0[None], avg_mses]),
        nodes.T.contiguous(),
        hops.T.contiguous(),
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
                    projections=None) -> Callable:
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
    """
    from repro_torch.walk_sgd.llm_trainer import make_train_step

    single = make_train_step(model, optimizer, walk, advance_walk=False,
                             projections=projections)

    def fleet_step(params_w, opt_w, walk_w, batches_w, step_idx,
                   uniforms=None):
        num_walks = int(walk_w["node"].shape[0])
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
            params_w = fleet_average(params_w)
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
) -> dict:
    """Stacked LLM walk states for a W-walker fleet.

    Start nodes come from :func:`sample_initial_nodes` (the regression
    fleet's seeding); walker ``i``'s generator is seeded ``seed * 1009 +
    i``, the reference's per-walker key seed.  Every tensor carries a
    leading walker axis; ``"rng"`` is the tuple of the W generators.
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
    return out
