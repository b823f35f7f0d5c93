"""Dada-style learned collaboration graphs over walk-SGD, on the port.

The Dada line of work (Zantedeschi et al., AISTATS 2020) alternates two
phases: train models on the collaboration graph, then rewire the graph
from pairwise model similarity, so nodes with similar local models become
neighbors.  Per round of :func:`run_dada`:

1. one walk-SGD epoch through the trainer's loop
   (``trainer._train`` -> ``fleet.run_fleet``, captured in CUDA graphs on
   the card) on the current graph, the models carried over;
2. **personalization**: every node takes a few local gradient steps on
   its own datum from the walk-averaged model (:func:`personalize_models`,
   torch on the engine's device);
3. **rewiring**: the mutual k-nearest-neighbor edges in model space
   (:func:`similarity_edges`, host numpy) applied as one batched churn
   (``graphs.apply_edge_churn``): the engine's per-edge CDF is patched
   segment-locally (``WalkEngine.apply_churn``) and the walks cross the
   graph version by the continuity rule (``fleet.migrate_walk_nodes``).

Each round's walk loop is a new ``run_fleet`` call, so on the card it
captures again: a CUDA graph lives inside one ``scan`` call only, and none
is ever replayed over the buffers of an earlier graph version.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.engine import WalkEngine
from repro_torch.core.graphs import RaggedCSRGraph, _edges_to_csr, apply_edge_churn
from repro_torch.core.transition import MHLJParams, mh_importance_rows_ragged
from repro_torch.data.synthetic import RegressionData
from repro_torch.models import regression as reg
from repro_torch.walk_sgd import trainer as trainer_mod
from repro_torch.walk_sgd.fleet import (
    WalkFleet,
    load_fleet_checkpoint,
    migrate_walk_nodes,
    save_fleet_checkpoint,
)

__all__ = [
    "DadaResult",
    "personalize_models",
    "similarity_edges",
    "run_dada",
]

# the telemetry arrays a run_dada checkpoint carries in its extras
_TELEMETRY = ("round_mse", "personalized_mse", "edges_inserted",
              "edges_deleted", "walks_displaced", "graph_versions")


@dataclasses.dataclass
class DadaResult:
    """Per-round telemetry of one :func:`run_dada` run."""

    round_mse: np.ndarray  # (rounds,) walk-averaged-model MSE per round
    personalized_mse: np.ndarray  # (rounds,) mean per-node local sq. error
    edges_inserted: np.ndarray  # (rounds,) churn batch sizes (0 = no rewire)
    edges_deleted: np.ndarray  # (rounds,)
    walks_displaced: np.ndarray  # (rounds,) re-seeded walks entering round
    graph_versions: np.ndarray  # (rounds,) engine.graph_version per round
    x_final: np.ndarray  # (W, dim) final per-walk models
    method: str


def personalize_models(
    x_avg,
    features,
    targets,
    *,
    local_steps: int = 5,
    lr: float = 0.01,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Per-node models: ``local_steps`` gradient steps of each node's
    single-datum squared loss (``models.regression.linear_grad``) from the
    shared model ``x_avg``, in float32 on ``device``.  Returns the
    ``(n, dim)`` model matrix that :func:`similarity_edges` reads."""
    if local_steps < 0:
        raise ValueError("local_steps must be >= 0")
    feats = torch.as_tensor(np.asarray(features, np.float32), device=device)
    targs = torch.as_tensor(np.asarray(targets, np.float32), device=device)
    x = torch.as_tensor(np.asarray(x_avg, np.float32), device=device)
    x = x[None, :].expand(feats.shape).clone()
    for _ in range(local_steps):
        x = x - lr * reg.linear_grad(x, feats, targs)
    return x.cpu().numpy()


def _component_labels(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Connected-component label per node over a CSR structure (O(E) DFS)."""
    n = indptr.shape[0] - 1
    labels = np.full(n, -1, dtype=np.int64)
    c = 0
    for s in range(n):
        if labels[s] >= 0:
            continue
        labels[s] = c
        stack = [s]
        while stack:
            v = stack.pop()
            for u in indices[indptr[v] : indptr[v + 1]]:
                if labels[u] < 0:
                    labels[u] = c
                    stack.append(int(u))
        c += 1
    return labels


def similarity_edges(models: np.ndarray, k: int) -> np.ndarray:
    """Symmetrized k-nearest-neighbor edges in model space (host numpy,
    the reference's bit for bit).

    Each node proposes its ``k`` nearest peers by squared model distance
    (ties broken by node id), the proposals become undirected pairs, and
    each component past the first is bridged to it by one edge between
    the components' smallest ids, so the graph stays connected.  Returns a
    ``(E, 2)`` int64 canonical pair array for ``graphs.apply_edge_churn``
    or ``from_edges``.
    """
    x = np.asarray(models, dtype=np.float64)
    n = x.shape[0]
    if x.ndim != 2 or n < 2:
        raise ValueError("models must be (n >= 2, dim)")
    if not (1 <= k < n):
        raise ValueError(f"similarity_edges needs 1 <= k < n, got k={k}")
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1, kind="stable")[:, :k]
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = nn.ravel().astype(np.int64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    codes = np.unique(lo * n + hi)
    pairs = np.stack([codes // n, codes % n], axis=1)
    indptr, indices, _ = _edges_to_csr(n, pairs[:, 0], pairs[:, 1])
    labels = _component_labels(indptr, indices)
    num_comp = int(labels.max()) + 1
    if num_comp > 1:
        reps = np.asarray(
            [int(np.nonzero(labels == c)[0][0]) for c in range(num_comp)],
            dtype=np.int64,
        )
        bridges = np.stack(
            [np.full(num_comp - 1, reps[0]), reps[1:]], axis=1
        )
        bridges = np.stack(
            [bridges.min(axis=1), bridges.max(axis=1)], axis=1
        )
        codes = np.unique(
            np.concatenate([codes, bridges[:, 0] * n + bridges[:, 1]])
        )
        pairs = np.stack([codes // n, codes % n], axis=1)
    return pairs


def _undirected_pairs(core) -> np.ndarray:
    """Canonical non-loop undirected pairs of a CSR-core graph."""
    n = core.n
    src = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(np.asarray(core.indptr))
    )
    dst = np.asarray(core.indices, dtype=np.int64)
    keep = src < dst
    return np.stack([src[keep], dst[keep]], axis=1)


def _walk_round(**kw) -> trainer_mod.MultiRWSGDResult:
    """One round's walk-SGD epoch (the trainer's loop) as host arrays."""
    xs, _, avg_mses, nodes, hops, _ = trainer_mod._train(**kw)
    return trainer_mod.MultiRWSGDResult(
        mse=None, avg_mse=avg_mses.cpu().numpy(),
        update_nodes=nodes.cpu().numpy(), transitions=hops.cpu().numpy(),
        x_final=xs.cpu().numpy(), method=kw["method"],
    )


def _rewire(core, engine: WalkEngine, desired: np.ndarray, lips: np.ndarray):
    """Diff the current edge set against ``desired`` and apply the net
    churn; returns ``(core, engine, num_inserted, num_deleted)``."""
    current = _undirected_pairs(core)
    n = core.n
    des_codes = desired[:, 0] * n + desired[:, 1]
    cur_codes = current[:, 0] * n + current[:, 1]
    ins_codes = np.setdiff1d(des_codes, cur_codes)
    del_codes = np.setdiff1d(cur_codes, des_codes)
    if ins_codes.size or del_codes.size:
        ins = np.stack([ins_codes // n, ins_codes % n], axis=1)
        dele = np.stack([del_codes // n, del_codes % n], axis=1)
        core, churn = apply_edge_churn(
            core,
            insert=ins if ins_codes.size else None,
            delete=dele if del_codes.size else None,
        )
        # the escalated full rebuild (the max degree outgrew the engine's
        # cdf_width) needs the rows of every node, not the touched ones
        need_full = int(np.asarray(core.degrees).max()) > engine.cdf_width
        engine = engine.apply_churn(
            core, churn,
            touched_probs=mh_importance_rows_ragged(
                core, lips,
                node_ids=None if need_full else churn.touched_rows,
            ),
        )
    return core, engine, int(ins_codes.size), int(del_codes.size)


def run_dada(
    graph,
    data: RegressionData,
    *,
    rounds: int = 3,
    num_steps: int = 200,
    num_walks: int = 4,
    gamma: Optional[float] = None,
    k: int = 3,
    method: str = "mhlj",
    mhlj_params: Optional[MHLJParams] = None,
    avg_every: int = 25,
    local_steps: int = 5,
    local_lr: Optional[float] = None,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    capture: Optional[bool] = None,
    device: Union[str, torch.device] = "cuda",
) -> DadaResult:
    """Alternate walk-SGD epochs with learned collaboration-graph updates.

    Per round: one ``num_steps``-step epoch of ``num_walks`` walkers on
    the current graph (models carried over), personalization
    (:func:`personalize_models`), then, except after the last round, a
    kNN rewire (:func:`similarity_edges`) applied as one batched churn:
    ``apply_edge_churn`` diffs the edge sets, ``WalkEngine.apply_churn``
    patches the touched CDF segments, ``migrate_walk_nodes`` carries the
    walks across the graph version with the seed ``seed + 7919·(rnd+1)``.

    ``method`` is a P_IS-row law (``"mhlj"`` or ``"importance"``): the
    ragged engine carries Eq.-7 rows from ``data.lipschitz``, the rows the
    trainer builds, so round one equals a plain ``run_rw_sgd_multi`` with
    the same seed bit for bit.

    Streams: round ``rnd`` draws from a generator seeded ``seed + rnd``
    (absolute, as the reference's per-round keys), or from ``generator``
    across all rounds when given, or takes the injected block
    ``uniforms[rnd]`` (a ``(num_steps, W, 3 + r)`` tensor per round, slot
    0 the jump flag).  ``capture`` is ``run_fleet``'s comparison switch;
    each round's ``run_fleet`` captures anew on the card, so no CUDA graph
    outlives its graph version.

    ``checkpoint_path`` makes the loop crash-consistent at round
    granularity (docs/faults.md): after every round the churned engine,
    the averaged model, the migrated walk positions and the telemetry go
    into one atomic ``save_fleet_checkpoint`` file (with ``generator``'s
    state when one is given); a rerun with the same path resumes at the
    first unfinished round and gives the uninterrupted run's result bit
    for bit.  The reference's checkpoints resume here too.  A checkpoint
    of another configuration is refused.
    """
    if rounds < 1:
        raise ValueError("run_dada needs rounds >= 1")
    if method not in ("mhlj", "importance"):
        raise ValueError(
            "run_dada carries Eq.-7 P_IS rows across graph versions; "
            f"method must be 'mhlj' or 'importance', got {method!r}"
        )
    if uniforms is not None and len(uniforms) != rounds:
        raise ValueError(f"uniforms needs one block per round ({rounds}), "
                         f"got {len(uniforms)}")
    device = torch.device(device)
    core = graph.to_ragged() if hasattr(graph, "to_ragged") else (
        graph.to_csr().to_ragged()
    )
    lips = np.asarray(data.lipschitz, dtype=np.float64)
    if gamma is None:
        gamma = 0.3 / float(lips.mean())
    if local_lr is None:
        local_lr = 0.5 / float(lips.max())
    if method == "mhlj":
        params = (
            mhlj_params if mhlj_params is not None
            else MHLJParams(p_j=0.1, p_d=0.5, r=3)
        )
        p_d, r = params.p_d, params.r
    else:
        params = mhlj_params
        p_d, r = 0.5, 1  # the trainer's no-jump engine shape

    engine = WalkEngine.from_graph(
        core,
        MHLJParams(p_j=0.0, p_d=p_d, r=r),
        row_probs=mh_importance_rows_ragged(core, lips),
        layout="ragged",
        device=device,
    )
    telemetry = {
        name: np.zeros(rounds, dtype=np.float64 if "mse" in name
                       else np.int64)
        for name in _TELEMETRY
    }
    x0 = None
    v0s = None
    res = None

    def _result(x_final: np.ndarray) -> DadaResult:
        return DadaResult(**telemetry, x_final=np.asarray(x_final),
                          method=method)

    def _ckpt(step: int, nodes, x_final=None) -> None:
        extras = {
            "x0": np.asarray(x0),
            **telemetry,
            "dada_rounds": np.int64(rounds),
            "dada_seed": np.int64(seed),
            "dada_num_steps": np.int64(num_steps),
        }
        if x_final is not None:
            extras["x_final"] = np.asarray(x_final)
        if generator is not None:
            extras["generator"] = generator.get_state()
        save_fleet_checkpoint(
            checkpoint_path,
            WalkFleet(
                engine=engine,
                nodes=torch.as_tensor(np.asarray(nodes, np.int32),
                                      device=device),
                num_walks=num_walks,
            ),
            step=step,
            extras=extras,
        )

    start_round = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        fleet, step, extras = load_fleet_checkpoint(checkpoint_path,
                                                    device=device)
        saved = {
            key: int(extras[f"dada_{key}"])
            for key in ("rounds", "seed", "num_steps")
        }
        want = {"rounds": rounds, "seed": seed, "num_steps": num_steps}
        if saved != want or fleet.num_walks != num_walks:
            raise ValueError(
                f"checkpoint at {checkpoint_path!r} was written by a "
                f"different run_dada config (saved {saved} "
                f"num_walks={fleet.num_walks}, requested {want} "
                f"num_walks={num_walks}); refusing to resume"
            )
        if generator is not None:
            if "generator" not in extras:
                raise ValueError(
                    f"checkpoint at {checkpoint_path!r} holds no generator "
                    "state; resume it without generator="
                )
            generator.set_state(torch.from_numpy(extras["generator"]))
        engine = fleet.engine
        # the core graph is the engine's CSR state, rebuilt on the host in
        # the graph classes' dtypes so the rewire diff is a fresh run's
        core = RaggedCSRGraph(
            indptr=engine.indptr.cpu().numpy().astype(np.int64),
            indices=engine.indices.cpu().numpy().astype(np.int32),
            degrees=engine.degrees.cpu().numpy().astype(np.int32),
            name=core.name,
        )
        for name in _TELEMETRY:
            telemetry[name][:] = extras[name]
        x0 = np.asarray(extras["x0"])
        v0s = fleet.nodes.cpu().numpy()
        start_round = int(step)
        if start_round >= rounds:
            return _result(extras["x_final"])

    for rnd in range(start_round, rounds):
        res = _walk_round(
            method=method, graph=core, data=data, gamma=gamma,
            num_steps=num_steps, num_walks=num_walks, mhlj_params=params,
            p_j_schedule=None, loss="linear", x0=x0, v0s=v0s,
            avg_every=avg_every, seed=seed + rnd, engine=engine,
            engine_kwargs=None, law_kwargs=None,
            uniforms=None if uniforms is None else uniforms[rnd],
            device=device, generator=generator, capture=capture,
        )
        x0 = res.x_avg
        models = personalize_models(
            x0, data.features, data.targets,
            local_steps=local_steps, lr=local_lr, device=device,
        )
        preds = (models * np.asarray(data.features)).sum(axis=1)
        telemetry["round_mse"][rnd] = float(res.avg_mse[-1])
        telemetry["personalized_mse"][rnd] = float(
            ((preds - np.asarray(data.targets)) ** 2).mean()
        )
        telemetry["graph_versions"][rnd] = engine.graph_version
        if rnd == rounds - 1:
            if checkpoint_path is not None:
                _ckpt(rounds, res.update_nodes[:, -1], x_final=res.x_final)
            break
        core, engine, num_ins, num_del = _rewire(
            core, engine, similarity_edges(models, k), lips)
        telemetry["edges_inserted"][rnd] = num_ins
        telemetry["edges_deleted"][rnd] = num_del
        v0s, displaced = migrate_walk_nodes(
            res.update_nodes[:, -1], np.asarray(core.degrees),
            seed=seed + 7919 * (rnd + 1),
        )
        telemetry["walks_displaced"][rnd + 1] = int(displaced.sum())
        if checkpoint_path is not None:
            _ckpt(rnd + 1, v0s)

    return _result(res.x_final)
