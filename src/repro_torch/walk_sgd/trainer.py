"""Random-walk SGD trainer (paper Algorithm 1 + baselines) on the port.

Per iteration each walker applies the importance-weighted stochastic
gradient of the visited node's local loss (Eq. 12) and the walk advances
by the chosen method's chain law:

  method='uniform'     MH targeting uniform pi, plain gradient (w=1)
  method='importance'  MH-IS (Eq. 7), weighted gradient w(v)=L_bar/L_v
  method='mhlj'        Algorithm 1 (MH-IS + Lévy jumps), weighted gradient
  method='simple'      simple random walk, plain gradient (degree-biased)
  method='heterogeneity'  MH targeting the gradient-heterogeneity-optimized
                       pi of ``core.heterogeneity`` (arXiv:2204.06477),
                       weighted gradient w ∝ 1/pi
  method='private'     private weighted walk on Gamma-noised weights
                       (arXiv:2009.01790), weighted gradient w ∝ 1/ŵ

Non-jump methods are the engine at p_J = 0.  The graph class picks the
rows and the engine layout, as in the reference: a dense ``Graph`` gets
the dense law gathered onto its padded rows and a ``CSRGraph`` the padded
local rows (both the ``sparse`` layout), a ``BucketedCSRGraph`` per-bucket
rows (``bucketed``), a ``RaggedCSRGraph`` flat per-edge rows
(``ragged``); ``engine_kwargs`` may ask for another layout.
:func:`repro_torch.walk_sgd.fleet.run_fleet` is the one training loop —
:func:`run_rw_sgd` is its W=1 case.  ``law_kwargs`` parameterizes the
heterogeneity and private laws (see :func:`_setup_method`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import heterogeneity as het_mod
from repro_torch.core import transition as trans_mod
from repro_torch.core.engine import WalkEngine
from repro_torch.core.transition import MHLJParams
from repro_torch.data.synthetic import RegressionData
from repro_torch.models import regression as reg
from repro_torch.walk_sgd.fleet import WalkFleet, run_fleet

__all__ = ["METHODS", "RWSGDResult", "MultiRWSGDResult", "run_rw_sgd",
           "run_rw_sgd_multi"]

METHODS = (
    "uniform", "importance", "mhlj", "simple", "heterogeneity", "private"
)
_GRADS = {"linear": reg.linear_grad, "logistic": reg.logistic_grad}


@dataclasses.dataclass
class RWSGDResult:
    mse: np.ndarray  # (T+1,) objective trace (paper Fig-3 metric)
    update_nodes: np.ndarray  # (T,)
    transitions: np.ndarray  # (T,) physical hops per update (Remark 1)
    x_final: np.ndarray
    method: str

    @property
    def transitions_per_update(self) -> float:
        return float(self.transitions.mean())


@dataclasses.dataclass
class MultiRWSGDResult:
    """W parallel walks trained in one loop off one batched engine step."""

    mse: np.ndarray  # (W, T+1) per-walk objective traces
    avg_mse: np.ndarray  # (T+1,) objective of the walk-averaged model
    update_nodes: np.ndarray  # (W, T) node holding each model at update t
    transitions: np.ndarray  # (W, T) physical hops (Remark 1)
    x_final: np.ndarray  # (W, dim) per-walk models
    method: str

    @property
    def x_avg(self) -> np.ndarray:
        return self.x_final.mean(axis=0)

    @property
    def transitions_per_update(self) -> float:
        return float(self.transitions.mean())


def _setup_method(
    method: str,
    graph,
    data: RegressionData,
    mhlj_params: Optional[MHLJParams],
    p_j_schedule: Optional[np.ndarray],
    num_steps: int,
    law_kwargs: Optional[dict] = None,
):
    """Method dispatch: rows, weights, p_J schedule and (p_d, r).

    Returns ``(row_probs, weights, p_j_sched, p_d, r, use_weights)``, as
    numpy: ``row_probs`` by graph class — the dense law gathered onto the
    padded rows (``Graph``), padded local rows (``CSRGraph``), a tuple of
    per-bucket rows (``BucketedCSRGraph``) or flat (nnz,) rows
    (``RaggedCSRGraph``) — ``weights`` (n,) float32, ``mean(target) /
    target`` for the chain's target weights (L_v but for the two laws
    below), and ``p_j_sched`` (num_steps,) float32.

    ``law_kwargs`` parameterizes the chain law:

    * ``method="heterogeneity"`` — ``pi``, a precomputed (n,) target; when
      absent it is measured and optimized from ``data`` by
      ``core.heterogeneity.heterogeneity_pi``, whose ``floor`` /
      ``num_probes`` / ``probe_scale`` / ``seed`` / ``steps`` pass through
      (its dissimilarity matrix is dense (n, n) float64, so pass ``pi`` on
      large graphs);
    * ``method="private"`` — ``gamma`` (the privacy knob, default 0.1) and
      ``noise_seed`` (the Gamma noise's seed, default 0).
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}")
    if law_kwargs and method not in ("heterogeneity", "private"):
        raise ValueError(f"law_kwargs is not consumed by method={method!r}")
    lips = data.lipschitz
    dense = getattr(graph, "adj", None) is not None
    bucketed = hasattr(graph, "buckets")
    ragged = not (dense or bucketed) and not hasattr(graph, "neighbors")

    def pick(dense_p, padded_rows, bucket_rows, ragged_rows):
        if dense:
            return trans_mod.row_probs_padded(dense_p(), graph)
        if bucketed:
            return bucket_rows()
        return ragged_rows() if ragged else padded_rows()

    def law(name, *args, **kw):
        """``pick`` over the four row functions ``{name}_mh``, ``_rows``,
        ``_rows_bucketed`` and ``_rows_ragged`` of one law."""
        return pick(*(
            functools.partial(getattr(trans_mod, name + sfx), graph, *args,
                              **kw)
            for sfx in ("_mh", "_rows", "_rows_bucketed", "_rows_ragged")
        ))

    use_jumps = method == "mhlj"
    use_weights = method not in ("uniform", "simple")
    target = np.asarray(lips, dtype=np.float64)
    if method == "uniform":
        rows = pick(
            lambda: trans_mod.mh_uniform(graph),
            lambda: trans_mod.mh_uniform_rows(graph),
            lambda: trans_mod.mh_uniform_rows_bucketed(graph),
            lambda: trans_mod.mh_uniform_rows_ragged(graph),
        )
    elif method == "simple":
        rows = pick(
            lambda: trans_mod.simple_rw(graph),
            lambda: trans_mod.simple_rw_rows(graph),
            lambda: trans_mod.simple_rw_rows_bucketed(graph),
            lambda: trans_mod.simple_rw_rows_ragged(graph),
        )
    elif method == "heterogeneity":
        kw = dict(law_kwargs or {})
        pi = kw.pop("pi", None)
        if pi is None:
            pi = het_mod.heterogeneity_pi(data, **kw)
        elif kw:
            raise ValueError(
                f"unused heterogeneity law_kwargs besides pi: {sorted(kw)}"
            )
        target = np.asarray(pi, dtype=np.float64)
        rows = law("heterogeneity", target)
    elif method == "private":
        kw = dict(law_kwargs or {})
        priv_gamma = float(kw.pop("gamma", 0.1))
        noise_seed = int(kw.pop("noise_seed", 0))
        if kw:
            raise ValueError(f"unknown private-walk law_kwargs: {sorted(kw)}")
        rows = law("private_weighted", lips, priv_gamma, seed=noise_seed)
        # the update sees only the noised weights (the chain's target)
        target = trans_mod.private_weights(target, priv_gamma,
                                           seed=noise_seed)
    else:  # importance / mhlj share the P_IS rows; jumps sampled live
        rows = pick(
            lambda: trans_mod.mh_importance(graph, lips),
            lambda: trans_mod.mh_importance_rows(graph, lips),
            lambda: trans_mod.mh_importance_rows_bucketed(graph, lips),
            lambda: trans_mod.mh_importance_rows_ragged(graph, lips),
        )
    weights = (target.mean() / target).astype(np.float32)
    if use_jumps:
        mhlj_params = mhlj_params or MHLJParams()
        mhlj_params.validate()
        if p_j_schedule is not None:
            p_j_sched = np.asarray(p_j_schedule, np.float32)
            if p_j_sched.shape != (num_steps,):
                raise ValueError("p_j_schedule must have shape (num_steps,)")
        else:
            p_j_sched = np.full((num_steps,), mhlj_params.p_j, np.float32)
        p_d, r = mhlj_params.p_d, mhlj_params.r
    else:
        p_j_sched = np.zeros((num_steps,), np.float32)
        p_d, r = 0.5, 1  # the engine never jumps at p_J = 0
    return rows, weights, p_j_sched, p_d, r, use_weights


def _build_engine(graph, p_d, r, row_probs, engine_kwargs, device):
    """Engine for a training run; ``engine_kwargs`` forwards ``layout``,
    ``compact``, ``capacity_factor`` and ``bucket_factor`` to
    :meth:`WalkEngine.from_graph`."""
    return WalkEngine.from_graph(
        graph, MHLJParams(p_j=0.0, p_d=p_d, r=r), row_probs=row_probs,
        device=device, **dict(engine_kwargs or {}),
    )


def _train(
    method, graph, data, gamma, num_steps, num_walks, *, mhlj_params,
    p_j_schedule, loss, x0, v0s, avg_every, seed, engine, engine_kwargs,
    law_kwargs, uniforms, device, generator=None, capture=None, mesh=None,
):
    """One training run through :func:`run_fleet`; returns its outputs.
    Without ``uniforms`` the walks draw from ``generator``, by default a
    new one seeded with ``seed``; ``capture`` is ``run_fleet``'s."""
    rows, weights, p_j_sched, p_d, r, use_weights = _setup_method(
        method, graph, data, mhlj_params, p_j_schedule, num_steps, law_kwargs
    )
    if engine is None:
        engine = _build_engine(graph, p_d, r, rows, engine_kwargs, device)
    elif engine_kwargs is not None:
        raise ValueError(
            "pass either a pre-built engine or engine_kwargs, not both"
        )
    elif (engine.p_d, engine.r) != (p_d, r):
        raise ValueError(
            f"injected engine has (p_d, r)=({engine.p_d}, {engine.r}); "
            f"method {method!r} needs ({p_d}, {r})"
        )
    dev = engine.device
    fleet = WalkFleet.create(
        engine, num_walks, v0s=v0s, seed=seed, avg_every=avg_every
    )
    if loss not in _GRADS:
        raise ValueError(f"loss must be one of {tuple(_GRADS)}")
    x0 = (
        torch.zeros(data.dim, device=dev)
        if x0 is None
        else torch.as_tensor(np.asarray(x0, np.float32), device=dev)
    )
    if uniforms is not None:
        generator = None
    elif generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return run_fleet(
        x0[None].expand(num_walks, data.dim).clone(),
        torch.as_tensor(np.asarray(data.features, np.float32), device=dev),
        torch.as_tensor(np.asarray(data.targets, np.float32), device=dev),
        torch.as_tensor(weights, device=dev),
        fleet,
        num_steps,
        gamma,
        torch.as_tensor(p_j_sched, device=dev),
        use_weights,
        _GRADS[loss],
        uniforms=uniforms,
        generator=generator,
        # only when asked: callers that wrap run_fleet set them themselves
        **({} if capture is None else {"capture": capture}),
        **({} if mesh is None else {"mesh": mesh}),
    )


def run_rw_sgd(
    method: str,
    graph,
    data: RegressionData,
    gamma: float,
    num_steps: int,
    *,
    mhlj_params: Optional[MHLJParams] = None,
    p_j_schedule: Optional[np.ndarray] = None,
    loss: str = "linear",
    x0: Optional[np.ndarray] = None,
    v0: int = 0,
    seed: int = 0,
    engine: Optional[WalkEngine] = None,
    engine_kwargs: Optional[dict] = None,
    law_kwargs: Optional[dict] = None,
    uniforms: Optional[torch.Tensor] = None,
    device: Union[str, torch.device] = "cuda",
) -> RWSGDResult:
    """One RW-SGD training from ``v0``; returns the Fig-3 style MSE trace.

    The W=1 case of :func:`run_rw_sgd_multi`.  ``uniforms`` injects a
    ``(T, 1, 3 + r)`` block (slot 0 = jump flag); otherwise the walk draws
    from a ``torch.Generator`` seeded with ``seed``.  ``engine`` injects a
    pre-built engine (e.g. from ``repro_torch.interop``) whose ``(p_d, r)``
    must match the method's; ``engine_kwargs`` instead forwards ``layout``,
    ``compact``, ``capacity_factor`` or ``bucket_factor`` to
    :meth:`WalkEngine.from_graph`; ``law_kwargs`` parameterizes the
    heterogeneity and private laws (:func:`_setup_method`).
    """
    xs, mses, _, nodes, hops, _ = _train(
        method, graph, data, gamma, num_steps, 1, mhlj_params=mhlj_params,
        p_j_schedule=p_j_schedule, loss=loss, x0=x0, v0s=[v0], avg_every=0,
        seed=seed, engine=engine, engine_kwargs=engine_kwargs,
        law_kwargs=law_kwargs, uniforms=uniforms, device=device,
    )
    return RWSGDResult(
        mse=mses[0].cpu().numpy(),
        update_nodes=nodes[0].cpu().numpy(),
        transitions=hops[0].cpu().numpy(),
        x_final=xs[0].cpu().numpy(),
        method=method,
    )


def run_rw_sgd_multi(
    method: str,
    graph,
    data: RegressionData,
    gamma: float,
    num_steps: int,
    num_walks: int,
    *,
    mhlj_params: Optional[MHLJParams] = None,
    p_j_schedule: Optional[np.ndarray] = None,
    loss: str = "linear",
    x0: Optional[np.ndarray] = None,
    v0s: Optional[Sequence[int]] = None,
    avg_every: int = 0,
    seed: int = 0,
    engine: Optional[WalkEngine] = None,
    engine_kwargs: Optional[dict] = None,
    law_kwargs: Optional[dict] = None,
    uniforms: Optional[torch.Tensor] = None,
    device: Union[str, torch.device] = "cuda",
    mesh=None,
) -> MultiRWSGDResult:
    """W parallel RW-SGD trainings sharing one batched engine transition.

    Start nodes come from ``sample_initial_nodes(n, W, seed=seed)`` unless
    ``v0s`` is given; ``avg_every > 0`` averages the models across walks
    every that many updates.  ``uniforms`` injects a ``(T, W, 3 + r)``
    block, ``engine`` a pre-built engine and ``engine_kwargs`` engine
    options, and ``law_kwargs`` the law, as in :func:`run_rw_sgd`.

    ``mesh`` (``repro_torch.launch.mesh.make_walker_mesh``; every rank
    calls with the same arguments) shards the walks and their models over
    the walker axis, the graph replicated on every rank, the average an
    all-reduce (``fleet.run_fleet(mesh=)``); each rank returns the whole
    result.  The walks equal ``mesh=None``'s bit for bit, and on one rank
    every field does.
    """
    xs, mses, avg_mses, nodes, hops, _ = _train(
        method, graph, data, gamma, num_steps, num_walks,
        mhlj_params=mhlj_params, p_j_schedule=p_j_schedule, loss=loss, x0=x0,
        v0s=v0s, avg_every=avg_every, seed=seed, engine=engine,
        engine_kwargs=engine_kwargs, law_kwargs=law_kwargs, uniforms=uniforms,
        device=device, mesh=mesh,
    )
    return MultiRWSGDResult(
        mse=mses.cpu().numpy(),
        avg_mse=avg_mses.cpu().numpy(),
        update_nodes=nodes.cpu().numpy(),
        transitions=hops.cpu().numpy(),
        x_final=xs.cpu().numpy(),
        method=method,
    )
