"""Carry the JAX package's state into the port.

The port reads the reference's state as plain numpy arrays — it imports
nothing of the JAX package — and rebuilds its own objects on the
requested device:

* :func:`from_reference_state` — a walk engine (and fleet) from a
  reference engine's fields.  Parity tests hand the reference's exact row
  state (padded rows, per-bucket rows, or the per-edge CDF) to the port,
  so a last-ulp difference between two row builders cannot hide or fake a
  sampler fault;
* :func:`fault_model_from_reference` / :func:`fault_state_from_reference`
  — a ``FaultModel`` and a ``FaultState`` from the numpy leaves of the
  reference's (the ``extras`` a reference checkpoint carries);
* :func:`model_from_reference_params` — a language model from the JAX
  package's params pytree, so both packages run on the same weights;
  :func:`reference_params_of` is its inverse (a port model's weights as
  that pytree, e.g. to start runs on two devices from one model).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.engine import LAYOUTS, WalkEngine
from repro_torch.core.faults import FaultModel, FaultState
from repro_torch.walk_sgd.fleet import WalkFleet

__all__ = ["from_reference_state", "fault_model_from_reference",
           "fault_state_from_reference", "model_from_reference_params",
           "reference_params_of"]


def from_reference_state(
    *,
    degrees,
    p_d: float,
    r: int,
    layout: str = "ragged",
    p_j: float = 0.0,
    indptr=None,
    indices=None,
    edge_cdf=None,
    max_degree: Optional[int] = None,
    cdf_width: Optional[int] = None,
    graph_version: int = 0,
    neighbors=None,
    row_probs=None,
    node_bucket=None,
    node_slot=None,
    bucket_neighbors: Optional[Sequence] = None,
    bucket_rows: Optional[Sequence] = None,
    bucket_share: Optional[Sequence[float]] = None,
    compact: bool = True,
    capacity_factor: float = 1.25,
    nodes=None,
    models=None,
    avg_every: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> tuple:
    """Port engine, fleet and models from the reference's numpy state.

    The keyword arguments are a reference ``WalkEngine``'s fields of the
    same names, for its ``layout``:

    * ``"ragged"``: ``indptr``/``indices``/``edge_cdf``/``max_degree``,
      ``cdf_width`` (checked against ``max_degree`` and kept: the sticky
      width of a churned engine) and ``graph_version``, kept as they are
      (the stored ``edge_cdf`` too, never rebuilt): a CDF that decreases
      inside a row is refused;
    * ``"sparse"``/``"dense"``: ``neighbors`` and ``row_probs`` (None for
      live rows);
    * ``"bucketed"``: ``indptr``/``indices``, ``node_bucket``/``node_slot``,
      ``bucket_neighbors``, ``bucket_rows`` (None for live rows),
      ``bucket_share``, ``compact`` and ``capacity_factor``.

    ``nodes`` are the fleet's (W,) positions and ``models`` its (W, dim)
    per-walker models.  ``graph_version`` is carried on every layout.
    Returns ``(engine, fleet, models)`` — ``fleet`` is None without
    ``nodes``, ``models`` None without models.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    device = torch.device(device)

    def i32(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x).astype(np.int32), device=device
        )

    def f32(x):  # an own, writable copy
        return None if x is None else torch.as_tensor(
            np.array(x, dtype=np.float32), device=device
        )

    fields = dict(degrees=i32(degrees), layout=layout, p_j=float(p_j),
                  p_d=float(p_d), r=int(r), graph_version=int(graph_version))
    if layout == "ragged":
        if edge_cdf is None or indices is None or max_degree is None:
            raise ValueError(
                "the ragged layout needs indices, edge_cdf and max_degree"
            )
        if np.shape(edge_cdf) != np.shape(indices):
            raise ValueError("edge_cdf and indices must both be (nnz,)")
        if cdf_width is not None and cdf_width < max_degree:
            raise ValueError("cdf_width must cover max_degree")
        cdf = np.asarray(edge_cdf, np.float32)
        inner = np.ones(max(cdf.size - 1, 0), bool)  # pairs inside a row
        ends = np.asarray(indptr)[1:-1]
        inner[ends[(ends > 0) & (ends < cdf.size)] - 1] = False
        if np.any(np.diff(cdf)[inner] < 0):
            raise ValueError(
                "edge_cdf decreases inside a row; the ragged kernel's search "
                "needs every row's CDF non-decreasing"
            )
        fields.update(
            indptr=i32(indptr), indices=i32(indices), edge_cdf=f32(edge_cdf),
            max_degree=int(max_degree),
            cdf_width=int(max_degree if cdf_width is None else cdf_width),
        )
    elif layout == "bucketed":
        if bucket_neighbors is None:
            raise ValueError("the bucketed layout needs bucket_neighbors")
        fields.update(
            indptr=i32(indptr), indices=i32(indices),
            node_bucket=i32(node_bucket), node_slot=i32(node_slot),
            bucket_neighbors=tuple(i32(b) for b in bucket_neighbors),
            bucket_rows=None if bucket_rows is None
            else tuple(f32(b) for b in bucket_rows),
            bucket_share=None if bucket_share is None
            else tuple(float(s) for s in bucket_share),
            compact=bool(compact), capacity_factor=float(capacity_factor),
        )
    else:
        if neighbors is None:
            raise ValueError(f"the {layout} layout needs neighbors")
        if row_probs is not None and np.shape(row_probs) != np.shape(neighbors):
            raise ValueError("row_probs and neighbors must both be (n, max_deg)")
        fields.update(neighbors=i32(neighbors), row_probs=f32(row_probs))
    engine = WalkEngine(**fields)
    fleet = None
    if nodes is not None:
        nodes = np.asarray(nodes, np.int32)
        fleet = WalkFleet.create(
            engine, int(nodes.shape[0]), v0s=nodes, avg_every=avg_every
        )
    if models is not None:
        models = torch.as_tensor(np.asarray(models, np.float32), device=device)
    return engine, fleet, models


def fault_model_from_reference(
    *,
    crash_rate: float = 0.0,
    recovery_rate: float = 0.0,
    down_at=None,
    up_at=None,
    edge_down_at=None,
    edge_up_at=None,
    patience: int = 3,
    rescue: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> FaultModel:
    """The port's ``FaultModel`` from a reference model's fields (its
    scripted windows as numpy arrays), the windows int32 on ``device``."""
    return FaultModel(
        crash_rate=float(crash_rate), recovery_rate=float(recovery_rate),
        down_at=down_at, up_at=up_at, edge_down_at=edge_down_at,
        edge_up_at=edge_up_at, patience=int(patience), rescue=bool(rescue),
    ).to(device)


def fault_state_from_reference(
    *, live, blocked, t, device: Union[str, torch.device] = "cuda"
) -> FaultState:
    """The port's ``FaultState`` from a reference state's leaves: ``live``
    (n,) bool, ``blocked`` (W,) int32 and the 0-d int32 tick ``t``."""
    return FaultState(
        live=torch.as_tensor(np.asarray(live, bool), device=device),
        blocked=torch.as_tensor(np.atleast_1d(np.asarray(blocked, np.int32)),
                                device=device),
        t=torch.as_tensor(np.asarray(t, np.int32).reshape(()), device=device),
    )


def _flatten(tree, prefix: str = "") -> dict:
    """``{"a/0/b": leaf}`` of nested dicts and lists of arrays (the
    reference's key paths)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; numpy's bfloat16 (from
    ml_dtypes, which JAX arrays convert to, or the two-byte records a
    checkpoint stores) is carried bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def model_from_reference_params(cfg, params, *, device: Union[str, torch.device] = "cuda"):
    """The port's model for ``cfg`` holding the JAX package's ``params``.

    ``params`` is the reference model's params pytree (nested dicts and
    lists of numpy arrays, or arrays numpy can read), carried leaf by leaf
    in the port's :func:`~repro_torch.models.base.param_tree` structure: a
    stacked leaf (``layers/attn/wq`` of shape ``(L, ...)``; the hybrid's
    ``periods/mamba/mixer/in_proj`` of shape ``(P, 7, ...)``) fills the
    per-layer tensors it stacks, a list entry (``dense_layers/0/...``) its
    layer's.  The model dtype is the embedding table's; every leaf keeps
    its dtype (the norm scales, the router, ``a_log``, ``d_skip`` and
    ``dt_bias`` are float32).  Raises ``ValueError`` on a missing, extra,
    mis-shaped or mis-typed leaf.
    """
    from repro_torch.models.base import leaf_shape, param_tree
    from repro_torch.models.factory import build_model
    from repro_torch.optim.base import leaves

    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    if "embedding/table" not in flat:
        raise ValueError("params has no embedding/table leaf")
    dtype = _to_torch(flat["embedding/table"][:1]).dtype
    model = build_model(cfg, dtype, device=torch.device(device))
    tree = param_tree(model)
    missing = sorted(set(tree) - set(flat))
    extra = sorted(set(flat) - set(tree))
    if missing or extra:
        raise ValueError(f"params do not match {cfg.name}: missing {missing}, "
                         f"extra {extra}")
    with torch.no_grad():
        for path, leaf in tree.items():
            t = _to_torch(flat[path])
            want = leaf_shape(leaf)
            dsts = leaves({path: leaf})
            if tuple(t.shape) != want or t.dtype != dsts[0].dtype:
                raise ValueError(
                    f"leaf {path}: {tuple(t.shape)} {t.dtype}, the port holds "
                    f"{want} {dsts[0].dtype}"
                )
            for dst, src in zip(dsts, t.reshape(-1, *dsts[0].shape)):
                dst.copy_(src)
    return model


def reference_params_of(model) -> dict:
    """The port model's weights as the JAX package's params pytree: nested
    dicts of numpy arrays, the per-layer leaves stacked ``(L, ...)`` (or
    ``(P, n, ...)``), a list where the reference has one
    (``dense_layers``); the inverse of :func:`model_from_reference_params`."""
    from repro_torch.models.base import param_tree
    from repro_torch.utils.checkpoint import flatten_with_paths

    out: dict = {}
    for path, arr in flatten_with_paths(param_tree(model)).items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr

    def listed(node):  # dicts keyed 0..n-1 are the reference's lists
        if not isinstance(node, dict):
            return node
        node = {k: listed(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listed(out)
