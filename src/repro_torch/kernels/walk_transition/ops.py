"""Batched MHLJ transitions (multi-walk mode): thin views over
:class:`repro_torch.core.engine.WalkEngine`, as the reference's
``repro/kernels/walk_transition/ops.py``.

``mhlj_step_batched`` steps the padded tile layout (``"sparse"``, the
``walk_transition_sparse`` kernel) or, with ``layout="dense"``, the
full-table kernel; ``mhlj_step_sparse`` and ``mhlj_step_dense`` name the
two; ``mhlj_step_bucketed`` and ``mhlj_step_ragged`` step a prebuilt
bucketed or ragged engine; ``mhlj_step_oracle`` runs the plain versions
of ``kernels/walk_transition/ref.py`` on any device.  Each takes an
injected ``(W, 3 + r)`` block ``uniforms`` (slot 0 = jump flag) or a
``generator`` from which the block is drawn at ``p_j``, in place of the
reference's key; given the same block they all return the same next
nodes, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import WalkEngine, draw_uniforms, num_uniforms
from repro_torch.kernels.walk_transition.ref import walk_transition_ref

__all__ = [
    "mhlj_step_batched",
    "mhlj_step_sparse",
    "mhlj_step_dense",
    "mhlj_step_bucketed",
    "mhlj_step_ragged",
    "mhlj_step_oracle",
]


def mhlj_step_batched(
    nodes: torch.Tensor,
    row_probs: torch.Tensor,
    neighbors: torch.Tensor,
    degrees: torch.Tensor,
    *,
    p_j: float,
    p_d: float,
    r: int,
    layout: str = "sparse",
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Next nodes (W,) of one step of a padded-layout engine over the
    ``(n, max_deg)`` tables ``row_probs`` / ``neighbors``."""
    engine = WalkEngine(
        degrees=degrees, layout=layout, p_j=p_j, p_d=p_d, r=r,
        neighbors=neighbors, row_probs=row_probs,
    )
    next_nodes, _ = engine.step(nodes, uniforms=uniforms, generator=generator)
    return next_nodes


def mhlj_step_sparse(nodes, row_probs, neighbors, degrees, *, p_j, p_d, r,
                     uniforms=None, generator=None):
    """The sparse tile path, explicitly (the default of
    :func:`mhlj_step_batched`)."""
    return mhlj_step_batched(
        nodes, row_probs, neighbors, degrees, p_j=p_j, p_d=p_d, r=r,
        layout="sparse", uniforms=uniforms, generator=generator,
    )


def mhlj_step_dense(nodes, row_probs, neighbors, degrees, *, p_j, p_d, r,
                    uniforms=None, generator=None):
    """The full-table dense-layout kernel."""
    return mhlj_step_batched(
        nodes, row_probs, neighbors, degrees, p_j=p_j, p_d=p_d, r=r,
        layout="dense", uniforms=uniforms, generator=generator,
    )


def _engine_step_nodes(engine: WalkEngine, layout: str, nodes, uniforms,
                       generator) -> torch.Tensor:
    if engine.layout != layout:
        raise ValueError(
            f"engine layout must be {layout!r}, got {engine.layout!r}"
        )
    next_nodes, _ = engine.step(nodes, uniforms=uniforms, generator=generator)
    return next_nodes


def mhlj_step_bucketed(nodes, engine: WalkEngine, *, uniforms=None,
                       generator=None) -> torch.Tensor:
    """The per-degree-bucket dispatch of a prebuilt bucketed engine
    (``WalkEngine.from_graph(graph.to_bucketed(), ...)``)."""
    return _engine_step_nodes(engine, "bucketed", nodes, uniforms, generator)


def mhlj_step_ragged(nodes, engine: WalkEngine, *, uniforms=None,
                     generator=None) -> torch.Tensor:
    """The fused true-degree kernel of a prebuilt ragged engine
    (``WalkEngine.from_graph(graph, ..., layout="ragged")``)."""
    return _engine_step_nodes(engine, "ragged", nodes, uniforms, generator)


def mhlj_step_oracle(nodes, row_probs, neighbors, degrees, *, p_j, p_d, r,
                     uniforms=None, generator=None) -> torch.Tensor:
    """The plain version (``ref.walk_transition_ref``) on the tables'
    device, whatever it is: the oracle the kernels are held against."""
    nodes = torch.as_tensor(nodes, dtype=torch.int32, device=degrees.device)
    shape = (nodes.shape[0], num_uniforms(r))
    if uniforms is None:
        if generator is None:
            raise ValueError("pass uniforms= (injected block) or generator=")
        uniforms = draw_uniforms(shape[0], r, p_j, generator, degrees.device)
    elif tuple(uniforms.shape) != shape:
        raise ValueError(
            f"uniform block must have shape {shape}, got "
            f"{tuple(uniforms.shape)}"
        )
    next_nodes, _ = walk_transition_ref(
        nodes, row_probs, neighbors, degrees,
        uniforms.to(device=degrees.device, dtype=torch.float32),
        p_d=p_d, r=r,
    )
    return next_nodes
