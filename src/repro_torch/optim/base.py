"""Minimal gradient-transformation library, the JAX package's
``repro.optim`` in PyTorch.

A ``GradientTransformation`` is an (init, update) pair:
    init(params)                      -> state
    update(grads, state, params)      -> (updates, state)
Updates are *added* to params: ``params + updates`` (the transformations
produce the final negative-lr-scaled step).

``params``, ``grads`` and ``updates`` are the reference's pytree
(``repro_torch.models.base.param_tree``): a dict ``{path: leaf}`` in the
reference's leaf order, where a leaf is a tensor or, for a per-layer leaf,
the tuple of its L layer tensors (the reference's stacked ``(L, ...)``
leaf; the hybrid's stacks in stacks are tuples of such tuples).  Elementwise transformations and global sums do not see that
structure; adafactor, which factors whole leaves, does.

``update`` runs under ``torch.no_grad`` and changes ``state``'s tensors in
place (the returned state is the same object), so a state whose tensors
are views into a walker fleet's ``(W, ...)`` storage updates that storage.
``updates`` are new tensors.  The step counters are 0-d int32 tensors on
the parameters' device, and a schedule's learning rate a 0-d float32
tensor there: a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["GradientTransformation", "OptState", "chain", "identity",
           "apply_updates", "global_norm", "leaves", "unflatten", "tree_map",
           "zeros_count"]

OptState = Any
Params = dict
Updates = dict


def _flat(leaf) -> list:
    if isinstance(leaf, tuple):
        return [t for piece in leaf for t in _flat(piece)]
    return [leaf]


def leaves(tree: dict) -> list:
    """Every tensor of ``tree`` in leaf order, a per-layer leaf's tensors
    in layer order (a stack in a stack: row-major)."""
    out = []
    for leaf in tree.values():
        out.extend(_flat(leaf))
    return out


def unflatten(like: dict, flat) -> dict:
    """``flat`` (tensors in :func:`leaves` order) in ``like``'s structure."""
    it = iter(flat)

    def build(leaf):
        if isinstance(leaf, tuple):
            return tuple(build(piece) for piece in leaf)
        return next(it)

    out = {path: build(leaf) for path, leaf in like.items()}
    if next(it, None) is not None:
        raise ValueError("more tensors than the tree has leaves")
    return out


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the tensors of ``tree`` (and of ``rest``, in step)."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                  *map(leaves, rest))])


def zeros_count(params: dict) -> torch.Tensor:
    """A step counter: 0-d int32 zero on the parameters' device."""
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Params], OptState]
    update: Callable[[Updates, OptState, Params], tuple]


class ChainState(NamedTuple):
    inner: tuple


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return ChainState(tuple(t.init(params) for t in transforms))

    def update(grads, state, params=None):
        new_states = []
        updates = grads
        for t, s in zip(transforms, state.inner):
            updates, s = t.update(updates, s, params)
            new_states.append(s)
        return updates, ChainState(tuple(new_states))

    return GradientTransformation(init, update)


def identity() -> GradientTransformation:
    return GradientTransformation(
        init=lambda params: (),
        update=lambda g, s, p=None: (g, s),
    )


@torch.no_grad()
def apply_updates(params: Params, updates: Updates) -> Params:
    """``params + updates`` (each update cast to its parameter's dtype),
    written into ``params``' tensors in place; returns ``params``."""
    ps = leaves(params)
    torch._foreach_add_(ps, [u.to(p.dtype) for p, u in
                             zip(ps, leaves(updates))])
    return params


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    """``sqrt(Σ x²)`` over every tensor of ``tree``, in float32: a 0-d
    tensor."""
    norms = torch._foreach_norm(leaves(tree), 2, dtype=torch.float32)
    return torch.stack(norms).square().sum().sqrt()
