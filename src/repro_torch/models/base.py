"""Model protocol shared by the port's language models.

A :class:`Model` is an ``nn.Module`` holding its parameters under the JAX
package's pytree names (``embedding.table``, ``layers.{i}.attn.wq``, ...,
so ``interop.model_from_reference_params`` carries weights one leaf at a
time) with the JAX ``Model`` bundle's entry points as methods:

  apply(batch) -> final hidden states (B, S, D)          under no_grad
  loss(batch) -> (scalar cross-entropy, aux)             under grad
  loss_with(params, batch) -> the same on other weights  under grad
  init_cache(batch_size, cache_len) -> decode cache
  decode_step(tokens, cache, pos) -> (logits (B, V) float32, cache)
  input_specs(shape, for_decode=False) -> {name: (shape, dtype)}

The training path sees the weights as the reference's pytree
(:func:`param_tree`): one leaf per reference path, in the reference's leaf
order, a leaf of a :class:`Stack` being the tuple of its layers' tensors (the
reference's ``(L, ...)`` stacked leaf; a stack in a stack, the hybrid's,
a tuple of such tuples).  The optimizers
(``repro_torch.optim``) and the checkpoints work on that structure.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from repro_torch.sharding.constraints import whole_dim

__all__ = ["Model", "Stack", "stack_paths", "tree_of", "named_of", "param_tree",
           "leaf_shape", "stack_leaf", "unstack_like", "stack_axes"]

Leaf = Union[torch.Tensor, tuple]


class Stack(nn.ModuleList):
    """Layers the reference stacks into one leaf per path: a parameter of
    the i-th layer is row i of the reference's ``(L, ...)`` leaf
    (``layers.3.attn.wq`` is row 3 of ``layers/attn/wq``).  A plain
    ``nn.ModuleList`` is one of the reference's Python lists
    (``dense_layers.0.attn.wq`` is leaf ``dense_layers/0/attn/wq``).  A
    stack in a stack's layers (the hybrid's periods) adds an axis:
    ``periods/mamba/mixer/in_proj`` is (P, 7, ...), the nested tuple of P
    tuples of 7 tensors."""


def _path_key(path: str) -> tuple:
    """``jax.tree_util``'s order: dict keys sorted, list indices in order."""
    return tuple(int(p) if p.isdigit() else p for p in path.split("/"))


def _split(name: str, stacks: frozenset) -> tuple:
    """A port name -> (the reference's path, its stack indices): an index
    right after a :class:`Stack` is a stack index, any other is a path
    component."""
    path, idx = [], []
    for p in name.split("."):
        if p.isdigit() and "/".join(path) in stacks:
            idx.append(int(p))
        else:
            path.append(p)
    return "/".join(path), tuple(idx)


def stack_paths(model: nn.Module) -> frozenset:
    """The reference paths of ``model``'s :class:`Stack` s: ``{"layers"}``,
    the hybrid's ``{"periods", "periods/mamba", "periods/moe",
    "periods/mlp"}``."""
    out: set = set()
    for name, m in model.named_modules():  # a stack before the stacks in it
        if isinstance(m, Stack):
            out.add(_split(name, frozenset(out))[0])
    return frozenset(out)


def _nest(pieces: dict, depth: int, path: str):
    """``{(i, j, ...): tensor}`` -> nested tuples, checking every index."""
    firsts = sorted({key[0] for key in pieces})
    if firsts != list(range(len(firsts))):
        raise ValueError(f"leaf {path} lacks layers: {firsts}")
    if depth == 1:
        return tuple(pieces[(i,)] for i in firsts)
    return tuple(_nest({key[1:]: t for key, t in pieces.items() if key[0] == i},
                       depth - 1, path) for i in firsts)


def tree_of(named: dict, stacks: frozenset) -> dict:
    """``{port name: tensor}`` -> the reference's pytree ``{path: leaf}``,
    ``stacks`` being the model's :func:`stack_paths`:
    ``layers.{i}.attn.wq`` is piece i of leaf ``layers/attn/wq``,
    ``periods.{p}.mamba.{j}.mixer.in_proj`` piece (p, j) of
    ``periods/mamba/mixer/in_proj``, any other ``a.0.b`` is leaf ``a/0/b``;
    leaves sorted as ``jax.tree_util`` orders the reference's nested dicts
    and lists."""
    plain, stacked = {}, {}
    for name, t in named.items():
        path, idx = _split(name, stacks)
        if idx:
            stacked.setdefault(path, {})[idx] = t
        else:
            plain[path] = t
    for path, pieces in stacked.items():
        depths = {len(key) for key in pieces}
        if len(depths) != 1:
            raise ValueError(f"leaf {path} mixes stack depths {depths}")
        plain[path] = _nest(pieces, depths.pop(), path)
    return {p: plain[p] for p in sorted(plain, key=_path_key)}


def stack_axes(path: str, stacks: frozenset) -> list:
    """The positions of ``path``'s components after which :func:`tree_of`
    removed a stack index (``[0]``: one stack; ``[0, 1]``: the hybrid's
    stacks in its periods; ``[]``: not a stacked leaf)."""
    parts = path.split("/")
    return [i for i in range(len(parts)) if "/".join(parts[:i + 1]) in stacks]


def named_of(tree: dict, stacks: frozenset) -> dict:
    """The inverse of :func:`tree_of`."""
    out = {}

    def put(parts, at, leaf, idx):
        if isinstance(leaf, tuple):
            for i, t in enumerate(leaf):
                put(parts, at, t, idx + (i,))
            return
        names = []
        for pos, p in enumerate(parts):
            names.append(p)
            if pos in at:
                names.append(str(idx[at.index(pos)]))
        out[".".join(names)] = leaf

    for path, leaf in tree.items():
        at = stack_axes(path, stacks) if isinstance(leaf, tuple) else []
        put(path.split("/"), at, leaf, ())
    return out


def param_tree(model: nn.Module) -> dict:
    """The model's own parameters as the reference's pytree (aliases: an
    in-place update of a leaf updates the model)."""
    return tree_of(dict(model.named_parameters()), stack_paths(model))


def leaf_shape(leaf: Leaf) -> tuple:
    """The reference's shape of ``leaf``: ``(L, *piece)`` for a per-layer
    leaf, ``(P, n, *piece)`` for a stack in a stack."""
    if isinstance(leaf, tuple):
        return (len(leaf),) + leaf_shape(leaf[0])
    return tuple(leaf.shape)


def stack_leaf(leaf: Leaf) -> torch.Tensor:
    """A leaf as the reference's one tensor (nested tuples stacked)."""
    if isinstance(leaf, tuple):
        return torch.stack([stack_leaf(t) for t in leaf])
    return leaf


def unstack_like(t: torch.Tensor, like: Leaf) -> Leaf:
    """``t`` (of :func:`leaf_shape` ``like``) in ``like``'s tuple structure
    (views of ``t``)."""
    if isinstance(like, tuple):
        return tuple(unstack_like(piece, sub) for piece, sub in zip(
            whole_dim(t, 0).unbind(0), like))
    return t


class Model(nn.Module):
    """Base of the port's LMs: ``cfg`` (an ``ArchConfig``) and the entry
    points above.  ``cfg.use_kernels`` and ``cfg.remat`` are read at call
    time, so switching the config switches the path on the same weights.
    ``forward`` is the training objective, :meth:`loss`."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embedding.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embedding.table.dtype

    def forward(self, batch: dict) -> tuple:
        return self.loss(batch)

    def loss_with(self, params: dict, batch: dict) -> tuple:
        """:meth:`loss` on the weights of ``params`` (a :func:`param_tree`
        of the same structure) instead of the model's own."""
        return torch.func.functional_call(
            self, named_of(params, stack_paths(self)), (batch,))

    def apply(self, batch: dict) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: dict) -> tuple:
        raise NotImplementedError

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        raise NotImplementedError

    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        raise NotImplementedError

    def input_specs(self, shape, for_decode: bool = False) -> dict:
        """The reference's dry-run stand-ins for a ``ShapeConfig``: ``{name:
        (shape, dtype)}`` of the batch ``loss`` (or, with ``for_decode``,
        ``decode_step``) takes."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if for_decode:
            return {"tokens": ((b, 1), torch.int32)}
        specs = {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}
        if cfg.is_prefix_lm:
            specs["prefix_embeddings"] = ((b, cfg.num_prefix_tokens, cfg.d_model),
                                          self.dtype)
        if cfg.family == "audio":
            specs["frames"] = ((b, cfg.encoder_len, cfg.d_model), self.dtype)
        return specs
