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

The training path sees the weights as the reference's pytree
(:func:`param_tree`): one leaf per reference path, in the reference's leaf
order, a per-layer leaf being the tuple of its ``num_layers`` tensors (the
reference's ``(L, ...)`` stacked leaf).  The optimizers
(``repro_torch.optim``) and the checkpoints work on that structure.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

__all__ = ["Model", "tree_of", "named_of", "param_tree", "leaf_shape"]

Leaf = Union[torch.Tensor, tuple]


def _path_key(path: str) -> tuple:
    return tuple(path.split("/"))


def tree_of(named: dict) -> dict:
    """``{port name: tensor}`` -> the reference's pytree ``{path: leaf}``:
    ``layers.{i}.attn.wq`` is piece i of leaf ``layers/attn/wq``, any other
    ``a.b`` is leaf ``a/b``; leaves sorted as ``jax.tree_util`` orders the
    reference's nested dicts."""
    plain, stacked = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            path = "/".join(["layers"] + parts[2:])
            stacked.setdefault(path, {})[int(parts[1])] = t
        else:
            plain["/".join(parts)] = t
    for path, pieces in stacked.items():
        if sorted(pieces) != list(range(len(pieces))):
            raise ValueError(f"leaf {path} lacks layers: {sorted(pieces)}")
        plain[path] = tuple(pieces[i] for i in range(len(pieces)))
    return {p: plain[p] for p in sorted(plain, key=_path_key)}


def named_of(tree: dict) -> dict:
    """The inverse of :func:`tree_of`."""
    out = {}
    for path, leaf in tree.items():
        parts = path.split("/")
        if isinstance(leaf, tuple):
            rest = ".".join(parts[1:])
            for i, t in enumerate(leaf):
                out[f"{parts[0]}.{i}.{rest}"] = t
        else:
            out[".".join(parts)] = leaf
    return out


def param_tree(model: nn.Module) -> dict:
    """The model's own parameters as the reference's pytree (aliases: an
    in-place update of a leaf updates the model)."""
    return tree_of(dict(model.named_parameters()))


def leaf_shape(leaf: Leaf) -> tuple:
    """The reference's shape of ``leaf``: ``(L, *piece)`` for a per-layer
    leaf."""
    if isinstance(leaf, tuple):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


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
        return torch.func.functional_call(self, named_of(params), (batch,))

    def apply(self, batch: dict) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: dict) -> tuple:
        raise NotImplementedError

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        raise NotImplementedError

    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        raise NotImplementedError
