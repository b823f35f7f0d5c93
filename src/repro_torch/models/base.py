"""Model protocol shared by the port's language models.

A :class:`Model` is an ``nn.Module`` holding its parameters under the JAX
package's pytree names (``embedding.table``, ``layers.{i}.attn.wq``, ...,
so ``interop.model_from_reference_params`` carries weights one leaf at a
time) with the JAX ``Model`` bundle's entry points as methods:

  apply(batch) -> final hidden states (B, S, D)
  loss(batch) -> (scalar cross-entropy, aux)        forward value only
  init_cache(batch_size, cache_len) -> decode cache
  decode_step(tokens, cache, pos) -> (logits (B, V) float32, cache)

Inference only in this slice: the parameters do not require grad, and
every entry point runs under ``torch.no_grad``.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Model"]


class Model(nn.Module):
    """Base of the port's LMs: ``cfg`` (an ``ArchConfig``) and the entry
    points above.  ``cfg.use_kernels`` is read at call time, so switching
    the config switches the path on the same weights."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embedding.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embedding.table.dtype

    def apply(self, batch: dict) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: dict) -> tuple:
        raise NotImplementedError

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        raise NotImplementedError

    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        raise NotImplementedError
