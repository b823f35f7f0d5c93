"""Shared model-assembly pieces: named parameter groups, the init law, the
layer loop with its activation-checkpoint policy, and the gradient dtype
guard.

The JAX package stacks each leaf over layers and scans them with
``lax.scan``; the port keeps one parameter group per layer in an
``models.base.Stack`` and loops over it (:func:`scan_layers`).  The loop reads
each layer's tensors at call time and hands them to the layer body as
arguments, so a checkpointed layer recomputes with the tensors it ran
with, also under ``torch.func.functional_call``.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

__all__ = ["ParamGroup", "normal", "grad_dtype_guard", "remat_wrap",
           "scan_layers", "scan_layers_aux", "layer_params"]


class ParamGroup(nn.Module):
    """Named tensors as trainable parameters, read like the JAX package's
    parameter dicts (``group["wq"]``); a nested dict (the MoE layer's
    ``"shared"`` experts) becomes a child group."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, dict):
                self.add_module(name, ParamGroup(**t))
            else:
                self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name: str):
        if name in self._modules:
            return self._modules[name]
        return self._parameters[name]


def normal(shape, std: float, dtype, device, generator) -> torch.Tensor:
    """``N(0, std^2)`` drawn in float32 from ``generator``, cast to ``dtype``
    (the JAX package's ``normal(key, shape, float32) * std`` init)."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return (out * std).to(dtype)


class _GradDtypeGuard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_dtype_guard(x: torch.Tensor) -> torch.Tensor:
    """Identity whose gradient is cast back to ``x``'s dtype (the JAX
    package's ``custom_vjp`` guard at each layer boundary and at the
    cross-entropy's input): float32 cotangents of the float32 scores and
    logits do not ride the bf16 residual stream backwards."""
    return _GradDtypeGuard.apply(x)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of products
    without a batch dimension, recompute everything else (the batched
    attention products included)."""
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, mode: str) -> Callable:
    """``fn`` under the activation-checkpoint policy ``mode``: ``"full"``
    recomputes the whole call in the backward pass, ``"dots"`` keeps the
    unbatched matmul outputs and recomputes the rest, ``"none"`` keeps
    everything.  The recompute is not checked against the first pass
    (``determinism_check="none"``): the layers' shapes do not depend on the
    data, so the check would only cost host time."""
    checkpoint = functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                   determinism_check="none")
    if mode == "full":
        return checkpoint
    if mode == "dots":
        return functools.partial(
            checkpoint, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    if mode == "none":
        return fn
    raise ValueError(f"unknown remat mode {mode!r}")


def layer_params(layer: nn.Module):
    """The layer's tensors now, as the JAX package's nested dicts
    (``{"attn": {"wq": ...}}``); a ``ModuleList`` (a stack inside the
    layer, the hybrid's period) is a list of them."""
    if isinstance(layer, nn.ModuleList):
        return [layer_params(m) for m in layer]
    if isinstance(layer, ParamGroup):
        return {**layer._parameters,
                **{name: layer_params(m) for name, m in layer._modules.items()}}
    return {name: layer_params(m) for name, m in layer.items()}


def scan_layers(body: Callable, layers: nn.ModuleList, x: torch.Tensor,
                remat: str = "full", *, guard: bool = True) -> torch.Tensor:
    """``x -> body(layer_params, x)`` over the layers, each layer's input
    behind :func:`grad_dtype_guard` (unless ``guard=False``: the JAX
    package's MoE, hybrid and decoder stacks scan without it) and the body
    under ``remat`` while gradients are recorded (without them there is
    nothing to checkpoint)."""
    fn = remat_wrap(body, remat) if torch.is_grad_enabled() else body
    for layer in layers:
        x = fn(layer_params(layer), grad_dtype_guard(x) if guard else x)
    return x


def scan_layers_aux(body: Callable, layers: nn.ModuleList, x: torch.Tensor,
                    remat: str = "full") -> tuple:
    """Like :func:`scan_layers` for a body returning ``(x, aux scalar)``,
    without the guard (the JAX package's MoE and hybrid stacks scan
    without it); returns ``(x, mean of the layers' aux)``."""
    auxs = []
    fn = remat_wrap(body, remat) if torch.is_grad_enabled() else body
    for layer in layers:
        x, aux = fn(layer_params(layer), x)
        auxs.append(aux)
    return x, torch.stack(auxs).mean()
