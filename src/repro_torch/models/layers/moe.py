"""Mixture-of-Experts layer: token-choice top-k routing with a fixed expert
capacity, index dispatch into ``(E, cap, D)`` expert buffers (no
``(S, E, C)`` one-hot product), optional shared experts (DeepSeekMoE) and
the Switch-style load-balance aux loss.

The router runs in float32 (routing decisions are precision sensitive):
``x.float() @ router``, with TF32 off on the card.  The top-k order is the
JAX package's ``lax.top_k``: among equal probabilities the lower expert
index comes first (a stable descending sort).

Dispatch and combine are one ``scatter`` and one ``gather`` over a flat
buffer of ``E * cap`` slots plus one spare slot: a kept choice has a slot
of its own, a dropped one goes to the spare, which is cut off after the
dispatch and reads as zeros in the combine.  So the kept rows are the
reference's bits (its ``.at[].add`` drops add exact zeros), and the
backward passes (a ``gather`` and a ``scatter_add`` whose only repeated
index is the spare's) give the same bits under
``torch.use_deterministic_algorithms(True)``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.model_utils import normal
from repro_torch.sharding.constraints import (
    aligned_to, constrain, is_dtensor, local_call, placements_of,
)

__all__ = ["MoEDims", "moe_init", "moe_route", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    num_experts: int
    experts_per_token: int
    d_expert: int  # per-expert FFN hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25


def moe_init(dims: MoEDims, dtype, device, generator) -> dict:
    """The JAX package's init law; the router stays float32.  With shared
    experts the dict holds a nested ``"shared"`` dict."""
    d, e, f = dims.d_model, dims.num_experts, dims.d_expert
    s_in, s_out = d**-0.5, f**-0.5
    params = {
        "router": normal((d, e), s_in, torch.float32, device, generator),
        "w_gate": normal((e, d, f), s_in, dtype, device, generator),
        "w_up": normal((e, d, f), s_in, dtype, device, generator),
        "w_down": normal((e, f, d), s_out, dtype, device, generator),
    }
    if dims.num_shared_experts > 0:
        fs = dims.num_shared_experts * f
        params["shared"] = {
            "w_gate": normal((d, fs), s_in, dtype, device, generator),
            "w_up": normal((d, fs), s_in, dtype, device, generator),
            "w_down": normal((fs, d), fs**-0.5, dtype, device, generator),
        }
    return params


def _capacity(seq_tokens: int, dims: MoEDims) -> int:
    """The JAX package's expression in its order, rounded up to a multiple
    of 8, at least 8 (8 at decode)."""
    c = int(dims.capacity_factor * seq_tokens * dims.experts_per_token / dims.num_experts)
    return max(8, -(-c // 8) * 8)


@contextlib.contextmanager
def _exact_float32(device: torch.device):
    """Float32 products without TF32 on the card for the block's span."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def moe_route(params, x: torch.Tensor, dims: MoEDims) -> tuple:
    """``(probs (B,S,E), gates (B,S,K), idx (B,S,K))``: the float32 router's
    softmax, the renormalised top-k gates and their experts, ties to the
    lower index."""
    with _exact_float32(x.device):
        logits = torch.einsum("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = dims.experts_per_token
    gates, idx = top[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _dispatch(x, rows, e: int, cap: int) -> torch.Tensor:
    """The ``(B, E, cap, D)`` expert buffers: one ``scatter`` of each
    (token, choice) into its slot of ``E * cap + 1``, the spare cut off."""
    b, s, d = x.shape
    k = rows.shape[1] // s
    x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    buf = x.new_zeros((b, e * cap + 1, d)).scatter(1, rows, x_rep)
    return buf[:, : e * cap].reshape(b, e, cap, d)


def _combine(expert_out, rows, gates) -> torch.Tensor:
    """out[token] = sum_k gate_k * expert_out[e_k, pos_k]: one ``gather``,
    the spare slot reading zeros."""
    b, e, cap, d = expert_out.shape
    s, k = gates.shape[1], gates.shape[2]
    eo = F.pad(expert_out.reshape(b, e * cap, d), (0, 0, 0, 1))
    vals = eo.gather(1, rows).reshape(b, s, k, d)
    return (vals * gates.to(vals.dtype)[..., None]).sum(dim=2)


def _by_batch(fn, tensors: tuple, out_shape: tuple, *args):
    """``fn(*tensors, *args)``; on a mesh on each device's batch rows (the
    dispatch and combine index within a batch row only), every other dim
    whole."""
    if not is_dtensor(tensors[0]):
        return fn(*tensors, *args)
    pb = placements_of(tensors[0], (0,))
    return local_call(lambda *t: fn(*t, *args), tensors,
                      (pb,) + (aligned_to(pb, {0: 0}),) * (len(tensors) - 1),
                      pb, out_shape)


def moe_apply(params, x: torch.Tensor, dims: MoEDims) -> tuple:
    """x: (B, S, D) -> (B, S, D) and the aux dict (``moe_aux_loss``,
    ``moe_dropped_frac``, ``moe_expert_load``)."""
    b, s, d = x.shape
    e, k = dims.num_experts, dims.experts_per_token
    cap = _capacity(s, dims)
    probs, gates, idx = moe_route(params, x, dims)

    # position of each (token, choice) in its expert's buffer: an exclusive
    # count over the S*K choices in scan order
    flat_idx = idx.reshape(b, s * k)
    onehot = F.one_hot(flat_idx, e)
    pos_in_expert = torch.cumsum(onehot, dim=1) - onehot
    pos = pos_in_expert.gather(-1, flat_idx[..., None])[..., 0]
    keep = pos < cap  # overflow dropped
    slot = torch.where(keep, flat_idx * cap + pos, e * cap)  # spare: e * cap
    rows = slot[..., None].expand(b, s * k, d)

    expert_in = _by_batch(_dispatch, (x, rows), (b, e, cap, d), e, cap)
    # the expert-parallel layout on a mesh (batch over 'data', experts over
    # 'model'; no-ops without one), as the JAX package constrains it; not
    # at decode-size capacities, where it measured as a pure collective cost
    constrain_ep = cap >= 64
    if constrain_ep:
        expert_in = constrain(expert_in, ("data", "model", None, None))

    # expert FFN (SwiGLU), batched over (B, E)
    h_gate = torch.einsum("becd,edf->becf", expert_in, params["w_gate"])
    h_up = torch.einsum("becd,edf->becf", expert_in, params["w_up"])
    expert_out = torch.einsum("becf,efd->becd", F.silu(h_gate) * h_up,
                              params["w_down"])
    if constrain_ep:
        expert_out = constrain(expert_out, ("data", "model", None, None))

    out = _by_batch(_combine, (expert_out, rows, gates), (b, s, d))

    if dims.num_shared_experts > 0:
        sh = params["shared"]
        hidden = F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])
        out = out + hidden @ sh["w_down"]

    # Switch-style load balance: E * sum_e f_e * p_e
    f_e = F.one_hot(idx, e).float().sum(dim=(1, 2)) / (s * k)  # (B,E)
    p_e = probs.mean(dim=1)
    aux = {
        "moe_aux_loss": e * torch.mean(torch.sum(f_e * p_e, dim=-1)),
        "moe_dropped_frac": 1.0 - keep.float().mean(),
        "moe_expert_load": f_e.mean(dim=0),
    }
    return out.to(x.dtype), aux
