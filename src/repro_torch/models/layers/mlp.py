"""Feed-forward block: SwiGLU (llama family)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.model_utils import normal

__all__ = ["swiglu_init", "swiglu"]


def swiglu_init(d_model: int, d_ff: int, dtype, device, generator) -> dict:
    s_in, s_out = d_model**-0.5, d_ff**-0.5
    return {
        "w_gate": normal((d_model, d_ff), s_in, dtype, device, generator),
        "w_up": normal((d_model, d_ff), s_in, dtype, device, generator),
        "w_down": normal((d_ff, d_model), s_out, dtype, device, generator),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    hidden = F.silu(gate) * up
    return hidden @ params["w_down"]
