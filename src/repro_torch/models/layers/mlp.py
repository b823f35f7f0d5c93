"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.model_utils import normal

__all__ = ["swiglu_init", "swiglu", "gelu_mlp_init", "gelu_mlp"]


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


def gelu_mlp_init(d_model: int, d_ff: int, dtype, device, generator) -> dict:
    return {
        "w_in": normal((d_model, d_ff), d_model**-0.5, dtype, device, generator),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_out": normal((d_ff, d_model), d_ff**-0.5, dtype, device, generator),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation, so this is too."""
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    return h @ params["w_out"] + params["b_out"]
