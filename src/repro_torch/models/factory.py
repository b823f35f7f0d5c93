"""Build a Model from an ArchConfig, dispatching on family."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import Model
from repro_torch.models.mamba_model import build_mamba_model
from repro_torch.models.transformer import build_dense_model

__all__ = ["build_model"]

# families the port does not build yet, and the ROADMAP item that brings them
_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 10 (models/moe_transformer.py, layers/moe.py)",
    "hybrid": "ROADMAP Queue 1 item 10 (models/hybrid.py)",
    "audio": "ROADMAP Queue 1 item 10 (models/encdec.py, cross-attention, "
             "gelu_mlp, layernorm)",
}


def build_model(
    cfg: ArchConfig,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> Model:
    """The family's model with random weights drawn from ``generator``
    (seed 0 on ``device`` when None), on ``device``."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if cfg.family in ("dense", "vlm"):
        return build_dense_model(cfg, dtype, device=device, generator=generator)
    if cfg.family == "ssm":
        return build_mamba_model(cfg, dtype, device=device, generator=generator)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet: {_NOT_PORTED[cfg.family]}"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
