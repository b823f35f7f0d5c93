"""Build a Model from an ArchConfig, dispatching on family."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import Model
from repro_torch.models.encdec import build_encdec_model
from repro_torch.models.hybrid import build_hybrid_model
from repro_torch.models.mamba_model import build_mamba_model
from repro_torch.models.moe_transformer import build_moe_model
from repro_torch.models.transformer import build_dense_model

__all__ = ["build_model"]


def build_model(
    cfg: ArchConfig,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> Model:
    """The family's model with random weights drawn from ``generator``
    (seed 0 on ``device`` when None), on ``device``.  On the ``meta``
    device or under ``FakeTensorMode`` (a planned model: shapes and dtypes,
    no values) no generator is made."""
    device = torch.device(device)
    fake = torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None
    if generator is None and device.type != "meta" and not fake:
        generator = torch.Generator(device=device).manual_seed(0)
    builders = {"dense": build_dense_model, "vlm": build_dense_model,
                "moe": build_moe_model, "ssm": build_mamba_model,
                "hybrid": build_hybrid_model, "audio": build_encdec_model}
    if cfg.family in builders:
        return builders[cfg.family](cfg, dtype, device=device, generator=generator)
    raise ValueError(f"unknown family {cfg.family!r}")
