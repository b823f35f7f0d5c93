"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig, INPUT_SHAPES, SHAPES_BY_NAME, reduced
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE_398B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN2_5_32B

ARCHITECTURES = {
    c.name: c
    for c in (
        PALIGEMMA_3B,
        DEEPSEEK_MOE_16B,
        DEEPSEEK_7B,
        MINITRON_8B,
        JAMBA_1_5_LARGE_398B,
        DEEPSEEK_67B,
        MAMBA2_370M,
        OLMOE_1B_7B,
        WHISPER_TINY,
        QWEN2_5_32B,
    )
}

# sliding-window used for the long_500k adaptation of full-attention archs
LONG_CONTEXT_WINDOW = 8192


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def arch_for_shape(cfg: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    """Shape-specific adaptation: long_500k forces sliding-window attention
    on attention-bearing archs (DESIGN.md §4); SSM needs nothing."""
    if shape.name == "long_500k" and cfg.family != "ssm" and cfg.num_heads:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "INPUT_SHAPES",
    "ARCHITECTURES",
    "LONG_CONTEXT_WINDOW",
    "get_arch",
    "get_shape",
    "arch_for_shape",
    "reduced",
]
