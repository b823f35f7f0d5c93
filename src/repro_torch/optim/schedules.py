"""Learning-rate schedules: ``count`` (a 0-d int32 step tensor) -> a 0-d
float32 learning rate on ``count``'s device."""
from __future__ import annotations

import math

import torch

__all__ = ["constant_lr", "cosine_decay", "warmup_cosine", "inverse_sqrt"]


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def constant_lr(value: float):
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=torch.as_tensor(count).device)


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    def schedule(count):
        t = torch.clamp(_f32(count), max=decay_steps) / decay_steps
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return init_value * ((1 - alpha) * cos + alpha)

    return schedule


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def schedule(count):
        c = _f32(count)
        warm = peak * c / max(warmup_steps, 1)
        t = torch.clamp((c - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(c < warmup_steps, warm, cos)

    return schedule


def inverse_sqrt(peak: float, warmup_steps: int = 1000):
    def schedule(count):
        c = torch.clamp(_f32(count), min=1.0)
        return peak * torch.minimum(c / warmup_steps,
                                    torch.sqrt(warmup_steps / c))

    return schedule
