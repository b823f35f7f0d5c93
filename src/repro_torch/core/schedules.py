"""Jump-probability schedules p_J(t) (paper Fig 6: shrink p_J -> 0 to kill the
error gap without losing speed).

Each schedule is a factory returning a (T,) float32 numpy array consumable by
the engine's ``run`` and the trainers.  Every factory validates its arguments
the way ``MHLJParams.validate`` does — p_J values are probabilities, so an
out-of-range ``p_j0`` would feed the engine a Bernoulli parameter outside
[0, 1] and silently clamp (or worse, wrap) inside the sampler.
"""
from __future__ import annotations

import numpy as np

__all__ = ["constant", "polynomial_decay", "step_decay", "linear_to_zero"]


def _validate(p_j0: float, num_steps: int) -> None:
    """Mirror of ``MHLJParams.validate`` for the schedule factories."""
    if not (0.0 <= p_j0 <= 1.0):
        raise ValueError(f"p_j0 must be in [0,1], got {p_j0}")
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")


def constant(p_j: float, num_steps: int) -> np.ndarray:
    _validate(p_j, num_steps)
    return np.full(num_steps, p_j, dtype=np.float32)


def polynomial_decay(p_j0: float, num_steps: int, power: float = 1.0, t0: int = 1) -> np.ndarray:
    """p_J(t) = p_j0 * (t0 / (t0 + t))^power — the Fig-6 style annealing."""
    _validate(p_j0, num_steps)
    if t0 < 1:
        raise ValueError(f"t0 must be >= 1, got {t0}")
    if power < 0:
        raise ValueError(f"power must be >= 0, got {power}")
    t = np.arange(num_steps, dtype=np.float64)
    return (p_j0 * (t0 / (t0 + t)) ** power).astype(np.float32)


def step_decay(p_j0: float, num_steps: int, drop_every: int, factor: float = 0.5) -> np.ndarray:
    """p_J(t) = p_j0 * factor^(t // drop_every) — staircase annealing."""
    _validate(p_j0, num_steps)
    if drop_every <= 0:
        raise ValueError(
            f"drop_every must be a positive step count, got {drop_every}"
        )
    if not (0.0 < factor <= 1.0):
        raise ValueError(f"factor must be in (0,1], got {factor}")
    t = np.arange(num_steps)
    return (p_j0 * factor ** (t // drop_every)).astype(np.float32)


def linear_to_zero(p_j0: float, num_steps: int, zero_at: float = 0.8) -> np.ndarray:
    """Linear ramp from p_j0 to 0 reaching zero at fraction ``zero_at`` of T."""
    _validate(p_j0, num_steps)
    if not (0.0 < zero_at <= 1.0):
        raise ValueError(f"zero_at must be in (0,1], got {zero_at}")
    t = np.arange(num_steps, dtype=np.float64)
    horizon = max(1.0, zero_at * num_steps)
    return np.maximum(0.0, p_j0 * (1.0 - t / horizon)).astype(np.float32)
