"""Importance measures: gradient-Lipschitz constants L_v and pi_IS (paper §III).

Closed forms (paper §II.B, Appendix D):
* linear regression   f_v(x) = (y_v - x^T A_v)^2        ->  L_v = 2 ||A_v||^2
* logistic regression f_v(x) = y_v x^T A_v - log(1+e^{x^T A_v}) -> L_v = ||A_v||^2 / 4

For losses without a closed form (the LLM path), an online estimate of
the local curvature proxy ``L_v ~= |g_v(x_t) - g_v(x_t')| / |f(x_t) -
f(x_t')|`` is kept per node from consecutive visits, with ``f`` a fixed
random projection of the parameters (:func:`param_fingerprint`): gathers
and scatters on tensors, the reference's ``online_lipschitz_update``
operation for operation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "linear_regression_lipschitz",
    "logistic_regression_lipschitz",
    "importance_distribution",
    "importance_weights",
    "FINGERPRINT_SEED",
    "param_fingerprint",
    "OnlineLipschitzState",
    "online_lipschitz_init",
    "online_lipschitz_update",
]


def linear_regression_lipschitz(features: np.ndarray) -> np.ndarray:
    """L_v = 2 ||A_v||^2 for f_v(x) = (y_v - x^T A_v)^2 (paper Appendix D)."""
    features = np.asarray(features)
    return 2.0 * (features**2).sum(axis=-1)


def logistic_regression_lipschitz(features: np.ndarray) -> np.ndarray:
    """L_v = ||A_v||^2 / 4 (paper §II.B)."""
    features = np.asarray(features)
    return 0.25 * (features**2).sum(axis=-1)


def importance_distribution(lipschitz: np.ndarray) -> np.ndarray:
    """pi_IS(v) = L_v / sum_u L_u (paper Eq. 5)."""
    lipschitz = np.asarray(lipschitz, dtype=np.float64)
    if np.any(lipschitz <= 0):
        raise ValueError("Lipschitz constants must be strictly positive")
    return lipschitz / lipschitz.sum()


def importance_weights(lipschitz) -> torch.Tensor:
    """Per-node update weights w(v) = L_bar / L_v of Eq. (12), float32."""
    lipschitz = torch.as_tensor(lipschitz)
    if not lipschitz.is_floating_point() or lipschitz.dtype == torch.float64:
        lipschitz = lipschitz.to(torch.float32)
    return lipschitz.mean() / lipschitz


# The seed of the fingerprint's projection.  The fingerprint must be the same
# functional of the parameters at every visit of every node, so the
# projection is fixed once per state and recorded in it (``proj_seed``).
FINGERPRINT_SEED = 0


def param_fingerprint(
    params,
    seed: int = FINGERPRINT_SEED,
    *,
    projections: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Random-projection fingerprint ``<r, vec(x)> / sqrt(D)`` of a model's
    parameters (a ``torch.nn.Module``) or of a list of tensors.

    ``r ~ N(0, I)`` is drawn per leaf, in order, from one ``torch.Generator``
    seeded with ``seed`` on the first leaf's device, so the fingerprint is
    a fixed function of the parameters; ``projections`` (one tensor per
    leaf) replaces that draw, e.g. with the reference's
    ``jax.random.normal`` vectors.  Differences of fingerprints track
    parameter distance (``E[(r.(x - x'))^2] = ||x - x'||^2``, over D), where
    the norm ``||x||`` would collide for far-apart parameters of equal norm.
    Returns a 0-d float32 tensor.
    """
    leaves = list(params.parameters() if isinstance(params, torch.nn.Module)
                  else params)
    dim = sum(int(leaf.numel()) for leaf in leaves) or 1
    if projections is not None and len(projections) != len(leaves):
        raise ValueError(f"{len(projections)} projections for "
                         f"{len(leaves)} parameter leaves")
    device = leaves[0].device if leaves else torch.device("cpu")
    gen = None
    if projections is None and leaves:
        gen = torch.Generator(device=device).manual_seed(seed)
    total = torch.zeros((), dtype=torch.float32, device=device)
    with torch.no_grad():
        for i, leaf in enumerate(leaves):
            x = leaf.detach().to(torch.float32)
            if projections is None:
                r = torch.randn(x.shape, generator=gen, device=device)
            else:
                r = torch.as_tensor(projections[i], dtype=torch.float32,
                                    device=device)
            total = total + torch.vdot(r.reshape(-1), x.reshape(-1))
    return total / math.sqrt(dim)


@dataclasses.dataclass
class OnlineLipschitzState:
    """Per-node secant curvature estimates; ``proj_seed`` is the seed of the
    fingerprint the stored ``last_param_fingerprint`` values came from."""

    lipschitz: torch.Tensor  # (n,) float32 current estimates
    last_grad_norm: torch.Tensor  # (n,) float32 ||g_v|| at the last visit
    last_param_fingerprint: torch.Tensor  # (n,) float32 fingerprint there
    visited: torch.Tensor  # (n,) bool
    proj_seed: int = FINGERPRINT_SEED


def online_lipschitz_init(
    n: int,
    init: float = 1.0,
    proj_seed: int = FINGERPRINT_SEED,
    *,
    device: Union[str, torch.device] = "cuda",
) -> OnlineLipschitzState:
    """Every estimate at ``init``, no node visited."""
    return OnlineLipschitzState(
        lipschitz=torch.full((n,), init, dtype=torch.float32, device=device),
        last_grad_norm=torch.zeros(n, dtype=torch.float32, device=device),
        last_param_fingerprint=torch.zeros(n, dtype=torch.float32,
                                           device=device),
        visited=torch.zeros(n, dtype=torch.bool, device=device),
        proj_seed=proj_seed,
    )


def online_lipschitz_update(
    state: OnlineLipschitzState,
    node,
    grad_norm,
    param_fingerprint,
    *,
    ema: float = 0.9,
    clip_min: float = 1e-3,
    clip_max: float = 1e3,
) -> OnlineLipschitzState:
    """Secant update of ``L_node`` from consecutive visits.

    ``L_new = |grad_norm - last| / max(|fingerprint - last_fp|, 1e-8)``,
    clipped to ``[clip_min, clip_max]`` and blended into an EMA; a first
    visit keeps the prior.  Gathers and scatters at ``node`` only (no host
    read).  ``param_fingerprint`` must come from :func:`param_fingerprint`
    with ``seed=state.proj_seed``.
    """
    dev = state.lipschitz.device
    node = torch.as_tensor(node, dtype=torch.int64, device=dev)
    grad_norm = torch.as_tensor(grad_norm, dtype=torch.float32, device=dev)
    fp = torch.as_tensor(param_fingerprint, dtype=torch.float32, device=dev)
    prev_g = state.last_grad_norm[node]
    prev_f = state.last_param_fingerprint[node]
    seen = state.visited[node]
    dx = torch.abs(fp - prev_f)
    secant = torch.abs(grad_norm - prev_g) / torch.clamp(dx, min=1e-8)
    secant = torch.clamp(secant, clip_min, clip_max)
    old = state.lipschitz[node]
    blended = torch.where(seen, ema * old + (1.0 - ema) * secant, old)

    def put(vec, val):
        out = vec.clone()
        out[node] = val
        return out

    return OnlineLipschitzState(
        lipschitz=put(state.lipschitz, blended),
        last_grad_norm=put(state.last_grad_norm, grad_norm),
        last_param_fingerprint=put(state.last_param_fingerprint, fp),
        visited=put(state.visited, True),
        proj_seed=state.proj_seed,
    )
