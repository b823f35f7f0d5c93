"""Heterogeneity-aware transition targets (Dandi et al., arXiv:2204.06477).

A numpy copy of ``repro.core.heterogeneity``, bit for bit.

The paper's P_IS targets pi ∝ L_v — smoothness-aware importance sampling.
Dandi et al. argue the *data heterogeneity* between nodes, not just their
smoothness, should shape the communication topology: nodes whose local
gradients disagree most with the rest of the network carry the most
information and deserve more visit mass.  This module implements that
pipeline for the repo's chain-law stack:

1. **Measure** — :func:`measure_dissimilarity` evaluates each node's local
   gradient at a small set of probe parameter points and returns the pairwise
   gradient-dissimilarity matrix ``H[u, v] = mean_probes ||g_u - g_v||^2``
   (the discrete analogue of the zeta^2 heterogeneity bound in
   arXiv:2204.06477).

2. **Optimize** — :func:`optimize_pi` minimizes the sampling-variance
   surrogate

       J(pi) = sum_v  h_bar(v) / pi_v,      h_bar(v) = mean_u H[v, u]

   over the probability simplex by projected gradient descent, with an
   entrywise floor ``pi_v >= floor / n`` that keeps the optimized chain
   irreducible and the importance weights 1/(n pi_v) bounded (the same role
   the weight clip plays for the online L_v estimator).  With the floor
   inactive the minimizer is the closed form ``pi ∝ sqrt(h_bar)``
   (:func:`optimal_pi_closed_form`) — the test oracle for the descent.

3. **Walk** — the optimized pi feeds ``transition.heterogeneity_rows*``:
   Metropolis–Hastings rows targeting pi through the identical
   ``_mh_rows_block`` math as every other law, so all four engine layouts
   sample it bitwise-identically.

Everything here is offline numpy precompute (the analysis stack), like the
dense transition matrices: the output is one (n,) target handed to the row
functions once per training run.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "pairwise_gradient_dissimilarity",
    "measure_dissimilarity",
    "mean_dissimilarity",
    "project_to_simplex",
    "optimal_pi_closed_form",
    "optimize_pi",
    "heterogeneity_pi",
]


def pairwise_gradient_dissimilarity(grads: np.ndarray) -> np.ndarray:
    """``H[u, v] = mean_p ||g_u - g_v||^2`` from per-probe node gradients.

    ``grads`` is ``(num_probes, n, d)`` (or ``(n, d)`` for a single probe).
    Computed via the Gram expansion ||g_u||^2 + ||g_v||^2 - 2 g_u.g_v, one
    (n, n) matmul per probe — O(p n^2 d) flops, O(n^2) memory: the float64
    H alone is 8 n^2 bytes (80 GB at n = 100,000), so callers at that size
    pass a precomputed target to the trainer (``law_kwargs={"pi": ...}``).
    """
    grads = np.asarray(grads, dtype=np.float64)
    if grads.ndim == 2:
        grads = grads[None]
    if grads.ndim != 3:
        raise ValueError(
            f"grads must be (num_probes, n, d) or (n, d), got {grads.shape}"
        )
    p, n, _ = grads.shape
    h = np.zeros((n, n), dtype=np.float64)
    for g in grads:
        sq = (g**2).sum(axis=1)
        h += sq[:, None] + sq[None, :] - 2.0 * (g @ g.T)
    h = np.maximum(h / p, 0.0)  # float error can push diagonals below 0
    np.fill_diagonal(h, 0.0)
    return 0.5 * (h + h.T)  # exact symmetry for downstream consumers


def measure_dissimilarity(
    data,
    num_probes: int = 8,
    probe_scale: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Pairwise gradient-dissimilarity matrix of a regression instance.

    Evaluates each node's local least-squares gradient
    ``g_v(x) = -2 (y_v - A_v.x) A_v`` at ``num_probes`` parameter probes
    (the origin plus fixed-seed Gaussian draws of scale ``probe_scale``) and
    averages the pairwise squared gradient gaps — a plug-in estimate of the
    heterogeneity matrix of arXiv:2204.06477 measured where training
    actually starts, not at the (unknown) optimum.
    """
    if num_probes < 1:
        raise ValueError(f"num_probes must be >= 1, got {num_probes}")
    features = np.asarray(data.features, dtype=np.float64)
    targets = np.asarray(data.targets, dtype=np.float64)
    n, d = features.shape
    rng = np.random.default_rng(seed)
    probes = [np.zeros(d)]
    probes += [
        probe_scale * rng.standard_normal(d) for _ in range(num_probes - 1)
    ]
    grads = np.stack(
        [
            -2.0 * (targets - features @ x)[:, None] * features
            for x in probes
        ]
    )
    return pairwise_gradient_dissimilarity(grads)


def mean_dissimilarity(h: np.ndarray) -> np.ndarray:
    """Per-node mean dissimilarity ``h_bar(v) = mean_u H[v, u]``."""
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 2 or h.shape[0] != h.shape[1]:
        raise ValueError(f"H must be square (n, n), got {h.shape}")
    if np.any(h < 0):
        raise ValueError("dissimilarity entries must be nonnegative")
    return h.mean(axis=1)


def project_to_simplex(v: np.ndarray, floor: float = 0.0) -> np.ndarray:
    """Euclidean projection onto ``{pi : sum pi = 1, pi_i >= floor/n}``.

    The floored simplex is the plain simplex shifted by ``floor/n`` per
    coordinate: project ``v - floor/n`` onto the simplex of total mass
    ``1 - floor`` (the standard sort-based algorithm) and shift back.
    """
    v = np.asarray(v, dtype=np.float64)
    n = v.size
    if not (0.0 <= floor < 1.0):
        raise ValueError(f"floor must be in [0, 1), got {floor}")
    z = v - floor / n
    mass = 1.0 - floor
    u = np.sort(z)[::-1]
    css = np.cumsum(u) - mass
    idx = np.arange(1, n + 1)
    rho = idx[u - css / idx > 0][-1]
    theta = css[rho - 1] / rho
    return np.maximum(z - theta, 0.0) + floor / n


def optimal_pi_closed_form(h: np.ndarray) -> np.ndarray:
    """Unconstrained simplex minimizer of J(pi): ``pi ∝ sqrt(h_bar)``.

    From the KKT conditions h_bar(v) / pi_v^2 = const.  Exact only while
    every entry clears the floor — the projected-descent optimizer handles
    the constrained case; this is its oracle (and its warm start).
    """
    hbar = mean_dissimilarity(h)
    if hbar.max() <= 0.0:
        return np.full(hbar.size, 1.0 / hbar.size)
    root = np.sqrt(hbar)
    return root / root.sum()


def optimize_pi(
    h: np.ndarray,
    floor: float = 0.25,
    steps: int = 400,
    step_size: float = 0.1,
    init: np.ndarray | None = None,
) -> np.ndarray:
    """Projected-descent minimizer of ``J(pi) = sum_v h_bar(v)/pi_v``.

    Normalized projected gradient descent with a 1/sqrt(t) step decay on the
    floored simplex (``pi_v >= floor/n``).  ``floor`` keeps the MH chain
    targeting pi irreducible on any connected graph and bounds the
    importance weights; ``floor=0`` recovers the unconstrained optimum
    ``pi ∝ sqrt(h_bar)`` up to descent tolerance.  A fully homogeneous
    network (H = 0) returns the uniform distribution — heterogeneity-aware
    sampling degenerates to MH-uniform, as it should.
    """
    hbar = mean_dissimilarity(h)
    n = hbar.size
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if hbar.max() <= 0.0:
        return np.full(n, 1.0 / n)
    hbar = hbar / hbar.max()  # argmin is scale-invariant; tame the gradients
    if init is None:
        pi = project_to_simplex(optimal_pi_closed_form(h), floor)
    else:
        pi = project_to_simplex(np.asarray(init, dtype=np.float64), floor)
    best, best_obj = pi, float(np.sum(hbar / pi))
    for t in range(steps):
        grad = -hbar / pi**2
        lr = step_size / (np.abs(grad).max() * np.sqrt(t + 1.0))
        pi = project_to_simplex(pi - lr * grad, floor)
        obj = float(np.sum(hbar / pi))
        if obj < best_obj:
            best, best_obj = pi, obj
    return best


def heterogeneity_pi(
    data,
    floor: float = 0.25,
    num_probes: int = 8,
    probe_scale: float = 1.0,
    seed: int = 0,
    steps: int = 400,
) -> np.ndarray:
    """Measure-then-optimize convenience: the (n,) walk target in one call.

    This is what ``walk_sgd.trainer`` invokes for ``method="heterogeneity"``
    when no precomputed pi is supplied.
    """
    h = measure_dissimilarity(
        data, num_probes=num_probes, probe_scale=probe_scale, seed=seed
    )
    return optimize_pi(h, floor=floor, steps=steps)
